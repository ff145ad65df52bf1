// gat_fwd: single-head GAT forward with the bound-shift softmax for n_ch <= 8
// channels that share one edge list, and the online-max forward of one
// channel (K12-online, below), for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernels
//   ops/flash_gat.py:_make_flash_fwd_chunk_kernel (K1, chunk-major grid) and
//   ops/flash_gat.py:_make_flash_kernel(bound_shift=True) (K12, dst-block
//     grid): n_ch = 1, launched by ops/flash_gat.flash_gat_fwd;
//   ops/batch_gat.py:_make_fwd_kernel (K3): n_ch <= 8 over one edge list,
//     launched by ops/batch_gat.batch_gat_fwd.
// Per channel c and edge (s, d) with d < num_rows:
//   p_c   = exp(min(leaky(a_dst[c, d] + a_src_c[s]) - mhat[c, d], 60))
//   acc[d, band c] += [ round_T(z_c[s] * q_c) | round_T(p_c) ]  (f32 accumulate)
// where q_c = p_c for K1/K12, which round the f32 product (flash_gat.py:577),
// and q_c = round_T(p_c) for K3, which rounds p first and multiplies the
// rounded values (batch_gat.py:229-235): the RoundPFirst template flag.
// round_T rounds through the transport type T (identity for f32,
// round-to-nearest-even for bf16).  Normalization by s_c + 1e-16 and the
// bound shift mhat = round_T(leaky(round_T(a_dst) + max a_src)) are plain
// torch in the wrappers, as the JAX package leaves them to XLA.
//
// What bounds it on the H100: bytes.  Per (edge, channel) it does
// ~2(kz+1) flops and moves one (kz+1)-wide band, and per edge two ids, plus
// n_ch*(kz+1) f32 atomic adds; no tensor-core work exists.  The design:
//   * the table is row-major [n, n_ch*(kz+1)]: row s holds every channel's
//     band [z_c[s] | a_src_c[s]], so one edge visit is one coalesced read of
//     all n_ch bands (the TPU kernels' one-hot windows play this role there;
//     their column-major table would give kz scattered reads per edge);
//   * one warp per edge, lanes over the row: lanes 0..n_ch-1 each form one
//     channel's p_c, the other lanes take theirs by warp shuffle, so the exp
//     runs once per (edge, channel); a lane steps its (channel, column) by
//     32 per pass without a division, which cost the one-channel case ~10 %
//     when it divided (PERF.md);
//   * the grid walks edges, not 128-row dst blocks: at the flagship a dst
//     grid would have 119 (union) or 14 (step 2) blocks for 132 SMs, an edge
//     grid has thousands;
//   * the TPU's one-hot MXU gathers, (8,128) padding and VMEM residency are
//     dropped: rows are read directly and sums are f32 atomics, which the
//     50 MB L2 serves (the flagship accumulators are ~4 MB and under 1 MB);
//   * padding edges (dst >= num_rows) are skipped before any other load, so
//     the sentinel src is never dereferenced.
// A later PR can replace the atomics by a segmented warp reduction over the
// block-monotone dst order.
//
// K12-online, ops/flash_gat.py:_make_flash_kernel(bound_shift=False): the
// same forward with the exact row max m in place of m-hat, exact for any
// logit spread.  The TPU kernel keeps a running max per 128-row dst block
// and rescales its accumulator when the max grows; rounding the max to T at
// each step is monotone, so its final m is round_T of the exact row max.
// Here two passes compute the same function:
//   1. gat_rowmax: a thread per edge forms the edge's logit act =
//      leaky(round_T(a_dst[d]) + a_src[s]) and takes an atomicMax of its
//      ordered-int image into m[d] (as segment.cu's K8 does); a row pass
//      turns the images back, rounds to T and writes 0 for a row without
//      an edge (JAX flash_gat.py:474).  Bound: the ids and one a_src value
//      an edge, ~E * 10 bytes.
//   2. gat_fwd_online: the edge walk above (fwd_edges<T, false>) with m as
//      the shift, under its own __global__ so that it is counted and timed
//      apart from K1/K12.  p = exp(act - m) <= ~1, so the +60 clamp is
//      inert.
// The TPU kernel rounds p * z at the running shift and rescales the
// rounded sums by exp(m_old - m_new) in f32 (flash_gat.py:455-470); this one
// rounds p * z at the final m, so out and s agree with it at rounding level
// while m agrees bitwise.  A per-block online rescale would need
// cross-warp synchronisation: block-ordered edges interleave rows.

#include "gat_common.cuh"

namespace {

template <typename T, bool RoundPFirst>
__global__ void __launch_bounds__(256) gat_fwd_kernel(
    const T* __restrict__ table, const float* __restrict__ adst,
    const float* __restrict__ mhat, const int* __restrict__ src,
    const int* __restrict__ dst, float* __restrict__ acc, long long num_edges,
    int num_rows, int kz, int n_ch, float slope) {
  gat::fwd_edges<T, RoundPFirst>(table, adst, mhat, src, dst, acc, num_edges,
                                 num_rows, kz, n_ch, slope);
}

// K12-online's walk: K1/K12's edge walk with the row max as the shift.
template <typename T>
__global__ void __launch_bounds__(256) gat_fwd_online_kernel(
    const T* __restrict__ table, const float* __restrict__ adst,
    const float* __restrict__ m, const int* __restrict__ src,
    const int* __restrict__ dst, float* __restrict__ acc, long long num_edges,
    int num_rows, int kz, float slope) {
  gat::fwd_edges<T, false>(table, adst, m, src, dst, acc, num_edges, num_rows, kz,
                           1, slope);
}

// K12-online's row max, edge pass: key[d] = max ordered(act) over the real
// edges of row d (key starts at the image of -inf).
template <typename T>
__global__ void __launch_bounds__(256) gat_rowmax_kernel(
    const T* __restrict__ table, const float* __restrict__ adst,
    const int* __restrict__ src, const int* __restrict__ dst, int* __restrict__ key,
    long long num_edges, int num_rows, int kz, float slope) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < num_edges;
       e += step) {
    const int d = dst[e];
    if ((unsigned)d >= (unsigned)num_rows) continue;  // padding sentinel
    const float pre = adst[d] + gat::to_f32(table[(long long)src[e] * (kz + 1) + kz]);
    // the walk's own logit (edge_weight), so that in f32 act - m is
    // exactly 0 at the row's best edge
    const float act = pre > 0.f ? pre : __fmul_rn(slope, pre);
    atomicMax(key + d, gat::ordered(act));
  }
}

// K12-online's row max, row passes: set every key to the image of -inf
// (init), or turn the keys into m = round_T(max), 0 for an empty row.
template <typename T>
__global__ void __launch_bounds__(256) gat_rowmax_rows_kernel(float* __restrict__ m,
                                                              int num_rows, bool init) {
  int* key = reinterpret_cast<int*>(m);
  const int neg_inf = gat::ordered(__int_as_float(static_cast<int>(0xff800000u)));
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < num_rows;
       r += gridDim.x * blockDim.x) {
    if (init) {
      key[r] = neg_inf;
    } else {
      const int k = key[r];
      m[r] = k == neg_inf ? 0.f : gat::round_t<T>(gat::unordered(k));
    }
  }
}

unsigned thread_blocks(long long n) {
  long long blocks = (n + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride past this
  return (unsigned)(blocks > 0 ? blocks : 1);
}

template <typename T>
void launch_rowmax(cudaStream_t s, const void* table, const void* adst, const void* src,
                   const void* dst, void* m, long long num_edges, int num_rows, int kz,
                   float slope) {
  float* mf = static_cast<float*>(m);
  const unsigned rb = thread_blocks(num_rows);
  gat_rowmax_rows_kernel<T><<<rb, 256, 0, s>>>(mf, num_rows, true);
  gat_rowmax_kernel<T><<<thread_blocks(num_edges), 256, 0, s>>>(
      static_cast<const T*>(table), static_cast<const float*>(adst),
      static_cast<const int*>(src), static_cast<const int*>(dst), reinterpret_cast<int*>(mf),
      num_edges, num_rows, kz, slope);
  gat_rowmax_rows_kernel<T><<<rb, 256, 0, s>>>(mf, num_rows, false);
}

template <typename T>
void launch_online(unsigned blocks, cudaStream_t s, const void* table, const void* adst,
                   const void* m, const void* src, const void* dst, void* acc,
                   long long num_edges, int num_rows, int kz, float slope) {
  gat_fwd_online_kernel<T><<<blocks, 256, 0, s>>>(
      static_cast<const T*>(table), static_cast<const float*>(adst),
      static_cast<const float*>(m), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<float*>(acc), num_edges, num_rows, kz,
      slope);
}

template <typename T, bool RoundPFirst>
void launch(unsigned blocks, cudaStream_t s, const void* table, const void* adst,
            const void* mhat, const void* src, const void* dst, void* acc,
            long long num_edges, int num_rows, int kz, int n_ch, float slope) {
  gat_fwd_kernel<T, RoundPFirst><<<blocks, 256, 0, s>>>(
      static_cast<const T*>(table), static_cast<const float*>(adst),
      static_cast<const float*>(mhat), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<float*>(acc), num_edges,
      num_rows, kz, n_ch, slope);
}

}  // namespace

// Plain C entry for ctypes.  table: [n, n_ch*(kz+1)] T row-major (T = bf16
// when `bf16` else f32); adst/mhat: f32[n_ch, num_rows]; src/dst:
// int32[num_edges]; acc: f32[num_rows, n_ch*(kz+1)], zeroed by the caller.
// `round_p_first` selects K3's rounding points over K1's.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int gat_fwd(int device, const void* table, int bf16, int round_p_first,
                       const void* adst, const void* mhat, const void* src,
                       const void* dst, void* acc, long long num_edges,
                       int num_rows, int kz, int n_ch, float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_ch < 1 || n_ch > 8 || kz < 1) return (int)cudaErrorInvalidValue;
  if (num_edges > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned b = gat::warp_edge_blocks(num_edges);
    if (bf16 && round_p_first)
      launch<__nv_bfloat16, true>(b, s, table, adst, mhat, src, dst, acc, num_edges, num_rows, kz, n_ch, slope);
    else if (bf16)
      launch<__nv_bfloat16, false>(b, s, table, adst, mhat, src, dst, acc, num_edges, num_rows, kz, n_ch, slope);
    else if (round_p_first)
      launch<float, true>(b, s, table, adst, mhat, src, dst, acc, num_edges, num_rows, kz, n_ch, slope);
    else
      launch<float, false>(b, s, table, adst, mhat, src, dst, acc, num_edges, num_rows, kz, n_ch, slope);
  }
  return (int)cudaGetLastError();
}

// K12-online, pass 1.  table: [n, kz+1] T row-major [z | a_src]; adst:
// f32[num_rows] = round_T(a_dst); src/dst: int32[num_edges]; m:
// f32[num_rows], written whole.  Three launches on `stream` (set up, edges,
// decode); returns cudaGetLastError().
extern "C" int gat_rowmax(int device, const void* table, int bf16, const void* adst,
                          const void* src, const void* dst, void* m, long long num_edges,
                          int num_rows, int kz, float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kz < 1 || num_rows < 0 || num_edges < 0) return (int)cudaErrorInvalidValue;
  if (num_rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_rowmax<__nv_bfloat16>(s, table, adst, src, dst, m, num_edges, num_rows, kz, slope);
  else
    launch_rowmax<float>(s, table, adst, src, dst, m, num_edges, num_rows, kz, slope);
  return (int)cudaGetLastError();
}

// K12-online, pass 2: gat_fwd for one channel at K1's rounding points with
// m as the shift.  acc: f32[num_rows, kz+1], zeroed by the caller.
extern "C" int gat_fwd_online(int device, const void* table, int bf16, const void* adst,
                              const void* m, const void* src, const void* dst, void* acc,
                              long long num_edges, int num_rows, int kz, float slope,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kz < 1) return (int)cudaErrorInvalidValue;
  if (num_edges > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned b = gat::warp_edge_blocks(num_edges);
    if (bf16)
      launch_online<__nv_bfloat16>(b, s, table, adst, m, src, dst, acc, num_edges, num_rows, kz, slope);
    else
      launch_online<float>(b, s, table, adst, m, src, dst, acc, num_edges, num_rows, kz, slope);
  }
  return (int)cudaGetLastError();
}
