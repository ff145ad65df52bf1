// stream_gat: the streaming GAT over a loop-free edge list (the implicit
// self-loop graphs of the ML-25M and Yelp scale) for n_ch <= 8 channels
// that share one edge list, for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernels in ops/stream_gat.py:
//   _make_fwd_kernel (K9)      -> stream_gat_fwd_kernel
//   _make_bwd_dst_kernel (K10) -> stream_gat_bwd_dst_kernel
//   _make_bwd_src_kernel (K11) -> stream_gat_bwd_src_kernel
// launched by ops/stream_gat.stream_gat_fwd, stream_gat_bwd_dst and
// stream_gat_bwd_src.  The analytic self-loop term, the normalization and
// the stat table are plain torch in ops/stream_gat.StreamGAT, as the JAX
// package leaves them to XLA.  Per channel c and real edge (s, d):
//   K9:  p_c = exp(min(leaky(a_dst[c, d] + a_src_c[s]) - mhat[c, d], 60)),
//        acc[d, band c] += [ round_T(z_c[s] * round_T(p_c)) | round_T(p_c) ]
//        (ops/stream_gat.py:272-283: the rounding points of K3, so the
//        edge walk is gat_common.cuh's fwd_edges<T, true>, shared with
//        csrc/gat_fwd.cu);
//   K10, K11 recompute from the stat band st_c[d] = round_T([g_c | gout_c
//        | logden_c | a_dst_c]) (ops/stream_gat.py:311, 760):
//        pre  = a_dst + a_src_c[s],  att = exp(min(leaky(pre) - logden, 60))
//        datt = sum_k round_T(g_c[k] * z_c[s, k])        (f32 sum)
//        dpre = att * (datt - gout) * leaky'(pre)
//   K10: da_dst[c, d] += round_T(dpre)                   (:351-356)
//   K11: dpk[s, band c] += [ round_T(g_c * round_T(att)) | round_T(dpre) ]
//        over the src-sorted order                        (:426-444)
// round_T rounds through the transport type T (identity for f32,
// round-to-nearest-even for bf16).  Sums are f32, in an order that changes
// from run to run.
//
// What bounds them on the H100: bytes and atomics.  Per (edge, channel)
// they read a (kz+1)-wide source band (and the backwards a (kz+3)-wide
// stat band) and do ~2-4 kz flops; no tensor-core work exists.  The TPU
// kernels stream an XLA-gathered [E, n_ch*band] edge array and touch node
// tables only through 128-row one-hot windows; none of that is carried
// over.  The designs:
//   * rows are gathered inside the kernels, one warp per edge over
//     row-major tables ([n, n_ch*(kz+1)] bands [z_c | a_src_c], [num_rows,
//     n_ch*(kz+3)] stat bands), so no [E, n_ch*band] stream exists: at kz
//     125 and 8 channels it would be 2.13 M x 1,024 values, past 2^31.  Row
//     offsets are 64-bit;
//   * K9 and K10 walk the edges in the graph's block order and add with
//     f32 atomics into L2-resident accumulators (68,830 x 119 f32 = 32.8
//     MB at the widest ML-25M share, 7 channels at kz 16);
//   * K11 walks the src-sorted order (StepGraph.src_perm / src_sorted) and
//     reads dst[src_perm[e]] itself.  Edges sharing a src are contiguous
//     there, so a warp takes kRun consecutive edges and sums each src run
//     in registers, one atomic per column per run: the i2u graph's most
//     popular item has tens of thousands of out-edges, which per-edge
//     atomics would serialize on one row;
//   * padding edges (dst >= num_rows) are skipped before any other load.
//     In the src-sorted order they sit inside row 0's run (src 0; the
//     stable sort puts them after row 0's real edges), so K11 must drop
//     them, not count on zero stats.
// datt is a shuffle reduction per channel (lanes over the kz columns);
// lanes 0..n_ch-1 then form their channel's att and dpre, which the other
// lanes take by shuffle while the warp walks the row in 32-wide passes.

#include "gat_common.cuh"

namespace {

using gat::round_t;
using gat::to_f32;

constexpr int kRun = 32;  // src-sorted edges per warp task in K11

template <typename T>
__global__ void __launch_bounds__(256) stream_gat_fwd_kernel(
    const T* __restrict__ table, const float* __restrict__ adst,
    const float* __restrict__ mhat, const int* __restrict__ src,
    const int* __restrict__ dst, float* __restrict__ acc, long long num_edges,
    int num_rows, int kz, int n_ch, float slope) {
  gat::fwd_edges<T, true>(table, adst, mhat, src, dst, acc, num_edges, num_rows,
                          kz, n_ch, slope);
}

// att and dpre of one real edge for lane c < n_ch (channel c), 0 on the
// other lanes; every lane of the warp must call it.  row: the source's
// [z_c | a_src_c] bands; srow: the destination's [g_c | gout_c | logden_c |
// a_dst_c] stat bands, both in T.
template <typename T>
__device__ __forceinline__ void edge_grads(const T* __restrict__ row,
                                           const T* __restrict__ srow, int lane,
                                           int kz, int n_ch, float slope,
                                           float& att_out, float& dpre_out) {
  const int bz = kz + 1, sz = kz + 3;
  float datt_mine = 0.f;
  for (int c = 0; c < n_ch; ++c) {
    float part = 0.f;
    for (int f = lane; f < kz; f += 32)
      part = __fadd_rn(part, round_t<T>(__fmul_rn(to_f32(srow[c * sz + f]),
                                                  to_f32(row[c * bz + f]))));
    for (int o = 16; o > 0; o >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
    if (lane == c) datt_mine = part;
  }
  att_out = 0.f;
  dpre_out = 0.f;
  if (lane < n_ch) {
    const T* st = srow + lane * sz;
    const float pre = to_f32(st[kz + 2]) + to_f32(row[lane * bz + kz]);
    const float att = gat::edge_weight(pre, to_f32(st[kz + 1]), slope);
    const float dalpha = __fmul_rn(att, __fsub_rn(datt_mine, to_f32(st[kz])));
    att_out = att;
    dpre_out = pre > 0.f ? dalpha : __fmul_rn(dalpha, slope);
  }
}

template <typename T>
__global__ void __launch_bounds__(256) stream_gat_bwd_dst_kernel(
    const T* __restrict__ table, const T* __restrict__ stat,
    const int* __restrict__ src, const int* __restrict__ dst,
    float* __restrict__ dadst, long long num_edges, int num_rows, int kz,
    int n_ch, float slope) {
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long step = ((long long)gridDim.x * blockDim.x) >> 5;
  const int width = n_ch * (kz + 1), swidth = n_ch * (kz + 3);
  for (long long e = first; e < num_edges; e += step) {
    const int d = dst[e];
    if (d >= num_rows) continue;  // padding sentinel: skip before any load
    float att, dpre;
    edge_grads<T>(table + (long long)src[e] * width, stat + (long long)d * swidth,
                  lane, kz, n_ch, slope, att, dpre);
    if (lane < n_ch) atomicAdd(dadst + (long long)lane * num_rows + d, round_t<T>(dpre));
  }
}

// kPasses: 32-column passes over an output row of `width` <= 32 * kPasses
// columns; the run sums live in registers (the loops unroll).
template <typename T, int kPasses>
__global__ void __launch_bounds__(256) stream_gat_bwd_src_kernel(
    const T* __restrict__ table, const T* __restrict__ stat,
    const int* __restrict__ perm, const int* __restrict__ src_sorted,
    const int* __restrict__ dst, float* __restrict__ dpk, long long num_edges,
    int num_rows, int kz, int n_ch, float slope) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const int bz = kz + 1, sz = kz + 3;
  const int width = n_ch * bz, swidth = n_ch * sz;
  const int c0 = lane / bz, f0 = lane - c0 * bz;
  for (long long base = warp * kRun; base < num_edges; base += warps * kRun) {
    const long long end = base + kRun < num_edges ? base + kRun : num_edges;
    float run[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) run[p] = 0.f;
    int cur = -1;
    for (long long e = base; e < end; ++e) {
      const int d = dst[perm[e]];
      if (d >= num_rows) continue;  // padding: in row 0's run, src 0
      const int s = src_sorted[e];
      if (s != cur) {
        if (cur >= 0) {
          float* out = dpk + (long long)cur * width;
#pragma unroll
          for (int p = 0; p < kPasses; ++p) {
            const int j = lane + 32 * p;
            if (j < width) atomicAdd(out + j, run[p]);
            run[p] = 0.f;
          }
        }
        cur = s;
      }
      const T* srow = stat + (long long)d * swidth;
      float att_mine, dpre_mine;
      edge_grads<T>(table + (long long)s * width, srow, lane, kz, n_ch, slope,
                    att_mine, dpre_mine);
      att_mine = round_t<T>(att_mine);
      dpre_mine = round_t<T>(dpre_mine);
      int c = c0, f = f0;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        if (32 * p < width) {  // warp-uniform: every lane reaches the shuffles
          const int j = lane + 32 * p;
          const int from = min(c, n_ch - 1);
          const float att = __shfl_sync(0xffffffffu, att_mine, from);
          const float dpre = __shfl_sync(0xffffffffu, dpre_mine, from);
          if (j < width)
            run[p] = __fadd_rn(run[p], f < kz ? round_t<T>(__fmul_rn(
                                                    to_f32(srow[c * sz + f]), att))
                                              : dpre);
          for (f += 32; f >= bz; f -= bz) ++c;
        }
      }
    }
    if (cur >= 0) {
      float* out = dpk + (long long)cur * width;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int j = lane + 32 * p;
        if (j < width) atomicAdd(out + j, run[p]);
      }
    }
  }
}

unsigned run_blocks(long long num_edges) {
  long long blocks = ((num_edges + kRun - 1) / kRun * 32 + 255) / 256;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride past this
  return (unsigned)(blocks > 0 ? blocks : 1);
}

bool bad_layout(int kz, int n_ch) { return n_ch < 1 || n_ch > 8 || kz < 1 || kz > 125; }

}  // namespace

// Plain C entries for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a layout it refuses:
// 1 <= n_ch <= 8, 1 <= kz <= 125).  T = bf16 when `bf16` else f32.
// table: [n, n_ch*(kz+1)] T row-major bands [z_c | a_src_c]; stat:
// [num_rows, n_ch*(kz+3)] T bands [g_c | gout_c | logden_c | a_dst_c];
// ids int32[num_edges], padding dst >= num_rows.

// adst/mhat: f32[n_ch, num_rows]; acc: f32[num_rows, n_ch*(kz+1)], zeroed
// by the caller.
extern "C" int stream_gat_fwd(int device, const void* table, int bf16, const void* adst,
                              const void* mhat, const void* src, const void* dst,
                              void* acc, long long num_edges, int num_rows, int kz,
                              int n_ch, float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_layout(kz, n_ch) || num_edges < 0) return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = gat::warp_edge_blocks(num_edges);
#define ARGS                                                                   \
  static_cast<const float*>(adst), static_cast<const float*>(mhat),            \
      static_cast<const int*>(src), static_cast<const int*>(dst),              \
      static_cast<float*>(acc), num_edges, num_rows, kz, n_ch, slope
  if (bf16)
    stream_gat_fwd_kernel<__nv_bfloat16><<<b, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(table), ARGS);
  else
    stream_gat_fwd_kernel<float><<<b, 256, 0, s>>>(static_cast<const float*>(table), ARGS);
#undef ARGS
  return (int)cudaGetLastError();
}

// src/dst: the graph's block order; dadst: f32[n_ch, num_rows], zeroed by
// the caller.
extern "C" int stream_gat_bwd_dst(int device, const void* table, int bf16, const void* stat,
                                  const void* src, const void* dst, void* dadst,
                                  long long num_edges, int num_rows, int kz, int n_ch,
                                  float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_layout(kz, n_ch) || num_edges < 0) return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = gat::warp_edge_blocks(num_edges);
#define ARGS                                                                   \
  static_cast<const int*>(src), static_cast<const int*>(dst),                  \
      static_cast<float*>(dadst), num_edges, num_rows, kz, n_ch, slope
  if (bf16)
    stream_gat_bwd_dst_kernel<__nv_bfloat16><<<b, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(table),
        static_cast<const __nv_bfloat16*>(stat), ARGS);
  else
    stream_gat_bwd_dst_kernel<float><<<b, 256, 0, s>>>(
        static_cast<const float*>(table), static_cast<const float*>(stat), ARGS);
#undef ARGS
  return (int)cudaGetLastError();
}

// perm/src_sorted: the graph's stable src sort (src_sorted[e] ==
// src[perm[e]]); dst: the block-ordered dst, read as dst[perm[e]]; dpk:
// f32[n, n_ch*(kz+1)] bands [dz_c | da_src_c], zeroed by the caller.
extern "C" int stream_gat_bwd_src(int device, const void* table, int bf16, const void* stat,
                                  const void* perm, const void* src_sorted, const void* dst,
                                  void* dpk, long long num_edges, int num_rows, int kz,
                                  int n_ch, float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_layout(kz, n_ch) || num_edges < 0) return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = run_blocks(num_edges);
  const bool narrow = n_ch * (kz + 1) <= 128;
#define ARGS                                                                   \
  static_cast<const int*>(perm), static_cast<const int*>(src_sorted),          \
      static_cast<const int*>(dst), static_cast<float*>(dpk), num_edges,       \
      num_rows, kz, n_ch, slope
  if (bf16) {
    const auto* t = static_cast<const __nv_bfloat16*>(table);
    const auto* st = static_cast<const __nv_bfloat16*>(stat);
    if (narrow)
      stream_gat_bwd_src_kernel<__nv_bfloat16, 4><<<b, 256, 0, s>>>(t, st, ARGS);
    else
      stream_gat_bwd_src_kernel<__nv_bfloat16, 32><<<b, 256, 0, s>>>(t, st, ARGS);
  } else {
    const auto* t = static_cast<const float*>(table);
    const auto* st = static_cast<const float*>(stat);
    if (narrow)
      stream_gat_bwd_src_kernel<float, 4><<<b, 256, 0, s>>>(t, st, ARGS);
    else
      stream_gat_bwd_src_kernel<float, 32><<<b, 256, 0, s>>>(t, st, ARGS);
  }
#undef ARGS
  return (int)cudaGetLastError();
}
