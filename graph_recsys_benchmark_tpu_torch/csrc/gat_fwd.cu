// gat_fwd: single-head GAT forward with the bound-shift softmax for n_ch <= 8
// channels that share one edge list, for Hopper (sm_90a).
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
