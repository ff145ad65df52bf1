// gat_common: device helpers shared by the GAT kernels (gat_fwd.cu,
// gat_bwd.cu, gat_bwd_onepass.cu, stream_gat.cu; segment.cu takes the
// ordered-int image), and the forward edge walk that the flash and
// batched forwards (K1, K12, K3) run.  The streaming forward (K9) sums the
// same terms with its own dst-block pieces (stream_gat.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gat {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// round_T: identity for f32, round-to-nearest-even through bf16.
template <typename T>
__device__ __forceinline__ float round_t(float v);
template <>
__device__ __forceinline__ float round_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_t<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// f32 -> T: identity for f32, round-to-nearest-even to bf16 (exact for a
// value already rounded through T).
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A float's order-preserving int image (and back): ints compare as the
// floats do, -0 below +0, so atomicMax on the image is a float max
// (segment.cu's K8, gat_fwd.cu's row max).
__device__ __forceinline__ int ordered(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// The softmax weight of one (edge, channel): exp(min(leaky(pre) - shift,
// 60)).  The _rn intrinsics keep nvcc from contracting into an FMA, so the
// logit rounds exactly as the plain versions' separate multiply and
// subtract.
__device__ __forceinline__ float edge_weight(float pre, float shift, float slope) {
  const float act = pre > 0.f ? pre : __fmul_rn(slope, pre);
  return expf(fminf(__fsub_rn(act, shift), 60.f));
}

// Blocks for a one-warp-per-edge grid of 256-thread blocks, grid-stride
// past 64 blocks per SM.
inline unsigned warp_edge_blocks(long long num_edges) {
  long long blocks = (num_edges * 32 + 255) / 256;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

// Forward edge walk, one warp per edge, for n_ch <= 8 channels that share
// one edge list.  Per channel c and edge (s, d) with d < num_rows:
//   p_c   = exp(min(leaky(a_dst[c, d] + a_src_c[s]) - mhat[c, d], 60))
//   acc[d, band c] += [ round_T(z_c[s] * q_c) | round_T(p_c) ]  (f32 atomics)
// with q_c = round_T(p_c) when RoundPFirst (K3) and p_c otherwise (K1,
// K12).  table: [n, n_ch*(kz+1)] row-major bands [z_c | a_src_c]; lanes
// 0..n_ch-1 each form one channel's p_c, the other lanes take theirs by
// warp shuffle while the warp walks the row in 32-wide passes, stepping
// its (channel, column) without a division.  Padding edges (dst >=
// num_rows) are skipped before any other load.
template <typename T, bool RoundPFirst>
__device__ __forceinline__ void fwd_edges(
    const T* __restrict__ table, const float* __restrict__ adst,
    const float* __restrict__ mhat, const int* __restrict__ src,
    const int* __restrict__ dst, float* __restrict__ acc, long long num_edges,
    int num_rows, int kz, int n_ch, float slope) {
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long step = ((long long)gridDim.x * blockDim.x) >> 5;
  const int bz = kz + 1;
  const int width = n_ch * bz;
  const int c0 = lane / bz, f0 = lane - c0 * bz;
  for (long long e = first; e < num_edges; e += step) {
    const int d = dst[e];
    if (d >= num_rows) continue;  // padding sentinel: skip before any load
    const T* row = table + (long long)src[e] * width;
    float p_mine = 0.f;
    if (lane < n_ch) {
      const long long cd = (long long)lane * num_rows + d;
      p_mine = edge_weight(adst[cd] + to_f32(row[lane * bz + kz]), mhat[cd], slope);
      if (RoundPFirst) p_mine = round_t<T>(p_mine);
    }
    float* out = acc + (long long)d * width;
    // warp-uniform trip count: every lane reaches the shuffle
    int c = c0, f = f0;
    for (int j = lane; j - lane < width; j += 32) {
      const float p = __shfl_sync(0xffffffffu, p_mine, min(c, n_ch - 1));
      if (j < width)
        atomicAdd(out + j, round_t<T>(f < kz ? __fmul_rn(to_f32(row[j]), p) : p));
      for (f += 32; f >= bz; f -= bz) ++c;
    }
  }
}

}  // namespace gat
