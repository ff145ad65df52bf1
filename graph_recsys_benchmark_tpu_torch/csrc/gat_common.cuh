// gat_common: device helpers shared by the GAT kernels (gat_fwd.cu: K1/K12,
// K3 and K12-online on the graph's walk by dst; gat_bwd.cu: K2, K4 and K14
// on its walk by source, and K13; stream_gat.cu: K9-K11); segment.cu takes
// the ordered-int image.
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
// (segment.cu's K8; gat_fwd.cu's row max, as an unsigned key).
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

// Floats of one worker's row in shared memory in the GAT walks (gat_fwd.cu
// by dst, gat_bwd.cu by source): the whole padded row of `stride` floats,
// or where one channel takes passes of `cols` columns, a pass's columns
// and the 4 after them (the last pass's p or dpre column and the padding).
__host__ __device__ __forceinline__ int walk_row_floats(int stride, int cols, bool passes) {
  return passes && stride > cols + 4 ? cols + 4 : stride;
}

// Blocks for a one-warp-per-edge grid of 256-thread blocks (K13's glue
// kernel, gat_bwd.cu), grid-stride past 64 blocks per SM.
inline unsigned warp_edge_blocks(long long num_edges) {
  long long blocks = (num_edges * 32 + 255) / 256;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace gat
