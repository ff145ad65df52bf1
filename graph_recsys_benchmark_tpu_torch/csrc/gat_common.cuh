// gat_common: device helpers shared by the GAT kernels (gat_fwd.cu: K1/K12,
// K3 and K12-online on the graph's walk by dst; gat_bwd.cu: K2, K4 and K14
// on its walk by source, K13 on its walk by dst; stream_gat.cu: K9-K11);
// segment.cu takes the ordered-int image.  The walks' slice loop is
// walk_slice below.
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

// One worker's slice of a graph walk, shared by the GAT walks (gat_fwd.cu:
// K1/K12 and K3 by dst; gat_bwd.cu: K2, K4 and K14 by source, K13 by dst).
// Position k of the walk is edge e = perm[k], whose key ids[k] is its dst
// where ByDst, else its source; other[e] is the edge's other end.  A worker
// of GE lanes (32 / GE a warp) takes positions [k0, k0 + slice): its lanes
// load GE of them at once, then shuffle each one's (e, s, d) to the whole
// worker (e only where Edges; else -1).  For each position in order,
// edge(e, s, d, real, fresh) runs, real being d < num_rows and fresh a real
// edge whose key differs from the run before; run_end(key) closes a run
// just before the next run's first edge, and after the slice.  Padding
// edges (d >= num_rows) neither add to nor end a run and read no other end
// where ByDst (they sort last there); positions past the walk come as
// padding with e = -1.  Every worker of a warp runs the same trip counts,
// so shuffles in `edge` see every lane.
template <int GE, bool ByDst, bool Edges, typename Edge, typename RunEnd>
__device__ __forceinline__ void walk_slice(const int* __restrict__ perm,
                                           const int* __restrict__ ids,
                                           const int* __restrict__ other, long long k0,
                                           int slice, long long num_edges, int num_rows,
                                           Edge&& edge, RunEnd&& run_end) {
  const int wl = threadIdx.x & (GE - 1);
  int cur = -1;  // the run's key; -1 before the slice's first real edge
  for (int kb = 0; kb < slice; kb += GE) {
    int my_e = -1, my_s = 0, my_d = num_rows;
    if (kb + wl < slice && k0 + kb + wl < num_edges) {
      const long long k = k0 + kb + wl;
      const int key = __ldg(ids + k);
      if (ByDst) {
        my_d = key;
        if (Edges) my_e = __ldg(perm + k);
        if (key < num_rows) my_s = __ldg(other + (Edges ? my_e : __ldg(perm + k)));
      } else {
        my_s = key;
        my_d = __ldg(other + __ldg(perm + k));
      }
    }
    for (int i = 0; i < GE && i < slice; ++i) {
      const int e = Edges ? __shfl_sync(0xffffffffu, my_e, i, GE) : -1;
      const int s = __shfl_sync(0xffffffffu, my_s, i, GE);
      const int d = __shfl_sync(0xffffffffu, my_d, i, GE);
      const bool real = d < num_rows;  // uniform in the worker
      const int key = ByDst ? d : s;
      const bool fresh = real && key != cur;
      if (fresh && cur >= 0) run_end(cur);
      edge(e, s, d, real, fresh);
      if (real) cur = key;
    }
  }
  if (cur >= 0) run_end(cur);
}

}  // namespace gat
