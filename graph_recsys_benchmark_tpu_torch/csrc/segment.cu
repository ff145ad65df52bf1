// segment: the edge pipeline's sum-by-id and row gather for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernels in ops/pallas_segment.py:
//   _make_segsum_kernel (K5)    -> scatter_add by dst:  out[d] = Σ_{dst[e]=d} msgs[e]
//   _make_scatter_kernel (K6)   -> scatter_add by src:  out[i] = Σ_{idx[e]=i} ct[e]
//   _make_broadcast_kernel (K7) -> row_gather:          out[e] = v[idx[e]]
//   _softmax_stats_kernel (K8)  -> softmax_stats:       out[d] = [max_e a_e |
//                                  Σ_e exp(a_e - max)] over dst[e] = d
// launched by ops/segment_kernels.sorted_segment_sum (K5),
// localized_scatter_add (K6), sorted_broadcast (K7) and softmax_stats (K8).  On the TPU, K5
// and K6 are two kernels because the MXU wants a sorted dst for the
// segment-sum and a VMEM-resident table for the unordered scatter; both
// compute a sum by id, and on the H100 one kernel does.  The TPU kernels
// resolve each edge chunk against a 128-row window with a one-hot MXU
// matmul; none of that is carried over: rows are read and written directly.
//
// What bounds them on the H100: bytes.  Each moves its [E, D] edge array
// once (f32 or bf16) and an [N, D] node table (N << E at the flagship:
// 15,210 rows against 154k-663k edges) and does at most one add per
// element; there is no tensor-core work.  The designs:
//   * scatter_add (K5, K6).  f32 atomics into the caller's zeroed [N, D]
//     accumulator (3.9 MB at the flagship: it stays in the 50 MB L2), four
//     columns in one of Hopper's 16-byte vector atomics (float4); a group
//     of threads takes one edge's row (16 B f32 / 8 B bf16 a thread), so
//     loads are coalesced.  An edge grid balances any degree skew.  K5's
//     block-monotone dst order is not needed.  A first design used it: one
//     CTA per 128-row dst block summing in a shared-memory tile, no global
//     atomics, each output row written once.  At the flagship it took
//     0.25-1.19 ms a call against 0.03-0.11 ms for this one (H100 80GB HBM3
//     at 700 W, chip_smoke.py; PERF.md): the union graphs' busiest dst block
//     holds 12.6x the mean block's edges (17,949 against 1,421 at PEAGCN
//     step 1), and that one CTA set the time.
//     Ids outside [0, num_rows) are dropped (K5's padding sentinel dst ==
//     num_rows); K6's padding edges carry zero ct at idx 0 (graph.py).
//   * row_gather (K7).  A pure copy, so it moves raw words: the widest of
//     16/8/4/2 bytes that divides the row and the pointers.  A group of
//     threads copies one row, neighbouring groups take neighbouring edges,
//     so the loads of a row and all stores are coalesced.  idx outside
//     [0, num_rows) -- the padding sentinel -- writes zeros and reads
//     nothing.
//   * softmax_stats (K8).  The TPU kernel keeps a running max and rescales
//     its sum as it walks a dst block's edge chunks, which is how it fits
//     one pass into VMEM; the function is the per-dst max and sum-exp.
//     Here an edge grid makes two passes of f32 atomics (the logits, 4 B
//     an edge, and the [N, 2] table stay in L2 between them): atomicMax of
//     the max through the order-preserving int image of a float, then
//     atomicAdd of exp(a - max); two row passes set the table up and turn
//     the ints back into floats.  A row with no edges keeps max -inf.
// Sums are f32 whatever the input type (bf16 inputs are widened exactly),
// in an order that changes from run to run.  Columns: d <= 256, rows of at
// most 4 KB for row_gather; the wrappers check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// V consecutive elements of T at p, widened to f32: V == 4 is one 16-byte
// (f32) or 8-byte (bf16) load, p aligned to it; V == 1 one element.
template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&o)[V]) {
  if constexpr (V == 1) {
    o[0] = to_f32(__ldg(p));
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "f32 vectors are float4");
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    static_assert(V == 4, "bf16 vectors are 4 x bf16");
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) scatter_add_kernel(
    const T* __restrict__ rows, const int* __restrict__ idx, float* __restrict__ out,
    long long num_edges, int num_rows, int d) {
  // thread -> (edge slot, V-column group); `per` edges a block pass
  const int dv = d / V;
  const int per = blockDim.x / dv;
  const int slot = threadIdx.x / dv;
  const int c = (threadIdx.x - slot * dv) * V;
  if (slot >= per) return;
  const long long step = (long long)gridDim.x * per;
  for (long long e = (long long)blockIdx.x * per + slot; e < num_edges; e += step) {
    const int r = idx[e];
    if ((unsigned)r >= (unsigned)num_rows) continue;
    float m[V];
    load_f32<T, V>(rows + e * d + c, m);
    float* o = out + (long long)r * d + c;
    if constexpr (V == 1)
      atomicAdd(o, m[0]);
    else  // sm_90 vector atomic; o is 16-byte aligned (d % 4 == 0)
      atomicAdd(reinterpret_cast<float4*>(o), make_float4(m[0], m[1], m[2], m[3]));
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads) row_gather_kernel(
    const W* __restrict__ v, const int* __restrict__ idx, W* __restrict__ out,
    long long num_edges, int num_rows, int words) {
  const int per = blockDim.x / words;
  const int slot = threadIdx.x / words;
  const int w = threadIdx.x - slot * words;
  if (slot >= per) return;
  const long long step = (long long)gridDim.x * per;
  for (long long e = (long long)blockIdx.x * per + slot; e < num_edges; e += step) {
    const int r = idx[e];
    W val{};
    if ((unsigned)r < (unsigned)num_rows) val = __ldg(v + (long long)r * words + w);
    out[e * words + w] = val;
  }
}

// A float's order-preserving int image (and back): ints compare as the
// floats do, -0 below +0, so atomicMax on the image is a float max.
__device__ __forceinline__ int ordered(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// stats: [num_rows, 2] rows [max | sum]; column 0 holds the int image of
// the max between softmax_rows(true) and softmax_rows(false).
__global__ void __launch_bounds__(kThreads) softmax_rows_kernel(float* __restrict__ stats,
                                                                int num_rows, bool init) {
  int* key = reinterpret_cast<int*>(stats);
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < num_rows;
       r += gridDim.x * blockDim.x) {
    if (init) {
      key[2 * r] = ordered(__int_as_float(static_cast<int>(0xff800000u)));  // -inf
      stats[2 * r + 1] = 0.f;
    } else {
      stats[2 * r] = unordered(key[2 * r]);
    }
  }
}

template <bool Sum>
__global__ void __launch_bounds__(kThreads) softmax_edges_kernel(
    const float* __restrict__ alpha, const int* __restrict__ dst,
    float* __restrict__ stats, long long num_edges, int num_rows) {
  int* key = reinterpret_cast<int*>(stats);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < num_edges;
       e += step) {
    const int d = dst[e];
    if ((unsigned)d >= (unsigned)num_rows) continue;  // padding sentinel
    const float a = alpha[e];
    if (Sum)
      atomicAdd(stats + 2 * (long long)d + 1, expf(__fsub_rn(a, unordered(key[2 * (long long)d]))));
    else
      atomicMax(key + 2 * (long long)d, ordered(a));
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

unsigned edge_blocks(long long num_edges, int per) {
  long long blocks = (num_edges + per - 1) / per;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride past this
  return (unsigned)(blocks > 0 ? blocks : 1);
}

template <typename T, int V>
void launch_scatter_add(cudaStream_t s, const void* rows, const void* idx, void* out,
                        long long num_edges, int num_rows, int d) {
  scatter_add_kernel<T, V><<<edge_blocks(num_edges, kThreads / (d / V)), kThreads, 0, s>>>(
      static_cast<const T*>(rows), static_cast<const int*>(idx), static_cast<float*>(out),
      num_edges, num_rows, d);
}

template <typename W>
void launch_row_gather(cudaStream_t s, const void* v, const void* idx, void* out,
                       long long num_edges, int num_rows, int row_bytes) {
  const int words = row_bytes / (int)sizeof(W);
  row_gather_kernel<W><<<edge_blocks(num_edges, kThreads / words), kThreads, 0, s>>>(
      static_cast<const W*>(v), static_cast<const int*>(idx), static_cast<W*>(out),
      num_edges, num_rows, words);
}

}  // namespace

// Plain C entries for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses).
// int32 ids.  The vector paths are taken when the row width and the
// pointers allow them.

// rows: [num_edges, d], bf16 when `bf16` else f32; idx: [num_edges], any
// order, ids outside [0, num_rows) dropped; out: [num_rows, d] f32, zeroed
// by the caller.
extern "C" int scatter_add(int device, const void* rows, int bf16, const void* idx, void* out,
                           long long num_edges, int num_rows, int d, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > kMaxCols || num_edges < 0) return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && aligned(rows, bf16 ? 8 : 16) && aligned(out, 16);
  if (bf16)
    vec ? launch_scatter_add<__nv_bfloat16, 4>(s, rows, idx, out, num_edges, num_rows, d)
        : launch_scatter_add<__nv_bfloat16, 1>(s, rows, idx, out, num_edges, num_rows, d);
  else
    vec ? launch_scatter_add<float, 4>(s, rows, idx, out, num_edges, num_rows, d)
        : launch_scatter_add<float, 1>(s, rows, idx, out, num_edges, num_rows, d);
  return (int)cudaGetLastError();
}

// v: [num_rows, row_bytes] of any type; idx: [num_edges]; out: [num_edges,
// row_bytes]; idx outside [0, num_rows) gives a zero row.
extern "C" int row_gather(int device, const void* v, const void* idx, void* out,
                          long long num_edges, int num_rows, int row_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the widest word that divides the row and both pointers; a row is at
  // most kThreads words (one thread a word)
  const uintptr_t a = reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
                      (uintptr_t)row_bytes;
  const int ws = a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
  if (row_bytes < 2 || a % 2 != 0 || row_bytes / ws > kThreads || num_edges < 0)
    return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ws == 16)
    launch_row_gather<uint4>(s, v, idx, out, num_edges, num_rows, row_bytes);
  else if (ws == 8)
    launch_row_gather<uint2>(s, v, idx, out, num_edges, num_rows, row_bytes);
  else if (ws == 4)
    launch_row_gather<unsigned>(s, v, idx, out, num_edges, num_rows, row_bytes);
  else
    launch_row_gather<unsigned short>(s, v, idx, out, num_edges, num_rows, row_bytes);
  return (int)cudaGetLastError();
}

// alpha: f32[num_edges] logits; dst: int32[num_edges], any order, ids
// outside [0, num_rows) dropped; stats: f32[num_rows, 2], written whole
// (rows [max | sum of exp(alpha - max)], max -inf for a row with no edge).
// Four launches on `stream`: set up, max pass, sum pass, decode.
extern "C" int softmax_stats(int device, const void* alpha, const void* dst, void* stats,
                             long long num_edges, int num_rows, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_edges < 0 || num_rows < 0) return (int)cudaErrorInvalidValue;
  if (num_rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  const auto* a = static_cast<const float*>(alpha);
  const auto* d = static_cast<const int*>(dst);
  const unsigned rb = edge_blocks(num_rows, kThreads);
  softmax_rows_kernel<<<rb, kThreads, 0, s>>>(st, num_rows, true);
  if (num_edges > 0) {
    const unsigned eb = edge_blocks(num_edges, kThreads);
    softmax_edges_kernel<false><<<eb, kThreads, 0, s>>>(a, d, st, num_edges, num_rows);
    softmax_edges_kernel<true><<<eb, kThreads, 0, s>>>(a, d, st, num_edges, num_rows);
  }
  softmax_rows_kernel<<<rb, kThreads, 0, s>>>(st, num_rows, false);
  return (int)cudaGetLastError();
}
