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
// What bounds them on the H100: bytes, and for K5 and K6 the atomics.  Each
// moves its [E, D] edge array once (f32 or bf16) and an [N, D] node table
// and does at most one add per element; there is no tensor-core work.  The
// numbers below are chip_smoke.py's on one NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md section 6), at the ML-25M composed GAT's recorded calls (68,830
// rows; 85k-197k edges; widths 1, 2, 16, 17, 64 and the packed [h | a_src]
// rows of 65) and the flagship's union graphs (15,210 rows, 154k-663k
// edges, widths 16 and 64).  The designs:
//   * scatter_add (K5, K6): f32 atomics into the caller's zeroed
//     accumulator, over a walk of the edges.  A group of lanes takes
//     `slice` consecutive positions of the walk, each lane 4 columns; it
//     sums each run of equal ids in registers and adds the run's sum with
//     one vector atomic (float4; float2 or scalar for D 2 or 1) when the id
//     changes.  The walk is (perm, ids[perm]): the graph's sort by id
//     (StepGraph.dst_perm for K5, src_perm for K6), every id's edges one
//     run, the rows read through the permutation; or perm NULL and the
//     edges' own order.  The kernel sums by the walk's ids, so they must be
//     ids[perm] of the ids the caller means; the order only sets the runs.
//     K13's K6 walks the edges' own order: on the union graph block order
//     already runs a source's edges together, and the two walks tie there
//     (PERF.md section 6; on K13's rows 0.028 ms in the edges' order
//     against 0.029 on the walk by source, f32, torch_tools/gat_bwd_walk.py).  The accumulator's rows are padded to a multiple
//     of 4 columns (68 for 65, 20 for 17) so that every row takes 16-byte
//     atomics; the wrapper hands back a view of its first D columns.  Why:
//     the design before it, one atomic per (edge, 4 columns) in the edges'
//     order, ran the 15 K6 calls of an ML-25M step at 32 % of their byte
//     bound (0.62 ms): a row of 65 or 17 has no 16-byte vector path, so
//     every element took its own 4-byte load and scalar atomic (65 an
//     edge); and the runs of equal ids in the edge order are 1.00 (K5 by
//     dst) and 1.18 (K6 by src) edges long against 2.18 in a whole call, so
//     nothing was summed before the atomic.  An edge order cut at the
//     128-row dst blocks and sorted by row in shared memory (K9's design)
//     would reach 2.02 for K5 and 1.26 for K6 (2,048-edge chunks).  The
//     slice, chosen in the C entry from the call's shape: 4 for D <= 2 (so
//     that a narrow call fills the card), else 8, or 16 where the call
//     averages more than 4 edges an id (the flagship's union graphs, where
//     longer runs fold more); torch_tools/segment_variants.py measures the
//     other slices.  What is left is the zeroing (a memset of the
//     accumulator, about 0.04 ms of an ML-25M step's 0.33 ms of width-64 K5
//     calls) and the atomics' read-modify-write of an accumulator that the
//     edge rows stream past in L2; a design that writes each row once would
//     need a second launch for runs cut by a slice (ROADMAP).
//     The design before that one, one CTA per 128-row dst block summing in
//     shared memory, took 0.25-1.19 ms a flagship call against 0.03-0.11 ms
//     for atomics: the union graphs' busiest dst block holds 12.6x the mean
//     block's edges, and that one CTA set the time.
//     Ids outside [0, num_rows) are dropped (K5's padding sentinel dst ==
//     num_rows); K6's padding edges carry zero ct at idx 0 (graph.py).
//   * row_gather (K7).  A pure copy, so it moves raw words: the widest of
//     16/8/4/2 bytes that divides the row and the pointers.  The output is
//     one flat array of words, cut into tiles of whole rows (256 x U words);
//     a thread copies U words of a tile (U = 2 for 16-byte words, else 4,
//     more where one row outgrows a tile), loading the tile's ids first,
//     then U independent rows' words, then storing U coalesced words; up to
//     132 x 32 CTAs, which loop over the tiles past that.  So no lane idles
//     because of the width: the design before it gave a row a group of
//     lanes, one word each, which left 61 of 256 lanes idle at 65 words and
//     held one 4-byte word in flight a thread, and ran the 11 width-65 f32
//     calls of an ML-25M step at 41 % of their byte bound (64: 72 %).  idx
//     outside [0, num_rows) -- the padding sentinel -- writes zeros and
//     reads nothing.
//   * softmax_stats (K8).  The TPU kernel keeps a running max and rescales
//     its sum as it walks a dst block's edge chunks, which is how it fits
//     one pass into VMEM; the function is the per-dst max and sum-exp.
//     Its time here is launches and latency, not bytes (a composed ML-25M
//     graph's 168,830 logits and ids are 1.35 MB, 0.4 us at 3.35 TB/s): an
//     edge grid of global atomics took four launches a call (set-up, max,
//     sum, decode).  So one launch, one CTA a 128-row dst block of a
//     block-monotone dst (StepGraph.block_bounds): the CTA zeroes its rows'
//     sums, takes its block's max by row in shared memory through the
//     order-preserving int image of a float (atomicMax, native there),
//     staging up to kSoftmaxStage logits and ids as it goes, writes the
//     rows' max, then adds each exp(a - the row's final max) into its
//     rows' sums in global memory (from the staged edges, past
//     kSoftmaxStage from global memory again, L2-hot).  Each term is
//     exp(a - final max), as the plain version's, with no running
//     rescale; a row with no edge gets (-inf, 0).  The sums go to global
//     memory because sm_90 has no native shared f32 add: nvcc emits a
//     compare-and-swap loop (ATOMS.CAST.SPIN), which slowed the busiest
//     block (16,282 edges over 128 rows of ~127 each, in ML-25M's
//     composed u2t and i2t graphs) in trial builds on one H100; a global
//     f32 reduction is native.  Each thread loads kSoftmaxUnroll
//     edges before it uses them, so the busiest block's loads overlap.
// Sums are f32 whatever the input type (bf16 inputs are widened exactly),
// in an order that changes from run to run.  Columns: scatter_add takes
// d <= 256 a launch and reads and writes rows of a row stride of its own,
// so its wrappers take a wider row in passes of at most 256 columns, one
// launch a pass; row_gather takes rows of at most 4 KB at any alignment,
// and its wrapper gathers a wider row as pieces of it in one launch.

#include <stdint.h>

#include "gat_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 256;
constexpr int kRunUnroll = 4;  // edges a lane loads before it adds them (scatter_add)
constexpr int kMaxWords = 8;   // words a thread copies, at most (row_gather)
constexpr long long kMaxCtas = 132LL * 32;  // row_gather's grid, at most

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Columns c .. c+V-1 of one row of T at p (row width d), widened to f32;
// columns >= d read as 0.  kVec: one V-element load (p + c aligned to it).
template <typename T, int V, bool kVec>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, int c, int d, float (&o)[V]) {
  if constexpr (kVec && V == 4 && sizeof(T) == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + c));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if constexpr (kVec && V == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + c));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else if constexpr (kVec && V == 2 && sizeof(T) == 4) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p + c));
    o[0] = v.x; o[1] = v.y;
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) o[t] = c + t < d ? to_f32(__ldg(p + c + t)) : 0.f;
  }
}

// One lane's V columns of a run's sum into out (16- or 8-byte aligned for
// V 4 or 2: sm_90's vector atomics).
template <int V>
__device__ __forceinline__ void add_cols(float* o, const float (&a)[V]) {
  if constexpr (V == 4)
    atomicAdd(reinterpret_cast<float4*>(o), make_float4(a[0], a[1], a[2], a[3]));
  else if constexpr (V == 2)
    atomicAdd(reinterpret_cast<float2*>(o), make_float2(a[0], a[1]));
  else
    atomicAdd(o, a[0]);
}

// K5, K6: out[ids[k]] += rows[perm ? perm[k] : k] over the walk k = 0 ..
// num_edges-1, d columns of rows ld_in apart into rows of out ld_out
// apart.  A group of G = stride / V lanes takes `slice` consecutive
// positions of the walk, each lane V columns; it sums a run of equal ids in
// registers and adds the sum with one atomic when the id changes (and at
// the slice's end).  ids outside [0, num_rows) are dropped.
template <typename T, int V, bool kVec>
__global__ void __launch_bounds__(kThreads) scatter_add_kernel(
    const T* __restrict__ rows, const int* __restrict__ perm, const int* __restrict__ ids,
    float* __restrict__ out, long long num_edges, int num_rows, int d, int stride, int slice,
    int ld_in, int ld_out) {
  const int group = stride / V;
  const int n_groups = kThreads / group;
  const int grp = threadIdx.x / group;
  if (grp >= n_groups) return;
  const int c = (threadIdx.x - grp * group) * V;
  const long long k0 = ((long long)blockIdx.x * n_groups + grp) * slice;
  const long long k1 = min(k0 + slice, num_edges);
  int cur = -1;
  float acc[V];
#pragma unroll
  for (int t = 0; t < V; ++t) acc[t] = 0.f;
  for (long long k = k0; k < k1; k += kRunUnroll) {
    int id[kRunUnroll];
    long long e[kRunUnroll];
#pragma unroll
    for (int u = 0; u < kRunUnroll; ++u) {
      const long long kk = k + u;
      id[u] = kk < k1 ? __ldg(ids + kk) : -1;
      e[u] = kk < k1 ? (perm ? (long long)__ldg(perm + kk) : kk) : 0;
    }
    float x[kRunUnroll][V];
#pragma unroll
    for (int u = 0; u < kRunUnroll; ++u) {
      if ((unsigned)id[u] < (unsigned)num_rows)
        load_cols<T, V, kVec>(rows + e[u] * ld_in, c, d, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kRunUnroll; ++u) {
      if ((unsigned)id[u] >= (unsigned)num_rows) continue;
      if (id[u] != cur) {
        if (cur >= 0) add_cols<V>(out + (long long)cur * ld_out + c, acc);
        cur = id[u];
#pragma unroll
        for (int t = 0; t < V; ++t) acc[t] = x[u][t];
      } else {
#pragma unroll
        for (int t = 0; t < V; ++t) acc[t] = __fadd_rn(acc[t], x[u][t]);
      }
    }
  }
  if (cur >= 0) add_cols<V>(out + (long long)cur * ld_out + c, acc);
}

// K7: the output [num_edges, words] W is one flat array, cut into tiles of
// `tile` edges, tile * words consecutive output words; a CTA copies tiles
// b, b + gridDim.x, ..., U words a thread (w = threadIdx.x + u * kThreads):
// the tile's ids first, then U independent row loads, then U coalesced
// stores.  A word's (edge, column) steps by (kThreads / words, kThreads %
// words) from u to u + 1, the same in every tile.
template <typename W, int U>
__global__ void __launch_bounds__(kThreads) row_gather_kernel(
    const W* __restrict__ v, const int* __restrict__ idx, W* __restrict__ out,
    long long num_edges, int num_rows, int words, int tile) {
  const int dj = kThreads / words, dw = kThreads - dj * words;
  int jj[U], ww[U];
  {
    int j = threadIdx.x / words, w = threadIdx.x - j * words;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      jj[u] = j;
      ww[u] = w;
      j += dj;
      w += dw;
      if (w >= words) {
        w -= words;
        ++j;
      }
    }
  }
  for (long long e0 = (long long)blockIdx.x * tile; e0 < num_edges;
       e0 += (long long)gridDim.x * tile) {
    const int nt = (int)min((long long)tile, num_edges - e0);
    int r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = jj[u] < nt ? __ldg(idx + e0 + jj[u]) : -1;
    W val[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      val[u] = W{};
      if ((unsigned)r[u] < (unsigned)num_rows)
        val[u] = __ldg(v + (long long)r[u] * words + ww[u]);
    }
    W* o = out + e0 * words;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (jj[u] < nt) o[threadIdx.x + u * kThreads] = val[u];
  }
}

using gat::ordered;
using gat::unordered;

constexpr int kSoftmaxThreads = 512;
constexpr int kSoftmaxStage = 4096;  // edges a CTA stages: 32 KB
constexpr int kSoftmaxUnroll = 4;    // edges a thread loads before it uses them
constexpr int kBlockRows = 128;      // rows of a dst block

// K8: one CTA per 128-row dst block b, whose edges are [bounds[b],
// bounds[b+1]); edges whose dst lies outside the block (the padding) are
// dropped.  stats: f32[num_rows, 2] rows [max | sum].
__global__ void __launch_bounds__(kSoftmaxThreads) softmax_block_kernel(
    const float* __restrict__ alpha, const int* __restrict__ dst,
    const int* __restrict__ bounds, float* __restrict__ stats, int num_rows) {
  __shared__ int key[kBlockRows];  // the rows' max (ordered int image)
  __shared__ float sa[kSoftmaxStage];
  __shared__ int sd[kSoftmaxStage];
  const int row0 = blockIdx.x * kBlockRows, nr = min(kBlockRows, num_rows - row0);
  const long long lo = bounds[blockIdx.x];
  const int n_e = (int)(bounds[blockIdx.x + 1] - lo);
  float* out = stats + 2LL * row0;
  for (int r = threadIdx.x; r < kBlockRows; r += kSoftmaxThreads) {
    key[r] = ordered(__int_as_float(static_cast<int>(0xff800000u)));  // -inf
    if (r < nr) out[2 * r + 1] = 0.f;
  }
  __threadfence();  // the zeroed sums reach memory before the CTA's atomics add to them
  __syncthreads();
  constexpr int kStep = kSoftmaxUnroll * kSoftmaxThreads;
  for (int i0 = threadIdx.x; i0 < n_e; i0 += kStep) {
    int d[kSoftmaxUnroll];
    float a[kSoftmaxUnroll];
#pragma unroll
    for (int k = 0; k < kSoftmaxUnroll; ++k) {
      const int i = i0 + k * kSoftmaxThreads;
      d[k] = i < n_e ? dst[lo + i] : num_rows;
      a[k] = i < n_e ? alpha[lo + i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kSoftmaxUnroll; ++k) {
      const int i = i0 + k * kSoftmaxThreads;
      if (i < kSoftmaxStage) {
        sd[i] = d[k];
        sa[i] = a[k];
      }
      const int r = d[k] - row0;
      if ((unsigned)r < (unsigned)nr) atomicMax(key + r, ordered(a[k]));
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nr; r += kSoftmaxThreads) out[2 * r] = unordered(key[r]);
  // each term exp(a - the row's final max), the shift 0 where the max is
  // not finite, as the plain version's; added in global memory (a native
  // f32 reduction there, where shared memory takes a compare-and-swap loop)
  for (int i0 = threadIdx.x; i0 < n_e; i0 += kStep) {
    int d[kSoftmaxUnroll];
    float a[kSoftmaxUnroll];
#pragma unroll
    for (int k = 0; k < kSoftmaxUnroll; ++k) {
      const int i = i0 + k * kSoftmaxThreads;
      const bool staged = i < kSoftmaxStage;
      d[k] = i >= n_e ? num_rows : staged ? sd[i] : dst[lo + i];
      a[k] = i >= n_e ? 0.f : staged ? sa[i] : alpha[lo + i];
    }
#pragma unroll
    for (int k = 0; k < kSoftmaxUnroll; ++k) {
      const int r = d[k] - row0;
      if ((unsigned)r < (unsigned)nr) {
        const float m = unordered(key[r]);
        atomicAdd(out + 2 * r + 1, expf(__fsub_rn(a[k], isfinite(m) ? m : 0.f)));
      }
    }
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T, int V>
void launch_scatter_add(cudaStream_t s, const void* rows, bool vec, const void* perm,
                        const void* ids, void* out, long long num_edges, int num_rows, int d,
                        int stride, int slice, int ld_in, int ld_out) {
  const long long per = (long long)(kThreads / (stride / V)) * slice;  // edges a CTA
  const unsigned grid = (unsigned)((num_edges + per - 1) / per);
  auto kernel = vec ? scatter_add_kernel<T, V, true> : scatter_add_kernel<T, V, false>;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const T*>(rows), static_cast<const int*>(perm),
                                   static_cast<const int*>(ids), static_cast<float*>(out),
                                   num_edges, num_rows, d, stride, slice, ld_in, ld_out);
}

// The slice: a group of one lane (d <= 2) takes 4 positions, so that a
// narrow call fills the card; wider groups 8, or 16 where the mean id takes
// more than 4 edges (longer runs fold more before their atomic).  Within 3 %
// of the fastest slice at every ML-25M and flagship shape on one H100
// (torch_tools/segment_variants.py; PERF.md).
template <typename T>
void launch_scatter_add(cudaStream_t s, const void* rows, const void* perm, const void* ids,
                        void* out, long long num_edges, int num_rows, int d, int stride,
                        int ld_in, int ld_out) {
  const int slice = d <= 2 ? 4 : num_edges > 4LL * num_rows ? 16 : 8;
  const int v = stride % 4 == 0 ? 4 : stride;  // stride is 1, 2 or a multiple of 4
  const bool vec = d % v == 0 && ld_in % v == 0 && aligned(rows, v * (unsigned)sizeof(T));
  if (v == 4)
    launch_scatter_add<T, 4>(s, rows, vec, perm, ids, out, num_edges, num_rows, d, stride, slice,
                             ld_in, ld_out);
  else if (v == 2)
    launch_scatter_add<T, 2>(s, rows, vec, perm, ids, out, num_edges, num_rows, d, stride, slice,
                             ld_in, ld_out);
  else
    launch_scatter_add<T, 1>(s, rows, vec, perm, ids, out, num_edges, num_rows, d, stride, slice,
                             ld_in, ld_out);
}

// One CTA a tile, up to kMaxCtas; past that the CTAs loop over the tiles.
// A grid of only the CTAs resident at once ran slower at the flagship's
// 16-byte shapes on one H100 (torch_tools/segment_variants.py; PERF.md).
template <typename W, int U>
void launch_row_gather(cudaStream_t s, const void* v, const void* idx, void* out,
                       long long num_edges, int num_rows, int words) {
  const int tile = kThreads * U / words;
  const unsigned grid = (unsigned)min((num_edges + tile - 1) / tile, kMaxCtas);
  row_gather_kernel<W, U><<<grid, kThreads, 0, s>>>(
      static_cast<const W*>(v), static_cast<const int*>(idx), static_cast<W*>(out), num_edges,
      num_rows, words, tile);
}

// U, the words a thread copies: 2 for 16-byte words and 4 for narrower
// ones, doubled until a tile holds a row.  Within a few percent of the
// fastest U at every ML-25M and flagship shape on one H100
// (torch_tools/segment_variants.py; PERF.md).
template <typename W>
void launch_row_gather(cudaStream_t s, const void* v, const void* idx, void* out,
                       long long num_edges, int num_rows, int words) {
  int u = sizeof(W) == 16 ? 2 : 4;
  while (u * kThreads < words) u *= 2;  // words <= kMaxWords * kThreads: the C entry checks
  if (u >= 8)
    launch_row_gather<W, 8>(s, v, idx, out, num_edges, num_rows, words);
  else if (u >= 4)
    launch_row_gather<W, 4>(s, v, idx, out, num_edges, num_rows, words);
  else
    launch_row_gather<W, 2>(s, v, idx, out, num_edges, num_rows, words);
}

}  // namespace

// Plain C entries for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses).
// int32 ids.  The vector paths are taken when the row width and the
// pointers allow them.

// rows: d columns of rows ld_in elements apart (ld_in >= d), bf16 when
// `bf16` else f32; out: f32 rows ld_out apart, zeroed by the caller, of
// which the call adds to the first `stride` columns: stride = d for d <= 2,
// else d rounded up to a multiple of 4 (the sum is out[:, :d]; a wider
// row's wrapper points rows and out at a pass's first column); the walk:
// for k = 0 .. num_edges-1, rows[perm[k]] (rows[k] where perm is NULL) is
// added to row ids[k], so with a perm, ids must be the caller's ids
// permuted by it; runs of equal ids in the walk are summed before their
// atomic; ids outside [0, num_rows) dropped.
extern "C" int scatter_add(int device, const void* rows, int bf16, const void* perm,
                           const void* ids, void* out, long long num_edges, int num_rows, int d,
                           int stride, int ld_in, int ld_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int v = stride % 4 == 0 ? 4 : stride;
  if (d < 1 || d > kMaxCols || num_edges < 0 || ld_in < d || ld_out < stride ||
      ld_out % v != 0 || stride != (d <= 2 && stride == d ? d : (d + 3) / 4 * 4) ||
      !aligned(out, 4 * v))
    return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_scatter_add<__nv_bfloat16>(s, rows, perm, ids, out, num_edges, num_rows, d, stride,
                                      ld_in, ld_out);
  else
    launch_scatter_add<float>(s, rows, perm, ids, out, num_edges, num_rows, d, stride, ld_in,
                              ld_out);
  return (int)cudaGetLastError();
}

// v: [num_rows, row_bytes] of any type; idx: [num_edges]; out: [num_edges,
// row_bytes]; idx outside [0, num_rows) gives a zero row.
extern "C" int row_gather(int device, const void* v, const void* idx, void* out,
                          long long num_edges, int num_rows, int row_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the widest word that divides the row and both pointers
  const uintptr_t a = reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
                      (uintptr_t)row_bytes;
  const int ws = a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
  if (row_bytes < 2 || a % 2 != 0 || row_bytes / ws > kMaxWords * kThreads || num_edges < 0)
    return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = row_bytes / ws;
  if (ws == 16)
    launch_row_gather<uint4>(s, v, idx, out, num_edges, num_rows, words);
  else if (ws == 8)
    launch_row_gather<uint2>(s, v, idx, out, num_edges, num_rows, words);
  else if (ws == 4)
    launch_row_gather<unsigned>(s, v, idx, out, num_edges, num_rows, words);
  else
    launch_row_gather<unsigned short>(s, v, idx, out, num_edges, num_rows, words);
  return (int)cudaGetLastError();
}

// alpha: f32[num_edges] logits; dst: int32[num_edges], block-monotone
// (graph.py's order: the edges of 128-row dst block b are [bounds[b],
// bounds[b+1])), ids >= num_rows (padding) dropped; bounds: int32[n_blocks
// + 1], n_blocks = ceil(num_rows / 128) (ops/flash_gat.dst_block_bounds);
// stats: f32[num_rows, 2], written whole (rows [max | sum
// of exp(alpha - max)], max -inf and sum 0 for a row with no edge).  One
// launch on `stream`.
extern "C" int softmax_stats(int device, const void* alpha, const void* dst,
                             const void* bounds, void* stats, long long num_edges,
                             int n_blocks, int num_rows, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_edges < 0 || num_edges > 0x7fffffffLL || num_rows < 0 ||
      n_blocks != (num_rows + kBlockRows - 1) / kBlockRows)
    return (int)cudaErrorInvalidValue;
  if (num_rows == 0) return (int)cudaGetLastError();
  softmax_block_kernel<<<n_blocks, kSoftmaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), static_cast<const int*>(dst),
      static_cast<const int*>(bounds), static_cast<float*>(stats), num_rows);
  return (int)cudaGetLastError();
}
