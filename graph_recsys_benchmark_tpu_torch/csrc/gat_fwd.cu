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
// ~2(kz+1) flops and reads one (kz+1)-wide band of its source's row, per
// edge two ids, and it writes each dst row once; no tensor-core work
// exists.  The table is row-major [n, n_ch*(kz+1)]: row s holds every
// channel's band [z_c[s] | a_src_c[s]], so one edge visit is one coalesced
// read of all n_ch bands (the TPU kernels' one-hot windows play this role
// there; their column-major table would give kz scattered reads per edge).
// The design before this one ran one warp an edge in the edges' own
// (dst // 128, src) order and issued n_ch * (kz+1) scalar f32 atomics an
// edge (K12 65, 11.0 M a flagship call; K3 119 and 34 on its two step-2
// shares), idled lanes on the warp's last 32-column pass and re-read
// a_dst and mhat an edge: 0.049 ms for K12 and 0.059 ms for K3's two calls
// against bounds of 0.0028 and 0.0010 (PERF.md section 6).  This design
// mirrors the backwards' walk by source (gat_bwd.cu) on the dst side:
//   * the walk: the graph's stable sort by dst (StepGraph.dst_perm /
//     dst_sorted, built once with the graph), so every dst row's edges are
//     one run (11.1 edges a row on the flagship's step-1 union graph, 43.6
//     on its step-2 graph).  A worker takes `slice` consecutive positions
//     of the walk (fixed slices, so a row with many edges spreads over
//     many workers; see gat_fwd for the slice), its lanes load them and
//     src[perm] at once, and it takes the edges in order;
//   * a worker of GE lanes an edge, GC lanes a channel, J columns a lane
//     (K1/K12 at kz 64 8, 8, 8, four workers a warp; K3 at kz 16 8, 4, 4
//     for 2 channels, 32, 4, 4 for 7): each lane forms its channel's p_c
//     once an edge, with a_dst and mhat loaded once a run;
//   * a run in registers: each lane sums its columns of the run and its
//     channel's p; the run's end (a new dst, or the slice's end) writes the
//     run's row through the worker's row in shared memory as 16-byte
//     vector atomics into acc, whose rows the wrapper pads to a multiple of
//     4 columns (65 -> 68, 119 -> 120, 34 -> 36) and hands back as a view;
//   * any width: one channel past the widest layout (kz > 256) walks its
//     slice once per 256-column pass, the last pass with the p column;
//     every pass reads the same positions, so no refusal past a layout;
//   * padding edges (dst >= num_rows) sort last in the walk and are skipped
//     before any other load; they neither add to nor end a run.
// What is left (PERF.md section 6): the random gather of each edge's
// source row (K12 260 bytes in f32, K3 476 at 7 channels), the zeroing of
// acc and the launch.  torch_tools/gat_fwd_walk.py times the slices, other
// worker layouts, the edges' own order (perm = arange, ids = dst) and
// plain 16-byte stores for the runs that lie inside one slice.
//
// K12-online, ops/flash_gat.py:_make_flash_kernel(bound_shift=False): the
// same forward with the exact row max m in place of m-hat, exact for any
// logit spread.  The TPU kernel keeps a running max per 128-row dst block
// and rescales its accumulator when the max grows; rounding the max to T at
// each step is monotone, so its final m is round_T of the exact row max.
// Here two passes compute the same function, both on the graph's walk by
// dst (StepGraph.dst_perm / dst_sorted):
//   1. gat_rowmax: m = round_T(max act) by dst row, 0 for a row without an
//      edge (JAX flash_gat.py:474), from act = leaky(round_T(a_dst[d]) +
//      a_src[s]), the walk's own logit (gat::edge_weight), so that in f32
//      act - m is exactly 0 at the row's best edge.  A warp takes a fixed
//      slice of RowmaxChunks chunks of 32 positions (so a row with many
//      edges spreads over many warps); its lanes load a chunk's ids,
//      src[perm], a_src and a_dst coalesced where the walk is, every
//      chunk's loads in flight together; a segmented max over the lanes
//      (a shuffle scan: a run's lanes are neighbours) leaves each run's max
//      at its last lane, and a run that goes on past the chunk is carried
//      into the next.  One unsigned atomicMax of an order-preserving key
//      (max_key) a run and slice, where the design before this took one a
//      real edge (169,155 onto 15,210 rows a flagship call, in block
//      order) after a launch that set every key to -inf's.  Key 0 is no
//      float's but a NaN's, so the wrapper's zeroed buffer is the set-up,
//      and a decode launch turns each key into round_T(max) in place, or 0
//      where no edge wrote one.  Folding the decode into the walk read
//      slower on the H100 (torch_tools/gat_fwd_walk.py: the last CTA to
//      finish decoding every row; a count of each row's parts, the last
//      part decoding, took a fence a part and also read slower), and the
//      zeroing and the two launches are most of the time.  Bound: each
//      real edge's ids (8 bytes), each row's a_src and a_dst once and m,
//      ~E * 8 + N * (sizeof(T) + 8) bytes; the walk also reads perm (4
//      bytes an edge) and gathers a_src and a_dst an edge.
//   2. flash_gat_fwd_online: the walk above (gat_fwd, K1/K12's rounding
//      points) with m as the shift.  p = exp(act - m) <= ~1, so the +60
//      clamp is inert.
// The TPU kernel rounds p * z at the running shift and rescales the
// rounded sums by exp(m_old - m_new) in f32 (flash_gat.py:455-470); this one
// rounds p * z at the final m, so out and s agree with it at rounding level
// while m agrees bitwise.

#include <stdint.h>

#include "gat_common.cuh"

namespace {

using gat::round_t;
using gat::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// K1/K12 and K3 on a walk of the edges sorted by dst.  A worker of GE lanes
// (32 / GE a warp, each with its own slice of the walk) takes one edge at a
// time; lane l of a worker holds channel l / GC and that channel's columns
// base + l % GC + j * GC, j < J, of the pass at column `base` (one pass
// unless one channel is wider than GC * J columns).  acc: f32[num_rows,
// stride], stride = n_ch * (kz+1) rounded up to 4; shared memory: one row
// of gat::walk_row_floats floats a worker, the pass's columns of acc's row.
template <typename T, bool RoundPFirst, int GE, int GC, int J>
__global__ void __launch_bounds__(kThreads) gat_fwd_walk_kernel(
    const T* __restrict__ table, const float* __restrict__ adst,
    const float* __restrict__ mhat, const int* __restrict__ perm,
    const int* __restrict__ ids, const int* __restrict__ src, float* __restrict__ acc,
    long long num_edges, int num_rows, int kz, int n_ch, int stride, int slice,
    float slope) {
  constexpr int kWorkers = 32 / GE;  // a warp's
  constexpr int kCols = GC * J;  // a channel's columns in one pass
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wl = lane & (GE - 1), wk = lane / GE;  // lane in its worker, worker
  const unsigned wmask = GE == 32 ? 0xffffffffu : ((1u << GE) - 1) << (wk * GE);
  const int c = wl / GC, gl = wl & (GC - 1);  // the lane's channel, lane in it
  const bool chv = c < n_ch;
  const int bz = kz + 1, width = n_ch * bz;
  const int bw = gat::walk_row_floats(stride, kCols, n_ch == 1);
  float* buf = reinterpret_cast<float*>(smem) + (warp * kWorkers + wk) * bw;
  // the worker's slice [k0, k0 + slice); every worker of the warp runs the
  // same trip counts (positions past the walk read as padding), so that
  // the shuffles see every lane
  const long long k0 = (((long long)blockIdx.x * kWarps + warp) * kWorkers + wk) * slice;
  for (int base = 0; base < kz; base += kCols) {
    // the last pass also sums p (column kz) and writes the pad columns
    const bool last = base + kCols >= kz;
    const int span = last ? stride - base : kCols;  // acc columns this pass writes
    for (int q = wl; q < bw; q += GE) buf[q] = 0.f;  // unwritten columns stay 0
    __syncwarp(wmask);
    bool colv[J];
#pragma unroll
    for (int j = 0; j < J; ++j) colv[j] = chv && base + gl + j * GC < kz;
    float accv[J], accp = 0.f;  // the run's sums
    float ad = 0.f, mh = 0.f;  // the run's a_dst and mhat of the lane's channel
    int cur = -1;  // the run's row; -1 before the slice's first real edge

    // the run's row of acc: the worker's columns and p into its shared
    // row, then 16-byte atomics (the worker's lanes only: a run ends where
    // the worker's row changes)
    auto flush = [&]() {
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (colv[j]) buf[c * bz + gl + j * GC] = accv[j];
      if (last && chv && gl == 0) buf[c * bz + kz - base] = accp;
      __syncwarp(wmask);
      float4* out = reinterpret_cast<float4*>(acc + (long long)cur * stride + base);
      const float4* b4 = reinterpret_cast<const float4*>(buf);
      for (int q = wl; q < span / 4; q += GE) atomicAdd(out + q, b4[q]);
      __syncwarp(wmask);
    };
    for (int kb = 0; kb < slice; kb += GE) {
      int my_s = 0, my_d = num_rows;  // positions past the slice read as padding
      if (kb + wl < slice && k0 + kb + wl < num_edges) {
        const long long k = k0 + kb + wl;
        my_d = __ldg(ids + k);
        if (my_d < num_rows) my_s = __ldg(src + __ldg(perm + k));
      }
      for (int i = 0; i < GE && i < slice; ++i) {
        const int s = __shfl_sync(0xffffffffu, my_s, i, GE);
        const int d = __shfl_sync(0xffffffffu, my_d, i, GE);
        if (d >= num_rows) continue;  // padding, uniform in the worker: no load
        const bool fresh = d != cur;
        if (fresh) {  // a new row ends the run before it
          if (cur >= 0) flush();
          cur = d;
          if (chv) {
            const long long cd = (long long)c * num_rows + d;
            ad = __ldg(adst + cd);
            mh = __ldg(mhat + cd);
          }
        }
        const T* row = table + (long long)s * width + c * bz;
        const float p = chv ? gat::edge_weight(ad + to_f32(row[kz]), mh, slope) : 0.f;
        const float q = RoundPFirst ? round_t<T>(p) : p;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          // _rn: the product rounds as the plain version's, no FMA
          const float t =
              colv[j] ? round_t<T>(__fmul_rn(to_f32(row[base + gl + j * GC]), q)) : 0.f;
          accv[j] = fresh ? t : __fadd_rn(accv[j], t);
        }
        const float pt = round_t<T>(p);
        accp = fresh ? pt : __fadd_rn(accp, pt);
      }
    }
    if (cur >= 0) flush();
    __syncwarp(wmask);  // the next pass zeroes buf
  }
}

template <typename T, bool RoundPFirst, int GE, int GC, int J>
void launch_walk(cudaStream_t s, const void* table, const void* adst, const void* mhat,
                 const void* perm, const void* ids, const void* src, void* acc,
                 long long num_edges, int num_rows, int kz, int n_ch, int stride, int slice,
                 float slope) {
  const long long per_warp = (long long)slice * (32 / GE);
  const long long warps = (num_edges + per_warp - 1) / per_warp;
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  const size_t smem =
      (size_t)kThreads / GE * gat::walk_row_floats(stride, GC * J, n_ch == 1) * sizeof(float);
  gat_fwd_walk_kernel<T, RoundPFirst, GE, GC, J><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(table), static_cast<const float*>(adst),
      static_cast<const float*>(mhat), static_cast<const int*>(perm),
      static_cast<const int*>(ids), static_cast<const int*>(src), static_cast<float*>(acc),
      num_edges, num_rows, kz, n_ch, stride, slice, slope);
}

// The worker layout (GE lanes an edge, GC lanes a channel, J columns a
// lane) for (kz, n_ch), or false where none is built: K1/K12's rounding
// for one channel at any kz (past 256 in 256-column passes), K3's for n_ch
// <= 8 at kz <= 128.  The backward's layouts (gat_bwd.cu), but at the
// flagship's calls (K1/K12 at kz 64, K3 at kz 16 with 2 channels) 8 lanes
// an edge with 8 or 4 columns a lane, which torch_tools/gat_fwd_walk.py
// read fastest there (the forward has no datt reduction to spread).
template <typename T, bool RoundPFirst>
bool launch_walk(cudaStream_t s, const void* table, const void* adst, const void* mhat,
                 const void* perm, const void* ids, const void* src, void* acc,
                 long long num_edges, int num_rows, int kz, int n_ch, int stride, int slice,
                 float slope) {
#define GAT_FWD_WALK(GE, GC, J)                                                          \
  launch_walk<T, RoundPFirst, GE, GC, J>(s, table, adst, mhat, perm, ids, src, acc,      \
                                         num_edges, num_rows, kz, n_ch, stride, slice, \
                                         slope)
  if constexpr (!RoundPFirst) {  // K1/K12: one channel
    if (n_ch != 1) return false;
    if (kz <= 32) GAT_FWD_WALK(8, 8, 4);
    else if (kz <= 64) GAT_FWD_WALK(8, 8, 8);
    else if (kz <= 128) GAT_FWD_WALK(16, 16, 8);
    else GAT_FWD_WALK(32, 32, 8);
  } else {  // K3
    if (kz <= 16 && n_ch <= 2) GAT_FWD_WALK(8, 4, 4);
    else if (kz <= 16 && n_ch <= 4) GAT_FWD_WALK(16, 4, 4);
    else if (kz <= 16) GAT_FWD_WALK(32, 4, 4);
    else if (kz <= 32) GAT_FWD_WALK(32, 4, 8);
    else if (kz <= 64) GAT_FWD_WALK(32, 4, 16);
    else if (kz <= 128) GAT_FWD_WALK(32, 4, 32);
    else return false;
  }
#undef GAT_FWD_WALK
  return true;
}

// A float's key for an unsigned atomicMax: order-preserving (ordered()'s
// image moved to unsigned order), and above 0 for every float but a NaN.
__device__ __forceinline__ unsigned max_key(float v) {
  return static_cast<unsigned>(gat::ordered(v)) ^ 0x80000000u;
}

// K12-online's row max on the walk by dst: key[d] = max max_key(act) over
// the real edges of row d (key zeroed by the caller).  A warp takes C
// chunks of 32 consecutive positions of the walk.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads) gat_rowmax_walk_kernel(
    const T* __restrict__ table, const float* __restrict__ adst,
    const int* __restrict__ perm, const int* __restrict__ ids, const int* __restrict__ src,
    unsigned* __restrict__ key, long long num_edges, int num_rows, int kz, float slope) {
  const int lane = threadIdx.x & 31;
  const long long k0 = (((long long)blockIdx.x * kThreads + threadIdx.x) >> 5) * (C * 32) + lane;
  int d[C], s[C];
#pragma unroll
  for (int j = 0; j < C; ++j)  // positions past the walk read as padding
    d[j] = k0 + j * 32 < num_edges ? __ldg(ids + k0 + j * 32) : num_rows;
#pragma unroll
  for (int j = 0; j < C; ++j)  // padding: no load
    s[j] = d[j] < num_rows ? __ldg(src + __ldg(perm + k0 + j * 32)) : 0;
  unsigned v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    v[j] = 0u;
    if (d[j] < num_rows) {
      const float pre = __ldg(adst + d[j]) + to_f32(table[(long long)s[j] * (kz + 1) + kz]);
      v[j] = max_key(pre > 0.f ? pre : __fmul_rn(slope, pre));  // edge_weight's act
    }
  }
  int cur = num_rows;  // the run carried from the chunk before; num_rows: none
  unsigned best = 0u;  // its max so far
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int dj = d[j];
    unsigned x = v[j];
    // a segmented max: in the sorted walk a lane o back with the same row
    // is in the same run, and so is every lane between (in another order
    // a run's parts each take their own atomic)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned xo = __shfl_up_sync(0xffffffffu, x, o);
      const int dd = __shfl_up_sync(0xffffffffu, dj, o);
      if (lane >= o && dd == dj) x = max(x, xo);
    }
    if (dj == cur) x = max(x, best);  // the run from the chunk before goes on
    const int first = __shfl_sync(0xffffffffu, dj, 0);
    if (lane == 0 && cur < num_rows && cur != first) atomicMax(key + cur, best);  // or ended
    const int next = __shfl_down_sync(0xffffffffu, dj, 1);
    if (lane < 31 && dj != next && dj < num_rows) atomicMax(key + dj, x);  // a run's end
    cur = __shfl_sync(0xffffffffu, dj, 31);
    best = __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0 && cur < num_rows) atomicMax(key + cur, best);
}

// K12-online's row max, decode: each key into m = round_T(max) in place,
// 0 where no edge wrote one.
template <typename T>
__global__ void __launch_bounds__(kThreads) gat_rowmax_decode_kernel(
    unsigned* __restrict__ key, int num_rows) {
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < num_rows; r += gridDim.x * kThreads) {
    const unsigned k = key[r];
    const float m = k == 0u ? 0.f : round_t<T>(gat::unordered(static_cast<int>(k ^ 0x80000000u)));
    key[r] = __float_as_uint(m);
  }
}

// The row max's launches on `s`: the walk, RowmaxChunks chunks of 32
// positions a warp, then the decode.
template <typename T>
void launch_rowmax(cudaStream_t s, const void* table, const void* adst, const void* perm,
                   const void* ids, const void* src, void* m, long long num_edges, int num_rows,
                   int kz, float slope) {
  constexpr int RowmaxChunks = 2;
  unsigned* key = static_cast<unsigned*>(m);
  const long long warps = (num_edges + RowmaxChunks * 32 - 1) / (RowmaxChunks * 32);
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  gat_rowmax_walk_kernel<T, RowmaxChunks><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(table), static_cast<const float*>(adst),
      static_cast<const int*>(perm), static_cast<const int*>(ids), static_cast<const int*>(src),
      key, num_edges, num_rows, kz, slope);
  long long blocks = ((long long)num_rows + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride past this
  gat_rowmax_decode_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(key, num_rows);
}

}  // namespace

// Plain C entry for ctypes.  table: [n, n_ch*(kz+1)] T row-major (T = bf16
// when `bf16` else f32); adst/mhat: f32[n_ch, num_rows]; the walk: for k =
// 0 .. num_edges-1 the edge perm[k] of dst row ids[k] (ids = dst[perm],
// StepGraph.dst_perm / dst_sorted, padding ids >= num_rows); src:
// int32[num_edges] in the edges' order; acc: f32[num_rows, stride], stride
// = n_ch*(kz+1) rounded up to a multiple of 4, 16-byte aligned, zeroed by
// the caller.  `round_p_first` selects K3's rounding points (n_ch <= 8, kz
// <= 128) over K1's (n_ch 1, any kz).  Launches on `stream`; returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses).
extern "C" int gat_fwd(int device, const void* table, int bf16, int round_p_first,
                       const void* adst, const void* mhat, const void* perm, const void* ids,
                       const void* src, void* acc, long long num_edges, int num_rows, int kz,
                       int n_ch, int stride, float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_ch < 1 || n_ch > 8 || kz < 1 || num_edges < 0 ||
      stride != (n_ch * (kz + 1) + 3) / 4 * 4 || reinterpret_cast<uintptr_t>(acc) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // positions of the walk a worker takes, fitted to the flagship's three
  // calls: torch_tools/gat_fwd_walk.py read 8 fastest for K1/K12 and K3 in
  // both transports (4 to 16 within 0.004 ms); the other layouts take it
  // unmeasured
  const int slice = 8;
  bool ok;
  if (bf16 && round_p_first)
    ok = launch_walk<__nv_bfloat16, true>(s, table, adst, mhat, perm, ids, src, acc, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  else if (bf16)
    ok = launch_walk<__nv_bfloat16, false>(s, table, adst, mhat, perm, ids, src, acc, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  else if (round_p_first)
    ok = launch_walk<float, true>(s, table, adst, mhat, perm, ids, src, acc, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  else
    ok = launch_walk<float, false>(s, table, adst, mhat, perm, ids, src, acc, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K12-online, pass 1.  table: [n, kz+1] T row-major [z | a_src]; adst:
// f32[num_rows] = round_T(a_dst); the walk by dst and src as gat_fwd's;
// m: f32[num_rows], zeroed by the caller (every bit 0), written whole.
// Two launches on `stream` (the walk, the decode); returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses).
extern "C" int gat_rowmax(int device, const void* table, int bf16, const void* adst,
                          const void* perm, const void* ids, const void* src, void* m,
                          long long num_edges, int num_rows, int kz, float slope,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kz < 1 || num_rows < 0 || num_edges < 0) return (int)cudaErrorInvalidValue;
  if (num_rows == 0 || num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_rowmax<__nv_bfloat16>(s, table, adst, perm, ids, src, m, num_edges, num_rows, kz, slope);
  else
    launch_rowmax<float>(s, table, adst, perm, ids, src, m, num_edges, num_rows, kz, slope);
  return (int)cudaGetLastError();
}
