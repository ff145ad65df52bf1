// gat_bwd: backward of the single-head GAT attention (csrc/gat_fwd.cu)
// for n_ch <= 8 channels that share one edge list, for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernels
//   ops/flash_gat.py:_make_bwd_glue_kernel(fused_scatter=True) (K2):
//     n_ch = 1, launched by ops/flash_gat.flash_gat_bwd;
//   ops/batch_gat.py:_make_bwd_kernel (K4): n_ch <= 8 over one edge list,
//     launched by ops/batch_gat.batch_gat_bwd.
// Inputs per destination row d and channel c (built by the wrappers as the
// TPU wrappers build them): the stat band gtab[d, c] = [round_T(g_c) |
// gout_c] (gout = sum g * out, f32), logden[c, d] = mhat + log(s + 1e-16)
// and a_dst[c, d] = round_T(a_dst).  Per edge (s, d) with d < num_rows:
//   pre  = a_dst[c, d] + a_src_c[s],  act = leaky(pre)
//   att  = exp(min(act - logden[c, d], 60))       (the softmax weight)
//   datt = sum_k g_c[d, k] * z_c[s, k]            (lane reduction)
//   dpre = att * (datt - gout_c[d]) * leaky'(pre)
//   dpk[s, band c]  += [ att * g_c[d] | dpre ]   (f32)
//   da_dst[c, d]    += dpre                      (f32 atomics)
// The two TPU kernels compute this function and differ only in where they
// round through the transport type T (round_T: identity for f32,
// round-to-nearest-even for bf16); the RoundAttFirst template flag picks
// K4's points over K2's:
//   K2 (flash_gat.py:932-946): datt sums the unrounded f32 products; the
//     cotangent [round_T(g * att) | round_T(dpre)] is rounded before the
//     f32 sum by src; da_dst sums the unrounded dpre.
//   K4 (batch_gat.py:319-382): datt sums round_T(g * z); the cotangent is
//     [round_T(g * round_T(att)) | round_T(dpre)]; da_dst sums
//     round_T(dpre).
// Both are held to what the TPU kernels compute in interpret mode, where
// their f32 one-hot matmuls are exact.  On a TPU, K2's da_dst pass
// (flash_gat.py:969-979) multiplies dpre at DEFAULT precision and would
// round it to bf16 first; this kernel does not.
//
// What bounds it on the H100.  Per (edge, channel) it reads a (kz+1)-wide
// stat band, does ~3 kz flops and adds kz+1 values into its source's row
// of dpk and one into da_dst; no tensor-core work exists.  The design
// before this one ran one warp per edge in the edges' own order and issued
// n_ch * (kz+1) scalar f32 atomics an edge into dpk (K2 65 an edge, 11.0 M
// a flagship call; K4 119 an edge into a 0.8 MB table, every source's ~44
// edges at the same 119 addresses), re-read the source row an edge, and
// idled half the warp at kz 16 (7 full-warp reductions an edge): 0.070 ms
// for K2 and 0.118 ms for K4's two calls against bounds of 0.004 and 0.001
// (PERF.md section 6).  This design sums each source's run before one
// write:
//   * the walk: the graph's stable sort by source (StepGraph.src_perm /
//     src_sorted, built once with the graph), so every source's edges are
//     one run (11.1 edges a source on the flagship's step-1 union graph,
//     43.6 on its step-2 graph; 7.1 and 16.9 in the edges' own block
//     order).  A worker takes `slice` consecutive positions of the walk
//     (fixed slices, so a skewed source spreads over many workers; 16 for
//     K2 in f32, 4 otherwise, see gat_bwd), its lanes load them and
//     dst[perm] at once, and it takes the edges in order;
//   * a worker of GE lanes an edge, GC lanes a channel, J columns a lane
//     (K2 at kz 64: 16, 16, 4, two workers a warp; K4 at kz 16: 16, 8, 2
//     for 2 channels, 32, 4, 4 for 7), so that the channels' reductions
//     of datt run side by side (a butterfly of 4, 3 or 2 steps where the
//     design before ran 7 full-warp ones) and each lane forms its channel's
//     softmax weight once an edge;
//   * a run in registers: each lane sums its columns of the cotangent and
//     its channel's dpre; the run's end (a new source, or the slice's end)
//     writes the run's row through the worker's row in shared memory as
//     16-byte vector atomics into dpk, whose rows the wrapper pads to a
//     multiple of 4 columns (65 -> 68, 119 -> 120, 34 -> 36) and hands
//     back as a view;
//   * any width: one channel past the widest layout (K2 at kz > 256) walks
//     its slice once per 256-column pass; each pass sums datt over the
//     whole row before it forms its columns' terms, and only the last
//     writes dpre and da_dst (a layout holds J columns a lane in
//     registers, and dpre needs datt over every column);
//   * da_dst stays one atomic a (edge, channel) by dst, the dst changing
//     from edge to edge of a run; it is summed as [num_rows, n_ch], so an
//     edge's channels share a sector (the wrapper transposes it): summed
//     as [n_ch, num_rows], K4's two calls took 0.0586 ms against 0.0448
//     (f32, the C entry alone, torch_tools/gat_bwd_walk.py; PERF.md
//     section 6);
//   * padding edges (dst >= num_rows) are skipped before any other load
//     and neither add to nor end a run: in the sort by source they lie in
//     row 0's run (src 0), after its real edges.
// What is left (PERF.md section 6): each edge still gathers its
// dst's stat row at random (K2 260 bytes, 9 or 10 sectors of L2; K4 at 7
// channels 476 bytes, and logden and a_dst from 7 rows each), and every
// call zeroes its accumulator and launches a grid of a few hundred CTAs;
// torch_tools/gat_bwd_walk.py times the slices, other worker layouts, the
// edges' own order (perm = arange, ids = src), the kernel without its
// atomics and without any work.  Trial builds that kept several edges'
// loads in flight a worker did not run faster.
//
// K13, ops/flash_gat.py:_make_bwd_glue_kernel(fused_scatter=False) (the JAX
// route when the fused tables exceed 13 MiB, flash_gat.py:1444-1479): K2's
// per-edge math, one warp per edge in the edges' own order, as before the
// design above (gat_bwd_glue_kernel).  Instead of a sum by src, each edge
// STORES its cotangent row [round_T(g * att) | round_T(dpre)] into ct[e, :]
// in the transport type T (half the bytes in bf16); da_dst keeps its
// atomics by dst, as the TPU kernel reduces da_dst in-kernel
// (flash_gat.py:968-979).  A padding edge's row is written as exact zeros
// (the TPU contract, flash_gat.py:852-855): ct comes from torch.empty, and
// the scatter that follows (segment.cu's scatter_add, the port's K6, by
// src) adds every row.  Launched by ops/flash_gat.flash_gat_bwd_glue (one
// channel, K2's rounding points).  Extra bytes over K2: the ct write,
// E * (kz+1) * sizeof(T), and K6 reads it back.

#include <stdint.h>

#include "gat_common.cuh"

namespace {

using gat::round_t;
using gat::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// K2 / K4 on a walk of the edges.  A worker of GE lanes (32 / GE a warp,
// each with its own slice of the walk) takes one edge at a time; lane l of
// a worker holds channel l / GC and that channel's columns k = base + l %
// GC + j * GC, j < J, of the pass at column `base`.  Wide (K2 past its
// widest layout, one channel): the worker walks its slice once per GC * J
// columns, each pass summing datt over every column of the row before it
// forms the pass's outputs, and only the last pass writes dpre and da_dst;
// otherwise one pass, base 0.  dpk: f32[n, stride], stride = n_ch * (kz+1)
// rounded up to 4; dadst: f32[num_rows, n_ch]; shared memory: one row of
// gat::walk_row_floats floats a worker, the pass's columns of dpk's row.
template <typename T, bool RoundAttFirst, int GE, int GC, int J, bool Wide>
__global__ void __launch_bounds__(kThreads) gat_bwd_walk_kernel(
    const T* __restrict__ table, const float* __restrict__ gtab,
    const float* __restrict__ logden, const float* __restrict__ adst,
    const int* __restrict__ perm, const int* __restrict__ ids,
    const int* __restrict__ dst, float* __restrict__ dpk, float* __restrict__ dadst,
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
  const int bw = gat::walk_row_floats(stride, kCols, Wide);
  float* buf = reinterpret_cast<float*>(smem) + (warp * kWorkers + wk) * bw;
  // the worker's slice [k0, k0 + slice); every worker of the warp runs the
  // same trip counts (positions past the walk read as padding), so that
  // the shuffles see every lane
  const long long k0 = (((long long)blockIdx.x * kWarps + warp) * kWorkers + wk) * slice;
  for (int base = 0; base < (Wide ? kz : 1); base += kCols) {
    // the last pass also writes dpre (column kz), the pad columns and da_dst
    const bool last = !Wide || base + kCols >= kz;
    const int span = last ? stride - base : kCols;  // dpk columns this pass writes
    for (int q = wl; q < bw; q += GE) buf[q] = 0.f;  // unwritten columns stay 0
    __syncwarp(wmask);
    bool colv[J];
#pragma unroll
    for (int j = 0; j < J; ++j) colv[j] = chv && base + gl + j * GC < kz;
    float acc[J], accd = 0.f;  // the run's sums
    int cur = -1;  // the run's source; -1 before the slice's first real edge

    // the run's row of dpk: the worker's columns and dpre into its shared
    // row, then 16-byte atomics (the worker's lanes only: a run ends where
    // the worker's source changes)
    auto flush = [&]() {
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (colv[j]) buf[c * bz + gl + j * GC] = acc[j];
      if (last && chv && gl == 0) buf[c * bz + kz - base] = accd;
      __syncwarp(wmask);
      float4* out = reinterpret_cast<float4*>(dpk + (long long)cur * stride + base);
      const float4* b4 = reinterpret_cast<const float4*>(buf);
      for (int q = wl; q < span / 4; q += GE) atomicAdd(out + q, b4[q]);
      __syncwarp(wmask);
    };
    for (int kb = 0; kb < slice; kb += GE) {
      int my_s = 0, my_d = num_rows;  // positions past the slice read as padding
      if (kb + wl < slice && k0 + kb + wl < num_edges) {
        const long long k = k0 + kb + wl;
        my_s = __ldg(ids + k);
        my_d = __ldg(dst + __ldg(perm + k));
      }
      for (int i = 0; i < GE && i < slice; ++i) {
        const int s = __shfl_sync(0xffffffffu, my_s, i, GE);
        const int d = __shfl_sync(0xffffffffu, my_d, i, GE);
        const bool real = d < num_rows;  // padding: no load
        const float* grow = gtab + (long long)d * width + c * bz;
        const T* row = table + (long long)s * width + c * bz;
        const long long cd = (long long)c * num_rows + d;
        const bool v = real && chv;
        float g[J], part = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          g[j] = v && colv[j] ? __ldg(grow + base + gl + j * GC) : 0.f;
          if (Wide) continue;  // datt below, over every pass's columns
          const float z = v && colv[j] ? to_f32(row[gl + j * GC]) : 0.f;
          // datt: the lane's columns in order, then a butterfly within the
          // channel's lanes (every lane ends with the same sum)
          float gz = __fmul_rn(g[j], z);
          if (RoundAttFirst) gz = round_t<T>(gz);
          if (colv[j]) part = __fadd_rn(part, gz);
        }
        if (Wide && v) {  // the lane's columns of every pass, in order
          for (int k = gl; k < kz; k += GC) {
            float gz = __fmul_rn(__ldg(grow + k), to_f32(row[k]));
            if (RoundAttFirst) gz = round_t<T>(gz);
            part = __fadd_rn(part, gz);
          }
        }
        const float gout = v ? __ldg(grow + kz) : 0.f;
        const float ld = v ? __ldg(logden + cd) : 0.f;
        const float pre = v ? __ldg(adst + cd) + to_f32(row[kz]) : 0.f;
#pragma unroll
        for (int o = GC / 2; o > 0; o >>= 1)
          part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
        if (!real) continue;  // uniform in the worker: neither adds nor ends a run
        // _rn intrinsics keep nvcc from contracting into FMAs, so every
        // product and difference rounds as the plain version's does
        const float act = pre > 0.f ? pre : __fmul_rn(slope, pre);
        const float att = expf(fminf(__fsub_rn(act, ld), 60.f));
        const float dalpha = __fmul_rn(att, __fsub_rn(part, gout));
        const float dpre = pre > 0.f ? dalpha : __fmul_rn(dalpha, slope);
        const float dpre_t = round_t<T>(dpre);
        if (last && chv && gl == 0)  // dadst by dst, then channel: an edge's channels share a sector
          atomicAdd(dadst + (long long)d * n_ch + c, RoundAttFirst ? dpre_t : dpre);
        const float a = RoundAttFirst ? round_t<T>(att) : att;
        // the sums by source, in walk order: a new source flushes the run
        const bool fresh = s != cur;
        if (fresh && cur >= 0) flush();
        cur = s;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float t = round_t<T>(__fmul_rn(g[j], a));
          acc[j] = fresh ? t : __fadd_rn(acc[j], t);
        }
        accd = fresh ? dpre_t : __fadd_rn(accd, dpre_t);
      }
    }
    if (cur >= 0) flush();
    __syncwarp(wmask);  // the next pass zeroes buf
  }
}

template <typename T, bool RoundAttFirst, int GE, int GC, int J, bool Wide>
void launch_walk(cudaStream_t s, const void* table, const void* gtab, const void* logden,
                 const void* adst, const void* perm, const void* ids, const void* dst, void* dpk,
                 void* dadst, long long num_edges, int num_rows, int kz, int n_ch, int stride,
                 int slice, float slope) {
  const long long per_warp = (long long)slice * (32 / GE);
  const long long warps = (num_edges + per_warp - 1) / per_warp;
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  const size_t smem =
      (size_t)kThreads / GE * gat::walk_row_floats(stride, GC * J, Wide) * sizeof(float);
  gat_bwd_walk_kernel<T, RoundAttFirst, GE, GC, J, Wide><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(table), static_cast<const float*>(gtab),
      static_cast<const float*>(logden), static_cast<const float*>(adst),
      static_cast<const int*>(perm), static_cast<const int*>(ids), static_cast<const int*>(dst),
      static_cast<float*>(dpk), static_cast<float*>(dadst), num_edges, num_rows, kz, n_ch,
      stride, slice, slope);
}

// The worker layout (GE lanes an edge, GC lanes a channel, J columns a
// lane) for (kz, n_ch), or false where none is built: K2's rounding for
// one channel at any kz (past 256 in 256-column passes), K4's for n_ch <=
// 8 at kz <= 128.
template <typename T, bool RoundAttFirst>
bool launch_walk(cudaStream_t s, const void* table, const void* gtab, const void* logden,
                 const void* adst, const void* perm, const void* ids, const void* dst, void* dpk,
                 void* dadst, long long num_edges, int num_rows, int kz, int n_ch, int stride,
                 int slice, float slope) {
#define GAT_BWD_WALK(GE, GC, J, WIDE)                                                       \
  launch_walk<T, RoundAttFirst, GE, GC, J, WIDE>(s, table, gtab, logden, adst, perm, ids, dst, \
                                                 dpk, dadst, num_edges, num_rows, kz, n_ch,   \
                                                 stride, slice, slope)
  if constexpr (!RoundAttFirst) {  // K2: one channel
    if (n_ch != 1) return false;
    if (kz <= 32) GAT_BWD_WALK(8, 8, 4, false);
    else if (kz <= 64) GAT_BWD_WALK(16, 16, 4, false);
    else if (kz <= 128) GAT_BWD_WALK(16, 16, 8, false);
    else if (kz <= 256) GAT_BWD_WALK(32, 32, 8, false);
    else GAT_BWD_WALK(32, 32, 8, true);
  } else {  // K4
    if (kz <= 16 && n_ch <= 2) GAT_BWD_WALK(16, 8, 2, false);
    else if (kz <= 16 && n_ch <= 4) GAT_BWD_WALK(16, 4, 4, false);
    else if (kz <= 16) GAT_BWD_WALK(32, 4, 4, false);
    else if (kz <= 32) GAT_BWD_WALK(32, 4, 8, false);
    else if (kz <= 64) GAT_BWD_WALK(32, 4, 16, false);
    else if (kz <= 128) GAT_BWD_WALK(32, 4, 32, false);
    else return false;
  }
#undef GAT_BWD_WALK
  return true;
}

// K13: one warp per edge in the edges' own order (the design that K2 and
// K4 ran before the walk above, kept as it was for the stored rows): per
// channel, lanes over the kz columns form g * z and a shuffle reduction
// sums them; lanes 0..n_ch-1 then form their channel's att and dpre, and
// every lane takes its band's values by shuffle while the warp walks the
// row in 32-wide passes (stepping its (channel, column) without a
// division).  Each edge stores its cotangent row [round_T(g * att) |
// round_T(dpre)] into ct[e] (zeros for a padding edge) and adds its
// unrounded dpre into dadst (K2's rounding points).
template <typename T>
__global__ void __launch_bounds__(kThreads) gat_bwd_glue_kernel(
    const T* __restrict__ table, const float* __restrict__ gtab,
    const float* __restrict__ logden, const float* __restrict__ adst,
    const int* __restrict__ src, const int* __restrict__ dst, T* __restrict__ ct,
    float* __restrict__ dadst, long long num_edges, int num_rows, int kz, int n_ch,
    float slope) {
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long step = ((long long)gridDim.x * blockDim.x) >> 5;
  const int bz = kz + 1;
  const int width = n_ch * bz;
  const int c0 = lane / bz, f0 = lane - c0 * bz;
  for (long long e = first; e < num_edges; e += step) {
    const int d = dst[e];
    if (d >= num_rows) {  // padding sentinel: skip before any load, but its
      for (int j = lane; j < width; j += 32)  // cotangent row is exact zeros
        ct[e * width + j] = gat::from_f32<T>(0.f);
      continue;
    }
    const long long s = src[e];
    const T* row = table + s * width;
    const float* grow = gtab + (long long)d * width;
    // datt_c = g_c . z_c: lanes over the columns, a shuffle reduction;
    // lane c keeps channel c's sum
    float datt_mine = 0.f;
    for (int c = 0; c < n_ch; ++c) {
      float part = 0.f;
      for (int f = lane; f < kz; f += 32)
        part = __fadd_rn(part, __fmul_rn(grow[c * bz + f], to_f32(row[c * bz + f])));
      for (int o = 16; o > 0; o >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
      if (lane == c) datt_mine = part;
    }
    float att_mine = 0.f, dpre_mine = 0.f;
    if (lane < n_ch) {
      const long long cd = (long long)lane * num_rows + d;
      const float pre = adst[cd] + to_f32(row[lane * bz + kz]);
      // _rn intrinsics keep nvcc from contracting into FMAs, so every
      // product and difference rounds as the plain version's does
      const float act = pre > 0.f ? pre : __fmul_rn(slope, pre);
      const float att = expf(fminf(__fsub_rn(act, logden[cd]), 60.f));
      const float dalpha = __fmul_rn(att, __fsub_rn(datt_mine, grow[lane * bz + kz]));
      const float dpre = pre > 0.f ? dalpha : __fmul_rn(dalpha, slope);
      atomicAdd(dadst + cd, dpre);
      att_mine = att;
      dpre_mine = round_t<T>(dpre);
    }
    // warp-uniform trip count: every lane reaches the shuffles
    int c = c0, f = f0;
    for (int j = lane; j - lane < width; j += 32) {
      const int src_lane = min(c, n_ch - 1);
      const float att = __shfl_sync(0xffffffffu, att_mine, src_lane);
      const float dpre = __shfl_sync(0xffffffffu, dpre_mine, src_lane);
      if (j < width) {
        const float v = f < kz ? round_t<T>(__fmul_rn(grow[j], att)) : dpre;
        ct[e * width + j] = gat::from_f32<T>(v);  // exact: v is T-valued
      }
      for (f += 32; f >= bz; f -= bz) ++c;
    }
  }
}

}  // namespace

// Plain C entry for ctypes.  table: [n, n_ch*(kz+1)] T row-major (T = bf16
// when `bf16` else f32); gtab: f32[num_rows, n_ch*(kz+1)]; logden/adst:
// f32[n_ch, num_rows]; the walk: for k = 0 .. num_edges-1 the edge
// perm[k] of source ids[k] (ids = src[perm], StepGraph.src_perm /
// src_sorted); dst: int32[num_edges] in the edges' order; dpk: f32[n, stride], stride =
// n_ch*(kz+1) rounded up to a multiple of 4, 16-byte aligned, and dadst:
// f32[num_rows, n_ch] (by dst, then channel), both zeroed by the caller.  `round_att_first`
// selects K4's rounding points (n_ch <= 8, kz <= 128) over K2's (n_ch 1,
// any kz).  Launches on `stream`; returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it refuses).
extern "C" int gat_bwd(int device, const void* table, int bf16, int round_att_first,
                       const void* gtab, const void* logden, const void* adst,
                       const void* perm, const void* ids, const void* dst, void* dpk,
                       void* dadst, long long num_edges, int num_rows, int kz, int n_ch,
                       int stride, float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_ch < 1 || n_ch > 8 || kz < 1 || num_edges < 0 ||
      stride != (n_ch * (kz + 1) + 3) / 4 * 4 || reinterpret_cast<uintptr_t>(dpk) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // positions of the walk a worker takes, by kernel and transport, fitted
  // to the flagship's two calls alone (K2 at kz 64 on 169,472 positions, K4
  // at kz 16 with 7 and 2 channels on 73,728): torch_tools/gat_bwd_walk.py
  // read K2 in f32 fastest at 16, K2 in bf16 and K4 at 4 (K4 in f32 within
  // 1 % of 8); the other layouts take the same slices unmeasured
  const int slice = !bf16 && !round_att_first ? 16 : 4;
  bool ok;
  if (bf16 && round_att_first)
    ok = launch_walk<__nv_bfloat16, true>(s, table, gtab, logden, adst, perm, ids, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  else if (bf16)
    ok = launch_walk<__nv_bfloat16, false>(s, table, gtab, logden, adst, perm, ids, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  else if (round_att_first)
    ok = launch_walk<float, true>(s, table, gtab, logden, adst, perm, ids, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  else
    ok = launch_walk<float, false>(s, table, gtab, logden, adst, perm, ids, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K13.  As gat_bwd for one channel at K2's rounding points, in the edges'
// own order, but ct: [num_edges, kz+1] T (bf16 when `bf16` else f32),
// written whole (zeros for a padding edge), takes the cotangent rows in
// place of dpk; dadst: f32[num_rows], zeroed by the caller.
extern "C" int gat_bwd_glue(int device, const void* table, int bf16, const void* gtab,
                            const void* logden, const void* adst, const void* src,
                            const void* dst, void* ct, void* dadst, long long num_edges,
                            int num_rows, int kz, float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kz < 1) return (int)cudaErrorInvalidValue;
  if (num_edges > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned b = gat::warp_edge_blocks(num_edges);
    if (bf16)
      gat_bwd_glue_kernel<__nv_bfloat16><<<b, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(table), static_cast<const float*>(gtab),
          static_cast<const float*>(logden), static_cast<const float*>(adst),
          static_cast<const int*>(src), static_cast<const int*>(dst),
          static_cast<__nv_bfloat16*>(ct), static_cast<float*>(dadst), num_edges, num_rows,
          kz, 1, slope);
    else
      gat_bwd_glue_kernel<float><<<b, kThreads, 0, s>>>(
          static_cast<const float*>(table), static_cast<const float*>(gtab),
          static_cast<const float*>(logden), static_cast<const float*>(adst),
          static_cast<const int*>(src), static_cast<const int*>(dst), static_cast<float*>(ct),
          static_cast<float*>(dadst), num_edges, num_rows, kz, 1, slope);
  }
  return (int)cudaGetLastError();
}
