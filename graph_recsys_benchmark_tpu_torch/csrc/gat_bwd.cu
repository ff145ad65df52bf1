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
// K14, ops/flash_gat.py:_make_flash_bwd_kernel (the one-pass backward, the
// JAX route when FLASH_BWD_MEGA is set), launched by
// ops/flash_gat.flash_gat_bwd_onepass: K2's function at K2's rounding
// points on other stats.  Per dst row d its stat row stat[d] = [g | gout |
// logden | a_dst] (f32[kz+3]) holds g NOT rounded to the transport, as
// the TPU route builds it (flash_gat.py:1365-1373), so in bf16 datt sums
// the products of the unrounded g (in f32 the two functions are the same).
// The walk above runs it as a mode of its own (StatRow, a __global__
// instance apart from K2's): each edge reads its dst's stat row in place,
// g and gout, then logden and a_dst from columns kz+1 and kz+2 of the same
// row (K2 gathers them from two more tables), with K2's layouts and
// 256-column passes at any kz, 4 positions a worker (gat_bwd's slice
// rule).  The design before this one mirrored the TPU kernel: a CTA a
// piece of a 128-row dst block's edge range, the block's stat rows staged
// in shared memory (so kz <= 125), one warp an edge in the edges' own
// order and kz+1 scalar f32 atomics an edge by source (11.0 M a flagship
// call): 0.098 ms against a bound of 0.004 (PERF.md section 6).  On this
// card the staging bought little: the time went into the atomics by
// source, which the walk sums first.  What is left is K2's (each edge's
// stat-row gather, the zeroing and the launch); the one row a dst reads
// 5-12 % slower than K2's three tables on the same sums, for a reason
// not measured.
//
// K13, ops/flash_gat.py:_make_bwd_glue_kernel(fused_scatter=False) (the JAX
// route when the fused tables exceed 13 MiB, flash_gat.py:1444-1479),
// launched by ops/flash_gat.flash_gat_bwd_glue: K2's per-edge math at K2's
// rounding points, but instead of a sum by src each edge STORES its
// cotangent row [round_T(g * att) | round_T(dpre)] into ct[e, :] in the
// transport type T, at the edge's own index e, so that ct keeps the edges'
// order and the scatter that follows (segment.cu's scatter_add, the port's
// K6, by src) and the plain version see the same tensor.  A padding edge's
// row is written as exact zeros (the TPU contract, flash_gat.py:852-855):
// ct comes from torch.empty.  da_dst sums the unrounded dpre by dst, as the
// TPU kernel reduces da_dst in-kernel (flash_gat.py:968-979).  The kernel
// walks the graph's stable sort by dst (StepGraph.dst_perm / dst_sorted,
// padding last), as K1/K12's forward does (gat_fwd.cu), so that a dst row's
// edges are one run: its stat row loads once a run, and the run's dpre
// reaches da_dst with one atomic (any walk order stays right).  datt sums
// in the order of torch's sum at kz 64 (see gat_bwd_glue_walk_kernel), so
// the stored rows stay within a unit of the plain version's last place.
// Its design history and times are in PERF.md section 6.

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
// StatRow (K14, one channel): gtab is the stat table [num_rows, kz+3]
// whose row d also holds logden and a_dst (columns kz+1, kz+2); logden and
// adst are not read.
template <typename T, bool RoundAttFirst, int GE, int GC, int J, bool Wide, bool StatRow>
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
  const int gw = StatRow ? kz + 3 : width;  // floats of a dst's row of gtab
  const int bw = gat::walk_row_floats(stride, kCols, Wide);
  float* buf = reinterpret_cast<float*>(smem) + (warp * kWorkers + wk) * bw;
  // the worker's slice [k0, k0 + slice) of the walk (gat::walk_slice)
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

    // the run's row of dpk: the worker's columns and dpre into its shared
    // row, then 16-byte atomics (the worker's lanes only: a run ends where
    // the worker's source changes)
    auto flush = [&](int s) {
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (colv[j]) buf[c * bz + gl + j * GC] = acc[j];
      if (last && chv && gl == 0) buf[c * bz + kz - base] = accd;
      __syncwarp(wmask);
      float4* out = reinterpret_cast<float4*>(dpk + (long long)s * stride + base);
      const float4* b4 = reinterpret_cast<const float4*>(buf);
      for (int q = wl; q < span / 4; q += GE) atomicAdd(out + q, b4[q]);
      __syncwarp(wmask);
    };
    auto edge = [&](int, int s, int d, bool real, bool fresh) {
      const float* grow = gtab + (long long)d * gw + c * bz;
      const T* row = table + (long long)s * width + c * bz;
      const long long cd = (long long)c * num_rows + d;
      const bool v = real && chv;  // padding: no load
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
      const float ld = v ? __ldg(StatRow ? grow + kz + 1 : logden + cd) : 0.f;
      const float pre = v ? __ldg(StatRow ? grow + kz + 2 : adst + cd) + to_f32(row[kz]) : 0.f;
#pragma unroll
      for (int o = GC / 2; o > 0; o >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
      if (!real) return;  // uniform in the worker, after the warp's shuffles
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
      // the sums by source, in walk order
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float t = round_t<T>(__fmul_rn(g[j], a));
        acc[j] = fresh ? t : __fadd_rn(acc[j], t);
      }
      accd = fresh ? dpre_t : __fadd_rn(accd, dpre_t);
    };
    gat::walk_slice<GE, false, false>(perm, ids, dst, k0, slice, num_edges, num_rows, edge,
                                      flush);
    __syncwarp(wmask);  // the next pass zeroes buf
  }
}

template <typename T, bool RoundAttFirst, int GE, int GC, int J, bool Wide, bool StatRow>
void launch_walk(cudaStream_t s, const void* table, const void* gtab, const void* logden,
                 const void* adst, const void* perm, const void* ids, const void* dst, void* dpk,
                 void* dadst, long long num_edges, int num_rows, int kz, int n_ch, int stride,
                 int slice, float slope) {
  const long long per_warp = (long long)slice * (32 / GE);
  const long long warps = (num_edges + per_warp - 1) / per_warp;
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  const size_t smem =
      (size_t)kThreads / GE * gat::walk_row_floats(stride, GC * J, Wide) * sizeof(float);
  gat_bwd_walk_kernel<T, RoundAttFirst, GE, GC, J, Wide, StatRow><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(table), static_cast<const float*>(gtab),
      static_cast<const float*>(logden), static_cast<const float*>(adst),
      static_cast<const int*>(perm), static_cast<const int*>(ids), static_cast<const int*>(dst),
      static_cast<float*>(dpk), static_cast<float*>(dadst), num_edges, num_rows, kz, n_ch,
      stride, slice, slope);
}

// The worker layout (GE lanes an edge, GC lanes a channel, J columns a
// lane) for (kz, n_ch), or false where none is built: K2's rounding (and
// K14's, StatRow) for one channel at any kz (past 256 in 256-column
// passes), K4's for n_ch <= 8 at kz <= 128.
template <typename T, bool RoundAttFirst, bool StatRow>
bool launch_walk(cudaStream_t s, const void* table, const void* gtab, const void* logden,
                 const void* adst, const void* perm, const void* ids, const void* dst, void* dpk,
                 void* dadst, long long num_edges, int num_rows, int kz, int n_ch, int stride,
                 int slice, float slope) {
#define GAT_BWD_WALK(GE, GC, J, WIDE)                                                    \
  launch_walk<T, RoundAttFirst, GE, GC, J, WIDE, StatRow>(                                \
      s, table, gtab, logden, adst, perm, ids, dst, dpk, dadst, num_edges, num_rows, kz, \
      n_ch, stride, slice, slope)
  if constexpr (!RoundAttFirst) {  // K2, K14: one channel
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

// The walk on `stream` for the entries below: K4's rounding points where
// `round_att_first`, else K2's, or K14's where `stat_row`.  Returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses).
int bwd_walk(int device, const void* table, int bf16, int round_att_first, bool stat_row,
             const void* gtab, const void* logden, const void* adst, const void* perm,
             const void* ids, const void* dst, void* dpk, void* dadst, long long num_edges,
             int num_rows, int kz, int n_ch, int stride, float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_ch < 1 || n_ch > 8 || kz < 1 || num_edges < 0 ||
      (stat_row && (n_ch != 1 || round_att_first)) ||
      stride != (n_ch * (kz + 1) + 3) / 4 * 4 || reinterpret_cast<uintptr_t>(dpk) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // positions of the walk a worker takes, by kernel and transport, fitted
  // to the flagship's calls alone (K2 and K14 at kz 64 on 169,472
  // positions, K4 at kz 16 with 7 and 2 channels on 73,728):
  // torch_tools/gat_bwd_walk.py read K2 in f32 fastest at 16, K2 in bf16,
  // K4 and K14 at 4 (K4 in f32 within 1 % of 8; K14 in f32 0.043 ms at 4,
  // 0.048 at 16); the other layouts take the same slices unmeasured
  const int slice = !bf16 && !round_att_first && !stat_row ? 16 : 4;
  bool ok;
  if (bf16 && round_att_first)
    ok = launch_walk<__nv_bfloat16, true, false>(s, table, gtab, logden, adst, perm, ids, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  else if (bf16 && stat_row)
    ok = launch_walk<__nv_bfloat16, false, true>(s, table, gtab, logden, adst, perm, ids, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  else if (bf16)
    ok = launch_walk<__nv_bfloat16, false, false>(s, table, gtab, logden, adst, perm, ids, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  else if (round_att_first)
    ok = launch_walk<float, true, false>(s, table, gtab, logden, adst, perm, ids, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  else if (stat_row)
    ok = launch_walk<float, false, true>(s, table, gtab, logden, adst, perm, ids, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  else
    ok = launch_walk<float, false, false>(s, table, gtab, logden, adst, perm, ids, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, stride, slice, slope);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K13 on the graph's walk by dst (one channel, K2's rounding points), a
// warp an edge.  Lane l sums datt's products of columns l, l + 32, ... in
// order, then the warp's butterfly (xor 16 .. 1): at the flagship's kz 64
// that is also the order of torch's own sum on the card, so the stored rows
// match the plain version's bitwise there.  Per run of a dst row: its g
// columns (J a lane, in registers; Wide, past 256 columns: read from gtab
// an edge), gout, logden and a_dst, loaded once; per edge: the source row's
// gather, att (which needs no datt, so the g * att columns are stored as
// the row is read), the row of ct stored whole at the edge's own index e
// (exact zeros with no load on a padding edge); per run: one atomic of its
// f32 sum of dpre into dadst.
template <typename T, int J, bool Wide>
__global__ void __launch_bounds__(kThreads) gat_bwd_glue_walk_kernel(
    const T* __restrict__ table, const float* __restrict__ gtab,
    const float* __restrict__ logden, const float* __restrict__ adst,
    const int* __restrict__ perm, const int* __restrict__ ids, const int* __restrict__ src,
    T* __restrict__ ct, float* __restrict__ dadst, long long num_edges, int num_rows, int kz,
    int slice, float slope) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bz = kz + 1;
  bool colv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) colv[j] = lane + 32 * j < kz;
  // the run's stats and sum: the lane's g columns, gout, logden, a_dst, dpre
  float g[J], gout = 0.f, ld = 0.f, ad = 0.f, accd = 0.f;
  auto run_end = [&](int d) {
    if (lane == 0) atomicAdd(dadst + d, accd);
  };
  auto edge = [&](int e, int s, int d, bool real, bool fresh) {
    if (e < 0) return;  // past the walk
    T* out = ct + (long long)e * bz;
    if (!real) {  // a padding edge's row: exact zeros, no load
      for (int q = lane; q < bz; q += 32) out[q] = gat::from_f32<T>(0.f);
      return;
    }
    const float* grow = gtab + (long long)d * bz;
    if (fresh) {  // the new run's stats
      if constexpr (!Wide) {
#pragma unroll
        for (int j = 0; j < J; ++j) g[j] = colv[j] ? __ldg(grow + lane + 32 * j) : 0.f;
      }
      gout = __ldg(grow + kz);
      ld = __ldg(logden + d);
      ad = __ldg(adst + d);
    }
    const T* row = table + (long long)s * bz;
    const float pre = ad + to_f32(row[kz]);
    // _rn intrinsics keep nvcc from contracting into FMAs, so every
    // product and difference rounds as the plain version's does
    const float act = pre > 0.f ? pre : __fmul_rn(slope, pre);
    const float att = expf(fminf(__fsub_rn(act, ld), 60.f));
    float part = 0.f;
    if constexpr (Wide) {
      for (int k = lane; k < kz; k += 32) {
        const float gk = __ldg(grow + k);
        part = __fadd_rn(part, __fmul_rn(gk, to_f32(row[k])));
        out[k] = gat::from_f32<T>(__fmul_rn(gk, att));  // rounds: round_T
      }
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (!colv[j]) continue;
        const int col = lane + 32 * j;
        part = __fadd_rn(part, __fmul_rn(g[j], to_f32(row[col])));
        out[col] = gat::from_f32<T>(__fmul_rn(g[j], att));  // rounds: round_T
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
    const float dalpha = __fmul_rn(att, __fsub_rn(part, gout));
    const float dpre = pre > 0.f ? dalpha : __fmul_rn(dalpha, slope);
    if (lane == 0) out[kz] = gat::from_f32<T>(dpre);  // round_T(dpre)
    accd = fresh ? dpre : __fadd_rn(accd, dpre);  // da_dst sums the unrounded dpre
  };
  const long long k0 = ((long long)blockIdx.x * kWarps + warp) * slice;
  gat::walk_slice<32, true, true>(perm, ids, src, k0, slice, num_edges, num_rows, edge,
                                  run_end);
}

template <typename T, int J, bool Wide>
void launch_glue(cudaStream_t s, const void* table, const void* gtab, const void* logden,
                 const void* adst, const void* perm, const void* ids, const void* src, void* ct,
                 void* dadst, long long num_edges, int num_rows, int kz, int slice,
                 float slope) {
  const long long warps = (num_edges + slice - 1) / slice;
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  gat_bwd_glue_walk_kernel<T, J, Wide><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(table), static_cast<const float*>(gtab),
      static_cast<const float*>(logden), static_cast<const float*>(adst),
      static_cast<const int*>(perm), static_cast<const int*>(ids), static_cast<const int*>(src),
      static_cast<T*>(ct), static_cast<float*>(dadst), num_edges, num_rows, kz, slice, slope);
}

// K13's layout for kz: J columns a lane, past 256 in passes of 32.  A warp
// an edge read fastest at the flagship's kz 64 (torch_tools/gat_bwd_walk.py,
// PERF.md section 6); the other widths take it unmeasured.
template <typename T>
void launch_glue(cudaStream_t s, const void* table, const void* gtab, const void* logden,
                 const void* adst, const void* perm, const void* ids, const void* src, void* ct,
                 void* dadst, long long num_edges, int num_rows, int kz, int slice,
                 float slope) {
#define GAT_BWD_GLUE(J, WIDE)                                                             \
  launch_glue<T, J, WIDE>(s, table, gtab, logden, adst, perm, ids, src, ct, dadst,        \
                          num_edges, num_rows, kz, slice, slope)
  if (kz <= 32) GAT_BWD_GLUE(1, false);
  else if (kz <= 64) GAT_BWD_GLUE(2, false);
  else if (kz <= 128) GAT_BWD_GLUE(4, false);
  else if (kz <= 256) GAT_BWD_GLUE(8, false);
  else GAT_BWD_GLUE(1, true);
#undef GAT_BWD_GLUE
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
  return bwd_walk(device, table, bf16, round_att_first, false, gtab, logden, adst, perm, ids,
                  dst, dpk, dadst, num_edges, num_rows, kz, n_ch, stride, slope, stream);
}

// K14.  As gat_bwd for one channel at K2's rounding points, but stat:
// f32[num_rows, kz+3] rows [g | gout | logden | a_dst] in place of gtab,
// logden and adst; dpk: f32[n, stride] (stride = kz+1 rounded up to 4) and
// dadst: f32[num_rows], both zeroed by the caller.
extern "C" int gat_bwd_onepass(int device, const void* table, int bf16, const void* stat,
                               const void* perm, const void* ids, const void* dst, void* dpk,
                               void* dadst, long long num_edges, int num_rows, int kz,
                               int stride, float slope, void* stream) {
  return bwd_walk(device, table, bf16, 0, true, stat, nullptr, nullptr, perm, ids, dst, dpk,
                  dadst, num_edges, num_rows, kz, 1, stride, slope, stream);
}

// K13.  As gat_bwd for one channel at K2's rounding points, but on the
// walk by dst: for k = 0 .. num_edges-1 the edge perm[k] of dst row ids[k]
// (ids = dst[perm], StepGraph.dst_perm / dst_sorted, padding ids >=
// num_rows last), src: int32[num_edges] in the edges' order; ct:
// [num_edges, kz+1] T (bf16 when `bf16` else f32), row e the cotangent
// row of edge e, written whole (zeros for a padding edge), in place of
// dpk; dadst: f32[num_rows], zeroed by the caller.  Any kz.
extern "C" int gat_bwd_glue(int device, const void* table, int bf16, const void* gtab,
                            const void* logden, const void* adst, const void* perm,
                            const void* ids, const void* src, void* ct, void* dadst,
                            long long num_edges, int num_rows, int kz, float slope,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kz < 1 || num_edges < 0 || num_rows < 0) return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // positions of the walk a warp takes: torch_tools/gat_bwd_walk.py read 8
  // fastest at the flagship's kz 64 in both transports (PERF.md section 6)
  const int slice = 8;
  if (bf16)
    launch_glue<__nv_bfloat16>(s, table, gtab, logden, adst, perm, ids, src, ct, dadst, num_edges, num_rows, kz, slice, slope);
  else
    launch_glue<float>(s, table, gtab, logden, adst, perm, ids, src, ct, dadst, num_edges, num_rows, kz, slice, slope);
  return (int)cudaGetLastError();
}
