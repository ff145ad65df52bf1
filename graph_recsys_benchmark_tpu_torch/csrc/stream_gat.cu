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
// from run to run.  The stat table's row stride is padded to a multiple
// of 8 values (16 bytes in bf16, 32 in f32), so every stat row and every
// 128-row block of it starts 16-byte aligned.
//
// What bounds them on the H100.  Per (edge, channel) they read a
// (kz+1)-wide source band and a (kz+3)-wide stat band and do ~2-4 kz
// flops; there is no tensor-core work.  The one-warp-per-edge design they
// replace ran 30-40x the bytes it must move (K10 2.78 ms, K11 4.18
// ms an ML-25M step on one H100, f32; bf16 no faster): the limit was
// instructions and per-edge latency.  One warp an edge left half its lanes
// idle at kz 16 and took a 5-level butterfly per channel (35 shuffles an
// edge at 7 channels); K11 walked 32 src-sorted edges one after another
// through three dependent loads each (perm, dst, the stat row); K10 added
// 7 global f32 atomics an edge.  What bounds the designs below is latency
// and occupancy: each SM needs many edges' gathered rows in flight, so
// every byte of shared memory a CTA holds costs resident warps (K11
// staging its src block's table rows and a [128, width] f32 accumulator
// ran slower on one H100 than without them, in trial builds).  The TPU kernels
// reduce per 128-row block with the block resident in VMEM; here:
//   * pieces.  A CTA takes one chunk of `piece_edges` consecutive edges of
//     the walk's order (the graph's block order for K10, the src-sorted
//     order for K11) and works it block by block: each nonempty
//     intersection of the chunk with a 128-row block's edge range
//     (StepGraph.block_bounds by dst, StepGraph.src_block_bounds by src)
//     is one piece.  So every CTA takes at most piece_edges edges whatever
//     the skew (the busiest 128-item block of u2i holds 411,933 of 2.13 M
//     edges), the grid is ceil(E / piece_edges) without reading any count,
//     and no CTA stages a block for nothing;
//   * lanes over (edge, channel, column group).  A group of G lanes (G the
//     least power of two with 8 G >= kz: 2 at kz 16, 8 at kz 64, 16 at kz
//     125) takes one (edge, channel) unit, each lane <= 8 of its columns; a
//     CTA pass takes floor(threads / G / n_ch) edges.  datt reduces over
//     the group in log2(G) shuffles, every channel of every edge of the
//     pass at once, and every lane of the group then holds it;
//   * K10 stages its dst block's 128 stat rows in shared memory with
//     cp.async (16-byte copies; 69.6 KB in f32 at (7, 16)), gathers only
//     each edge's source row from global memory (edges of a block are
//     sorted by src, so the units of one pass that share a source read the
//     same addresses in one transaction), loads each pass's ids a pass
//     ahead, sums round_T(dpre) into a shared da_dst[n_ch][128] and flushes
//     it with one global atomic a (channel, row) a piece;
//   * K11 loads its chunk's dst[perm[e]] and src ids with every thread
//     first (one round trip a chunk) and keeps the next kStages - 1 passes'
//     stat rows (gathered by dst) in flight through a cp.async ring in
//     shared memory while the current pass computes.  Each edge slot of a
//     CTA walks a contiguous slice of its piece, so a thread meets one
//     source's edges one after another: it keeps the source's z and a_src
//     in registers (the next pass's row loaded a pass ahead when the
//     source changes), sums the run in registers and adds it into dpk with
//     one atomic a column when the source changes (a hot source's run
//     spans many passes);
//   * layouts past shared memory ((8, 125): a 128-row f32 stat block is
//     524 KB) run K10 unstaged: the block's stat rows are read from global
//     memory;
//   * padding edges (dst >= num_rows) are skipped by dst before any other
//     load.  In the src-sorted order they sit inside row 0's run (src 0;
//     the stable sort puts them after row 0's real edges).  An edge whose
//     dst lies outside its K10 piece's block (an order that is not
//     block-monotone) reads and adds through global memory, so any order
//     gives the right sums.

#include <cstdint>

#include "gat_common.cuh"

namespace {

using gat::round_t;
using gat::to_f32;

constexpr int kRows = 128;            // rows of a dst (K10) or src (K11) block
constexpr int kDstThreads = 256;      // K10's CTA
constexpr int kSrcThreads = 256;      // K11's CTA
constexpr int kStages = 4;            // K11's ring of gathered stat rows
constexpr int kMaxCols = 8;           // columns a lane takes of a unit
constexpr int kSmemLimit = 232448;    // dynamic shared memory a CTA may use (227 KB)
constexpr int kMaxSrcPiece = 8192;    // K11's chunk ids in shared memory, 8 bytes an edge

template <typename T>
__global__ void __launch_bounds__(256) stream_gat_fwd_kernel(
    const T* __restrict__ table, const float* __restrict__ adst,
    const float* __restrict__ mhat, const int* __restrict__ src,
    const int* __restrict__ dst, float* __restrict__ acc, long long num_edges,
    int num_rows, int kz, int n_ch, float slope) {
  gat::fwd_edges<T, true>(table, adst, mhat, src, dst, acc, num_edges, num_rows,
                          kz, n_ch, slope);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* sdst, const void* gsrc) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(sdst)),
               "l"(gsrc)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `bytes` (a multiple of 16: whole stat rows, whose stride
// bad_stride keeps at 16-byte multiples) from 16-byte aligned global memory
// into 16-byte aligned shared memory with every thread of the CTA, 16-byte
// cp.async copies in one committed group.  The caller waits for the group
// and syncs before reading.
__device__ __forceinline__ void stage_bytes(void* sdst, const void* gsrc, long long bytes) {
  char* d = static_cast<char*>(sdst);
  const char* s = static_cast<const char*>(gsrc);
  for (long long i = threadIdx.x; i < (bytes >> 4); i += blockDim.x)
    cp_async16(d + 16 * i, s + 16 * i);
  cp_async_commit();
}

// The block of edge position x: the last b < n_blocks with bounds[b] <= x
// (bounds[0] = 0, so one exists; empty blocks are passed over).
__device__ __forceinline__ int block_of(const int* __restrict__ bounds, int n_blocks,
                                        long long x) {
  int lo = 0, hi = n_blocks - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bounds[mid] <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// datt of one (edge, channel) unit, summed over the lanes of its group of
// `group` lanes (aligned, a power of two) in log2(group) shuffle levels;
// every lane of the group ends with the same sum.  All 32 lanes of the
// warp must call it.
__device__ __forceinline__ float group_sum(float part, int group) {
  for (int o = group >> 1; o > 0; o >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
  return part;
}

// att and dpre of one unit from its stat band srow ([g_c | gout_c |
// logden_c | a_dst_c] in T), its source's a_src_c and its datt.  The _rn
// intrinsics keep nvcc from contracting into FMAs, so every product and
// difference rounds as the plain version's does.
template <typename T>
__device__ __forceinline__ void unit_grads(const T* srow, float asrc, float datt, int kz,
                                           float slope, float& att, float& dpre) {
  const float pre = to_f32(srow[kz + 2]) + asrc;
  att = gat::edge_weight(pre, to_f32(srow[kz + 1]), slope);
  const float dalpha = __fmul_rn(att, __fsub_rn(datt, to_f32(srow[kz])));
  dpre = pre > 0.f ? dalpha : __fmul_rn(dalpha, slope);
}

// K10.  Shared memory: da[n_ch][128] f32, then (staged) the block's stat
// rows [nr][sstride] T.  Each thread takes one unit a pass; the pass's
// ids are loaded a pass ahead.
template <typename T>
__global__ void __launch_bounds__(kDstThreads) stream_gat_bwd_dst_kernel(
    const T* __restrict__ table, const T* __restrict__ stat, const int* __restrict__ src,
    const int* __restrict__ dst, const int* __restrict__ bounds, float* __restrict__ dadst,
    int n_blocks, int num_rows, int kz, int n_ch, int sstride, int group, int staged,
    int piece_edges, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* da = reinterpret_cast<float*>(smem);
  T* st = reinterpret_cast<T*>(smem + (size_t)n_ch * kRows * sizeof(float));
  const int bz = kz + 1, sz = kz + 3, width = n_ch * bz;
  const int u = threadIdx.x / group, gl = threadIdx.x - u * group;
  const int per = blockDim.x / group / n_ch;  // edges a pass
  const int j = u / n_ch, c = u - j * n_ch;
  const bool active = j < per;
  const long long chunk_lo = (long long)blockIdx.x * piece_edges;
  const long long chunk_hi = min(chunk_lo + piece_edges, (long long)bounds[n_blocks]);
  for (int b = block_of(bounds, n_blocks, chunk_lo); b < n_blocks && bounds[b] < chunk_hi;
       ++b) {
    const long long lo = max(chunk_lo, (long long)bounds[b]);
    const long long hi = min(chunk_hi, (long long)bounds[b + 1]);
    if (lo >= hi) continue;  // uniform: an empty block
    const int row0 = b * kRows, nr = min(kRows, num_rows - row0);
    __syncthreads();  // the previous piece's flush has read da and st
    if (staged)
      stage_bytes(st, stat + (long long)row0 * sstride, (long long)nr * sstride * sizeof(T));
    for (int i = threadIdx.x; i < n_ch * kRows; i += blockDim.x) da[i] = 0.f;
    cp_async_wait<0>();
    __syncthreads();
    const T* sblock = staged ? st : stat + (long long)row0 * sstride;
    long long e = lo + j;
    int d_next = active && e < hi ? dst[e] : num_rows;
    int s_next = d_next < num_rows ? src[e] : 0;  // padding: no other load
    for (long long base = lo; base < hi; base += per, e += per) {
      const int d = d_next, s = s_next;
      d_next = active && e + per < hi ? dst[e + per] : num_rows;
      s_next = d_next < num_rows ? src[e + per] : 0;
      const bool real = d < num_rows;
      const int r = d - row0;
      const bool local = (unsigned)r < (unsigned)nr;
      const T* srow =
          (local ? sblock + (long long)r * sstride : stat + (long long)d * sstride) + c * sz;
      const T* zrow = table + (long long)s * width + c * bz;
      float part = 0.f;
      if (real) {
#pragma unroll
        for (int t = 0; t < kMaxCols; ++t) {
          const int f = gl + t * group;
          if (f < kz)
            part = __fadd_rn(part, round_t<T>(__fmul_rn(to_f32(srow[f]), to_f32(zrow[f]))));
        }
      }
      part = group_sum(part, group);
      if (real && gl == 0) {
        float att, dpre;
        unit_grads<T>(srow, to_f32(zrow[kz]), part, kz, slope, att, dpre);
        const float v = round_t<T>(dpre);
        if (local) atomicAdd(da + c * kRows + r, v);
        else atomicAdd(dadst + (long long)c * num_rows + d, v);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_ch * nr; i += blockDim.x) {
      const int cc = i / nr, r = i - cc * nr;
      const float v = da[cc * kRows + r];
      if (v != 0.f) atomicAdd(dadst + (long long)cc * num_rows + row0 + r, v);
    }
  }
}

// Add a thread's open run (its columns of one source's band c) into `out`.
__device__ __forceinline__ void add_run(float* out, float (&run)[kMaxCols], float& run_dpre,
                                        int gl, int group, int kz) {
#pragma unroll
  for (int t = 0; t < kMaxCols; ++t) {
    const int f = gl + t * group;
    if (f < kz) atomicAdd(out + f, run[t]);
    run[t] = 0.f;
  }
  if (gl == 0) atomicAdd(out + kz, run_dpre);
  run_dpre = 0.f;
}

// K11.  Shared memory: the chunk's dst ids and src ids int[piece_edges]
// each, then the ring [kStages][per][sstride] T.  Each of a piece's `per`
// edge slots walks a contiguous slice of the piece, one edge a pass, so a
// thread's consecutive edges are consecutive in src order: its run sums
// and its source's z and a_src stay in registers until the source changes
// (the next pass's source row is loaded a pass ahead), and a run adds into
// dpk once.
template <typename T>
__global__ void __launch_bounds__(kSrcThreads) stream_gat_bwd_src_kernel(
    const T* __restrict__ table, const T* __restrict__ stat, const int* __restrict__ perm,
    const int* __restrict__ src_sorted, const int* __restrict__ dst,
    const int* __restrict__ bounds, float* __restrict__ dpk, int n_blocks, int num_rows,
    int kz, int n_ch, int sstride, int group, int piece_edges, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bz = kz + 1, sz = kz + 3, width = n_ch * bz;
  const int per = blockDim.x / group / n_ch;  // edge slots
  const size_t stage_elems = (size_t)per * sstride;
  int* sd = reinterpret_cast<int*>(smem);
  int* ss = sd + piece_edges;
  T* ring = reinterpret_cast<T*>(smem + (((size_t)piece_edges * 8 + 15) & ~(size_t)15));

  const long long chunk_lo = (long long)blockIdx.x * piece_edges;
  const long long chunk_hi = min(chunk_lo + piece_edges, (long long)bounds[n_blocks]);
  // every id of the chunk first: dst[perm[e]], then src_sorted[e]
  for (long long i = threadIdx.x; i < chunk_hi - chunk_lo; i += blockDim.x) {
    sd[i] = dst[perm[chunk_lo + i]];
    ss[i] = src_sorted[chunk_lo + i];
  }
  const int u = threadIdx.x / group, gl = threadIdx.x - u * group;
  const int j = u / n_ch, c = u - j * n_ch;
  const bool active = j < per;
  const int cpr = sstride * (int)sizeof(T) / 16;  // 16-byte copies a stat row

  for (int b = block_of(bounds, n_blocks, chunk_lo); b < n_blocks && bounds[b] < chunk_hi;
       ++b) {
    const long long lo = max(chunk_lo, (long long)bounds[b]);
    const long long hi = min(chunk_hi, (long long)bounds[b + 1]);
    if (lo >= hi) continue;  // uniform: an empty block
    const int off = (int)(lo - chunk_lo), n_e = (int)(hi - lo);
    const int len = (n_e + per - 1) / per;  // passes: slot jr takes [jr*len, (jr+1)*len)
    __syncthreads();  // the ids are written; the last piece's ring is read
    // pass q's stat rows into ring slot q % kStages, one committed group a
    // pass (empty past the last)
    auto issue = [&](int q) {
      if (q < len) {
        T* slot = ring + (size_t)(q % kStages) * stage_elems;
        for (int i = threadIdx.x; i < per * cpr; i += blockDim.x) {
          const int jr = i / cpr, part = i - jr * cpr;
          const int k = jr * len + q;
          if (k < n_e) {
            const int d = sd[off + k];
            if (d < num_rows)  // padding: no load
              cp_async16(slot + (size_t)jr * sstride + part * (16 / sizeof(T)),
                         stat + (long long)d * sstride + part * (16 / sizeof(T)));
          }
        }
      }
      cp_async_commit();
    };
    for (int q = 0; q < kStages - 1; ++q) issue(q);
    int s_next = -1;  // the source whose row z_next holds
    float z_next[kMaxCols], asrc_next = 0.f;
    auto load_next = [&](int q) {
      const int k = j * len + q;
      if (!active || q >= len || k >= n_e || sd[off + k] >= num_rows) return;
      const int s = ss[off + k];
      if (s == s_next) return;
      s_next = s;
      const T* zrow = table + (long long)s * width + c * bz;
      asrc_next = to_f32(zrow[kz]);
#pragma unroll
      for (int t = 0; t < kMaxCols; ++t) {
        const int f = gl + t * group;
        z_next[t] = f < kz ? to_f32(zrow[f]) : 0.f;
      }
    };
    load_next(0);
    int cur = -1;  // the source of this thread's open run
    float run[kMaxCols], run_dpre = 0.f, zc[kMaxCols], asrc = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxCols; ++t) run[t] = zc[t] = 0.f;
    for (int q = 0; q < len; ++q) {
      issue(q + kStages - 1);
      cp_async_wait<kStages - 1>();  // this thread's copies of pass q landed
      __syncthreads();               // and everyone's
      const int k = j * len + q;
      const int d = active && k < n_e ? sd[off + k] : num_rows;
      const bool real = d < num_rows;  // padding: skipped before any other load
      if (real && ss[off + k] != cur) {
        if (cur >= 0) add_run(dpk + (long long)cur * width + c * bz, run, run_dpre, gl, group, kz);
        cur = s_next;  // == ss[off + k], loaded a pass ahead
        asrc = asrc_next;
#pragma unroll
        for (int t = 0; t < kMaxCols; ++t) zc[t] = z_next[t];
      }
      load_next(q + 1);
      const T* srow = ring + (size_t)(q % kStages) * stage_elems + (size_t)j * sstride + c * sz;
      float part = 0.f;
      if (real) {
#pragma unroll
        for (int t = 0; t < kMaxCols; ++t) {
          const int f = gl + t * group;
          if (f < kz) part = __fadd_rn(part, round_t<T>(__fmul_rn(to_f32(srow[f]), zc[t])));
        }
      }
      part = group_sum(part, group);
      if (real) {
        float att, dpre;
        unit_grads<T>(srow, asrc, part, kz, slope, att, dpre);
        const float att_r = round_t<T>(att);
#pragma unroll
        for (int t = 0; t < kMaxCols; ++t) {
          const int f = gl + t * group;
          if (f < kz) run[t] = __fadd_rn(run[t], round_t<T>(__fmul_rn(to_f32(srow[f]), att_r)));
        }
        run_dpre = __fadd_rn(run_dpre, round_t<T>(dpre));
      }
      __syncthreads();  // slot q % kStages is read before it is refilled
    }
    if (cur >= 0) add_run(dpk + (long long)cur * width + c * bz, run, run_dpre, gl, group, kz);
    cp_async_wait<0>();
  }
}

// Lanes an (edge, channel) unit: the least power of two G with kMaxCols G >= kz,
// at most 32 (kz <= 125 keeps each lane at <= kMaxCols columns).
int group_lanes(int kz) {
  int g = 1;
  while (kMaxCols * g < kz && g < 32) g <<= 1;
  return g;
}

bool bad_layout(int kz, int n_ch) { return n_ch < 1 || n_ch > 8 || kz < 1 || kz > 125; }

// A stat stride the backwards take: the band's n_ch * (kz+3) values padded
// to a multiple of 8 (16-byte rows in either type).
bool bad_stride(int sstride, int kz, int n_ch) {
  return sstride < n_ch * (kz + 3) || sstride % 8 != 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Plain C entries for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a layout it refuses:
// 1 <= n_ch <= 8, 1 <= kz <= 125).  T = bf16 when `bf16` else f32.
// table: [n, n_ch*(kz+1)] T row-major bands [z_c | a_src_c]; stat:
// [num_rows, sstride] T bands [g_c | gout_c | logden_c | a_dst_c] in its
// first n_ch*(kz+3) columns, sstride a multiple of 8; both 16-byte
// aligned; ids int32[num_edges], padding dst >= num_rows.

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

template <typename T>
cudaError_t launch_dst(const void* table, const void* stat, const void* src, const void* dst,
                       const void* bounds, void* dadst, long long num_edges, int n_blocks,
                       int num_rows, int kz, int n_ch, int sstride, int piece_edges,
                       float slope, cudaStream_t s) {
  const int group = group_lanes(kz);
  const size_t da_bytes = (size_t)n_ch * kRows * sizeof(float);
  const size_t st_bytes = (size_t)kRows * sstride * sizeof(T);
  const int staged = da_bytes + st_bytes <= (size_t)kSmemLimit;
  const size_t smem = da_bytes + (staged ? st_bytes : 0);
  cudaError_t err = allow_smem(stream_gat_bwd_dst_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((num_edges + piece_edges - 1) / piece_edges);
  stream_gat_bwd_dst_kernel<T><<<grid, kDstThreads, smem, s>>>(
      static_cast<const T*>(table), static_cast<const T*>(stat), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const int*>(bounds),
      static_cast<float*>(dadst), n_blocks, num_rows, kz, n_ch, sstride, group, staged,
      piece_edges, slope);
  return cudaSuccess;
}

// src/dst: the graph's block order; bounds: int32[n_blocks+1], the 128-row
// dst blocks' edge ranges (bounds[0] = 0, bounds[n_blocks] = num_edges,
// as ops/flash_gat.dst_block_bounds builds them; n_blocks = ceil(num_rows
// / 128)); dadst: f32[n_ch, num_rows], zeroed by
// the caller.  One CTA a chunk of piece_edges >= 1 edges.
extern "C" int stream_gat_bwd_dst(int device, const void* table, int bf16, const void* stat,
                                  const void* src, const void* dst, const void* bounds,
                                  void* dadst, long long num_edges, int n_blocks,
                                  int num_rows, int kz, int n_ch, int sstride,
                                  int piece_edges, float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_layout(kz, n_ch) || bad_stride(sstride, kz, n_ch) || num_edges < 0 ||
      piece_edges < 1 || n_blocks != (num_rows + kRows - 1) / kRows)
    return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch_dst<__nv_bfloat16>(table, stat, src, dst, bounds, dadst, num_edges,
                                         n_blocks, num_rows, kz, n_ch, sstride, piece_edges,
                                         slope, s)
             : launch_dst<float>(table, stat, src, dst, bounds, dadst, num_edges, n_blocks,
                                 num_rows, kz, n_ch, sstride, piece_edges, slope, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
cudaError_t launch_src(const void* table, const void* stat, const void* perm,
                       const void* src_sorted, const void* dst, const void* bounds, void* dpk,
                       long long num_edges, int n_blocks, int num_rows, int kz, int n_ch,
                       int sstride, int piece_edges, float slope, cudaStream_t s) {
  const int group = group_lanes(kz);
  const int per = kSrcThreads / group / n_ch;
  const size_t smem = (((size_t)piece_edges * 8 + 15) & ~(size_t)15) +
                      (size_t)kStages * per * sstride * sizeof(T);
  cudaError_t err = allow_smem(stream_gat_bwd_src_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((num_edges + piece_edges - 1) / piece_edges);
  stream_gat_bwd_src_kernel<T><<<grid, kSrcThreads, smem, s>>>(
      static_cast<const T*>(table), static_cast<const T*>(stat), static_cast<const int*>(perm),
      static_cast<const int*>(src_sorted), static_cast<const int*>(dst),
      static_cast<const int*>(bounds), static_cast<float*>(dpk), n_blocks, num_rows, kz, n_ch,
      sstride, group, piece_edges, slope);
  return cudaSuccess;
}

// perm/src_sorted: the graph's stable src sort (src_sorted[e] ==
// src[perm[e]]); dst: the block-ordered dst, read as dst[perm[e]]; bounds:
// int32[n_blocks+1], the 128-row src blocks' ranges of the src-sorted
// order (bounds[0] = 0, bounds[n_blocks] = num_edges; n_blocks =
// ceil(n_src / 128), n_src the table's rows); dpk:
// f32[n_src, n_ch*(kz+1)] bands [dz_c | da_src_c], zeroed by the caller.
// One CTA a chunk of 1 <= piece_edges <= 8192 edges.
extern "C" int stream_gat_bwd_src(int device, const void* table, int bf16, const void* stat,
                                  const void* perm, const void* src_sorted, const void* dst,
                                  const void* bounds, void* dpk, long long num_edges,
                                  int n_blocks, int n_src, int num_rows, int kz, int n_ch,
                                  int sstride, int piece_edges, float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_layout(kz, n_ch) || bad_stride(sstride, kz, n_ch) || num_edges < 0 ||
      piece_edges < 1 || piece_edges > kMaxSrcPiece ||
      n_blocks != (n_src + kRows - 1) / kRows)
    return (int)cudaErrorInvalidValue;
  if (num_edges == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch_src<__nv_bfloat16>(table, stat, perm, src_sorted, dst, bounds, dpk,
                                         num_edges, n_blocks, num_rows, kz, n_ch, sstride,
                                         piece_edges, slope, s)
             : launch_src<float>(table, stat, perm, src_sorted, dst, bounds, dpk, num_edges,
                                 n_blocks, num_rows, kz, n_ch, sstride, piece_edges, slope, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
