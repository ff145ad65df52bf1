// gat_bwd_onepass: the one-pass dst-block backward of the single-head GAT
// attention (csrc/gat_fwd.cu), for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel
//   ops/flash_gat.py:_make_flash_bwd_kernel (K14, runner _flash_bwd_impl,
//   taken when FLASH_BWD_MEGA is set), launched by
//   ops/flash_gat.flash_gat_bwd_onepass.
// Inputs per destination row d: the stat row stat[d] = [g | gout | logden |
// a_dst] (f32[kz+3]: g the output cotangent NOT rounded to the transport,
// as the TPU route builds it at flash_gat.py:1365-1373; gout = sum g * out;
// logden = m + log(s + 1e-16); a_dst rounded through T).  Per edge (s, d)
// with d < num_rows, K2's math (csrc/gat_bwd.cu) on these stats:
//   pre  = a_dst[d] + a_src[s],  act = leaky(pre)
//   att  = exp(min(act - logden[d], 60))
//   datt = sum_k g[d, k] * z[s, k]           (unrounded f32 products)
//   dpre = att * (datt - gout[d]) * leaky'(pre)
//   dpk[s]    += [ round_T(g * att) | round_T(dpre) ]   (f32 atomics)
//   da_dst[d] += dpre                                    (unrounded)
// In bf16 this is not K2's function (K2 reads round_T(g)); in f32 it is.
// The TPU kernel's f32 one-hot matmuls are exact in interpret mode, which
// is the reference; on a TPU its DEFAULT-precision stat broadcast would
// round g to bf16 first, this kernel does not.
//
// What bounds it on the H100: bytes, then atomics, as K2: each edge reads
// its source row and its dst's stat row, does ~3 kz flops and kz+1 f32
// atomic adds by src.  The TPU kernel walks a 128-row dst block's edge
// chunks with the block's stats resident and accumulates da_dst
// block-locally, so no [E, *] glue reaches HBM; the design keeps that:
//   * a CTA takes one PIECE of a dst block's edge range: the block's
//     range (StepGraph.block_bounds, the counterpart of
//     _block_chunk_bounds) cut into pieces of at most `piece_edges` edges,
//     so that the union graphs' skew (the busiest block holds 12.6x the
//     mean block's edges at the flagship) spreads over many CTAs instead of
//     setting the time from one SM (PERF.md, PR 4's K5 lesson);
//   * the CTA stages its block's 128 stat rows in shared memory (128 *
//     (kz+3) * 4 bytes, 34 KB at kz 64) and sums dpre into a shared
//     da_dst[128]; it flushes that with one global atomicAdd a row (a
//     block cut into several pieces adds from each);
//   * one warp per edge, lanes over the kz columns: products, a butterfly
//     shuffle reduction (every lane ends with the same datt), then every
//     lane forms att and dpre and adds its columns of the cotangent;
//   * padding edges (dst >= num_rows; with num_rows % 128 != 0 they lie in
//     the last block's range) are skipped before any other load; an edge
//     whose dst lies outside the CTA's block (an edge list that is not
//     block-monotone) reads its stat row from global memory and adds
//     da_dst globally, so any order gives the right sums.
// piece_end[b] is the inclusive prefix sum of the pieces of blocks 0..b;
// each CTA finds its block by a binary search over it, and the grid's
// surplus CTAs (the host sizes it without reading the counts) return.

#include "gat_common.cuh"

namespace {

using gat::round_t;
using gat::to_f32;

constexpr int kRows = 128;

template <typename T>
__global__ void __launch_bounds__(256) gat_bwd_onepass_kernel(
    const T* __restrict__ table, const float* __restrict__ stat,
    const int* __restrict__ src, const int* __restrict__ dst,
    const int* __restrict__ block_bounds, const int* __restrict__ piece_end,
    float* __restrict__ dpk, float* __restrict__ dadst, int n_blocks, int num_rows,
    int kz, int piece_edges, float slope) {
  extern __shared__ float sh[];
  const int sw = kz + 3;
  const int p = blockIdx.x;
  if (p >= piece_end[n_blocks - 1]) return;  // surplus CTA: uniform, before any barrier
  int lo = 0, hi = n_blocks - 1;  // the first block whose piece_end exceeds p
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (piece_end[mid] > p) hi = mid; else lo = mid + 1;
  }
  const int b = lo;
  const int k = p - (b > 0 ? piece_end[b - 1] : 0);
  const long long e_lo = block_bounds[b] + (long long)k * piece_edges;
  const long long e_hi = min(e_lo + piece_edges, (long long)block_bounds[b + 1]);
  const int row0 = b * kRows;
  const int nr = min(kRows, num_rows - row0);
  float* st = sh;                 // [nr, kz+3] stat rows of the block
  float* da = sh + kRows * sw;    // [128] the block's da_dst partial sums
  for (int i = threadIdx.x; i < nr * sw; i += blockDim.x)
    st[i] = stat[(long long)row0 * sw + i];
  for (int i = threadIdx.x; i < kRows; i += blockDim.x) da[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int bz = kz + 1;
  for (long long e = e_lo + (threadIdx.x >> 5); e < e_hi; e += blockDim.x >> 5) {
    const int d = dst[e];
    if (d >= num_rows) continue;  // padding sentinel: skip before any load
    const int r = d - row0;
    const bool local = (unsigned)r < (unsigned)nr;
    const float* grow = local ? st + r * sw : stat + (long long)d * sw;
    const long long s = src[e];
    const T* row = table + s * bz;
    float datt = 0.f;
    for (int f = lane; f < kz; f += 32)
      datt = __fadd_rn(datt, __fmul_rn(grow[f], to_f32(row[f])));
    for (int o = 16; o > 0; o >>= 1)
      datt = __fadd_rn(datt, __shfl_xor_sync(0xffffffffu, datt, o));
    // _rn intrinsics keep nvcc from contracting into FMAs, so every product
    // and difference rounds as the plain version's does
    const float pre = grow[kz + 2] + to_f32(row[kz]);
    const float act = pre > 0.f ? pre : __fmul_rn(slope, pre);
    const float att = expf(fminf(__fsub_rn(act, grow[kz + 1]), 60.f));
    const float dalpha = __fmul_rn(att, __fsub_rn(datt, grow[kz]));
    const float dpre = pre > 0.f ? dalpha : __fmul_rn(dalpha, slope);
    float* out = dpk + s * bz;
    for (int j = lane; j < bz; j += 32)
      atomicAdd(out + j, j < kz ? round_t<T>(__fmul_rn(grow[j], att)) : round_t<T>(dpre));
    if (lane == 0) atomicAdd(local ? da + r : dadst + d, dpre);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr; i += blockDim.x) atomicAdd(dadst + row0 + i, da[i]);
}

template <typename T>
cudaError_t launch(unsigned blocks, size_t smem, cudaStream_t s, const void* table,
                   const void* stat, const void* src, const void* dst,
                   const void* block_bounds, const void* piece_end, void* dpk, void* dadst,
                   int n_blocks, int num_rows, int kz, int piece_edges, float slope) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gat_bwd_onepass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  gat_bwd_onepass_kernel<T><<<blocks, 256, smem, s>>>(
      static_cast<const T*>(table), static_cast<const float*>(stat),
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const int*>(block_bounds), static_cast<const int*>(piece_end),
      static_cast<float*>(dpk), static_cast<float*>(dadst), n_blocks, num_rows, kz,
      piece_edges, slope);
  return cudaSuccess;
}

}  // namespace

// Plain C entry for ctypes.  table: [n, kz+1] T row-major [z | a_src] (T =
// bf16 when `bf16` else f32); stat: f32[num_rows, kz+3]; src/dst:
// int32[num_edges]; block_bounds: int32[n_blocks+1], block b's edges are
// [block_bounds[b], block_bounds[b+1]), covering [0, num_edges); piece_end:
// int32[n_blocks]; dpk: f32[n, kz+1] and dadst: f32[num_rows], both zeroed
// by the caller.  `grid` CTAs, at least piece_end[n_blocks-1].  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int gat_bwd_onepass(int device, const void* table, int bf16, const void* stat,
                               const void* src, const void* dst, const void* block_bounds,
                               const void* piece_end, void* dpk, void* dadst, int grid,
                               int n_blocks, int num_rows, int kz, int piece_edges,
                               float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kz < 1 || kz > 125 || piece_edges < 1 || n_blocks < 1 || grid < 0)
    return (int)cudaErrorInvalidValue;
  if (grid > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = (size_t)(kRows * (kz + 3) + kRows) * sizeof(float);
    err = bf16 ? launch<__nv_bfloat16>(grid, smem, s, table, stat, src, dst, block_bounds,
                                       piece_end, dpk, dadst, n_blocks, num_rows, kz,
                                       piece_edges, slope)
               : launch<float>(grid, smem, s, table, stat, src, dst, block_bounds, piece_end,
                               dpk, dadst, n_blocks, num_rows, kz, piece_edges, slope);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
