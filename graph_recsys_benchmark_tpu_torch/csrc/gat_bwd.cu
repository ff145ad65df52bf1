// gat_bwd: backward of the single-head bound-shift GAT attention
// (csrc/gat_fwd.cu) for n_ch <= 8 channels that share one edge list, for
// Hopper (sm_90a).
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
//   datt = sum_k g_c[d, k] * z_c[s, k]            (warp reduction)
//   dpre = att * (datt - gout_c[d]) * leaky'(pre)
//   dpk[s, band c]  += [ att * g_c[d] | dpre ]   (f32 atomics)
//   da_dst[c, d]    += dpre
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
// What bounds it on the H100: bytes, then atomics.  Per (edge, channel) it
// reads a (kz+1)-wide source band and a (kz+1)-wide stat band, does
// ~3 kz flops and n_ch * (kz+1) + n_ch f32 atomic adds; no tensor-core
// work exists.  The design follows the forward:
//   * row-major tables: row s of the table holds every channel's [z_c |
//     a_src_c], row d of gtab every channel's [g_c | gout_c], so an edge
//     visit reads contiguous rows (the TPU kernels' one-hot windows play
//     this role there);
//   * one warp per edge: per channel, lanes over the kz columns form
//     g * z and a shuffle reduction sums them; lanes 0..n_ch-1 then form
//     their channel's att and dpre, and every lane takes its band's values
//     by shuffle while the warp walks the row in 32-wide passes (stepping
//     its (channel, column) without a division, as the forward does);
//   * the src-side sums and da_dst are f32 atomics into accumulators that
//     the 50 MB L2 holds (the flagship's are ~4 MB and under 1 MB), where
//     the TPU kept VMEM-resident accumulators and walked edge chunks in
//     order;
//   * padding edges (dst >= num_rows) are skipped before any other load.
// A later PR can replace the atomics by a segmented reduction over a
// src-sorted edge order.

#include "gat_common.cuh"

namespace {

using gat::round_t;
using gat::to_f32;

template <typename T, bool RoundAttFirst>
__global__ void __launch_bounds__(256) gat_bwd_kernel(
    const T* __restrict__ table, const float* __restrict__ gtab,
    const float* __restrict__ logden, const float* __restrict__ adst,
    const int* __restrict__ src, const int* __restrict__ dst,
    float* __restrict__ dpk, float* __restrict__ dadst, long long num_edges,
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
    const long long s = src[e];
    const T* row = table + s * width;
    const float* grow = gtab + (long long)d * width;
    // datt_c = g_c . z_c: lanes over the columns, a shuffle reduction;
    // lane c keeps channel c's sum
    float datt_mine = 0.f;
    for (int c = 0; c < n_ch; ++c) {
      float part = 0.f;
      for (int f = lane; f < kz; f += 32) {
        float gz = __fmul_rn(grow[c * bz + f], to_f32(row[c * bz + f]));
        if (RoundAttFirst) gz = round_t<T>(gz);
        part = __fadd_rn(part, gz);
      }
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
      const float dpre_t = round_t<T>(dpre);
      atomicAdd(dadst + cd, RoundAttFirst ? dpre_t : dpre);
      att_mine = RoundAttFirst ? round_t<T>(att) : att;
      dpre_mine = dpre_t;
    }
    float* out = dpk + s * width;
    // warp-uniform trip count: every lane reaches the shuffles
    int c = c0, f = f0;
    for (int j = lane; j - lane < width; j += 32) {
      const int src_lane = min(c, n_ch - 1);
      const float att = __shfl_sync(0xffffffffu, att_mine, src_lane);
      const float dpre = __shfl_sync(0xffffffffu, dpre_mine, src_lane);
      if (j < width)
        atomicAdd(out + j, f < kz ? round_t<T>(__fmul_rn(grow[j], att)) : dpre);
      for (f += 32; f >= bz; f -= bz) ++c;
    }
  }
}

template <typename T, bool RoundAttFirst>
void launch(unsigned blocks, cudaStream_t s, const void* table, const void* gtab,
            const void* logden, const void* adst, const void* src, const void* dst,
            void* dpk, void* dadst, long long num_edges, int num_rows, int kz,
            int n_ch, float slope) {
  gat_bwd_kernel<T, RoundAttFirst><<<blocks, 256, 0, s>>>(
      static_cast<const T*>(table), static_cast<const float*>(gtab),
      static_cast<const float*>(logden), static_cast<const float*>(adst),
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<float*>(dpk), static_cast<float*>(dadst), num_edges, num_rows,
      kz, n_ch, slope);
}

}  // namespace

// Plain C entry for ctypes.  table: [n, n_ch*(kz+1)] T row-major (T = bf16
// when `bf16` else f32); gtab: f32[num_rows, n_ch*(kz+1)]; logden/adst:
// f32[n_ch, num_rows]; src/dst: int32[num_edges]; dpk: f32[n, n_ch*(kz+1)]
// and dadst: f32[n_ch, num_rows], both zeroed by the caller.
// `round_att_first` selects K4's rounding points over K2's.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int gat_bwd(int device, const void* table, int bf16, int round_att_first,
                       const void* gtab, const void* logden, const void* adst,
                       const void* src, const void* dst, void* dpk, void* dadst,
                       long long num_edges, int num_rows, int kz, int n_ch,
                       float slope, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_ch < 1 || n_ch > 8 || kz < 1) return (int)cudaErrorInvalidValue;
  if (num_edges > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned b = gat::warp_edge_blocks(num_edges);
    if (bf16 && round_att_first)
      launch<__nv_bfloat16, true>(b, s, table, gtab, logden, adst, src, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, slope);
    else if (bf16)
      launch<__nv_bfloat16, false>(b, s, table, gtab, logden, adst, src, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, slope);
    else if (round_att_first)
      launch<float, true>(b, s, table, gtab, logden, adst, src, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, slope);
    else
      launch<float, false>(b, s, table, gtab, logden, adst, src, dst, dpk, dadst, num_edges, num_rows, kz, n_ch, slope);
  }
  return (int)cudaGetLastError();
}
