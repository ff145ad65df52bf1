"""Batched flash-GAT for channel groups sharing ONE edge list, forward and
backward.

Port of the JAX package's ``ops/batch_gat.py``.  The reference's metapath
table reuses one edge list across several channels (ML-small: 7 of the 9
second steps ride the item->user graph), so each shared edge list is
processed once for up to 8 channels.  Per channel the semantics are exactly
``ops/flash_gat.flash_gat_attention`` (bound-shift softmax, +1e-16 guard)
over a loop-materialized edge list.

Kernels: ``batch_gat_fwd`` launches csrc/gat_fwd.cu (ops/flash_gat.gat_fwd)
at K3's rounding points and replaces the TPU kernel K3
(ops/batch_gat.py:_make_fwd_kernel), walking the graph's stable sort by dst
(``dst_perm`` / ``dst_sorted``); ``batch_gat_bwd`` launches
csrc/gat_bwd.cu (ops/flash_gat.gat_bwd) at K4's rounding points and
replaces K4 (ops/batch_gat.py:_make_bwd_kernel), walking the graph's
stable sort by source (``src_perm`` / ``src_sorted``).  Their input is the
row-major table ``[num_rows, n_ch*(kz+1)]`` whose row j holds every
channel's band ``[z_c[j] | a_src_c[j]]``, so one edge visit reads all
channels' sources at once.  CPU tensors take the plain versions in this
module.  ``BatchGAT`` (a ``torch.autograd.Function``) packs the table
inside itself, so z's gradient comes back in f32 unrounded, as the JAX
VJP's ``dz.astype(z.dtype)`` does.
"""

from __future__ import annotations

import torch

from .cost import batch_bwd_cost, batch_fwd_cost, declares
from .flash_gat import (
    bound_shift,
    dst_walk,
    gat_bwd,
    gat_bwd_plain,
    gat_fwd,
    gat_fwd_plain,
    src_walk,
    t_dtype_of,
)
from .segment import segment_softmax, segment_sum

# Kernel layout limits, as the JAX package's batched kernels: at most 8
# channels per pass (one warp lane forms each channel's p) and kz <= 125.
MAX_CHANNELS = 8
MAX_KZ = 125


def _layout(kz, n_ch):
    """(band stride, row width) of the packed table: [z (kz) | a_src]."""
    bz = kz + 1
    return bz, n_ch * bz


def _pack_tables(z, a_src, a_dst, num_rows, kz, n_ch, negative_slope, t_dtype):
    """table [num_rows, n_ch*(kz+1)] t_dtype (bands [z_c | a_src_c]),
    plus a_dst and m̂ [n_ch, num_rows] f32, both pre-rounded through the
    transport dtype as K3 gathers them (batch_gat.py:403-428)."""
    band = torch.cat([z.to(t_dtype), a_src[:, :, None].to(t_dtype)], dim=2)
    table = band.permute(1, 0, 2).reshape(num_rows, n_ch * (kz + 1)).contiguous()
    adst_r, mhat = bound_shift(a_dst, band[:, :, kz], negative_slope, t_dtype)
    return table, adst_r, mhat


def batch_gat_fwd_plain(table, adst_r, mhat, src, dst, num_rows, kz,
                        negative_slope=0.2, dst_perm=None, dst_sorted=None):
    """Plain PyTorch version of batch_gat_fwd, same inputs and rounding
    points: acc[num_rows, n_ch*(kz+1)] f32, band c = Σ_e [round_T(z_c·p_c) |
    p_c] with p_c rounded through the transport dtype first; the walk is
    accepted and not read (flash_gat.flash_gat_fwd_plain)."""
    return gat_fwd_plain(table, adst_r, mhat, src, dst, num_rows, kz, True,
                         negative_slope)


@declares("batch_gat_fwd", lambda table, adst_r, mhat, src, dst, num_rows, kz, *a, **k:
          batch_fwd_cost(dst.shape[0], kz, adst_r.shape[0], num_rows, table.shape[0],
                         table.element_size()))
def batch_gat_fwd(table, adst_r, mhat, src, dst, num_rows, kz,
                  negative_slope=0.2, dst_perm=None, dst_sorted=None):
    """Unnormalized accumulator ``[num_rows, n_ch*(kz+1)]`` f32 (band column
    kz = s_c): ops/flash_gat.gat_fwd at K3's rounding points.

    table: [n, n_ch*(kz+1)] row-major bands in the transport dtype; adst_r,
    mhat: f32[n_ch, num_rows]; src, dst: int32[E] with padding ``dst >=
    num_rows``; dst_perm, dst_sorted: the walk by dst (flash_gat.gat_fwd;
    required on a CUDA tensor).  Launches counted in
    ``batch_gat_fwd.launches``."""
    n_ch = adst_r.shape[0]
    if not (1 <= n_ch <= MAX_CHANNELS and 1 <= kz <= MAX_KZ):
        raise ValueError(f"batch_gat_fwd: n_ch {n_ch} / kz {kz} outside 1..8 / 1..125")
    return gat_fwd(batch_gat_fwd, table, adst_r, mhat, src, dst, num_rows, kz,
                   True, negative_slope, dst_perm, dst_sorted)


batch_gat_fwd.launches = 0


def batch_gat_bwd_plain(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                        negative_slope=0.2, src_perm=None, src_sorted=None):
    """Plain PyTorch version of batch_gat_bwd, same inputs and rounding
    points (K4's: g·z rounded before the sum, att and dpre rounded); the
    walk is accepted and not read (flash_gat.gat_bwd_plain)."""
    return gat_bwd_plain(table, gtab, logden, adst_r, src, dst, num_rows, kz, True,
                         negative_slope)


@declares("batch_gat_bwd", lambda table, gtab, logden, adst_r, src, dst, num_rows, kz, *a,
          **k: batch_bwd_cost(dst.shape[0], kz, adst_r.shape[0], num_rows, table.shape[0],
                              table.element_size()))
def batch_gat_bwd(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                  negative_slope=0.2, src_perm=None, src_sorted=None):
    """(dpk f32[n, n_ch*(kz+1)], da_dst f32[n_ch, num_rows]):
    ops/flash_gat.gat_bwd at K4's rounding points.

    table: the forward's bands in the transport dtype; gtab:
    f32[num_rows, n_ch*(kz+1)] bands ``[round_T(g_c) | gout_c]``; logden,
    adst_r: f32[n_ch, num_rows]; src, dst: int32[E] with padding ``dst >=
    num_rows``; src_perm, src_sorted: the walk (flash_gat.gat_bwd; required
    on a CUDA tensor).  Launches counted in ``batch_gat_bwd.launches``."""
    n_ch = adst_r.shape[0]
    if not (1 <= n_ch <= MAX_CHANNELS and 1 <= kz <= MAX_KZ):
        raise ValueError(f"batch_gat_bwd: n_ch {n_ch} / kz {kz} outside 1..8 / 1..125")
    return gat_bwd(batch_gat_bwd, table, gtab, logden, adst_r, src, dst, num_rows, kz,
                   True, negative_slope, src_perm, src_sorted)


batch_gat_bwd.launches = 0


class BatchGAT(torch.autograd.Function):
    """batch_gat_fwd + normalization, differentiable in z, a_src and a_dst.

    forward(z f32[n_ch, N, kz], a_src, a_dst f32[n_ch, N], src, dst,
    src_perm, src_sorted int32[E] (the walk of the backward), dst_perm,
    dst_sorted int32[E] (the forward's), num_rows, negative_slope,
    transport) -> out f32[n_ch, N, kz].
    The backward builds the stat bands as ``_batch_bwd`` does
    (ops/batch_gat.py:532-552) and returns dz, da_src, da_dst in f32
    (:608-612).  A graph without edges gives exact zeros both ways."""

    @staticmethod
    def forward(ctx, z, a_src, a_dst, src, dst, src_perm, src_sorted, dst_perm, dst_sorted,
                num_rows, negative_slope, transport):
        n_ch, _, kz = z.shape
        table, adst_r, mhat = _pack_tables(z, a_src, a_dst, num_rows, kz, n_ch,
                                           negative_slope, t_dtype_of(transport))
        acc = batch_gat_fwd(table, adst_r, mhat, src, dst, num_rows, kz,
                            negative_slope, dst_perm=dst_perm, dst_sorted=dst_sorted)
        acc_b = acc.view(num_rows, n_ch, kz + 1)
        s = acc_b[:, :, kz].t()  # [n_ch, N]
        out = acc_b[:, :, :kz].permute(1, 0, 2) / (s[:, :, None] + 1e-16)
        ctx.save_for_backward(table, adst_r, mhat, s, out, src, dst, src_perm, src_sorted)
        ctx.consts = (num_rows, kz, negative_slope)
        return out

    @staticmethod
    def backward(ctx, g):
        table, adst_r, mhat, s, out, src, dst, src_perm, src_sorted = ctx.saved_tensors
        num_rows, kz, negative_slope = ctx.consts
        n_ch = adst_r.shape[0]
        g = g.float()
        gout = (g * out).sum(dim=2)  # [n_ch, N]
        gband = torch.cat([g.to(table.dtype).float(), gout[:, :, None]], dim=2)
        gtab = gband.permute(1, 0, 2).reshape(num_rows, n_ch * (kz + 1)).contiguous()
        logden = (mhat + torch.log(s + 1e-16)).contiguous()
        dpk, da_dst = batch_gat_bwd(table, gtab, logden, adst_r, src, dst, num_rows,
                                    kz, negative_slope, src_perm=src_perm,
                                    src_sorted=src_sorted)
        dpk_b = dpk.unflatten(1, (n_ch, kz + 1))[:num_rows]
        dz = dpk_b[:, :, :kz].permute(1, 0, 2)
        da_src = dpk_b[:, :, kz].t()
        return dz, da_src, da_dst, None, None, None, None, None, None, None, None, None


def batch_gat_attention(z, a_src, a_dst, src, dst, num_rows,
                        negative_slope=0.2, transport="f32", src_perm=None,
                        src_sorted=None, dst_perm=None, dst_sorted=None):
    """Single-head GAT attention for n_ch channels sharing ONE
    loop-materialized edge list (padding sentinel ``dst == num_rows``).

    z: [n_ch, num_rows, kz]; a_src/a_dst: [n_ch, num_rows] f32; src_perm,
    src_sorted: the StepGraph's walk by source, read by the backward (None =
    flash_gat.src_walk of `src`, a sort, for callers without a StepGraph);
    dst_perm, dst_sorted: its walk by dst, read by the forward (None =
    flash_gat.dst_walk of `dst`).  Returns [n_ch, num_rows, kz] f32,
    differentiable in z, a_src and a_dst (BatchGAT)."""
    src = src.to(torch.int32).contiguous()
    dst = dst.to(torch.int32).contiguous()
    src_perm, src_sorted = src_walk(src, src_perm, src_sorted)
    dst_perm, dst_sorted = dst_walk(dst, dst_perm, dst_sorted)
    return BatchGAT.apply(
        z, a_src, a_dst, src, dst, src_perm, src_sorted, dst_perm, dst_sorted,
        num_rows, negative_slope, transport,
    )


def batch_gat_reference(z, a_src, a_dst, src, dst, num_rows,
                        negative_slope=0.2):
    """Plain oracle: per-channel exact-max softmax over the shared edge list
    (JAX batch_gat_reference)."""
    real = dst < num_rows
    safe_src = torch.clamp(src, max=num_rows - 1).long()
    safe_dst = torch.clamp(dst, max=num_rows - 1).long()
    outs = []
    for z_c, a_src_c, a_dst_c in zip(z, a_src, a_dst):
        pre = a_dst_c[safe_dst] + a_src_c[safe_src]
        pre = torch.where(real, pre, torch.full_like(pre, float("-inf")))
        act = torch.where(pre > 0, pre, negative_slope * pre)
        att = segment_softmax(act, dst, num_rows)
        att = torch.where(real, att, torch.zeros_like(att))
        zs = z_c[safe_src]
        msgs = att[:, None] * torch.where(real[:, None], zs, torch.zeros_like(zs))
        outs.append(segment_sum(msgs, dst, num_rows))
    return torch.stack(outs)
