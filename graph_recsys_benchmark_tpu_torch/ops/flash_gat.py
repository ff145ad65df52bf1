"""Flash-style GAT attention, single head (callers loop heads —
models/pea._fused_gat_step), forward and backward.

Port of the JAX package's ``ops/flash_gat.py``.  One pass computes

    out[i] = Σ_e softmax_dst(leaky_relu(a_dst[i] + a_src[j]))_e · z[j]

over a loop-materialized edge list with the BOUND-SHIFT softmax: the shift
for row i is m̂_i = leaky(a_dst_i + max_j a_src_j), an upper bound on every
logit of the row, so p = exp(act − m̂) ∈ (0, 1] needs no running max.  The
reference math is PyG 1.5 GATConv's scatter-softmax + scatter-add with the
+1e-16 denominator guard (models/peagat.py:14-21).

Kernels: csrc/gat_fwd.cu and csrc/gat_bwd.cu, shared with ops/batch_gat.
``gat_fwd`` launches the forward for n_ch <= 8 channels over one edge list
and returns the unnormalized accumulator; ``flash_gat_fwd`` is its
one-channel case at K1's rounding points, ``[Σ round_T(p·z) | Σ
round_T(p)]``, and replaces both TPU forms (K1 chunk-major, K12 dst-block in
bound-shift mode), which differ only in how the TPU grid walks the edges.
``gat_bwd`` launches the backward; ``flash_gat_bwd`` is its one-channel
case at K2's rounding points (the fused glue kernel, ``_flash_bwd``'s
choice at ops/flash_gat.py:1443-1450).  A CUDA tensor takes the kernel, a
CPU tensor the plain version in this module.

Autograd: ``FlashGAT`` (a ``torch.autograd.Function``) saves m̂, s and out
as ``_flash_fwd`` does and builds K2's stat table in its backward.  It takes
the table already in the transport dtype and returns the table's gradient
in that dtype, as the JAX VJP returns ``dpk.astype(packed_t.dtype)``: under
bf16 transport the gradient of z is rounded to bf16 there.

Layout: the kernels read a row-major ``[n, kz+1]`` table so that an edge's
source row is contiguous.  The model builds that table directly and calls
``flash_gat_attention_rows``; ``flash_gat_attention`` keeps the JAX
signature (``packed_t`` in ``pack_gat_table``'s column-major
``[k_pad, n_src_pad]`` layout) and makes one row-major copy.
"""

from __future__ import annotations

import torch

from . import _cuda
from .segment import segment_softmax, segment_sum

_BR = 128


def _cdiv(a, b):
    return -(-a // b)


def t_dtype_of(transport):
    if transport == "bf16":
        return torch.bfloat16
    if transport == "f32":
        return torch.float32
    raise ValueError(f"transport {transport!r}: expected 'f32' or 'bf16'")


def _layout(num_rows, kz):
    k = kz + 1
    k_pad = max(8, _cdiv(k, 8) * 8)
    n_src_pad = _cdiv(num_rows + 1, _BR) * _BR + _BR
    return k, k_pad, n_src_pad


def pack_gat_table(z_t, a_src, num_rows, t_dtype):
    """Build the column-major packed table ``[k_pad, n_src_pad]``.

    z_t: [kz, N] — feature-major z; a_src: [N] f32.
    Rows 0..kz-1 = z (cast to t_dtype), row kz = a_src, rest zero."""
    kz, n = z_t.shape
    _, k_pad, n_src_pad = _layout(num_rows, kz)
    table = torch.zeros((k_pad, n_src_pad), dtype=t_dtype, device=z_t.device)
    table[:kz, :n] = z_t
    table[kz, :n] = a_src
    return table


def bound_shift(a_dst, a_src_t, negative_slope, t_dtype):
    """(a_dst, m̂) rounded through the transport dtype, as the TPU kernels
    gather them: m̂ = round(leaky(round(a_dst) + max a_src)), with a_src_t
    already in t_dtype (flash_gat.py:696-708, 624-627)."""
    adst_r = a_dst.to(t_dtype).float()
    pre_b = adst_r + a_src_t.float().max(dim=-1, keepdim=True).values
    mhat = torch.where(pre_b > 0, pre_b, negative_slope * pre_b)
    return adst_r.contiguous(), mhat.to(t_dtype).float().contiguous()


def gat_fwd_plain(table, adst_r, mhat, src, dst, num_rows, kz, round_p_first,
                  negative_slope=0.2):
    """Plain PyTorch version of csrc/gat_fwd.cu, same inputs and rounding
    points: acc[num_rows, n_ch*(kz+1)] f32, band c = Σ_e [round_T(z_c·q_c) |
    round_T(p_c)] by dst, with q_c = round_T(p_c) if `round_p_first` (K3)
    else p_c (K1/K12)."""
    t_dtype = table.dtype
    n_ch = adst_r.shape[0]
    real = dst < num_rows
    s, d = src[real].long(), dst[real].long()
    rows = table[s].float().view(-1, n_ch, kz + 1)
    pre = adst_r[:, d].t() + rows[:, :, kz]
    act = torch.where(pre > 0, pre, negative_slope * pre)
    p = torch.exp(torch.clamp(act - mhat[:, d].t(), max=60.0))
    q = p.to(t_dtype).float() if round_p_first else p
    msg = torch.cat([(rows[:, :, :kz] * q[:, :, None]).to(t_dtype).float(),
                     p.to(t_dtype).float()[:, :, None]], dim=2)
    return segment_sum(msg.reshape(-1, n_ch * (kz + 1)), d, num_rows)


def _check_table(name, table, n_ch, kz):
    """(device, row width) of a kernel's input table, validated: a CUDA
    tensor, f32 or bf16, contiguous [n, n_ch*(kz+1)], 1 <= n_ch <= 8."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not (1 <= n_ch <= 8 and kz >= 1):
        raise ValueError(f"{name}: n_ch {n_ch} outside 1..8 or kz {kz} < 1")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"table: dtype {table.dtype}, expected f32 or bf16")
    width = n_ch * (kz + 1)
    if table.dim() != 2 or table.shape[1] != width or not table.is_contiguous():
        raise ValueError(f"table: need contiguous [n, {width}], got {tuple(table.shape)}")
    return dev, width


def gat_fwd(counter, table, adst_r, mhat, src, dst, num_rows, kz, round_p_first,
            negative_slope=0.2):
    """Unnormalized accumulator ``[num_rows, n_ch*(kz+1)]`` f32 (band column
    kz = s_c) for n_ch <= 8 channels over one edge list.

    table: [n, n_ch*(kz+1)] row-major bands ``[z_c | a_src_c]`` in the
    transport dtype (f32 or bf16), n > max real src; adst_r, mhat:
    f32[n_ch, num_rows]; src, dst: int32[E] with padding ``dst >=
    num_rows``.  CPU tensors take the plain version; CUDA tensors launch the
    kernel, counted in ``counter.launches`` (the calling wrapper), or
    raise."""
    if table.device.type == "cpu":
        return gat_fwd_plain(table, adst_r, mhat, src, dst, num_rows, kz,
                             round_p_first, negative_slope)
    n_ch = adst_r.shape[0]
    dev, width = _check_table("gat_fwd", table, n_ch, kz)
    e = dst.shape[0]
    _cuda.require(adst_r, "adst_r", torch.float32, (n_ch, num_rows), dev)
    _cuda.require(mhat, "mhat", torch.float32, (n_ch, num_rows), dev)
    _cuda.require(src, "src", torch.int32, (e,), dev)
    _cuda.require(dst, "dst", torch.int32, (e,), dev)
    acc = torch.zeros((num_rows, width), dtype=torch.float32, device=dev)
    if e == 0:
        return acc
    _cuda.launch(
        "gat_fwd", dev, table.data_ptr(), int(table.dtype == torch.bfloat16),
        int(round_p_first), adst_r.data_ptr(), mhat.data_ptr(), src.data_ptr(),
        dst.data_ptr(), acc.data_ptr(), e, num_rows, kz, n_ch, float(negative_slope),
    )
    counter.launches += 1
    return acc


def flash_gat_fwd_plain(table, adst_r, mhat, src, dst, num_rows, kz,
                        negative_slope=0.2):
    """Plain PyTorch version of flash_gat_fwd, same inputs and rounding
    points: acc[num_rows, kz+1] f32 = Σ_e [round_T(p·z_src) | round_T(p)]."""
    return gat_fwd_plain(table, adst_r[None], mhat[None], src, dst, num_rows, kz,
                         False, negative_slope)


def flash_gat_fwd(table, adst_r, mhat, src, dst, num_rows, kz,
                  negative_slope=0.2):
    """Unnormalized accumulator ``[num_rows, kz+1]`` f32 (column kz = s):
    gat_fwd for one channel at K1's rounding points.

    table: [n, kz+1] row-major ``[z | a_src]`` rows in the transport dtype;
    adst_r, mhat: f32[num_rows]; src, dst: int32[E] with padding ``dst >=
    num_rows``.  Launches counted in ``flash_gat_fwd.launches``."""
    return gat_fwd(flash_gat_fwd, table, adst_r[None], mhat[None], src, dst,
                   num_rows, kz, False, negative_slope)


flash_gat_fwd.launches = 0


def gat_bwd_plain(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                  round_att_first, negative_slope=0.2):
    """Plain PyTorch version of csrc/gat_bwd.cu, same inputs and rounding
    points: (dpk f32[n, n_ch*(kz+1)], da_dst f32[n_ch, num_rows]).  Per
    edge and channel, att = exp(min(act − logden, 60)), datt = Σ_k g·z,
    dpre = att·(datt − gout)·leaky′(pre); dpk's band c sums [round_T(g·a) |
    round_T(dpre)] by src and da_dst sums dpre by dst.  K4
    (`round_att_first`) rounds g·z before the sum, uses a = round_T(att)
    and sums round_T(dpre) into da_dst; K2 uses a = att and sums the
    unrounded g·z and dpre."""
    t_dtype = table.dtype
    n_ch = adst_r.shape[0]
    bz = kz + 1

    def rt(x):
        return x.to(t_dtype).float()

    real = dst < num_rows
    s, d = src[real].long(), dst[real].long()
    rows = table[s].float().view(-1, n_ch, bz)
    g = gtab[d].view(-1, n_ch, bz)
    pre = adst_r[:, d].t() + rows[:, :, kz]
    act = torch.where(pre > 0, pre, negative_slope * pre)
    att = torch.exp(torch.clamp(act - logden[:, d].t(), max=60.0))
    gz = g[:, :, :kz] * rows[:, :, :kz]
    datt = (rt(gz) if round_att_first else gz).sum(dim=2)
    dalpha = att * (datt - g[:, :, kz])
    dpre = torch.where(pre > 0, dalpha, dalpha * negative_slope)
    a = rt(att) if round_att_first else att
    ct = torch.cat([rt(g[:, :, :kz] * a[:, :, None]), rt(dpre)[:, :, None]], dim=2)
    dpk = torch.zeros((table.shape[0], n_ch * bz), dtype=torch.float32,
                      device=table.device)
    dpk.index_add_(0, s, ct.reshape(-1, n_ch * bz))
    da_dst = segment_sum(rt(dpre) if round_att_first else dpre, d, num_rows)
    return dpk, da_dst.t().contiguous()


def gat_bwd(counter, table, gtab, logden, adst_r, src, dst, num_rows, kz,
            round_att_first, negative_slope=0.2):
    """(dpk f32[n, n_ch*(kz+1)], da_dst f32[n_ch, num_rows]): the backward
    of gat_fwd for n_ch <= 8 channels over one edge list.

    table: the forward's [n, n_ch*(kz+1)] row-major bands ``[z_c |
    a_src_c]`` in the transport dtype; gtab: f32[num_rows, n_ch*(kz+1)]
    stat bands ``[round_T(g_c) | gout_c]``; logden = m̂ + log(s + 1e-16) and
    adst_r = round_T(a_dst): f32[n_ch, num_rows]; src, dst: int32[E] with
    padding ``dst >= num_rows``.  dpk's band c is ``[dz_c | da_src_c]``.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    counted in ``counter.launches`` (the calling wrapper), or raise."""
    if table.device.type == "cpu":
        return gat_bwd_plain(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                             round_att_first, negative_slope)
    n_ch = adst_r.shape[0]
    dev, width = _check_table("gat_bwd", table, n_ch, kz)
    e = dst.shape[0]
    _cuda.require(gtab, "gtab", torch.float32, (num_rows, width), dev)
    _cuda.require(logden, "logden", torch.float32, (n_ch, num_rows), dev)
    _cuda.require(adst_r, "adst_r", torch.float32, (n_ch, num_rows), dev)
    _cuda.require(src, "src", torch.int32, (e,), dev)
    _cuda.require(dst, "dst", torch.int32, (e,), dev)
    dpk = torch.zeros((table.shape[0], width), dtype=torch.float32, device=dev)
    da_dst = torch.zeros((n_ch, num_rows), dtype=torch.float32, device=dev)
    if e == 0:
        return dpk, da_dst
    _cuda.launch(
        "gat_bwd", dev, table.data_ptr(), int(table.dtype == torch.bfloat16),
        int(round_att_first), gtab.data_ptr(), logden.data_ptr(), adst_r.data_ptr(),
        src.data_ptr(), dst.data_ptr(), dpk.data_ptr(), da_dst.data_ptr(), e,
        num_rows, kz, n_ch, float(negative_slope),
    )
    counter.launches += 1
    return dpk, da_dst


def flash_gat_bwd_plain(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                        negative_slope=0.2):
    """Plain PyTorch version of flash_gat_bwd, same inputs and rounding
    points (K2's)."""
    dpk, da_dst = gat_bwd_plain(table, gtab, logden[None], adst_r[None], src, dst,
                                num_rows, kz, False, negative_slope)
    return dpk, da_dst[0]


def flash_gat_bwd(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                  negative_slope=0.2):
    """(dpk f32[n, kz+1], da_dst f32[num_rows]): gat_bwd for one channel at
    K2's rounding points.

    table: the forward's [n, kz+1] ``[z | a_src]`` rows in the transport
    dtype; gtab: f32[num_rows, kz+1] ``[round_T(g) | gout]``; logden,
    adst_r: f32[num_rows]; src, dst: int32[E] with padding ``dst >=
    num_rows``.  Launches counted in ``flash_gat_bwd.launches``."""
    dpk, da_dst = gat_bwd(flash_gat_bwd, table, gtab, logden[None], adst_r[None],
                          src, dst, num_rows, kz, False, negative_slope)
    return dpk, da_dst[0]


flash_gat_bwd.launches = 0


class FlashGAT(torch.autograd.Function):
    """flash_gat_fwd + normalization, differentiable in the table and a_dst.

    forward(table [n, kz+1] in the transport dtype, a_dst f32[num_rows],
    src, dst int32[E], num_rows, kz, negative_slope) -> out f32[num_rows,
    kz].  The backward builds K2's stat table as ``_flash_bwd`` does
    (ops/flash_gat.py:1423-1433): g rounded once through the transport,
    gout = Σ g·out from the unrounded g, logden = m̂ + log(s + 1e-16),
    a_dst rounded through the transport; it returns the table's gradient in
    the table's dtype and a_dst's in f32.  m̂ is a residual with no
    gradient.  A graph without edges gives exact zeros both ways."""

    @staticmethod
    def forward(ctx, table, a_dst, src, dst, num_rows, kz, negative_slope):
        adst_r, mhat = bound_shift(a_dst, table[:num_rows, kz], negative_slope,
                                   table.dtype)
        acc = flash_gat_fwd(table, adst_r, mhat, src, dst, num_rows, kz,
                            negative_slope)
        s = acc[:, kz]
        out = acc[:, :kz] / (s[:, None] + 1e-16)
        ctx.save_for_backward(table, adst_r, mhat, s, out, src, dst)
        ctx.consts = (num_rows, kz, negative_slope)
        return out

    @staticmethod
    def backward(ctx, g):
        table, adst_r, mhat, s, out, src, dst = ctx.saved_tensors
        num_rows, kz, negative_slope = ctx.consts
        g = g.float()
        gtab = torch.cat([g.to(table.dtype).float(), (g * out).sum(dim=1, keepdim=True)],
                         dim=1)
        logden = mhat + torch.log(s + 1e-16)
        dpk, da_dst = flash_gat_bwd(table, gtab, logden, adst_r, src, dst, num_rows,
                                    kz, negative_slope)
        return dpk.to(table.dtype), da_dst, None, None, None, None, None


def flash_gat_attention_rows(table, a_dst, src, dst, num_rows, kz,
                             negative_slope=0.2, transport="f32"):
    """out[i] = Σ_e softmax_dst(leaky_relu(a_dst[i] + a_src[j]))_e · z[j]
    for single-head GAT, from the row-major table the kernel reads.

    table: [n, kz+1] ``[z | a_src]`` rows (n >= num_rows, n > max real src);
    a_dst: [num_rows] f32; src/dst: int32[E] with padding sentinel
    ``dst == num_rows``.  Returns [num_rows, kz] f32, differentiable in
    table and a_dst (FlashGAT).  The cast to the transport dtype stays
    outside the Function, so the table's gradient is rounded to it as the
    JAX VJP's is."""
    table = table.to(t_dtype_of(transport)).contiguous()
    return FlashGAT.apply(
        table, a_dst.float().contiguous(), src.to(torch.int32).contiguous(),
        dst.to(torch.int32).contiguous(), num_rows, kz, negative_slope,
    )


def flash_gat_attention(packed_t, a_dst, src, dst, src_perm, src_sorted,
                        num_rows, kz, negative_slope=0.2, transport="f32"):
    """flash_gat_attention_rows with the JAX signature.

    packed_t: [k_pad, n_src_pad] column-major ``[z | a_src]`` table
    (pack_gat_table), copied once to the row-major [n_src_pad, kz+1];
    src_perm/src_sorted: the StepGraph's src-sorted permutation, kept for
    the JAX signature (only the JAX package's composed backward reads
    it)."""
    _, k_pad, n_src_pad = _layout(num_rows, kz)
    if tuple(packed_t.shape) != (k_pad, n_src_pad):
        raise ValueError(
            f"packed_t: shape {tuple(packed_t.shape)}, expected {(k_pad, n_src_pad)}"
        )
    return flash_gat_attention_rows(packed_t[: kz + 1].t(), a_dst, src, dst,
                                    num_rows, kz, negative_slope, transport)


def flash_gat_reference(packed_t, a_dst, src, dst, num_rows, kz,
                        negative_slope=0.2):
    """Plain oracle with the exact-max softmax (JAX flash_gat_reference)."""
    z = packed_t[:kz, :num_rows].t().float()
    a_src = packed_t[kz, :num_rows].float()
    safe_src = torch.clamp(src, max=num_rows - 1).long()
    safe_dst = torch.clamp(dst, max=num_rows - 1).long()
    real = dst < num_rows
    pre = torch.where(real, a_dst[safe_dst] + a_src[safe_src],
                      torch.full_like(a_src[safe_src], float("-inf")))
    act = torch.where(pre > 0, pre, negative_slope * pre)
    att = segment_softmax(act, dst, num_rows)
    att = torch.where(real, att, torch.zeros_like(att))
    msgs = att[:, None] * torch.where(real[:, None], z[safe_src], torch.zeros_like(z[safe_src]))
    return segment_sum(msgs, dst, num_rows)
