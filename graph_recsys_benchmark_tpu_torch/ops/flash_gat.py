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
The forward walks the graph's stable sort by dst (``dst_perm`` /
``dst_sorted``, StepGraph's; the callers without a StepGraph build it with
``dst_walk``), summing each dst row's run before it writes.  ``gat_bwd``
launches the backward; ``flash_gat_bwd`` is its one-channel case at K2's
rounding points (the fused glue kernel, ``_flash_bwd``'s choice at
ops/flash_gat.py:1443-1450).  The backward walks the graph's stable sort by
source (``src_perm`` / ``src_sorted``; ``src_walk``), summing each
source's run before it writes.  A CUDA tensor takes the kernel, a CPU
tensor the plain version in this module.

The variant routes, picked by ``ops/config.FlashGATMode`` (the JAX
package's FLASH_SOFTMAX_SHIFT, FLASH_BWD_GLUE and FLASH_BWD_MEGA):
  * ``softmax_shift='online'`` (K12-online): ``online_shift`` takes the
    exact row max m with ``gat_rowmax`` (csrc/gat_fwd.cu), then
    ``flash_gat_fwd_online`` runs the forward's walk with m as the shift;
    both walk the graph's sort by dst;
  * ``bwd='glue'`` (K13): ``flash_gat_bwd_glue`` (csrc/gat_bwd.cu's
    ``gat_bwd_glue_walk_kernel``, on the graph's walk by dst) stores each
    edge's cotangent row and sums da_dst, then
    ``segment_kernels.localized_scatter_add`` (K6) scatters the rows by src;
  * ``bwd='onepass'`` (K14): ``flash_gat_bwd_onepass`` (csrc/gat_bwd.cu's
    StatRow mode) runs the backward's walk by source on one stat table
    ``[g | gout | logden | a_dst]`` with g unrounded.

Autograd: ``FlashGAT`` (a ``torch.autograd.Function``) saves the shift (m̂
or m), s and out as ``_flash_fwd`` does and builds the route's stat table
in its backward.  It takes the table already in the transport dtype and
returns the table's gradient in that dtype, as the JAX VJP returns
``dpk.astype(packed_t.dtype)``: under bf16 transport the gradient of z is
rounded to bf16 there.

Layout: the kernels read a row-major ``[n, kz+1]`` table so that an edge's
source row is contiguous.  The model builds that table directly and calls
``flash_gat_attention_rows``; ``flash_gat_attention`` keeps the JAX
signature (``packed_t`` in ``pack_gat_table``'s column-major
``[k_pad, n_src_pad]`` layout) and makes one row-major copy.
"""

from __future__ import annotations

import torch

from . import _cuda, cost
from .config import FlashGATMode
from .cost import declares
from .segment import segment_max, segment_softmax, segment_sum

_BR = 128


def _cdiv(a, b):
    return -(-a // b)


def t_dtype_of(transport):
    if transport == "bf16":
        return torch.bfloat16
    if transport == "f32":
        return torch.float32
    raise ValueError(f"transport {transport!r}: expected 'f32' or 'bf16'")


def msg_cast(*arrays, transport):
    """Message operands in the transport dtype (the JAX package's
    ``ops/config.msg_cast`` with the transport passed explicitly): bf16
    rounds each once, f32 leaves them as they are."""
    if transport == "bf16":
        arrays = tuple(a.to(torch.bfloat16) for a in arrays)
    else:
        t_dtype_of(transport)  # validate
    return arrays if len(arrays) != 1 else arrays[0]


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
                  negative_slope=0.2, acc_dtype=torch.float32):
    """Plain PyTorch version of csrc/gat_fwd.cu, same inputs and rounding
    points: acc[num_rows, n_ch*(kz+1)] f32, band c = Σ_e [round_T(z_c·q_c) |
    round_T(p_c)] by dst, with q_c = round_T(p_c) if `round_p_first` (K3)
    else p_c (K1/K12).  `acc_dtype` float64 gives the exact sums of the
    same terms (the card check's reference for atomic sums)."""
    real = dst < num_rows
    s, d = src[real].long(), dst[real].long()
    msg = _fwd_edge_terms(table, adst_r, mhat, s, d, kz, round_p_first, negative_slope)
    return segment_sum(msg.to(acc_dtype), d, num_rows)


def _fwd_edge_terms(table, adst_r, mhat, s, d, kz, round_p_first, negative_slope):
    """gat_fwd_plain's per-edge terms for the real edges (s, d) (int64):
    f32[e, n_ch*(kz+1)], band c = [round_T(z_c·q_c) | round_T(p_c)],
    transport-dtype values."""
    t_dtype = table.dtype
    n_ch = adst_r.shape[0]
    rows = table[s].float().view(-1, n_ch, kz + 1)
    pre = adst_r[:, d].t() + rows[:, :, kz]
    act = torch.where(pre > 0, pre, negative_slope * pre)
    p = torch.exp(torch.clamp(act - mhat[:, d].t(), max=60.0))
    q = p.to(t_dtype).float() if round_p_first else p
    msg = torch.cat([(rows[:, :, :kz] * q[:, :, None]).to(t_dtype).float(),
                     p.to(t_dtype).float()[:, :, None]], dim=2)
    return msg.reshape(-1, n_ch * (kz + 1))


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
            negative_slope=0.2, dst_perm=None, dst_sorted=None):
    """Unnormalized accumulator ``[num_rows, n_ch*(kz+1)]`` f32 (band column
    kz = s_c) for n_ch <= 8 channels over one edge list.

    table: [n, n_ch*(kz+1)] row-major bands ``[z_c | a_src_c]`` in the
    transport dtype (f32 or bf16), n > max real src; adst_r, mhat:
    f32[n_ch, num_rows]; src, dst: int32[E] with padding ``dst >=
    num_rows``; dst_perm, dst_sorted: int32[E], the stable sort of dst and
    dst[dst_perm] (required on a CUDA tensor, check_dst_walk), the kernel's
    walk: it sums each dst row's run of edges before one write.  On the card
    the result is a view of a zeroed buffer whose rows are padded to a
    multiple of 4 columns.  K1's rounding points take one channel and any
    kz, K3's kz <= 128.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, counted in ``counter.launches`` (the calling
    wrapper), or raise."""
    if table.device.type == "cpu":
        return gat_fwd_plain(table, adst_r, mhat, src, dst, num_rows, kz,
                             round_p_first, negative_slope)
    n_ch = adst_r.shape[0]
    dev, width = _check_table("gat_fwd", table, n_ch, kz)
    if kz > 128 if round_p_first else n_ch != 1:
        raise ValueError(f"gat_fwd: kz {kz} / n_ch {n_ch} outside the kernel's layouts "
                         "(K1/K12: one channel; K3: kz <= 128)")
    e = dst.shape[0]
    _cuda.require(adst_r, "adst_r", torch.float32, (n_ch, num_rows), dev)
    _cuda.require(mhat, "mhat", torch.float32, (n_ch, num_rows), dev)
    _cuda.require(src, "src", torch.int32, (e,), dev)
    _cuda.require(dst, "dst", torch.int32, (e,), dev)
    check_dst_walk(dst, dst_perm, dst_sorted)
    stride = -(-width // 4) * 4  # 16-byte rows for the kernel's vector atomics
    acc = torch.zeros((num_rows, stride), dtype=torch.float32, device=dev)
    if e > 0:
        _cuda.launch(
            "gat_fwd", dev, table.data_ptr(), int(table.dtype == torch.bfloat16),
            int(round_p_first), adst_r.data_ptr(), mhat.data_ptr(), dst_perm.data_ptr(),
            dst_sorted.data_ptr(), src.data_ptr(), acc.data_ptr(), e, num_rows, kz, n_ch,
            stride, float(negative_slope),
        )
        counter.launches += 1
    return acc[:, :width]


def flash_gat_fwd_plain(table, adst_r, mhat, src, dst, num_rows, kz,
                        negative_slope=0.2, dst_perm=None, dst_sorted=None):
    """Plain PyTorch version of flash_gat_fwd, same inputs and rounding
    points: acc[num_rows, kz+1] f32 = Σ_e [round_T(p·z_src) | round_T(p)].
    The walk (`dst_perm`, `dst_sorted`) is accepted and not read: every
    real edge is summed by its own dst, so a walk that drops or repeats
    edges shows as a mismatch with the kernel."""
    return gat_fwd_plain(table, adst_r[None], mhat[None], src, dst, num_rows, kz,
                         False, negative_slope)


@declares("flash_gat_fwd", lambda table, adst_r, mhat, src, dst, num_rows, kz, *a, **k:
          cost.flash_fwd_cost(dst.shape[0], kz, num_rows, table.shape[0], table.element_size()))
def flash_gat_fwd(table, adst_r, mhat, src, dst, num_rows, kz,
                  negative_slope=0.2, dst_perm=None, dst_sorted=None):
    """Unnormalized accumulator ``[num_rows, kz+1]`` f32 (column kz = s):
    gat_fwd for one channel at K1's rounding points.

    table: [n, kz+1] row-major ``[z | a_src]`` rows in the transport dtype;
    adst_r, mhat: f32[num_rows]; src, dst: int32[E] with padding ``dst >=
    num_rows``; dst_perm, dst_sorted: the walk by dst (gat_fwd; required on
    a CUDA tensor).  Launches counted in ``flash_gat_fwd.launches``."""
    return gat_fwd(flash_gat_fwd, table, adst_r[None], mhat[None], src, dst,
                   num_rows, kz, False, negative_slope, dst_perm, dst_sorted)


flash_gat_fwd.launches = 0


def gat_rowmax_plain(table, adst_r, src, dst, num_rows, kz, negative_slope=0.2,
                     dst_perm=None, dst_sorted=None):
    """Plain PyTorch version of gat_rowmax: m[d] = round_T(max_e leaky(adst_r[d]
    + a_src[src_e])) over the real edges of row d, 0 for a row without one.
    The walk is accepted and not read (flash_gat_fwd_plain)."""
    real = dst < num_rows
    s, d = src[real].long(), dst[real].long()
    pre = adst_r[d] + table[s, kz].float()
    act = torch.where(pre > 0, pre, negative_slope * pre)
    m = segment_max(act, d, num_rows)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m.to(table.dtype).float()


@declares("gat_rowmax", lambda table, adst_r, src, dst, num_rows, kz, *a, **k:
          cost.rowmax_cost(dst.shape[0], num_rows, table.shape[0], table.element_size()))
def gat_rowmax(table, adst_r, src, dst, num_rows, kz, negative_slope=0.2,
               dst_perm=None, dst_sorted=None):
    """K12-online's shift f32[num_rows]: the exact row max of the logits,
    rounded to the transport dtype, 0 for a row without an edge (the JAX
    online kernel's m, flash_gat.py:442-446, 474).

    table: [n, kz+1] row-major ``[z | a_src]`` rows in the transport dtype;
    adst_r: f32[num_rows] = round_T(a_dst); src, dst: int32[E] with padding
    ``dst >= num_rows``; dst_perm, dst_sorted: the walk by dst (gat_fwd;
    required on a CUDA tensor): the kernel takes one atomic a run of it.
    CPU tensors take the plain version; CUDA tensors launch
    csrc/gat_fwd.cu's row max (the walk, then a decode), counted once in
    ``gat_rowmax.launches``, or raise."""
    if table.device.type == "cpu":
        return gat_rowmax_plain(table, adst_r, src, dst, num_rows, kz, negative_slope)
    dev, _ = _check_table("gat_rowmax", table, 1, kz)
    e = dst.shape[0]
    _cuda.require(adst_r, "adst_r", torch.float32, (num_rows,), dev)
    _cuda.require(src, "src", torch.int32, (e,), dev)
    _cuda.require(dst, "dst", torch.int32, (e,), dev)
    check_dst_walk(dst, dst_perm, dst_sorted)
    m = torch.zeros(num_rows, dtype=torch.float32, device=dev)  # the kernel's empty keys
    if e == 0:
        return m
    _cuda.launch(
        "gat_rowmax", dev, table.data_ptr(), int(table.dtype == torch.bfloat16),
        adst_r.data_ptr(), dst_perm.data_ptr(), dst_sorted.data_ptr(), src.data_ptr(),
        m.data_ptr(), e, num_rows, kz, float(negative_slope),
    )
    gat_rowmax.launches += 1
    return m


gat_rowmax.launches = 0


def online_shift(table, a_dst, src, dst, num_rows, kz, negative_slope=0.2,
                 dst_perm=None, dst_sorted=None):
    """(a_dst, m) rounded through the transport dtype, as the online kernel
    gathers them: m = gat_rowmax (the exact row max, rounded; 0 for an
    empty row) on the walk by dst.  The counterpart of bound_shift for
    ``FlashGATMode(softmax_shift='online')``."""
    adst_r = a_dst.to(table.dtype).float().contiguous()
    return adst_r, gat_rowmax(table, adst_r, src, dst, num_rows, kz, negative_slope,
                              dst_perm=dst_perm, dst_sorted=dst_sorted)


@declares("flash_gat_fwd_online", lambda table, adst_r, m, src, dst, num_rows, kz, *a, **k:
          cost.flash_fwd_online_cost(dst.shape[0], kz, num_rows, table.element_size()))
def flash_gat_fwd_online(table, adst_r, m, src, dst, num_rows, kz, negative_slope=0.2,
                         dst_perm=None, dst_sorted=None):
    """K12-online's walk: flash_gat_fwd with the row max m as the shift, the
    same kernel (gat_fwd) on the walk by dst (required on a CUDA tensor),
    counted in ``flash_gat_fwd_online.launches``.  Its plain version is
    flash_gat_fwd_plain."""
    return gat_fwd(flash_gat_fwd_online, table, adst_r[None], m[None], src, dst, num_rows,
                   kz, False, negative_slope, dst_perm, dst_sorted)


flash_gat_fwd_online.launches = 0


def gat_bwd_plain(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                  round_att_first, negative_slope=0.2, src_perm=None, src_sorted=None):
    """Plain PyTorch version of csrc/gat_bwd.cu, same inputs and rounding
    points: (dpk f32[n, n_ch*(kz+1)], da_dst f32[n_ch, num_rows]).  Per
    edge and channel, att = exp(min(act − logden, 60)), datt = Σ_k g·z,
    dpre = att·(datt − gout)·leaky′(pre); dpk's band c sums [round_T(g·a) |
    round_T(dpre)] by src and da_dst sums dpre by dst.  K4
    (`round_att_first`) rounds g·z before the sum, uses a = round_T(att)
    and sums round_T(dpre) into da_dst; K2 uses a = att and sums the
    unrounded g·z and dpre.  The walk (`src_perm`, `src_sorted`) is
    accepted and not read: every real edge is summed by its own src, so a
    walk that drops or repeats edges shows as a mismatch with the kernel."""
    real = dst < num_rows
    s, d = src[real].long(), dst[real].long()
    ct, dpre = _bwd_edge_terms(table, gtab, logden, adst_r, s, d, kz, round_att_first,
                               negative_slope)
    dpk = torch.zeros((table.shape[0], ct.shape[1]), dtype=torch.float32,
                      device=table.device)
    dpk.index_add_(0, s, ct)
    if round_att_first:
        dpre = dpre.to(table.dtype).float()
    return dpk, segment_sum(dpre, d, num_rows).t().contiguous()


def _bwd_edge_terms(table, gtab, logden, adst_r, s, d, kz, round_att_first,
                    negative_slope):
    """gat_bwd_plain's per-edge terms for the real edges (s, d) (int64):
    (ct f32[e, n_ch*(kz+1)], the cotangent rows [round_T(g·a) |
    round_T(dpre)] holding transport-dtype values; dpre f32[e, n_ch],
    unrounded)."""
    t_dtype = table.dtype
    n_ch = adst_r.shape[0]
    bz = kz + 1

    def rt(x):
        return x.to(t_dtype).float()

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
    return ct.reshape(-1, n_ch * bz), dpre


def _sorted_walk(ids, perm, srt, side):
    """(perm, ids[perm]) int32[E] on ids' device: the walk given, or the
    stable sort of `ids` where neither half is given."""
    if perm is None and srt is None:
        perm = torch.argsort(ids, stable=True)
        return perm.to(torch.int32), ids[perm].to(torch.int32)
    if perm is None or srt is None:
        raise ValueError(f"{side}_perm and {side}_sorted: pass both or neither")
    return tuple(torch.as_tensor(w, device=ids.device).to(torch.int32).contiguous()
                 for w in (perm, srt))


def src_walk(src, src_perm=None, src_sorted=None):
    """(src_perm, src_sorted) int32[E] on src's device: the walk given (a
    StepGraph's), or where none is given the stable sort of `src` and
    src[perm] (graph.py builds the same for every StepGraph), for callers
    with bare edges."""
    return _sorted_walk(src, src_perm, src_sorted, "src")


def dst_walk(dst, dst_perm=None, dst_sorted=None):
    """(dst_perm, dst_sorted) int32[E] on dst's device, the forward's walk:
    the one given (a StepGraph's), or where none is given the stable sort
    of `dst` and dst[perm] (StepGraph.dst_perm / dst_sorted; the padding
    sorts last), for callers with bare edges."""
    return _sorted_walk(dst, dst_perm, dst_sorted, "dst")


def _check_walk(kernel, ids, perm, srt, side):
    if perm is None or srt is None:
        raise ValueError(f"{kernel}: a CUDA call needs the walk ({side}_perm, {side}_sorted: "
                         f"StepGraph's, or {side}_walk({side}))")
    shape = (ids.shape[0],)
    _cuda.require(perm, f"{side}_perm", torch.int32, shape, ids.device)
    _cuda.require(srt, f"{side}_sorted", torch.int32, shape, ids.device)


def check_walk(src, src_perm, src_sorted):
    """The backward kernel's walk validated against `src`: both given, each
    an int32 [E] contiguous tensor on src's device.  The values are not
    read (that would synchronise): src_sorted must be src[src_perm]."""
    _check_walk("gat_bwd", src, src_perm, src_sorted, "src")


def check_dst_walk(dst, dst_perm, dst_sorted, kernel="gat_fwd"):
    """The walk by dst of the forward kernel (or of `kernel`, K13's
    gat_bwd_glue) validated against `dst`, as check_walk validates the
    backward's: both given, each an int32 [E] contiguous tensor on dst's
    device; dst_sorted must be dst[dst_perm] (not read)."""
    _check_walk(kernel, dst, dst_perm, dst_sorted, "dst")


def gat_bwd(counter, table, gtab, logden, adst_r, src, dst, num_rows, kz,
            round_att_first, negative_slope=0.2, src_perm=None, src_sorted=None):
    """(dpk f32[n, n_ch*(kz+1)], da_dst f32[n_ch, num_rows]): the backward
    of gat_fwd for n_ch <= 8 channels over one edge list.

    table: the forward's [n, n_ch*(kz+1)] row-major bands ``[z_c |
    a_src_c]`` in the transport dtype; gtab: f32[num_rows, n_ch*(kz+1)]
    stat bands ``[round_T(g_c) | gout_c]``; logden = m̂ + log(s + 1e-16) and
    adst_r = round_T(a_dst): f32[n_ch, num_rows]; src, dst: int32[E] with
    padding ``dst >= num_rows``; src_perm, src_sorted: int32[E], the stable
    sort of src and src[src_perm] (required on a CUDA tensor, check_walk).
    dpk's band c is ``[dz_c | da_src_c]``; on the card it is a view of a
    zeroed buffer whose rows are padded to a multiple of 4 columns.  K2's
    rounding points take one channel and any kz, K4's kz <= 128.  CPU
    tensors take the plain version; CUDA tensors launch the kernel, counted
    in ``counter.launches`` (the calling wrapper), or raise."""
    if table.device.type == "cpu":
        return gat_bwd_plain(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                             round_att_first, negative_slope)
    n_ch = adst_r.shape[0]
    dev, width = _check_table("gat_bwd", table, n_ch, kz)
    if kz > 128 if round_att_first else n_ch != 1:
        raise ValueError(f"gat_bwd: kz {kz} / n_ch {n_ch} outside the kernel's layouts "
                         "(K2: one channel; K4: kz <= 128)")
    e = dst.shape[0]
    _cuda.require(gtab, "gtab", torch.float32, (num_rows, width), dev)
    _cuda.require(logden, "logden", torch.float32, (n_ch, num_rows), dev)
    _cuda.require(adst_r, "adst_r", torch.float32, (n_ch, num_rows), dev)
    _cuda.require(src, "src", torch.int32, (e,), dev)
    _cuda.require(dst, "dst", torch.int32, (e,), dev)
    check_walk(src, src_perm, src_sorted)
    # one zeroed buffer for both sums: dpk's rows padded to 16 bytes, da_dst
    # by dst, then channel (an edge's channels share a sector)
    stride = -(-width // 4) * 4
    n = table.shape[0]
    out = torch.zeros(n * stride + num_rows * n_ch, dtype=torch.float32, device=dev)
    dpk = out[: n * stride].view(n, stride)
    da_dst = out[n * stride:].view(num_rows, n_ch)
    if e > 0:
        _cuda.launch(
            "gat_bwd", dev, table.data_ptr(), int(table.dtype == torch.bfloat16),
            int(round_att_first), gtab.data_ptr(), logden.data_ptr(), adst_r.data_ptr(),
            src_perm.data_ptr(), src_sorted.data_ptr(), dst.data_ptr(), dpk.data_ptr(),
            da_dst.data_ptr(), e, num_rows, kz, n_ch, stride, float(negative_slope),
        )
        counter.launches += 1
    # one transpose here: left strided, the autograd consumers copied it twice
    return dpk[:, :width], da_dst.t().contiguous()


def flash_gat_bwd_plain(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                        negative_slope=0.2, src_perm=None, src_sorted=None):
    """Plain PyTorch version of flash_gat_bwd, same inputs and rounding
    points (K2's); the walk is accepted and not read (gat_bwd_plain)."""
    dpk, da_dst = gat_bwd_plain(table, gtab, logden[None], adst_r[None], src, dst,
                                num_rows, kz, False, negative_slope)
    return dpk, da_dst[0]


@declares("flash_gat_bwd", lambda table, gtab, logden, adst_r, src, dst, num_rows, kz, *a,
          **k: cost.flash_bwd_cost(dst.shape[0], kz, num_rows, table.shape[0],
                                   table.element_size(), True))
def flash_gat_bwd(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                  negative_slope=0.2, src_perm=None, src_sorted=None):
    """(dpk f32[n, kz+1], da_dst f32[num_rows]): gat_bwd for one channel at
    K2's rounding points.

    table: the forward's [n, kz+1] ``[z | a_src]`` rows in the transport
    dtype; gtab: f32[num_rows, kz+1] ``[round_T(g) | gout]``; logden,
    adst_r: f32[num_rows]; src, dst: int32[E] with padding ``dst >=
    num_rows``; src_perm, src_sorted: the walk (gat_bwd; required on a CUDA
    tensor).  Launches counted in ``flash_gat_bwd.launches``."""
    dpk, da_dst = gat_bwd(flash_gat_bwd, table, gtab, logden[None], adst_r[None],
                          src, dst, num_rows, kz, False, negative_slope, src_perm,
                          src_sorted)
    return dpk, da_dst[0]


flash_gat_bwd.launches = 0


def flash_gat_bwd_glue_plain(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                             negative_slope=0.2, dst_perm=None, dst_sorted=None):
    """Plain PyTorch version of flash_gat_bwd_glue, same inputs and rounding
    points (K2's): (ct [E, kz+1] in the table's dtype, exact zeros on the
    padding edges' rows; da_dst f32[num_rows], the unrounded dpre summed by
    dst).  The walk is accepted and not read: every edge's row is formed
    at its own index and every real edge's dpre summed by its own dst, so
    a walk that drops or repeats edges shows as a mismatch with the
    kernel."""
    real = dst < num_rows
    s, d = src[real].long(), dst[real].long()
    ct_real, dpre = _bwd_edge_terms(table, gtab, logden[None], adst_r[None], s, d, kz,
                                    False, negative_slope)
    ct = torch.zeros((dst.shape[0], kz + 1), dtype=table.dtype, device=table.device)
    ct[real] = ct_real.to(table.dtype)
    return ct, segment_sum(dpre[:, 0], d, num_rows)


@declares("flash_gat_bwd_glue", lambda table, gtab, logden, adst_r, src, dst, num_rows, kz,
          *a, **k: cost.flash_bwd_cost(dst.shape[0], kz, num_rows, table.shape[0],
                                       table.element_size(), False))
def flash_gat_bwd_glue(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                       negative_slope=0.2, dst_perm=None, dst_sorted=None):
    """K13 (``bwd='glue'``): (ct [E, kz+1] in the table's dtype, da_dst
    f32[num_rows]).  Edge e's row is its cotangent ``[round_T(g·att) |
    round_T(dpre)]`` (exact zeros for a padding edge) and da_dst sums dpre by
    dst, from K2's stat inputs (see flash_gat_bwd); the caller scatters ct
    by src with segment_kernels.localized_scatter_add (K6), as the JAX
    route does (flash_gat.py:1444-1479).

    dst_perm, dst_sorted: int32[E], the walk by dst (gat_fwd's; required on
    a CUDA tensor, check_dst_walk): the kernel loads each dst row's stats
    once a run of it and adds the run's dpre with one atomic; ct stays in
    the edges' own order.  Any kz.  CPU tensors take the plain version;
    CUDA tensors launch csrc/gat_bwd.cu's gat_bwd_glue_walk_kernel, counted
    in ``flash_gat_bwd_glue.launches``, or raise."""
    if table.device.type == "cpu":
        return flash_gat_bwd_glue_plain(table, gtab, logden, adst_r, src, dst, num_rows, kz,
                                        negative_slope)
    dev, width = _check_table("flash_gat_bwd_glue", table, 1, kz)
    e = dst.shape[0]
    _cuda.require(gtab, "gtab", torch.float32, (num_rows, width), dev)
    _cuda.require(logden, "logden", torch.float32, (num_rows,), dev)
    _cuda.require(adst_r, "adst_r", torch.float32, (num_rows,), dev)
    _cuda.require(src, "src", torch.int32, (e,), dev)
    _cuda.require(dst, "dst", torch.int32, (e,), dev)
    check_dst_walk(dst, dst_perm, dst_sorted, "gat_bwd_glue")
    ct = torch.empty((e, width), dtype=table.dtype, device=dev)  # written whole
    da_dst = torch.zeros(num_rows, dtype=torch.float32, device=dev)
    if e == 0:
        return ct, da_dst
    _cuda.launch(
        "gat_bwd_glue", dev, table.data_ptr(), int(table.dtype == torch.bfloat16),
        gtab.data_ptr(), logden.data_ptr(), adst_r.data_ptr(), dst_perm.data_ptr(),
        dst_sorted.data_ptr(), src.data_ptr(), ct.data_ptr(), da_dst.data_ptr(), e, num_rows,
        kz, float(negative_slope),
    )
    flash_gat_bwd_glue.launches += 1
    return ct, da_dst


flash_gat_bwd_glue.launches = 0


def dst_block_bounds(dst, num_rows):
    """int32[n_blocks+1] for the 128-row dst blocks: block b's edges are
    ``[bounds[b], bounds[b+1])`` of a block-monotone edge list (graph.py's
    order), the counterpart of the JAX ``_block_chunk_bounds``.  The first
    bound is 0 and the last E, so the ranges cover every edge (the padding
    lands in the last block's range) whatever the order."""
    n_blocks = max(1, _cdiv(num_rows, _BR))
    blocks = torch.arange(n_blocks + 1, dtype=torch.int32, device=dst.device)
    bounds = torch.searchsorted((dst // _BR).to(torch.int32).contiguous(), blocks,
                                out_int32=True)
    bounds[0] = 0
    bounds[-1] = dst.shape[0]
    return bounds


def flash_gat_bwd_onepass_plain(table, stat, src, dst, num_rows, kz, negative_slope=0.2,
                                src_perm=None, src_sorted=None):
    """Plain PyTorch version of flash_gat_bwd_onepass, same inputs and
    rounding points: gat_bwd_plain at K2's points on the stat table's
    columns (g unrounded); the walk is accepted and not read."""
    dpk, da_dst = gat_bwd_plain(table, stat[:, : kz + 1], stat[None, :, kz + 1],
                                stat[None, :, kz + 2], src, dst, num_rows, kz, False,
                                negative_slope)
    return dpk, da_dst[0]


@declares("flash_gat_bwd_onepass", lambda table, stat, src, dst, num_rows, kz, *a, **k:
          cost.flash_bwd_onepass_cost(dst.shape[0], kz, num_rows, table.shape[0],
                                      table.element_size()))
def flash_gat_bwd_onepass(table, stat, src, dst, num_rows, kz, negative_slope=0.2,
                          src_perm=None, src_sorted=None):
    """K14 (``bwd='onepass'``): (dpk f32[n, kz+1], da_dst f32[num_rows]),
    the one-pass backward: K2's function with g not rounded to the
    transport, from one stat table.

    table: the forward's [n, kz+1] ``[z | a_src]`` rows in the transport
    dtype; stat: f32[num_rows, kz+3] rows ``[g | gout | logden | a_dst]``
    with g NOT rounded to the transport (JAX flash_gat.py:1365-1373);
    src, dst: int32[E] with padding ``dst >= num_rows``; src_perm,
    src_sorted: the walk by source (gat_bwd; required on a CUDA tensor,
    check_walk).  On the card dpk is a view of a zeroed buffer whose rows
    are padded to a multiple of 4 columns.  Any kz.  CPU tensors take the
    plain version; CUDA tensors launch csrc/gat_bwd.cu's walk in its
    StatRow mode, counted in ``flash_gat_bwd_onepass.launches``, or
    raise."""
    if table.device.type == "cpu":
        return flash_gat_bwd_onepass_plain(table, stat, src, dst, num_rows, kz,
                                           negative_slope)
    dev, width = _check_table("flash_gat_bwd_onepass", table, 1, kz)
    e = dst.shape[0]
    _cuda.require(stat, "stat", torch.float32, (num_rows, kz + 3), dev)
    _cuda.require(src, "src", torch.int32, (e,), dev)
    _cuda.require(dst, "dst", torch.int32, (e,), dev)
    check_walk(src, src_perm, src_sorted)
    # one zeroed buffer for both sums, dpk's rows padded to 16 bytes
    stride = -(-width // 4) * 4
    n = table.shape[0]
    out = torch.zeros(n * stride + num_rows, dtype=torch.float32, device=dev)
    dpk, da_dst = out[: n * stride].view(n, stride), out[n * stride:]
    if e > 0:
        _cuda.launch(
            "gat_bwd_onepass", dev, table.data_ptr(), int(table.dtype == torch.bfloat16),
            stat.data_ptr(), src_perm.data_ptr(), src_sorted.data_ptr(), dst.data_ptr(),
            dpk.data_ptr(), da_dst.data_ptr(), e, num_rows, kz, stride, float(negative_slope),
        )
        flash_gat_bwd_onepass.launches += 1
    return dpk[:, :width], da_dst


flash_gat_bwd_onepass.launches = 0


class FlashGAT(torch.autograd.Function):
    """The flash pass + normalization, differentiable in the table and
    a_dst, on the routes of `mode` (ops/config.FlashGATMode).

    forward(table [n, kz+1] in the transport dtype, a_dst f32[num_rows],
    src, dst int32[E], src_perm, src_sorted (int32[E], the walk by source
    of the fused and one-pass backwards, K2 and K14), dst_perm, dst_sorted
    (int32[E], the walk by dst of the forwards, K1/K12 and K12-online, and
    of the glue backward, K13),
    num_rows, kz, negative_slope, mode) -> out f32[num_rows, kz].  The
    shift is m̂ (bound_shift, K1/K12) or the row max m (online_shift,
    K12-online); it is a residual with no gradient, and logden = shift +
    log(s + 1e-16).  The backward builds the route's stat table as
    ``_flash_bwd`` does (ops/flash_gat.py:1360-1479): K2 and K13 take
    ``[round_T(g) | gout]`` (g rounded once through the transport, gout =
    Σ g·out from the unrounded g), logden and round_T(a_dst); K14 takes
    ``[g | gout | logden | round_T(a_dst)]`` with g unrounded.  It returns
    the table's gradient in the table's dtype and a_dst's in f32.  A graph
    without edges gives exact zeros both ways."""

    @staticmethod
    def forward(ctx, table, a_dst, src, dst, src_perm, src_sorted, dst_perm, dst_sorted,
                num_rows, kz, negative_slope, mode):
        fwalk = dict(dst_perm=dst_perm, dst_sorted=dst_sorted)
        if mode.softmax_shift == "online":
            adst_r, shift = online_shift(table, a_dst, src, dst, num_rows, kz,
                                         negative_slope, **fwalk)
            acc = flash_gat_fwd_online(table, adst_r, shift, src, dst, num_rows, kz,
                                       negative_slope, **fwalk)
        else:
            adst_r, shift = bound_shift(a_dst, table[:num_rows, kz], negative_slope,
                                        table.dtype)
            acc = flash_gat_fwd(table, adst_r, shift, src, dst, num_rows, kz,
                                negative_slope, **fwalk)
        s = acc[:, kz]
        out = acc[:, :kz] / (s[:, None] + 1e-16)
        ctx.save_for_backward(table, adst_r, shift, s, out, src, dst, src_perm, src_sorted,
                              dst_perm, dst_sorted)
        ctx.consts = (num_rows, kz, negative_slope, mode)
        return out

    @staticmethod
    def backward(ctx, g):
        (table, adst_r, shift, s, out, src, dst, src_perm, src_sorted, dst_perm,
         dst_sorted) = ctx.saved_tensors
        num_rows, kz, negative_slope, mode = ctx.consts
        if dst.shape[0] == 0:  # JAX flash_gat.py:1354-1356
            return (torch.zeros_like(table), torch.zeros_like(adst_r), None, None, None,
                    None, None, None, None, None, None, None)
        g = g.float()
        gout = (g * out).sum(dim=1, keepdim=True)
        logden = shift + torch.log(s + 1e-16)
        walk = dict(src_perm=src_perm, src_sorted=src_sorted)
        if mode.bwd == "onepass":
            stat = torch.cat([g, gout, logden[:, None], adst_r[:, None]], dim=1)
            dpk, da_dst = flash_gat_bwd_onepass(table, stat, src, dst, num_rows, kz,
                                                negative_slope, **walk)
        else:
            gtab = torch.cat([g.to(table.dtype).float(), gout], dim=1)
            if mode.bwd == "glue":
                from .segment_kernels import localized_scatter_add  # imports this module

                ct, da_dst = flash_gat_bwd_glue(table, gtab, logden, adst_r, src, dst,
                                                num_rows, kz, negative_slope,
                                                dst_perm=dst_perm, dst_sorted=dst_sorted)
                dpk = localized_scatter_add(
                    ct, src, table.shape[0], "bf16" if table.dtype == torch.bfloat16 else "f32")
            else:
                dpk, da_dst = flash_gat_bwd(table, gtab, logden, adst_r, src, dst,
                                            num_rows, kz, negative_slope, **walk)
        return (dpk.to(table.dtype), da_dst, None, None, None, None, None, None, None, None,
                None, None)


def flash_gat_attention_rows(table, a_dst, src, dst, num_rows, kz,
                             negative_slope=0.2, transport="f32", mode=FlashGATMode(),
                             src_perm=None, src_sorted=None, dst_perm=None, dst_sorted=None):
    """out[i] = Σ_e softmax_dst(leaky_relu(a_dst[i] + a_src[j]))_e · z[j]
    for single-head GAT, from the row-major table the kernel reads.

    table: [n, kz+1] ``[z | a_src]`` rows (n >= num_rows, n > max real src);
    a_dst: [num_rows] f32; src/dst: int32[E] with padding sentinel
    ``dst == num_rows``; mode: the routes (ops/config.FlashGATMode);
    src_perm, src_sorted: the StepGraph's walk by source, for the fused and
    one-pass backwards (None = src_walk of `src`, a sort, for callers
    without a StepGraph); dst_perm, dst_sorted: its walk by dst, for the
    forward in either shift and the glue backward (None = dst_walk of
    `dst`).  Returns
    [num_rows, kz] f32, differentiable in table and a_dst (FlashGAT).  The
    cast to the transport dtype stays outside the Function, so the table's
    gradient is rounded to it as the JAX VJP's is."""
    table = table.to(t_dtype_of(transport)).contiguous()
    src = src.to(torch.int32).contiguous()
    dst = dst.to(torch.int32).contiguous()
    if mode.bwd in ("fused", "onepass"):
        src_perm, src_sorted = src_walk(src, src_perm, src_sorted)
    dst_perm, dst_sorted = dst_walk(dst, dst_perm, dst_sorted)
    return FlashGAT.apply(
        table, a_dst.float().contiguous(), src, dst, src_perm, src_sorted, dst_perm,
        dst_sorted, num_rows, kz, negative_slope, mode,
    )


def flash_gat_attention(packed_t, a_dst, src, dst, src_perm, src_sorted,
                        num_rows, kz, negative_slope=0.2, transport="f32",
                        mode=FlashGATMode(), dst_perm=None, dst_sorted=None):
    """flash_gat_attention_rows with the JAX signature.

    packed_t: [k_pad, n_src_pad] column-major ``[z | a_src]`` table
    (pack_gat_table), copied once to the row-major [n_src_pad, kz+1];
    src_perm/src_sorted: the StepGraph's src-sorted permutation, the walk
    of the fused and one-pass backwards (None, None: built with src_walk);
    dst_perm/dst_sorted: its dst-sorted one, the walk of the forward and of
    the glue backward (None, None: built with dst_walk)."""
    _, k_pad, n_src_pad = _layout(num_rows, kz)
    if tuple(packed_t.shape) != (k_pad, n_src_pad):
        raise ValueError(
            f"packed_t: shape {tuple(packed_t.shape)}, expected {(k_pad, n_src_pad)}"
        )
    return flash_gat_attention_rows(packed_t[: kz + 1].t(), a_dst, src, dst,
                                    num_rows, kz, negative_slope, transport, mode,
                                    src_perm, src_sorted, dst_perm, dst_sorted)


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
