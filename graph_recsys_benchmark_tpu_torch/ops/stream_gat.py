"""Streaming GAT attention over loop-free edge lists with the self-loop
added analytically: the sparse, large-scale regime (ML-25M, Yelp).

Port of the JAX package's ``ops/stream_gat.py``.  PyG 1.5 GATConv adds one
self-loop per node; on a `gat_loops` StepGraph (graph.build_gat_graph
``analytic_loops``) the edge list carries none, and the loop's softmax term
is a row-wise quantity computed in plain torch (``_loop_terms``), as the
JAX package computes it in fused XLA.  Channels that share one edge list
(ML-25M: 7 of the 13 second steps ride the 2.13 M-edge item -> user graph)
run batched, at most 8 a pass.  Per channel the semantics are PyG's
single-head GATConv with the +1e-16 denominator guard, over the bound-shift
softmax of ops/flash_gat (m̂ = leaky(a_dst + max a_src), rounded once
through the transport dtype with a_dst, so forward and both backward
recomputations see the same logits).

Kernels (csrc/stream_gat.cu): ``stream_gat_fwd`` (K9, ``_make_fwd_kernel``)
accumulates ``[round_T(z·round_T(p)) | round_T(p)]`` per dst;
``stream_gat_bwd_dst`` (K10, ``_make_bwd_dst_kernel``) reduces da_dst and
``stream_gat_bwd_src`` (K11, ``_make_bwd_src_kernel``) scatters ``[att·g |
dpre]`` by src over the src-sorted order, both recomputing att and dpre per
edge from the stat table ``[g | gout | logden | a_dst]`` rounded to the
transport dtype (ops/stream_gat.py:311, 760; ``stat_table``, its rows
padded to ``stat_width``, a multiple of 8 values).  The three give each
CTA a chunk of STREAM_FWD_PIECE_EDGES / STREAM_DST_PIECE_EDGES /
STREAM_SRC_PIECE_EDGES edges of their walk, cut at the 128-row blocks'
bounds (StepGraph.block_bounds, StepGraph.src_block_bounds) into pieces:
K9 sorts its piece's edges by dst row in shared memory and sums each
row's run in registers, K10 stages its piece's 128 dst rows of stats in
shared memory, K11 streams the gathered stat rows through a shared-memory
ring and sums each source's run in registers.  A CUDA
tensor launches the kernel, counted in the wrapper's ``launches``, or
raises; a CPU tensor takes the ``*_plain`` version in this module, which
sums every real edge whatever the work split.  ``StreamGAT`` (a
``torch.autograd.Function``) builds the tables, adds the loop term and
normalizes, as ``_fwd_common`` / ``_stream_bwd`` do.

Edge-parallel (``mesh``, ``psum_scale``; the JAX ``psum_axis`` contract,
ops/stream_gat.py:595-822): the edge list is this rank's shard
(parallel/edge_parallel.py).  The forward all-reduces K9's per-dst
numerator and denominator partials before the loop term and the
normalization; the backward all-reduces the incoming cotangent, then K10's
and K11's partials, adds the loop term's gradient, and scales dz, da_src
and da_dst by `psum_scale` (1/dp), so that the trainer's one all-reduce of
the gradients restores the totals at every conv depth.  K9-K11 run on the
shard unchanged.  The row-sharded modes (parallel/a2a.py, spmd.py) run
the union graphs and never this route.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .cost import declares, stream_cost
from .flash_gat import _check_table, bound_shift, dst_block_bounds, gat_fwd_plain, t_dtype_of
from .segment import segment_max, segment_sum

# Per-channel GAT edge count from which graph.build_gat_graph (auto mode)
# leaves the self-loops implicit and the streaming path takes the graph.
# It picks a graph layout, not a kernel gate: the math is exact either
# way, and both packages keep it so that they build the same graphs.
STREAM_MIN_EDGES = 262144

# Kernel layout limits, as the JAX package's: at most 8 channels a pass
# and kz <= 125 feature columns.
MAX_CHANNELS = 8
MAX_KZ = 125


def _band_for(kz):
    """Width of one channel's stat band ``[g (kz) | gout | logden | a_dst]``.
    The JAX package pads each band to a multiple of 8 for the TPU's lane
    tiles; here the bands are packed and only the row is padded
    (stat_width)."""
    return kz + 3


def _leaky(x, slope):
    return torch.where(x > 0, x, slope * x)


def _check_layout(name, n_ch, kz):
    if not (1 <= n_ch <= MAX_CHANNELS and 1 <= kz <= MAX_KZ):
        raise ValueError(f"{name}: n_ch {n_ch} / kz {kz} outside 1..{MAX_CHANNELS} / "
                         f"1..{MAX_KZ}")


# Edges a CTA takes (one chunk of the walk's order, cut at the 128-row
# blocks' bounds into pieces) in K9 (stream_gat_fwd), K10
# (stream_gat_bwd_dst) and K11 (stream_gat_bwd_src), the fastest of
# chip_smoke.py's sweep on one H100 (PERF.md).  K11 keeps a chunk's ids in
# shared memory, so its chunk is at most MAX_SRC_PIECE_EDGES; K9 sorts
# its chunk's sources by row there, so its chunk is at most
# MAX_FWD_PIECE_EDGES.
STREAM_FWD_PIECE_EDGES = 2048
STREAM_DST_PIECE_EDGES = 2048
STREAM_SRC_PIECE_EDGES = 1024
MAX_FWD_PIECE_EDGES = 8192
MAX_SRC_PIECE_EDGES = 8192


def _check_pieces(name, bounds, n_rows, piece_edges, max_piece, dev):
    """n_blocks of a kernel's 128-row blocks over n_rows, with `bounds`
    (int32[n_blocks+1], the blocks' edge ranges) and `piece_edges`
    validated."""
    n_blocks = max(1, -(-n_rows // 128))
    if bounds is None:
        raise ValueError(f"{name}: the kernel needs the graph's block bounds (StepGraph)")
    _cuda.require(bounds, f"{name} block bounds", torch.int32, (n_blocks + 1,), dev)
    if not 1 <= piece_edges <= max_piece:
        raise ValueError(f"{name}: piece_edges {piece_edges} outside 1..{max_piece}")
    return n_blocks


# ---------------------------------------------------------------- K9


def stream_gat_fwd_plain(table, adst_r, mhat, src, dst, num_rows, kz,
                         negative_slope=0.2, acc_dtype=torch.float32):
    """Plain PyTorch version of stream_gat_fwd, same inputs and rounding
    points (K3's, ops/flash_gat.gat_fwd_plain with round_p_first), over
    every real edge (no block bounds, no pieces)."""
    return gat_fwd_plain(table, adst_r, mhat, src, dst, num_rows, kz, True,
                         negative_slope, acc_dtype)


@declares("stream_gat_fwd", lambda table, adst_r, mhat, src, dst, num_rows, kz, *a, **k:
          stream_cost("fwd", dst.shape[0], kz, adst_r.shape[0], num_rows, table.element_size()))
def stream_gat_fwd(table, adst_r, mhat, src, dst, num_rows, kz, negative_slope=0.2,
                   block_bounds=None, piece_edges=None):
    """Unnormalized accumulator ``[num_rows, n_ch*(kz+1)]`` f32 (band c =
    ``[Σ round_T(z_c·round_T(p_c)) | Σ round_T(p_c)]`` by dst, no loop term)
    over a loop-free edge list in block order.

    table: [n, n_ch*(kz+1)] row-major bands ``[z_c | a_src_c]`` in the
    transport dtype; adst_r, mhat: f32[n_ch, num_rows] rounded through it;
    src, dst: int32[E] with padding ``dst >= num_rows``; block_bounds:
    int32[ceil(num_rows/128)+1], the 128-row dst blocks' edge ranges from
    0 to E (StepGraph.block_bounds, flash_gat.dst_block_bounds), which the
    kernel needs and the plain version does not read; piece_edges: edges a
    CTA takes, 1..MAX_FWD_PIECE_EDGES (default STREAM_FWD_PIECE_EDGES).
    Launches counted in ``stream_gat_fwd.launches``."""
    n_ch = adst_r.shape[0]
    _check_layout("stream_gat_fwd", n_ch, kz)
    if table.device.type == "cpu":
        return stream_gat_fwd_plain(table, adst_r, mhat, src, dst, num_rows, kz,
                                    negative_slope)
    piece_edges = piece_edges or STREAM_FWD_PIECE_EDGES
    dev, width = _check_table("stream_gat_fwd", table, n_ch, kz)
    e = dst.shape[0]
    _cuda.require(adst_r, "adst_r", torch.float32, (n_ch, num_rows), dev)
    _cuda.require(mhat, "mhat", torch.float32, (n_ch, num_rows), dev)
    _cuda.require(src, "src", torch.int32, (e,), dev)
    _cuda.require(dst, "dst", torch.int32, (e,), dev)
    n_blocks = _check_pieces("stream_gat_fwd", block_bounds, num_rows, piece_edges,
                             MAX_FWD_PIECE_EDGES, dev)
    acc = torch.zeros((num_rows, width), dtype=torch.float32, device=dev)
    if e > 0 and num_rows > 0:
        _cuda.launch("stream_gat_fwd", dev, table.data_ptr(),
                     int(table.dtype == torch.bfloat16), adst_r.data_ptr(),
                     mhat.data_ptr(), src.data_ptr(), dst.data_ptr(), block_bounds.data_ptr(),
                     acc.data_ptr(), e, n_blocks, num_rows, kz, n_ch, piece_edges,
                     float(negative_slope))
        stream_gat_fwd.launches += 1
    return acc


stream_gat_fwd.launches = 0


# ---------------------------------------------------------------- K10, K11


def stat_width(n_ch, kz):
    """Row stride of the backwards' stat table: the n_ch bands of kz+3
    values padded to a multiple of 8, so that every row (and every 128-row
    block) is 16 bytes aligned in f32 and bf16 and the kernels copy it in
    16-byte pieces.  The padding columns are zero and never read."""
    return -(-n_ch * _band_for(kz) // 8) * 8


def stat_table(g, gout, logden, adst_r, t_dtype):
    """The stat table [num_rows, stat_width] in `t_dtype`: band c =
    ``[g_c | gout_c | logden_c | a_dst_c]`` (g [n_ch, N, kz]; the rest
    [n_ch, N]), zero-padded and rounded once."""
    n_ch, n, kz = g.shape
    rows = torch.cat([g.permute(1, 0, 2), gout.t()[:, :, None], logden.t()[:, :, None],
                      adst_r.t()[:, :, None]], dim=2).view(n, n_ch * _band_for(kz))
    return F.pad(rows, (0, stat_width(n_ch, kz) - n_ch * _band_for(kz))).to(t_dtype)


def _edge_grads(table, stat, s, d, kz, n_ch, negative_slope):
    """Per real edge (s, d) and channel, what K10 and K11 recompute: (stat
    rows [E, n_ch, kz+3] f32, att, dpre [E, n_ch]).  datt sums the
    transport-rounded products g·z in f32."""
    t_dtype = table.dtype
    rows = table[s].float().view(-1, n_ch, kz + 1)
    st = stat[d, : n_ch * _band_for(kz)].float().view(-1, n_ch, _band_for(kz))
    pre = st[:, :, kz + 2] + rows[:, :, kz]
    att = torch.exp(torch.clamp(_leaky(pre, negative_slope) - st[:, :, kz + 1], max=60.0))
    datt = (st[:, :, :kz] * rows[:, :, :kz]).to(t_dtype).float().sum(dim=2)
    dalpha = att * (datt - st[:, :, kz])
    dpre = torch.where(pre > 0, dalpha, dalpha * negative_slope)
    return st, att, dpre


def _check_bwd(name, table, stat, num_rows, n_rows, n_ch, kz, ids, bounds, piece_edges,
               max_piece):
    """(device, width, E, n_blocks) of a backward's inputs, validated;
    n_rows: the rows its blocks cover (num_rows by dst, the table's by src)."""
    _check_layout(name, n_ch, kz)
    dev, width = _check_table(name, table, n_ch, kz)
    _cuda.require(stat, "stat", table.dtype, (num_rows, stat_width(n_ch, kz)), dev)
    e = ids[0].shape[0]
    for i, t in enumerate(ids):
        _cuda.require(t, f"{name} ids {i}", torch.int32, (e,), dev)
    n_blocks = _check_pieces(name, bounds, n_rows, piece_edges, max_piece, dev)
    for t, what in ((table, "table"), (stat, "stat")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    return dev, width, e, n_blocks


def stream_gat_bwd_dst_plain(table, stat, src, dst, num_rows, kz, negative_slope=0.2,
                             acc_dtype=torch.float32):
    """Plain PyTorch version of stream_gat_bwd_dst, same inputs and rounding
    points: da_dst f32[n_ch, num_rows] = Σ round_T(dpre) by dst over every
    real edge (no block bounds, no pieces)."""
    n_ch = table.shape[1] // (kz + 1)
    real = dst < num_rows
    s, d = src[real].long(), dst[real].long()
    _, _, dpre = _edge_grads(table, stat, s, d, kz, n_ch, negative_slope)
    dpre = dpre.to(table.dtype).to(acc_dtype)
    return segment_sum(dpre, d, num_rows).t().contiguous()


@declares("stream_gat_bwd_dst", lambda table, stat, src, dst, num_rows, kz, *a, **k:
          stream_cost("bwd_dst", dst.shape[0], kz, table.shape[1] // (kz + 1), num_rows,
                      table.element_size()))
def stream_gat_bwd_dst(table, stat, src, dst, num_rows, kz, negative_slope=0.2,
                       block_bounds=None, piece_edges=None):
    """da_dst f32[n_ch, num_rows]: Σ round_T(dpre) by dst over the block
    order.

    table: the forward's bands in the transport dtype; stat: [num_rows,
    stat_width(n_ch, kz)] bands ``[g_c | gout_c | logden_c | a_dst_c]`` in
    the transport dtype (stat_table); src, dst: int32[E] with padding
    ``dst >= num_rows``; block_bounds: int32[ceil(num_rows/128)+1], the
    128-row dst blocks' edge ranges from 0 to E (StepGraph.block_bounds,
    flash_gat.dst_block_bounds), which the kernel needs and the plain
    version does not read; piece_edges: edges a
    CTA takes (default STREAM_DST_PIECE_EDGES).  Launches counted in
    ``stream_gat_bwd_dst.launches``."""
    n_ch = table.shape[1] // (kz + 1)
    if table.device.type == "cpu":
        return stream_gat_bwd_dst_plain(table, stat, src, dst, num_rows, kz, negative_slope)
    piece_edges = piece_edges or STREAM_DST_PIECE_EDGES
    dev, _, e, n_blocks = _check_bwd("stream_gat_bwd_dst", table, stat, num_rows, num_rows,
                                     n_ch, kz, (src, dst), block_bounds, piece_edges, 2 ** 30)
    da_dst = torch.zeros((n_ch, num_rows), dtype=torch.float32, device=dev)
    if e > 0:
        _cuda.launch("stream_gat_bwd_dst", dev, table.data_ptr(),
                     int(table.dtype == torch.bfloat16), stat.data_ptr(), src.data_ptr(),
                     dst.data_ptr(), block_bounds.data_ptr(), da_dst.data_ptr(), e, n_blocks,
                     num_rows, kz, n_ch, stat.shape[1], piece_edges, float(negative_slope))
        stream_gat_bwd_dst.launches += 1
    return da_dst


stream_gat_bwd_dst.launches = 0


def stream_gat_bwd_src_plain(table, stat, src_perm, src_sorted, dst, num_rows, kz,
                             negative_slope=0.2, acc_dtype=torch.float32):
    """Plain PyTorch version of stream_gat_bwd_src, same inputs and rounding
    points: dpk f32[n, n_ch*(kz+1)], band c = Σ [round_T(g_c·round_T(att)) |
    round_T(dpre)] by src over every real edge (no block bounds, no
    pieces)."""
    n_ch = table.shape[1] // (kz + 1)
    d_e = dst[src_perm.long()]
    real = d_e < num_rows
    s, d = src_sorted[real].long(), d_e[real].long()
    st, att, dpre = _edge_grads(table, stat, s, d, kz, n_ch, negative_slope)
    t_dtype = table.dtype
    att_t = att.to(t_dtype).float()
    ct = torch.cat([(st[:, :, :kz] * att_t[:, :, None]).to(t_dtype).float(),
                    dpre.to(t_dtype).float()[:, :, None]], dim=2)
    dpk = torch.zeros((table.shape[0], n_ch * (kz + 1)), dtype=acc_dtype,
                      device=table.device)
    return dpk.index_add_(0, s, ct.reshape(-1, n_ch * (kz + 1)).to(acc_dtype))


@declares("stream_gat_bwd_src", lambda table, stat, src_perm, src_sorted, dst, num_rows, kz,
          *a, **k: stream_cost("bwd_src", dst.shape[0], kz, table.shape[1] // (kz + 1),
                               num_rows, table.element_size()))
def stream_gat_bwd_src(table, stat, src_perm, src_sorted, dst, num_rows, kz,
                       negative_slope=0.2, src_block_bounds=None, piece_edges=None):
    """dpk f32[n, n_ch*(kz+1)], band c = ``[dz_c | da_src_c]``: Σ
    [round_T(g_c·round_T(att)) | round_T(dpre)] by src, walked in the
    src-sorted order.

    table, stat: as stream_gat_bwd_dst; src_perm, src_sorted: int32[E], the
    graph's stable src sort; dst: int32[E] in block order (the kernel reads
    dst[src_perm[e]]), padding ``dst >= num_rows``; src_block_bounds:
    int32[ceil(n/128)+1], the 128-row src blocks' ranges of the src-sorted
    order from 0 to E (StepGraph.src_block_bounds), which the kernel needs
    and the plain version does not read; piece_edges: edges a CTA takes,
    1..MAX_SRC_PIECE_EDGES (default STREAM_SRC_PIECE_EDGES).  Launches
    counted in ``stream_gat_bwd_src.launches``."""
    n_ch = table.shape[1] // (kz + 1)
    if table.device.type == "cpu":
        return stream_gat_bwd_src_plain(table, stat, src_perm, src_sorted, dst, num_rows, kz,
                                        negative_slope)
    n_src = table.shape[0]
    piece_edges = piece_edges or STREAM_SRC_PIECE_EDGES
    dev, width, e, n_blocks = _check_bwd(
        "stream_gat_bwd_src", table, stat, num_rows, n_src, n_ch, kz,
        (src_perm, src_sorted, dst), src_block_bounds, piece_edges, MAX_SRC_PIECE_EDGES)
    dpk = torch.zeros((n_src, width), dtype=torch.float32, device=dev)
    if e > 0:
        _cuda.launch("stream_gat_bwd_src", dev, table.data_ptr(),
                     int(table.dtype == torch.bfloat16), stat.data_ptr(),
                     src_perm.data_ptr(), src_sorted.data_ptr(), dst.data_ptr(),
                     src_block_bounds.data_ptr(), dpk.data_ptr(), e, n_blocks, n_src,
                     num_rows, kz, n_ch, stat.shape[1], piece_edges, float(negative_slope))
        stream_gat_bwd_src.launches += 1
    return dpk


stream_gat_bwd_src.launches = 0


# ---------------------------------------------------------------- autograd


def _loop_terms(table, adst_r, mhat, num_rows, kz, n_ch, negative_slope):
    """Per-row analytic self-loop quantities per channel: the rounded z
    [n_ch, N, kz], the loop logit's pre-activation [n_ch, N] and p =
    exp(min(act - m̂, 60)) [n_ch, N], all f32."""
    bands = table[:num_rows].float().view(num_rows, n_ch, kz + 1)
    z_r = bands[:, :, :kz].permute(1, 0, 2)
    pre = adst_r + bands[:, :, kz].t()
    p = torch.exp(torch.clamp(_leaky(pre, negative_slope) - mhat, max=60.0))
    return z_r, pre, p


def _fwd_common(z, a_src, a_dst, src, dst, block_bounds, num_rows, self_loops,
                negative_slope, t_dtype, mesh=None):
    """(out [n_ch, N, kz] f32, table, adst_r, m̂, s): the table's bands and
    a_dst rounded once to the transport dtype, K9 over the edges (in
    pieces cut at `block_bounds`), its partials all-reduced over `mesh`
    (an edge shard's; m̂ depends on replicated tables only, so every rank
    shifts alike), then the loop term and the normalization in f32
    (ops/stream_gat.py:594-665)."""
    n_ch, _, kz = z.shape
    band = torch.cat([z.to(t_dtype), a_src[:, :, None].to(t_dtype)], dim=2)
    table = band.permute(1, 0, 2).reshape(num_rows, n_ch * (kz + 1)).contiguous()
    adst_r, mhat = bound_shift(a_dst, band[:, :, kz], negative_slope, t_dtype)
    acc = stream_gat_fwd(table, adst_r, mhat, src, dst, num_rows, kz, negative_slope,
                         block_bounds=block_bounds)
    if mesh is not None:
        from ..parallel.collectives import all_reduce_

        all_reduce_(acc, mesh)
    acc_b = acc.view(num_rows, n_ch, kz + 1)
    num = acc_b[:, :, :kz].permute(1, 0, 2)
    s = acc_b[:, :, kz].t()
    if self_loops:
        z_r, _, p_l = _loop_terms(table, adst_r, mhat, num_rows, kz, n_ch,
                                  negative_slope)
        num = num + p_l[:, :, None] * z_r
        s = s + p_l
    return num / (s[:, :, None] + 1e-16), table, adst_r, mhat, s


class StreamGAT(torch.autograd.Function):
    """Batched streaming GAT, differentiable in z, a_src and a_dst.

    forward(z f32[n_ch, N, kz], a_src, a_dst f32[n_ch, N], src, dst,
    src_perm, src_sorted int32[E], block_bounds, src_block_bounds
    (int32[ceil(N/128)+1]: K9 and K10 read the first, K11 the second),
    num_rows, self_loops,
    negative_slope, transport, mesh, psum_scale) -> out f32[n_ch, N, kz]
    (`mesh` None: the whole edge list, no collective).  The backward builds
    the stat table as ``_stream_bwd`` does (ops/stream_gat.py:707-720: g,
    gout = Σ g·out, logden = m̂ + log(s + 1e-16), a_dst, rounded to the
    transport dtype for the kernels; stat_table), runs K10 and K11, and
    adds the loop term's gradient from
    the unrounded f32 stats; dz, da_src, da_dst come back in f32."""

    @staticmethod
    def forward(ctx, z, a_src, a_dst, src, dst, src_perm, src_sorted, block_bounds,
                src_block_bounds, num_rows, self_loops, negative_slope, transport,
                mesh=None, psum_scale=1.0):
        t_dtype = t_dtype_of(transport)
        out, table, adst_r, mhat, s = _fwd_common(z, a_src, a_dst, src, dst, block_bounds,
                                                  num_rows, self_loops, negative_slope,
                                                  t_dtype, mesh)
        ctx.save_for_backward(table, adst_r, mhat, s, out, src, dst, src_perm, src_sorted,
                              block_bounds, src_block_bounds)
        ctx.consts = (num_rows, self_loops, negative_slope, mesh, psum_scale)
        ctx.dtypes = (z.dtype, a_src.dtype, a_dst.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        (table, adst_r, mhat, s, out, src, dst, src_perm, src_sorted, block_bounds,
         src_block_bounds) = ctx.saved_tensors
        num_rows, self_loops, negative_slope, mesh, psum_scale = ctx.consts
        n_ch, _, kz = out.shape
        g = g.float()
        if mesh is not None:
            from ..parallel.collectives import all_reduce_

            # the cotangent may be this rank's partial (a batch-sharded
            # loss): every edge must see the total (ops/stream_gat.py:722-732)
            g = all_reduce_(g.contiguous().clone(), mesh)
        logden = mhat + torch.log(s + 1e-16)
        gout = (g * out).sum(dim=2)
        stat = stat_table(g, gout, logden, adst_r, table.dtype)
        da_dst = stream_gat_bwd_dst(table, stat, src, dst, num_rows, kz, negative_slope,
                                    block_bounds=block_bounds)
        dpk = stream_gat_bwd_src(table, stat, src_perm, src_sorted, dst, num_rows, kz,
                                 negative_slope, src_block_bounds=src_block_bounds)
        if mesh is not None:  # the shards' partials -> totals, one call
            both = all_reduce_(torch.cat([dpk.reshape(-1), da_dst.reshape(-1)]), mesh)
            dpk = both[: dpk.numel()].view_as(dpk)
            da_dst = both[dpk.numel():].view_as(da_dst)
        dpk_b = dpk.view(-1, n_ch, kz + 1)[:num_rows]
        dz = dpk_b[:, :, :kz].permute(1, 0, 2)
        da_src = dpk_b[:, :, kz].t()
        if self_loops:
            z_r, pre_l, _ = _loop_terms(table, adst_r, mhat, num_rows, kz, n_ch,
                                        negative_slope)
            att_l = torch.exp(torch.clamp(_leaky(pre_l, negative_slope) - logden, max=60.0))
            dalpha_l = att_l * ((g * z_r).sum(dim=2) - gout)
            dpre_l = torch.where(pre_l > 0, dalpha_l, dalpha_l * negative_slope)
            da_dst = da_dst + dpre_l
            da_src = da_src + dpre_l
            dz = dz + att_l[:, :, None] * g
        if mesh is not None and psum_scale != 1.0:
            dz, da_src, da_dst = dz * psum_scale, da_src * psum_scale, da_dst * psum_scale
        z_dt, as_dt, ad_dt = ctx.dtypes
        return (dz.to(z_dt), da_src.to(as_dt), da_dst.to(ad_dt),
                None, None, None, None, None, None, None, None, None, None, None, None)


def stream_gat_attention_batched(z, a_src, a_dst, src, dst, src_perm, src_sorted,
                                 num_rows, self_loops=True, negative_slope=0.2,
                                 transport="f32", block_bounds=None, src_block_bounds=None,
                                 mesh=None, psum_scale=1.0):
    """Batched single-head GAT attention for n_ch <= 8 channels sharing ONE
    loop-free, block-ordered edge list, with PyG's self-loop added
    analytically per channel when `self_loops`.

    z: [n_ch, num_rows, kz] (kz <= 125); a_src/a_dst: [n_ch, num_rows];
    src/dst: int32[E] (padding sentinel dst == num_rows); src_perm /
    src_sorted: the StepGraph's stable src sort; block_bounds /
    src_block_bounds: the StepGraph's 128-row block ranges by dst and in
    the src-sorted order (computed here when None); mesh / psum_scale: the
    edge-parallel contract (src/dst one rank's shard; StreamGAT).  Returns
    [n_ch, num_rows, kz] f32, differentiable in z, a_src and a_dst
    (StreamGAT)."""
    _check_layout("stream_gat_attention_batched", z.shape[0], z.shape[2])
    i32 = [t.to(torch.int32).contiguous() for t in (src, dst, src_perm, src_sorted)]
    if block_bounds is None:
        block_bounds = dst_block_bounds(i32[1], num_rows)
    if src_block_bounds is None:
        src_block_bounds = dst_block_bounds(i32[3], num_rows)
    return StreamGAT.apply(z.float(), a_src.float(), a_dst.float(), *i32, block_bounds,
                           src_block_bounds, num_rows, self_loops, negative_slope, transport,
                           mesh, psum_scale)


def stream_gat_attention(z, a_src, a_dst, src, dst, src_perm, src_sorted, num_rows,
                         self_loops=True, negative_slope=0.2, transport="f32",
                         block_bounds=None, src_block_bounds=None):
    """One channel of stream_gat_attention_batched: z [num_rows, kz];
    a_src/a_dst: [num_rows]."""
    return stream_gat_attention_batched(
        z[None], a_src[None], a_dst[None], src, dst, src_perm, src_sorted, num_rows,
        self_loops, negative_slope, transport, block_bounds, src_block_bounds)[0]


def stream_gat_reference(z, a_src, a_dst, src, dst, num_rows, self_loops=True,
                         negative_slope=0.2, edge_keep=None, loop_keep=None,
                         dropout=0.0):
    """Plain f32 oracle with the exact-max softmax (JAX
    stream_gat_reference): GAT over the loop-free list plus, when
    `self_loops`, the analytic loop.  It is also the route of a `gat_loops`
    conv under attention dropout, on the card too (plain torch ops, as the
    JAX package runs its XLA version there): edge_keep bool [E] and
    loop_keep bool [N] are the keep masks (PyG drops each alpha on its own;
    with loops as edges their alphas were dropped too, so the analytic loop
    has its own mask).  The softmax's denominator sums the un-dropped p,
    loop term included; the normalized alphas are then dropped and scaled
    by 1 / (1 - dropout), with no renormalizing (PyG 1.5 GATConv order)."""
    real = dst < num_rows
    safe_src = torch.clamp(src, max=num_rows - 1).long()
    safe_dst = torch.clamp(dst, max=num_rows - 1).long()
    pre = a_dst[safe_dst] + a_src[safe_src]
    act = torch.where(real, _leaky(pre, negative_slope), torch.full_like(pre, float("-inf")))
    m = segment_max(act, safe_dst, num_rows)
    if self_loops:
        act_l = _leaky(a_dst + a_src, negative_slope)
        m = torch.maximum(m, act_l)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(real, torch.exp(act - m_safe[safe_dst]), torch.zeros_like(act))
    s = segment_sum(p, safe_dst, num_rows)
    if self_loops:
        p_l = torch.exp(act_l - m_safe)
        s = s + p_l
    att = p / (s + 1e-16)[safe_dst]
    if dropout > 0.0 and edge_keep is not None:
        att = torch.where(edge_keep, att / (1.0 - dropout), torch.zeros_like(att))
    msgs = att[:, None] * torch.where(real[:, None], z[safe_src], torch.zeros_like(z[safe_src]))
    out = segment_sum(msgs, safe_dst, num_rows)
    if self_loops:
        att_l = p_l / (s + 1e-16)
        if dropout > 0.0 and loop_keep is not None:
            att_l = torch.where(loop_keep, att_l / (1.0 - dropout), torch.zeros_like(att_l))
        out = out + att_l[:, None] * z
    return out


def stream_gat_enabled(kz=None, n_ch=1, dropout_active=False):
    """Whether channels of a `gat_loops` graph may stream batched: the
    kernels' layout limits (kz <= 125, <= 8 channels) and no attention
    dropout (which runs stream_gat_reference with its masks).  The JAX
    predicate also asks for a TPU and a large edge list; here every
    `gat_loops` graph streams (the edge threshold chose the layout in
    graph.build_gat_graph)."""
    return (not dropout_active and n_ch <= MAX_CHANNELS
            and (kz is None or kz <= MAX_KZ))
