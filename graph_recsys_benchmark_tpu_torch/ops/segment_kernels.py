"""Segment-sum, row gather, scatter-add and segment softmax over edge lists:
the edge pipeline of every summing conv (GCN, SAGE, and the later NGCF/KG
families) and of the composed GAT (nn/conv.gat_apply on loop-edge graphs).

Port of the JAX package's ``ops/pallas_segment.py`` kernels:

  * ``sorted_segment_sum`` (K5, ``sorted_segment_sum_pallas``):
    ``out[d] = Σ_{dst[e]=d} msgs[e]``, f32 accumulation of f32 or bf16
    messages.  The JAX contract is a block-monotone ``dst`` (graph.py's
    edge order); the port's kernel and plain version take any order.
    Differentiable: its backward is ``sorted_broadcast`` of the output
    gradient by ``dst``, cast to the messages' dtype, as ``_bwd``
    (:228-238) does.
  * ``sorted_broadcast`` (K7, ``sorted_broadcast_pallas``): ``out[e] =
    v[idx[e]]``, an exact row copy in v's dtype; the padding sentinel gives
    zeros.  Differentiable (``Broadcast``): its backward is ``_bc_bwd``
    (:609-619), the K5 segment-sum of the output gradient by ``idx`` in the
    transport dtype, cast to v's dtype.
  * ``localized_scatter_add`` (K6, ``localized_scatter_add_pallas``):
    ``out[i] = Σ_{idx[e]=i} ct[e]`` for ``idx`` in any order, ``ct`` rounded
    to the transport dtype first (:701-707), f32 accumulation.  Used as a
    backward only (``ops/gather.GatherRows``), so it refuses inputs that
    need a gradient.
  * ``softmax_stats`` (K8, ``_softmax_stats_kernel``): per dst row the max
    and the sum of exp(alpha - max) of f32 edge logits, max -inf for a row
    with no edge.  As the JAX contract, the kernel takes a block-monotone
    ``dst`` (graph.py's order) and its 128-row blocks' edge ranges
    (``StepGraph.block_bounds``); the plain version takes any order and
    reads no bounds.  ``segment_softmax`` (``segment_softmax_pallas``,
    :346-398) builds the softmax on it: stats gathered per edge by K7, the
    +1e-16 guard, padding edges forced to 0; its backward (``_softmax_bwd``,
    :376-391) is a K5 segment-sum of att·g by dst and a K7 gather back.

Kernels: csrc/segment.cu.  K5 and K6 both launch its ``scatter_add`` (f32
atomics by id over a walk of the edges: the graph's sort by id where the
caller passes it as ``order`` = (perm, ids[perm]), each id's edges one run
summed before its atomic, else the edges' own order; the kernel then sums
by ``order[1]``, not by the ids, so the walk must be that of the same ids;
the source says why a dst-block design lost), K7 its ``row_gather``, K8 its ``softmax_stats`` (one
CTA a dst block, one launch a call).  A
CUDA tensor launches the kernel, counted in the wrapper's ``launches``, or
raises; a CPU tensor takes the ``*_plain`` version in this module.  The
JAX package's dispatch gates (65,536 edges, ``GATHER_SPAN_MAX``,
``scatter_fits_vmem``, k <= 128) are TPU facts and are not copied: every
call on a CUDA tensor reaches its kernel.  Columns: any number.  K5 and
K6 take a row wider than ``MAX_COLS`` in passes of at most that many
columns, one counted launch a pass (the kernel reads and writes rows of a
stride of its own); K7 copies a row of up to ``GATHER_ROW_BYTES`` in one
launch and a wider one as equal pieces of it, also in one launch
(_gather_pieces).  Ids are int32 and non-negative, as the port's graphs
hold them; ids >= num_rows are the padding sentinel.
"""

from __future__ import annotations

import torch

from . import _cuda
from .cost import declares, gather_cost, scatter_cost, segsum_cost, softmax_stats_cost
from .flash_gat import t_dtype_of
from .segment import segment_max, segment_sum

# the columns of one launch of K5 or K6 (a row is at most 256 threads'
# work); a wider row takes passes of at most this many columns
MAX_COLS = 256
# the bytes of a row that K7 copies whatever its alignment (row_gather: 256
# threads of at most 8 words, of at least 2 bytes)
GATHER_ROW_BYTES = 4096


def _as_2d(name, x):
    """[E] -> [E, 1]; [E, D] as is (D >= 1, any width); contiguous."""
    x2 = x[:, None] if x.dim() == 1 else x
    if x2.dim() != 2 or x2.shape[1] < 1:
        raise ValueError(f"{name}: need [E] or [E, D] with D >= 1, got {tuple(x.shape)}")
    return x2.contiguous()


def _passes(d):
    """(first column, columns) of each launch over a row of d columns."""
    return [(c, min(MAX_COLS, d - c)) for c in range(0, d, MAX_COLS)]


def _check_launch(name, data, ids, num_ids):
    """(device, bf16 flag) of a kernel's inputs, validated: `data` a
    contiguous f32 or bf16 CUDA tensor; `ids` int32[num_ids] on the same
    card."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {data.dtype}, expected f32 or bf16")
    _cuda.require(ids, f"{name} ids", torch.int32, (num_ids,), dev)
    return dev, int(data.dtype == torch.bfloat16)


def acc_width(d):
    """Columns of scatter_add's f32 accumulator for rows of width d: d for
    d <= 2, else d rounded up to a multiple of 4, so that every row of it
    takes 16-byte vector atomics (65 -> 68, 17 -> 20)."""
    return d if d <= 2 else -(-d // 4) * 4


def _sum_by_id(counter, rows, ids, num_rows, order=None):
    """f32 ``[num_rows, D]`` sums of ``rows`` (a CUDA tensor already in the
    transport dtype) by int32 ``ids``: csrc/segment.cu's scatter_add, which
    serves K5 and K6.  ``order``: (perm, ids[perm]) int32[E], a walk of the
    edges sorted by id (StepGraph.dst_perm / dst_sorted, src_perm /
    src_sorted), in which each id's edges form one run that the kernel sums
    before its atomic; the kernel adds rows[perm[k]] to row order[1][k] and
    reads ``ids`` no more, so order[1] must equal ids[perm] (the caller's
    contract, held by the card tests; checking it here would cost a gather
    and a host sync a call).  None walks the edges in their own order (the
    runs are shorter).  The accumulator's rows are
    acc_width(D) wide: for D % 4 != 0 (65, 17) the result is a view of its
    first D columns, no copy; the padding costs (acc_width(D) - D) / D
    more zeroed bytes.  A row wider than MAX_COLS takes one launch a pass
    of at most MAX_COLS columns (_passes), each adding into its columns of
    the one accumulator, in 16-byte pieces (a pass's width rounded up to 4
    columns: the last pass of 257 adds 4, three of them zeros into the
    padding).  Each launch is counted in ``counter.launches`` (the calling
    wrapper)."""
    e, d = rows.shape
    name = counter.__name__
    dev, bf16 = _check_launch(name, rows, ids, e)
    ld_out = acc_width(d)
    out = torch.zeros((num_rows, ld_out), dtype=torch.float32, device=dev)
    perm, walk = None, ids
    if order is not None:
        perm, walk = order
        _cuda.require(perm, f"{name} perm", torch.int32, (e,), dev)
        _cuda.require(walk, f"{name} sorted ids", torch.int32, (e,), dev)
    if e > 0 and num_rows > 0:
        for c0, dp in _passes(d):
            stride = d if d <= 2 else -(-dp // 4) * 4
            _cuda.launch("scatter_add", dev, rows.data_ptr() + c0 * rows.element_size(), bf16,
                         None if perm is None else perm.data_ptr(), walk.data_ptr(),
                         out.data_ptr() + c0 * 4, e, num_rows, dp, stride, d, ld_out)
            counter.launches += 1
    return out if ld_out == d else out[:, :d]


def _refuse_grad(name, t):
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(
            f"{name} is a backward only and has no backward of its own: call "
            "it on tensors that need no gradient"
        )


# ---------------------------------------------------------------- K5


def sorted_segment_sum_plain(msgs, dst, num_rows, transport="f32"):
    """Plain PyTorch version of sorted_segment_sum's forward: the messages
    rounded to the transport dtype, summed in f32; ids >= num_rows dropped."""
    msgs = msgs.to(t_dtype_of(transport))
    return segment_sum(msgs.float(), dst, num_rows)


@declares("sorted_segment_sum", lambda msgs, dst, num_rows, transport, order: segsum_cost(
    dst.shape[0], msgs.shape[1], num_rows, t_dtype_of(transport).itemsize))
def _segment_sum(msgs, dst, num_rows, transport, order):
    """K5's forward: the plain version for a CPU tensor, else the kernel."""
    if msgs.device.type == "cpu":
        return sorted_segment_sum_plain(msgs, dst, num_rows, transport)
    return _sum_by_id(sorted_segment_sum, msgs.to(t_dtype_of(transport)).contiguous(),
                      dst, num_rows, order)


class SegmentSum(torch.autograd.Function):
    """K5 forward on the messages rounded to the transport dtype; K7
    backward: d msgs[e] = g[dst[e]] (zeros for the padding sentinel), cast
    to the messages' own dtype, as the JAX VJP's ``astype`` does."""

    @staticmethod
    def forward(ctx, msgs, dst, num_rows, transport, order):
        ctx.save_for_backward(dst)
        ctx.num_rows = num_rows
        ctx.msg_dtype = msgs.dtype
        return _segment_sum(msgs, dst, num_rows, transport, order)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        gm = sorted_broadcast(g.float().contiguous(), dst, ctx.num_rows)
        return gm.to(ctx.msg_dtype), None, None, None, None


def sorted_segment_sum(msgs, dst, num_rows, transport="f32", order=None):
    """Segment-sum ``msgs`` ([E] or [E, D], f32 or bf16) by ``dst`` (int32[E]
    in graph.py's block order or any other, padding sentinel ``dst ==
    num_rows`` dropped) into f32 ``[num_rows]`` / ``[num_rows, D]``; the
    messages are rounded to the transport dtype first.  ``order``: the
    kernel's walk, (perm, dst[perm]) sorted by dst (StepGraph.dst_perm,
    dst_sorted) for this very ``dst``, or None for the edges' own order
    (_sum_by_id); the plain version reads none.  Differentiable in msgs (SegmentSum).  Kernel
    launches counted in ``sorted_segment_sum.launches``."""
    out = SegmentSum.apply(_as_2d("sorted_segment_sum", msgs), dst, num_rows, transport, order)
    return out[:, 0] if msgs.dim() == 1 else out


sorted_segment_sum.launches = 0


# ---------------------------------------------------------------- K7


def sorted_broadcast_plain(v, idx, num_rows):
    """Plain PyTorch version of sorted_broadcast: v[idx] in v's dtype, zero
    rows for ids >= num_rows."""
    pad = torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))])
    return pad[torch.clamp(idx.long(), max=num_rows)]


def _gather_pieces(k, elem_bytes):
    """m, the pieces a row of k columns is gathered as: the fewest that
    divide k into pieces of at most GATHER_ROW_BYTES (1 for every row of
    at most that many bytes)."""
    return next(m for m in range(1, k + 1)
                if k % m == 0 and k // m * elem_bytes <= GATHER_ROW_BYTES)


def _piece_ids(idx, num_rows, m):
    """The ids of idx's rows cut into m pieces: the table [num_rows, k] seen
    as [num_rows * m, k / m], piece j of row r is row r * m + j, so that the
    gather of these ids is the gather of idx's rows, [E * m, k / m] =
    [E, k]; a padding id gives m ids past the table."""
    if (num_rows + 1) * m > torch.iinfo(torch.int32).max:
        raise ValueError(f"sorted_broadcast: {num_rows} rows of {m} pieces overflow int32 ids")
    r = torch.clamp(idx.long(), max=num_rows) * m
    return (r[:, None] + torch.arange(m, device=idx.device)).flatten().to(torch.int32)


@declares("sorted_broadcast", lambda v, idx, num_rows: gather_cost(
    idx.shape[0], v[0].numel() if v.dim() > 1 else 1, num_rows, v.element_size()))
def _gather(v, idx, num_rows):
    """K7's forward: the plain version for a CPU tensor, else the kernel,
    one counted launch; a row wider than GATHER_ROW_BYTES is gathered as
    _gather_pieces(k) pieces of it (_piece_ids)."""
    if v.device.type == "cpu":
        return sorted_broadcast_plain(v, idx, num_rows)
    v2 = _as_2d("sorted_broadcast", v)
    e, k = idx.shape[0], v2.shape[1]
    dev, _ = _check_launch("sorted_broadcast", v2, idx, e)
    out = torch.empty((e, k), dtype=v2.dtype, device=dev)
    if e > 0:
        m = _gather_pieces(k, v2.element_size())
        ids = idx if m == 1 else _piece_ids(idx, num_rows, m)
        _cuda.launch("row_gather", dev, v2.data_ptr(), ids.data_ptr(), out.data_ptr(),
                     e * m, num_rows * m, k // m * v2.element_size())
        sorted_broadcast.launches += 1
    return out[:, 0] if v.dim() == 1 else out


class Broadcast(torch.autograd.Function):
    """K7 forward; backward ``_bc_bwd``: d v = the K5 segment-sum of the
    output gradient by idx (in the transport dtype, f32 sums), cast to v's
    dtype; padding ids drop out."""

    @staticmethod
    def forward(ctx, v, idx, num_rows, transport, order):
        ctx.save_for_backward(idx)
        ctx.num_rows, ctx.dtype, ctx.transport, ctx.order = num_rows, v.dtype, transport, order
        return _gather(v, idx, num_rows)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        gv = sorted_segment_sum(g.contiguous(), idx, ctx.num_rows, ctx.transport, ctx.order)
        return gv.to(ctx.dtype), None, None, None, None


def sorted_broadcast(v, idx, num_rows, transport="f32", order=None):
    """``out[e] = v[idx[e]]`` for v ``[num_rows]`` or ``[num_rows, K]`` (f32
    or bf16) and int32 idx in any order (block order is the speed contract,
    never the correctness one); ids >= num_rows give zeros.
    An exact copy in v's dtype, differentiable in v (Broadcast; `transport`
    is its backward's, and `order` its backward's walk, as
    sorted_segment_sum's).  Kernel launches counted in
    ``sorted_broadcast.launches``."""
    if v.shape[0] != num_rows:
        raise ValueError(f"sorted_broadcast: v has {v.shape[0]} rows, expected {num_rows}")
    t_dtype_of(transport)  # validate
    return Broadcast.apply(v, idx, num_rows, transport, order)


sorted_broadcast.launches = 0


# ---------------------------------------------------------------- K6


def localized_scatter_add_plain(ct, idx, num_rows, transport="f32"):
    """Plain PyTorch version of localized_scatter_add: ct rounded to the
    transport dtype, summed in f32 by idx; ids >= num_rows dropped."""
    return sorted_segment_sum_plain(ct, idx, num_rows, transport)


@declares("localized_scatter_add", lambda ct, idx, num_rows, transport="f32", order=None:
          scatter_cost(idx.shape[0], ct[0].numel() if ct.dim() > 1 else 1, num_rows,
                       t_dtype_of(transport).itemsize))
def localized_scatter_add(ct, idx, num_rows, transport="f32", order=None):
    """``out[i] = Σ_{idx[e]=i} ct[e]`` for ct ``[E]`` or ``[E, K]`` (f32 or
    bf16, rounded to the transport dtype first) and int32 idx in any order;
    ids >= num_rows are dropped.  Returns f32 ``[num_rows]`` /
    ``[num_rows, K]``.  ``order``: the kernel's walk, (perm, idx[perm])
    sorted by idx (StepGraph.src_perm, src_sorted) for this very ``idx``,
    or None for the edges' own order (_sum_by_id).  Kernel launches counted in
    ``localized_scatter_add.launches``."""
    _refuse_grad("localized_scatter_add", ct)
    ct2 = _as_2d("localized_scatter_add", ct.to(t_dtype_of(transport)))
    if ct2.device.type == "cpu":
        out = localized_scatter_add_plain(ct2, idx, num_rows, transport)
    else:
        out = _sum_by_id(localized_scatter_add, ct2, idx, num_rows, order)
    return out[:, 0] if ct.dim() == 1 else out


localized_scatter_add.launches = 0


# ---------------------------------------------------------------- K8


def softmax_stats_plain(alpha, dst, num_rows):
    """Plain PyTorch version of softmax_stats: f32 ``[num_rows, 2]`` rows
    ``[max | Σ exp(alpha - max)]`` by dst; max -inf (sum 0) for a row with
    no edge; ids >= num_rows dropped."""
    m = segment_max(alpha, dst, num_rows)
    shift = torch.cat([torch.where(torch.isfinite(m), m, torch.zeros_like(m)),
                       m.new_zeros(1)])
    ex = torch.exp(alpha - shift[torch.clamp(dst.long(), max=num_rows)])
    return torch.stack([m, segment_sum(ex, dst, num_rows)], dim=1)


@declares("softmax_stats", lambda alpha, dst, num_rows, block_bounds=None:
          softmax_stats_cost(dst.shape[0], num_rows))
def softmax_stats(alpha, dst, num_rows, block_bounds=None):
    """Per-dst softmax statistics of f32 edge logits ``alpha`` [E] by int32
    ``dst`` [E] (padding ``dst >= num_rows`` dropped): f32 ``[num_rows, 2]``
    rows ``[max | Σ exp(alpha - max)]``, max -inf for a row with no edge.
    The max is exact; the sums are f32 in the kernel's atomic order.

    block_bounds: int32[ceil(num_rows/128)+1], the 128-row dst blocks' edge
    ranges from 0 to E of a block-monotone dst (StepGraph.block_bounds,
    flash_gat.dst_block_bounds), which the kernel needs (one CTA a block)
    and the plain version (any order) does not read.  Kernel launches
    counted in ``softmax_stats.launches``."""
    _refuse_grad("softmax_stats", alpha)
    if alpha.device.type == "cpu":
        return softmax_stats_plain(alpha, dst, num_rows)
    dev, e = alpha.device, dst.shape[0]
    _cuda.require(alpha, "softmax_stats alpha", torch.float32, (e,), dev)
    _cuda.require(dst, "softmax_stats dst", torch.int32, (e,), dev)
    n_blocks = max(1, -(-num_rows // 128))
    if block_bounds is None:
        raise ValueError("softmax_stats: the kernel needs the graph's block bounds (StepGraph)")
    _cuda.require(block_bounds, "softmax_stats block bounds", torch.int32, (n_blocks + 1,),
                  dev)
    out = torch.empty((num_rows, 2), dtype=torch.float32, device=dev)
    if num_rows > 0:
        _cuda.launch("softmax_stats", dev, alpha.data_ptr(), dst.data_ptr(),
                     block_bounds.data_ptr(), out.data_ptr(), e, n_blocks, num_rows)
        softmax_stats.launches += 1
    return out


softmax_stats.launches = 0


class SegmentSoftmax(torch.autograd.Function):
    """``segment_softmax_pallas`` for one head: K8 stats, a K7 gather of
    ``[max | sum]`` per edge (an empty row's -inf max becomes 0,
    ops/pallas_segment.py:359), att = exp(alpha - max) / (sum + 1e-16),
    padding edges forced to 0 (:367).  Backward (:376-391): dalpha =
    att·(g - s[dst]) with s the K5 segment-sum of att·g by dst in the
    transport dtype and s[dst] a K7 gather."""

    @staticmethod
    def forward(ctx, alpha, dst, num_rows, transport, block_bounds, order):
        stats = softmax_stats(alpha, dst, num_rows, block_bounds)
        stats = torch.where(torch.isfinite(stats), stats, torch.zeros_like(stats))
        stats_e = sorted_broadcast(stats, dst, num_rows)
        att = torch.exp(alpha - stats_e[:, 0]) / (stats_e[:, 1] + 1e-16)
        att = torch.where(dst < num_rows, att, torch.zeros_like(att))
        ctx.save_for_backward(att, dst)
        ctx.num_rows, ctx.transport, ctx.order = num_rows, transport, order
        return att

    @staticmethod
    def backward(ctx, g):
        att, dst = ctx.saved_tensors
        s = sorted_segment_sum((att * g)[:, None], dst, ctx.num_rows, ctx.transport, ctx.order)
        s_e = sorted_broadcast(s[:, 0].contiguous(), dst, ctx.num_rows)
        return att * (g - s_e), None, None, None, None, None


def segment_softmax(alpha, dst, num_rows, transport="f32", block_bounds=None, order=None):
    """Per-dst softmax of f32 edge logits ``alpha`` [E] or [E, H] (one K8
    pass per head, as ``segment_softmax_auto`` loops heads) with PyG's
    +1e-16 guard; padding edges (``dst >= num_rows``) get 0.  On the card
    ``dst`` is block-monotone (graph.py's order) and ``block_bounds`` its
    128-row blocks' edge ranges (StepGraph.block_bounds), which K8 needs.
    Differentiable in alpha (SegmentSoftmax; `transport` is its backward's
    segment-sum transport, `order` its walk, as sorted_segment_sum's)."""
    t_dtype_of(transport)  # validate
    alpha = alpha.float()
    if alpha.dim() == 1:
        return SegmentSoftmax.apply(alpha.contiguous(), dst, num_rows, transport, block_bounds,
                                    order)
    return torch.stack([SegmentSoftmax.apply(alpha[:, h].contiguous(), dst, num_rows,
                                             transport, block_bounds, order)
                        for h in range(alpha.shape[1])], dim=1)
