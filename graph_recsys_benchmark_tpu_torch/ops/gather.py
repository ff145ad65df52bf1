"""Edge gathers with a row-gather forward and a scatter-add or segment-sum
backward.

Port of the JAX package's ``ops/gather.py`` (``gather_rows``, ``gather_src``,
``gather_dst``).
``x[idx]`` is the other half of message passing: ``GatherRows`` runs K7
(``ops/segment_kernels.sorted_broadcast``) forward and K6
(``localized_scatter_add``) backward, both by ``idx``, with no E->E
permutation.  The JAX package's gates around them (65,536 edges,
``GATHER_SPAN_MAX``, ``scatter_fits_vmem``, k <= 128) and its ``ct[perm]``
-> sorted segment-sum fallback are TPU choices and are not copied: on a
CUDA tensor both directions always launch their kernels.

``gather_dst`` is the JAX package's narrow-table branch
(ops/gather.py:104-118): K7 (``sorted_broadcast``) forward and, as its VJP
``_bc_bwd`` (ops/pallas_segment.py:609-619), the K5 segment-sum of the
cotangent by dst, cast to the table's dtype.

Padding edges (src 0, w 0) carry zero cotangent, so their src placement
adds nothing.  The gradient is cast to the primal's dtype, as
``_bwd`` (:82-83) does: bf16 under the bf16 message transport.
"""

from __future__ import annotations

import torch

from .segment_kernels import localized_scatter_add, sorted_broadcast


class GatherRows(torch.autograd.Function):
    """forward(x [N, ...], idx int32[E], transport, order) -> x[idx] [E,
    ...]: K7 on x flattened to [N, K]; backward: K6 of the cotangent
    (reshaped to [E, K], rounded to the transport dtype) by idx, f32, cast
    to x's dtype, walking the edges in `order` (localized_scatter_add's)."""

    @staticmethod
    def forward(ctx, x, idx, transport, order):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype, ctx.transport, ctx.order = x.shape, x.dtype, transport, order
        n = x.shape[0]
        out = sorted_broadcast(x.reshape(n, -1), idx, n)
        return out.reshape((idx.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        n = ctx.shape[0]
        ct2 = ct.reshape(ct.shape[0], -1).contiguous()
        gx = localized_scatter_add(ct2, idx, n, ctx.transport, ctx.order)
        return gx.reshape(ctx.shape).to(ctx.dtype), None, None, None


def gather_rows(x, idx, transport="f32", order=None):
    """x[idx] with the K7 forward and the K6 scatter-add backward; `order`:
    the backward's walk, (perm, idx[perm]) sorted by this very idx, or None
    for the edges' own order (localized_scatter_add's)."""
    return GatherRows.apply(x.contiguous(), idx, transport, order)


def gather_src(x, g, transport="f32"):
    """Per-edge source rows x[g.src] of StepGraph `g`; the backward walks
    the edges by src (g.src_perm), each source's edges one run."""
    return gather_rows(x, g.src, transport, (g.src_perm, g.src_sorted))


def gather_dst(x, g, transport="f32"):
    """Per-edge destination rows x[g.dst] of StepGraph `g` (x: [g.num_nodes]
    or [g.num_nodes, K]; padding edges read zeros), differentiable in x
    through a dst segment-sum (ops/segment_kernels.Broadcast) that walks the
    edges by dst (g.dst_perm), each row's edges one run."""
    return sorted_broadcast(x.contiguous(), g.dst, g.num_nodes, transport,
                            (g.dst_perm, g.dst_sorted))
