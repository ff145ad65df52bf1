"""The collectives of the parallel layer, differentiable.

The JAX package's parallel layer runs under ``shard_map(...,
check_vma=False)``.  Its edge mode uses two collectives over the world:
``jax.lax.psum``, whose transpose there is ``psum`` again (the cotangents
of every rank are summed), and ``jax.lax.pmax``, which has no gradient and
is only ever applied to a stopped value
(``parallel/edge_parallel.make_sharded_softmax``).  Here:

  * ``psum(x, mesh)`` — ``PSum``: forward all-reduces the sum over the
    mesh's ranks, backward all-reduces the sum of the cotangents;
  * ``pmax(x, mesh)`` — the all-reduced max, detached;
  * ``all_reduce_grads(params, mesh, extra)`` — the step's one gradient
    exchange: every ``.grad`` (and `extra`, the loss) flattened into one
    buffer per dtype and all-reduced in one call, as gloo pays its latency
    a call.

The row-sharded table (modes 'a2a' and 'dp') adds three over one axis of
the mesh (parallel/mesh.py), each an autograd Function whose backward is
its transpose:

  * ``all_to_all(x, mesh, axis)`` — JAX ``lax.all_to_all(x, axis, 0, 0)``:
    dim 0 split into P equal chunks, chunk p sent to the axis's rank p,
    the chunks that arrive stacked in rank order; backward the same
    exchange of the cotangents;
  * ``all_gather(x, mesh, axis)`` — the tiled gather, [n, ...] -> [P n,
    ...] in rank order; backward the reduce-scatter (sum) of the
    cotangents;
  * ``psum_scatter(x, mesh, axis)`` — the tiled ``lax.psum_scatter(x,
    axis, scatter_dimension=0, tiled=True)``: [P n, ...] summed over the
    ranks, this rank's n rows kept; backward the all-gather.

They call ``all_to_all_single``, ``all_gather_into_tensor`` and
``reduce_scatter_tensor``.  The route is a rule of the backend and the
device, never a fallback: every tensor goes to the backend as it is.
NCCL reads CUDA tensors on the card; gloo serves the three single-tensor
calls on CUDA tensors, staging them through host memory itself (probed on
two ranks sharing an H100, torch 2.11: values right in f32, bf16 and int32;
only the list ``all_to_all`` is refused, which the port does not call),
and CPU tensors directly.  ``route(mesh)`` says which (printed by the
sharded trainers).

A mesh of one rank (or None), or an axis of one rank, makes no call:
every function returns its input.  A failed collective raises.

``STATS`` counts calls and the bytes each rank sends, in all and per
collective (``STATS['ops'][name] = [calls, bytes]``); ``timing(True)``
also synchronizes the device around each call and adds its seconds (an
instrument for one measured step, off by default).
"""

from __future__ import annotations

import contextlib
import hashlib
import time

import torch
import torch.distributed as dist

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "ops": {}}
_TIMING = [False]


def reset_stats():
    STATS.update(calls=0, bytes=0, seconds=0.0, ops={})


@contextlib.contextmanager
def timing():
    """Within the block each call synchronizes the device before and after
    and adds its host seconds to STATS['seconds']."""
    _TIMING[0] = True
    try:
        yield STATS
    finally:
        _TIMING[0] = False


def active(mesh) -> bool:
    """Whether `mesh` spans more than one rank."""
    return mesh is not None and mesh.size > 1


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def all_reduce_(t, mesh, op="sum", axis=None):
    """All-reduce `t` in place over the mesh's ranks, or over the ranks of
    this rank's line along `axis` (op 'sum' or 'max'); `t` must be
    contiguous.  No call on a mesh (or axis) of one."""
    if not active(mesh) or (axis is not None and mesh.axis_size(axis) == 1):
        return t
    if not t.is_contiguous():
        raise ValueError("all_reduce_: the tensor must be contiguous")
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    group = mesh.group if axis is None else mesh.axis_group(axis)
    _call("all_reduce", t, lambda: dist.all_reduce(t, op=red, group=group))
    return t


def _call(name, t, fn):
    """fn(), one collective on `t` (the tensor this rank sends), counted
    in STATS (and timed inside timing())."""
    timed = _TIMING[0]
    if timed:
        _sync(t)
        t0 = time.perf_counter()
    fn()
    if timed:
        _sync(t)
        STATS["seconds"] += time.perf_counter() - t0
    nbytes = t.numel() * t.element_size()
    STATS["calls"] += 1
    STATS["bytes"] += nbytes
    calls, total = STATS["ops"].get(name, (0, 0))
    STATS["ops"][name] = [calls + 1, total + nbytes]


def route(mesh) -> str:
    """How the row-sharded collectives reach the backend on this mesh's
    device (a rule of the backend and the device, no fallback)."""
    if not active(mesh):
        return "a mesh of one rank: no collective"
    backend = dist.get_backend(mesh.group)
    how = {("gloo", "cuda"): "gloo stages them through host memory itself",
           ("nccl", "cuda"): "NCCL reads them on the card",
           ("gloo", "cpu"): "gloo reads them in place"}.get(
        (backend, mesh.device.type), "as the backend serves them")
    return (f"all_to_all_single / all_gather_into_tensor / reduce_scatter_tensor on "
            f"{mesh.device.type} tensors passed to {backend} as they are ({how})")


def _single(op, x, mesh, axis):
    """One single-tensor collective over `axis` of `mesh`: op 'all_to_all'
    (x's shape), 'all_gather' ([P n, ...]) or 'psum_scatter' ([n, ...],
    the sum) of contiguous x; counted in STATS."""
    p = mesh.axis_size(axis)
    x = x.contiguous()
    if op != "all_gather" and x.shape[0] % p:
        raise ValueError(f"{op}: {x.shape[0]} rows do not split over {p} ranks")
    rows = {"all_to_all": x.shape[0], "all_gather": p * x.shape[0],
            "psum_scatter": x.shape[0] // p}[op]
    out = x.new_empty((rows,) + tuple(x.shape[1:]))
    group = mesh.axis_group(axis)
    call = {"all_to_all": lambda: dist.all_to_all_single(out, x, group=group),
            "all_gather": lambda: dist.all_gather_into_tensor(out, x, group=group),
            "psum_scatter": lambda: dist.reduce_scatter_tensor(out, x, group=group)}[op]
    _call(op, x, call)
    return out


# each collective's transpose (JAX's under check_vma=False)
_TRANSPOSE = {"all_to_all": "all_to_all", "all_gather": "psum_scatter",
              "psum_scatter": "all_gather"}


class AxisCollective(torch.autograd.Function):
    """forward(x, op, mesh, axis) -> _single(op, x); backward: the
    transpose collective (_TRANSPOSE) of the cotangent over the same
    axis."""

    @staticmethod
    def forward(ctx, x, op, mesh, axis):
        ctx.op, ctx.mesh, ctx.axis = op, mesh, axis
        return _single(op, x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _single(_TRANSPOSE[ctx.op], g, ctx.mesh, ctx.axis), None, None, None


def _on_axis(op, x, mesh, axis):
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return AxisCollective.apply(x, op, mesh, axis)


def all_to_all(x, mesh, axis="dp"):
    """JAX ``lax.all_to_all(x, axis, 0, 0)`` over `axis` of `mesh`,
    differentiable (its backward the same exchange); x itself on an axis
    of one rank.  Takes any dtype (the lookups send int32 ids)."""
    return _on_axis("all_to_all", x, mesh, axis)


def all_gather(x, mesh, axis="mp"):
    """The tiled all-gather over `axis`: [n, ...] -> [P n, ...] in the
    axis's rank order; backward the reduce-scatter of the cotangents."""
    return _on_axis("all_gather", x, mesh, axis)


def psum_scatter(x, mesh, axis="dp"):
    """The tiled ``lax.psum_scatter(x, axis, scatter_dimension=0,
    tiled=True)``: [P n, ...] summed over the ranks of `axis`, this rank's
    block of n rows; backward the all-gather of the cotangents."""
    return _on_axis("psum_scatter", x, mesh, axis)


class PSum(torch.autograd.Function):
    """forward(x, mesh) -> the sum of x over the ranks; backward: the sum
    of the ranks' cotangents (JAX's transpose of psum under
    check_vma=False)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.mesh), None


def psum(x, mesh):
    """Sum of x over the mesh's ranks, differentiable (PSum); x itself on a
    mesh of one."""
    if not active(mesh):
        return x
    return PSum.apply(x, mesh)


def pmax(x, mesh):
    """Max of x over the mesh's ranks, without gradient; x on a mesh of
    one (the caller stops the gradient, as the JAX package does)."""
    if not active(mesh):
        return x
    with torch.no_grad():
        return all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), mesh,
                           "max")


def all_reduce_grads(params, mesh, extra=None):
    """Sum every parameter's ``.grad`` over the ranks in place: one
    all-reduce per gradient dtype over a flat buffer, `extra` (a 0-dim
    tensor of the first dtype, the loss) riding at its end.  Returns the
    reduced `extra` (or None).  No call on a mesh of one."""
    if not active(mesh):
        return extra
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    out = extra
    for i, (dtype, gs) in enumerate(by_dtype.items()):
        parts = [g.reshape(-1) for g in gs]
        if i == 0 and extra is not None:
            parts.append(extra.detach().reshape(1).to(dtype))
        flat = all_reduce_(torch.cat(parts), mesh)
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        if i == 0 and extra is not None:
            out = flat[off].to(extra.dtype)
    if extra is not None and not by_dtype:
        out = all_reduce_(extra.detach().reshape(1).clone(), mesh)[0]
    return out


# the attribute that marks a row-sharded Parameter: (mesh, axis), rank i of
# the axis holding rows [i S, (i + 1) S) (utils/checkpoint.py gathers it)
ROW_SHARD = "row_shard"


def mark_row_sharded(p, mesh, axis):
    """Mark Parameter `p` as this rank's rows of a table split over `axis`."""
    setattr(p, ROW_SHARD, (mesh, axis))
    return p


def row_sharding(p):
    """(mesh, axis) of a row-sharded Parameter, or None."""
    return getattr(p, ROW_SHARD, None)


@torch.no_grad()
def full_rows(t, mesh, axis):
    """The whole table of which `t` is this rank's rows (an all-gather)."""
    return _single("all_gather", t.detach(), mesh, axis) if mesh.axis_size(axis) > 1 else t


def local_rows(full, mesh, axis):
    """This rank's rows of the whole table `full`."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    per = full.shape[0] // n
    return full[i * per:(i + 1) * per]


def param_digest(params) -> str:
    """sha1 of every parameter's bytes, in order (a bitwise checksum)."""
    h = hashlib.sha1()
    for p in params:
        t = p.detach().contiguous().cpu().reshape(-1)
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def gather_digests(params, mesh):
    """Every rank's param_digest, in rank order (all_gather_object); the
    local one alone on a mesh of one."""
    mine = param_digest(params)
    if not active(mesh):
        return [mine]
    out = [None] * mesh.size
    dist.all_gather_object(out, mine, group=mesh.group)
    return out
