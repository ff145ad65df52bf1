"""The all-reduce of the edge-parallel layer, differentiable.

The JAX package's edge mode runs under ``shard_map(..., check_vma=False)``
and uses two collectives: ``jax.lax.psum``, whose transpose there is
``psum`` again (the cotangents of every rank are summed), and
``jax.lax.pmax``, which has no gradient and is only ever applied to a
stopped value (``parallel/edge_parallel.make_sharded_softmax``).  Here:

  * ``psum(x, mesh)`` — ``PSum``: forward all-reduces the sum over the
    mesh's ranks, backward all-reduces the sum of the cotangents;
  * ``pmax(x, mesh)`` — the all-reduced max, detached;
  * ``all_reduce_grads(params, mesh, extra)`` — the step's one gradient
    exchange: every ``.grad`` (and `extra`, the loss) flattened into one
    buffer per dtype and all-reduced in one call, as gloo pays its latency
    a call.

A mesh of one rank (or None) makes no call: every function returns its
input.  A tensor on the card goes to ``torch.distributed.all_reduce`` as
it is: NCCL reads it there, and gloo stages it through host memory
itself (ProcessGroupGloo's CUDA work).  A failed collective raises.

``STATS`` counts calls and bytes; ``timing(True)`` also synchronizes the
device around each call and adds its seconds (an instrument for one
measured step, off by default).
"""

from __future__ import annotations

import contextlib
import hashlib
import time

import torch
import torch.distributed as dist

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}
_TIMING = [False]


def reset_stats():
    STATS.update(calls=0, bytes=0, seconds=0.0)


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


def all_reduce_(t, mesh, op="sum"):
    """All-reduce `t` in place over the mesh's ranks (op 'sum' or 'max');
    `t` must be contiguous.  No call on a mesh of one."""
    if not active(mesh):
        return t
    if not t.is_contiguous():
        raise ValueError("all_reduce_: the tensor must be contiguous")
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    timed = _TIMING[0]
    if timed:
        _sync(t)
        t0 = time.perf_counter()
    dist.all_reduce(t, op=red, group=mesh.group)
    if timed:
        _sync(t)
        STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    return t


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
