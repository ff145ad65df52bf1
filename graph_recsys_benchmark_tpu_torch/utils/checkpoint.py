"""Checkpointing: params + optimizer state + metric history, resumable.

Port of the JAX package's ``utils/checkpoint.py`` as torch state dicts.  A
checkpoint carries {epoch, params, opt_state, rec_metrics} (reference
utils/general_utils.py:40-124): the module's ``state_dict()``, the
optimizer's ``state_dict()`` (Adam's step, exp_avg and exp_avg_sq per
parameter) and rec_metrics, the per-epoch HR/NDCG/AUC/loss history, so a
resumed run keeps its max-over-epochs summary (solvers.py:296-300).  The
layout is the JAX package's, ``<dir>/run_<n>/{latest,epoch_<k>}.ckpt``.

Everything in the file is a tensor or a plain Python value, so it loads
under ``torch.load(weights_only=True)``: the history goes in as float64
tensors (the float64 numpy arrays of the Solver's history survive
exactly), not as pickled numpy arrays, which that setting refuses.

In a torch.distributed world (parallel/multihost.py) rank 0 is the only
writer, as in the JAX package (its checkpoint.py:25,45); the ranks meet at
a barrier after the write, so none reads a file before it is there.  Every
rank reads on resume.  A replicated parameter is the same on every rank;
a row-sharded one (the 'a2a' and 'dp' modes' table, marked by
parallel/collectives.mark_row_sharded) is all-gathered first, with its
optimizer moments, so that the file holds the whole table whatever the
mesh, and on resume each rank slices its rows back out (the contract of
JAX tests/test_spmd.py:101).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0 of a world, or
    a process outside any."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save_checkpoint(path, params, optimizer, epoch, rec_metrics):
    """params: an nn.Module; optimizer: its torch.optim.Optimizer;
    rec_metrics: dict of numpy arrays (per-epoch metric history).  Written
    atomically: a crash never truncates `latest`.  Only rank 0 of a world
    writes; all ranks then meet at a barrier."""
    from ..parallel.collectives import full_rows

    state, opt_state = _rows_of_sharded(params, optimizer, params.state_dict(),
                                        optimizer.state_dict(), full_rows)
    payload = {
        "epoch": int(epoch),
        "params": state,
        "opt_state": opt_state,
        "rec_metrics": {k: torch.as_tensor(np.asarray(v, dtype=np.float64))
                        for k, v in rec_metrics.items()},
    }
    if is_writer():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def load_checkpoint(path, params, optimizer):
    """Restores `params` (an nn.Module) and `optimizer` in place from `path`
    and returns (params, optimizer, last_epoch, rec_metrics), the history
    as float64 numpy arrays; the templates as they are, epoch 0 and no
    history when no file exists (general_utils.py:87-104).

    The file's tensors are read onto the CPU (``map_location``) and placed
    like the templates, as the JAX package restores onto the templates'
    shardings: the parameters are copied into the module's own tensors on
    its device, and ``Optimizer.load_state_dict`` moves the moments to
    their parameters' device and keeps Adam's step count on the CPU, where
    a fresh Adam keeps it."""
    if not os.path.isfile(path):
        return params, optimizer, 0, None
    from ..parallel.collectives import local_rows

    payload = torch.load(path, map_location="cpu", weights_only=True)
    state, opt_state = _rows_of_sharded(params, optimizer, payload["params"],
                                        payload["opt_state"], local_rows)
    params.load_state_dict(state)
    optimizer.load_state_dict(opt_state)
    rec = {k: v.numpy() for k, v in payload["rec_metrics"].items()}
    return params, optimizer, payload["epoch"], rec


def _rows_of_sharded(params, optimizer, state, opt_state, rows):
    """(state, opt_state) with every row-sharded parameter's entry and its
    optimizer moments (state tensors of its shape but the rows) passed
    through rows(t, mesh, axis): parallel/collectives.full_rows before a
    write, local_rows after a read."""
    from ..parallel.collectives import row_sharding

    for name, p in params.named_parameters():
        how = row_sharding(p)
        if how is not None:
            state[name] = rows(state[name], *how)
    opt_params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(opt_params):
        how = row_sharding(p)
        if how is None or i not in opt_state["state"]:
            continue
        opt_state["state"][i] = {
            k: rows(v, *how) if isinstance(v, torch.Tensor) and v.dim() == p.dim()
            and v.shape[1:] == p.shape[1:] else v
            for k, v in opt_state["state"][i].items()}
    return state, opt_state
