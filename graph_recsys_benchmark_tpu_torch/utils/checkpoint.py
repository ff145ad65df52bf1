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
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save_checkpoint(path, params, optimizer, epoch, rec_metrics):
    """params: an nn.Module; optimizer: its torch.optim.Optimizer;
    rec_metrics: dict of numpy arrays (per-epoch metric history).  Written
    atomically: a crash never truncates `latest`."""
    payload = {
        "epoch": int(epoch),
        "params": params.state_dict(),
        "opt_state": optimizer.state_dict(),
        "rec_metrics": {k: torch.as_tensor(np.asarray(v, dtype=np.float64))
                        for k, v in rec_metrics.items()},
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


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
    payload = torch.load(path, map_location="cpu", weights_only=True)
    params.load_state_dict(payload["params"])
    optimizer.load_state_dict(payload["opt_state"])
    rec = {k: v.numpy() for k, v in payload["rec_metrics"].items()}
    return params, optimizer, payload["epoch"], rec
