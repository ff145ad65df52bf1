"""Optimizer factory with reference parity (utils/general_utils.py:29-37).

Port of the JAX package's ``train/optim.py``.  The JAX package rebuilds
torch's optimizers in optax; here they are torch's own:
``torch.optim.Adam(weight_decay=wd)`` is L2-inside-Adam, grad += wd * param
before the moment updates, which is exactly the JAX chain
``add_decayed_weights`` then ``scale_by_adam`` then ``scale(-lr)``
(train/optim.py:65-72).  Defaults as torch: b1=0.9, b2=0.999, eps=1e-8.
The SparseAdam variant (:16-26) is not on the flagship path and is not
ported yet (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import functools

import torch


def make_optimizer(opt: str = "adam", lr: float = 1e-3, weight_decay: float = 0.0):
    """A factory ``params -> torch.optim.Optimizer`` for 'adam' or 'sgd'
    (the JAX function returns an optax transformation, which needs no
    parameters to build; a torch optimizer does)."""
    opt = opt.lower()
    if opt == "adam":
        return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    if opt == "sgd":
        return functools.partial(torch.optim.SGD, lr=lr, weight_decay=weight_decay)
    if opt == "sparseadam":
        raise NotImplementedError("sparseadam is not ported (ROADMAP Queue 1 item 2)")
    raise ValueError(f"unknown optimizer {opt!r}")
