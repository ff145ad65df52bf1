"""Optimizer factory with reference parity (utils/general_utils.py:29-37).

Port of the JAX package's ``train/optim.py``.  The JAX package rebuilds
torch's optimizers in optax; here Adam and SGD are torch's own:
``torch.optim.Adam(weight_decay=wd)`` is L2-inside-Adam, grad += wd * param
before the moment updates, which is exactly the JAX chain
``add_decayed_weights`` then ``scale_by_adam`` then ``scale(-lr)``
(train/optim.py:65-72).  Defaults as torch: b1=0.9, b2=0.999, eps=1e-8.

'sparseadam' is ``SparseAdam`` below, a copy of the JAX chain
``scale_by_sparse_adam`` then ``scale(-lr)`` (train/optim.py:16-62, :73-79)
on dense gradients.  ``torch.optim.SparseAdam`` needs sparse gradients and
the port's are dense.
"""

from __future__ import annotations

import functools

import torch


class SparseAdam(torch.optim.Optimizer):
    """torch.optim.SparseAdam's semantics on dense gradients, as the JAX
    ``scale_by_sparse_adam``: a row (the first axis; an element of a 1-D
    parameter) counts as touched when any of its gradient entries is
    nonzero; moments and parameters move only on touched rows, so an
    untouched row stays bitwise as it was (no momentum tail); the bias
    correction uses the global step, which every ``step()`` advances
    whatever a parameter's coverage.  There is no weight decay: the JAX
    chain has none."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                if p.grad is None:  # no gradient: every row untouched
                    continue
                g = p.grad
                # bias corrections in f32, as the JAX chain computes them
                count = torch.tensor(state["step"], dtype=torch.float32)
                bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** count)
                bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** count)
                if g.dim() >= 2:
                    touched = (g != 0).flatten(1).any(dim=1)
                    touched = touched.view((-1,) + (1,) * (g.dim() - 1))
                else:
                    touched = g != 0
                mu, nu = state["exp_avg"], state["exp_avg_sq"]
                mu.copy_(torch.where(touched, b1 * mu + (1.0 - b1) * g, mu))
                nu.copy_(torch.where(touched, b2 * nu + (1.0 - b2) * g * g, nu))
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
                p.add_(torch.where(touched, -group["lr"] * upd, torch.zeros_like(upd)))
        return loss


def make_optimizer(opt: str = "adam", lr: float = 1e-3, weight_decay: float = 0.0):
    """A factory ``params -> torch.optim.Optimizer`` for 'adam', 'sparseadam'
    or 'sgd' (the JAX function returns an optax transformation, which needs
    no parameters to build; a torch optimizer does).  'sparseadam' ignores
    `weight_decay`, as the JAX chain does."""
    opt = opt.lower()
    if opt == "adam":
        return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    if opt == "sparseadam":
        return functools.partial(SparseAdam, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if opt == "sgd":
        return functools.partial(torch.optim.SGD, lr=lr, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {opt!r}")
