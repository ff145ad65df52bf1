"""Neural Factorization Machine over (uid, iid) fields.

Port of the JAX package's ``models/nfm.py``, its native rebuild of the
``torchfm`` NeuralFactorizationMachineModel the reference wraps
(models/nfm.py:10-11; torchfm 0.7.0):

  linear  = w_u[uid] + w_i[iid] + b                     (FeaturesLinear)
  fm      = 0.5 * ((v_u + v_i)^2 - v_u^2 - v_i^2)       (bi-interaction)
          -> BatchNorm1d -> dropout
  mlp     = Linear(d, hidden) -> BN -> ReLU -> dropout -> Linear(hidden, 1)
  score   = linear + mlp(fm)

Item ids are offset by num_users (torchfm's field offset).  Trained with
MSE on 0/1 labels: the reference's NFM overrides the BCE loss with
torch.nn.MSELoss on BCE-style labels (models/nfm.py:21-33).

The BatchNorm running statistics are buffers of the ``NFM`` module, not
parameters: no optimizer and no weight decay reaches them, and they still
go into ``state_dict()``, so a resumed run gets them back.  A training
forward returns the new statistics (momentum 0.1, eps 1e-5, torch's
defaults) and the trainer stores them after the step (``set_state``), as
the JAX engine threads its ``state`` through the scan.  The batch
statistics are masked by ``row_mask`` and the running variance is
unbiased, so this is a function on tensors, not ``nn.BatchNorm1d``, which
would count the padding rows of an epoch's last batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..nn.init import ParamTree, linear, torch_linear_params, uniform
from .ngcf import KeepMasks, _dropout

STATE = ("bn0_mean", "bn0_var", "bn1_mean", "bn1_var")


@dataclasses.dataclass(frozen=True)
class NFMConfig:
    num_users: int
    num_items: int
    emb_dim: int = 64
    hidden_size: int = 64
    dropout: float = 0.3
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5


class NFM(ParamTree):
    """NFM in the JAX layout: the parameters ``emb [n, emb]``, ``lin_w [n,
    1]``, ``bias [1]``, ``bn0_scale``, ``bn0_bias`` ``[emb]``, ``fc1.{w, b}``,
    ``bn1_scale``, ``bn1_bias`` ``[hidden]``, ``fc2.{w, b}``; the buffers
    ``bn0_mean``, ``bn0_var`` ``[emb]``, ``bn1_mean``, ``bn1_var``
    ``[hidden]`` (the JAX tree's ``state``)."""

    def __init__(self, params, state):
        super().__init__(params)
        for k in STATE:
            self.register_buffer(k, state[k])

    def state(self):
        return {k: getattr(self, k) for k in STATE}

    @torch.no_grad()
    def set_state(self, state):
        """Store a training forward's new running statistics."""
        for k in STATE:
            getattr(self, k).copy_(state[k])


def nfm_init(generator: torch.Generator, cfg: NFMConfig) -> NFM:
    """Random NFM parameters from `generator` (CPU tensors) and the initial
    running statistics, the distributions of the JAX ``nfm_init``."""
    n = cfg.num_users + cfg.num_items
    e, h = cfg.emb_dim, cfg.hidden_size
    params = {
        # torchfm FeaturesEmbedding / FeaturesLinear use xavier-uniform
        "emb": uniform(generator, (n, e), math.sqrt(6.0 / (n + e))),
        "lin_w": uniform(generator, (n, 1), math.sqrt(6.0 / (n + 1))),
        "bias": torch.zeros(1),
        "bn0_scale": torch.ones(e),
        "bn0_bias": torch.zeros(e),
        "fc1": torch_linear_params(generator, e, h),
        "bn1_scale": torch.ones(h),
        "bn1_bias": torch.zeros(h),
        "fc2": torch_linear_params(generator, h, 1),
    }
    state = {"bn0_mean": torch.zeros(e), "bn0_var": torch.ones(e),
             "bn1_mean": torch.zeros(h), "bn1_var": torch.ones(h)}
    return NFM(params, state)


def _batchnorm(x, scale, bias, mean, var, row_mask, training, momentum, eps):
    """BatchNorm1d with the padding rows masked out of the batch
    statistics; returns (y, new_mean, new_var), the new ones detached."""
    if training:
        w = row_mask[:, None]
        n = torch.clamp(torch.sum(row_mask), min=1.0)
        mu = torch.sum(x * w, dim=0) / n
        v = torch.sum(((x - mu) ** 2) * w, dim=0) / n
        # torch tracks the unbiased running variance
        unbiased = v * n / torch.clamp(n - 1.0, min=1.0)
        new_mean = (1 - momentum) * mean + momentum * mu.detach()
        new_var = (1 - momentum) * var + momentum * unbiased.detach()
        y = (x - mu) / torch.sqrt(v + eps)
        return y * scale + bias, new_mean, new_var
    y = (x - mean) / torch.sqrt(var + eps)
    return y * scale + bias, mean, var


def nfm_forward(model: NFM, cfg: NFMConfig, uids, iids, row_mask=None, training=False,
                masks: Optional[KeepMasks] = None):
    """Returns (scores [B], the new running statistics): a training forward
    normalizes by the batch's statistics and drops at rate cfg.dropout
    under `masks` (layers 0 and 1); an eval forward uses the running ones."""
    if row_mask is None:
        row_mask = torch.ones(uids.shape[0], dtype=torch.float32, device=uids.device)
    if not training:
        masks = None
    iid_idx = iids + cfg.num_users  # torchfm field offset
    lin = model.lin_w[uids, 0] + model.lin_w[iid_idx, 0] + model.bias[0]

    vu = model.emb[uids]
    vi = model.emb[iid_idx]
    fm = 0.5 * ((vu + vi) ** 2 - vu ** 2 - vi ** 2)
    fm, m0, v0 = _batchnorm(fm, model.bn0_scale, model.bn0_bias, model.bn0_mean,
                            model.bn0_var, row_mask, training, cfg.bn_momentum, cfg.bn_eps)
    fm = _dropout(fm, cfg.dropout, masks, 0)

    h = linear(model.fc1, fm)
    h, m1, v1 = _batchnorm(h, model.bn1_scale, model.bn1_bias, model.bn1_mean,
                           model.bn1_var, row_mask, training, cfg.bn_momentum, cfg.bn_eps)
    h = torch.relu(h)
    h = _dropout(h, cfg.dropout, masks, 1)
    out = linear(model.fc2, h)[:, 0]
    return lin + out, {"bn0_mean": m0, "bn0_var": v0, "bn1_mean": m1, "bn1_var": v1}


def nfm_mse_loss(model: NFM, cfg: NFMConfig, batch, row_mask,
                 masks: Optional[KeepMasks] = None):
    """MSE on 0/1 labels (models/nfm.py:22-27), the mean over the real rows;
    batch columns (u, i, label) with 0-based user and item ids.  Returns
    (loss, the new running statistics)."""
    scores, new_state = nfm_forward(model, cfg, batch[:, 0], batch[:, 1], row_mask,
                                    training=True, masks=masks)
    label = batch[:, 2].float()
    n = torch.clamp(torch.sum(row_mask), min=1.0)
    loss = torch.sum(((scores - label) ** 2) * row_mask) / n
    return loss, new_state
