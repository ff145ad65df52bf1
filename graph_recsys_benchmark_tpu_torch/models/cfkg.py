"""CFKG: pure translational KG embedding recommender.

Port of the JAX package's ``models/cfkg.py`` (reference models/cfkg.py +
experiments/cfkg_solver_bpr.py).  Trained ONLY on the knowledge-graph
objective over all typed edges with corrupted tails
(cfkg_solver_bpr.py:95-106):

  kg_loss = -( Σ log σ((h+r)·t_pos) + Σ log σ(-(h+r)·t_neg) )

Prediction ranks items by exp(Σ (x_u + r_user2item) ⊙ x_i) (cfkg.py:21-27);
node ids are used directly (MODEL_TYPE='Graph', no offset shifting).  No
kernel runs: every op is a row lookup and a dot product.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..nn.init import ParamTree, glorot, uniform
from .pea import _log_sigmoid


@dataclasses.dataclass(frozen=True)
class CFKGConfig:
    num_nodes: int
    num_relations: int
    user2item_rel: int
    emb_dim: int = 64

    @property
    def emb_rows(self):
        return -(-self.num_nodes // 128) * 128


class CFKG(ParamTree):
    """CFKG parameters in the JAX layout: ``x [emb_rows, emb]``,
    ``r [num_relations, emb]``."""


def cfkg_init(generator: torch.Generator, cfg: CFKGConfig) -> CFKG:
    """Random CFKG parameters from `generator` (CPU tensors), the
    distributions of the JAX ``cfkg_init``."""
    bound = math.sqrt(6.0 / (cfg.num_nodes + cfg.emb_dim))
    return CFKG({
        "x": uniform(generator, (cfg.emb_rows, cfg.emb_dim), bound),
        "r": glorot(generator, (cfg.num_relations, cfg.emb_dim)),
    })


def cfkg_predict(model: CFKG, cfg: CFKGConfig, unids, inids):
    u = model.x[unids]
    i = model.x[inids]
    r = model.r[cfg.user2item_rel]
    return torch.exp(torch.sum((u + r) * i, dim=-1))


def cfkg_kg_loss(model: CFKG, batch, row_mask):
    """batch columns: (h, t_pos, t_neg, rel)."""
    h = model.x[batch[:, 0]]
    pos_t = model.x[batch[:, 1]]
    neg_t = model.x[batch[:, 2]]
    r = model.r[batch[:, 3]]
    pos_sim = torch.sum((h + r) * pos_t, dim=-1)
    neg_sim = torch.sum((h + r) * neg_t, dim=-1)
    return -torch.sum((_log_sigmoid(pos_sim) + _log_sigmoid(-neg_sim)) * row_mask)
