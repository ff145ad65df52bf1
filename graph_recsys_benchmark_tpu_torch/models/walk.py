"""Walk-based scorer: frozen pretrained embedding + 2-layer MLP pair scorer.

Port of the JAX package's ``models/walk.py`` (reference models/walk.py:11-33):
the embedding is the frozen MetaPath2Vec one (a tensor of the trainer, not
a parameter); predict = fc2(relu(fc1([u_repr, i_repr]))); trained with BPR.
No kernel runs: two row gathers and two small matmuls.
"""

from __future__ import annotations

import torch

from ..nn.init import ParamTree, linear, torch_linear_params
from .pea import _log_sigmoid


class Walk(ParamTree):
    """The pair scorer in the JAX layout: ``fc1.{w [2D, D], b [D]}``,
    ``fc2.{w [D, 1], b [1]}``."""


def walk_init(generator: torch.Generator, embedding_dim: int) -> Walk:
    """Random scorer parameters from `generator` (CPU tensors), the
    distributions of the JAX ``walk_init``."""
    return Walk({
        "fc1": torch_linear_params(generator, 2 * embedding_dim, embedding_dim,
                                   glorot_weight=True),
        "fc2": torch_linear_params(generator, embedding_dim, 1, glorot_weight=True),
    })


def walk_predict(params: Walk, embedding, unids, inids):
    z = torch.cat([embedding[unids], embedding[inids]], dim=-1)
    return linear(params.fc2, torch.relu(linear(params.fc1, z)))[..., 0]


def walk_bpr_loss(params: Walk, embedding, batch, row_mask):
    """batch columns: (u, pos item, neg item) node ids."""
    pos = walk_predict(params, embedding, batch[:, 0], batch[:, 1])
    neg = walk_predict(params, embedding, batch[:, 0], batch[:, 2])
    return torch.sum(-_log_sigmoid(pos - neg) * row_mask)
