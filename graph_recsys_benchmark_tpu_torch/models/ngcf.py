"""NGCF baseline (reference models/ngcf.py + nn/ngcf_conv.py).

Port of the JAX package's ``models/ngcf.py``: three NGCFConv layers over
the bidirectional user-item interaction graph (graph.build_ngcf_graph),
dropout after each conv, and the final representation the concat of the
three L2-normalized layer outputs; pair score = dot product (ngcf.py:37-48).
The entity-aware regularizer of GraphRecsysModel.loss (base.py:50-76)
applies in training, as in the reference.

Dropout takes its keep masks from a ``KeepMasks`` that the caller hands the
training forward (drawn from the step's generator; the tests hand the JAX
package's own masks), so that no draw hides inside the model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..graph import StepGraph
from ..nn import conv as C
from ..nn.init import ParamTree, uniform
from .pea import _log_sigmoid, entity_reg_loss


class KeepMasks:
    """The keep masks of one training forward's dropout layers.

    ``keep(i, shape, device)`` gives layer i its bool mask, each element
    kept with probability 1 - p, drawn once from `generator` (on its
    device) and replayed after.  A subclass may draw them otherwise
    (``draw``): the tests hand the port the JAX package's masks."""

    def __init__(self, p: float, generator: Optional[torch.Generator] = None):
        self.p = p
        self.generator = generator
        self._drawn: dict = {}

    def keep(self, i, shape, device):
        if i not in self._drawn:
            self._drawn[i] = self.draw(i, tuple(shape)).to(device)
        return self._drawn[i]

    def draw(self, i, shape):
        gen = self.generator
        return torch.rand(shape, generator=gen, device=gen.device) < 1.0 - self.p


def _dropout(x, rate, masks: Optional[KeepMasks], i):
    """Inverted dropout of layer i (JAX ``_dropout``): kept elements scaled
    by 1 / (1 - rate); none without masks or at rate 0."""
    if masks is None or rate <= 0.0:
        return x
    keep = masks.keep(i, x.shape, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _l2norm(x):
    # torch F.normalize(dim=-1) semantics (eps=1e-12)
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=1e-12)


@dataclasses.dataclass(frozen=True)
class NGCFConfig:
    num_nodes: int
    emb_dim: int = 64
    hidden_size: int = 64
    dropout: float = 0.0
    entity_aware: bool = False
    entity_aware_coff: float = 0.1

    @property
    def emb_rows(self):
        return -(-self.num_nodes // 128) * 128

    @property
    def layer_dims(self):
        h = self.hidden_size
        return [(self.emb_dim, h), (h, h // 2), (h // 2, h // 4)]


class NGCF(ParamTree):
    """NGCF parameters in the JAX layout: ``x [emb_rows, emb]``,
    ``conv1..3.{w1, w2} [din, dout]``."""


def ngcf_init(generator: torch.Generator, cfg: NGCFConfig) -> NGCF:
    """Random NGCF parameters from `generator` (CPU tensors), the
    distributions of the JAX ``ngcf_init``."""
    bound = math.sqrt(6.0 / (cfg.num_nodes + cfg.emb_dim))
    tree = {"x": uniform(generator, (cfg.emb_rows, cfg.emb_dim), bound)}
    for name, (din, dout) in zip(("conv1", "conv2", "conv3"), cfg.layer_dims):
        tree[name] = C.ngcf_init(generator, din, dout)
    return NGCF(tree)


def ngcf_forward(model: NGCF, g: StepGraph, cfg: NGCFConfig, transport="f32",
                 masks: Optional[KeepMasks] = None):
    """Every node's representation [num_nodes, 7 h / 4]; `masks` (a training
    forward) drops after each conv at rate cfg.dropout."""
    x1 = _dropout(C.ngcf_apply(model.conv1, model.x, g, transport=transport),
                  cfg.dropout, masks, 0)
    x2 = _dropout(C.ngcf_apply(model.conv2, x1, g, transport=transport), cfg.dropout, masks, 1)
    x3 = _dropout(C.ngcf_apply(model.conv3, x2, g, transport=transport), cfg.dropout, masks, 2)
    return torch.cat([_l2norm(x1), _l2norm(x2), _l2norm(x3)], dim=-1)


def ngcf_predict(model, cached, unids, inids):
    return torch.sum(cached[unids] * cached[inids], dim=-1)


def ngcf_loss(model: NGCF, g: StepGraph, cfg: NGCFConfig, batch, row_mask=None,
              training=True, transport="f32", masks: Optional[KeepMasks] = None):
    """Summed BPR over the batch (u, pos, neg[, entity columns]), plus the
    entity-aware regularizer in training."""
    if row_mask is None:
        row_mask = torch.ones(batch.shape[0], dtype=torch.float32, device=batch.device)
    cached = ngcf_forward(model, g, cfg, transport=transport, masks=masks)
    pos = ngcf_predict(model, cached, batch[:, 0], batch[:, 1])
    neg = ngcf_predict(model, cached, batch[:, 0], batch[:, 2])
    cf = torch.sum(-_log_sigmoid(pos - neg) * row_mask)
    if cfg.entity_aware and training:
        cf = cf + cfg.entity_aware_coff * entity_reg_loss(model.x, batch, row_mask)
    return cf
