"""KGAT / KGCN knowledge-graph baselines.

Port of the JAX package's ``models/kg.py``, which replicates the two-phase
reference models (experiments/kgat_solver_bpr.py, kgcn_solver_bpr.py +
models/kgat.py, kgcn.py):

  graph      : all typed relations + reversed copies with negated relation
               ids (kgat_solver_bpr.py:126-140; graph.build_kg_graph)
  kg phase   : TransR-projected BPR over (h, t_pos, t_neg, r) with corrupted
               tails (kgat_solver_bpr.py:110-124); the reference ranks
               pos_dist - neg_dist through -log sigmoid exactly as written
  attention  : trans_vec = r[|rel|] * sign(rel), sign(0) := 1
               KGAT:  alpha_e = (x_dst P) . tanh(x_src P + trans_vec)
               KGCN:  alpha_e = x_dst . trans_vec
               att = segment_softmax(alpha, dst)   (solver :311-320),
               without gradient
  cf phase   : 3 conv layers with the frozen att, dropout, concat of
               L2-normalized outputs; dot-product predict (models/kgat.py:45-56)

The attention map's softmax is ops/segment_kernels.segment_softmax with the
graph's block bounds (K8, and K7 to gather the stats per edge on the card);
the convs run nn/conv.kgat_apply / kgcn_apply (K7, K5 forward; K7, K6
backward).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..graph import StepGraph
from ..nn import conv as C
from ..nn.init import ParamTree, glorot, uniform
from ..ops.segment_kernels import segment_softmax
from .ngcf import KeepMasks, _dropout, _l2norm
from .pea import _log_sigmoid


@dataclasses.dataclass(frozen=True)
class KGConfig:
    variant: str  # 'kgat' | 'kgcn'
    num_nodes: int
    num_relations: int
    emb_dim: int = 64
    hidden_size: int = 64
    dropout: float = 0.0

    @property
    def emb_rows(self):
        return -(-self.num_nodes // 128) * 128

    @property
    def layer_dims(self):
        h = self.hidden_size
        return [(self.emb_dim, h), (h, h // 2), (h // 2, h // 4)]


class KG(ParamTree):
    """KGAT/KGCN parameters in the JAX layout: ``x [emb_rows, emb]``,
    ``r [num_relations, emb]``, ``proj [emb, emb]``, ``conv1..3``: KGAT
    ``{w_add, w_bi [din, dout], b [dout]}``, KGCN ``{w [din, dout], b}``."""


def kg_init(generator: torch.Generator, cfg: KGConfig) -> KG:
    """Random KGAT/KGCN parameters from `generator` (CPU tensors), the
    distributions of the JAX ``kg_init``."""
    if cfg.variant not in ("kgat", "kgcn"):
        raise ValueError(f"variant {cfg.variant!r}: expected 'kgat' or 'kgcn'")
    bound = math.sqrt(6.0 / (cfg.num_nodes + cfg.emb_dim))
    tree = {
        "x": uniform(generator, (cfg.emb_rows, cfg.emb_dim), bound),
        "r": glorot(generator, (cfg.num_relations, cfg.emb_dim)),
        "proj": glorot(generator, (cfg.emb_dim, cfg.emb_dim)),
    }
    init = C.kgat_init if cfg.variant == "kgat" else C.kgcn_init
    for name, (din, dout) in zip(("conv1", "conv2", "conv3"), cfg.layer_dims):
        tree[name] = init(generator, din, dout)
    return KG(tree)


@torch.no_grad()
def att_logits(model: KG, g: StepGraph, cfg: KGConfig):
    """The attention map's per-edge logits f32 [E_pad] (solver :311-320), 0
    on the padding edges, without gradient (JAX ``stop_gradient``).

    The edge rows x[dst], x[src] are plain indexing.  Padding edges carry
    dst == num_nodes, a row of x only while emb_rows > num_nodes: their ids
    are clamped into the table (JAX clips an out-of-range gather to the
    last row, torch would fault) and their logits set to 0."""
    x, r = model.x, model.r
    dst = torch.clamp(g.dst.long(), max=x.shape[0] - 1)
    rel = g.rel.long()
    sign = torch.where(rel < 0, -1.0, 1.0)  # sign(0) := 1 as in the reference
    trans_vec = r[torch.abs(rel)] * sign[:, None]
    x_dst = x[dst]
    x_src = x[g.src.long()]
    if cfg.variant == "kgat":
        alpha = torch.sum((x_dst @ model.proj)
                          * torch.tanh(x_src @ model.proj + trans_vec), dim=-1)
    else:
        alpha = torch.sum(x_dst * trans_vec, dim=-1)
    return torch.where(g.dst < g.num_nodes, alpha, torch.zeros_like(alpha))


@torch.no_grad()
def compute_att_map(model: KG, g: StepGraph, cfg: KGConfig, transport="f32",
                    softmax=None):
    """Per-edge attention f32 [E_pad] over the signed typed graph: the
    per-dst softmax of att_logits (segment_softmax: K8 and a K7 of the
    stats on the card), 0 on the padding edges, without gradient.
    `softmax(logits, dst, num_rows)` overrides it (the edge-parallel
    softmax over the ranks' shards, JAX models/kg.py:69)."""
    logits = att_logits(model, g, cfg)
    if softmax is not None:
        return softmax(logits, g.dst, g.num_nodes)
    return segment_softmax(logits, g.dst, g.num_nodes, transport,
                           g.block_bounds, (g.dst_perm, g.dst_sorted))


def kg_forward(model: KG, g: StepGraph, cfg: KGConfig, att_map, transport="f32",
               masks: Optional[KeepMasks] = None, aggregate=None):
    """Every node's representation [num_nodes, 7 h / 4] under the frozen
    `att_map`; `masks` (a training forward) drops after each conv at rate
    cfg.dropout; `aggregate` overrides the convs' edge sum (the
    edge-parallel path, JAX models/kg.py:92)."""
    apply = C.kgat_apply if cfg.variant == "kgat" else C.kgcn_apply

    def conv(p, x):
        return apply(p, x, g, att_map, transport=transport, aggregate=aggregate)

    x1 = _dropout(conv(model.conv1, model.x), cfg.dropout, masks, 0)
    x2 = _dropout(conv(model.conv2, x1), cfg.dropout, masks, 1)
    x3 = _dropout(conv(model.conv3, x2), cfg.dropout, masks, 2)
    return torch.cat([_l2norm(x1), _l2norm(x2), _l2norm(x3)], dim=-1)


def kg_predict(model, cached, unids, inids):
    return torch.sum(cached[unids] * cached[inids], dim=-1)


def transr_kg_loss(model: KG, batch, row_mask):
    """TransR BPR over corrupted tails (kgat_solver_bpr.py:110-124); batch
    columns (h, t_pos, t_neg, rel).  Reaches x, r and proj only."""
    proj = model.proj
    h = model.x[batch[:, 0]] @ proj
    pos_t = model.x[batch[:, 1]] @ proj
    neg_t = model.x[batch[:, 2]] @ proj
    r = model.r[batch[:, 3]]
    pos_pred = torch.sum((h + r - pos_t) ** 2, dim=-1)
    neg_pred = torch.sum((h + r - neg_t) ** 2, dim=-1)
    return torch.sum(-_log_sigmoid(pos_pred - neg_pred) * row_mask)


def kg_cf_loss(model: KG, g: StepGraph, cfg: KGConfig, att_map, batch, row_mask,
               transport="f32", masks: Optional[KeepMasks] = None, aggregate=None):
    """Summed BPR over the batch (u, pos, neg) under the frozen `att_map`."""
    cached = kg_forward(model, g, cfg, att_map, transport=transport, masks=masks,
                        aggregate=aggregate)
    pos = kg_predict(model, cached, batch[:, 0], batch[:, 1])
    neg = kg_predict(model, cached, batch[:, 0], batch[:, 2])
    return torch.sum(-_log_sigmoid(pos - neg) * row_mask)
