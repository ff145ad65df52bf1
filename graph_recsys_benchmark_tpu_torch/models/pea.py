"""PEAGAT (metapath- and entity-aware GAT recommender): forward and loss.

Port of the JAX package's ``models/pea.py`` for the hybrid GAT plan, which
replicates the reference model family (models/base.py:129-214 +
models/peagat.py):

  * one learned embedding row per HIN node, glorot-initialized over the
    whole table (base.py:156,183),
  * one GAT channel per metapath — a stack of `num_steps` convs with ReLU
    between steps and none after the last (base.py:134-140),
  * channel fusion: 'att' (learned per-channel attention, base.py:201-203),
    'mean', or 'concat', and a multiplicative channel mask for the
    metapath-ablation eval,
  * pair scorer: 2-layer MLP over [u_repr, i_repr] (base.py:208-214).

Per step, the hybrid plan batches channels sharing one edge list through
``ops/batch_gat`` and runs the rest as one union graph through
``ops/flash_gat``; both are differentiable (their backwards are kernels
too).  ``pea_loss`` is BPR plus the entity-aware regularizer
(base.py:43-80).  Attention dropout and the other conv types come in later
slices (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph import StepGraph, fuse_step_graphs
from ..nn.conv import gat_init
from ..nn.init import glorot, linear, torch_linear_params, uniform
from ..ops.batch_gat import MAX_CHANNELS, MAX_KZ, batch_gat_attention
from ..ops.flash_gat import flash_gat_attention_rows


@dataclasses.dataclass(frozen=True)
class PEAConfig:
    conv: str  # 'gat' in this slice
    num_nodes: int
    meta_path_steps: Tuple[int, ...]
    emb_dim: int = 64
    hidden_size: int = 64
    repr_dim: int = 16
    num_heads: int = 1
    channel_aggr: str = "att"  # 'att' | 'mean' | 'concat'
    dropout: float = 0.0  # attention dropout; > 0 in training is not ported
    entity_aware: bool = False
    entity_aware_coff: float = 0.1

    @property
    def num_channels(self):
        return len(self.meta_path_steps)

    @property
    def emb_rows(self):
        """Embedding-table rows padded to 128 (the JAX layout); rows >=
        num_nodes are never read."""
        return -(-self.num_nodes // 128) * 128


def _channel_layer_dims(cfg: PEAConfig, num_steps: int):
    """Per-step (in, out, heads) mirroring peagat.py:14-21; heads always
    concatenate."""
    if num_steps == 1:
        return [(cfg.emb_dim, cfg.repr_dim, 1)]
    h = cfg.num_heads
    dims = [(cfg.emb_dim, cfg.hidden_size, h)]
    for _ in range(num_steps - 2):
        dims.append((cfg.hidden_size * h, cfg.hidden_size, h))
    dims.append((cfg.hidden_size * h, cfg.repr_dim, 1))
    return dims


class PEA(nn.Module):
    """PEA parameters in the JAX package's layout and names:
    ``x [emb_rows, emb]``, ``channels[c][k].{w [din, H*dout],
    att [1, H, 2*dout], b [H*dout]}``, ``att [1, C, R]`` (channel_aggr
    'att' only), ``fc1/fc2.{w [in, out], b [out]}``."""

    def __init__(self, x, channels, fc1, fc2, att=None):
        super().__init__()

        def pdict(d):
            return nn.ParameterDict({k: nn.Parameter(v) for k, v in d.items()})

        self.x = nn.Parameter(x)
        self.channels = nn.ModuleList(
            nn.ModuleList(pdict(layer) for layer in ch) for ch in channels
        )
        self.register_parameter("att", None if att is None else nn.Parameter(att))
        self.fc1 = pdict(fc1)
        self.fc2 = pdict(fc2)


def pea_init(generator: torch.Generator, cfg: PEAConfig) -> PEA:
    """Random PEA parameters from `generator` (CPU tensors; move with
    ``.to(device)``), the distributions of the JAX ``pea_init``."""
    # glorot bound from the TRUE node count (base.py:156,183); rows are
    # padded to emb_rows for the layout only
    bound = math.sqrt(6.0 / (cfg.num_nodes + cfg.emb_dim))
    x = uniform(generator, (cfg.emb_rows, cfg.emb_dim), bound)
    channels = []
    for num_steps in cfg.meta_path_steps:
        channels.append([
            gat_init(generator, din, dout, heads=heads)
            for din, dout, heads in _channel_layer_dims(cfg, num_steps)
        ])
    att = None
    if cfg.channel_aggr == "att":
        att = glorot(generator, (1, cfg.num_channels, cfg.repr_dim))
    fc1_in = 2 * cfg.repr_dim * (cfg.num_channels if cfg.channel_aggr == "concat" else 1)
    fc1 = torch_linear_params(generator, fc1_in, cfg.repr_dim, glorot_weight=True)
    fc2 = torch_linear_params(generator, cfg.repr_dim, 1, glorot_weight=True)
    return PEA(x, channels, fc1, fc2, att=att)


def _stacked_subset_params(model: PEA, step_idx, chans):
    """Stack the step-k conv params of `chans` along a leading C axis."""
    layers = [model.channels[c][step_idx] for c in chans]
    return {k: torch.stack([lp[k] for lp in layers]) for k in ("w", "att", "b")}


def _fused_gat_step(sp, h, g: StepGraph, num_channels, num_nodes, heads,
                    transport):
    """One GAT step of `num_channels` channels over their union graph `g`
    (virtual node space C*N).  h: [N', din] (shared input, step 0) or
    [C, N, din] -> [C, N, H*dout], heads concatenated.  One flash pass per
    head."""
    n_virtual = num_channels * num_nodes
    c_dim = sp["w"].shape[-1] // heads
    head_outs = []
    for hh in range(heads):
        w_h = sp["w"][:, :, hh * c_dim : (hh + 1) * c_dim]
        if h.dim() == 2:
            z3 = torch.einsum("nd,cde->cne", h[:num_nodes], w_h)
        else:
            z3 = torch.einsum("cnd,cde->cne", h, w_h)
        att2 = sp["att"][:, 0, hh]  # [C, 2c]
        a_dst = torch.einsum("cne,ce->cn", z3, att2[:, :c_dim]).reshape(n_virtual)
        a_src = torch.einsum("cne,ce->cn", z3, att2[:, c_dim:]).reshape(n_virtual)
        # the kernel's row-major [z | a_src] table, built directly
        table = torch.cat([z3.reshape(n_virtual, c_dim), a_src[:, None]], dim=1)
        out_h = flash_gat_attention_rows(
            table, a_dst, g.src, g.dst, n_virtual, c_dim, 0.2, transport,
        )
        head_outs.append(out_h.reshape(num_channels, num_nodes, c_dim))
    out = head_outs[0] if heads == 1 else torch.cat(head_outs, dim=-1)
    return out + sp["b"][:, None, :]


@dataclasses.dataclass(frozen=True)
class HybridGATPlan:
    """Build-time channel grouping for the GAT forward.

    Per step: (batched: tuple[(StepGraph, chans)], union: StepGraph | None,
    union_chans: tuple[int, ...]).  Channels sharing one StepGraph are
    batched through ops/batch_gat; the rest run as ONE union graph through
    ops/flash_gat."""

    steps: tuple
    num_channels: int

    def to(self, device) -> "HybridGATPlan":
        steps = tuple(
            (
                tuple((g.to(device), chans) for g, chans in batched),
                None if union is None else union.to(device),
                rest,
            )
            for batched, union, rest in self.steps
        )
        return HybridGATPlan(steps=steps, num_channels=self.num_channels)


def build_hybrid_gat_plan(per_channel_graphs, num_nodes, cfg: PEAConfig):
    """Group channels by StepGraph identity (graph.build_metapath_graphs
    dedupes identical step edge lists) into batched shares of 2..8
    channels; singleton graphs, multi-head steps and shares past the
    kernel's limits (8 channels, kz 125) go into one union graph per step.

    The JAX package also gates a share on its TPU VMEM budget; that rule
    means nothing on the H100 and is dropped.  The `max_per` split is kept
    so that both packages build the same plan."""
    if cfg.conv != "gat" or len(set(cfg.meta_path_steps)) != 1:
        raise NotImplementedError(
            "the hybrid plan needs GAT channels of one depth (other paths: "
            "ROADMAP Queue 1 item 3)"
        )
    num_steps = cfg.meta_path_steps[0]
    dims = _channel_layer_dims(cfg, num_steps)
    steps = []
    for k in range(num_steps):
        _, dout, heads = dims[k]
        groups_d: dict = {}
        for c, ch_graphs in enumerate(per_channel_graphs):
            groups_d.setdefault(id(ch_graphs[k]), []).append(c)
        batched, rest = [], []
        max_per = min(MAX_CHANNELS, max(2, 128 // (dout + 1)))
        for chans in groups_d.values():
            g = per_channel_graphs[chans[0]][k]
            for i in range(0, len(chans), max_per):
                sub = chans[i : i + max_per]
                if len(sub) >= 2 and heads == 1 and dout <= MAX_KZ:
                    batched.append((g, tuple(sub)))
                else:
                    rest.extend(sub)
        rest = sorted(rest)
        union = None
        if rest:
            union = fuse_step_graphs([per_channel_graphs[c][k] for c in rest], num_nodes)
        steps.append((tuple(batched), union, tuple(rest)))
    return HybridGATPlan(steps=tuple(steps), num_channels=len(per_channel_graphs))


def pea_forward_hybrid(model: PEA, plan: HybridGATPlan, cfg: PEAConfig,
                       transport="f32"):
    """Batched shared-edge passes for grouped channels, one union flash pass
    for the rest -> [N, C, R]."""
    n = cfg.num_nodes
    num_steps = cfg.meta_path_steps[0]
    dims = _channel_layer_dims(cfg, num_steps)
    n_chan = plan.num_channels
    hs = [None] * n_chan  # step 0 reads the shared embedding table
    for k in range(num_steps):
        _, dout, heads = dims[k]
        batched, union, rest = plan.steps[k]
        new_hs: list = [None] * n_chan
        for g, chans in batched:
            sp = _stacked_subset_params(model, k, chans)
            att = sp["att"][:, 0, 0]  # [Cg, 2*dout] (one head)
            if k == 0:
                z = torch.einsum("nd,cde->cne", model.x[:n], sp["w"])
            else:
                hstack = torch.stack([hs[c] for c in chans])
                z = torch.einsum("cnd,cde->cne", hstack, sp["w"])
            a_dst = torch.einsum("cne,ce->cn", z, att[:, :dout])
            a_src = torch.einsum("cne,ce->cn", z, att[:, dout:])
            outb = batch_gat_attention(z, a_src, a_dst, g.src, g.dst, n, 0.2, transport)
            outb = outb + sp["b"][:, None, :]
            for i, c in enumerate(chans):
                new_hs[c] = outb[i]
        if union is not None:
            sp = _stacked_subset_params(model, k, rest)
            h_in = model.x if k == 0 else torch.stack([hs[c] for c in rest])
            out_u = _fused_gat_step(sp, h_in, union, len(rest), n, heads, transport)
            for i, c in enumerate(rest):
                new_hs[c] = out_u[i]
        if k < num_steps - 1:
            new_hs = [torch.relu(h) for h in new_hs]
        hs = new_hs
    return torch.stack(hs, dim=1)  # [N, C, R]


def pea_forward(model: PEA, plan, cfg: PEAConfig,
                channel_mask: Optional[torch.Tensor] = None, transport="f32"):
    """Full-graph forward -> cached representation [num_nodes, repr-like]."""
    if not isinstance(plan, HybridGATPlan):
        raise NotImplementedError(
            "only the hybrid GAT plan is ported; the fused, grouped-stream "
            "and per-channel forwards are ROADMAP Queue 1 items 3 and 8"
        )
    h = pea_forward_hybrid(model, plan, cfg, transport)
    if channel_mask is not None:
        h = h * channel_mask[None, :, None]
    if cfg.channel_aggr == "concat":
        return h.reshape(h.shape[0], -1)
    if cfg.channel_aggr == "mean":
        return h.mean(dim=1)
    if cfg.channel_aggr == "att":
        atts = torch.softmax(torch.sum(h * model.att, dim=-1), dim=-1)
        return torch.sum(h * atts[..., None], dim=1)
    raise ValueError(cfg.channel_aggr)


def pea_predict(model: PEA, cached_repr, unids, inids):
    """2-layer MLP pair scorer (base.py:208-214) -> float[B]."""
    z = torch.cat([cached_repr[unids], cached_repr[inids]], dim=-1)
    z = torch.relu(linear(model.fc1, z))
    return linear(model.fc2, z)[..., 0]


def _log_sigmoid(z):
    # numerically stable log σ(z) = -softplus(-z)
    return -F.softplus(-z)


def entity_reg_loss(x_table, batch, row_mask):
    """Entity-aware contrastive regularizer, exactly as base.py:50-76.

    batch columns: [u, pos_i, neg_i, pos_item_ent, neg_item_ent, item_mask,
                    pos_user_ent, neg_user_ent, user_mask]."""

    def sq(a, b):
        d = x_table[a] - x_table[b]
        return torch.sum(d * d, dim=-1)

    item_pos = sq(batch[:, 1], batch[:, 3])
    item_neg = sq(batch[:, 1], batch[:, 4])
    user_pos = sq(batch[:, 0], batch[:, 6])
    user_neg = sq(batch[:, 0], batch[:, 7])
    item_term = -_log_sigmoid((item_pos - item_neg) * batch[:, 5])
    user_term = -_log_sigmoid((user_pos - user_neg) * batch[:, 8])
    return torch.sum((item_term + user_term) * row_mask)


def pea_loss(model: PEA, plan, cfg: PEAConfig, batch, row_mask=None,
             transport="f32"):
    """Training loss: BPR with the optional entity-aware regularizer
    (base.py:43-80).

    batch: int64[B, 3] or [B, 9] (entity-aware columns, see
    entity_reg_loss); row_mask: float[B], 0 for the padding rows of an
    epoch's last batch."""
    if cfg.dropout > 0.0:
        raise NotImplementedError(
            "attention dropout in training runs the per-channel path in the "
            "JAX package, which is not ported (ROADMAP Queue 1 item 3)"
        )
    if row_mask is None:
        row_mask = torch.ones(batch.shape[0], dtype=torch.float32, device=batch.device)
    cached = pea_forward(model, plan, cfg, transport=transport)
    pos = pea_predict(model, cached, batch[:, 0], batch[:, 1])
    neg = pea_predict(model, cached, batch[:, 0], batch[:, 2])
    cf_loss = torch.sum(-_log_sigmoid(pos - neg) * row_mask)
    if cfg.entity_aware:
        reg = entity_reg_loss(model.x, batch, row_mask)
        return cf_loss + cfg.entity_aware_coff * reg
    return cf_loss
