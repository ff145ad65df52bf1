"""PEA (metapath- and entity-aware GNN recommenders): PEAGCN, PEAGAT and
PEASage, forward and loss.

Port of the JAX package's ``models/pea.py``, which replicates the reference
model family (models/base.py:129-214 + models/peagcn.py / peagat.py /
peasage.py):

  * one learned embedding row per HIN node, glorot-initialized over the
    whole table (base.py:156,183),
  * one channel per metapath — a stack of `num_steps` convs with ReLU
    between steps and none after the last (base.py:134-140),
  * channel fusion: 'att' (learned per-channel attention, base.py:201-203),
    'mean', or 'concat', and a multiplicative channel mask for the
    metapath-ablation eval,
  * pair scorer: 2-layer MLP over [u_repr, i_repr] (base.py:208-214).

``pea_forward`` dispatches on the graph object, as the JAX package does:

  * a ``HybridGATPlan`` (GAT): per step, channels sharing one edge list run
    batched through ``ops/batch_gat`` and the rest as one union graph
    through ``ops/flash_gat``;
  * a tuple of union ``StepGraph``s, one per step
    (graph.build_fused_metapath_graphs): every channel advances together,
    one row gather (``ops/gather``, K7 forward / K6 backward) and one
    segment-sum (``nn/conv._aggregate``, K5 forward / K7 backward) a step.
    This is PEAGCN's and PEASage's path; GAT runs its union flash pass;
  * per-channel graphs (tuple[channel] of tuple[step]) of GAT channels of
    one depth: the grouped forward (``_grouped_gat_forward``), which the
    trainer picks when a graph carries implicit self-loops (ML-25M scale)
    or ``cfg.fused`` is off.  Channels sharing a `gat_loops` graph run
    batched through ``ops/stream_gat``; every other conv runs
    ``nn/conv.gat_apply``;
  * per-channel graphs otherwise (GCN and SAGE, or metapaths of mixed
    depth): the ungrouped forward (``_channel_forward``, JAX
    models/pea.py:115-137, :571-580), one conv a channel and step
    (``nn/conv.gcn_apply`` / ``sage_apply``: K7 and K5 forward, K6 and K7
    backward; ``gat_apply``: the composed GAT, K7, K8, K5 and K6).

Every op on the way is differentiable and its backward a kernel too.
``pea_loss`` is BPR plus the entity-aware regularizer (base.py:43-80).

GAT attention dropout (``cfg.dropout``) takes its keep masks from the
caller: ``pea_loss(..., masks=DropoutMasks(p, generator))``.  A training
forward with masks runs the per-channel graphs (a HybridGATPlan's
``per_channel``) through the grouped forward with nothing batched, each
conv with its own masks (``nn/conv.gat_apply``: the composed convs drop
the normalized alphas; a `gat_loops` graph runs
``ops/stream_gat.stream_gat_reference`` per head, never the streaming
kernels), as the JAX package does (models/pea.py:338-396, :555-558).  An
eval forward never drops.  A GAT channel on the ungrouped forward takes
its masks the same way, per channel, step and head.  On union graphs
(the fused forward, which the 'dp' mode trains) each GAT step takes one
[E_union, heads] mask (``DropoutMasks.union``) and leaves the flash route
for the composed one (JAX models/pea.py:193-202, :250-275); GCN and SAGE
ignore the masks, as JAX ignores the key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph import StepGraph, fuse_step_graphs
from ..nn.conv import (
    composed_attention,
    gat_apply,
    gat_init,
    gcn_apply,
    gcn_init,
    propagate,
    sage_apply,
    sage_init,
)
from ..nn.init import glorot, linear, torch_linear_params, uniform
from ..ops.batch_gat import MAX_CHANNELS, MAX_KZ, batch_gat_attention
from ..ops.config import FlashGATMode
from ..ops.flash_gat import flash_gat_attention_rows
from ..ops.stream_gat import stream_gat_attention_batched, stream_gat_enabled


class DropoutMasks:
    """The keep masks of GAT attention dropout for one training forward.

    ``gat(c, k, g, heads)`` gives channel c's step-k conv over graph g its
    masks: a composed graph's bool [E, heads] (one per edge and head, the
    padding edges included), a `gat_loops` graph's tuple of one
    ``(edge_keep [E], loop_keep [N])`` pair a head.  ``union(k, g, heads)``
    gives union step k's (every channel over one union graph g) its bool
    [E, heads], drawn as ``draw(None, k, g, heads)``.  Here they are drawn
    from `generator` (on its device), each kept with probability 1 - p;
    a conv's masks are drawn once, so the same object replays them, on
    another device through ``to``.  A subclass may draw them otherwise
    (``draw``): the tests hand the port the JAX package's own masks."""

    def __init__(self, p: float, generator: Optional[torch.Generator] = None):
        self.p = p
        self.generator = generator
        self._drawn: dict = {}

    def gat(self, c, k, g: StepGraph, heads):
        if (c, k) not in self._drawn:
            self._drawn[(c, k)] = self.draw(c, k, g, heads)
        return self._drawn[(c, k)]

    def union(self, k, g: StepGraph, heads):
        return self.gat(None, k, g, heads)

    def draw(self, c, k, g: StepGraph, heads):
        gen = self.generator

        def keep(*shape):
            return torch.rand(shape, generator=gen, device=gen.device) < 1.0 - self.p

        num_edges = g.dst.shape[0]
        if g.gat_loops:
            return tuple((keep(num_edges), keep(g.num_nodes)) for _ in range(heads))
        return keep(num_edges, heads)

    def to(self, device) -> "DropoutMasks":
        """The masks drawn so far, on `device` (nothing more is drawn)."""
        out = DropoutMasks(self.p)
        for key, m in self._drawn.items():
            if isinstance(m, torch.Tensor):
                out._drawn[key] = m.to(device)
            else:
                out._drawn[key] = tuple((e.to(device), l.to(device)) for e, l in m)
        return out


def step_masks(cfg, generator: Optional[torch.Generator]) -> Optional[DropoutMasks]:
    """A training step's keep masks: DropoutMasks(cfg.dropout, generator)
    for a GAT with cfg.dropout > 0, else None (also without a generator,
    as the JAX loss without a dropout key)."""
    if cfg.conv == "gat" and cfg.dropout > 0.0 and generator is not None:
        return DropoutMasks(cfg.dropout, generator)
    return None


@dataclasses.dataclass(frozen=True)
class PEAConfig:
    conv: str  # 'gcn' | 'gat' | 'sage'
    num_nodes: int
    meta_path_steps: Tuple[int, ...]
    emb_dim: int = 64
    hidden_size: int = 64
    repr_dim: int = 16
    num_heads: int = 1  # GAT only
    channel_aggr: str = "att"  # 'att' | 'mean' | 'concat'
    dropout: float = 0.0  # GAT attention dropout (training with DropoutMasks)
    entity_aware: bool = False
    entity_aware_coff: float = 0.1
    # channels of one depth share union graphs (GCN, SAGE) or the hybrid
    # plan (GAT); False runs the per-channel graphs (PEATrainer)
    fused: bool = True

    @property
    def num_channels(self):
        return len(self.meta_path_steps)

    @property
    def emb_rows(self):
        """Embedding-table rows padded to 128 (the JAX layout); rows >=
        num_nodes are never read."""
        return -(-self.num_nodes // 128) * 128


def _channel_layer_dims(cfg: PEAConfig, num_steps: int):
    """Per-step (in, out, heads) mirroring peagcn/peagat/peasage.py:14-21;
    heads (GAT only) always concatenate."""
    if num_steps == 1:
        return [(cfg.emb_dim, cfg.repr_dim, 1)]
    h = cfg.num_heads if cfg.conv == "gat" else 1
    dims = [(cfg.emb_dim, cfg.hidden_size, h)]
    for _ in range(num_steps - 2):
        dims.append((cfg.hidden_size * h, cfg.hidden_size, h))
    dims.append((cfg.hidden_size * h, cfg.repr_dim, 1))
    return dims


class PEA(nn.Module):
    """PEA parameters in the JAX package's layout and names:
    ``x [emb_rows, emb]``; ``channels[c][k]``, one conv layer a step:
    GAT ``{w [din, H*dout], att [1, H, 2*dout], b [H*dout]}``, GCN
    ``{w [din, dout], b [dout]}``, SAGE ``{w_rel [din, dout], b_rel [dout],
    w_root [din, dout]}``; ``att [1, C, R]`` (channel_aggr 'att' only);
    ``fc1/fc2.{w [in, out], b [out]}``."""

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


_INITS = {"gcn": gcn_init, "gat": gat_init, "sage": sage_init}


def pea_init(generator: torch.Generator, cfg: PEAConfig) -> PEA:
    """Random PEA parameters from `generator` (CPU tensors; move with
    ``.to(device)``), the distributions of the JAX ``pea_init``."""
    if cfg.conv not in _INITS:
        raise ValueError(f"conv {cfg.conv!r}: expected one of {sorted(_INITS)}")
    # glorot bound from the TRUE node count (base.py:156,183); rows are
    # padded to emb_rows for the layout only
    bound = math.sqrt(6.0 / (cfg.num_nodes + cfg.emb_dim))
    x = uniform(generator, (cfg.emb_rows, cfg.emb_dim), bound)
    channels = []
    for num_steps in cfg.meta_path_steps:
        layers = []
        for din, dout, heads in _channel_layer_dims(cfg, num_steps):
            if cfg.conv == "gat":
                layers.append(gat_init(generator, din, dout, heads=heads))
            else:
                layers.append(_INITS[cfg.conv](generator, din, dout))
        channels.append(layers)
    att = None
    if cfg.channel_aggr == "att":
        att = glorot(generator, (1, cfg.num_channels, cfg.repr_dim))
    fc1_in = 2 * cfg.repr_dim * (cfg.num_channels if cfg.channel_aggr == "concat" else 1)
    fc1 = torch_linear_params(generator, fc1_in, cfg.repr_dim, glorot_weight=True)
    fc2 = torch_linear_params(generator, cfg.repr_dim, 1, glorot_weight=True)
    return PEA(x, channels, fc1, fc2, att=att)


def _stacked_step_params(model: PEA, step_idx, chans=None):
    """Stack the step-k conv params of `chans` (default: every channel)
    along a leading C axis."""
    if chans is None:
        chans = range(len(model.channels))
    layers = [model.channels[c][step_idx] for c in chans]
    return {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}


def _fused_gcn_step(sp, h, g: StepGraph, num_channels, num_nodes, transport,
                    aggregate=None):
    """One GCN step of every channel over their union graph `g` (virtual
    node space C*N).  h: [N', din] (shared input, step 0) or [C, N, din] ->
    [C, N, dout].  Under bf16 the message is the bf16 product of bf16 w and
    bf16 z_src, summed in f32.  `aggregate(msgs, g, transport)` overrides
    the edge sum (the edge-parallel path sums the ranks' partials,
    parallel/edge_parallel.py)."""
    if h.dim() == 2:
        z = torch.einsum("nd,cde->cne", h[:num_nodes], sp["w"])
    else:
        z = torch.einsum("cnd,cde->cne", h, sp["w"])
    out = propagate(z.reshape(num_channels * num_nodes, -1), g, transport, aggregate)
    return out.reshape(num_channels, num_nodes, -1) + sp["b"][:, None, :]


def _fused_sage_step(sp, h, g: StepGraph, num_channels, num_nodes, transport,
                     aggregate=None):
    """One SAGE step: the mean of the (transport-rounded) source rows, then
    w_rel and b_rel, plus the root term from the un-rounded input;
    `aggregate` as _fused_gcn_step's."""
    if h.dim() == 2:
        hc = h[None, :num_nodes].expand((num_channels,) + h[:num_nodes].shape)
    else:
        hc = h
    mean_agg = propagate(hc.reshape(num_channels * num_nodes, -1), g, transport, aggregate)
    mean_agg = mean_agg.reshape(num_channels, num_nodes, -1)
    out = torch.einsum("cnd,cde->cne", mean_agg, sp["w_rel"]) + sp["b_rel"][:, None, :]
    return out + torch.einsum("cnd,cde->cne", hc, sp["w_root"])


def _fused_gat_step(sp, h, g: StepGraph, num_channels, num_nodes, heads,
                    transport, flash_mode=FlashGATMode(), aggregate=None, softmax=None,
                    keep=None, dropout=0.0):
    """One GAT step of `num_channels` channels over their union graph `g`
    (virtual node space C*N).  h: [N', din] (shared input, step 0) or
    [C, N, din] -> [C, N, H*dout], heads concatenated.  One flash pass per
    head, on the routes of `flash_mode`; with an `aggregate` or `softmax`
    override (the edge-parallel path) or attention dropout's `keep` mask
    [E, heads] (a training step with dropout at rate `dropout`) the
    edge-materialized route instead (_edge_gat_step: K7, K8, K5 and K6),
    as JAX leaves its flash route when overridden or dropout_active (JAX
    models/pea.py:188-202, :250-275)."""
    if aggregate is not None or softmax is not None or keep is not None:
        return _edge_gat_step(sp, h, g, num_channels, num_nodes, heads, transport,
                              aggregate, softmax, keep, dropout)
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
            table, a_dst, g.src, g.dst, n_virtual, c_dim, 0.2, transport, flash_mode,
            g.src_perm, g.src_sorted, g.dst_perm, g.dst_sorted,
        )
        head_outs.append(out_h.reshape(num_channels, num_nodes, c_dim))
    out = head_outs[0] if heads == 1 else torch.cat(head_outs, dim=-1)
    return out + sp["b"][:, None, :]


def _edge_gat_step(sp, h, g: StepGraph, num_channels, num_nodes, heads, transport,
                   aggregate=None, softmax=None, keep=None, dropout=0.0):
    """The edge-materialized union GAT step (JAX ``_fused_gat_step``'s
    overridden or dropout route): nn/conv.composed_attention over the union
    graph with the `softmax` and `aggregate` hooks -> [C, N, H*dout] + b.
    Under `keep` the alphas, normalized over the un-dropped logits, are
    dropped and the kept ones scaled by 1 / (1 - dropout), with no
    renormalizing, before the transport cast (JAX models/pea.py:268-272)."""
    n_virtual = num_channels * num_nodes
    c_dim = sp["w"].shape[-1] // heads
    if h.dim() == 2:
        z = torch.einsum("nd,cde->cne", h[:num_nodes], sp["w"])
    else:
        z = torch.einsum("cnd,cde->cne", h, sp["w"])
    z = z.reshape(num_channels, num_nodes, heads, c_dim)
    att = sp["att"][:, 0]  # [C, H, 2c]
    a_dst = torch.sum(z * att[:, None, :, :c_dim], dim=-1).reshape(n_virtual, heads)
    a_src = torch.sum(z * att[:, None, :, c_dim:], dim=-1).reshape(n_virtual, heads)
    out = composed_attention(z.reshape(n_virtual, heads, c_dim), a_src, a_dst, g, 0.2,
                             transport, keep, dropout, softmax=softmax, aggregate=aggregate)
    return out.reshape(num_channels, num_nodes, heads * c_dim) + sp["b"][:, None, :]


@dataclasses.dataclass(frozen=True)
class HybridGATPlan:
    """Build-time channel grouping for the GAT forward.

    Per step: (batched: tuple[(StepGraph, chans)], union: StepGraph | None,
    union_chans: tuple[int, ...]).  Channels sharing one StepGraph are
    batched through ops/batch_gat; the rest run as ONE union graph through
    ops/flash_gat.  `per_channel` keeps the ungrouped graphs (tuple[channel]
    of tuple[step]) for a training forward with attention dropout."""

    steps: tuple
    per_channel: tuple
    num_channels: int

    def to(self, device) -> "HybridGATPlan":
        moved = {}

        def move(g):
            if id(g) not in moved:
                moved[id(g)] = g.to(device)
            return moved[id(g)]

        per_channel = tuple(tuple(move(g) for g in ch) for ch in self.per_channel)
        steps = tuple(
            (
                tuple((move(g), chans) for g, chans in batched),
                None if union is None else union.to(device),
                rest,
            )
            for batched, union, rest in self.steps
        )
        return HybridGATPlan(steps=steps, per_channel=per_channel,
                             num_channels=self.num_channels)


def build_hybrid_gat_plan(per_channel_graphs, num_nodes, cfg: PEAConfig):
    """Group channels by StepGraph identity (graph.build_metapath_graphs
    dedupes identical step edge lists) into batched shares of 2..8
    channels; singleton graphs, multi-head steps and shares past the
    kernel's limits (8 channels, kz 125) go into one union graph per step.

    The JAX package also gates a share on its TPU VMEM budget; that rule
    means nothing on the H100 and is dropped.  The `max_per` split is kept
    so that both packages build the same plan."""
    if cfg.conv != "gat" or len(set(cfg.meta_path_steps)) != 1:
        raise ValueError(
            "the hybrid plan needs GAT channels of one depth: GCN and SAGE take "
            "graph.build_fused_metapath_graphs, mixed depths the per-channel "
            "graphs (graph.build_metapath_graphs) and pea_forward's ungrouped forward"
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
    return HybridGATPlan(steps=tuple(steps), per_channel=tuple(per_channel_graphs),
                         num_channels=len(per_channel_graphs))


def pea_forward_hybrid(model: PEA, plan: HybridGATPlan, cfg: PEAConfig,
                       transport="f32", flash_mode=FlashGATMode()):
    """Batched shared-edge passes for grouped channels, one union flash pass
    (on the routes of `flash_mode`) for the rest -> [N, C, R]."""
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
            sp = _stacked_step_params(model, k, chans)
            att = sp["att"][:, 0, 0]  # [Cg, 2*dout] (one head)
            if k == 0:
                z = torch.einsum("nd,cde->cne", model.x[:n], sp["w"])
            else:
                hstack = torch.stack([hs[c] for c in chans])
                z = torch.einsum("cnd,cde->cne", hstack, sp["w"])
            a_dst = torch.einsum("cne,ce->cn", z, att[:, :dout])
            a_src = torch.einsum("cne,ce->cn", z, att[:, dout:])
            outb = batch_gat_attention(z, a_src, a_dst, g.src, g.dst, n, 0.2, transport,
                                       g.src_perm, g.src_sorted, g.dst_perm, g.dst_sorted)
            outb = outb + sp["b"][:, None, :]
            for i, c in enumerate(chans):
                new_hs[c] = outb[i]
        if union is not None:
            sp = _stacked_step_params(model, k, rest)
            h_in = model.x if k == 0 else torch.stack([hs[c] for c in rest])
            out_u = _fused_gat_step(sp, h_in, union, len(rest), n, heads, transport,
                                    flash_mode)
            for i, c in enumerate(rest):
                new_hs[c] = out_u[i]
        if k < num_steps - 1:
            new_hs = [torch.relu(h) for h in new_hs]
        hs = new_hs
    return torch.stack(hs, dim=1)  # [N, C, R]


def pea_forward_fused(model: PEA, fused_graphs, cfg: PEAConfig, transport="f32",
                      flash_mode=FlashGATMode(), aggregate=None, softmax=None,
                      masks: Optional[DropoutMasks] = None):
    """All channels advance together over one union graph a step
    (graph.build_fused_metapath_graphs): per step one batched einsum and one
    union aggregation -> [N, C, R].  `aggregate(msgs, g, transport)` and
    `softmax(alpha, dst, num_rows)` override the edge sum and the GAT
    softmax (the edge-parallel path over one rank's shards of the union
    graphs, parallel/edge_parallel.py; GAT then takes the edge-materialized
    route, _edge_gat_step).  `masks`: GAT step k drops attention under
    masks.union(k, g, heads) on that route too (JAX keys it fold_in(key,
    k), models/pea.py:309-310); GCN and SAGE ignore them."""
    n = cfg.num_nodes
    num_steps = cfg.meta_path_steps[0]
    dims = _channel_layer_dims(cfg, num_steps)
    h = model.x
    for k in range(num_steps):
        sp = _stacked_step_params(model, k)
        g = fused_graphs[k]
        if cfg.conv == "gcn":
            h = _fused_gcn_step(sp, h, g, cfg.num_channels, n, transport, aggregate)
        elif cfg.conv == "sage":
            h = _fused_sage_step(sp, h, g, cfg.num_channels, n, transport, aggregate)
        elif cfg.conv == "gat":
            heads = dims[k][2]
            keep = None if masks is None else masks.union(k, g, heads)
            h = _fused_gat_step(sp, h, g, cfg.num_channels, n, heads, transport,
                                flash_mode, aggregate, softmax, keep, cfg.dropout)
        else:
            raise ValueError(cfg.conv)
        if k < num_steps - 1:
            h = torch.relu(h)
    return h.permute(1, 0, 2)  # [N, C, R]


def _grouped_gat_forward(model: PEA, graphs, cfg: PEAConfig, transport="f32",
                         masks: Optional[DropoutMasks] = None):
    """Per-channel GAT forward (models/pea.py:323-411) that batches the
    channels sharing one `gat_loops` step graph (graph.build_metapath_graphs
    dedupes identical lists, so object identity is the key) through one
    streaming pass, in chunks of at most 8; every other conv runs
    nn/conv.gat_apply on its channel's graph -> [N, C, R].  With dropout
    `masks` nothing batches: every conv runs gat_apply with its own."""
    n = cfg.num_nodes
    num_steps = cfg.meta_path_steps[0]
    dims = _channel_layer_dims(cfg, num_steps)
    n_chan = cfg.num_channels
    hs = [model.x] * n_chan
    for k in range(num_steps):
        _, dout, heads = dims[k]
        groups: dict = {}
        for c in range(n_chan):
            groups.setdefault(id(graphs[c][k]), []).append(c)
        new_hs: list = [None] * n_chan
        for shared in groups.values():
            for i in range(0, len(shared), MAX_CHANNELS):
                chans = shared[i : i + MAX_CHANNELS]
                g = graphs[chans[0]][k]
                batchable = (len(chans) > 1 and heads == 1 and g.gat_loops
                             and stream_gat_enabled(kz=dout, n_ch=len(chans),
                                                    dropout_active=masks is not None))
                if not batchable:
                    for c in chans:
                        keep = None if masks is None else masks.gat(c, k, g, heads)
                        new_hs[c] = gat_apply(model.channels[c][k], hs[c], g, heads=heads,
                                              concat=True, dropout=cfg.dropout, keep=keep,
                                              transport=transport)
                    continue
                sp = _stacked_step_params(model, k, chans)
                att = sp["att"][:, 0, 0]  # [Cg, 2*dout] (one head)
                z = torch.einsum("cnd,cde->cne", torch.stack([hs[c][:n] for c in chans]),
                                 sp["w"])
                a_dst = torch.einsum("cne,ce->cn", z, att[:, :dout])
                a_src = torch.einsum("cne,ce->cn", z, att[:, dout:])
                outb = stream_gat_attention_batched(z, a_src, a_dst, g.src, g.dst,
                                                    g.src_perm, g.src_sorted, n, True, 0.2,
                                                    transport, g.block_bounds,
                                                    g.src_block_bounds)
                outb = outb + sp["b"][:, None, :]
                for j, c in enumerate(chans):
                    new_hs[c] = outb[j]
        if k < num_steps - 1:
            new_hs = [torch.relu(h) for h in new_hs]
        hs = new_hs
    return torch.stack(hs, dim=1)  # [N, C, R]


def _channel_forward(model: PEA, c, steps, cfg: PEAConfig, transport="f32",
                     masks: Optional[DropoutMasks] = None):
    """Channel c over its own step graphs (JAX models/pea.py:115-137,
    PEABaseChannel.forward, base.py:134-140): one conv a step on the dims
    of _channel_layer_dims for its depth, ReLU between steps -> [num_nodes,
    dout of the last step].  A GAT conv drops attention with masks.gat(c,
    k, g, heads) when `masks` is given."""
    layers = model.channels[c]
    dims = _channel_layer_dims(cfg, len(layers))
    h = model.x
    for k, (lp, g) in enumerate(zip(layers, steps)):
        heads = dims[k][2]
        if cfg.conv == "gcn":
            h = gcn_apply(lp, h, g, transport)
        elif cfg.conv == "sage":
            h = sage_apply(lp, h, g, transport)
        elif cfg.conv == "gat":
            keep = None if masks is None else masks.gat(c, k, g, heads)
            h = gat_apply(lp, h, g, heads=heads, concat=True, dropout=cfg.dropout,
                          keep=keep, transport=transport)
        else:
            raise ValueError(cfg.conv)
        if k < len(layers) - 1:
            h = torch.relu(h)
    return h


def pea_forward(model: PEA, graphs, cfg: PEAConfig,
                channel_mask: Optional[torch.Tensor] = None, transport="f32",
                flash_mode=FlashGATMode(), masks: Optional[DropoutMasks] = None):
    """Full-graph forward -> cached representation [num_nodes, repr-like].

    graphs: a HybridGATPlan (the hybrid GAT forward), a tuple of union
    StepGraphs, one per step (the fused forward), or per-channel graphs
    (tuple[channel] of tuple[step]): the grouped forward for GAT channels
    of one depth, else the ungrouped one (_channel_forward a channel).
    flash_mode: the routes of the union flash-GAT passes
    (ops/config.FlashGATMode); the batched, streaming and composed GATs
    ignore it, as the JAX switches leave them alone.  masks: GAT attention
    dropout's keep masks (a training forward); a HybridGATPlan then hands
    the forward to its per-channel graphs (JAX models/pea.py:555-558), and
    union graphs drop one mask a step on the composed route
    (pea_forward_fused; JAX :568).  GCN and SAGE ignore them."""
    if masks is not None and isinstance(graphs, HybridGATPlan):
        graphs = graphs.per_channel
    if isinstance(graphs, HybridGATPlan):
        h = pea_forward_hybrid(model, graphs, cfg, transport, flash_mode)
    elif len(graphs) > 0 and isinstance(graphs[0], StepGraph):
        h = pea_forward_fused(model, graphs, cfg, transport, flash_mode, masks=masks)
    elif cfg.conv == "gat" and len(set(cfg.meta_path_steps)) == 1:
        h = _grouped_gat_forward(model, graphs, cfg, transport, masks)
    else:
        h = torch.stack([_channel_forward(model, c, steps, cfg, transport, masks)
                         for c, steps in enumerate(graphs)], dim=1)  # [N, C, R]
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


def pea_loss(model: PEA, graphs, cfg: PEAConfig, batch, row_mask=None,
             transport="f32", flash_mode=FlashGATMode(),
             masks: Optional[DropoutMasks] = None):
    """Training loss: BPR with the optional entity-aware regularizer
    (base.py:43-80).

    batch: int64[B, 3] or [B, 9] (entity-aware columns, see
    entity_reg_loss); row_mask: float[B], 0 for the padding rows of an
    epoch's last batch; masks: GAT attention dropout's keep masks (None:
    no dropout), dropping at rate cfg.dropout."""
    if row_mask is None:
        row_mask = torch.ones(batch.shape[0], dtype=torch.float32, device=batch.device)
    cached = pea_forward(model, graphs, cfg, transport=transport, flash_mode=flash_mode,
                         masks=masks)
    pos = pea_predict(model, cached, batch[:, 0], batch[:, 1])
    neg = pea_predict(model, cached, batch[:, 0], batch[:, 2])
    cf_loss = torch.sum(-_log_sigmoid(pos - neg) * row_mask)
    if cfg.entity_aware:
        reg = entity_reg_loss(model.x, batch, row_mask)
        return cf_loss + cfg.entity_aware_coff * reg
    return cf_loss
