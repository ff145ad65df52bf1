"""Edge-parallel message passing over the ranks of a world: the graph
analog of sequence parallelism.

Port of the JAX package's ``parallel/edge_parallel.py``.  The edge list of
each metapath step is split into contiguous, equal shards, one a rank;
every rank gathers and transforms only its shard's edges, computes a
partial per-node aggregate with the segment kernels (K7 gathers, K5 sums;
backwards K6, K5, K7), and the partials combine with one all-reduce
(``parallel/collectives.psum``).  Parameters are replicated; the batch is
split by rows; the gradients are all-reduced once a step.

GAT's per-destination softmax needs global statistics, so the sharded
softmax runs the two-pass exchange: the local per-dst max, its all-reduced
max (no gradient: softmax is shift-invariant), the local sums of exp, their
all-reduced sum, then a local normalization.  The stats stay plain torch
(``ops/segment``), as the JAX package computes them in XLA outside any
Pallas kernel.  At ML-25M scale the streaming route runs instead: each
channel group's batched streaming GAT (K9-K11) on the rank's shard, its
partials all-reduced inside ``ops/stream_gat.StreamGAT``.

Shards are built on the host by ``shard_step_graph``, each with the walks
the port's kernels take (dst_perm for K5, block_bounds for K8-K10,
src_block_bounds for K11) built from that shard's edges alone.  A shard of
the (dst // 128, src) order is block-monotone, not sorted.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import PAD_TO, StepGraph
from ..ops.flash_gat import dst_block_bounds
from ..ops.segment import segment_max, segment_sum
from ..train.engine import fill_grads
from .collectives import all_reduce_grads, pmax, psum
from .multihost import process_local_rows


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def shard_step_graph(g: StepGraph, n_shards: int):
    """Split a padded, block-ordered StepGraph into `n_shards` contiguous,
    equal-length shards, PAD_TO-aligned, the filler edges padding (dst ==
    num_nodes, w 0, src 0, rel 0) -> tuple of StepGraphs on the CPU.  Each
    shard's src/dst/w/rel/src_perm/src_sorted are the JAX
    ``shard_step_graph``'s row; dst_perm/dst_sorted, block_bounds and
    src_block_bounds are built from the shard's own edges.  num_nodes,
    num_edges (the whole graph's), src_span and gat_loops are g's."""
    arrays = [t.cpu().numpy() for t in (g.src, g.dst, g.w, g.rel)]
    e_pad = arrays[0].shape[0]
    per = -(-e_pad // (n_shards * PAD_TO)) * PAD_TO
    pad = per * n_shards - e_pad

    def split(a, fill):
        return np.concatenate([a, np.full(pad, fill, dtype=a.dtype)]).reshape(n_shards, per)

    src, dst, w, rel = (split(a, f) for a, f in zip(arrays, (0, g.num_nodes, 0.0, 0)))
    shards = []
    for s in range(n_shards):
        src_perm = np.argsort(src[s], kind="stable")
        dst_perm = np.argsort(dst[s], kind="stable")
        dst_t = _i32(dst[s])
        src_sorted = _i32(src[s][src_perm])
        shards.append(StepGraph(
            src=_i32(src[s]), dst=dst_t, w=torch.from_numpy(w[s].astype(np.float32)),
            rel=_i32(rel[s]), src_perm=_i32(src_perm), src_sorted=src_sorted,
            dst_perm=_i32(dst_perm), dst_sorted=_i32(dst[s][dst_perm]),
            num_nodes=g.num_nodes, num_edges=g.num_edges,
            block_bounds=dst_block_bounds(dst_t, g.num_nodes),
            src_block_bounds=dst_block_bounds(src_sorted, g.num_nodes),
            src_span=g.src_span, gat_loops=g.gat_loops,
        ))
    return tuple(shards)


def _local_view(shards, mesh):
    """This rank's shard of `shards` (shard_step_graph's tuple), on the
    mesh's device."""
    return shards[mesh.rank].to(mesh.device)


def shard_fused_graphs(fused_graphs, n_shards: int):
    """shard_step_graph of every step's union graph: tuple[step] of
    tuple[shard]."""
    return tuple(shard_step_graph(g, n_shards) for g in fused_graphs)


def make_psum_aggregate(mesh):
    """aggregate(msgs, g, transport): the local segment-sum (K5), then the
    sum of the ranks' partials (psum)."""

    def aggregate(msgs, g, transport="f32"):
        from ..nn.conv import _aggregate

        return psum(_aggregate(msgs, g, transport), mesh)

    return aggregate


def make_sharded_softmax(mesh):
    """softmax(alpha, dst, num_rows): the per-destination softmax over
    edges sharded across the ranks, equal to the single-process
    segment_softmax (PyG's +1e-16 guard included).  Padding edges (dst ==
    num_rows) read the last row's stats and add nothing to the sums."""

    def softmax(alpha, dst, num_rows):
        # shift-invariant: the max carries no gradient (the JAX pmax has no
        # AD rule); a shard's dst is block-monotone, never claimed sorted
        lmax = segment_max(alpha.detach(), dst, num_rows)
        gmax = pmax(lmax, mesh)
        gmax_safe = torch.where(torch.isfinite(gmax), gmax, torch.zeros_like(gmax))
        rows = torch.clamp(dst, max=num_rows - 1).long()
        expd = torch.exp(alpha - gmax_safe[rows])
        gsum = psum(segment_sum(expd, dst, num_rows), mesh)
        return expd / (gsum[rows] + 1e-16)

    return softmax


def plan_channel_shards(per_channel_graphs, n_shards: int):
    """Shard the per-channel metapath graphs for the streaming edge
    trainer -> (groups, dist):
      groups[k] = tuple[(chans tuple, dist_idx)]: the channels sharing one
                  step-k edge list (graph.build_metapath_graphs dedupes by
                  object), in shares of <= 8 (ops/stream_gat's limit);
      dist[k]   = tuple[tuple[StepGraph]]: the distinct step-k graphs,
                  each shard_step_graph'd."""
    n_chan = len(per_channel_graphs)
    num_steps = len(per_channel_graphs[0])
    groups_all, dist_all = [], []
    for k in range(num_steps):
        by_id: dict = {}
        for c in range(n_chan):
            by_id.setdefault(id(per_channel_graphs[c][k]), []).append(c)
        groups, dist = [], []
        for chans in by_id.values():
            gi = len(dist)
            dist.append(shard_step_graph(per_channel_graphs[chans[0]][k], n_shards))
            for i in range(0, len(chans), 8):
                groups.append((tuple(chans[i: i + 8]), gi))
        groups_all.append(tuple(groups))
        dist_all.append(tuple(dist))
    return tuple(groups_all), tuple(dist_all)


def _pea_loss_tail(cfg, params, h, batch, row_mask):
    """Channel fusion, BPR and the entity regularizer on a [N, C, R]
    forward output: the local loss tail of both edge-sharded steps."""
    from ..models.pea import _log_sigmoid, entity_reg_loss, pea_predict

    if cfg.channel_aggr == "concat":
        cached = h.reshape(h.shape[0], -1)
    elif cfg.channel_aggr == "mean":
        cached = h.mean(dim=1)
    else:
        atts = torch.softmax(torch.sum(h * params.att, dim=-1), dim=-1)
        cached = torch.sum(h * atts[..., None], dim=1)
    pos = pea_predict(params, cached, batch[:, 0], batch[:, 1])
    neg = pea_predict(params, cached, batch[:, 0], batch[:, 2])
    loss = torch.sum(-_log_sigmoid(pos - neg) * row_mask)
    if cfg.entity_aware and batch.shape[1] > 3:
        loss = loss + cfg.entity_aware_coff * entity_reg_loss(params.x, batch, row_mask)
    return loss


def stream_grouped_forward_local(params, cfg, groups, dist_local, mesh, transport="f32"):
    """The PEA GAT forward over this rank's shards of the per-channel
    graphs (dist_local[k][gi]: the rank's shard of plan_channel_shards'
    graph) -> [N, C, R]: every channel group runs the batched streaming
    GAT (K9; backward K10, K11) on the shard, its node partials summed over
    the ranks; a `gat_loops` graph's loop term once on replicated math, a
    loop-materialized one with self_loops off.  Per channel the math of
    the single-process grouped forward."""
    from ..models.pea import _channel_layer_dims
    from ..ops.stream_gat import stream_gat_attention_batched

    n = cfg.num_nodes
    num_steps = cfg.meta_path_steps[0]
    dims = _channel_layer_dims(cfg, num_steps)
    hs = [None] * cfg.num_channels
    for k in range(num_steps):
        _, dout, heads = dims[k]
        if heads != 1:
            raise ValueError("the streaming edge step runs single-head GAT")
        new_hs: list = [None] * cfg.num_channels
        for chans, gi in groups[k]:
            g = dist_local[k][gi]
            lp = [params.channels[c][k] for c in chans]
            w = torch.stack([p["w"] for p in lp])  # [Cg, din, dout]
            att = torch.stack([p["att"][0, 0] for p in lp])  # [Cg, 2 dout]
            b = torch.stack([p["b"] for p in lp])
            if k == 0:
                z = torch.einsum("nd,cde->cne", params.x[:n], w)
            else:
                z = torch.einsum("cnd,cde->cne", torch.stack([hs[c] for c in chans]), w)
            a_dst = torch.einsum("cne,ce->cn", z, att[:, :dout])
            a_src = torch.einsum("cne,ce->cn", z, att[:, dout:])
            # psum_scale 1/dp: the attention's backward sums the cotangent
            # and the edge partials into totals; the share keeps the step's
            # one gradient all-reduce exact at every depth
            outb = stream_gat_attention_batched(
                z, a_src, a_dst, g.src, g.dst, g.src_perm, g.src_sorted, n,
                bool(g.gat_loops), 0.2, transport, g.block_bounds, g.src_block_bounds,
                mesh=mesh, psum_scale=1.0 / mesh.dp)
            outb = outb + b[:, None, :]
            for i, c in enumerate(chans):
                new_hs[c] = outb[i]
        if k < num_steps - 1:
            new_hs = [torch.relu(x) for x in new_hs]
        hs = new_hs
    return torch.stack(hs, dim=1)  # [N, C, R]


def sharded_grads(local_loss, params, batch, row_mask, mesh):
    """The step's loss and gradients summed over the ranks: the local loss
    on this rank's rows, its backward (the collectives inside add their
    own), a zero .grad for every parameter it did not reach (fill_grads),
    and one all-reduce of every gradient with the loss at its end.
    Returns the total loss, detached; the gradients stay in .grad."""
    for p in params.parameters():
        p.grad = None
    loss = local_loss(params, batch, row_mask)
    loss.backward()
    fill_grads(params)
    return all_reduce_grads(list(params.parameters()), mesh, extra=loss.detach())


def _make_step(local_loss, mesh):
    def step(params, optimizer, batch, row_mask):
        """One optimizer step on this rank's rows; the total loss."""
        loss = sharded_grads(local_loss, params, batch, row_mask, mesh)
        optimizer.step()
        return loss

    def place(batch, row_mask):
        """This rank's rows of the global batch and mask."""
        rows = process_local_rows(batch.shape[0], mesh)
        return batch[rows], row_mask[rows]

    step.local_loss = local_loss
    return step, place


def make_stream_edge_sharded_train_step(cfg, groups, dist_local, mesh, transport="f32"):
    """The edge-sharded PEA step on the streaming route -> (step, place):
    step(params, optimizer, batch, row_mask) -> the total loss, on this
    rank's rows (place(batch, row_mask) takes them from the global batch);
    dist_local[k][gi] is the rank's shard of plan_channel_shards'
    graphs."""

    def local_loss(params, batch, row_mask):
        h = stream_grouped_forward_local(params, cfg, groups, dist_local, mesh, transport)
        return _pea_loss_tail(cfg, params, h, batch, row_mask)

    return _make_step(local_loss, mesh)


def make_edge_sharded_train_step(cfg, local_graphs, mesh, transport="f32"):
    """The edge-sharded PEA step over the union graphs -> (step, place), as
    make_stream_edge_sharded_train_step's; local_graphs[k] is the rank's
    shard of step k's union graph.  Every rank computes its shard of every
    step's edge messages (GAT on the edge-materialized route with the
    sharded softmax) and its rows of the BPR and entity terms; node
    aggregates and gradients are all-reduced once a use.  GAT trains
    without attention dropout whatever cfg.dropout says, as the reference
    does: JAX's edge union step passes dropout_key=None (JAX
    parallel/edge_parallel.py:296), and its streaming route requires
    dropout 0 (JAX parallel/engine.py:120)."""
    from ..models.pea import pea_forward_fused

    aggregate = make_psum_aggregate(mesh)
    softmax = make_sharded_softmax(mesh)

    def local_loss(params, batch, row_mask):
        h = pea_forward_fused(params, local_graphs, cfg, transport,
                              aggregate=aggregate, softmax=softmax)
        return _pea_loss_tail(cfg, params, h, batch, row_mask)

    return _make_step(local_loss, mesh)
