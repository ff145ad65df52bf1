"""Fully sharded PEA training: the row-sharded embedding table with
all-to-all lookups.

Port of the JAX package's ``parallel/a2a.py``.  Nothing table-shaped is
replicated or all-gathered over the P ranks of the mesh axis:

  params.x         [emb_rows/P, emb]   this rank's rows of the table
  per-step z / h   [emb_rows C/P, d]   psum-scattered aggregates, row-aligned
  cached repr      [emb_rows/P, F]     the fused channels of this rank's rows
  x's gradient     [emb_rows/P, emb]   complete after the lookups' reverse
                                       exchanges (never all-reduced)
  Adam's moments   shaped like the shard (they are the shard's own)

Per conv step each rank transforms only its own table rows, ships the rows
its peers' edge shards need through one all-to-all (the exchange plan is
built on the host from the static edge sets, so no id crosses the wire:
sharded_embedding.build_static_plan / static_lookup), sums its edge shard
into the whole virtual node space (``nn/conv._aggregate``: K5, walking the
shard's ``dst_perm``), and psum-scatters the partial sums straight into
the next step's row-aligned shard (the node-major union of
graph.fuse_step_graphs_interleaved lines each rank's scatter block up with
the table rows it owns).  The batch's (u, pos, neg, entity) rows take the
dynamic lookup (sharded_embedding.sharded_lookup).  Every gather of the
lookups is K7 forward and K6 backward (ops/gather.gather_rows); GAT's
softmax is the edge layer's two-pass sharded softmax
(edge_parallel.make_sharded_softmax, plain torch as in the JAX package).

Messages ride the transport dtype as on the port's union route
(nn/conv.propagate, composed_attention): the exchanged edge rows are cast
to it (``msg_cast``) and K5 sums them in f32; the batch lookups stay f32.
The single-process math is preserved; only orders of sums differ.

Attention dropout (GAT): the JAX package folds the rank into the step's
key; here each rank draws its keep masks from a generator seeded by a
draw from the epoch's generator (every rank draws the same) and its rank
(``rank_generator``), so that each edge shard has masks of its own:
distribution parity with the single-process dropout, not its bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..graph import build_fused_metapath_graphs_interleaved
from ..models.pea import PEAConfig, _channel_layer_dims, _log_sigmoid, _stacked_step_params
from ..nn.conv import _aggregate
from ..nn.init import linear
from ..ops.flash_gat import msg_cast
from ..train.engine import fill_grads
from .collectives import all_reduce_grads, psum_scatter
from .edge_parallel import make_sharded_softmax, shard_fused_graphs
from .multihost import process_local_rows
from .sharded_embedding import (
    build_static_plan,
    plan_arrays,
    sharded_lookup,
    static_lookup,
)


def _axis(mesh, axis):
    """(P, this rank's index) on `axis` (1, 0 without a mesh)."""
    if mesh is None:
        return 1, 0
    return mesh.axis_size(axis), mesh.axis_index(axis)


def build_a2a_setup(cfg: PEAConfig, metapath_edges, mesh, axis: str = "dp"):
    """Host-side preprocessing: the interleaved union graphs, their
    contiguous edge shards, one static exchange plan a lookup site, and
    this rank's shards and plan rows on the mesh's device."""
    n_shards, rank = _axis(mesh, axis)
    emb_rows = cfg.emb_rows
    if emb_rows % n_shards:
        raise ValueError(f"{emb_rows} table rows do not split over {n_shards} ranks")
    C = cfg.num_channels
    r_loc = emb_rows // n_shards
    s_virt = r_loc * C
    fused = build_fused_metapath_graphs_interleaved(
        metapath_edges, cfg.num_nodes, emb_rows, cfg.conv)
    sharded = shard_fused_graphs(fused, n_shards)
    v_total = emb_rows * C

    src_plans, dst_plans = [], []
    for k, shards in enumerate(sharded):
        src = np.stack([g.src.numpy() for g in shards])  # [P, E_loc]; padding src 0, w 0
        if cfg.conv == "sage" and k == 0:
            # SAGE step 1 gathers raw x rows: node-space ids dedupe the
            # C-fold channel duplication away
            src_plans.append(build_static_plan(src // C, r_loc, n_shards))
        else:
            src_plans.append(build_static_plan(src, s_virt, n_shards))
        if cfg.conv == "gat":
            dst = np.stack([g.dst.numpy() for g in shards])
            dst = np.where(dst >= v_total, 0, dst)  # sentinel -> row 0 (unused)
            dst_plans.append(build_static_plan(dst, s_virt, n_shards))
        else:
            dst_plans.append(None)
    device = torch.device("cpu") if mesh is None else mesh.device
    return {
        "sharded_graphs": sharded,
        "graphs": tuple(shards[rank].to(device) for shards in sharded),
        "src_plans": src_plans,
        "dst_plans": dst_plans,
        "splans": [plan_arrays(p, rank, device) for p in src_plans],
        "dplans": [None if p is None else plan_arrays(p, rank, device) for p in dst_plans],
        "n_shards": n_shards,
        "rank": rank,
        "r_loc": r_loc,
        "s_virt": s_virt,
        "v_total": v_total,
    }


def rank_generator(generator, rank):
    """This rank's generator for one step's dropout masks: seeded by one
    draw from `generator` (the epoch's; every rank draws it alike, so the
    ranks' streams stay in step) and the rank."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(
        (seed + 1_000_003 * rank) % 2 ** 63)


def _lookup(setup, plans, k, table, mesh, axis, transport, which="src"):
    plan = (setup["src_plans"] if which == "src" else setup["dst_plans"])[k]
    arr = plans[k]
    return static_lookup(table, arr["own"], arr["pos"], arr["serve"], mesh, axis,
                         plan["capacity"], transport)


def _a2a_forward(cfg: PEAConfig, setup, mesh, axis, params, x_shard, transport="f32",
                 masks_generator=None):
    """The sharded union forward -> this rank's channel representations
    [r_loc, C, repr].  `masks_generator` (GAT with cfg.dropout > 0) draws
    this rank's attention keep masks, one [E_loc, heads] a step."""
    C = cfg.num_channels
    r_loc, s_virt, v_total = setup["r_loc"], setup["s_virt"], setup["v_total"]
    splans, dplans = setup["splans"], setup["dplans"]
    num_steps = cfg.meta_path_steps[0]
    dims = _channel_layer_dims(cfg, num_steps)
    softmax = make_sharded_softmax(mesh)

    h = None  # [r_loc, C, d] from step 2 on
    for k in range(num_steps):
        sp = _stacked_step_params(params, k)
        g = setup["graphs"][k]
        din, dout, heads = dims[k]
        if cfg.conv == "gcn":
            if k == 0:
                z = torch.einsum("rd,cde->rce", x_shard, sp["w"])
            else:
                z = torch.einsum("rcd,cde->rce", h, sp["w"])
            zm, w = msg_cast(z.reshape(s_virt, dout), g.w, transport=transport)
            z_e = _lookup(setup, splans, k, zm, mesh, axis, transport)
            partial = _aggregate(w[:, None] * z_e, g, transport)  # [v_total, dout]
            agg = psum_scatter(partial, mesh, axis)
            h = agg.reshape(r_loc, C, dout) + sp["b"][None]
        elif cfg.conv == "sage":
            if k == 0:
                src_rows = x_shard
                root = torch.einsum("rd,cde->rce", x_shard, sp["w_root"])
            else:
                src_rows = h.reshape(s_virt, din)
                root = torch.einsum("rcd,cde->rce", h, sp["w_root"])
            xm, w = msg_cast(src_rows, g.w, transport=transport)
            x_e = _lookup(setup, splans, k, xm, mesh, axis, transport)
            partial = _aggregate(w[:, None] * x_e, g, transport)
            mean_agg = psum_scatter(partial, mesh, axis).reshape(r_loc, C, din)
            h = torch.einsum("rcd,cde->rce", mean_agg, sp["w_rel"]) + sp["b_rel"][None] + root
        elif cfg.conv == "gat":
            if k == 0:
                z = torch.einsum("rd,cde->rce", x_shard, sp["w"])
            else:
                z = torch.einsum("rcd,cde->rce", h, sp["w"])
            c_dim = dout  # per-head width; z is [r_loc, C, H c]
            zh = z.reshape(r_loc, C, heads, c_dim)
            att = sp["att"][:, 0]  # [C, H, 2c]
            a_dst = torch.sum(zh * att[None, :, :, :c_dim], dim=-1).reshape(s_virt, heads)
            a_src = torch.sum(zh * att[None, :, :, c_dim:], dim=-1).reshape(s_virt, heads)
            # one exchange ships [z | a_src]: H c + H columns
            packed = msg_cast(torch.cat([z.reshape(s_virt, heads * c_dim), a_src], dim=1),
                              transport=transport)
            packed_e = _lookup(setup, splans, k, packed, mesh, axis, transport)
            a_dst_e = _lookup(setup, dplans, k, a_dst, mesh, axis, transport, "dst")
            alpha = F.leaky_relu(a_dst_e + packed_e[:, heads * c_dim:].float(), 0.2)
            att_e = softmax(alpha, g.dst, v_total)  # [E_loc, H]
            if masks_generator is not None and cfg.dropout > 0.0:
                keep = torch.rand(att_e.shape, generator=masks_generator,
                                  device=masks_generator.device) < 1.0 - cfg.dropout
                att_e = torch.where(keep, att_e / (1.0 - cfg.dropout), torch.zeros_like(att_e))
            z_e = packed_e[:, : heads * c_dim].reshape(-1, heads, c_dim)
            msgs = z_e * msg_cast(att_e, transport=transport)[:, :, None]
            partial = _aggregate(msgs.reshape(-1, heads * c_dim), g, transport)
            agg = psum_scatter(partial, mesh, axis)
            # heads concatenate between steps, one head on the last
            h = agg.reshape(r_loc, C, heads * c_dim) + sp["b"][None]
        else:
            raise ValueError(cfg.conv)
        if k < num_steps - 1:
            h = torch.relu(h)
    return h  # [r_loc, C, repr]


def _fuse_channels(cfg, params, h):
    if cfg.channel_aggr == "concat":
        return h.reshape(h.shape[0], -1)
    if cfg.channel_aggr == "mean":
        return h.mean(dim=1)
    atts = torch.softmax(torch.sum(h * params.att, dim=-1), dim=-1)
    return torch.sum(h * atts[..., None], dim=1)


def _score(params, u, i):
    return linear(params.fc2, torch.relu(linear(params.fc1, torch.cat([u, i], dim=-1))))[..., 0]


def make_a2a_parts(cfg: PEAConfig, metapath_edges, mesh, axis: str = "dp", transport="f32"):
    """The pieces of the a2a path (the sharded epoch engine,
    parallel/engine.py, builds on them):

      shard(params)                      x replaced by this rank's rows
      local_cached(params, channel_mask) -> this rank's cached rows [r_loc, F]
      local_loss(params, batch, row_mask, generator=None)
          this rank's loss on its rows of the batch; `generator` draws the
          dropout masks (rank_generator)
      grads(params, batch, row_mask, generator=None) -> the total loss;
          every leaf's gradient but x's summed over the ranks in .grad
      step(params, optimizer, batch, row_mask, generator=None) -> the
          total loss, after one optimizer step
      place(batch, row_mask)             this rank's rows of a global batch
    plus the setup (build_a2a_setup), r_loc and n_shards.  Metapaths of
    mixed depth raise ValueError: the exchange plans are per step
    position."""
    if len(set(cfg.meta_path_steps)) != 1:
        raise ValueError(
            "--parallel a2a requires uniform meta_path_steps (the sharded "
            f"exchange plans are per step position); got {cfg.meta_path_steps}. "
            "Use --parallel dp/edge for mixed-depth metapaths.")
    if not cfg.fused:
        raise ValueError("--parallel a2a runs the fused union graphs (cfg.fused)")
    setup = build_a2a_setup(cfg, metapath_edges, mesh, axis)
    P, rank = setup["n_shards"], setup["rank"]
    r_loc = setup["r_loc"]

    def shard(params):
        with torch.no_grad():
            params.x = torch.nn.Parameter(params.x[rank * r_loc:(rank + 1) * r_loc].clone())
        return params

    def local_cached(params, channel_mask=None):
        h = _a2a_forward(cfg, setup, mesh, axis, params, params.x, transport)
        if channel_mask is not None:
            h = h * channel_mask[None, :, None]
        return _fuse_channels(cfg, params, h)  # [r_loc, F]

    def local_loss(params, batch, row_mask, generator=None):
        x_shard = params.x
        masks = None
        if generator is not None and cfg.conv == "gat" and cfg.dropout > 0.0:
            masks = rank_generator(generator, rank)
        h = _a2a_forward(cfg, setup, mesh, axis, params, x_shard, transport, masks)
        cached = _fuse_channels(cfg, params, h)  # [r_loc, F]
        b_loc = batch.shape[0]
        ids3 = torch.cat([batch[:, 0], batch[:, 1], batch[:, 2]]).to(torch.int32)
        # an owner is asked for at most min(#ids, #rows it owns) distinct
        # rows, so these capacities never overflow a bucket
        cap3 = min(3 * b_loc, r_loc)
        rows = sharded_lookup(cached, ids3, mesh, axis, cap3)
        u_r, p_r, n_r = rows[:b_loc], rows[b_loc:2 * b_loc], rows[2 * b_loc:]
        loss = torch.sum(-_log_sigmoid(_score(params, u_r, p_r) - _score(params, u_r, n_r))
                         * row_mask)
        if cfg.entity_aware and batch.shape[1] > 3:
            ids6 = batch[:, [0, 1, 3, 4, 6, 7]].T.reshape(-1).to(torch.int32)
            cap6 = min(6 * b_loc, r_loc)
            xr = sharded_lookup(x_shard, ids6, mesh, axis, cap6).reshape(6, b_loc, -1)
            u, pos_i, p_ie, n_ie, p_ue, n_ue = (xr[i] for i in range(6))

            def sq(a, b):
                d = a - b
                return torch.sum(d * d, dim=-1)

            item_term = -_log_sigmoid((sq(pos_i, p_ie) - sq(pos_i, n_ie)) * batch[:, 5])
            user_term = -_log_sigmoid((sq(u, p_ue) - sq(u, n_ue)) * batch[:, 8])
            loss = loss + cfg.entity_aware_coff * torch.sum((item_term + user_term) * row_mask)
        return loss

    def grads(params, batch, row_mask, generator=None):
        for p in params.parameters():
            p.grad = None
        loss = local_loss(params, batch, row_mask, generator)
        loss.backward()
        fill_grads(params)
        # x's gradient is complete: every rank's request cotangents reached
        # its owner through the lookups' reverse exchanges; every other
        # leaf's is this rank's share of the batch and edges
        rest = [p for p in params.parameters() if p is not params.x]
        return all_reduce_grads(rest, mesh, extra=loss.detach())

    def step(params, optimizer, batch, row_mask, generator=None):
        loss = grads(params, batch, row_mask, generator)
        optimizer.step()
        return loss

    def place(batch, row_mask):
        if mesh is None:
            return batch, row_mask
        rows = process_local_rows(batch.shape[0], mesh)
        return batch[rows], row_mask[rows]

    return {"setup": setup, "shard": shard, "local_cached": local_cached,
            "local_loss": local_loss, "grads": grads, "step": step, "place": place,
            "r_loc": r_loc, "n_shards": P}


def make_a2a_train_step(cfg: PEAConfig, metapath_edges, mesh, axis: str = "dp",
                        transport="f32"):
    """(step, place, shard) of the a2a path (make_a2a_parts):
    step(params, optimizer, batch, row_mask, generator=None) -> the total
    loss on this rank's rows (place(batch, row_mask) takes them from the
    global batch), params sharded by shard(params) first."""
    parts = make_a2a_parts(cfg, metapath_edges, mesh, axis, transport)
    return parts["step"], parts["place"], parts["shard"]

