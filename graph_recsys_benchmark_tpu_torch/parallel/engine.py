"""Sharded epoch engine: the parallel modes as a product feature.

Port of the JAX package's ``parallel/engine.py``: ``ShardedPEATrainer``
presents the trainer interface the Solver drives while every step runs
over the ranks of the mesh (parallel/mesh.py):

  mode 'edge'  the metapath edge sets and the batch rows sharded, the
               parameters replicated, node aggregates and gradients
               all-reduced (parallel/edge_parallel.py);
  mode 'dp'    the batch split over all dp * mp ranks, the embedding table
               row-sharded over 'mp', all-gathered for the forward and
               reduce-scattered in the backward (parallel/spmd.py); eval
               all-gathers the table and runs the single-process eval on
               every rank;
  mode 'a2a'   the table, the per-step aggregates and the cached
               representation row-sharded over the ranks, the lookups
               all-to-all (parallel/a2a.py), nothing table-shaped
               replicated; its evaluator scores the 99-negative protocol
               through sharded_lookup of the sharded cached representation,
               and the full-catalog sweep scores every test user against
               each rank's own catalog rows, the partial ranks summed.

``make_sharded_kg_trainer`` runs KGAT and KGCN edge-sharded.

Batch parity: every rank draws the epoch's permutation and the whole
batch (negatives, entities) from the same generator, exactly as the
single-process trainer does, then keeps its rows; so a sharded run sees
the single-process run's batches.  The batch is rounded up to a multiple
of the mesh's ranks.  ``init`` builds the whole ``pea_init`` from the seed
on every rank; the row-sharded modes keep each rank's rows of the table
(marked for utils/checkpoint.py, which writes the whole table).  The
graphs are built with the hybrid plan off and the GAT loops as edges, as
the JAX trainer's; the Solver's files are written by rank 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..data.hin import HINData
from ..eval.metrics import hit_vec_metrics, ranks_to_metrics
from ..eval.ranking import eval_loss_per_user
from ..models.pea import PEAConfig
from ..ops.config import FlashGATMode
from ..train.pea_trainer import PEATrainer, TrainConfig
from ..train.sampling import sample_eval_negatives
from . import spmd
from .a2a import make_a2a_parts
from .collectives import all_gather, all_reduce_, mark_row_sharded, route
from .edge_parallel import (
    _local_view,
    make_edge_sharded_train_step,
    make_psum_aggregate,
    make_sharded_softmax,
    make_stream_edge_sharded_train_step,
    plan_channel_shards,
    shard_fused_graphs,
    shard_step_graph,
    sharded_grads,
)
from .mesh import Mesh
from .multihost import make_pod_mesh, process_local_rows
from .sharded_embedding import sharded_lookup

MODES = ("dp", "edge", "a2a")


def _round_up(n, m):
    return -(-n // m) * m


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")


def _sharded_tcfg(tcfg, mesh):
    bs = _round_up(tcfg.batch_size, mesh.size)
    return tcfg if bs == tcfg.batch_size else dataclasses.replace(tcfg, batch_size=bs)


def default_mesh(mode, mesh_mp=None, device=None):
    """The world as the mode's mesh: 'dp' row-shards the table over mp =
    mesh_mp or (2 if the world is even else 1); 'edge' and 'a2a' run over
    a flat dp axis (JAX cli.py:255-266)."""
    if mode == "dp":
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        mp = mesh_mp or (2 if world % 2 == 0 else 1)
    else:
        mp = 1
    return make_pod_mesh(mp=mp, device=device)


class ShardedPEATrainer(PEATrainer):
    """PEATrainer whose steps run over the ranks of `mesh` (default: the
    world as the mode's mesh, default_mesh), on the mesh's device.

    Mode 'edge': GAT channels of one depth with no dropout, one head and
    widths <= 125 take the streaming route when some per-channel graph
    carries implicit self-loops (ML-25M, Yelp): each rank's shards of the
    per-channel graphs through K9-K11 (``_stream_edge_plan``).  Everything
    else takes the union graphs' shards (``_edge_graphs``): GCN and SAGE
    through K7/K5, GAT on the edge-materialized route with the sharded
    softmax.  Attention dropout is not applied in edge mode, as in the JAX
    package.

    Mode 'dp': the trainer's union graphs (K5/K7/K6; GAT's flash passes
    K12/K1 forward, K2 backward) over the all-gathered table.  GAT's
    attention dropout draws one global mask a union step from the epoch's
    generator, the same on every rank (spmd.make_sharded_train_step), and
    runs the composed route (K7, K8, K5; K6 backward), as JAX's dp step
    does (JAX parallel/spmd.py:50-55, models/pea.py:193-202); the eval
    draws nothing.  Mode 'a2a': the interleaved union
    graphs' shards and their exchange plans (``_a2a``, make_a2a_parts);
    GAT's attention dropout draws each rank's masks (a2a.rank_generator).
    Both print the collectives' route (collectives.route)."""

    _analytic_gat_loops = False  # the eval's graphs carry their loops as edges
    _use_hybrid_plan = False
    _eval_user_chunk = 128  # the a2a sweep's users a chunk (bounds [chunk, r_loc, H])

    def __init__(self, hin: HINData, cfg: PEAConfig, tcfg: TrainConfig,
                 metapath_edges=None, mesh: Optional[Mesh] = None, mode: str = "edge",
                 transport="f32", flash_mode=FlashGATMode()):
        _check_mode(mode)
        if mesh is None:
            mesh = default_mesh(mode)
        if mode != "dp" and mesh.mp != 1:
            raise ValueError(f"mode {mode!r} runs over a flat dp axis; got mp {mesh.mp}")
        self.mesh, self.mode, self.n_dp = mesh, mode, mesh.dp
        tcfg = _sharded_tcfg(tcfg, mesh)
        super().__init__(hin, cfg, tcfg, metapath_edges=metapath_edges, device=mesh.device,
                         transport=transport, flash_mode=flash_mode)
        edges = self._resolved_edges(hin, metapath_edges)
        if mode == "a2a":
            self._a2a = make_a2a_parts(cfg, edges, mesh, "dp", transport)
            self._place = self._a2a["place"]
            # test user (local id) -> its row in test_users, -1 if none
            t = self.tables
            self._u_index = torch.full((hin.num_users,), -1, dtype=torch.long,
                                       device=self.device)
            self._u_index[t.test_users.long() - t.user_lo] = torch.arange(
                t.test_users.shape[0], device=self.device)
        elif mode == "dp":
            self._dp_step, self._place = spmd.make_sharded_train_step(
                cfg, self.graphs, mesh, transport, flash_mode)
        else:
            self._build_edge(hin, cfg, edges, mesh, transport)
        if mode != "edge" and mesh.size > 1:
            print(f"rank {mesh.rank}: --parallel {mode} on a {mesh.dp} x {mesh.mp} mesh: "
                  f"{route(mesh)}", flush=True)

    def _build_edge(self, hin, cfg, edges, mesh, transport):
        stream_ok = (cfg.conv == "gat" and cfg.dropout == 0.0 and cfg.num_heads == 1
                     and len(set(cfg.meta_path_steps)) == 1
                     and max(cfg.hidden_size, cfg.repr_dim) <= 125)
        if stream_ok:
            from ..graph import build_metapath_graphs

            per_channel = build_metapath_graphs(edges, hin.num_nodes, cfg.conv,
                                                analytic_gat_loops=None)
            # only at streaming scale: below it the union route keeps the
            # single-process trainers' order of sums
            stream_ok = any(g.gat_loops for ch in per_channel for g in ch)
        if stream_ok:
            groups, dist_ = plan_channel_shards(per_channel, mesh.dp)
            local = tuple(tuple(_local_view(d, mesh) for d in step) for step in dist_)
            self._stream_edge_plan = (groups, local)
            self._edge_step, self._place = make_stream_edge_sharded_train_step(
                cfg, groups, local, mesh, transport)
        else:
            from ..graph import build_fused_metapath_graphs

            fused = build_fused_metapath_graphs(edges, hin.num_nodes, cfg.conv)
            self._edge_graphs = tuple(_local_view(s, mesh)
                                      for s in shard_fused_graphs(fused, mesh.dp))
            self._edge_step, self._place = make_edge_sharded_train_step(
                cfg, self._edge_graphs, mesh, transport)

    # ------------------------------------------------------------ placement

    def init(self, seed: int):
        """The whole pea_init from `seed` (bitwise the single-process
        trainer's), the row-sharded modes keeping this rank's rows of x."""
        params = super().init(seed)
        if self.mode == "a2a":
            self._a2a["shard"](params)
            mark_row_sharded(params.x, self.mesh, "dp")
        elif self.mode == "dp":
            spmd.shard_table(params, self.mesh)
            mark_row_sharded(params.x, self.mesh, "mp")
        return params

    # ------------------------------------------------------------ steps

    def train_step(self, params, optimizer, rows, row_mask, generator):
        """One step: the whole batch drawn as the single-process trainer
        draws it, this rank's rows of it through the mode's step.  Returns
        the total batch loss, detached, on the device."""
        batch = self._build_batch(rows, generator)
        b, m = self._place(batch, row_mask)
        if self.mode == "a2a":
            return self._a2a["step"](params, optimizer, b, m, generator)
        if self.mode == "dp":
            return self._dp_step(params, optimizer, b, m, generator)
        return self._edge_step(params, optimizer, b, m)

    def loss_and_grads(self, params, batch, row_mask, generator=None):
        """The mode's total loss and reduced gradients (in .grad) on the
        global `batch`, no optimizer step (x's gradient this rank's rows
        in the row-sharded modes); `generator` draws the dropout masks in
        modes 'a2a' and 'dp'."""
        b, m = self._place(batch, row_mask)
        if self.mode == "a2a":
            return self._a2a["grads"](params, b, m, generator)
        if self.mode == "dp":
            return self._dp_step.grads(params, b, m, generator)
        return sharded_grads(self._edge_step.local_loss, params, b, m, self.mesh)

    # ------------------------------------------------------------ eval

    def eval_forward(self, params, channel_mask=None):
        """Cached representation of every node; 'dp' over the all-gathered
        table (on every rank), 'a2a' this rank's rows only [r_loc, F]."""
        if self.mode == "a2a":
            return self._a2a["local_cached"](params, channel_mask)
        if self.mode == "dp":
            return spmd.eval_forward(params, self.graphs, self.cfg, self.mesh, channel_mask,
                                     self.transport, self.flash_mode)
        return super().eval_forward(params, channel_mask)

    def _channel_mask(self, metapath_idx):
        mask = torch.ones(self.cfg.num_channels, dtype=torch.float32, device=self.device)
        if metapath_idx is not None:
            mask[metapath_idx] = 0.0
        return mask

    def _eval_rows(self):
        """(this rank's slice of the test users padded to a multiple of
        the ranks, the padded count U_pad)."""
        u = self.tables.test_users.shape[0]
        u_pad = _round_up(u, self.mesh.size)
        return process_local_rows(u_pad, self.mesh), u_pad

    def _padded(self, t, u_pad):
        pad = u_pad - t.shape[0]
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))]) if pad else t

    @torch.no_grad()
    def evaluate(self, params, generator: torch.Generator,
                 metapath_idx: Optional[int] = None):
        """99-negative ranking eval; metapath_idx ablates one channel.  In
        'a2a' mode the negatives come from the single-process evaluator's
        call on the same generator (the same candidates), each rank scores
        its share of the test users through sharded_lookup of the sharded
        cached representation, and the sums are all-reduced."""
        if self.mode != "a2a":
            return super().evaluate(params, generator, metapath_idx)
        tables, mesh = self.tables, self.mesh
        neg = sample_eval_negatives(generator, tables, self.tcfg.num_neg_candidates)
        u = tables.test_users.shape[0]
        sl, u_pad = self._eval_rows()
        test_u = self._padded(tables.test_users, u_pad)[sl]
        test_i = self._padded(tables.test_items, u_pad)[sl]
        neg_l = self._padded(neg, u_pad)[sl]
        umask = (torch.arange(u_pad, device=self.device) < u).float()[sl]
        cached = self._a2a["local_cached"](params, self._channel_mask(metapath_idx))
        u_loc, c = neg_l.shape
        ids = torch.cat([test_u, test_i, neg_l.reshape(-1)]).to(torch.int32)
        # an owner serves at most min(#ids, r_loc) distinct rows
        rows = sharded_lookup(cached, ids, mesh, "dp", min(ids.shape[0], self._a2a["r_loc"]))
        u_r, p_r = rows[:u_loc], rows[u_loc:2 * u_loc]
        n_r = rows[2 * u_loc:].reshape(u_loc, c, -1)
        from .a2a import _score

        pos_s = _score(params, u_r, p_r)
        neg_s = _score(params, u_r[:, None, :].expand(n_r.shape), n_r)
        hr, ndcg, auc, ranks = hit_vec_metrics(pos_s, neg_s)
        loss = eval_loss_per_user(pos_s, neg_s, "bpr")
        sums = torch.cat([(hr * umask[:, None]).sum(0), (ndcg * umask[:, None]).sum(0),
                          (auc * umask).sum()[None], (loss * umask).sum()[None]])
        all_reduce_(sums, mesh)
        ranks = all_gather(ranks.contiguous(), mesh, "dp")[:u]
        n = 16
        return {"HR": sums[:n] / u, "NDCG": sums[n:2 * n] / u, "AUC": sums[2 * n] / u,
                "eval_loss": sums[2 * n + 1] / u, "ranks": ranks}

    @torch.no_grad()
    def evaluate_full(self, params):
        """Full-catalog ranking.  In 'a2a' mode the sharded sweep (JAX
        engine.py:280-356): each rank scores every test user against its
        own catalog rows in chunks of _eval_user_chunk users, subtracts its
        train-seen items scoring above, and the partial ranks are summed.
        Every score takes the split form fc2(relu(u Wu + (i Wi + b))), so
        the test item's own score equals the positive's bitwise (the
        concat form differs by ulps and would miscount that tie)."""
        if self.mode != "a2a":
            return super().evaluate_full(params)
        tables, mesh = self.tables, self.mesh
        r_loc = self._a2a["r_loc"]
        u = tables.test_users.shape[0]
        sl, u_pad = self._eval_rows()
        test_u = self._padded(tables.test_users, u_pad)[sl]
        test_i = self._padded(tables.test_items, u_pad)[sl]
        umask = (torch.arange(u_pad, device=self.device) < u).float()
        cached = self._a2a["local_cached"](params)
        u_loc = test_u.shape[0]
        ids = torch.cat([test_u, test_i]).to(torch.int32)
        rows = sharded_lookup(cached, ids, mesh, "dp", min(ids.shape[0], r_loc))
        u_r, p_r = rows[:u_loc], rows[u_loc:]
        f = u_r.shape[1]
        w1, b1 = params.fc1["w"], params.fc1["b"]
        w2, b2 = params.fc2["w"], params.fc2["b"]

        def split_score(iu_part, i_rows):
            z = torch.relu(iu_part + (i_rows @ w1[f:] + b1))
            return (z @ w2)[..., 0] + b2[0]

        iu_loc = u_r @ w1[:f]  # [U_loc, H]
        pos_loc = split_score(iu_loc, p_r)
        # the per-user tensors go to every rank; the catalog never moves
        iu = all_gather(iu_loc.contiguous(), mesh, "dp")  # [U_pad, H]
        pos_all = all_gather(pos_loc.contiguous(), mesh, "dp")
        p = self.mesh.axis_index("dp")
        gid = p * r_loc + torch.arange(r_loc, device=self.device)
        is_item = (gid >= tables.item_lo) & (gid < tables.item_lo + tables.num_items)
        ii = cached @ w1[f:] + b1  # [r_loc, H]
        above = []
        chunk = self._eval_user_chunk
        for c0 in range(0, u_pad, chunk):
            iu_c, pos_c = iu[c0:c0 + chunk], pos_all[c0:c0 + chunk]
            sc = (torch.relu(iu_c[:, None, :] + ii[None]) @ w2)[..., 0] + b2[0]
            above.append(((sc > pos_c[:, None]) & is_item[None]).sum(dim=1, dtype=torch.int32))
        above_all = torch.cat(above)
        # train-seen items scoring above, each edge counted by the rank that
        # owns its item row (unseen = all - train-seen)
        eu, ei = tables.train_pos[:, 0].long(), tables.train_pos[:, 1].long()
        local = (ei >= p * r_loc) & (ei < (p + 1) * r_loc)
        i_repr = cached[torch.clamp(ei - p * r_loc, 0, r_loc - 1)]
        tidx = self._u_index[eu - tables.user_lo]
        valid = (tidx >= 0) & local
        tidx_c = torch.clamp(tidx, 0, u_pad - 1)
        sc_e = split_score(iu[tidx_c], i_repr)
        contrib = ((sc_e > pos_all[tidx_c]) & valid).to(torch.int32)
        above_seen = torch.zeros(u_pad, dtype=torch.int32, device=self.device).index_add_(
            0, tidx_c, contrib)
        ranks = all_reduce_((above_all - above_seen).contiguous(), mesh)
        hr, ndcg = ranks_to_metrics(ranks)
        denom = torch.clamp(umask.sum(), min=1.0)
        return {"HR": (hr * umask[:, None]).sum(0) / denom,
                "NDCG": (ndcg * umask[:, None]).sum(0) / denom, "ranks": ranks[:u]}


def _shard_kg_hooks(trainer, mesh, transport):
    """Swap the port KGTrainer's three phase hooks and its step for sharded
    ones (JAX make_sharded_kg_trainer's composition): the TransR loss and
    the CF loss on this rank's rows, the attention snapshot by the two-pass
    softmax on this rank's shard of the typed graph, the CF convs summing
    the ranks' partial aggregates, the gradients all-reduced once a
    step."""
    from ..models import kg as M_kg
    from ..train.baseline_trainers import _masks

    cfg = trainer.cfg
    graph = _local_view(shard_step_graph(trainer.graph, mesh.dp), mesh)
    aggregate = make_psum_aggregate(mesh)
    softmax = make_sharded_softmax(mesh)

    def place(batch, row_mask):
        rows = process_local_rows(batch.shape[0], mesh)
        return batch[rows], row_mask[rows]

    def kg_loss(params, batch, row_mask):
        return M_kg.transr_kg_loss(params, *place(batch, row_mask))

    def att_snapshot(params):
        return M_kg.compute_att_map(params, graph, cfg, transport, softmax=softmax)

    def cf_loss(params, att, batch, row_mask, generator):
        b, m = place(batch, row_mask)
        return M_kg.kg_cf_loss(params, graph, cfg, att, b, m, transport=transport,
                               masks=_masks(cfg.dropout, generator), aggregate=aggregate)

    def step(params, optimizer, loss_fn):
        loss = sharded_grads(lambda p, b, m: loss_fn(), params, None, None, mesh)
        optimizer.step()
        return loss

    trainer._kg_loss, trainer._att_snapshot, trainer._cf_loss = kg_loss, att_snapshot, cf_loss
    trainer._step = step


def make_sharded_kg_trainer(hin, cfg, tcfg, mesh: Mesh | None = None, transport="f32"):
    """Edge-sharded KGAT/KGCN two-phase trainer (reference
    kgat_solver_bpr.py:284-348): the typed graph split over the ranks; the
    epoch's attention snapshot runs the two-pass sharded softmax on the
    rank's shard, the CF forward sums the ranks' partial aggregates, the
    TransR phase splits its batch rows, and the gradients are all-reduced
    once a step.  The epoch recipe and its draws are the single-process
    KGTrainer's: a KGTrainer on the mesh's device with its phase hooks
    swapped.  Eval stays the single-process one (the whole graph)."""
    from ..train.baseline_trainers import KGTrainer

    if mesh is None:
        mesh = make_pod_mesh(mp=1)
    trainer = KGTrainer(hin, cfg, _sharded_tcfg(tcfg, mesh), device=mesh.device,
                        transport=transport)
    trainer.mesh, trainer.n_dp = mesh, mesh.dp
    _shard_kg_hooks(trainer, mesh, transport)
    return trainer
