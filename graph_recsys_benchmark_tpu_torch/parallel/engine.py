"""Sharded epoch engine: edge-parallel training as a product feature.

Port of the JAX package's ``parallel/engine.py`` for mode 'edge':
``ShardedPEATrainer`` presents the trainer interface the Solver drives
while every step runs over the ranks of the mesh (parallel/mesh.py): the
metapath edge sets and the batch rows are sharded, the parameters
replicated, node aggregates and gradients all-reduced
(parallel/edge_parallel.py).  ``make_sharded_kg_trainer`` does the same for
KGAT and KGCN.  Modes 'dp' and 'a2a' (the row-sharded embedding table)
raise NotImplementedError naming their ROADMAP item.

Batch parity: every rank draws the epoch's permutation and the whole
batch (negatives, entities) from the same generator, exactly as the
single-process trainer does, then keeps its rows; so a sharded run sees
the single-process run's batches.  The batch is rounded up to a multiple
of dp.  Evaluation is replicated: every rank runs the single-process eval
on its copy of the parameters (the graphs built with the hybrid plan off
and the GAT loops as edges, as the JAX trainer's), and the Solver's files
are written by rank 0.
"""

from __future__ import annotations

import dataclasses

from ..data.hin import HINData
from ..models.pea import PEAConfig
from ..ops.config import FlashGATMode
from ..train.pea_trainer import PEATrainer, TrainConfig
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
from .mesh import ROW_SHARDED_ITEM, Mesh
from .multihost import make_pod_mesh, process_local_rows


def _round_up(n, m):
    return -(-n // m) * m


def _check_mode(mode):
    if mode in ("dp", "a2a"):
        raise NotImplementedError(
            f"mode {mode!r}: the row-sharded embedding table is not ported: "
            f"{ROW_SHARDED_ITEM}")
    if mode != "edge":
        raise ValueError(f"mode {mode!r}: expected 'edge' (or 'dp' / 'a2a')")


def _sharded_tcfg(tcfg, mesh):
    bs = _round_up(tcfg.batch_size, mesh.dp)
    return tcfg if bs == tcfg.batch_size else dataclasses.replace(tcfg, batch_size=bs)


class ShardedPEATrainer(PEATrainer):
    """PEATrainer whose steps run over the ranks of `mesh` (default: the
    world, make_pod_mesh), on the mesh's device.  Mode 'edge' only.

    GAT channels of one depth with no dropout, one head and widths <= 125
    take the streaming route when some per-channel graph carries implicit
    self-loops (ML-25M, Yelp): each rank's shards of the per-channel
    graphs through K9-K11 (``_stream_edge_plan``: the groups and the
    rank's shards).  Everything else takes the union graphs' shards
    (``_edge_graphs``): GCN and SAGE through K7/K5, GAT on the
    edge-materialized route with the sharded softmax.  Attention dropout
    is not applied in edge mode, as in the JAX package."""

    _analytic_gat_loops = False  # the eval's graphs carry their loops as edges
    _use_hybrid_plan = False

    def __init__(self, hin: HINData, cfg: PEAConfig, tcfg: TrainConfig,
                 metapath_edges=None, mesh: Mesh | None = None, mode: str = "edge",
                 transport="f32", flash_mode=FlashGATMode()):
        _check_mode(mode)
        if mesh is None:
            mesh = make_pod_mesh(mp=1)
        self.mesh, self.mode, self.n_dp = mesh, mode, mesh.dp
        tcfg = _sharded_tcfg(tcfg, mesh)
        super().__init__(hin, cfg, tcfg, metapath_edges=metapath_edges, device=mesh.device,
                         transport=transport, flash_mode=flash_mode)
        edges = self._resolved_edges(hin, metapath_edges)
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
            groups, dist = plan_channel_shards(per_channel, mesh.dp)
            local = tuple(tuple(_local_view(d, mesh) for d in step) for step in dist)
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

    def train_step(self, params, optimizer, rows, row_mask, generator):
        """One step: the whole batch drawn as the single-process trainer
        draws it, this rank's rows of it through the sharded step.  Returns
        the total batch loss, detached, on the device."""
        batch = self._build_batch(rows, generator)
        return self._edge_step(params, optimizer, *self._place(batch, row_mask))

    def loss_and_grads(self, params, batch, row_mask):
        """The sharded step's total loss and all-reduced gradients (in
        .grad) on the global `batch`, no optimizer step."""
        return sharded_grads(self._edge_step.local_loss, params,
                             *self._place(batch, row_mask), self.mesh)


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
