"""PEA trainer: the JAX package's ``PEATrainer`` on the port's
``GraphEpochEngine`` (train/pea_trainer.py, train/engine.py).

The constructor builds the metapath channel graphs once on the host, as
the JAX trainer does (its train/pea_trainer.py:38-80), from
`metapath_edges` (default: the ml-latest-small table of the HIN), routed
as there:

  * GAT channels of one depth with ``cfg.fused`` get per-channel graphs
    with implicit self-loops past the streaming threshold
    (``_analytic_gat_loops``); if any graph carries them the grouped
    forward runs the per-channel graphs (ML-25M), else the channels go
    into the hybrid plan;
  * GCN and SAGE channels of one depth with ``cfg.fused`` go into one
    union graph a step (the fused path);
  * everything else (metapaths of mixed depth, or ``cfg.fused`` off) runs
    the per-channel graphs (graph.build_metapath_graphs): GAT of one depth
    on the grouped forward, the rest on the ungrouped forward, one conv a
    channel and step (models/pea.py).

Graphs (each distinct one once) and sampling tables move to `device`.
``run_epoch`` trains one BPR epoch (``pea_loss``: BPR + the entity-aware
regularizer, reference models/base.py:43-80) with the optimizer from
``optimizer(params)``; with GAT attention dropout (``cfg.dropout > 0``)
each step draws its keep masks from the epoch's generator (on the
trainer's device; ``models/pea.DropoutMasks``), and its forward runs the
per-channel graphs; ``evaluate`` makes one forward pass that caches every
node's representation and ranks 1 held-out positive against 99 sampled
negatives per test user; ``evaluate_full`` (train/engine.py) ranks it
against every unseen item.  ``train/solver.Solver`` drives them over runs
and epochs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..data.hin import HINData
from ..data.movielens import mlsmall_metapath_edges
from ..device import resolve_device
from ..eval.ranking import evaluate_ranking
from ..graph import build_fused_metapath_graphs, build_metapath_graphs, graphs_to
from ..models.pea import (
    PEA,
    PEAConfig,
    build_hybrid_gat_plan,
    pea_forward,
    pea_init,
    pea_loss,
    pea_predict,
    step_masks,
)
from ..ops.config import FlashGATMode
from ..ops.flash_gat import t_dtype_of
from .engine import GraphEpochEngine
from .optim import make_optimizer
from .sampling import build_device_tables


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Reference defaults: experiments/pea*_solver_bpr.py:28-55."""

    batch_size: int = 1024
    lr: float = 1e-3
    weight_decay: float = 1e-3
    opt: str = "adam"
    num_negative_samples: int = 4
    num_neg_candidates: int = 99
    sampling_strategy: str = "unseen"  # ml-small; 'random' for 25m/yelp
    epochs: int = 30
    runs: int = 5


class PEATrainer(GraphEpochEngine):
    """PEAGCN, PEAGAT or PEASage (`cfg.conv`).  `metapath_edges`: one list
    of (src, dst) step edges per channel, None = mlsmall_metapath_edges(hin)
    (ML-25M: data.movielens.ml25m_metapath_edges).  `device` None = the
    card (raises without one); `transport` 'f32' | 'bf16' is the message
    transport dtype of the edge kernels; `flash_mode` picks the routes of
    the union flash-GAT passes (ops/config.FlashGATMode: the online-max
    forward, the glue or one-pass backward; the default is the JAX
    package's default route)."""

    # Per-channel GAT graphs: None = implicit self-loops past the streaming
    # threshold (graph.build_gat_graph's auto rule); True forces them on
    # every graph, False off.
    _analytic_gat_loops = None
    # GAT channels of one depth go into the hybrid plan (or the grouped
    # forward); the edge-parallel trainer (parallel/engine.py) turns it off
    # and its eval runs the union graphs (JAX train/pea_trainer.py:46,54).
    _use_hybrid_plan = True

    def __init__(self, hin: HINData, cfg: PEAConfig, tcfg: TrainConfig,
                 metapath_edges=None, device=None, transport="f32",
                 flash_mode=FlashGATMode()):
        t_dtype_of(transport)  # validate
        if not isinstance(flash_mode, FlashGATMode):
            raise TypeError(f"flash_mode: expected a FlashGATMode, got {flash_mode!r}")
        self.device = resolve_device(device)
        self.hin, self.cfg, self.tcfg = hin, cfg, tcfg
        self.transport = transport
        self.flash_mode = flash_mode
        metapath_edges = self._resolved_edges(hin, metapath_edges)
        if len(metapath_edges) != cfg.num_channels:
            raise ValueError("one metapath per channel expected")
        depths = tuple(len(steps) for steps in metapath_edges)
        if depths != tuple(cfg.meta_path_steps):
            raise ValueError(f"metapath depths {depths} differ from meta_path_steps "
                             f"{tuple(cfg.meta_path_steps)}")
        uniform = len(set(cfg.meta_path_steps)) == 1
        if cfg.fused and uniform and cfg.conv == "gat" and self._use_hybrid_plan:
            per_channel = build_metapath_graphs(
                metapath_edges, hin.num_nodes, cfg.conv,
                analytic_gat_loops=self._analytic_gat_loops,
            )
            if any(g.gat_loops for ch in per_channel for g in ch):
                self.graphs = graphs_to(per_channel, self.device)  # grouped forward
            else:
                self.graphs = build_hybrid_gat_plan(per_channel, hin.num_nodes,
                                                    cfg).to(self.device)
        elif cfg.fused and uniform:
            self.graphs = tuple(
                g.to(self.device) for g in
                build_fused_metapath_graphs(metapath_edges, hin.num_nodes, cfg.conv)
            )
        else:  # the grouped (GAT of one depth) or the ungrouped forward
            self.graphs = graphs_to(build_metapath_graphs(
                metapath_edges, hin.num_nodes, cfg.conv,
                analytic_gat_loops=self._analytic_gat_loops,
            ), self.device)
        super().__init__(build_device_tables(hin, self.device), tcfg,
                         batch_loss=self.batch_loss, entity_aware=cfg.entity_aware)
        self._make_optimizer = make_optimizer(tcfg.opt, tcfg.lr, tcfg.weight_decay)

    @staticmethod
    def _resolved_edges(hin, metapath_edges):
        """`metapath_edges`, or the ml-latest-small table of the HIN."""
        return mlsmall_metapath_edges(hin) if metapath_edges is None else metapath_edges

    def init(self, seed: int) -> PEA:
        """Random parameters from `seed`, on the trainer's device."""
        gen = torch.Generator().manual_seed(seed)
        return pea_init(gen, self.cfg).to(self.device)

    def optimizer(self, params: PEA) -> torch.optim.Optimizer:
        """The configured optimizer (tcfg.opt, lr, weight_decay) over
        `params`; its state lives with the parameters."""
        return self._make_optimizer(params.parameters())

    def batch_loss(self, params: PEA, batch, row_mask, generator=None):
        """Summed BPR (+ entity) loss of one batch over the full-graph
        forward (train/pea_trainer.py:84-88).  A GAT with attention dropout
        draws the step's keep masks from `generator` (None: no dropout, as
        the JAX loss without a dropout key)."""
        return pea_loss(params, self.graphs, self.cfg, batch, row_mask=row_mask,
                        transport=self.transport, flash_mode=self.flash_mode,
                        masks=step_masks(self.cfg, generator))

    def eval_forward(self, params: PEA, channel_mask=None):
        """Cached representation of every node [num_nodes, R]."""
        return pea_forward(params, self.graphs, self.cfg, channel_mask=channel_mask,
                           transport=self.transport, flash_mode=self.flash_mode)

    def scorer(self, params: PEA, metapath_idx: Optional[int] = None):
        """score(u, i) -> float[B]: the pair scorer over one forward's cached
        representation, every channel on but `metapath_idx` (ablated)."""
        mask = torch.ones(self.cfg.num_channels, dtype=torch.float32, device=self.device)
        if metapath_idx is not None:
            mask[metapath_idx] = 0.0
        cached = self.eval_forward(params, mask)

        def score(u, i):
            return pea_predict(params, cached, u.long(), i.long())

        return score

    @torch.no_grad()
    def evaluate(self, params: PEA, generator: torch.Generator,
                 metapath_idx: Optional[int] = None):
        """99-negative ranking eval; metapath_idx ablates one channel."""
        return evaluate_ranking(
            generator, self.scorer(params, metapath_idx), self.tables,
            num_candidates=self.tcfg.num_neg_candidates,
        )
