"""PEA trainer: the JAX package's ``PEATrainer`` on the port's
``GraphEpochEngine`` (train/pea_trainer.py, train/engine.py).

The constructor builds the metapath channel graphs, the hybrid GAT plan and
the sampling tables once on the host and moves them to `device`.
``run_epoch`` trains one BPR epoch (``pea_loss``: BPR + the entity-aware
regularizer, reference models/base.py:43-80) with the optimizer from
``optimizer(params)``; ``evaluate`` makes one forward pass that caches every
node's representation and ranks 1 held-out positive against 99 sampled
negatives per test user.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..data.hin import HINData
from ..data.movielens import mlsmall_metapath_edges
from ..device import resolve_device
from ..eval.ranking import evaluate_ranking
from ..graph import build_metapath_graphs
from ..models.pea import (
    PEA,
    PEAConfig,
    build_hybrid_gat_plan,
    pea_forward,
    pea_init,
    pea_loss,
    pea_predict,
)
from ..ops.flash_gat import t_dtype_of
from .engine import GraphEpochEngine
from .optim import make_optimizer
from .sampling import build_device_tables


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Reference defaults: experiments/pea*_solver_bpr.py:28-55.  The
    solver's fields (epochs, runs) come with the solver (ROADMAP Queue 1
    item 6)."""

    batch_size: int = 1024
    lr: float = 1e-3
    weight_decay: float = 1e-3
    opt: str = "adam"
    num_negative_samples: int = 4
    num_neg_candidates: int = 99
    sampling_strategy: str = "unseen"  # ml-small; 'random' for 25m/yelp


class PEATrainer(GraphEpochEngine):
    """PEAGAT on the hybrid plan.  `device` None = the card (raises without
    one); `transport` 'f32' | 'bf16' is the message transport dtype of the
    GAT kernels."""

    def __init__(self, hin: HINData, cfg: PEAConfig, tcfg: TrainConfig,
                 device=None, transport="f32"):
        t_dtype_of(transport)  # validate
        self.device = resolve_device(device)
        self.hin, self.cfg, self.tcfg = hin, cfg, tcfg
        self.transport = transport
        metapath_edges = mlsmall_metapath_edges(hin)
        if len(metapath_edges) != cfg.num_channels:
            raise ValueError("one metapath per channel expected")
        # analytic_gat_loops=None: the JAX trainer's auto rule, which picks
        # the (unported) streaming layout only past its edge threshold
        per_channel = build_metapath_graphs(
            metapath_edges, hin.num_nodes, cfg.conv, analytic_gat_loops=None
        )
        self.graphs = build_hybrid_gat_plan(per_channel, hin.num_nodes, cfg).to(self.device)
        super().__init__(build_device_tables(hin, self.device), tcfg,
                         batch_loss=self.batch_loss, entity_aware=cfg.entity_aware)
        self._make_optimizer = make_optimizer(tcfg.opt, tcfg.lr, tcfg.weight_decay)

    def init(self, seed: int) -> PEA:
        """Random parameters from `seed`, on the trainer's device."""
        gen = torch.Generator().manual_seed(seed)
        return pea_init(gen, self.cfg).to(self.device)

    def optimizer(self, params: PEA) -> torch.optim.Optimizer:
        """The configured optimizer (tcfg.opt, lr, weight_decay) over
        `params`; its state lives with the parameters."""
        return self._make_optimizer(params.parameters())

    def batch_loss(self, params: PEA, batch, row_mask):
        """Summed BPR (+ entity) loss of one batch over the full-graph
        forward (train/pea_trainer.py:84-88)."""
        return pea_loss(params, self.graphs, self.cfg, batch, row_mask=row_mask,
                        transport=self.transport)

    def eval_forward(self, params: PEA, channel_mask=None):
        """Cached representation of every node [num_nodes, R]."""
        return pea_forward(params, self.graphs, self.cfg, channel_mask=channel_mask,
                           transport=self.transport)

    @torch.no_grad()
    def evaluate(self, params: PEA, generator: torch.Generator,
                 metapath_idx: Optional[int] = None):
        """99-negative ranking eval; metapath_idx ablates one channel."""
        mask = torch.ones(self.cfg.num_channels, dtype=torch.float32, device=self.device)
        if metapath_idx is not None:
            mask[metapath_idx] = 0.0
        cached = self.eval_forward(params, mask)

        def score(u, i):
            return pea_predict(params, cached, u.long(), i.long())

        return evaluate_ranking(
            generator, score, self.tables,
            num_candidates=self.tcfg.num_neg_candidates,
        )
