"""Trainers for the baseline zoo: NGCF, KGAT, KGCN, CFKG, NFM.

Port of the JAX package's ``train/baseline_trainers.py``; each mirrors its
experiment driver in the reference:
  NGCF : bidirectional user-item graph, BPR (ngcf_solver_bpr.py:102-107);
         a step launches K7 9, K5 6, K6 3 on the card (three convs)
  KGAT/KGCN : two-phase epoch — a KG TransR phase over the original typed
    edges, one attention snapshot over the full graph (K8 1, K7 1), a CF
    BPR phase with the map frozen (kgat_solver_bpr.py:284-348), both
    phases on one optimizer; a CF step launches K7 6, K5 3, K6 3, a KG
    step none
  CFKG : KG-only training over typed edges, exp((u+r)·i) ranking
    (cfkg_solver_bpr.py:95-106, 222-253); no kernel
  NFM : (uid, iid) factorization machine, MSE on the bce rows' labels,
    BatchNorm statistics as module buffers (nfm_solver_bce.py,
    models/nfm.py); no kernel

Every trainer has PEATrainer's API for the Solver (``device``,
``init(seed)``, ``optimizer(params)``, ``run_epoch``, ``evaluate``,
``evaluate_full``).  Graphs and tables go to the trainer's device once;
nothing syncs with the host inside an epoch.  Dropout (NGCF, KG, NFM)
takes its keep masks from the step's generator (models/ngcf.KeepMasks).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.hin import HINData
from ..device import resolve_device
from ..graph import build_kg_graph, build_ngcf_graph
from ..models import cfkg as M_cfkg
from ..models import kg as M_kg
from ..models import nfm as M_nfm
from ..models import ngcf as M_ngcf
from ..models.ngcf import KeepMasks
from ..ops.flash_gat import t_dtype_of
from .engine import GraphEpochEngine
from .optim import make_optimizer
from .sampling import build_device_tables


def _bidirectional_user_item(hin: HINData):
    e = hin.edge_index["user2item"]
    src = np.concatenate([e[0], e[1]])
    dst = np.concatenate([e[1], e[0]])
    return src, dst


def _typed_edges(hin: HINData):
    """int32 [E, 3] (h, t, rel) over all relations in edge_type_dict order."""
    hs, ts, rs = [], [], []
    for name, rel in hin.edge_type_dict.items():
        e = hin.edge_index[name]
        hs.append(e[0])
        ts.append(e[1])
        rs.append(np.full(e.shape[1], rel, dtype=np.int64))
    return np.stack(
        [np.concatenate(hs), np.concatenate(ts), np.concatenate(rs)]
    ).T.astype(np.int32)


def _masks(rate, generator):
    """A training step's dropout masks, drawn from its generator (None: no
    dropout)."""
    return KeepMasks(rate, generator) if rate > 0.0 and generator is not None else None


class _Baseline(GraphEpochEngine):
    """The Solver's API around a family's ``init_fn(generator, cfg)``; `device`
    None = the card (raises without one)."""

    init_fn = None

    def _setup(self, hin: HINData, cfg, tcfg, device, transport="f32"):
        t_dtype_of(transport)  # validate
        self.device = resolve_device(device)
        self.hin, self.cfg, self.transport = hin, cfg, transport
        self._make_optimizer = make_optimizer(tcfg.opt, tcfg.lr, tcfg.weight_decay)
        return build_device_tables(hin, self.device)

    def init(self, seed: int):
        """Random parameters from `seed`, on the trainer's device."""
        return type(self).init_fn(torch.Generator().manual_seed(seed), self.cfg).to(self.device)

    def optimizer(self, params) -> torch.optim.Optimizer:
        """The configured optimizer (tcfg.opt, lr, weight_decay) over the
        parameters (never NFM's BatchNorm buffers)."""
        return self._make_optimizer(params.parameters())


class NGCFTrainer(_Baseline):
    init_fn = staticmethod(M_ngcf.ngcf_init)

    def __init__(self, hin: HINData, cfg: M_ngcf.NGCFConfig, tcfg, device=None,
                 transport="f32"):
        tables = self._setup(hin, cfg, tcfg, device, transport)
        src, dst = _bidirectional_user_item(hin)
        self.graph = build_ngcf_graph(src, dst, hin.num_nodes).to(self.device)
        super().__init__(tables, tcfg, self.batch_loss, entity_aware=cfg.entity_aware,
                         eval_forward=self.eval_forward, predict=M_ngcf.ngcf_predict)

    def batch_loss(self, params, batch, row_mask, generator=None):
        return M_ngcf.ngcf_loss(params, self.graph, self.cfg, batch, row_mask=row_mask,
                                transport=self.transport,
                                masks=_masks(self.cfg.dropout, generator))

    def eval_forward(self, params):
        return M_ngcf.ngcf_forward(params, self.graph, self.cfg, transport=self.transport)


class CFKGTrainer(_Baseline):
    init_fn = staticmethod(M_cfkg.cfkg_init)

    def __init__(self, hin: HINData, cfg: M_cfkg.CFKGConfig, tcfg, device=None):
        tables = self._setup(hin, cfg, tcfg, device)
        kg_edges = torch.from_numpy(_typed_edges(hin)).to(self.device)
        super().__init__(
            tables, tcfg, lambda p, b, m, _gen: M_cfkg.cfkg_kg_loss(p, b, m),
            predict=lambda p, _cached, u, i: M_cfkg.cfkg_predict(p, cfg, u, i),
            loss_mode="kg", kg_edges=kg_edges, num_nodes=hin.num_nodes,
        )


class NFMTrainer(_Baseline):
    init_fn = staticmethod(M_nfm.nfm_init)

    def __init__(self, hin: HINData, cfg: M_nfm.NFMConfig, tcfg, device=None):
        tables = self._setup(hin, cfg, tcfg, device)
        super().__init__(
            tables, tcfg, self.batch_loss,
            predict=lambda p, _cached, u, i: M_nfm.nfm_forward(p, cfg, u, i)[0],
            mf_offsets=(hin.type_accs[hin.types[0]], hin.item_acc),
            loss_mode="bce",
            has_state=True,
            # NFM overrides MFRecsysModel.loss with MSELoss (nfm.py:21-33),
            # so its eval-loss column is the MSE form, not BCE
            eval_loss_form="mse",
        )

    def batch_loss(self, params, batch, row_mask, generator=None):
        return M_nfm.nfm_mse_loss(params, self.cfg, batch, row_mask,
                                  masks=_masks(self.cfg.dropout, generator))


class KGTrainer(_Baseline):
    """KGAT/KGCN two-phase trainer (``run_epoch``: the KG phase, one
    attention snapshot, the CF phase)."""

    init_fn = staticmethod(M_kg.kg_init)

    def __init__(self, hin: HINData, cfg: M_kg.KGConfig, tcfg, device=None, transport="f32"):
        tables = self._setup(hin, cfg, tcfg, device, transport)
        typed = _typed_edges(hin)
        # model graph: edges + reversed with negated relation ids
        src = np.concatenate([typed[:, 0], typed[:, 1]])
        dst = np.concatenate([typed[:, 1], typed[:, 0]])
        rel = np.concatenate([typed[:, 2], -typed[:, 2]])
        self.graph = build_kg_graph(src, dst, rel, hin.num_nodes).to(self.device)
        super().__init__(tables, tcfg, self._cf_batch_loss, eval_forward=self._forward_with_att,
                         predict=M_kg.kg_predict)
        # the KG phase's rows (the engine's kg batches); the CF phase is 'bpr'
        self.kg_edges = torch.from_numpy(typed).to(self.device)
        self.num_nodes = hin.num_nodes
        self.kg_rows = int(typed.shape[0])
        self.kg_batches = -(-self.kg_rows // tcfg.batch_size)

    def att_snapshot(self, params):
        """The attention map of the current weights (no gradient)."""
        return M_kg.compute_att_map(params, self.graph, self.cfg, self.transport)

    def _cf_batch_loss(self, params, batch, row_mask, generator=None):
        # a standalone step (train_step) on the whole graph; the epoch's CF
        # phase freezes one map
        return M_kg.kg_cf_loss(params, self.graph, self.cfg, self.att_snapshot(params), batch,
                               row_mask, transport=self.transport,
                               masks=_masks(self.cfg.dropout, generator))

    # The epoch's phase hooks (JAX baseline_trainers.py:148-167): the
    # edge-sharded trainer (parallel/engine.make_sharded_kg_trainer) swaps
    # each, and the engine's _step, for its own while run_epoch and its
    # draws stay as they are.
    def _kg_loss(self, params, batch, row_mask):
        return M_kg.transr_kg_loss(params, batch, row_mask)

    def _att_snapshot(self, params):
        return self.att_snapshot(params)

    def _cf_loss(self, params, att, batch, row_mask, generator):
        return M_kg.kg_cf_loss(params, self.graph, self.cfg, att, batch, row_mask,
                               transport=self.transport,
                               masks=_masks(self.cfg.dropout, generator))

    def _forward_with_att(self, params):
        return M_kg.kg_forward(params, self.graph, self.cfg, self.att_snapshot(params),
                               transport=self.transport)

    def kg_step(self, params, optimizer, rows, row_mask, generator):
        """One TransR step of the KG phase on the typed edges `rows`."""
        batch = self._kg_batch(rows, generator)
        return self._step(params, optimizer, lambda: self._kg_loss(params, batch, row_mask))

    def run_epoch(self, params, optimizer, generator):
        """Phase A: the KG TransR scan; ONE attention-map snapshot; phase B:
        the CF BPR scan with the frozen map — the reference's epoch
        (kgat_solver_bpr.py:284-348).  Returns {"train_loss": the CF
        phase's mean, "kg_train_loss": the KG phase's}, 0-dim tensors on
        the device (the reference tracks both, :364-375)."""
        kg_loss = self._scan(generator, self.kg_rows,
                             lambda rows, mask: self.kg_step(params, optimizer, rows, mask,
                                                             generator))
        att = self._att_snapshot(params)

        def cf_step(rows, mask):
            batch = self._build_batch(rows, generator)
            return self._step(params, optimizer,
                              lambda: self._cf_loss(params, att, batch, mask, generator))

        cf_loss = self._scan(generator, self.n_rows, cf_step)
        return {"train_loss": cf_loss, "kg_train_loss": kg_loss}
