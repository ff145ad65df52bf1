"""Two-stage walk-based trainers: MetaPath2Vec and HeRec.

Port of the JAX package's ``train/walk_trainers.py``.

Stage 1 (both): metapath-guided random-walk skip-gram pretraining, the
reference's DataLoader-over-start-nodes loop (metapath2vec_solver_bpr.py:
197-222, one pass, SparseAdam), here a Python loop of eager steps over
batches of start nodes with the walker of models/metapath2vec.py, on the
trainer's device.

Stage 2:
  MetaPath2Vec: freeze the embedding, train the 2-layer-MLP pair scorer
    with BPR (metapath2vec_solver_bpr.py:225-300, models/walk.py).
  HeRec: one pretrained embedding per metapath (2 for ml / yelp,
    herec_solver_bpr.py:166-252), the fused MF model trained with MSE on
    ratings (models/herec.py; the engine's 'mse' mode).

Both have PEATrainer's API for the Solver (``device``, ``init(seed)``,
``optimizer(params)``, ``run_epoch``, ``evaluate``, ``evaluate_full``);
``init(seed)`` runs stage 1, or reads its embedding from the stage-1
cache, then draws the stage-2 parameters.  No repo kernel runs.
"""

from __future__ import annotations

import hashlib
import os

import torch

from ..data.hin import HINData
from ..device import resolve_device
from ..models import herec as M_herec
from ..models import metapath2vec as M_mp2v
from ..models import walk as M_walk
from .baseline_trainers import _Baseline
from .optim import SparseAdam

PACKAGE = __name__.split(".")[0]

ML_MP2V_STEPS = [
    ("user2item", False),
    ("genre2item", True),
    ("genre2item", False),
    ("user2item", True),
]  # uid -> iid -> genre -> iid -> uid (metapath2vec_solver_bpr.py:147-160)

ML_HEREC_METAPATHS = [
    ML_MP2V_STEPS,
    [("user2item", False), ("user2item", True)],
]  # herec_solver_bpr.py:166-177


RW_LR = 1e-3  # SparseAdam's learning rate in stage 1
RW_BATCH = 8  # start nodes a pretraining batch (metapath2vec_solver_bpr.py:197)


def pretrain_mp2v(hin: HINData, relation_steps, cfg: M_mp2v.MP2VConfig, seed, device=None):
    """One pass of skip-gram pretraining on `device` (None: the card) over a
    random order of the start nodes, padded with start 0 to whole batches of
    RW_BATCH (the padded starts walk too, as in the JAX package), with
    SparseAdam at RW_LR.  The embedding's init draws on the CPU from `seed`; the
    order and the walks from a generator on the device seeded with `seed`.
    Returns (the frozen embedding [num_nodes, D] on the device, the mean
    batch loss)."""
    dev = resolve_device(device)
    steps = M_mp2v.metapath_from_hin(hin, relation_steps, dev)
    params = M_mp2v.mp2v_init(torch.Generator().manual_seed(seed), cfg).to(dev)
    opt = SparseAdam(params.parameters(), lr=RW_LR)
    gen = torch.Generator(device=dev).manual_seed(seed)

    n_start, b = cfg.num_start, RW_BATCH
    n_batches = -(-n_start // b)
    order = torch.randperm(n_start, generator=gen, device=dev)
    order = torch.cat([order, order.new_zeros(n_batches * b - n_start)]).view(n_batches, b)
    losses = torch.empty(n_batches, dtype=torch.float32, device=dev)
    for i in range(n_batches):
        pos_rw = M_mp2v.sample_pos_walks(gen, order[i], steps, cfg)
        neg_rw = M_mp2v.sample_neg_walks(gen, order[i], steps, cfg)
        opt.zero_grad()
        loss = M_mp2v.mp2v_loss(params, pos_rw, neg_rw, cfg)
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    return params.emb.detach(), float(losses.mean())


def stage1_path(cache_dir, tag, hin, steps, cfg, seed, device):
    """The stage-1 cache file of a recipe: keyed by the package's name, the
    tag, the metapath, the walk config, RW_LR, RW_BATCH, seed, the HIN's
    size and the device type (the walks' random stream is the device's)."""
    key = hashlib.sha1(repr((PACKAGE, tag, steps, cfg, RW_LR, RW_BATCH, seed, hin.num_nodes,
                             device.type)).encode()).hexdigest()[:16]
    return os.path.join(cache_dir, f"random_walk_torch_{tag}_{key}.pt")


def _load_or_pretrain(cache_dir, tag, hin, steps, cfg, seed, device):
    """The stage-1 embedding with an on-disk cache, as the reference's
    ``random_walk_*.pkl`` (metapath2vec_solver_bpr.py:197-222): re-runs and
    resumes skip the pretraining pass.  The file is the port's own (a torch
    file, written atomically); a JAX ``.npz`` is never read, since its walks
    came from another random stream."""
    path = stage1_path(cache_dir, tag, hin, steps, cfg, seed, device) if cache_dir else None
    if path and os.path.isfile(path):
        data = torch.load(path, map_location=device, weights_only=True)
        return data["emb"], float(data["loss"])
    emb, loss = pretrain_mp2v(hin, steps, cfg, seed, device=device)
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save({"emb": emb.cpu(), "loss": loss}, tmp)
        os.replace(tmp, path)
    return emb, loss


class _WalkTrainer(_Baseline):
    """Stage 1 around the Solver's API; `device` None = the card."""

    def _stage1(self, tag, steps, seed):
        return _load_or_pretrain(self.cache_dir, tag, self.hin, steps, self.cfg, seed,
                                 self.device)


class MetaPath2VecTrainer(_WalkTrainer):
    """Stage 2 on the frozen embedding of `relation_steps` (default the ml
    metapath); ``init(seed)`` runs or reuses stage 1."""

    def __init__(self, hin: HINData, cfg: M_mp2v.MP2VConfig, tcfg, relation_steps=None,
                 cache_dir=None, device=None):
        tables = self._setup(hin, cfg, tcfg, device)
        self.cache_dir = cache_dir
        self.relation_steps = relation_steps or ML_MP2V_STEPS
        self.embedding = None  # set at init()
        self.rw_loss = None
        super().__init__(tables, tcfg, self.batch_loss,
                         eval_forward=lambda _params: self.embedding,
                         predict=M_walk.walk_predict)

    def batch_loss(self, params, batch, row_mask, generator=None):
        return M_walk.walk_bpr_loss(params, self.embedding, batch, row_mask)

    def init(self, seed: int):
        self.embedding, self.rw_loss = self._stage1("mp2v", self.relation_steps, seed)
        gen = torch.Generator().manual_seed(seed)
        return M_walk.walk_init(gen, self.cfg.embedding_dim).to(self.device)


class HeRecTrainer(_WalkTrainer):
    """Stage 2 on one frozen embedding a metapath (default the ml pair);
    ``init(seed)`` runs or reuses stage 1, metapath k with seed
    ``seed + 1000 k``."""

    def __init__(self, hin: HINData, cfg: M_mp2v.MP2VConfig, tcfg, metapaths=None,
                 cache_dir=None, device=None):
        tables = self._setup(hin, cfg, tcfg, device)
        self.cache_dir = cache_dir
        self.metapaths = metapaths or ML_HEREC_METAPATHS
        self.rk_embeddings = None  # set at init()
        self.acc_uids = hin.type_accs[hin.types[0]]
        self.acc_iids = hin.item_acc
        super().__init__(tables, tcfg, self.batch_loss, predict=self.predict, loss_mode="mse")

    def batch_loss(self, params, batch, row_mask, generator=None):
        pair, rating = batch
        return M_herec.herec_mse_loss(params, self.rk_embeddings, self.acc_uids,
                                      self.acc_iids, pair, rating, row_mask)

    def predict(self, params, _cached, u, i):
        return M_herec.herec_predict(params, self.rk_embeddings, self.acc_uids,
                                     self.acc_iids, u, i)

    def init(self, seed: int):
        self.rk_embeddings = tuple(self._stage1(f"herec{k}", mp, seed + 1000 * k)[0]
                                   for k, mp in enumerate(self.metapaths))
        gen = torch.Generator().manual_seed(seed)
        hin = self.hin
        return M_herec.herec_init(gen, hin.num_users, hin.num_items, self.cfg.embedding_dim,
                                  len(self.metapaths)).to(self.device)
