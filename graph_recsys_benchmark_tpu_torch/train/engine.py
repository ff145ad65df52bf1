"""Shared training engine: the epoch and the ranking eval of the JAX
package's ``GraphEpochEngine`` (train/engine.py).

Every model family in the reference shares one outer recipe
(solvers.py:191-248): per epoch, resample negatives over all train rows,
iterate batches, then rank 1 positive + 99 sampled negatives per test user.
The JAX engine runs an epoch as one jitted ``lax.scan``; here it is a
Python loop of eager steps whose shapes never change: the epoch's
permutation is padded to whole batches and the padding rows carry
``row_mask`` 0, so the last partial batch sums the same loss as JAX's
(train/engine.py:158-194) and a later PR can capture the step in a CUDA
graph.  Losses stay on the device; nothing syncs with the host inside the
epoch.

Families plug in ``batch_loss(params, batch, row_mask, generator)`` (the
generator the step samples with, for a family that draws more, such as
dropout's masks), which returns the scalar loss, or with ``has_state``
(loss, new model state) that the step stores with ``params.set_state``
after the optimizer (NFM's BatchNorm statistics, module buffers that no
optimizer reaches).  The ranking eval scores with ``scorer(params)``, by
default ``predict(params, eval_forward(params), u, i)`` over one cached
forward (JAX ``_evaluate``, :201-226), node ids shifted by ``mf_offsets``
(user_lo, item_lo) into 0-based user / item tables where the family says
so (solvers.py:69-71, 204-210).

Loss modes (JAX :83-94, :108-153), each with its rows and batch columns:
  'bpr' — one row per (train interaction, negative draw): (u, pos, neg
          [, entity columns]);
  'bce' — the positives then one row per negative draw: (u, item, label);
  'kg'  — one row per typed edge: (h, t, uniform corrupted tail, rel);
  'mse' — one row per rated interaction, no sampling: the batch is the
          pair (int64 [B, 2] (u, item), float32 [B] rating) (HeRec's).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .sampling import DeviceTables, sample_cf_negatives, sample_entities

LOSS_MODES = ("bpr", "bce", "mse", "kg")
EVAL_LOSS_FORMS = {"bpr": "bpr", "bce": "bce", "mse": "mse", "kg": "zero"}


def fill_grads(params: torch.nn.Module):
    """A zero gradient for every parameter that the loss did not reach:
    optax updates every leaf (weight decay and Adam's moments move it, and
    its step count is the optimizer's global one, JAX train/optim.py:66-71),
    where torch's optimizers skip a parameter whose ``.grad`` is None."""
    for p in params.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)


class GraphEpochEngine:
    def __init__(self, tables: DeviceTables, tcfg, batch_loss: Callable,
                 entity_aware: bool = False, *, eval_forward: Optional[Callable] = None,
                 predict: Optional[Callable] = None, mf_offsets=None, loss_mode: str = "bpr",
                 has_state: bool = False, kg_edges: Optional[torch.Tensor] = None,
                 num_nodes: Optional[int] = None, eval_loss_form: Optional[str] = None):
        if loss_mode not in LOSS_MODES:
            raise ValueError(f"loss_mode {loss_mode!r}: expected one of {LOSS_MODES}")
        if loss_mode == "kg" and (kg_edges is None or num_nodes is None):
            raise ValueError("loss_mode 'kg' needs kg_edges and num_nodes")
        self.tables = tables
        self.tcfg = tcfg
        self._batch_loss = batch_loss
        self.entity_aware = entity_aware
        self._eval_forward = eval_forward
        self._predict = predict
        self.mf_offsets = mf_offsets
        self.loss_mode = loss_mode
        self.has_state = has_state
        self.kg_edges = kg_edges
        self.num_nodes = num_nodes
        self.eval_loss_form = eval_loss_form or EVAL_LOSS_FORMS[loss_mode]
        ei = tables.train_pos.shape[0]
        if loss_mode == "bpr":
            self.n_rows = ei * tcfg.num_negative_samples
        elif loss_mode == "bce":  # pos rows + num_neg negative rows (movielens.py:887-917)
            self.n_rows = ei * (1 + tcfg.num_negative_samples)
        elif loss_mode == "mse":  # one row per rated interaction (movielens.py:918-919)
            self.n_rows = ei
        else:  # one row per typed edge, corrupted tail (movielens.py:861-877)
            self.n_rows = int(kg_edges.shape[0])
        self.num_batches = -(-self.n_rows // tcfg.batch_size)

    def _build_batch(self, rows, generator):
        """rows: int64[B] global row indices -> the loss mode's int64 batch
        columns (train/engine.py:108-153), user / item ids shifted by
        mf_offsets; 'mse' gives (pair, rating)."""
        if self.loss_mode == "kg":
            return self._kg_batch(rows, generator)
        tables = self.tables
        ei = tables.train_pos.shape[0]
        inter = rows % ei
        u_lo, i_lo = self.mf_offsets or (0, 0)
        if self.loss_mode == "mse":
            pair = tables.train_pos[inter].long() - rows.new_tensor([u_lo, i_lo])
            return pair, tables.ratings[inter]
        u = tables.train_pos[inter, 0]
        pos_i = tables.train_pos[inter, 1]
        neg_i = sample_cf_negatives(generator, u, tables, self.tcfg.sampling_strategy)
        if self.loss_mode == "bce":  # row < ei: positive (label 1), else a negative
            is_pos = rows < ei
            batch = torch.stack([u, torch.where(is_pos, pos_i, neg_i), is_pos.int()],
                                dim=1).long()
            shift = [u_lo, i_lo, 0]
        else:
            cols = [u[:, None], pos_i[:, None], neg_i[:, None]]
            if self.entity_aware:
                cols.append(sample_entities(generator, u, pos_i, tables))
            batch = torch.cat(cols, dim=1).long()
            shift = [u_lo, i_lo, i_lo] + [0] * (batch.shape[1] - 3)
        if self.mf_offsets is not None:
            batch = batch - batch.new_tensor(shift)
        return batch

    def _kg_batch(self, rows, generator):
        """(h, t, corrupted tail uniform over the nodes, rel) of the typed
        edges `rows` (JAX :123-126)."""
        e = self.kg_edges[rows].long()
        neg_t = torch.randint(0, self.num_nodes, (rows.shape[0],), generator=generator,
                              device=rows.device)
        return torch.stack([e[:, 0], e[:, 1], neg_t, e[:, 2]], dim=1)

    def _step(self, params: torch.nn.Module, optimizer, loss_fn):
        """loss_fn(), backward, optimizer step over every parameter
        (fill_grads), then the new model state where the family has one.
        Returns the loss, detached, on the device."""
        optimizer.zero_grad()
        out = loss_fn()
        loss, new_state = out if self.has_state else (out, None)
        loss.backward()
        fill_grads(params)
        optimizer.step()
        if self.has_state:
            params.set_state(new_state)
        return loss.detach()

    def train_step(self, params: torch.nn.Module, optimizer, rows, row_mask, generator):
        """One step on the batch of `rows`: sample, loss, backward,
        optimizer step.  Returns the batch loss, detached, on the device."""
        batch = self._build_batch(rows, generator)
        return self._step(params, optimizer,
                          lambda: self._batch_loss(params, batch, row_mask, generator))

    def _scan(self, generator, n_rows, step):
        """step(rows, row_mask) over a random order of n_rows rows drawn by
        `generator` (on the tables' device), padded to whole batches; the
        mean step loss, a 0-dim tensor on the device."""
        dev = self.tables.train_pos.device
        bs = self.tcfg.batch_size
        num_batches = -(-n_rows // bs)
        n_pad = num_batches * bs
        perm = torch.randperm(n_rows, generator=generator, device=dev)
        perm = torch.cat([perm, perm.new_zeros(n_pad - n_rows)])
        mask_all = (torch.arange(n_pad, device=dev) < n_rows).float()
        losses = torch.empty(num_batches, dtype=torch.float32, device=dev)
        for b in range(num_batches):
            window = slice(b * bs, (b + 1) * bs)
            losses[b] = step(perm[window], mask_all[window])
        return losses.mean()

    def run_epoch(self, params: torch.nn.Module, optimizer, generator):
        """One epoch over every row of the loss mode in a random order drawn
        by `generator`, one train_step per batch.  Updates `params` in
        place and returns the mean batch loss, a 0-dim tensor on the
        device."""
        return self._scan(generator, self.n_rows,
                          lambda rows, mask: self.train_step(params, optimizer, rows, mask,
                                                             generator))

    def scorer(self, params: torch.nn.Module):
        """score(u, i) -> float[B] over one eval forward (node ids, shifted
        by mf_offsets for the family's tables)."""
        cached = None if self._eval_forward is None else self._eval_forward(params)
        u_lo, i_lo = self.mf_offsets or (0, 0)

        def score(u, i):
            return self._predict(params, cached, u.long() - u_lo, i.long() - i_lo)

        return score

    @torch.no_grad()
    def evaluate(self, params: torch.nn.Module, generator: torch.Generator):
        """99-negative ranking eval (JAX ``evaluate``); the eval loss in the
        family's form.  The baselines have no metapaths to ablate."""
        from ..eval.ranking import evaluate_ranking

        return evaluate_ranking(generator, self.scorer(params), self.tables,
                                num_candidates=self.tcfg.num_neg_candidates,
                                loss_form=self.eval_loss_form)

    @torch.no_grad()
    def evaluate_full(self, params: torch.nn.Module):
        """Full-catalog ranking (every unseen item per test user) over one
        forward with every channel on, the north-star extension of the
        99-negative protocol (JAX train/engine.py:243-248); HR and NDCG
        vectors and per-user ranks, on the device."""
        from ..eval.full_ranking import evaluate_full_ranking

        return evaluate_full_ranking(self.scorer(params), self.tables)
