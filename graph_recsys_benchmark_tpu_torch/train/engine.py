"""Shared training engine: the BPR epoch of the JAX package's
``GraphEpochEngine`` (train/engine.py).

Every model family in the reference shares one outer recipe
(solvers.py:191-248): per epoch, resample negatives over all train
interactions and iterate batches.  The JAX engine runs an epoch as one
jitted ``lax.scan``; here it is a Python loop of eager steps whose shapes
never change: the epoch's permutation is padded to whole batches and the
padding rows carry ``row_mask`` 0, so the last partial batch sums the same
loss as JAX's (train/engine.py:158-194) and a later PR can capture the step
in a CUDA graph.  Losses stay on the device; nothing syncs with the host
inside the epoch.

Families plug in ``batch_loss(params, batch, row_mask, generator) -> scalar``
(the generator the step samples with, for a family that draws more, such
as attention dropout's masks) and, for the full-catalog eval, a method
``scorer(params) -> score(u, i)``.  Only
the 'bpr' loss mode is ported (the flagship's); bce, mse and kg come with
the baseline families (ROADMAP Queue 1, "Baselines").
"""

from __future__ import annotations

from typing import Callable

import torch

from .sampling import DeviceTables, sample_cf_negatives, sample_entities


class GraphEpochEngine:
    def __init__(self, tables: DeviceTables, tcfg, batch_loss: Callable,
                 entity_aware: bool = False):
        self.tables = tables
        self.tcfg = tcfg
        self._batch_loss = batch_loss
        self.entity_aware = entity_aware
        # bpr: one row per (train interaction, negative draw)
        # (train/engine.py:83-85)
        self.n_rows = tables.train_pos.shape[0] * tcfg.num_negative_samples
        self.num_batches = -(-self.n_rows // tcfg.batch_size)

    def _build_batch(self, rows, generator):
        """rows: int64[B] global row indices -> int64[B, 3] (u, pos_i, neg_i),
        or [B, 9] with the entity-aware columns (train/engine.py:114-122)."""
        tables = self.tables
        inter = rows % tables.train_pos.shape[0]
        u = tables.train_pos[inter, 0]
        pos_i = tables.train_pos[inter, 1]
        neg_i = sample_cf_negatives(generator, u, tables, self.tcfg.sampling_strategy)
        cols = [u[:, None], pos_i[:, None], neg_i[:, None]]
        if self.entity_aware:
            cols.append(sample_entities(generator, u, pos_i, tables))
        return torch.cat(cols, dim=1).long()

    def train_step(self, params: torch.nn.Module, optimizer, rows, row_mask, generator):
        """One step on the batch of `rows`: sample, loss, backward,
        optimizer step.  Returns the batch loss, detached, on the device."""
        batch = self._build_batch(rows, generator)
        optimizer.zero_grad()
        loss = self._batch_loss(params, batch, row_mask, generator)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def run_epoch(self, params: torch.nn.Module, optimizer, generator):
        """One epoch over every (interaction, negative) row in a random order
        drawn by `generator` (on the tables' device), one train_step per
        batch.  Updates `params` in place and returns the mean batch loss, a
        0-dim tensor on the device."""
        dev = self.tables.train_pos.device
        bs = self.tcfg.batch_size
        n_pad = self.num_batches * bs
        perm = torch.randperm(self.n_rows, generator=generator, device=dev)
        perm = torch.cat([perm, perm.new_zeros(n_pad - self.n_rows)])
        mask_all = (torch.arange(n_pad, device=dev) < self.n_rows).float()
        losses = torch.empty(self.num_batches, dtype=torch.float32, device=dev)
        for b in range(self.num_batches):
            window = slice(b * bs, (b + 1) * bs)
            losses[b] = self.train_step(params, optimizer, perm[window], mask_all[window],
                                        generator)
        return losses.mean()

    @torch.no_grad()
    def evaluate_full(self, params: torch.nn.Module):
        """Full-catalog ranking (every unseen item per test user) over one
        forward with every channel on, the north-star extension of the
        99-negative protocol (JAX train/engine.py:243-248); HR and NDCG
        vectors and per-user ranks, on the device."""
        from ..eval.full_ranking import evaluate_full_ranking

        return evaluate_full_ranking(self.scorer(params), self.tables)
