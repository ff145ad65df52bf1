"""The 'dp' mode's step: a split batch and an embedding table row-sharded
over the model axis.

Port of the JAX package's ``parallel/spmd.py``.  The JAX step leaves its
collectives to GSPMD (``params['x']`` placed ``P('mp', None)``, the batch
``P('dp')``); here they are written out:

  params.x       each rank holds the rows of its mp index as its own
                 Parameter [emb_rows / mp, emb] (``shard_table``); every
                 other parameter is replicated;
  forward        all-gathers x over the mp group (collectives.all_gather),
                 then runs the trainer's own loss (models/pea.pea_loss on
                 its graphs, kernels and transport) on this rank's rows of
                 the batch, which is split over all dp * mp ranks;
  gradients      x's arrives reduce-scattered over mp (the all-gather's
                 backward): the sum of the mp group's cotangents of this
                 shard.  It still needs the sum over the dp group, the
                 ranks holding the same shard with other rows of the batch
                 (an all-reduce over dp).  Every replicated leaf needs the
                 sum over the whole world, in one flat all-reduce with the
                 loss (collectives.all_reduce_grads).  A wrong group shows
                 only at dp > 1 and mp > 1.

GAT attention dropout (``cfg.dropout > 0``): the JAX step hands the
single-device ``pea_loss`` its one key (JAX parallel/spmd.py:50-55), whose
union graphs leave the flash route for the composed one and drop the
normalized alphas under ``bernoulli(fold_in(key, k), 1 - p, [E, H])`` a
step (JAX models/pea.py:193-202, :268-272, :309-310).  Here each step draws
its ``DropoutMasks`` (models/pea.step_masks) from the epoch's generator after
the batch, one [E_union, heads] mask a step (models/pea.pea_forward_fused):
every rank holds the same generator state (engine.ShardedPEATrainer draws
the whole batch on every rank), so every rank draws the same global masks,
as the one GSPMD key does.  Every rank runs the whole union forward, so
masks that differ by rank (a2a.rank_generator, for a2a's edge shards)
would give the ranks different forwards.  GCN and SAGE ignore dropout.

Adam's moments for x are shard-shaped because the parameter is the shard:
the counterpart of JAX ``_opt_shardings``, with no structure matcher.
"""

from __future__ import annotations

import torch

from ..models.pea import pea_forward, pea_loss, step_masks
from ..ops.config import FlashGATMode
from ..train.engine import fill_grads
from .collectives import all_gather, all_reduce_, all_reduce_grads
from .multihost import process_local_rows


class _WithTable:
    """`model` seen with another embedding table `x` (the all-gathered
    one): every attribute but x is the model's own."""

    def __init__(self, model, x):
        self._model, self.x = model, x

    def __getattr__(self, name):
        return getattr(self._model, name)


def gathered(params, mesh):
    """`params` with x all-gathered over the mp axis (differentiable)."""
    return _WithTable(params, all_gather(params.x, mesh, "mp"))


def param_shardings(params, mesh):
    """{parameter name: the axis its rows are split over, or None}: x over
    'mp', the rest replicated (JAX param_shardings' layout)."""
    return {name: ("mp" if name == "x" else None) for name, _ in params.named_parameters()}


def shard_table(params, mesh):
    """Replace params.x by the rows of this rank's mp index (the whole
    table built on every rank from the seed, as the JAX placement does)."""
    mp, m = mesh.axis_size("mp"), mesh.axis_index("mp")
    rows = params.x.shape[0]
    if rows % mp:
        raise ValueError(f"{rows} table rows do not split over mp {mp}")
    per = rows // mp
    with torch.no_grad():
        params.x = torch.nn.Parameter(params.x[m * per:(m + 1) * per].clone())
    return params


def make_sharded_train_step(cfg, graphs, mesh, transport="f32", flash_mode=FlashGATMode()):
    """(step, place) of the dp mode over the trainer's `graphs`:
    step(params, optimizer, batch, row_mask, generator=None) -> the total
    loss on this rank's rows (place(batch, row_mask) takes them from the
    global batch); params sharded by shard_table first.  A GAT with
    cfg.dropout > 0 draws the step's masks from `generator` (None: no
    dropout, as the JAX loss without a key).  step.local_loss and
    step.grads are its pieces (grads leaves the reduced gradients in
    .grad)."""

    def local_loss(params, batch, row_mask, generator=None):
        return pea_loss(gathered(params, mesh), graphs, cfg, batch, row_mask=row_mask,
                        transport=transport, flash_mode=flash_mode,
                        masks=step_masks(cfg, generator))

    def grads(params, batch, row_mask, generator=None):
        for p in params.parameters():
            p.grad = None
        loss = local_loss(params, batch, row_mask, generator)
        loss.backward()
        fill_grads(params)
        all_reduce_(params.x.grad, mesh, axis="dp")
        rest = [p for p in params.parameters() if p is not params.x]
        return all_reduce_grads(rest, mesh, extra=loss.detach())

    def step(params, optimizer, batch, row_mask, generator=None):
        loss = grads(params, batch, row_mask, generator)
        optimizer.step()
        return loss

    def place(batch, row_mask):
        rows = process_local_rows(batch.shape[0], mesh)
        return batch[rows], row_mask[rows]

    step.local_loss, step.grads = local_loss, grads
    return step, place


@torch.no_grad()
def eval_forward(params, graphs, cfg, mesh, channel_mask=None, transport="f32",
                 flash_mode=FlashGATMode()):
    """The single-process cached representation over the all-gathered
    table, on every rank."""
    return pea_forward(gathered(params, mesh), graphs, cfg, channel_mask=channel_mask,
                       transport=transport, flash_mode=flash_mode)
