"""Row-sharded embedding lookups with all-to-all exchanges.

Port of the JAX package's ``parallel/sharded_embedding.py``.  The
reference keeps one dense ``Parameter(num_nodes, emb_dim)`` on one GPU
(reference models/base.py:156); the row-sharded path splits that table
over the ranks of one mesh axis, rank p owning rows [p S, (p + 1) S), and
gathers arbitrary global rows from it without all-gathering the table:

  sharded_lookup (dynamic ids: the batch's u / pos / neg / entity rows):
      sort the ids, dedupe, bucket by owner (``_dedupe_buckets``), exchange
      the id buckets (all-to-all), each owner gathers its rows, exchange
      the rows back, pick each request's row in sorted order, un-permute.
  static_lookup (static ids: each step's edge src / dst sets):
      the dedupe / bucket plan is built on the host once
      (``build_static_plan``), so no id crosses the wire: one all-to-all
      moves the requested rows.

Both are built from the port's pieces, so autograd gives the exact
transposes of JAX's ``custom_vjp``s (:100-117, :213-226) with no
hand-written backward: a gather ``table[serve]`` is ``ops/gather.gather_rows``
(K7 forward, K6 backward), the exchange ``parallel/collectives.all_to_all``
(backward the same exchange), and the pick ``got[own, pos]`` is
``gather_rows`` on the received buffer flattened to [P cap, D] at index
own * cap + pos, un-permuted by composing the index with the inverse sort
(one gather).  A request past its bucket's capacity maps to the sentinel
index P cap: K7 reads zeros there and K6 drops it.  (JAX's forward pick
clamps such a request to its bucket's last slot, another id's row, while
its backward drops it; the a2a path's capacities never overflow.)  Pass
``capacity >= min(num_ids, rows_per_shard)`` for exact results, or the
plan's measured capacity for static sets.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gather import gather_rows
from .collectives import all_to_all


def _axis_size(mesh, axis):
    return 1 if mesh is None else mesh.axis_size(axis)


# --------------------------------------------------------------- dynamic


def _dedupe_buckets(idx, S, num_shards, capacity):
    """Sort + dedupe ids, bucket by owner (= id // S).

    Returns (own, pos, order, send): for sorted position k the id lives in
    bucket (own[k], pos[k]), `order` is the sorting permutation, and
    ``send[p, :]`` holds the deduped local slots requested from owner p
    (unrequested slots 0; requests past `capacity` dropped)."""
    idx = idx.to(torch.int64)
    order = torch.argsort(idx, stable=True)
    s = idx[order]
    first = torch.ones_like(s)
    first[1:] = (s[1:] != s[:-1]).to(s.dtype)
    uniq_rank = torch.cumsum(first, 0) - 1  # rank among uniques (dups share it)
    own = s // S
    slot = s - own * S
    per_owner = torch.zeros(num_shards, dtype=s.dtype, device=s.device).index_add_(
        0, own, first)
    start = torch.cumsum(per_owner, 0) - per_owner
    pos = uniq_rank - start[own]
    send = torch.zeros((num_shards, capacity), dtype=torch.int32, device=s.device)
    keep = pos < capacity
    send[own[keep], pos[keep]] = slot[keep].to(torch.int32)
    return own, pos, order, send


def _pick_index(own, pos, num_shards, capacity):
    """own * capacity + pos as int32, the sentinel num_shards * capacity
    past a bucket's capacity."""
    flat = own * capacity + pos
    return torch.where(pos < capacity, flat, torch.full_like(flat, num_shards * capacity)).to(
        torch.int32)


def sharded_lookup(table, idx, mesh, axis, capacity, transport="f32"):
    """Rows `idx` of the table row-sharded over `axis` of `mesh`.

    table: [S, D] this rank's shard (rank p owns [p S, (p + 1) S)).
    idx:   int[B] global row ids in [0, P S).
    Returns [B, D] in table's dtype, differentiable in table (the
    gradient reaches the owners through the reverse exchange; K6 sums
    duplicates, its cotangents rounded to `transport`).  A mesh or axis of
    one rank makes no exchange."""
    P = _axis_size(mesh, axis)
    S, D = table.shape[0], table.shape[1]
    own, pos, order, send = _dedupe_buckets(idx, S, P, capacity)
    req = all_to_all(send.reshape(-1), mesh, axis)  # slots each peer asks of me
    rows = gather_rows(table, req, transport)  # [P cap, D]
    got = all_to_all(rows, mesh, axis)  # [P cap, D]: bucket p from owner p
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    pick = _pick_index(own, pos, P, capacity)[inv]
    return gather_rows(got, pick, transport)


def lookup_overflowed(idx, S, num_shards, capacity):
    """Diagnostic: True iff some owner bucket holds more distinct ids than
    `capacity` (requests beyond it are dropped)."""
    s = torch.sort(idx.to(torch.int64)).values
    first = torch.ones_like(s)
    first[1:] = (s[1:] != s[:-1]).to(s.dtype)
    per_owner = torch.zeros(num_shards, dtype=s.dtype, device=s.device).index_add_(
        0, s // S, first)
    return bool(per_owner.max() > capacity)


# ---------------------------------------------------------------- static


def build_static_plan(idx, S, num_shards, align=8):
    """Host-side exchange plan for a STATIC id set (per-step edge src/dst).

    idx: int[num_shards, E]: rank d's global row requests (row d).
    Returns a dict of numpy arrays, each with a leading rank axis:

      own  [P, E]       owner rank of each request
      pos  [P, E]       slot of the request inside its (rank, owner) bucket
      serve[P, P, cap]  serve[p, d] = local slots rank p gathers for d
    plus the ints capacity (the largest bucket, rounded up to `align`)
    and S."""
    idx = np.asarray(idx)
    P, E = idx.shape
    assert P == num_shards, (P, num_shards)
    own_e = np.empty((P, E), np.int32)
    pos_e = np.empty((P, E), np.int32)
    uniq = []
    cap = 1
    for d in range(P):
        u, inv = np.unique(idx[d], return_inverse=True)
        uo = u // S
        counts = np.bincount(uo, minlength=P)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        posu = np.arange(len(u)) - start[uo]
        own_e[d] = uo[inv]
        pos_e[d] = posu[inv]
        uniq.append((u, uo, posu))
        cap = max(cap, int(counts.max()) if len(counts) else 1)
    cap = -(-cap // align) * align
    serve = np.zeros((P, P, cap), np.int32)
    for d, (u, uo, posu) in enumerate(uniq):
        serve[uo, d, posu] = (u - uo.astype(np.int64) * S).astype(np.int32)
    return {
        "own": own_e,
        "pos": pos_e,
        "serve": serve,
        "capacity": int(cap),
        "S": int(S),
    }


def plan_arrays(plan, rank, device):
    """Rank `rank`'s rows of a plan's arrays as int32 tensors on `device`
    ({own, pos, serve}); the ints stay in the plan."""
    return {k: torch.from_numpy(np.ascontiguousarray(plan[k][rank], dtype=np.int32)).to(device)
            for k in ("own", "pos", "serve")}


def static_lookup(table, own, pos, serve, mesh, axis, capacity, transport="f32"):
    """Rows of the sharded `table` for a static id set: this rank's
    slices of a build_static_plan (`serve` the local slots it ships to
    each peer, `own` / `pos` each request's place in the receive buffer).
    One all-to-all of rows, no id traffic -> [E, D] in table's dtype,
    differentiable in table."""
    P = _axis_size(mesh, axis)
    rows = gather_rows(table, serve.reshape(-1), transport)  # [P cap, D]
    got = all_to_all(rows, mesh, axis)
    return gather_rows(got, _pick_index(own, pos, P, capacity), transport)
