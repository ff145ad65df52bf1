"""Full-catalog ranking evaluation (north-star extension, BASELINE.json).

Port of the JAX package's ``eval/full_ranking.py``.  The reference protocol
ranks 1 positive against 99 *sampled* negatives (solvers.py:21-31); this
evaluator scores EVERY unseen item per test user, in chunks of users
(bounded memory), and derives the same closed-form HR/NDCG@k from the
full-catalog rank: the number of unseen items scored strictly above the
positive.

Dense candidate tables already enumerate each user's unseen items, so the
rank is counted over exactly that list; rejection-mode tables score the
whole item range and mask the (short) seen list.  The JAX function maps a
jitted chunk over a padded user range (``lax.map``); here the chunks are a
plain loop and the last one is short, which counts the same ranks.
"""

from __future__ import annotations

import torch

from .metrics import ranks_to_metrics


def _dense_ranks(score_fn, u, p, cand, counts):
    """Unseen items above the positive, over the dense table's columns 1.."""
    cd = cand[:, 1:]
    b, m = cd.shape
    pos_s = score_fn(u, p)
    neg_s = score_fn(torch.repeat_interleave(u, m), cd.reshape(-1)).reshape(b, m)
    valid = torch.arange(m, device=cd.device)[None, :] < counts[:, None]
    return ((neg_s > pos_s[:, None]) & valid).sum(dim=1, dtype=torch.int32)


def _rejection_ranks(score_fn, u, p, seen, item_lo, num_items):
    """Items above the positive over the whole catalog, each user's seen
    items (LOCAL ids, padded with num_items) masked out."""
    b = u.shape[0]
    items = item_lo + torch.arange(num_items, dtype=torch.int32, device=u.device)
    scores = score_fn(torch.repeat_interleave(u, num_items),
                      items.repeat(b)).reshape(b, num_items)
    mask = torch.zeros((b, num_items + 1), dtype=torch.bool, device=u.device)
    mask.scatter_(1, torch.clamp(seen.long(), max=num_items), True)
    unseen = ~mask[:, :num_items]
    pos_s = score_fn(u, p)
    return ((scores > pos_s[:, None]) & unseen).sum(dim=1, dtype=torch.int32)


def evaluate_full_ranking(score_fn, tables, chunk_users=128):
    """score_fn(u[B], i[B]) -> float[B] (int32 node ids).  Returns the mean
    HR/NDCG vectors over all test users (reference layout, 16 wide) and the
    per-user ranks (int32[U]).  tables: train.sampling.DeviceTables, dense
    or rejection."""
    users, pos = tables.test_users, tables.test_items
    chunks = []
    for c0 in range(0, users.shape[0], chunk_users):
        sl = slice(c0, c0 + chunk_users)
        if tables.mode == "dense":
            chunks.append(_dense_ranks(score_fn, users[sl], pos[sl], tables.cand[sl],
                                       tables.neg_counts[sl]))
        else:
            chunks.append(_rejection_ranks(score_fn, users[sl], pos[sl], tables.seen_all[sl],
                                           tables.item_lo, tables.num_items))
    ranks = torch.cat(chunks) if chunks else users.new_zeros(0)
    hr, ndcg = ranks_to_metrics(ranks)
    return {"HR": hr.mean(dim=0), "NDCG": ndcg.mean(dim=0), "ranks": ranks}
