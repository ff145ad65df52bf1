"""Vectorized leave-one-out ranking evaluation (1 pos + 99 sampled negatives).

Port of the JAX package's ``eval/ranking.py``: negatives are sampled for
every test user at once (train/sampling.py), all candidate scores come from
one batched predict, and HR/NDCG/AUC from the closed-form rank
(eval/metrics.py).  Sampling parity: the reference draws 99 negatives per
user per evaluation with replacement from that user's unseen-item list
(np.random.choice, solvers.py:29).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rank_candidates(score_fn, test_users, test_pos, neg_items):
    """score_fn(u[B], i[B]) -> float[B]; returns (pos_scores[U], neg_scores[U, C])."""
    u, c = neg_items.shape
    pos_scores = score_fn(test_users, test_pos)
    neg_scores = score_fn(
        torch.repeat_interleave(test_users, c), neg_items.reshape(-1)
    ).reshape(u, c)
    return pos_scores, neg_scores


def eval_loss_per_user(pos_scores, neg_scores):
    """Per-user eval loss of the graph models, GraphRecsysModel.loss
    (base.py:43-48): -Σ_j log σ(pos - neg_j).  The other families' forms
    come with those families (ROADMAP Queue 1, "Baselines")."""
    return torch.sum(F.softplus(-(pos_scores[:, None] - neg_scores)), dim=1)


def evaluate_ranking(generator, score_fn, tables, num_candidates=99):
    """Full eval pass -> dict of mean metrics over the test users in the
    reference layout (HR[16], NDCG[16], AUC, eval_loss, ranks[U]).

    tables: train.sampling.DeviceTables; generator draws the negatives."""
    from ..train.sampling import sample_eval_negatives
    from .metrics import hit_vec_metrics

    neg_items = sample_eval_negatives(generator, tables, num_candidates)
    pos_scores, neg_scores = rank_candidates(
        score_fn, tables.test_users, tables.test_items, neg_items
    )
    hr, ndcg, auc, ranks = hit_vec_metrics(pos_scores, neg_scores)
    return {
        "HR": hr.mean(dim=0),
        "NDCG": ndcg.mean(dim=0),
        "AUC": auc.mean(),
        "eval_loss": eval_loss_per_user(pos_scores, neg_scores).mean(),
        "ranks": ranks,
    }
