"""Heterogeneous information network container with static padded tables.

A copy of the JAX package's ``data/hin.py`` (numpy only):

  * `CandidateTables`: per-user padded unseen-item tables.  Column 0 is the
    held-out test item; columns 1.. are the user's never-interacted items.
    Evaluation draws from columns [1, 1+count) (reference solvers.py:28-29).
  * `RejectionCandidates`: the large-scale alternative (ML-25M): per-user
    padded SEEN lists, from which train/sampling.py draws unseen items
    exactly uniformly over the complement.
  * `EntityFeatureTables`: per-item / per-user padded entity-feature node
    ids + counts, plus per-node type ranges [ent_lo, ent_hi).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def pad_ragged(lists: List[np.ndarray], pad_value=0, min_width=1):
    """Stack ragged int lists into (table[N, K], counts[N])."""
    n = len(lists)
    counts = np.array([len(x) for x in lists], dtype=np.int32)
    k = max(min_width, int(counts.max()) if n else min_width)
    table = np.full((n, k), pad_value, dtype=np.int64)
    for i, x in enumerate(lists):
        if len(x):
            table[i, : len(x)] = np.asarray(x, dtype=np.int64)
    return table.astype(np.int32), counts


@dataclasses.dataclass
class CandidateTables:
    """cand[U, 1+M]: col 0 = test positive item nid, cols 1.. = unseen items."""

    test_users: np.ndarray  # int32[U] user nids
    cand: np.ndarray  # int32[U, 1+M]
    neg_counts: np.ndarray  # int32[U] — number of valid unseen items per user

    @property
    def num_users(self):
        return self.test_users.shape[0]

    @property
    def test_items(self):
        return self.cand[:, 0]


@dataclasses.dataclass
class RejectionCandidates:
    """Large-scale alternative to CandidateTables: each user's SEEN items
    (test item in column 0, then the train history); unseen items are drawn
    exactly uniformly over the complement, with seen lists bounded (e.g.
    ML-25M's user-count band < 30*num_core, movielens.py:690-695) while the
    complement is the whole catalog."""

    test_users: np.ndarray  # int32[U]
    seen: np.ndarray  # int32[U, 1+K]; col 0 = test item nid
    seen_counts: np.ndarray  # int32[U] — valid entries incl. col 0

    @property
    def num_users(self):
        return self.test_users.shape[0]

    @property
    def test_items(self):
        return self.seen[:, 0]


@dataclasses.dataclass
class EntityFeatureTables:
    item_feat: np.ndarray  # int32[num_items, Kf] entity nids
    item_feat_counts: np.ndarray  # int32[num_items]
    user_feat: np.ndarray  # int32[num_users, Ku]
    user_feat_counts: np.ndarray  # int32[num_users]
    ent_lo: np.ndarray  # int32[num_nodes+1] type range start per nid
    ent_hi: np.ndarray  # int32[num_nodes+1] type range end per nid


@dataclasses.dataclass
class HINData:
    """Typed-node graph + leave-one-out split + sampling tables (all numpy)."""

    name: str
    types: List[str]
    num_nodes_dict: Dict[str, int]
    type_accs: Dict[str, int]
    num_nodes: int
    edge_index: Dict[str, np.ndarray]  # relation -> int64[2, E] (src_nid, dst_nid)
    edge_type_dict: Dict[str, int]
    train_pos: np.ndarray  # int64[Ei, 2] (u_nid, i_nid) training interactions
    ratings: np.ndarray  # float32[Ei] aligned with train_pos
    candidates: "CandidateTables | RejectionCandidates"
    entity_feats: EntityFeatureTables | None = None

    @property
    def num_users(self):
        return self.num_nodes_dict[self.types[0]]

    @property
    def num_items(self):
        return self.num_nodes_dict[self.types[1]]

    @property
    def item_acc(self):
        return self.type_accs[self.types[1]]

    @property
    def num_edge_types(self):
        return len(self.edge_type_dict)

    def type_ranges(self):
        """[ent_lo, ent_hi) arrays over the whole node id space."""
        lo = np.zeros(self.num_nodes + 1, dtype=np.int32)
        hi = np.zeros(self.num_nodes + 1, dtype=np.int32)
        for t in self.types:
            a = self.type_accs[t]
            n = self.num_nodes_dict[t]
            lo[a : a + n] = a
            hi[a : a + n] = a + n
        return lo, hi
