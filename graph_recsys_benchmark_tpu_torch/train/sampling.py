"""Device-side negative and entity sampling from static padded tables.

Port of the JAX package's ``train/sampling.py`` with explicit
``torch.Generator``s, which must live on the tables' device.  Two
candidate-table modes (data/hin.py):

  dense     — padded per-user UNSEEN table; sampling is a direct gather.
  rejection — padded per-user sorted SEEN lists (ML-25M scale); an unseen
              draw maps a uniform int in [0, num_items - seen_count)
              through the order statistics of the complement
              (``complement_map``), exact uniform over the unseen set.

Parity with the reference is distribution parity, not random-stream
parity (train/sampling.py:21-27):
  'random'  : uniform over the full item id range (incl. seen);
  'unseen'  : uniform over {test item} ∪ {never-interacted} per user
              (rejection mode: over the complement of the train history);
  eval      : uniform over the user's never-interacted items, with
              replacement (solvers.py:28-29);
  entities  : uniform over the node's feature list; the corrupted entity is
              uniform over the type range of the sampled feature
              (movielens.py:1158-1162); empty feature lists yield
              (0, 0, mask=0) as the reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.hin import CandidateTables, HINData
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """Static device-resident sampling tables derived from HINData; the
    other mode's tables are [1, 1] / [1] zeros."""

    train_pos: torch.Tensor  # int32[Ei, 2] (u_nid, i_nid)
    test_users: torch.Tensor  # int32[U]
    test_items: torch.Tensor  # int32[U]
    mode: str  # 'dense' | 'rejection'
    # dense mode
    cand: torch.Tensor  # int32[U, 1+M]; col 0 = test item
    neg_counts: torch.Tensor  # int32[U]
    # rejection mode (LOCAL item ids, ascending, padded with num_items)
    seen_all: torch.Tensor  # int32[U, Ka] — train + test
    seen_train: torch.Tensor  # int32[U, Kt] — train only
    cnt_all: torch.Tensor  # int32[U]
    cnt_train: torch.Tensor  # int32[U]
    item_lo: int
    num_items: int
    user_lo: int
    # entity-aware tables (zero-width when the HIN has none)
    item_feat: torch.Tensor  # int32[num_items, Kf] entity nids
    item_feat_counts: torch.Tensor  # int32[num_items]
    user_feat: torch.Tensor  # int32[num_users, Ku]
    user_feat_counts: torch.Tensor  # int32[num_users]
    ent_lo: torch.Tensor  # int32[num_nodes+1] type range start per nid
    ent_hi: torch.Tensor  # int32[num_nodes+1] type range end per nid


def build_device_tables(hin: HINData, device) -> DeviceTables:
    cands = hin.candidates
    ef = hin.entity_feats

    def i32(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.int32)

    z2, z1 = i32([[0]]), i32([0])
    if ef is None:
        feats = dict(item_feat=z2, item_feat_counts=z1, user_feat=z2,
                     user_feat_counts=z1, ent_lo=z1, ent_hi=z1)
    else:
        feats = {f: i32(getattr(ef, f)) for f in (
            "item_feat", "item_feat_counts", "user_feat", "user_feat_counts",
            "ent_lo", "ent_hi")}
    num_items, item_lo = int(hin.num_items), int(hin.item_acc)
    if isinstance(cands, CandidateTables):
        tabs = dict(mode="dense", cand=i32(cands.cand), neg_counts=i32(cands.neg_counts),
                    seen_all=z2, seen_train=z2, cnt_all=z1, cnt_train=z1)
    else:  # RejectionCandidates: sorted local seen lists (train/sampling.py:103-120)
        counts = np.asarray(cands.seen_counts)
        local = np.asarray(cands.seen) - item_lo
        valid = np.arange(local.shape[1])[None, :] < counts[:, None]
        all_sorted = np.sort(np.where(valid, local, num_items), axis=1)
        # train-only: drop column 0 (the test item) before sorting
        train_sorted = np.sort(np.where(valid[:, 1:], local[:, 1:], num_items), axis=1)
        tabs = dict(mode="rejection", cand=z2, neg_counts=z1,
                    seen_all=i32(all_sorted), seen_train=i32(train_sorted),
                    cnt_all=i32(counts), cnt_train=i32(counts - 1))
    return DeviceTables(
        train_pos=i32(hin.train_pos),
        test_users=i32(cands.test_users),
        test_items=i32(cands.test_items),
        **tabs,
        item_lo=item_lo,
        num_items=num_items,
        user_lo=int(hin.type_accs[hin.types[0]]),
        **feats,
    )


def _check_generator(generator: torch.Generator, tables: DeviceTables):
    """The draw never crosses devices quietly: a generator that does not
    live with the tables raises."""
    if resolve_device(generator.device) != tables.train_pos.device:
        raise ValueError(
            f"generator on {generator.device}, tables on {tables.train_pos.device}"
        )


def _uniform_below(generator, counts, shape):
    """Uniform int32 in [0, counts) elementwise (counts broadcastable)."""
    r = torch.rand(shape, generator=generator, device=counts.device)
    idx = torch.floor(r * counts.float()).to(torch.int32)
    return torch.minimum(idx, torch.clamp(counts - 1, min=0))


def complement_map(idx, seen_sorted, seen_counts):
    """The idx-th (0-based) local item id missing from each user's seen
    list: ``sample_complement``'s 269-step loop (train/sampling.py:166-171,
    "every seen id <= the result shifts it up by one") as one search.  For
    distinct ascending ids s_j the result is idx + #{j : s_j - j <= idx};
    s_j - j rises over the real columns, and the padding columns (holding
    num_items, so s_j - j falls there) are masked out of the search.

    idx: int32[U'] or [U', C]; seen_sorted: int32[U', K]; seen_counts:
    int32[U'].  Returns int32 of idx's shape."""
    col = torch.arange(seen_sorted.shape[1], device=seen_sorted.device, dtype=torch.int32)
    key = torch.where(col[None, :] < seen_counts[:, None], seen_sorted - col[None, :],
                      torch.iinfo(torch.int32).max)
    flat = idx.dim() == 1
    shift = torch.searchsorted(key, idx[:, None] if flat else idx, right=True)
    return idx + (shift[:, 0] if flat else shift).to(torch.int32)


def sample_complement(generator, u_local, seen_sorted, seen_counts, num_items, shape):
    """Exact uniform draw over each user's UNSEEN local item ids: idx ~
    U[0, num_items - count) mapped through complement_map.  u_local:
    int[U']; shape (U',) or (U', C)."""
    counts = seen_counts[u_local.long()]
    free = num_items - counts
    idx = _uniform_below(generator, free if len(shape) == 1 else free[:, None], shape)
    return complement_map(idx, seen_sorted[u_local.long()], counts)


def sample_cf_negatives(generator, u_nids, tables: DeviceTables, strategy: str):
    """Negative item nids int32[B] for a batch of users (movielens.py:920-940)."""
    _check_generator(generator, tables)
    b = u_nids.shape[0]
    if strategy == "random":
        return tables.item_lo + torch.randint(
            0, tables.num_items, (b,), generator=generator, device=u_nids.device,
            dtype=torch.int32,
        )
    if strategy == "unseen":
        u_local = (u_nids - tables.user_lo).long()
        if tables.mode == "dense":
            counts = tables.neg_counts[u_local] + 1  # +1: test item at col 0
            idx = _uniform_below(generator, counts, (b,))
            return tables.cand[u_local, idx.long()]
        # rejection mode: the complement of the TRAIN history (the
        # reference's list is test_pos + never-interacted, movielens.py:933)
        return tables.item_lo + sample_complement(
            generator, u_local, tables.seen_train, tables.cnt_train, tables.num_items, (b,))
    raise NotImplementedError(strategy)


def sample_eval_negatives(generator: torch.Generator, tables: DeviceTables,
                          num_candidates=99):
    """Per-test-user negatives [U, num_candidates]: uniform over each user's
    never-interacted items, with replacement, drawn by `generator`."""
    _check_generator(generator, tables)
    u = tables.test_users.shape[0]
    if tables.mode == "dense":
        idx = _uniform_below(generator, tables.neg_counts[:, None], (u, num_candidates))
        return torch.gather(tables.cand[:, 1:], 1, idx.long())
    u_local = torch.arange(u, device=tables.seen_all.device)
    return tables.item_lo + sample_complement(
        generator, u_local, tables.seen_all, tables.cnt_all, tables.num_items,
        (u, num_candidates))


def sample_entities(generator, u_nids, pos_i_nids, tables: DeviceTables):
    """Per-row entity-aware columns int32[B, 6]: [pos_item_ent, neg_item_ent,
    item_mask, pos_user_ent, neg_user_ent, user_mask]
    (movielens.py:1149-1179)."""
    _check_generator(generator, tables)
    b = u_nids.shape[0]

    def one_side(feat, counts, local_ids):
        local_ids = local_ids.long()
        cnt = counts[local_ids]
        idx = _uniform_below(generator, cnt, (b,))
        pos_ent = feat[local_ids, idx.long()]
        mask = (cnt > 0).to(torch.int32)
        lo = tables.ent_lo[pos_ent.long()]
        hi = tables.ent_hi[pos_ent.long()]
        neg_ent = lo + _uniform_below(generator, hi - lo, (b,))
        # the reference yields exactly (0, 0, 0) for empty feature lists
        return pos_ent * mask, neg_ent * mask, mask

    pi, ni, mi = one_side(tables.item_feat, tables.item_feat_counts,
                          pos_i_nids - tables.item_lo)
    pu, nu, mu = one_side(tables.user_feat, tables.user_feat_counts,
                          u_nids - tables.user_lo)
    return torch.stack([pi, ni, mi, pu, nu, mu], dim=1)
