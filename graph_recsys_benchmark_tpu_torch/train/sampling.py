"""Device-side negative and entity sampling from static padded tables.

Port of the dense-mode half of the JAX package's ``train/sampling.py`` with
explicit ``torch.Generator``s, which must live on the tables' device.
Parity with the reference is distribution parity, not random-stream
parity (train/sampling.py:21-27):
  'random'  : uniform over the full item id range (incl. seen);
  'unseen'  : uniform over {test item} ∪ {never-interacted} per user;
  eval      : uniform over the user's never-interacted items, with
              replacement (solvers.py:28-29);
  entities  : uniform over the node's feature list; the corrupted entity is
              uniform over the type range of the sampled feature
              (movielens.py:1158-1162); empty feature lists yield
              (0, 0, mask=0) as the reference does.
The rejection mode (ML-25M scale) is not ported yet (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.hin import HINData
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """Static device-resident sampling tables derived from HINData (dense
    candidate mode)."""

    train_pos: torch.Tensor  # int32[Ei, 2] (u_nid, i_nid)
    test_users: torch.Tensor  # int32[U]
    test_items: torch.Tensor  # int32[U]
    cand: torch.Tensor  # int32[U, 1+M]; col 0 = test item
    neg_counts: torch.Tensor  # int32[U]
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

    if ef is None:
        z2, z1 = i32([[0]]), i32([0])
        feats = dict(item_feat=z2, item_feat_counts=z1, user_feat=z2,
                     user_feat_counts=z1, ent_lo=z1, ent_hi=z1)
    else:
        feats = {f: i32(getattr(ef, f)) for f in (
            "item_feat", "item_feat_counts", "user_feat", "user_feat_counts",
            "ent_lo", "ent_hi")}
    return DeviceTables(
        train_pos=i32(hin.train_pos),
        test_users=i32(cands.test_users),
        test_items=i32(cands.cand[:, 0]),
        cand=i32(cands.cand),
        neg_counts=i32(cands.neg_counts),
        item_lo=int(hin.item_acc),
        num_items=int(hin.num_items),
        user_lo=int(hin.type_accs[hin.types[0]]),
        **feats,
    )


def _check_generator(generator: torch.Generator, tables: DeviceTables):
    """The draw never crosses devices quietly: a generator that does not
    live with the tables raises."""
    if resolve_device(generator.device) != tables.cand.device:
        raise ValueError(
            f"generator on {generator.device}, tables on {tables.cand.device}"
        )


def _uniform_below(generator, counts, shape):
    """Uniform int32 in [0, counts) elementwise (counts broadcastable)."""
    r = torch.rand(shape, generator=generator, device=counts.device)
    idx = torch.floor(r * counts.float()).to(torch.int32)
    return torch.minimum(idx, torch.clamp(counts - 1, min=0))


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
        counts = tables.neg_counts[u_local] + 1  # +1: test item at col 0
        idx = _uniform_below(generator, counts, (b,))
        return tables.cand[u_local, idx.long()]
    raise NotImplementedError(strategy)


def sample_eval_negatives(generator: torch.Generator, tables: DeviceTables,
                          num_candidates=99):
    """Per-test-user negatives [U, num_candidates]: uniform over each user's
    never-interacted items, with replacement, drawn by `generator`."""
    _check_generator(generator, tables)
    u = tables.test_users.shape[0]
    idx = _uniform_below(generator, tables.neg_counts[:, None], (u, num_candidates))
    return torch.gather(tables.cand[:, 1:], 1, idx.long())


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
