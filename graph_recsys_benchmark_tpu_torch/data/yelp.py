"""Yelp HIN builder: raw dataframes -> 11-node-type graph + split + tables.

A copy of the JAX package's ``data/yelp.py`` (numpy + pandas), so that
both packages build bitwise-identical graphs from the same raw frames.  It
keeps every filtering and discretization rule of the reference pipeline
(datasets/yelp.py:488-674 preprocessing, :75-165 entity discretization,
:168-437 graph build):

  * review ∪ tip union as the interaction table (yelp.py:612-616)
  * open businesses only; business-count > num_core+40; user-count in
    (num_core, num_core+10]  (yelp.py:627-646 — the narrow band keeps the
    graph tractable and is why Yelp HR is so high in the paper)
  * category names occurring < 10% of the max category count dropped
    (yelp.py:57-74); business attributes flattened to boolean names
    (yelp.py:521-549)
  * user review_count/friends_count/fans/average_stars and business
    review_count/checkin_count discretized into fixed-width buckets of
    100/500/100/0.5/500/1000 (yelp.py:75-165)
  * node types in order: uid, iid, user_reviewcount, user_friendcount,
    user_fan, user_star, item_star, item_reviewcount, item_attribute,
    item_categorie, item_checkincount (yelp.py:256-258)
  * leave-one-out: interactions sorted by (bus_count, user_count), the last
    row per user is the test positive (yelp.py:395-421 — Yelp has no
    timestamps in the union table)

Deviations, as in the JAX package: set-ordered entity names use sorted
order (node-id assignment only); hours/checkin-time boolean columns feed
no edges in the reference and are not materialized.  ``YELP_MP2V_STEPS``
and ``YELP_HEREC_METAPATHS`` are the walk models' metapaths.
"""

from __future__ import annotations

import itertools
from collections import Counter

import numpy as np
import pandas as pd

from .hin import EntityFeatureTables, HINData, pad_ragged

YELP_TYPES = [
    "uid", "iid", "user_reviewcount", "user_friendcount", "user_fan",
    "user_star", "item_star", "item_reviewcount", "item_attribute",
    "item_categorie", "item_checkincount",
]


def drop_infrequent_categories(series):
    """Reference yelp.py:57-74: keep categories with count >= 10% of max;
    note the raw split is ', ' but the kept join is ','."""
    strs = [s if s is not None else "" for s in series]
    counter = Counter(itertools.chain.from_iterable(s.split(", ") for s in strs))
    counter.pop("", None)
    counter.pop("N/A", None)
    if not counter:
        return pd.Series(["" for _ in strs], index=series.index)
    cutoff = 0.1 * max(counter.values())
    keep = {k for k, v in counter.items() if v >= cutoff}
    return pd.Series(
        [",".join(c for c in s.split(", ") if c in keep) for s in strs],
        index=series.index,
    )


def _bucket(values, width):
    """Reference fixed-width bucketing (yelp.py:77-165): floor to
    min + k*width; everything beyond the last edge collapses into it."""
    v = np.asarray(values, dtype=np.float64)
    lo, hi = v.min(), v.max()
    n = int((hi - lo) // width)
    edges = [lo + i * width for i in range(n + 1)]
    out = v.copy()
    for i, e in enumerate(edges):
        if i != len(edges) - 1:
            out[(e <= v) & (v < edges[i + 1])] = e
        else:
            out[e <= v] = e
    return out


def discretize_entities(user, business):
    """yelp.py:75-165 bucket widths."""
    user = user.copy()
    business = business.copy()
    user["review_count"] = _bucket(user.review_count.astype(int), 100).astype(np.int64)
    user["friends_count"] = _bucket(user.friends_count.astype(int), 500).astype(np.int64)
    user["fans"] = _bucket(user.fans.astype(int), 100).astype(np.int64)
    user["average_stars"] = _bucket(user.average_stars.astype(float), 0.5)
    business["review_count"] = _bucket(business.review_count.astype(int), 500).astype(np.int64)
    business["checkin_count"] = _bucket(business.checkin_count.astype(int), 1000).astype(np.int64)
    return user, business


def filter_yelp(business, user, reviewtip, num_core=10):
    """Core band filtering (yelp.py:627-663): bus_count > num_core+40,
    num_core < user_count <= num_core+10, then sync + recount + reindex."""
    business = business.drop_duplicates(subset=["business_id"])
    user = user.drop_duplicates(subset=["user_id"])
    reviewtip = reviewtip.drop_duplicates()

    if "is_open" in business.columns:
        business = business[business.is_open == 1]

    bus_count = reviewtip["business_id"].value_counts()
    reviewtip = reviewtip[reviewtip.business_id.map(bus_count) > (num_core + 40)]
    user_count = reviewtip["user_id"].value_counts()
    uc = reviewtip.user_id.map(user_count)
    reviewtip = reviewtip[(uc > num_core) & (uc <= (num_core + 10))]

    user = user[user.user_id.isin(reviewtip["user_id"].unique())]
    business = business[business.business_id.isin(reviewtip["business_id"].unique())]
    reviewtip = reviewtip[reviewtip.user_id.isin(user["user_id"].unique())]
    reviewtip = reviewtip[reviewtip.business_id.isin(business["business_id"].unique())]

    bus_count = reviewtip["business_id"].value_counts()
    user_count = reviewtip["user_id"].value_counts()
    reviewtip = reviewtip.assign(
        bus_count=reviewtip.business_id.map(bus_count),
        user_count=reviewtip.user_id.map(user_count),
    )

    # reindex to dense ids (yelp.py:19-56: order of first appearance)
    uid_map = {u: i for i, u in enumerate(user.user_id.unique())}
    iid_map = {b: i for i, b in enumerate(business.business_id.unique())}
    user = user.assign(user_id=user.user_id.map(uid_map))
    business = business.assign(business_id=business.business_id.map(iid_map))
    reviewtip = reviewtip.assign(
        user_id=reviewtip.user_id.map(uid_map),
        business_id=reviewtip.business_id.map(iid_map),
    )
    return business, user, reviewtip


def _split_vals(series):
    return [[c for c in str(s).split(",") if c != ""] for s in series]


def build_yelp_hin(business, user, reviewtip, num_core=10, name="yelp",
                   candidate_mode="dense") -> HINData:
    """Filter + discretize + build the 11-type HIN.  Inputs are the
    post-parse dataframes: business(business_id, stars, review_count,
    attributes, categories, checkin_count, is_open), user(user_id,
    review_count, friends_count, fans, average_stars),
    reviewtip(user_id, business_id)."""
    business = business.copy()
    business["categories"] = drop_infrequent_categories(business.categories)
    business, user, reviewtip = filter_yelp(business, user, reviewtip, num_core)
    user, business = discretize_entities(user, business)

    groups = {
        "uid": list(np.sort(reviewtip.user_id.unique())),
        "iid": list(np.sort(reviewtip.business_id.unique())),
        "user_reviewcount": list(pd.unique(user.review_count)),
        "user_friendcount": list(pd.unique(user.friends_count)),
        "user_fan": list(pd.unique(user.fans)),
        "user_star": list(pd.unique(user.average_stars)),
        "item_star": list(pd.unique(business.stars)),
        "item_reviewcount": list(pd.unique(business.review_count)),
        "item_attribute": sorted(
            set(itertools.chain.from_iterable(_split_vals(business.attributes)))
        ),
        "item_categorie": sorted(
            set(itertools.chain.from_iterable(_split_vals(business.categories)))
        ),
        "item_checkincount": list(pd.unique(business.checkin_count)),
    }
    num_nodes_dict = {t: len(groups[t]) for t in YELP_TYPES}
    type_accs, e2nid = {}, {}
    acc = 0
    for t in YELP_TYPES:
        type_accs[t] = acc
        e2nid[t] = {e: i + acc for i, e in enumerate(groups[t])}
        acc += num_nodes_dict[t]
    num_nodes = acc

    edge_index = {}
    u_nids = user.user_id.map(e2nid["uid"]).to_numpy()
    for rel, col, t in [
        ("reviewcount2user", "review_count", "user_reviewcount"),
        ("friendcount2user", "friends_count", "user_friendcount"),
        ("fans2user", "fans", "user_fan"),
        ("stars2user", "average_stars", "user_star"),
    ]:
        src = user[col].map(e2nid[t]).to_numpy()
        edge_index[rel] = np.vstack([src, u_nids])

    i_nids = business.business_id.map(e2nid["iid"]).to_numpy()
    edge_index["stars2item"] = np.vstack(
        [business.stars.map(e2nid["item_star"]).to_numpy(), i_nids]
    )
    edge_index["reviewcount2item"] = np.vstack(
        [business.review_count.map(e2nid["item_reviewcount"]).to_numpy(), i_nids]
    )

    def multi_edges(series, t):
        srcs, dsts = [], []
        for inid, names in zip(i_nids, _split_vals(series)):
            for nm in names:
                srcs.append(e2nid[t][nm])
                dsts.append(inid)
        if not srcs:
            return np.zeros((2, 0), dtype=np.int64)
        return np.vstack([np.asarray(srcs), np.asarray(dsts)]).astype(np.int64)

    edge_index["attributes2item"] = multi_edges(business.attributes, "item_attribute")
    edge_index["categories2item"] = multi_edges(business.categories, "item_categorie")
    edge_index["checkincount2item"] = np.vstack(
        [business.checkin_count.map(e2nid["item_checkincount"]).to_numpy(), i_nids]
    )

    # leave-one-out over (bus_count, user_count)-sorted interactions
    rt = reviewtip.sort_values(["bus_count", "user_count"], kind="stable")
    rt = rt.sort_values("user_id", kind="stable")
    last_mask = rt.groupby("user_id").cumcount(ascending=False) == 0
    train_r, test_r = rt[~last_mask], rt[last_mask]

    train_u = train_r.user_id.to_numpy() + type_accs["uid"]
    train_i = train_r.business_id.to_numpy() + type_accs["iid"]
    edge_index["user2item"] = np.vstack([train_u, train_i])
    train_pos = np.stack([train_u, train_i], axis=1)

    num_users = num_nodes_dict["uid"]
    num_items = num_nodes_dict["iid"]
    # shared candidate builder (movielens.build_candidates): 'dense' padded
    # unseen tables for the filtered-Yelp scale, 'rejection' seen tables for
    # larger cuts — the same O(U*K) escape hatch the ML builders have
    # (round-1 review: the dense-only Yelp path was a latent scale bug)
    from .movielens import build_candidates

    candidates = build_candidates(
        reviewtip.rename(columns={"user_id": "uid", "business_id": "iid"}),
        test_r.user_id.to_numpy(),
        test_r.business_id.to_numpy() + type_accs["iid"],
        num_users, num_items, type_accs, candidate_mode,
    )

    # entity-aware feature tables (yelp.py:768-823)
    bus_by_iid = business.set_index("business_id")
    item_feats = []
    for iid in range(num_items):
        row = bus_by_iid.loc[iid]
        feats = [
            e2nid["item_star"][row["stars"]],
            e2nid["item_reviewcount"][row["review_count"]],
        ]
        feats += [e2nid["item_attribute"][a] for a in str(row["attributes"]).split(",") if a != ""]
        feats += [e2nid["item_categorie"][c] for c in str(row["categories"]).split(",") if c != ""]
        feats.append(e2nid["item_checkincount"][row["checkin_count"]])
        item_feats.append(np.asarray(feats, dtype=np.int64))
    usr_by_uid = user.set_index("user_id")
    user_feats = []
    for uid in range(num_users):
        row = usr_by_uid.loc[uid]
        user_feats.append(
            np.asarray(
                [
                    e2nid["user_reviewcount"][row["review_count"]],
                    e2nid["user_friendcount"][row["friends_count"]],
                    e2nid["user_fan"][row["fans"]],
                    e2nid["user_star"][row["average_stars"]],
                ],
                dtype=np.int64,
            )
        )
    item_feat, item_feat_counts = pad_ragged(item_feats)
    user_feat, user_feat_counts = pad_ragged(user_feats)

    hin = HINData(
        name=name,
        types=YELP_TYPES,
        num_nodes_dict=num_nodes_dict,
        type_accs=type_accs,
        num_nodes=num_nodes,
        edge_index=edge_index,
        edge_type_dict={k: i for i, k in enumerate(edge_index.keys())},
        train_pos=train_pos,
        ratings=np.ones(train_pos.shape[0], dtype=np.float32),
        candidates=candidates,
    )
    lo, hi = hin.type_ranges()
    hin.entity_feats = EntityFeatureTables(
        item_feat=item_feat, item_feat_counts=item_feat_counts,
        user_feat=user_feat, user_feat_counts=user_feat_counts,
        ent_lo=lo, ent_hi=hi,
    )
    return hin


def yelp_metapath_edges(hin: HINData):
    """The 11 hard-coded Yelp metapaths (utils/general_utils.py:377-392)."""
    e = hin.edge_index

    def fwd(name):
        return (e[name][0], e[name][1])

    def rev(name):
        return (e[name][1], e[name][0])

    u2i, i2u = fwd("user2item"), rev("user2item")
    return [
        [u2i, i2u],
        [i2u, u2i],
        [fwd("stars2item"), i2u],
        [fwd("reviewcount2item"), i2u],
        [fwd("attributes2item"), i2u],
        [fwd("categories2item"), i2u],
        [fwd("checkincount2item"), i2u],
        [fwd("reviewcount2user"), u2i],
        [fwd("friendcount2user"), u2i],
        [fwd("fans2user"), u2i],
        [fwd("stars2user"), u2i],
    ]


YELP_MP2V_STEPS = [
    ("reviewcount2item", False),
    ("user2item", True),
    ("friendcount2user", True),
    ("friendcount2user", False),
    ("user2item", False),
    ("reviewcount2item", True),
]  # item_reviewcount->iid->uid->user_friendcount->uid->iid->item_reviewcount
#   (metapath2vec_solver_bpr.py:162-180)

YELP_HEREC_METAPATHS = [
    YELP_MP2V_STEPS,
    [("user2item", False), ("user2item", True)],
]  # herec_solver_bpr.py:178-252; its first metapath starts at item_reviewcount
#   rows while HeRec starts every walk at a user (models/metapath2vec.py's clamp)
