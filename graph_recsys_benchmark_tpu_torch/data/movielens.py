"""MovieLens HIN builder: raw dataframes -> typed-node graph + split + tables.

A copy of the ml-latest-small half of the JAX package's
``data/movielens.py`` (numpy + pandas), so that both packages build
bitwise-identical graphs from the same raw frames.  It keeps every
filtering and discretization rule of the reference pipeline
(datasets/movielens.py:759-856 and :125-345):

  * dedupe -> sync -> movie-count > num_core -> user-count > num_core ->
    sync -> tag-count > num_feat_core
  * year clamp to >=1950 then decade buckets
  * reindex uids/iids/tags to dense ids
  * drop director/actor/writer names occurring < num_feat_core times
  * node-id space: [uid, iid, genre, year, director, actor, writer, tid]
    with cumulative type offsets
  * leave-one-out: per user, the latest-timestamp interaction is the test
    positive; the rest become user2item train edges

It also holds ``ml25m_metapath_edges``, the 13 ML-25M metapaths over the
relations of ``data/synthetic.synthetic_ml25m_hin``.  The ML-25M raw-frame
pipeline (``build_ml25m_hin``) is not ported: the scale path builds its HIN
straight from numpy.
"""

from __future__ import annotations

import itertools
from collections import Counter

import numpy as np
import pandas as pd

from .hin import (
    CandidateTables,
    EntityFeatureTables,
    HINData,
    RejectionCandidates,
    pad_ragged,
)


def build_candidates(ratings, test_u, test_i, num_users, num_items, type_accs, mode):
    """Per-user candidate structures for negative sampling + eval.

    mode='dense': padded unseen-item table (col 0 = test item) — O(U*I)
      memory, exact-gather sampling; right for ml-small/yelp scale.
    mode='rejection': padded SEEN table (col 0 = test item) — O(U*K)
      memory; sampling rejects seen items; right for ml-25m scale.
    """
    order = np.argsort(test_u, kind="stable")
    test_u, test_i = test_u[order], test_i[order]
    if test_u.shape[0] != num_users:
        raise ValueError("every user must have a test item")
    test_users = (np.arange(num_users) + type_accs["uid"]).astype(np.int32)

    seen = ratings.groupby("uid").iid.apply(set)
    if mode == "dense":
        all_items = set(range(num_items))
        neg_lists = [
            np.fromiter(
                (i + type_accs["iid"] for i in sorted(all_items - seen[u])),
                dtype=np.int64,
            )
            for u in range(num_users)
        ]
        neg_table, neg_counts = pad_ragged(neg_lists)
        cand = np.concatenate([test_i[:, None].astype(np.int32), neg_table], axis=1)
        return CandidateTables(test_users=test_users, cand=cand, neg_counts=neg_counts)

    if mode != "rejection":
        raise ValueError(f"candidate mode {mode!r}: expected 'dense' or 'rejection'")
    seen_lists = []
    for u in range(num_users):
        ti = int(test_i[u])
        rest = [i + type_accs["iid"] for i in sorted(seen[u])]
        rest.remove(ti)
        seen_lists.append(np.asarray([ti] + rest, dtype=np.int64))
    seen_table, seen_counts = pad_ragged(seen_lists)
    return RejectionCandidates(
        test_users=test_users, seen=seen_table, seen_counts=seen_counts
    )


def drop_infrequent_concepts(series, min_occs):
    """Reference `drop_infrequent_concept_from_str` (movielens.py:109-122):
    drop names with < min_occs occurrences, plus '' and 'N/A'."""
    counter = Counter(
        itertools.chain.from_iterable(s.split(",") for s in series)
    )
    counter.pop("", None)
    counter.pop("N/A", None)
    keep = {k for k, v in counter.items() if v >= min_occs}
    return series.map(
        lambda s: ",".join(c for c in s.split(",") if c in keep)
    )


def discretize_years(years):
    """Reference year handling (movielens.py:816-832): clamp to >=1950, then
    bucket into decades anchored at the minimum year."""
    years = np.asarray(years).astype(np.int64).copy()
    years[years < 1950] = 1950
    min_year, max_year = years.min(), years.max()
    num_decades = (max_year - min_year) // 10
    edges = [min_year + i * 10 for i in range(num_decades + 1)]
    out = years.copy()
    for i in range(len(edges) - 1):
        out[(edges[i] <= years) & (years < edges[i + 1])] = edges[i]
    out[years < edges[0]] = edges[0]
    out[years >= edges[-1]] = edges[-1]
    return out


def filter_mlsmall(movies, ratings, tagging, num_core, num_feat_core):
    """Core filtering chain (movielens.py:785-841), vectorized."""
    movies = movies.drop_duplicates()
    ratings = ratings.drop_duplicates()
    tagging = tagging.drop_duplicates()

    movies = movies[movies.iid.isin(ratings.iid.unique())]
    ratings = ratings[ratings.iid.isin(movies.iid.unique())]
    tagging = tagging[tagging.iid.isin(ratings.iid.unique())]
    tagging = tagging[tagging.uid.isin(ratings.uid.unique())]

    movie_count = ratings["iid"].value_counts()
    ratings = ratings[ratings.iid.map(movie_count) > num_core]
    user_count = ratings["uid"].value_counts()
    ratings = ratings[ratings.uid.map(user_count) > num_core]

    movies = movies[movies.iid.isin(ratings.iid.unique())]
    tagging = tagging[tagging.iid.isin(ratings.iid.unique())]
    tagging = tagging[tagging.uid.isin(ratings.uid.unique())]

    tag_count = tagging["tag"].value_counts()
    tagging = tagging[tagging.tag.map(tag_count) > num_feat_core]

    movies = movies.copy()
    movies["year"] = discretize_years(movies.year.to_numpy())

    # reindex to dense ids (movielens.py:21-57)
    uids = np.sort(ratings.uid.unique())
    uid_map = {u: i for i, u in enumerate(uids)}
    iids = np.sort(movies.iid.unique())
    iid_map = {m: i for i, m in enumerate(iids)}
    ratings = ratings.assign(
        uid=ratings.uid.map(uid_map), iid=ratings.iid.map(iid_map)
    )
    movies = movies.assign(iid=movies.iid.map(iid_map))
    tagging = tagging.assign(
        uid=tagging.uid.map(uid_map), iid=tagging.iid.map(iid_map)
    )
    tags = np.sort(tagging.tag.unique()) if len(tagging) else np.array([], dtype=str)
    tag_map = {t: i for i, t in enumerate(tags)}
    tagging = tagging.assign(tid=tagging.tag.map(tag_map)).drop(columns=["tag"])

    for col in ("writers", "directors", "actors"):
        movies[col] = drop_infrequent_concepts(movies[col].astype(str), num_feat_core)

    return movies, ratings, tagging


def _concept_lists(series):
    return [[c for c in s.split(",") if c != ""] for s in series]


def build_mlsmall_hin(
    movies, ratings, tagging, num_core=10, num_feat_core=10, name="ml-synthetic",
    genre_columns=None, candidate_mode="dense",
) -> HINData:
    """Filter + build the heterogeneous graph, split, and sampling tables."""
    movies, ratings, tagging = filter_mlsmall(
        movies, ratings, tagging, num_core, num_feat_core
    )

    if genre_columns is None:
        meta = {"iid", "title", "year", "directors", "actors", "writers"}
        genre_columns = [c for c in movies.columns if c not in meta]

    # ---------------- entity spaces (movielens.py:135-181)
    unique_uids = np.sort(ratings.uid.unique())
    unique_iids = np.sort(ratings.iid.unique())
    unique_genres = list(genre_columns)
    unique_years = list(pd.unique(movies.year))  # order of appearance, as ref
    directors = sorted(set(itertools.chain.from_iterable(_concept_lists(movies.directors))))
    actors = sorted(set(itertools.chain.from_iterable(_concept_lists(movies.actors))))
    writers = sorted(set(itertools.chain.from_iterable(_concept_lists(movies.writers))))
    unique_tids = np.sort(tagging.tid.unique()) if len(tagging) else np.array([], dtype=np.int64)

    types = ["uid", "iid", "genre", "year", "director", "actor", "writer", "tid"]
    groups = {
        "uid": list(unique_uids),
        "iid": list(unique_iids),
        "genre": unique_genres,
        "year": unique_years,
        "director": directors,
        "actor": actors,
        "writer": writers,
        "tid": list(unique_tids),
    }
    num_nodes_dict = {t: len(groups[t]) for t in types}
    type_accs = {}
    e2nid = {}
    acc = 0
    for t in types:
        type_accs[t] = acc
        e2nid[t] = {e: i + acc for i, e in enumerate(groups[t])}
        acc += num_nodes_dict[t]
    num_nodes = acc

    # ---------------- attribute edges (movielens.py:231-288)
    edge_index = {}

    m_inids = movies.iid.map(e2nid["iid"]).to_numpy()
    year_nids = movies.year.map(e2nid["year"]).to_numpy()
    edge_index["year2item"] = np.vstack([year_nids, m_inids])

    g_src, g_dst = [], []
    for g in unique_genres:
        sel = movies[movies[g].astype(bool)].iid.map(e2nid["iid"]).to_numpy()
        g_src.append(np.full(sel.shape[0], e2nid["genre"][g], dtype=np.int64))
        g_dst.append(sel)
    edge_index["genre2item"] = np.vstack(
        [np.concatenate(g_src) if g_src else np.zeros((0,), np.int64),
         np.concatenate(g_dst) if g_dst else np.zeros((0,), np.int64)]
    )

    def concept_edges(series, type_name):
        srcs, dsts = [], []
        for inid, names in zip(m_inids, _concept_lists(series)):
            for nm in names:
                srcs.append(e2nid[type_name][nm])
                dsts.append(inid)
        return np.vstack(
            [np.asarray(srcs, dtype=np.int64), np.asarray(dsts, dtype=np.int64)]
        ) if srcs else np.zeros((2, 0), dtype=np.int64)

    edge_index["director2item"] = concept_edges(movies.directors, "director")
    edge_index["actor2item"] = concept_edges(movies.actors, "actor")
    edge_index["writer2item"] = concept_edges(movies.writers, "writer")

    if len(tagging):
        t_nids = tagging.tid.map(e2nid["tid"]).to_numpy()
        t_unids = tagging.uid.map(e2nid["uid"]).to_numpy()
        t_inids = tagging.iid.map(e2nid["iid"]).to_numpy()
        edge_index["tag2user"] = np.vstack([t_nids, t_unids])
        edge_index["tag2item"] = np.vstack([t_nids, t_inids])
    else:
        edge_index["tag2user"] = np.zeros((2, 0), dtype=np.int64)
        edge_index["tag2item"] = np.zeros((2, 0), dtype=np.int64)

    # ---------------- leave-one-out split (movielens.py:290-326)
    r = ratings.sort_values(["uid", "timestamp"], kind="stable")
    last_mask = r.groupby("uid").cumcount(ascending=False) == 0
    train_r = r[~last_mask]
    test_r = r[last_mask]

    train_u = train_r.uid.to_numpy() + type_accs["uid"]
    train_i = train_r.iid.to_numpy() + type_accs["iid"]
    edge_index["user2item"] = np.vstack([train_u, train_i])
    train_pos = np.stack([train_u, train_i], axis=1)
    rating_vals = train_r.rating.to_numpy().astype(np.float32)

    # candidate tables: col 0 = test item
    test_u = test_r.uid.to_numpy()
    test_i = test_r.iid.to_numpy() + type_accs["iid"]
    num_users = num_nodes_dict["uid"]
    num_items = num_nodes_dict["iid"]
    candidates = build_candidates(
        ratings, test_u, test_i, num_users, num_items, type_accs, candidate_mode
    )

    # ---------------- entity-aware feature tables (movielens.py:942-991)
    mov_by_iid = movies.set_index("iid")
    tag_by_item = tagging.groupby("iid").tid.apply(list) if len(tagging) else {}
    tag_by_user = tagging.groupby("uid").tid.apply(list) if len(tagging) else {}

    item_feats = []
    for iid in range(num_items):
        feats = []
        if iid in mov_by_iid.index:
            row = mov_by_iid.loc[iid]
            feats.append(e2nid["year"][row["year"]])
            feats += [e2nid["genre"][g] for g in unique_genres if bool(row[g])]
            for col, t in (("actors", "actor"), ("directors", "director"), ("writers", "writer")):
                feats += [e2nid[t][nm] for nm in str(row[col]).split(",") if nm != ""]
        if len(tagging) and iid in tag_by_item.index:
            feats += [e2nid["tid"][t] for t in tag_by_item[iid]]
        item_feats.append(np.asarray(feats, dtype=np.int64))
    user_feats = []
    for uid in range(num_users):
        feats = []
        if len(tagging) and uid in tag_by_user.index:
            feats += [e2nid["tid"][t] for t in tag_by_user[uid]]
        user_feats.append(np.asarray(feats, dtype=np.int64))

    item_feat, item_feat_counts = pad_ragged(item_feats)
    user_feat, user_feat_counts = pad_ragged(user_feats)

    hin = HINData(
        name=name,
        types=types,
        num_nodes_dict=num_nodes_dict,
        type_accs=type_accs,
        num_nodes=num_nodes,
        edge_index=edge_index,
        edge_type_dict={k: i for i, k in enumerate(edge_index.keys())},
        train_pos=train_pos,
        ratings=rating_vals,
        candidates=candidates,
    )
    lo, hi = hin.type_ranges()
    hin.entity_feats = EntityFeatureTables(
        item_feat=item_feat,
        item_feat_counts=item_feat_counts,
        user_feat=user_feat,
        user_feat_counts=user_feat_counts,
        ent_lo=lo,
        ent_hi=hi,
    )
    return hin


def ml25m_metapath_edges(hin: HINData):
    """The 13 hard-coded ml-25m metapaths (utils/general_utils.py:335-356)."""
    e = hin.edge_index

    def fwd(name):
        return (e[name][0], e[name][1])

    def rev(name):
        return (e[name][1], e[name][0])

    u2i, i2u = fwd("user2item"), rev("user2item")
    t2u, u2t = fwd("tag2user"), rev("tag2user")
    t2i, i2t = fwd("tag2item"), rev("tag2item")
    return [
        [u2i, i2u],
        [fwd("year2item"), i2u],
        [fwd("actor2item"), i2u],
        [fwd("writer2item"), i2u],
        [fwd("director2item"), i2u],
        [fwd("genre2item"), i2u],
        [fwd("genome_tag2item"), i2u],
        [u2t, t2u],
        [i2t, t2u],
        [i2u, u2i],
        [t2u, u2i],
        [i2t, t2i],
        [u2t, t2i],
    ]


def mlsmall_metapath_edges(hin: HINData):
    """The 9 hard-coded ml-latest-small metapaths
    (utils/general_utils.py:300-313); each entry is a list of (src, dst)
    step edge arrays.  `rev` = reversed relation."""
    e = hin.edge_index

    def fwd(name):
        return (e[name][0], e[name][1])

    def rev(name):
        return (e[name][1], e[name][0])

    u2i, y2i = fwd("user2item"), fwd("year2item")
    a2i, d2i, w2i = fwd("actor2item"), fwd("director2item"), fwd("writer2item")
    g2i, t2i, t2u = fwd("genre2item"), fwd("tag2item"), fwd("tag2user")
    i2u = rev("user2item")
    return [
        [u2i, i2u],
        [i2u, u2i],
        [y2i, i2u],
        [a2i, i2u],
        [w2i, i2u],
        [d2i, i2u],
        [g2i, i2u],
        [t2i, i2u],
        [t2u, u2i],
    ]
