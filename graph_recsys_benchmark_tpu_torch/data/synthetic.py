"""Deterministic synthetic MovieLens-style data.

Copies of the JAX package's generators, drawn from one numpy seed in the
same order, so both packages build the same data from the same arguments:

  * ``synthetic_mlsmall_raw``: dataframes with the schema the raw
    ml-latest-small parser produces (movies: iid/title/year/<genre
    bools>/directors/actors/writers; ratings: uid/iid/rating/timestamp;
    tagging: uid/iid/tag/timestamp);
  * ``synthetic_ml25m_raw``: the ml-small trio past the 2018 cutoff plus
    genome scores and tags, for ``data/movielens.build_ml25m_hin``;
  * ``synthetic_yelp_raw``: (business, user, reviewtip) frames in the
    schema of ``data/yelp_raw.preprocess_yelp_raw``, for
    ``data/yelp.build_yelp_hin``;
  * ``synthetic_ml25m_hin``: the HIN at the ML-25M post-filter scale built
    straight from numpy (9 node types, 10 relations, rejection candidates,
    entity-feature tables), structure only.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .hin import EntityFeatureTables, HINData, RejectionCandidates

GENRES = [
    "Action", "Adventure", "Animation", "Comedy", "Crime", "Documentary",
    "Drama", "Fantasy", "Horror", "Mystery", "Romance", "Sci-Fi", "Thriller",
    "War",
]


def synthetic_mlsmall_raw(
    seed=0,
    num_users=150,
    num_items=120,
    min_ratings_per_user=8,
    max_ratings_per_user=30,
    num_directors=25,
    num_actors=60,
    num_writers=30,
    num_tags=40,
    tagging_rows=400,
):
    """Returns (movies, ratings, tagging) dataframes in raw-parser schema."""
    rng = np.random.default_rng(seed)

    # movies: popularity-skewed genre/crew assignment
    rows = []
    for iid in range(1, num_items + 1):
        year = int(rng.integers(1930, 2020))
        row = {"iid": iid, "title": f"Movie {iid}", "year": year}
        for gname in GENRES:
            row[gname] = bool(rng.random() < 0.18)
        row["directors"] = ",".join(
            f"Director{int(x)}" for x in rng.choice(num_directors, size=rng.integers(1, 3), replace=False)
        )
        row["actors"] = ",".join(
            f"Actor{int(x)}" for x in rng.choice(num_actors, size=rng.integers(1, 5), replace=False)
        )
        row["writers"] = ",".join(
            f"Writer{int(x)}" for x in rng.choice(num_writers, size=rng.integers(1, 3), replace=False)
        )
        rows.append(row)
    movies = pd.DataFrame(rows).fillna(False)

    # ratings: zipf-ish item popularity, per-user leave-one-out-able histories
    item_pop = rng.dirichlet(np.ones(num_items) * 0.3)
    r_rows = []
    ts = 1_000_000
    for uid in range(1, num_users + 1):
        k = int(rng.integers(min_ratings_per_user, max_ratings_per_user + 1))
        iids = rng.choice(np.arange(1, num_items + 1), size=min(k, num_items), replace=False, p=item_pop)
        for iid in iids:
            ts += int(rng.integers(1, 50))
            r_rows.append(
                {
                    "uid": uid,
                    "iid": int(iid),
                    "rating": float(rng.choice([2.0, 3.0, 3.5, 4.0, 4.5, 5.0])),
                    "timestamp": ts,
                }
            )
    ratings = pd.DataFrame(r_rows)

    # tagging
    t_rows = []
    for _ in range(tagging_rows):
        r = ratings.iloc[int(rng.integers(0, len(ratings)))]
        t_rows.append(
            {
                "uid": int(r.uid),
                "iid": int(r.iid),
                "tag": f"tag{int(rng.integers(0, num_tags))}",
                "timestamp": int(r.timestamp) + 1,
            }
        )
    tagging = pd.DataFrame(t_rows).drop_duplicates()

    return movies, ratings, tagging


def synthetic_ml25m_raw(seed=0, num_users=150, num_items=120, num_genome_tags=30, **kw):
    """Raw frames for the ML-25M pipeline: the ml-small trio plus
    genome_scores/genome_tags, timestamps placed beyond the 2018 cutoff the
    reference filters on (movielens.py:673)."""
    rng = np.random.default_rng(seed + 77)
    movies, ratings, tagging = synthetic_mlsmall_raw(
        seed=seed, num_users=num_users, num_items=num_items, **kw
    )
    ratings = ratings.copy()
    ratings["timestamp"] = ratings["timestamp"] + 1_514_764_800
    tagging = tagging.copy()
    tagging["timestamp"] = tagging["timestamp"] + 1_514_764_800

    gs_rows = []
    for iid in movies.iid:
        for gt in rng.choice(num_genome_tags, size=rng.integers(2, 8), replace=False):
            gs_rows.append(
                {
                    "iid": int(iid),
                    "genome_tid": int(gt) + 1,
                    "relevance": float(rng.random()),
                }
            )
    genome_scores = pd.DataFrame(gs_rows)
    genome_tags = pd.DataFrame(
        {"genome_tid": np.arange(1, num_genome_tags + 1), "tag": [f"gtag{i}" for i in range(num_genome_tags)]}
    )
    return movies, ratings, tagging, genome_scores, genome_tags


def synthetic_ml25m_hin(
    seed=0,
    num_users=40_000,
    num_items=16_000,
    target_interactions=2_000_000,
    num_core=10,
    num_genres=20,
    num_years=10,
    num_directors=2_000,
    num_actors=6_000,
    num_writers=3_000,
    num_tags=800,
    num_genome_tags=1_000,
    tagging_rows=100_000,
):
    """Direct, fully vectorized HINData at the ML-25M post-filter regime
    (~2M interactions after the 2018 timestamp cutoff, user band
    (num_core, 30*num_core) — reference movielens.py:673, 690-695).

    The dataframe pipeline (synthetic_ml25m_raw -> build_ml25m_hin) is the
    fidelity path for correctness tests; at 2M rows its per-row python
    loops take minutes, so the 25m-scale throughput bench builds the same
    HINData shape (9 node types, 10 relations, rejection candidates,
    entity-feature tables) straight from numpy.  Structure-only synthesis:
    edge endpoints are drawn with zipf-ish popularity skew, not learned
    signal — this feeds throughput benches, not quality runs.
    """
    rng = np.random.default_rng(seed)

    types = ["uid", "iid", "genre", "year", "director", "actor", "writer", "tid", "genome_tid"]
    sizes = {
        "uid": num_users, "iid": num_items, "genre": num_genres,
        "year": num_years, "director": num_directors, "actor": num_actors,
        "writer": num_writers, "tid": num_tags, "genome_tid": num_genome_tags,
    }
    type_accs, acc = {}, 0
    for t in types:
        type_accs[t] = acc
        acc += sizes[t]
    num_nodes = acc
    item_lo = type_accs["iid"]

    # --- interactions: lognormal per-user counts clipped to the ML-25M
    # user band (num_core, 30*num_core), zipf-skewed item popularity
    mean_cnt = target_interactions / num_users
    counts = np.clip(
        rng.lognormal(mean=np.log(mean_cnt), sigma=0.55, size=num_users),
        num_core + 2, 30 * num_core - 1,
    ).astype(np.int64)
    u_rep = np.repeat(np.arange(num_users, dtype=np.int64), counts)
    pop = 1.0 / (np.arange(1, num_items + 1) ** 0.8)
    pop = pop / pop.sum()
    i_rep = rng.choice(num_items, size=u_rep.shape[0], p=pop)
    # dedupe (u, i) pairs, keep sorted by (u, i)
    key = u_rep * num_items + i_rep
    key = np.unique(key)
    u_all = key // num_items
    i_all = key % num_items
    per_user = np.bincount(u_all, minlength=num_users)
    # every user keeps >= 2 rows w.h.p.; assert instead of filtering so the
    # uid space stays dense
    assert per_user.min() >= 2, "synthetic draw left a user with <2 items"

    # leave-one-out: last (highest local iid) row of each user group = test
    ends = np.cumsum(per_user) - 1
    test_i = i_all[ends]
    train_mask = np.ones(u_all.shape[0], dtype=bool)
    train_mask[ends] = False
    train_u, train_i = u_all[train_mask], i_all[train_mask]

    train_pos = np.stack([train_u + type_accs["uid"], train_i + item_lo], axis=1)
    ratings = rng.choice([2.0, 3.0, 3.5, 4.0, 4.5, 5.0], size=train_pos.shape[0]).astype(np.float32)

    # --- rejection candidates: per-user padded seen lists, test item col 0
    k_max = int(per_user.max())
    seen = np.zeros((num_users, k_max), dtype=np.int32)
    col = np.arange(u_all.shape[0]) - np.repeat(np.cumsum(per_user) - per_user, per_user)
    # rotate so the test row (last of each group) lands in column 0
    col = np.where(train_mask, col + 1, 0)
    seen[u_all, col] = (i_all + item_lo).astype(np.int32)
    candidates = RejectionCandidates(
        test_users=np.arange(num_users, dtype=np.int32) + type_accs["uid"],
        seen=seen,
        seen_counts=per_user.astype(np.int32),
    )

    # --- relation edges (src typed node, dst item/user nid)
    def attr_edges(tname, per_item):
        e = num_items * per_item
        src = type_accs[tname] + rng.integers(0, sizes[tname], size=e)
        dst = item_lo + np.repeat(np.arange(num_items, dtype=np.int64), per_item)
        return np.vstack([src, dst])

    edge_index = {
        "year2item": attr_edges("year", 1),
        "genre2item": attr_edges("genre", 2),
        "director2item": attr_edges("director", 1),
        "actor2item": attr_edges("actor", 3),
        "writer2item": attr_edges("writer", 1),
        "genome_tag2item": attr_edges("genome_tid", 8),
    }
    t_src = type_accs["tid"] + rng.integers(0, num_tags, size=tagging_rows)
    edge_index["tag2user"] = np.vstack(
        [t_src, type_accs["uid"] + rng.integers(0, num_users, size=tagging_rows)]
    )
    edge_index["tag2item"] = np.vstack(
        [t_src, item_lo + rng.integers(0, num_items, size=tagging_rows)]
    )
    edge_index["user2item"] = train_pos.T.copy()

    hin = HINData(
        name="ml-25m-synth",
        types=types,
        num_nodes_dict=sizes,
        type_accs=type_accs,
        num_nodes=num_nodes,
        edge_index=edge_index,
        edge_type_dict={k: i for i, k in enumerate(edge_index.keys())},
        train_pos=train_pos,
        ratings=ratings,
        candidates=candidates,
    )

    # --- entity features: fixed-width padded tables drawn per type range
    lo, hi = hin.type_ranges()
    widths = [("year", 1), ("genre", 2), ("director", 1), ("actor", 3),
              ("writer", 1), ("genome_tid", 8)]
    kf = sum(w for _, w in widths)
    item_feat = np.concatenate(
        [type_accs[t] + rng.integers(0, sizes[t], size=(num_items, w)) for t, w in widths],
        axis=1,
    ).astype(np.int32)
    item_feat_counts = np.full(num_items, kf, dtype=np.int32)
    ku = 4
    user_feat = (type_accs["tid"] + rng.integers(0, num_tags, size=(num_users, ku))).astype(np.int32)
    user_feat_counts = rng.integers(0, ku + 1, size=num_users).astype(np.int32)
    hin.entity_feats = EntityFeatureTables(
        item_feat=item_feat, item_feat_counts=item_feat_counts,
        user_feat=user_feat, user_feat_counts=user_feat_counts,
        ent_lo=lo, ent_hi=hi,
    )
    return hin


def synthetic_yelp_raw(
    seed=0,
    num_users=320,
    num_items=36,
    num_core=4,
    num_attributes=20,
    num_categories=15,
):
    """Synthetic (business, user, reviewtip) frames in the post-parse schema
    of data/yelp_raw.preprocess_yelp_raw, shaped to survive the reference's
    band filters (bus_count > num_core+40 needs popular businesses;
    num_core < user_count <= num_core+10 needs narrow user histories)."""
    rng = np.random.default_rng(seed)

    # latent taste clusters shared between interactions and item attributes
    # so the HIN carries learnable signal (categories/attributes correlate
    # with which users visit the business)
    n_clusters = 4
    item_cluster = rng.integers(0, n_clusters, size=num_items)
    cat_pool = [
        rng.choice(num_categories, size=max(2, num_categories // n_clusters), replace=False)
        for _ in range(n_clusters)
    ]
    b_rows = []
    for bid in range(1, num_items + 1):
        c = item_cluster[bid - 1]
        attrs = rng.choice(num_attributes, size=rng.integers(1, 5), replace=False)
        cats = rng.choice(cat_pool[c], size=min(2, len(cat_pool[c])), replace=False)
        b_rows.append(
            {
                "business_id": f"b{bid}",
                "stars": float(rng.choice([2.5, 3.0, 3.5, 4.0, 4.5, 5.0])),
                "review_count": int(rng.integers(10, 3000)),
                "is_open": 1,
                "attributes": ",".join(f"Attr{a}" for a in attrs),
                "categories": ", ".join(f"Cat{c}" for c in cats),
                "checkin_count": int(rng.integers(0, 5000)),
            }
        )
    business = pd.DataFrame(b_rows)

    u_rows = []
    for uid in range(1, num_users + 1):
        u_rows.append(
            {
                "user_id": f"u{uid}",
                "review_count": int(rng.integers(1, 900)),
                "friends_count": int(rng.integers(0, 2500)),
                "fans": int(rng.integers(0, 400)),
                "average_stars": float(rng.choice(np.arange(1.0, 5.01, 0.25))),
            }
        )
    user = pd.DataFrame(u_rows)

    # mildly skewed popularity + latent taste clusters: with a tiny catalog,
    # heavy skew makes the leave-most-reviewed-out split pathological (every
    # user's test item is the same global hub whose train count then
    # collapses), and cluster affinity gives the models a real collaborative
    # signal to learn.
    pop = rng.dirichlet(np.ones(num_items) * 5.0)
    rt_rows = []
    for uid in range(1, num_users + 1):
        c = rng.integers(0, n_clusters)
        w = pop * np.where(item_cluster == c, 10.0, 1.0)
        w = w / w.sum()
        k = int(rng.integers(num_core + 1, num_core + 9))
        for bid in rng.choice(np.arange(1, num_items + 1), size=min(k, num_items), replace=False, p=w):
            rt_rows.append({"user_id": f"u{uid}", "business_id": f"b{int(bid)}"})
    reviewtip = pd.DataFrame(rt_rows)
    return business, user, reviewtip


def synthetic_mlsmall_raw(
    seed=0,
    num_users=150,
    num_items=120,
    min_ratings_per_user=8,
    max_ratings_per_user=30,
    num_directors=25,
    num_actors=60,
    num_writers=30,
    num_tags=40,
    tagging_rows=400,
):
    """Returns (movies, ratings, tagging) dataframes in raw-parser schema."""
    rng = np.random.default_rng(seed)

    # movies: popularity-skewed genre/crew assignment
    rows = []
    for iid in range(1, num_items + 1):
        year = int(rng.integers(1930, 2020))
        row = {"iid": iid, "title": f"Movie {iid}", "year": year}
        for gname in GENRES:
            row[gname] = bool(rng.random() < 0.18)
        row["directors"] = ",".join(
            f"Director{int(x)}" for x in rng.choice(num_directors, size=rng.integers(1, 3), replace=False)
        )
        row["actors"] = ",".join(
            f"Actor{int(x)}" for x in rng.choice(num_actors, size=rng.integers(1, 5), replace=False)
        )
        row["writers"] = ",".join(
            f"Writer{int(x)}" for x in rng.choice(num_writers, size=rng.integers(1, 3), replace=False)
        )
        rows.append(row)
    movies = pd.DataFrame(rows).fillna(False)

    # ratings: zipf-ish item popularity, per-user leave-one-out-able histories
    item_pop = rng.dirichlet(np.ones(num_items) * 0.3)
    r_rows = []
    ts = 1_000_000
    for uid in range(1, num_users + 1):
        k = int(rng.integers(min_ratings_per_user, max_ratings_per_user + 1))
        iids = rng.choice(np.arange(1, num_items + 1), size=min(k, num_items), replace=False, p=item_pop)
        for iid in iids:
            ts += int(rng.integers(1, 50))
            r_rows.append(
                {
                    "uid": uid,
                    "iid": int(iid),
                    "rating": float(rng.choice([2.0, 3.0, 3.5, 4.0, 4.5, 5.0])),
                    "timestamp": ts,
                }
            )
    ratings = pd.DataFrame(r_rows)

    # tagging
    t_rows = []
    for _ in range(tagging_rows):
        r = ratings.iloc[int(rng.integers(0, len(ratings)))]
        t_rows.append(
            {
                "uid": int(r.uid),
                "iid": int(r.iid),
                "tag": f"tag{int(rng.integers(0, num_tags))}",
                "timestamp": int(r.timestamp) + 1,
            }
        )
    tagging = pd.DataFrame(t_rows).drop_duplicates()

    return movies, ratings, tagging
