"""Small raw dataset files that the port's tests (and chip_smoke.py's CLI
archive phase) write: the ml-latest-small CSVs (the grouplens layout), the
ML-25M CSVs (plus genome scores and tags) and the five Yelp JSON-lines
files, each drawn from a numpy seed."""

import json
import os
import zipfile

import numpy as np


def write_ml_csvs(folder, seed=0, num_users=60, num_movies=70):
    """Grouplens-layout movies.csv / ratings.csv / tags.csv from a seed."""
    rng = np.random.default_rng(seed)
    genres = ["Action", "Comedy", "Drama", "Horror", "Romance", "Sci-Fi"]
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "movies.csv"), "w") as f:
        f.write("movieId,title,genres\n")
        for m in range(num_movies):
            g = rng.choice(genres, size=rng.integers(1, 4), replace=False)
            title = f"Movie {m}, The ({rng.integers(1930, 2019)})" if m % 3 else f"Film {m}"
            f.write(f'{m + 1},"{title}",{"|".join(g)}\n')
    with open(os.path.join(folder, "ratings.csv"), "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for u in range(num_users):
            for m in rng.choice(num_movies, size=rng.integers(6, 20), replace=False):
                f.write(f"{u + 1},{m + 1},{rng.integers(1, 11) / 2},"
                        f"{rng.integers(9e8, 1.5e9)}\n")
    with open(os.path.join(folder, "tags.csv"), "w") as f:
        f.write("userId,movieId,tag,timestamp\n")
        for _ in range(300):
            f.write(f"{rng.integers(1, num_users + 1)},{rng.integers(1, num_movies + 1)},"
                    f"tag{rng.integers(0, 12)},{rng.integers(9e8, 1.5e9)}\n")


def write_ml_zip(zip_path, wrapper="ml-latest-small", seed=0):
    """A grouplens-layout archive of write_ml_csvs's files: each under
    ``<wrapper>/`` (a flat archive for wrapper None), written beside
    `zip_path` in a staging folder first.  Returns zip_path."""
    stage = os.path.join(os.path.dirname(os.path.abspath(zip_path)), "stage-" + str(seed))
    write_ml_csvs(stage, seed=seed)
    with zipfile.ZipFile(zip_path, "w") as zf:
        for name in sorted(os.listdir(stage)):
            zf.write(os.path.join(stage, name),
                     arcname=name if wrapper is None else f"{wrapper}/{name}")
    return zip_path


def write_ml25m_csvs(folder, seed=0, num_users=60, num_movies=40, num_genome_tags=12):
    """movies / ratings / tags / genome-scores / genome-tags .csv.  Most
    ratings lie past the 2018 cutoff (1514764799), some before it; every
    user rates 6-19 movies, inside the user band of num_core 2 or 3."""
    rng = np.random.default_rng(seed)
    genres = ["Action", "Comedy", "Drama", "Horror", "Romance", "Sci-Fi"]
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "movies.csv"), "w") as f:
        f.write("movieId,title,genres\n")
        for m in range(num_movies):
            g = rng.choice(genres, size=rng.integers(1, 4), replace=False)
            title = f"Movie {m}, The ({rng.integers(1930, 2019)})" if m % 3 else f"Film {m}"
            f.write(f'{m + 1},"{title}",{"|".join(g)}\n')
    with open(os.path.join(folder, "ratings.csv"), "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for u in range(num_users):
            for m in rng.choice(num_movies, size=rng.integers(6, 20), replace=False):
                ts = rng.integers(1.52e9, 1.56e9) if rng.random() < 0.9 else rng.integers(
                    1.2e9, 1.5e9)
                f.write(f"{u + 1},{m + 1},{rng.integers(1, 11) / 2},{ts}\n")
    with open(os.path.join(folder, "tags.csv"), "w") as f:
        f.write("userId,movieId,tag,timestamp\n")
        for _ in range(300):
            f.write(f"{rng.integers(1, num_users + 1)},{rng.integers(1, num_movies + 1)},"
                    f"tag{rng.integers(0, 12)},{rng.integers(1.52e9, 1.56e9)}\n")
    with open(os.path.join(folder, "genome-scores.csv"), "w") as f:
        f.write("movieId,tagId,relevance\n")
        for m in range(num_movies):
            for t in range(num_genome_tags):
                f.write(f"{m + 1},{t + 1},{rng.random():.5f}\n")
    with open(os.path.join(folder, "genome-tags.csv"), "w") as f:
        f.write("tagId,tag\n")
        for t in range(num_genome_tags):
            f.write(f"{t + 1},gtag {t}\n")


_ATTRS = [
    ("WiFi", ["u'free'", "'no'", "u'paid'", "None"]),
    ("HasTV", ["True", "False"]),
    ("Alcohol", ["u'full_bar'", "u'none'", "'beer_and_wine'"]),
    ("BusinessParking", ["{'garage': False, 'street': True, 'lot': False}",
                         "{'garage': False, 'street': False}", "{}", "None"]),
    ("RestaurantsPriceRange2", ["1", "2", "3"]),
    ("NoiseLevel", ["u'quiet'", "u'average'", "u'loud'"]),
]
_CATEGORIES = ["Restaurants", "Bars", "Nightlife", "Food", "Coffee & Tea", "Pizza",
               "Shopping", "Mexican"]


def write_yelp_json(folder, seed=0, num_users=320, num_business=20):
    """The five yelp_academic_dataset_*.json files: nested attribute dicts
    (some None), friends lists (some "None"), reviews and tips over
    popularity-skewed businesses, and a checkin file that misses some
    businesses.  Every user has 3-9 interactions, inside the band of
    num_core 2."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    bids = [f"b{i:03d}x" for i in range(num_business)]
    uids = [f"u{i:04d}y" for i in range(num_users)]

    def dump(name, rows):
        with open(os.path.join(folder, f"yelp_academic_dataset_{name}.json"), "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")

    business = []
    for i, b in enumerate(bids):
        attrs = None
        if i % 5:
            attrs = {k: str(rng.choice(v)) for k, v in _ATTRS if rng.random() < 0.8}
        cats = ", ".join(rng.choice(_CATEGORIES, size=rng.integers(1, 4), replace=False))
        business.append({"business_id": b, "name": f"Place {i}",
                         "stars": float(rng.integers(2, 11) / 2),
                         "review_count": int(rng.integers(3, 1500)),
                         "is_open": int(i % 7 != 3), "attributes": attrs,
                         "categories": cats if i % 6 else None,
                         "hours": {"Monday": "8:0-22:0"} if i % 2 else None})
    dump("business", business)
    users = []
    for i, u in enumerate(uids):
        friends = "None" if i % 4 == 0 else ", ".join(
            rng.choice(uids, size=rng.integers(1, 6), replace=False))
        users.append({"user_id": u, "name": f"User {i}",
                      "review_count": int(rng.integers(1, 900)), "friends": friends,
                      "fans": int(rng.integers(0, 250)),
                      "average_stars": float(np.round(rng.uniform(1, 5), 2))})
    dump("user", users)
    pop = rng.dirichlet(np.ones(num_business) * 2.0)
    review, tip = [], []
    for u in uids:
        for b in rng.choice(bids, size=rng.integers(3, 10), replace=False, p=pop):
            (review if rng.random() < 0.75 else tip).append(
                {"user_id": u, "business_id": str(b), "text": "ok"})
    review.append(dict(review[0]))  # a duplicate interaction
    dump("review", review)
    dump("tip", tip)
    checkin = [{"business_id": b, "date": ", ".join(
        f"2016-0{rng.integers(1, 10)}-1{rng.integers(0, 10)} 10:00:00"
        for _ in range(rng.integers(1, 2500)))} for b in bids if rng.random() < 0.8]
    dump("checkin", checkin)
