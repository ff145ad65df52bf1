"""Yelp raw-JSON preprocessing: the transformation chain from the raw
dataset files to the (business, user, reviewtip) frames `build_yelp_hin`
consumes.

A copy of the JAX package's ``data/yelp_raw.py`` (json + pandas), so that
both packages read the same frames from the same files.  It replicates
datasets/yelp.py:500-625: business attribute flattening with the
reference's truthy-value vocabulary, friends/checkin counts, review ∪ tip
union.  The checkin year/month/time-of-day boolean expansions feed no graph
edges in the reference and are skipped (only checkin_count matters).
`parse_yelp_dir` mirrors parser/yelp.py:6-39 for the five JSON-lines files
(``YELP_FILES``).  Nothing is fetched: the caller checks that the files are
on disk.
"""

from __future__ import annotations

import json
import re
from os.path import join

import pandas as pd

_TRUTHY = (
    "outdoor", "yes", "allages", "21plus", "19plus", "18plus", "full_bar",
    "beer_and_wine", "yes_free", "yes_corkage", "free", "paid", "quiet",
    "average", "loud", "very_loud", "casual", "formal", "dressy",
)

YELP_FILES = tuple(
    f"yelp_academic_dataset_{name}.json"
    for name in ("business", "user", "review", "tip", "checkin")
)


def parse_yelp_dir(raw_dir):
    """Read the five yelp_academic_dataset_*.json files (parser/yelp.py)."""
    def read(name, cols):
        rows = []
        with open(join(raw_dir, f"yelp_academic_dataset_{name}.json")) as f:
            for line in f:
                d = json.loads(line)
                rows.append({c: d.get(c) for c in cols})
        return pd.DataFrame(rows)

    business = read(
        "business",
        ["business_id", "stars", "review_count", "is_open", "attributes", "categories", "hours"],
    )
    user = read(
        "user", ["user_id", "review_count", "friends", "fans", "average_stars"]
    )
    review = read("review", ["user_id", "business_id"])
    tip = read("tip", ["user_id", "business_id"])
    checkin = read("checkin", ["business_id", "date"])
    return business, user, review, tip, checkin


def flatten_attributes(attr_list):
    """Reference attribute truthiness rules (yelp.py:521-549)."""
    attr_dict = {}
    if attr_list is not None:
        for a, b in attr_list.items():
            b = str(b)
            inner = "".join(re.findall(r"'(.*?)'", b)).lower()
            if b.lower() == "true" or inner in _TRUTHY:
                attr_dict[a.strip()] = True
            elif b.lower() in ("false", "none") or inner in ("no", "none"):
                attr_dict[a.strip()] = False
            elif b[0] != "{":
                attr_dict[a.strip()] = True
            else:
                for c in b.split(","):
                    attr_dict[a.strip()] = False
                    if c == "{}":
                        break
                    parts = c.split(":")
                    if len(parts) > 1 and parts[1].strip().lower() == "true":
                        attr_dict[a.strip()] = True
                        break
    return [k for k, v in attr_dict.items() if v]


def preprocess_yelp_raw(business, user, review, tip, checkin):
    """raw frames -> (business, user, reviewtip) for build_yelp_hin."""
    business = business.copy()
    business["attributes"] = [
        ",".join(flatten_attributes(a)) for a in business["attributes"]
    ]
    business["categories"] = business["categories"].fillna("")

    user = user.copy()
    user["friends_count"] = [
        len(str(f).split(",")) if f not in (None, "None") else 0 for f in user["friends"]
    ]
    user = user.drop(columns=["friends"])

    checkin = checkin.copy()
    checkin["checkin_count"] = [
        len(str(d).split(",")) if d not in (None, "None") else 0 for d in checkin["date"]
    ]
    business = pd.merge(
        business, checkin[["business_id", "checkin_count"]], on="business_id", how="left"
    ).fillna({"checkin_count": 0})

    reviewtip = pd.concat(
        [review[["user_id", "business_id"]], tip[["user_id", "business_id"]]], axis=0
    )
    return business, user, reviewtip
