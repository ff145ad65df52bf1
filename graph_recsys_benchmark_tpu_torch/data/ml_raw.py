"""MovieLens raw-CSV parsing (OMDB-free).

A copy of ``parse_ml_dir`` from the JAX package's ``data/ml_raw.py``
(pandas only), so that both packages read the same frames from the same
files: ratings/tags/movies CSVs -> the dataframes the HIN builders consume,
including the title-year extraction and genre-column expansion
(reference parser/ml.py:9-52).  Crew columns are read from a cached
`raw_movies.csv` side file when present and otherwise left empty, as there.
``parse_ml25m_extras`` reads ML-25M's genome scores and tags (reference
parser/ml.py:192-200; ``ML25M_FILES`` lists the five files the two readers
open).  Nothing is fetched: the caller checks that the files are on disk.
"""

from __future__ import annotations

import re
from os.path import isfile, join

import pandas as pd

ML_FILES = ("movies.csv", "ratings.csv", "tags.csv")
ML25M_FILES = ML_FILES + ("genome-scores.csv", "genome-tags.csv")


def _extract_year(title):
    year = title[-5:]
    year = year[year.find("(") + 1 : year.find(")")]
    if re.match(r"^-?\d+(?:\.\d+)?$", year) is None:
        return 2020
    return int(year)


def _clean_title(title):
    return title.split(", The")[0].split(" (")[0].split(", A")[0].strip()


def parse_ml_dir(raw_dir, raw_movies_csv=None):
    """raw_dir holds ratings.csv / tags.csv / movies.csv (grouplens layout).
    Returns (movies, ratings, tagging) in builder schema."""
    ratings = pd.read_csv(join(raw_dir, "ratings.csv")).dropna()
    ratings = ratings.rename(columns={"userId": "uid", "movieId": "iid"})
    ratings = ratings.astype({"uid": int, "iid": int, "rating": float})

    tagging = pd.read_csv(join(raw_dir, "tags.csv")).dropna()
    tagging = tagging.rename(columns={"userId": "uid", "movieId": "iid"})
    tagging = tagging.astype({"uid": int, "iid": int, "tag": str})

    if raw_movies_csv is None:
        candidate = join(raw_dir, "raw_movies.csv")
        raw_movies_csv = candidate if isfile(candidate) else None

    if raw_movies_csv is not None:
        movies = pd.read_csv(raw_movies_csv, sep=";").fillna("")
    else:
        movies_orig = pd.read_csv(join(raw_dir, "movies.csv")).dropna()
        rows = []
        for _, row in movies_orig.iterrows():
            data = {
                "iid": int(row["movieId"]),
                "title": _clean_title(row["title"]),
                "year": _extract_year(row["title"]),
            }
            for g in set(row["genres"].split("|")):
                data[g] = True
            rows.append(data)
        movies = pd.DataFrame(rows).fillna(False)
        movies["directors"] = ""
        movies["actors"] = ""
        movies["writers"] = ""
    return movies, ratings, tagging


def parse_ml25m_extras(raw_dir):
    """genome-scores.csv / genome-tags.csv -> builder schema (parser/ml.py:192-200)."""
    genome_scores = pd.read_csv(join(raw_dir, "genome-scores.csv")).dropna()
    genome_scores = genome_scores.rename(columns={"movieId": "iid", "tagId": "genome_tid"})
    genome_tags = pd.read_csv(join(raw_dir, "genome-tags.csv")).dropna()
    genome_tags = genome_tags.rename(columns={"tagId": "genome_tid"})
    return genome_scores, genome_tags
