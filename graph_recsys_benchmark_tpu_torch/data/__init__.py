from .hin import (
    CandidateTables,
    EntityFeatureTables,
    HINData,
    RejectionCandidates,
    pad_ragged,
)
from .movielens import (
    build_ml25m_hin,
    build_mlsmall_hin,
    ml25m_metapath_edges,
    mlsmall_metapath_edges,
)
from .synthetic import (
    synthetic_ml25m_hin,
    synthetic_ml25m_raw,
    synthetic_mlsmall_raw,
    synthetic_yelp_raw,
)
from .yelp import build_yelp_hin, yelp_metapath_edges

__all__ = [
    "CandidateTables",
    "EntityFeatureTables",
    "HINData",
    "RejectionCandidates",
    "pad_ragged",
    "build_ml25m_hin",
    "build_mlsmall_hin",
    "ml25m_metapath_edges",
    "mlsmall_metapath_edges",
    "synthetic_ml25m_hin",
    "synthetic_ml25m_raw",
    "synthetic_mlsmall_raw",
    "synthetic_yelp_raw",
    "build_yelp_hin",
    "yelp_metapath_edges",
]
