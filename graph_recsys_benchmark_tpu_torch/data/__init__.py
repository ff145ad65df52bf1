from .hin import (
    CandidateTables,
    EntityFeatureTables,
    HINData,
    RejectionCandidates,
    pad_ragged,
)
from .movielens import build_mlsmall_hin, ml25m_metapath_edges, mlsmall_metapath_edges
from .synthetic import synthetic_ml25m_hin, synthetic_mlsmall_raw

__all__ = [
    "CandidateTables",
    "EntityFeatureTables",
    "HINData",
    "RejectionCandidates",
    "pad_ragged",
    "build_mlsmall_hin",
    "ml25m_metapath_edges",
    "mlsmall_metapath_edges",
    "synthetic_ml25m_hin",
    "synthetic_mlsmall_raw",
]
