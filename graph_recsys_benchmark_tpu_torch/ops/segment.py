"""Plain segment reductions over edge lists — the building blocks of the
kernels' plain versions.

Semantics follow the JAX package's ``ops/segment.py`` (itself PyG's
scatter ops): ids ``>= num_segments`` (the padding sentinel) are dropped, as
XLA drops out-of-bounds scatter updates, and ``segment_softmax`` keeps PyG's
+1e-16 denominator guard:

    out_e = exp(a_e - max_{e': dst(e')=dst(e)} a_{e'})
    out_e = out_e / (sum_{e': dst(e')=dst(e)} out_e + 1e-16)
"""

from __future__ import annotations

import torch


def segment_sum(data, segment_ids, num_segments):
    """Sum `data` rows into `num_segments` buckets keyed by `segment_ids`.
    Dropped ids land in one extra row that is cut off, so no boolean mask
    (and no host sync on a card) is needed."""
    out = torch.zeros(
        (num_segments + 1,) + tuple(data.shape[1:]), dtype=data.dtype,
        device=data.device,
    )
    ids = torch.clamp(segment_ids.long(), max=num_segments)
    return out.index_add_(0, ids, data)[:num_segments]


def segment_max(data, segment_ids, num_segments):
    """Max-reduce; empty segments produce -inf."""
    keep = segment_ids < num_segments
    out = torch.full(
        (num_segments,) + tuple(data.shape[1:]), float("-inf"),
        dtype=data.dtype, device=data.device,
    )
    ids = segment_ids[keep].long()
    ids = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data[keep])
    return out.scatter_reduce_(0, ids, data[keep], "amax", include_self=True)


def segment_softmax(logits, segment_ids, num_segments):
    """Per-segment softmax over edge logits (PyG `softmax` parity, incl. the
    +1e-16 denominator guard).  Sentinel edges get a finite placeholder
    value; callers mask them."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    safe = torch.clamp(segment_ids, max=num_segments - 1).long()
    expd = torch.exp(logits - seg_max[safe])
    seg_sum = segment_sum(expd, segment_ids, num_segments)
    return expd / (seg_sum[safe] + 1e-16)
