"""Graph conv layers: initializers and the edge aggregation.

Ported: GATConv's, GCNConv's and SAGEConv's initializers, and
``_aggregate`` (the segment-sum of edge messages into destination rows,
ops/segment_kernels K5).  The fused forwards that use them live in
models/pea.py; the per-channel ``gat_apply`` (attention dropout),
``gcn_apply`` and ``sage_apply`` are still to port (ROADMAP Queue 1).

Semantics (PyG 1.5.0, the reference's pin), with the degree and self-loop
work precomputed into StepGraph.w (graph.py):
  GCNConv : out_i = sum_{(j,i) in E+I} (deg_j^-1/2 deg_i^-1/2) (x_j W) + b
  GATConv : alpha_e = softmax_dst(leaky_relu(att_dst . (x_i W) +
            att_src . (x_j W))), out_i = concat_heads(sum_j alpha_e (x_j W)) + b
  SAGEConv: out = mean_j(x_j) W_rel + b + x W_root
"""

from __future__ import annotations

import torch

from ..ops.segment_kernels import sorted_segment_sum
from .init import glorot, torch_linear_bias, torch_linear_weight


def _aggregate(msgs, g, transport="f32"):
    """Segment-sum edge messages [E, D] into g's destination rows -> f32
    [g.num_nodes, D]; the messages ride the transport dtype."""
    return sorted_segment_sum(msgs, g.dst, g.num_nodes, transport)


def gcn_init(generator, in_dim, out_dim):
    return {"w": glorot(generator, (in_dim, out_dim)),
            "b": torch.zeros(out_dim, dtype=torch.float32)}


def gat_init(generator, in_dim, out_dim, heads=1):
    return {
        "w": glorot(generator, (in_dim, heads * out_dim)),
        # stored exactly as PyG's att param [1, H, 2C] so glorot fan matches
        "att": glorot(generator, (1, heads, 2 * out_dim)),
        "b": torch.zeros(heads * out_dim, dtype=torch.float32),
    }


def sage_init(generator, in_dim, out_dim):
    return {
        "w_rel": torch_linear_weight(generator, in_dim, out_dim),
        "b_rel": torch_linear_bias(generator, in_dim, out_dim),
        "w_root": torch_linear_weight(generator, in_dim, out_dim),
    }
