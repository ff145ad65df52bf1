"""Graph conv layers: initializers and the edge aggregation.

Ported: GATConv's, GCNConv's and SAGEConv's initializers, ``_aggregate``
(the segment-sum of edge messages into destination rows,
ops/segment_kernels K5) and the per-channel ``gat_apply`` (the grouped GAT
forward's conv, models/pea.py), without attention dropout.  The fused
forwards live in models/pea.py; ``gcn_apply`` and ``sage_apply`` are still
to port (ROADMAP Queue 1).

Semantics (PyG 1.5.0, the reference's pin), with the degree and self-loop
work precomputed into StepGraph.w (graph.py):
  GCNConv : out_i = sum_{(j,i) in E+I} (deg_j^-1/2 deg_i^-1/2) (x_j W) + b
  GATConv : alpha_e = softmax_dst(leaky_relu(att_dst . (x_i W) +
            att_src . (x_j W))), out_i = concat_heads(sum_j alpha_e (x_j W)) + b
  SAGEConv: out = mean_j(x_j) W_rel + b + x W_root
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.flash_gat import msg_cast
from ..ops.gather import gather_dst, gather_src
from ..ops.segment_kernels import segment_softmax, sorted_segment_sum
from ..ops.stream_gat import stream_gat_attention
from .init import glorot, torch_linear_bias, torch_linear_weight


def _aggregate(msgs, g, transport="f32"):
    """Segment-sum edge messages [E, D] into g's destination rows -> f32
    [g.num_nodes, D]; the messages ride the transport dtype, and the kernel
    walks the edges by dst (g.dst_perm), each row's edges one run."""
    return sorted_segment_sum(msgs, g.dst, g.num_nodes, transport, (g.dst_perm, g.dst_sorted))


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


def gat_apply(params, x, g, heads=1, concat=True, negative_slope=0.2, dropout=0.0,
              transport="f32"):
    """GATConv over StepGraph `g` (nn/conv.py:76-162): x [>= g.num_nodes,
    din] (rows past num_nodes are layout padding that no edge reads) ->
    [num_nodes, heads*C] (concat) or [num_nodes, C].

    A `gat_loops` graph runs the streaming GAT per head
    (ops/stream_gat.stream_gat_attention: K9 forward, K10 and K11
    backward, the self-loop analytic).  A graph with its loops as edges
    runs the composed pipeline: the source rows ``[h | a_src]`` gathered in
    the transport dtype (gather_src: K7, backward K6), a_dst gathered by dst
    (gather_dst: K7, backward K5), leaky ReLU, the per-dst softmax
    (segment_softmax: K8 stats), the messages in the transport dtype and
    their segment-sum (_aggregate: K5).  Attention dropout is not ported:
    ROADMAP Queue 1, "Training options left out of slice 2"."""
    if dropout > 0.0:
        raise NotImplementedError(
            "GAT attention dropout is not ported: ROADMAP Queue 1, \"Training options "
            "left out of slice 2\" (its RNG)")
    n = g.num_nodes
    h = (x[:n] @ params["w"]).reshape(n, heads, -1)  # [N, H, C]
    att = params["att"][0]  # [H, 2C]: x_i (target) first, then x_j
    c = att.shape[-1] // 2
    alpha_dst = torch.sum(h * att[None, :, :c], dim=-1)  # [N, H]
    alpha_src = torch.sum(h * att[None, :, c:], dim=-1)
    if g.gat_loops:
        head_outs = [
            stream_gat_attention(h[:, hh], alpha_src[:, hh], alpha_dst[:, hh], g.src, g.dst,
                                 g.src_perm, g.src_sorted, n, True, negative_slope,
                                 transport, g.block_bounds, g.src_block_bounds)
            for hh in range(heads)
        ]
        out = torch.stack(head_outs, dim=1)  # [N, H, C]
    else:
        packed = msg_cast(torch.cat([h.reshape(n, heads * c), alpha_src], dim=1),
                          transport=transport)
        packed_e = gather_src(packed, g, transport)  # [E, H*C + H]
        h_e = packed_e[:, : heads * c].reshape(-1, heads, c)
        alpha = gather_dst(alpha_dst, g, transport) + packed_e[:, heads * c :].float()
        alpha = segment_softmax(F.leaky_relu(alpha, negative_slope), g.dst, n, transport,
                                g.block_bounds, (g.dst_perm, g.dst_sorted))
        msgs = h_e * msg_cast(alpha, transport=transport)[:, :, None]  # [E, H, C]
        out = _aggregate(msgs.reshape(-1, heads * c), g, transport).reshape(n, heads, c)
    out = out.reshape(n, heads * c) if concat else out.mean(dim=1)
    return out + params["b"]


def sage_init(generator, in_dim, out_dim):
    return {
        "w_rel": torch_linear_weight(generator, in_dim, out_dim),
        "b_rel": torch_linear_bias(generator, in_dim, out_dim),
        "w_root": torch_linear_weight(generator, in_dim, out_dim),
    }
