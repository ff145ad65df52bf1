"""Graph conv layers: initializers and the edge aggregation.

Ported: GATConv's, GCNConv's, SAGEConv's, NGCFConv's, KGATConv's and
KGCNConv's initializers, ``_aggregate``
(the segment-sum of edge messages into destination rows,
ops/segment_kernels K5), ``propagate`` (the weighted sum of source rows
that GCN and SAGE share: K7 forward and K6 backward for the gather, K5
forward and K7 backward for the sum), and the per-channel convs
``gcn_apply``, ``sage_apply`` and ``gat_apply`` (the per-channel forwards
of models/pea.py), the last with attention dropout under keep masks that
the caller draws.  The fused forwards (models/pea.py) run ``propagate`` on
union graphs.  The baselines' convs ``ngcf_apply`` (models/ngcf.py),
``kgat_apply`` and ``kgcn_apply`` (models/kg.py) gather their edge rows
with gather_src (K7 forward, K6 backward) and gather_dst (K7 forward, K5
backward) and sum with _aggregate (K5 forward, K7 backward).

Semantics (PyG 1.5.0, the reference's pin), with the degree and self-loop
work precomputed into StepGraph.w (graph.py):
  GCNConv : out_i = sum_{(j,i) in E+I} (deg_j^-1/2 deg_i^-1/2) (x_j W) + b
  GATConv : alpha_e = softmax_dst(leaky_relu(att_dst . (x_i W) +
            att_src . (x_j W))), out_i = concat_heads(sum_j alpha_e (x_j W)) + b
  SAGEConv: out = mean_j(x_j) W_rel + b + x W_root
  NGCFConv: out_i = leaky_relu(x_i W1 + sum_j w_e (x_j W1 + (x_i * x_j) W2))
            (reference nn/ngcf_conv.py:42-48)
  KGATConv: a_i = sum_j att_e x_j; out = leaky_relu((x + a) W_add) +
            leaky_relu((x * a) W_bi) + b (reference nn/kgat_conv.py:43-54)
  KGCNConv: out = relu((sum_j att_e x_j + x) W + b) (nn/kgcn_conv.py:39-44)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.flash_gat import msg_cast
from ..ops.gather import gather_dst, gather_src
from ..ops.segment_kernels import segment_softmax, sorted_segment_sum
from ..ops.stream_gat import stream_gat_attention, stream_gat_reference
from .init import glorot, torch_linear_bias, torch_linear_weight


def _aggregate(msgs, g, transport="f32"):
    """Segment-sum edge messages [E, D] into g's destination rows -> f32
    [g.num_nodes, D]; the messages ride the transport dtype, and the kernel
    walks the edges by dst (g.dst_perm), each row's edges one run."""
    return sorted_segment_sum(msgs, g.dst, g.num_nodes, transport, (g.dst_perm, g.dst_sorted))


def propagate(z, g, transport="f32", aggregate=None):
    """Σ over g's edges (j, i) of w_e z_j into row i -> f32 [g.num_nodes,
    D]: z [>= g.num_nodes, D] and g.w cast to the transport dtype (JAX
    ``msg_cast``), their product rounded there, f32 sums.  The source rows
    ride gather_src (K7, backward K6), the sum _aggregate (K5, backward
    K7), or `aggregate(msgs, g, transport)` where given (the edge-parallel
    sum over the ranks, parallel/edge_parallel.make_psum_aggregate)."""
    z, w = msg_cast(z, g.w, transport=transport)
    return (aggregate or _aggregate)(w[:, None] * gather_src(z, g, transport), g, transport)


def gcn_init(generator, in_dim, out_dim):
    return {"w": glorot(generator, (in_dim, out_dim)),
            "b": torch.zeros(out_dim, dtype=torch.float32)}


def gcn_apply(params, x, g, transport="f32"):
    """GCNConv over StepGraph `g` (JAX nn/conv.py:56-60): x [>= g.num_nodes,
    din] (rows past num_nodes are layout padding that no edge reads) ->
    [num_nodes, dout]; the normalization is g.w."""
    return propagate(x[: g.num_nodes] @ params["w"], g, transport) + params["b"]


def gat_init(generator, in_dim, out_dim, heads=1):
    return {
        "w": glorot(generator, (in_dim, heads * out_dim)),
        # stored exactly as PyG's att param [1, H, 2C] so glorot fan matches
        "att": glorot(generator, (1, heads, 2 * out_dim)),
        "b": torch.zeros(heads * out_dim, dtype=torch.float32),
    }


def gat_apply(params, x, g, heads=1, concat=True, negative_slope=0.2, dropout=0.0,
              transport="f32", keep=None):
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
    their segment-sum (_aggregate: K5).

    Attention dropout at rate `dropout` takes its keep masks from `keep`
    (None: no dropout; models/pea.DropoutMasks draws them): on a composed
    graph a bool [E, heads] that drops the normalized alphas before the
    transport cast, kept ones scaled by 1 / (1 - dropout) (JAX
    nn/conv.py:153-156); on a `gat_loops` graph one (edge_keep [E],
    loop_keep [N]) pair a head, run through stream_gat_reference (plain
    torch ops, on the card too), never the streaming kernels."""
    n = g.num_nodes
    h = (x[:n] @ params["w"]).reshape(n, heads, -1)  # [N, H, C]
    att = params["att"][0]  # [H, 2C]: x_i (target) first, then x_j
    c = att.shape[-1] // 2
    alpha_dst = torch.sum(h * att[None, :, :c], dim=-1)  # [N, H]
    alpha_src = torch.sum(h * att[None, :, c:], dim=-1)
    if g.gat_loops and keep is not None:
        head_outs = [
            stream_gat_reference(h[:, hh], alpha_src[:, hh], alpha_dst[:, hh], g.src, g.dst,
                                 n, True, negative_slope, edge_keep=ek, loop_keep=lk,
                                 dropout=dropout)
            for hh, (ek, lk) in enumerate(keep)
        ]
        out = torch.stack(head_outs, dim=1)  # [N, H, C]
    elif g.gat_loops:
        head_outs = [
            stream_gat_attention(h[:, hh], alpha_src[:, hh], alpha_dst[:, hh], g.src, g.dst,
                                 g.src_perm, g.src_sorted, n, True, negative_slope,
                                 transport, g.block_bounds, g.src_block_bounds)
            for hh in range(heads)
        ]
        out = torch.stack(head_outs, dim=1)  # [N, H, C]
    else:
        out = composed_attention(h, alpha_src, alpha_dst, g, negative_slope, transport, keep,
                                 dropout)
    out = out.reshape(n, heads * c) if concat else out.mean(dim=1)
    return out + params["b"]


def composed_attention(h, alpha_src, alpha_dst, g, negative_slope=0.2, transport="f32",
                       keep=None, dropout=0.0, softmax=None, aggregate=None):
    """GAT attention over the edges of StepGraph `g` with its loops as
    edges, composed: h [N, H, C], alpha_src / alpha_dst [N, H] (N =
    g.num_nodes) -> f32 [N, H, C].  The source rows ``[h | a_src]`` in the
    transport dtype by gather_src (K7, backward K6), a_dst by gather_dst
    (K7, backward K5), leaky ReLU, the per-dst softmax (segment_softmax:
    K8; or `softmax(alpha, dst, num_rows)`), dropout under `keep`, the
    messages in the transport dtype summed by dst (_aggregate: K5; or
    `aggregate(msgs, g, transport)`).  gat_apply's composed path, and the
    union step's of models/pea._edge_gat_step: the edge-parallel one with
    the sharded softmax and sum, the dropout one with `keep`."""
    n, heads, c = h.shape
    packed = msg_cast(torch.cat([h.reshape(n, heads * c), alpha_src], dim=1),
                      transport=transport)
    packed_e = gather_src(packed, g, transport)  # [E, H*C + H]
    h_e = packed_e[:, : heads * c].reshape(-1, heads, c)
    alpha = F.leaky_relu(gather_dst(alpha_dst, g, transport) + packed_e[:, heads * c :].float(),
                         negative_slope)
    if softmax is None:
        alpha = segment_softmax(alpha, g.dst, n, transport, g.block_bounds,
                                (g.dst_perm, g.dst_sorted))
    else:
        alpha = softmax(alpha, g.dst, n)
    if keep is not None:
        alpha = torch.where(keep, alpha / (1.0 - dropout), torch.zeros_like(alpha))
    msgs = h_e * msg_cast(alpha, transport=transport)[:, :, None]  # [E, H, C]
    return (aggregate or _aggregate)(msgs.reshape(-1, heads * c), g, transport).reshape(
        n, heads, c)


def sage_init(generator, in_dim, out_dim):
    return {
        "w_rel": torch_linear_weight(generator, in_dim, out_dim),
        "b_rel": torch_linear_bias(generator, in_dim, out_dim),
        "w_root": torch_linear_weight(generator, in_dim, out_dim),
    }


def sage_apply(params, x, g, transport="f32"):
    """SAGEConv over StepGraph `g` (JAX nn/conv.py:178-185): the mean of the
    transport-rounded source rows (g.w = 1 / indeg(dst)), then w_rel and
    b_rel, plus the root term from the un-rounded input.  x [>= g.num_nodes,
    din] -> [num_nodes, dout]."""
    xn = x[: g.num_nodes]
    mean_agg = propagate(xn, g, transport)
    return mean_agg @ params["w_rel"] + params["b_rel"] + xn @ params["w_root"]


def ngcf_init(generator, in_dim, out_dim):
    return {"w1": glorot(generator, (in_dim, out_dim)),
            "w2": glorot(generator, (in_dim, out_dim))}


def ngcf_apply(params, x, g, negative_slope=0.2, transport="f32"):
    """NGCFConv over StepGraph `g` (JAX nn/conv.py:196-201): x [>= g.num_nodes,
    din] -> [num_nodes, dout].  No message cast, as in JAX: the rows ride
    the gathers in x's dtype, and the transport rounds the messages inside
    the segment-sum (K5) and the gathers' backward sums (K6, K5), as the
    Pallas kernels cast them on the TPU at these graphs' sizes."""
    n = g.num_nodes
    x_j = gather_src(x, g, transport)
    x_i = gather_dst(x[:n], g, transport)
    msgs = g.w[:, None] * (x_j @ params["w1"] + (x_i * x_j) @ params["w2"])
    aggr = _aggregate(msgs, g, transport)
    return F.leaky_relu(x[:n] @ params["w1"] + aggr, negative_slope)


def kgat_init(generator, in_dim, out_dim):
    return {"w_add": glorot(generator, (in_dim, out_dim)),
            "w_bi": glorot(generator, (in_dim, out_dim)),
            "b": torch.zeros(out_dim, dtype=torch.float32)}


def _attend(x, g, att_map, transport, aggregate=None):
    """sum_j att_e x_j into each dst row -> f32 [num_nodes, D]: x and the
    per-edge attention [E_pad] (0 on padding) in the transport dtype, their
    product rounded there (JAX ``msg_cast``), f32 sums (_aggregate, or the
    `aggregate` hook)."""
    xm, att = msg_cast(x, att_map, transport=transport)
    return (aggregate or _aggregate)(att[:, None] * gather_src(xm, g, transport), g,
                                     transport)


def kgat_apply(params, x, g, att_map, negative_slope=0.2, transport="f32", aggregate=None):
    """KGATConv over StepGraph `g` with the frozen attention `att_map`
    (JAX nn/conv.py:215-227): x [>= g.num_nodes, din] -> [num_nodes, dout].
    `aggregate(msgs, g, transport)` overrides the edge sum (the
    edge-parallel path sums the ranks' partials)."""
    aggr = _attend(x, g, att_map, transport, aggregate)
    xn = x[: g.num_nodes]
    add_aggr = F.leaky_relu((xn + aggr) @ params["w_add"], negative_slope)
    bi_aggr = F.leaky_relu((xn * aggr) @ params["w_bi"], negative_slope)
    return add_aggr + bi_aggr + params["b"]


def kgcn_init(generator, in_dim, out_dim):
    return {"w": glorot(generator, (in_dim, out_dim)),
            "b": torch.zeros(out_dim, dtype=torch.float32)}


def kgcn_apply(params, x, g, att_map, transport="f32", aggregate=None):
    """KGCNConv over StepGraph `g` with the frozen attention `att_map`
    (JAX nn/conv.py:234-237): x [>= g.num_nodes, din] -> [num_nodes, dout];
    `aggregate` as kgat_apply's."""
    aggr = _attend(x, g, att_map, transport, aggregate)
    return torch.relu((aggr + x[: g.num_nodes]) @ params["w"] + params["b"])
