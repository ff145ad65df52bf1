"""Static graph tensors: padded, block-sorted edge lists per metapath step.

Port of the JAX package's ``graph.py`` for the GAT, GCN, SAGE, NGCF and
KG (KGAT/KGCN) convs.
Every array is built with numpy exactly as there, so both packages run on
bitwise-equal edge lists (``w`` too: f64 math rounded once to f32):

  * edges are sorted by (dst // 128, src, dst) — "block order".  The JAX
    package sorts with a native counting sort whose numpy fallback is this
    very ``np.lexsort``; both are stable, so the edge order is identical.
    The segment-sum kernel needs it: ``dst // 128`` never decreases, so
    each 128-row dst block owns one contiguous edge range
    (ops/segment_kernels).  The other kernels match ids by value; for them
    block order only keeps the src side local,
  * self-loops where the conv needs them are materialized as real edges,
    and the normalization is precomputed into the per-edge weight ``w``:
      GCN  — PyG 1.5 ``add_remaining_self_loops`` (only missing loops are
             added), deg over the source row, w = deg^-1/2[src] deg^-1/2[dst];
      GAT  — remove existing loops, add one per node, w = 1 (attention
             replaces it at run time); past STREAM_MIN_EDGES (auto mode)
             the loops stay implicit instead (``gat_loops``: a loop-free
             list, padded to a multiple of 2048, whose consumers add the
             loop term analytically, ops/stream_gat.py);
      SAGE — mean aggregation, w = 1/indeg(dst), no loops,
      NGCF — loops removed, w = (deg_src deg_dst)^-1/2 with the
             reference's integer-halved degrees,
      KG   — loops removed, w = 1, ``rel`` the signed relation ids,
  * arrays are padded to a multiple of ``pad_to`` with destination sentinel
    ``dst == num_nodes`` (src 0, w 0); every consumer drops such edges.

A ``StepGraph`` holds torch tensors (int32 ids, f32 weights) on the CPU
after building; ``.to(device)`` moves it.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Tuple

import numpy as np
import torch

from .ops.flash_gat import dst_block_bounds
from .ops.stream_gat import STREAM_MIN_EDGES

PAD_TO = 512
BLOCK = 128


@dataclasses.dataclass(frozen=True, eq=False)
class StepGraph:
    """One message-passing step: E_pad edges over `num_nodes` nodes.

    src/dst: int32[E_pad], sorted by (dst // 128, src); padding has
             dst == num_nodes, src = 0.
    w:       float32[E_pad] per-edge coefficient; 0 on padding edges.
    rel:     int32[E_pad] signed relation ids (0 when unused).
    src_perm/src_sorted: the stable sort of `src`; the streaming GAT's
             src-side backward (K11) and the scatter-add by src (K6,
             ops/gather.gather_src) walk the edges in this order.
    dst_perm/dst_sorted: the stable sort of `dst` (padding last); the
             segment-sum by dst (K5: nn/conv._aggregate, the softmax's and
             gather_dst's backwards) walks the edges in this order, each
             row's edges one run.  Built for every graph, as which conv
             runs a graph is decided per call (models/pea.py): a graph
             that only the streaming GAT reads holds 8 bytes an edge
             unread (ML-25M's u2i and i2u, 2.13 M edges each).
    gat_loops: True = PyG's GAT self-loops are implicit (not in the list);
             only nn/conv.gat_apply and the grouped forward understand it,
             and fuse_step_graphs refuses such graphs.
    block_bounds: int32[ceil(num_nodes / 128) + 1]: the 128-row dst block
             b's edges are [block_bounds[b], block_bounds[b+1]) (the
             padding in the last block's range; ops/flash_gat.dst_block_bounds,
             JAX ``_block_chunk_bounds``): the work split of the softmax
             stats (K8) and of the streaming GAT (K9, K10).
    src_block_bounds: int32[ceil(num_nodes / 128) + 1]: the 128-row src
             block b's edges are [src_block_bounds[b], src_block_bounds[b+1])
             of the src-sorted order (the padding, src 0, in block 0's
             range), K11's work split; built once here, never per step.
    Equality is identity: the hybrid plan and the grouped forward group
    channels by object.
    """

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    rel: torch.Tensor
    src_perm: torch.Tensor
    src_sorted: torch.Tensor
    dst_perm: torch.Tensor
    dst_sorted: torch.Tensor
    num_nodes: int
    num_edges: int  # valid (non-padding) edges
    block_bounds: torch.Tensor
    src_block_bounds: torch.Tensor
    src_span: float = 0.0  # mean 128-row src windows per 512-edge chunk
    gat_loops: bool = False

    def to(self, device) -> "StepGraph":
        move = {
            f: getattr(self, f).to(device)
            for f in ("src", "dst", "w", "rel", "src_perm", "src_sorted", "dst_perm",
                      "dst_sorted", "block_bounds", "src_block_bounds")
        }
        return dataclasses.replace(self, **move)


def _sort_pad(src, dst, w, rel, num_nodes, pad_to=PAD_TO, gat_loops=False):
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    order = np.lexsort((dst, src, dst // BLOCK))
    src, dst, w, rel = src[order], dst[order], w[order], rel[order]
    e = src.shape[0]
    e_pad = max(pad_to, -(-e // pad_to) * pad_to)
    pad = e_pad - e
    src = np.concatenate([src, np.zeros(pad, dtype=np.int64)])
    dst = np.concatenate([dst, np.full(pad, num_nodes, dtype=np.int64)])
    w = np.concatenate([w, np.zeros(pad, dtype=np.float32)])
    rel = np.concatenate([rel, np.zeros(pad, dtype=np.int64)])
    src_perm = np.argsort(src, kind="stable")
    dst_perm = np.argsort(dst, kind="stable")

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    dst_t = i32(dst)
    src_sorted = i32(src[src_perm])
    return StepGraph(
        src=i32(src),
        dst=dst_t,
        block_bounds=dst_block_bounds(dst_t, int(num_nodes)),
        w=torch.from_numpy(w.astype(np.float32)),
        rel=i32(rel),
        src_perm=i32(src_perm),
        src_sorted=src_sorted,
        dst_perm=i32(dst_perm),
        dst_sorted=i32(dst[dst_perm]),
        # the same 128-row searchsorted, over the src-sorted ids
        src_block_bounds=dst_block_bounds(src_sorted, int(num_nodes)),
        num_nodes=int(num_nodes),
        num_edges=int(e),
        src_span=_mean_src_span(src, dst, num_nodes),
        gat_loops=bool(gat_loops),
    )


def _mean_src_span(src, dst, num_nodes, chunk=512):
    """Mean 128-row src-window span per `chunk`-edge chunk (pad lanes
    excluded) — the locality figure the JAX package stores on StepGraph."""
    nch = src.shape[0] // chunk
    if nch == 0:
        return 0.0
    by = src[: nch * chunk].reshape(nch, chunk)
    real = dst[: nch * chunk].reshape(nch, chunk) < num_nodes
    lo = np.where(real, by, num_nodes).min(axis=1)
    hi = np.where(real, by, lo[:, None]).max(axis=1)
    has = real.any(axis=1)
    if not has.any():
        return 0.0
    spans = (hi // BLOCK - lo // BLOCK + 1)[has]
    return float(spans.mean())


def build_gcn_graph(src, dst, num_nodes, pad_to=PAD_TO) -> StepGraph:
    """PyG 1.5 GCNConv norm: add the missing self-loops
    (``add_remaining_self_loops`` keeps existing ones), deg over the source
    row, w_e = deg^-1/2[src] * deg^-1/2[dst]."""
    has_loop = np.zeros(num_nodes, dtype=bool)
    orig_src = np.asarray(src, dtype=np.int64)
    orig_dst = np.asarray(dst, dtype=np.int64)
    loop_mask = orig_src == orig_dst
    has_loop[orig_src[loop_mask]] = True
    loops = np.arange(num_nodes, dtype=np.int64)[~has_loop]
    src2 = np.concatenate([orig_src, loops])
    dst2 = np.concatenate([orig_dst, loops])

    deg = np.bincount(src2, minlength=num_nodes).astype(np.float64)
    dinv = np.zeros_like(deg)
    nz = deg > 0
    dinv[nz] = deg[nz] ** -0.5
    w = (dinv[src2] * dinv[dst2]).astype(np.float32)
    rel = np.zeros_like(src2)
    return _sort_pad(src2, dst2, w, rel, num_nodes, pad_to)


def build_gat_graph(src, dst, num_nodes, pad_to=PAD_TO,
                    analytic_loops=False) -> StepGraph:
    """PyG 1.5 GATConv: remove self-loops, add one per node; w=1 (attention
    replaces it at run time).

    analytic_loops: True keeps the list loop-free and flags the graph
    `gat_loops` (its consumers add the per-node loop term analytically,
    ops/stream_gat.py), padded to a multiple of max(pad_to, 2048) as the
    JAX package aligns it to its streaming chunk; None = auto, analytic
    from STREAM_MIN_EDGES loop-free edges on."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if analytic_loops is None:
        analytic_loops = src.shape[0] >= STREAM_MIN_EDGES
    if analytic_loops:
        w = np.ones(src.shape[0], dtype=np.float32)
        return _sort_pad(src, dst, w, np.zeros_like(src), num_nodes,
                         max(pad_to, 2048), gat_loops=True)
    loops = np.arange(num_nodes, dtype=np.int64)
    src2 = np.concatenate([src, loops])
    dst2 = np.concatenate([dst, loops])
    w = np.ones(src2.shape[0], dtype=np.float32)
    rel = np.zeros_like(src2)
    return _sort_pad(src2, dst2, w, rel, num_nodes, pad_to)


def build_sage_graph(src, dst, num_nodes, pad_to=PAD_TO) -> StepGraph:
    """PyG 1.5 SAGEConv mean aggregation: w_e = 1/indeg(dst), no self-loops."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    indeg = np.bincount(dst, minlength=num_nodes).astype(np.float64)
    w = (1.0 / np.maximum(indeg, 1.0))[dst].astype(np.float32)
    rel = np.zeros_like(src)
    return _sort_pad(src, dst, w, rel, num_nodes, pad_to)


def build_ngcf_graph(src, dst, num_nodes, pad_to=PAD_TO) -> StepGraph:
    """Reference NGCFConv degree scheme (nn/ngcf_conv.py:35-44): self-loops
    removed first, deg_i = (occurrences of i in either edge row) // 2, the
    integer division of torch 1.5's LongTensor '/', and w_e = 1 /
    sqrt(deg_dst * deg_src), 0 where that product is 0."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    count = np.bincount(src, minlength=num_nodes) + np.bincount(dst, minlength=num_nodes)
    deg = (count // 2).astype(np.float64)
    prod = deg[src] * deg[dst]
    w = np.zeros(src.shape[0], dtype=np.float64)
    nz = prod > 0
    w[nz] = 1.0 / np.sqrt(prod[nz])
    rel = np.zeros_like(src)
    return _sort_pad(src, dst, w.astype(np.float32), rel, num_nodes, pad_to)


def build_kg_graph(src, dst, rel, num_nodes, pad_to=PAD_TO) -> StepGraph:
    """KGAT/KGCN typed graph: the raw edges with their signed relation ids
    (``rel`` keeps its sign through the sort), w = 1, self-loops removed
    (reference KGATConv/KGCNConv forward); the attention map is computed
    per epoch over (src, dst, rel) in this block order."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    rel = np.asarray(rel, dtype=np.int64)
    keep = src != dst
    src, dst, rel = src[keep], dst[keep], rel[keep]
    w = np.ones(src.shape[0], dtype=np.float32)
    return _sort_pad(src, dst, w, rel, num_nodes, pad_to)


_BUILDERS = {
    "gcn": build_gcn_graph,
    "gat": build_gat_graph,
    "sage": build_sage_graph,
    "ngcf": build_ngcf_graph,
}


def build_metapath_graphs(
    metapath_steps, num_nodes, conv: str, pad_to=PAD_TO,
    analytic_gat_loops=False,
) -> Tuple[Tuple[StepGraph, ...], ...]:
    """Compile a metapath list (list of lists of (src, dst) numpy edge pairs)
    into per-step StepGraphs for the given conv ('gcn', 'gat', 'sage',
    'ngcf'); the KG graphs are typed, and come from build_kg_graph.

    Identical (src, dst) step lists return the SAME StepGraph object: the
    reference's metapath tables reuse one edge list across several channels
    (ML-small: 7 of 9 second steps ride the item->user graph, ML-25M 7 of
    13), and object identity is the hybrid plan's and the grouped forward's
    grouping key.

    analytic_gat_loops (GAT only): see build_gat_graph; must stay False
    for graphs that will be fused into union graphs."""
    if conv not in _BUILDERS:
        raise ValueError(f"conv {conv!r}: expected one of {sorted(_BUILDERS)}")
    build = _BUILDERS[conv]
    if conv == "gat":
        build = functools.partial(build_gat_graph, analytic_loops=analytic_gat_loops)

    cache = {}

    def cached_build(s, d):
        sa = np.ascontiguousarray(np.asarray(s, dtype=np.int64))
        da = np.ascontiguousarray(np.asarray(d, dtype=np.int64))
        key = (
            hashlib.md5(sa.tobytes()).digest(),
            hashlib.md5(da.tobytes()).digest(),
            sa.shape[0],
        )
        if key not in cache:
            cache[key] = build(s, d, num_nodes, pad_to)
        return cache[key]

    return tuple(
        tuple(cached_build(s, d) for (s, d) in steps) for steps in metapath_steps
    )


def fuse_step_graphs(step_graphs, num_nodes, pad_to=PAD_TO) -> StepGraph:
    """Union the same-position step of several metapath channels into ONE
    graph over a virtual node space of C*num_nodes (channel c's node n maps
    to c*num_nodes + n), so one kernel pass serves all C channels.
    `gat_loops` graphs (implicit self-loops) cannot be fused."""
    srcs, dsts, ws, rels = [], [], [], []
    for c, g in enumerate(step_graphs):
        if g.gat_loops:
            raise ValueError(
                "cannot fuse gat_loops (implicit self-loop) graphs: build the "
                "per-channel graphs with analytic_gat_loops=False for the "
                "fused path"
            )
        e = g.num_edges
        srcs.append(g.src[:e].cpu().numpy().astype(np.int64) + c * num_nodes)
        dsts.append(g.dst[:e].cpu().numpy().astype(np.int64) + c * num_nodes)
        ws.append(g.w[:e].cpu().numpy())
        rels.append(g.rel[:e].cpu().numpy().astype(np.int64))
    return _sort_pad(
        np.concatenate(srcs),
        np.concatenate(dsts),
        np.concatenate(ws).astype(np.float32),
        np.concatenate(rels),
        num_nodes * len(step_graphs),
        pad_to,
    )


def fuse_step_graphs_interleaved(step_graphs, emb_rows, pad_to=PAD_TO) -> StepGraph:
    """Node-major union: channel c's node n maps to virtual id ``n * C +
    c`` over ``emb_rows * C`` rows (emb_rows: the 128-padded table height).

    fuse_step_graphs is channel-major (c * N + n); this layout makes row
    ownership contiguous under a P-way row sharding of the embedding table:
    virtual row v belongs to shard ``v // (C * emb_rows / P)``, the shard
    that owns node ``v // C`` of the table, so that the row-sharded path
    (parallel/a2a.py) psum-scatters each step's aggregates straight into
    table-aligned shards.  Math per channel is identical.  Built by
    _sort_pad, so the graph carries its walks (src_perm, dst_perm, block
    bounds)."""
    c_total = len(step_graphs)
    srcs, dsts, ws, rels = [], [], [], []
    for c, g in enumerate(step_graphs):
        if g.gat_loops:
            raise ValueError(
                "cannot fuse gat_loops (implicit self-loop) graphs: build the "
                "per-channel graphs with analytic_gat_loops=False for the "
                "fused path"
            )
        e = g.num_edges
        srcs.append(g.src[:e].cpu().numpy().astype(np.int64) * c_total + c)
        dsts.append(g.dst[:e].cpu().numpy().astype(np.int64) * c_total + c)
        ws.append(g.w[:e].cpu().numpy())
        rels.append(g.rel[:e].cpu().numpy().astype(np.int64))
    return _sort_pad(
        np.concatenate(srcs),
        np.concatenate(dsts),
        np.concatenate(ws).astype(np.float32),
        np.concatenate(rels),
        emb_rows * c_total,
        pad_to,
    )


def build_fused_metapath_graphs_interleaved(
    metapath_steps, num_nodes, emb_rows, conv: str, pad_to=PAD_TO
) -> Tuple[StepGraph, ...]:
    """The node-major variant of build_fused_metapath_graphs
    (fuse_step_graphs_interleaved) for the row-sharded path."""
    per_channel = build_metapath_graphs(metapath_steps, num_nodes, conv, pad_to)
    n_steps = {len(ch) for ch in per_channel}
    if len(n_steps) != 1:
        raise ValueError(
            "fused metapath graphs require every metapath to have the same "
            f"number of steps; got step counts {sorted(n_steps)}. Use the "
            "per-channel path (PEAConfig fused=False / --parallel dp) for "
            "mixed-depth metapaths."
        )
    return tuple(
        fuse_step_graphs_interleaved([ch[k] for ch in per_channel], emb_rows, pad_to)
        for k in range(n_steps.pop())
    )


def build_fused_metapath_graphs(
    metapath_steps, num_nodes, conv: str, pad_to=PAD_TO
) -> Tuple[StepGraph, ...]:
    """Fused variant of build_metapath_graphs: every metapath must have the
    same number of steps (true for all reference configs: 2 steps per
    metapath).  Returns one union StepGraph per step position
    (fuse_step_graphs)."""
    per_channel = build_metapath_graphs(metapath_steps, num_nodes, conv, pad_to)
    n_steps = {len(ch) for ch in per_channel}
    if len(n_steps) != 1:
        raise ValueError(
            "fused metapath graphs require every metapath to have the same "
            f"number of steps; got step counts {sorted(n_steps)} (mixed depths "
            "run the per-channel graphs of build_metapath_graphs)"
        )
    return tuple(
        fuse_step_graphs([ch[k] for ch in per_channel], num_nodes, pad_to)
        for k in range(n_steps.pop())
    )


def graphs_to(per_channel, device):
    """Per-channel graphs (tuple[channel] of tuple[step] of StepGraph) on
    `device`, each distinct graph moved once, so channels that shared a
    graph object still share one."""
    moved = {}

    def move(g):
        if id(g) not in moved:
            moved[id(g)] = g.to(device)
        return moved[id(g)]

    return tuple(tuple(move(g) for g in ch) for ch in per_channel)
