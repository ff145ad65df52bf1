"""MetaPath2Vec: metapath random walks + skip-gram loss, on the device.

Port of the JAX package's ``models/metapath2vec.py`` (the reference's
``torch_sparse.SparseTensor.sample`` walker and skip-gram model,
models/metapath2vec.py):

  * per-relation CSR (rowptr/col over *typed local* indices) built once on
    the host; a walk step is ``col[rowptr[n] + floor(u * deg[n])]``, the
    uniform neighbor draw of torch_sparse, including its behavior on
    zero-degree rows (it reads col[rowptr[n]]);
  * walks add per-position type offsets so the embedding covers the global
    node-id space (metapath2vec.py:76-121);
  * skip-gram loss over sliding context windows (metapath2vec.py:147-172),
    reduced one context offset at a time, so no [walks, windows, context,
    dim] tensor is ever made;
  * negative walks draw every position uniformly within the step's node
    type (metapath2vec.py:123-140).

The walker clamps every table index to the table's last element, as the
gathers of the JAX package do (XLA clamps an out-of-range gather index).
Two cases reach past a table: a walk that starts at a node with no row in
the first relation (HeRec's first Yelp metapath starts every walk at a
user, and its first relation has one row per ``item_reviewcount`` node),
and a zero-degree last row, whose ``rowptr[n] + 0`` is ``len(col)``.  Torch
would raise there (a device-side assert on the card), so the clamp keeps
the JAX package's walks (ROADMAP Queue 3).  No repo kernel runs: every op
is a gather, a row product or an elementwise op.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.init import ParamTree


@dataclasses.dataclass(frozen=True)
class RelationCSR:
    """CSR of one typed relation over local (per-type) indices."""

    rowptr: torch.Tensor  # int32[N_src + 1]
    col: torch.Tensor  # int32[max(E, 1)]
    deg: torch.Tensor  # int32[N_src]
    dst_offset: int  # global nid offset of the destination type
    dst_count: int  # nodes in the destination type (for negative walks)


def build_relation_csr(src_local, dst_local, num_src, dst_offset, dst_count,
                       device="cpu") -> RelationCSR:
    """The CSR of the edges (src_local, dst_local) on `device`: a stable
    sort by source, so each row keeps its edges' order; an empty relation
    gets ``col = [0]``."""
    src_local = np.asarray(src_local, dtype=np.int64)
    dst_local = np.asarray(dst_local, dtype=np.int64)
    order = np.argsort(src_local, kind="stable")
    src_s, dst_s = src_local[order], dst_local[order]
    deg = np.bincount(src_s, minlength=num_src)
    rowptr = np.zeros(num_src + 1, dtype=np.int64)
    np.cumsum(deg, out=rowptr[1:])
    col = dst_s if len(dst_s) else np.zeros(1, dtype=np.int64)

    def i32(a):
        return torch.from_numpy(a.astype(np.int32)).to(device)

    return RelationCSR(rowptr=i32(rowptr), col=i32(col), deg=i32(deg),
                       dst_offset=int(dst_offset), dst_count=int(dst_count))


@dataclasses.dataclass(frozen=True)
class MP2VConfig:
    embedding_dim: int = 64
    walk_length: int = 100
    context_size: int = 7
    walks_per_node: int = 1000
    num_negative_samples: int = 5
    start_offset: int = 0  # global nid offset of the metapath's start type
    num_start: int = 0  # nodes of the start type
    num_nodes: int = 0  # total embedding rows (whole typed node space)


class MP2V(ParamTree):
    """The skip-gram embedding in the JAX layout: ``emb [num_nodes, D]``."""


def mp2v_init(generator: torch.Generator, cfg: MP2VConfig) -> MP2V:
    """torch.nn.Embedding's default init, N(0, 1), drawn on the CPU from
    `generator`."""
    return MP2V({"emb": torch.randn((cfg.num_nodes, cfg.embedding_dim), generator=generator)})


def _walk_offsets(metapath: List[RelationCSR], cfg: MP2VConfig, device):
    """Global-id offset of each walk position (metapath2vec.py:80-85)."""
    k = len(metapath)
    offs = [cfg.start_offset] + [metapath[i % k].dst_offset for i in range(cfg.walk_length)]
    return torch.tensor(offs, dtype=torch.int64, device=device)


def _clamped(table, idx):
    """table[idx] with idx clamped to the table's last element, as XLA's
    gather clamps."""
    return table[torch.clamp(idx, max=table.shape[0] - 1)]


def walk_from_uniforms(start_local, metapath: List[RelationCSR], cfg: MP2VConfig, u):
    """Positive walks from given uniforms: start_local int[B] local
    start-type ids, u float32[walk_length, B * walks_per_node] ->
    int64[B * walks_per_node, walk_length + 1] global ids.  The starts are
    tiled whole (walk w starts at start_local[w % B]); step i draws
    ``min(floor(u[i] * f32(deg)), max(deg - 1, 0))`` in f32, as the JAX
    walker does (an f64 floor can cross an integer that the f32 one does
    not)."""
    cur = start_local.long().repeat(cfg.walks_per_node)
    rows = [cur]
    k = len(metapath)
    for i in range(cfg.walk_length):
        rel = metapath[i % k]
        deg = _clamped(rel.deg, cur)
        step = torch.floor(u[i] * deg.float()).to(torch.int32)
        step = torch.minimum(step, torch.clamp(deg - 1, min=0))
        cur = _clamped(rel.col, _clamped(rel.rowptr, cur).long() + step.long()).long()
        rows.append(cur)
    return torch.stack(rows, dim=1) + _walk_offsets(metapath, cfg, cur.device)[None, :]


def sample_pos_walks(generator: torch.Generator, start_local, metapath: List[RelationCSR],
                     cfg: MP2VConfig):
    """Positive walks of the starts, the uniforms drawn from `generator`
    (on the starts' device)."""
    n = start_local.shape[0] * cfg.walks_per_node
    u = torch.rand((cfg.walk_length, n), generator=generator, device=start_local.device)
    return walk_from_uniforms(start_local, metapath, cfg, u)


def sample_neg_walks(generator: torch.Generator, start_local, metapath: List[RelationCSR],
                     cfg: MP2VConfig):
    """Negative walks: the starts tiled walks_per_node * num_negative_samples
    times, every later position uniform within its step's destination type
    (metapath2vec.py:123-140)."""
    start = start_local.long().repeat(cfg.walks_per_node * cfg.num_negative_samples)
    rows = [start]
    k = len(metapath)
    for i in range(cfg.walk_length):
        rows.append(torch.randint(0, metapath[i % k].dst_count, start.shape,
                                  generator=generator, device=start.device))
    return torch.stack(rows, dim=1) + _walk_offsets(metapath, cfg, start.device)[None, :]


def _window_loss(emb, rw, cfg: MP2VConfig, positive: bool):
    """Mean skip-gram loss over the sliding windows of the walks `rw`, one
    context offset at a time.  The reference's -log(σ(x) + 1e-15) /
    -log(1 - σ(x) + 1e-15) in their softplus forms (1e-15 is below f32
    resolution), as the JAX package computes them.  The rows are gathered
    with F.embedding: its backward sums each row's many repeats (a start
    node sits in every one of its walks) in parallel pieces, where an
    indexing backward adds them one by one."""
    num_windows = cfg.walk_length + 2 - cfg.context_size
    h_start = F.embedding(rw[:, :num_windows], emb)  # [B, W, D]
    total = 0.0
    for k in range(1, cfg.context_size):
        dots = torch.sum(h_start * F.embedding(rw[:, k:k + num_windows], emb), dim=-1)  # [B, W]
        total = total + torch.sum(F.softplus(-dots if positive else dots))
    n_pairs = rw.shape[0] * num_windows * (cfg.context_size - 1)
    return total / n_pairs


def mp2v_loss(params: MP2V, pos_rw, neg_rw, cfg: MP2VConfig):
    return (_window_loss(params.emb, pos_rw, cfg, True)
            + _window_loss(params.emb, neg_rw, cfg, False))


def metapath_from_hin(hin, relation_steps: List[Tuple[str, bool]], device="cpu"):
    """RelationCSR steps on `device` from the HIN's relations.

    relation_steps: [(relation_name, reversed?)], e.g. the reference's ml
    metapath uid->iid->genre->iid->uid (metapath2vec_solver_bpr.py:147-160)
    is [('user2item', False), ('genre2item', True), ('genre2item', False),
    ('user2item', True)].  Node types are found by id ranges."""
    def type_of(nid):
        for t in reversed(hin.types):
            if nid >= hin.type_accs[t]:
                return t
        return hin.types[0]

    steps = []
    for name, rev in relation_steps:
        e = hin.edge_index[name]
        src, dst = (e[1], e[0]) if rev else (e[0], e[1])
        src_t = type_of(int(src[0])) if src.shape[0] else hin.types[0]
        dst_t = type_of(int(dst[0])) if dst.shape[0] else hin.types[0]
        steps.append(build_relation_csr(
            src - hin.type_accs[src_t], dst - hin.type_accs[dst_t],
            hin.num_nodes_dict[src_t], hin.type_accs[dst_t], hin.num_nodes_dict[dst_t],
            device=device,
        ))
    return steps
