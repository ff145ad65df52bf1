"""The walks of csrc/segment.cu's scatter_add (K5, K6) on the CPU.

  * The walks the kernel takes (StepGraph.dst_perm / dst_sorted for K5,
    src_perm / src_sorted for K6) visit every edge exactly once, in
    non-decreasing id order, ties in edge order (a stable sort), the
    padding sentinels (dst == num_nodes) last, on graphs from every graph
    constructor (GCN, SAGE, GAT with loop edges and with implicit loops, a
    fused union).
  * The accumulator's padded width (acc_width): the row itself for widths
    1 and 2, else the next multiple of 4 (16-byte rows).
  * Every work-split rule that torch_tools/segment_variants.py replaces is
    in csrc/segment.cu exactly once, so its variants measure the source as
    it stands.  The kernel's own split runs on the card
    (tests/test_torch_kernels.py).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as tsk

N = 700


def _graph(kind, seed=0):
    """A graph of `kind` over N rows with a hot dst block, a hot source and
    an empty 128-row block."""
    rng = np.random.default_rng(seed)
    e = 5000
    src, dst = rng.integers(0, N, e), rng.integers(0, N, e)
    dst[:1500] = rng.integers(384, 512, 1500)
    src[1500:2500] = 77
    src = np.where(src // 128 == 2, src + 128, src)
    dst = np.where(dst // 128 == 2, dst + 128, dst)
    if kind == "gat_loops":
        return tgraph.build_gat_graph(src, dst, N, analytic_loops=True)
    if kind == "gat":
        return tgraph.build_gat_graph(src, dst, N, analytic_loops=False)
    if kind == "gcn":
        return tgraph.build_gcn_graph(src, dst, N)
    if kind == "sage":
        return tgraph.build_sage_graph(src, dst, N)
    return tgraph.fuse_step_graphs([tgraph.build_gcn_graph(src, dst, N),
                                    tgraph.build_sage_graph(dst, src, N)], N)


@pytest.mark.parametrize("kind", ["gat_loops", "gat", "gcn", "sage", "fused"])
def test_graph_walks_sort_every_edge_once(kind):
    g = _graph(kind)
    e = g.dst.numel()
    for ids, perm, walk in ((g.dst, g.dst_perm, g.dst_sorted),
                            (g.src, g.src_perm, g.src_sorted)):
        assert perm.dtype == walk.dtype == torch.int32 and perm.shape == walk.shape == (e,)
        p = perm.long()
        assert torch.equal(torch.sort(p).values, torch.arange(e))  # each edge once
        assert torch.equal(walk, ids[p])
        assert bool((walk[1:] >= walk[:-1]).all())
        tie = walk[1:] == walk[:-1]
        assert bool((p[1:][tie] > p[:-1][tie]).all())  # stable
    # the padding (dst == num_nodes) closes the dst walk
    n_pad = e - g.num_edges
    assert bool((g.dst_sorted[e - n_pad:] == g.num_nodes).all())
    assert bool((g.dst_sorted[: e - n_pad] < g.num_nodes).all())


def test_acc_width_pads_rows_to_16_bytes():
    for d in range(1, tsk.MAX_COLS + 1):
        w = tsk.acc_width(d)
        if d <= 2:
            assert w == d
        else:
            assert w % 4 == 0 and d <= w < d + 4
    assert (tsk.acc_width(65), tsk.acc_width(17), tsk.acc_width(64)) == (68, 20, 64)


def test_variants_replace_each_rule_once():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "segment_variants", os.path.join(root, "torch_tools", "segment_variants.py"))
    sv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sv)
    with open(os.path.join(root, "graph_recsys_benchmark_tpu_torch", "csrc", "segment.cu")) as f:
        source = f.read()
    assert len(sv.VARIANTS) == 8
    for name, (_, old, new) in sv.VARIANTS.items():
        out = sv.variant_source(name, source)
        assert out.count(new) == 1 and old not in out and len(out) < len(source)
    with pytest.raises(RuntimeError):
        sv.variant_source("slice 4", source.replace(sv._SLICE, ""))
