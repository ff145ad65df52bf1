"""The walks of csrc/segment.cu's scatter_add (K5, K6) on the CPU.

  * The walks the kernel takes (StepGraph.dst_perm / dst_sorted for K5,
    src_perm / src_sorted for K6) visit every edge exactly once, in
    non-decreasing id order, ties in edge order (a stable sort), the
    padding sentinels (dst == num_nodes) last, on graphs from every graph
    constructor (GCN, SAGE, GAT with loop edges and with implicit loops, a
    fused union).
  * The accumulator's padded width (acc_width): the row itself for widths
    1 and 2, else the next multiple of 4 (16-byte rows).
  * torch_tools/cu_variants.py, which builds the variants that
    torch_tools/segment_variants.py and gat_bwd_walk.py time, replaces a
    rule's text only where the source holds it exactly once, so a variant
    measures the source as it stands.  The kernel's own split runs on the
    card (tests/test_torch_kernels.py).
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
    """torch_tools/cu_variants.py, which builds the variants of
    torch_tools/segment_variants.py and gat_bwd_walk.py: each rule's text
    is replaced where it is held once, and a text held twice or not at all
    is refused before anything is built."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "cu_variants", os.path.join(root, "torch_tools", "cu_variants.py"))
    cv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cv)
    source = "int u = 4;\nconst int slice = 8;\nint v = 4;\n"
    out = cv.variant_source("x.cu", source, [("int u = 4;", "int u = 2;"),
                                            ("slice = 8;", "slice = 16;")])
    assert out == "int u = 2;\nconst int slice = 16;\nint v = 4;\n"
    assert cv.variant_source("x.cu", source, []) == source
    for rules in ([("= 4;", "= 1;")], [("slice = 32;", "slice = 4;")],
                  [("int u = 4;", "int v = 4;"), ("int v = 4;", "int w = 4;")]):
        with pytest.raises(RuntimeError, match="csrc/x.cu"):
            cv.variant_source("x.cu", source, rules)
