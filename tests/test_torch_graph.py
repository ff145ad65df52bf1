"""Port parity: HIN builders, metapath step graphs and the hybrid GAT plan
of graph_recsys_benchmark_tpu_torch against the JAX package, bitwise.

Both packages build from the same raw frames; the port's copies of the
builders must give equal arrays, the same block-ordered padded edge lists,
the same identity sharing of step graphs, and the same plan groups."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pytest
import torch

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.models import pea as jpea
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.models import pea as tpea

RAW = dict(seed=5, num_users=60, num_items=90, num_directors=20,
           num_actors=40, num_writers=20, num_tags=30, tagging_rows=300)


@pytest.fixture(scope="module")
def hins():
    jraw = jsyn.synthetic_mlsmall_raw(**RAW)
    traw = tsyn.synthetic_mlsmall_raw(**RAW)
    for a, b in zip(jraw, traw):
        pd.testing.assert_frame_equal(a, b)
    kw = dict(num_core=5, num_feat_core=3)
    return jml.build_mlsmall_hin(*jraw, **kw), tml.build_mlsmall_hin(*traw, **kw)


def test_hin_arrays_equal(hins):
    jh, th = hins
    for f in ("name", "types", "num_nodes_dict", "type_accs", "num_nodes",
              "edge_type_dict"):
        assert getattr(jh, f) == getattr(th, f), f
    assert jh.edge_index.keys() == th.edge_index.keys()
    for k in jh.edge_index:
        np.testing.assert_array_equal(jh.edge_index[k], th.edge_index[k], err_msg=k)
    np.testing.assert_array_equal(jh.train_pos, th.train_pos)
    np.testing.assert_array_equal(jh.ratings, th.ratings)
    for f in ("test_users", "cand", "neg_counts"):
        np.testing.assert_array_equal(getattr(jh.candidates, f), getattr(th.candidates, f))
    for f in ("item_feat", "item_feat_counts", "user_feat", "user_feat_counts",
              "ent_lo", "ent_hi"):
        np.testing.assert_array_equal(getattr(jh.entity_feats, f), getattr(th.entity_feats, f))
    for a, b in zip(jml.mlsmall_metapath_edges(jh), tml.mlsmall_metapath_edges(th)):
        for (js, jd), (ts, td) in zip(a, b):
            np.testing.assert_array_equal(js, ts)
            np.testing.assert_array_equal(jd, td)


def _assert_graph_equal(jg, tg):
    for f in ("src", "dst", "w", "rel", "src_perm", "src_sorted"):
        j = np.asarray(getattr(jg, f))
        t = getattr(tg, f).numpy()
        assert j.dtype == t.dtype, f
        np.testing.assert_array_equal(j, t, err_msg=f)
    assert (jg.num_nodes, jg.num_edges) == (tg.num_nodes, tg.num_edges)
    assert jg.src_span == tg.src_span


@pytest.fixture(scope="module")
def step_graphs(hins):
    jh, th = hins
    jg = jgraph.build_metapath_graphs(jml.mlsmall_metapath_edges(jh), jh.num_nodes, "gat")
    tg = tgraph.build_metapath_graphs(tml.mlsmall_metapath_edges(th), th.num_nodes, "gat")
    return jg, tg


def test_metapath_graphs_and_sharing_equal(step_graphs):
    jg, tg = step_graphs
    assert len(jg) == len(tg) == 9
    flat_j = [g for ch in jg for g in ch]
    flat_t = [g for ch in tg for g in ch]
    for a, b in zip(flat_j, flat_t):
        _assert_graph_equal(a, b)
    # identity sharing is the hybrid plan's grouping key
    share_j = [[a is b for b in flat_j] for a in flat_j]
    share_t = [[a is b for b in flat_t] for a in flat_t]
    assert share_j == share_t
    assert sum(map(sum, share_t)) > len(flat_t)  # some step graph is shared


def test_fuse_step_graphs_equal(step_graphs, hins):
    jg, tg = step_graphs
    n = hins[0].num_nodes
    _assert_graph_equal(
        jgraph.fuse_step_graphs([ch[0] for ch in jg], n),
        tgraph.fuse_step_graphs([ch[0] for ch in tg], n),
    )


def test_hybrid_plan_equal(step_graphs, hins):
    jg, tg = step_graphs
    n = hins[0].num_nodes
    common = dict(conv="gat", num_nodes=n, meta_path_steps=(2,) * 9, emb_dim=16,
                  hidden_size=16, repr_dim=8)
    jplan = jpea.build_hybrid_gat_plan(jg, n, jpea.PEAConfig(**common, entity_aware=True))
    tplan = tpea.build_hybrid_gat_plan(tg, n, tpea.PEAConfig(**common))
    assert any(len(b) for b, _, _ in tplan.steps)
    for (jb, ju, jr), (tb, tu, tr) in zip(jplan.steps, tplan.steps):
        assert [c for _, c in jb] == [c for _, c in tb]
        assert jr == tr
        for (jgr, _), (tgr, _) in zip(jb, tb):
            _assert_graph_equal(jgr, tgr)
        assert (ju is None) == (tu is None)
        if ju is not None:
            _assert_graph_equal(ju, tu)
    moved = tplan.to(torch.device("cpu"))
    assert [c for _, c in moved.steps[1][0]] == [c for _, c in tplan.steps[1][0]]


def test_analytic_loops_not_ported():
    """Implicit self-loops are ported (the streaming GAT); what stays out
    is fusing such graphs into union graphs, which the JAX package refuses
    too."""
    g = tgraph.build_gat_graph(np.array([0, 1, 1]), np.array([1, 0, 1]), 2,
                               analytic_loops=True)
    assert g.gat_loops and g.num_edges == 2 and g.dst.shape[0] == 2048
    with pytest.raises(ValueError):
        tgraph.fuse_step_graphs([g], 2)
