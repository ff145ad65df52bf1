"""Port parity for the baselines' graphs and convs: graph.build_ngcf_graph,
graph.build_kg_graph, nn/conv's NGCF, KGAT and KGCN convs and
models/kg.compute_att_map, against the JAX package on the CPU.

* The two builders bitwise the JAX package's, on a graph with self-loops,
  repeated (src, dst) pairs of different relations and relation 0, whose
  reversed copies keep +0; over 200 nodes and over 256 (a multiple of 128,
  where the padding id is no row of the embedding table).
* Each conv's forward and the gradients of a weighted sum of it in x and
  every weight, at the bars of tests/test_torch_gcn_sage_slice.py: f32 1e-5
  of the largest value; bf16 transport 1e-3 for the forward, the median
  gradient leaf 1e-3 and every leaf 5e-2.  The bf16 reference is the TPU
  path at the baselines' sizes (>= 65,536 edges): there the Pallas
  segment-sums and scatter-adds round their messages and cotangents to
  the transport dtype and sum in f32; off the TPU the JAX package sums its
  XLA fallback in the messages' own dtype, so the test hands the JAX convs
  that rounding (``_tpu_segment_sum``).  The JAX side is compiled with
  ``xla_allow_excess_precision`` off (test_torch_gcn_sage_slice.py).
* The attention map (KGAT, KGCN) on the real edges at 1e-5, 0 on the
  padding edges, finite and without gradient, at 200 and 256 nodes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.models import kg as jkg
from graph_recsys_benchmark_tpu.nn import conv as jconv
from graph_recsys_benchmark_tpu.ops import config as jconfig
from graph_recsys_benchmark_tpu.ops import gather as jgather
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.models import kg as tkg
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.nn import conv as tconv

EXACT_BF16 = {"xla_allow_excess_precision": False}
FIELDS = ("src", "dst", "w", "rel", "src_perm", "src_sorted")
NODES = (200, 256)
DIN, DOUT = 16, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _typed(n, seed=0, e=1500):
    """(src, dst, rel) of a KG trainer's model graph: typed edges plus their
    reversed copies with negated relation ids; self-loops, repeated pairs of
    other relations, and relation 0 among them."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    src[:40] = dst[:40]  # self-loops
    src[40:80], dst[40:80] = src[80:120], dst[80:120]  # repeated pairs
    rel = rng.integers(0, 8, e)
    rel[:200] = 0
    return (np.concatenate([src, dst]), np.concatenate([dst, src]),
            np.concatenate([rel, -rel]))


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for n in NODES:
        s, d, r = _typed(n)
        out[n] = {
            "ngcf": (jgraph.build_ngcf_graph(s, d, n), tgraph.build_ngcf_graph(s, d, n)),
            "kg": (jgraph.build_kg_graph(s, d, r, n), tgraph.build_kg_graph(s, d, r, n)),
        }
    return out


@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("kind", ["ngcf", "kg"])
def test_builders_bitwise_jax(graphs, kind, n):
    jg, tg = graphs[n][kind]
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jg, f)), getattr(tg, f).numpy(),
                                      err_msg=f)
    assert (jg.num_nodes, jg.num_edges, jg.src_span) == (tg.num_nodes, tg.num_edges,
                                                         tg.src_span)
    e = tg.num_edges
    s, d, r = _typed(n)
    keep = s != d
    assert e == int(keep.sum()) < s.size and bool((tg.src[:e] != tg.dst[:e]).all())
    if kind == "kg":
        # the signs kept; relation 0's reversed copies are +0
        assert sorted(tg.rel[:e].tolist()) == sorted(r[keep].tolist())
        assert int((tg.rel[:e] == 0).sum()) > 0
    else:  # w = 0 where a degree is 0 after the halving; the metapath builder's conv
        assert float(tg.w[:e].min()) >= 0.0 and bool(torch.isfinite(tg.w).all())
        (mp,), = tgraph.build_metapath_graphs([[(s, d)]], n, "ngcf")
        for f in FIELDS:
            assert torch.equal(getattr(mp, f), getattr(tg, f)), f
    # the port's dst walk (K5's) of the same edges
    np.testing.assert_array_equal(tg.dst_sorted.numpy(), np.sort(tg.dst.numpy()))


def test_ngcf_builder_reference_degrees():
    """The reference's degree: each node's count over both edge rows, halved
    by integer division (1 // 2 == 0 gives its edges w 0)."""
    src = np.array([0, 1, 1, 2, 3, 3])
    dst = np.array([1, 0, 2, 1, 3, 0])
    g = tgraph.build_ngcf_graph(src, dst, 4)
    e = g.num_edges
    got = {(int(a), int(b)): float(w) for a, b, w in zip(g.src[:e], g.dst[:e], g.w[:e])}
    # counts without the loop (3, 3): node 0: 3, 1: 4, 2: 2, 3: 1 -> deg 1, 2, 1, 0
    want = {(0, 1): 2 ** -0.5, (1, 0): 2 ** -0.5, (1, 2): 2 ** -0.5, (2, 1): 2 ** -0.5,
            (3, 0): 0.0}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-7)


def _tpu_segment_sum(msgs, dst, num_rows, indices_are_sorted=True, use_pallas=None):
    """The Pallas segment-sum's and scatter-add's rounding (TPU, >= 65,536
    edges): the messages in the transport dtype, f32 sums; the cotangent of
    the messages is the output's, unrounded (the kernel's VJP)."""
    t = jnp.bfloat16 if jconfig.SEGSUM_TRANSPORT == "bf16" else jnp.float32
    m = msgs.astype(jnp.float32)
    m = m + jax.lax.stop_gradient(msgs.astype(t).astype(jnp.float32) - m)
    return jax.ops.segment_sum(m, dst, num_segments=num_rows).astype(jnp.float32)


def _leaf_errors(tgrads, jgrads):
    errs = []
    for k in jgrads:
        t, j = tgrads[k], np.asarray(jgrads[k])
        assert t.shape == j.shape and np.isfinite(t).all(), k
        if not j.any():
            assert not t.any(), k
            continue
        errs.append(float(np.abs(t - j).max() / np.abs(j).max()))
    return sorted(errs)


def _att(n, tg):
    """A per-edge attention map (0 on padding) for the KG convs."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0.05, 1.0, tg.dst.shape[0]).astype(np.float32)
    a[tg.num_edges:] = 0.0
    return a


@pytest.mark.parametrize("transport", ["f32", "bf16"])
@pytest.mark.parametrize("conv", ["ngcf", "kgat", "kgcn"])
def test_conv_forward_and_grads_match_jax(graphs, monkeypatch, conv, transport):
    n = 256 if conv == "kgat" else 200  # one conv where the table has no padding row
    jg, tg = graphs[n]["ngcf" if conv == "ngcf" else "kg"]
    rows = -(-n // 128) * 128  # the embedding table's rows (emb_rows)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(rows, DIN)).astype(np.float32)
    r = rng.normal(size=(n, DOUT)).astype(np.float32)
    att = _att(n, tg)
    params = {"ngcf": jconv.ngcf_init, "kgat": jconv.kgat_init,
              "kgcn": jconv.kgcn_init}[conv](jax.random.PRNGKey(0), DIN, DOUT)
    params = {k: np.asarray(v) for k, v in params.items()}
    if "b" in params:  # a bias off zero, so its gradient path shows
        params["b"] = rng.normal(size=params["b"].shape).astype(np.float32)
    monkeypatch.setattr(jconfig, "SEGSUM_TRANSPORT", transport)
    monkeypatch.setattr(jconv, "segment_sum_auto", _tpu_segment_sum)
    monkeypatch.setattr(jgather, "segment_sum_auto", _tpu_segment_sum)

    def japply(p, xx):
        if conv == "ngcf":
            return jconv.ngcf_apply(p, xx, jg)
        return getattr(jconv, f"{conv}_apply")(p, xx, jg, jnp.asarray(att))

    def jloss(p, xx):
        out = japply(p, xx)
        return jnp.sum(out * r), out

    (jl, jout), (jgp, jgx) = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True),
        compiler_options=EXACT_BF16)(params, jnp.asarray(x)))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    if conv == "ngcf":
        out = tconv.ngcf_apply(tp, tx, tg, transport=transport)
    else:
        out = getattr(tconv, f"{conv}_apply")(tp, tx, tg, torch.from_numpy(att),
                                              transport=transport)
    loss = torch.sum(out * torch.from_numpy(r))
    loss.backward()
    tol = 1e-5 if transport == "f32" else 1e-3
    assert out.shape == jout.shape and out.dtype == torch.float32
    assert np.abs(out.detach().numpy() - jout).max() <= tol * np.abs(jout).max()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=tol, atol=tol)
    errs = _leaf_errors({"x": tx.grad.numpy(), **{k: v.grad.numpy() for k, v in tp.items()}},
                        {"x": jgx, **jgp})
    if transport == "f32":
        assert errs[-1] <= 1e-5, errs
    else:
        assert errs[len(errs) // 2] <= 1e-3 and errs[-1] <= 5e-2, errs


@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("variant", ["kgat", "kgcn"])
def test_att_map_matches_jax(graphs, variant, n):
    """At 256 nodes emb_rows == num_nodes: the padding edges' dst is no row
    of x (clamped in the port, clipped in JAX), their attention 0."""
    jg, tg = graphs[n]["kg"]
    jcfg = jkg.KGConfig(variant=variant, num_nodes=n, num_relations=8, emb_dim=DIN,
                        hidden_size=DIN)
    tcfg = tkg.KGConfig(variant=variant, num_nodes=n, num_relations=8, emb_dim=DIN,
                        hidden_size=DIN)
    assert tcfg.emb_rows == jcfg.emb_rows == 256
    jp = jkg.kg_init(jax.random.PRNGKey(3), jcfg)
    want = np.asarray(jax.jit(lambda p: jkg.compute_att_map(p, jg, jcfg))(jp))
    model = tparams.kg_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp))
    got = tkg.compute_att_map(model, tg, tcfg)
    assert not got.requires_grad and got.dtype == torch.float32
    e = tg.num_edges
    got = got.numpy()
    assert np.isfinite(got).all() and not got[e:].any()
    np.testing.assert_allclose(got[:e], want[:e], rtol=1e-5, atol=1e-6)
    # every dst's weights sum to 1
    sums = np.bincount(tg.dst[:e].numpy(), weights=got[:e], minlength=n)
    has = np.bincount(tg.dst[:e].numpy(), minlength=n) > 0
    np.testing.assert_allclose(sums[has], 1.0, rtol=1e-5)
