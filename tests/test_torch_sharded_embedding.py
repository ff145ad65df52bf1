"""The port's row-sharded table pieces against the JAX package: the
node-major union graphs (graph.fuse_step_graphs_interleaved,
build_fused_metapath_graphs_interleaved) and the static exchange plan
(parallel/sharded_embedding.build_static_plan) bitwise; the three
row-sharded collectives (parallel/collectives.all_to_all, all_gather,
psum_scatter) and their transposes on two ranks against numpy; and the
lookups (sharded_lookup, static_lookup) on two ranks against the JAX
functions on a 2-device JAX mesh, value and gradient, with duplicate ids,
a skewed owner and one overflowed bucket.

One two-rank gloo world on the CPU runs every rank-side case
(tests/torch_parallel_world.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.parallel import sharded_embedding as jse
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.parallel import sharded_embedding as tse
from torch_parallel_world import World, tiny_a2a_setup

S, D = 16, 5  # rows a rank, columns
CAP_OVER = 5  # rank 0 asks owner 1 for 6 distinct rows: one past this capacity


def _lookup_inputs():
    """Two ranks' ids into a [2 S, D] table: duplicates, rank 1 asking
    owner 0 only (a skewed owner), rank 0 asking owner 1 for 6 distinct
    rows; the static sets with duplicates."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(2 * S, D)).astype(np.float32)
    idx = np.empty((2, 12), np.int32)
    idx[0] = [3, 3, 20, 21, 22, 23, 24, 25, 3, 20, 0, 15]
    idx[1] = [1, 1, 1, 2, 7, 9, 2, 2, 9, 7, 7, 1]
    ct = rng.normal(size=(2, 12, D)).astype(np.float32)
    sidx = rng.integers(0, 2 * S, size=(2, 40)).astype(np.int64)
    sidx[:, 5] = sidx[:, 4]
    sct = rng.normal(size=(2, 40, D)).astype(np.float32)
    return dict(table=table, idx=idx, ct=ct, cap=np.asarray(12), cap_over=np.asarray(CAP_OVER),
                sidx=sidx, sct=sct)


def _collective_inputs():
    rng = np.random.default_rng(1)

    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return dict(a2a_x=f(2, 4, 3), a2a_ct=f(2, 4, 3), ag_x=f(2, 2, 3), ag_ct=f(2, 4, 3),
                ps_x=f(2, 4, 3), ps_ct=f(2, 2, 3))


def _jax_lookups(inp):
    """The JAX sharded_lookup (both capacities) and static_lookup (the JAX
    plan) on a 2-device mesh: {name: (values [2, B, D], grads [2 S, D])}."""
    mesh = JMesh(np.array(jax.devices()[:2]), ("dp",))
    out = {}
    for name, cap in (("dyn", int(inp["cap"])), ("over", int(inp["cap_over"]))):
        def f(tab, ids, c, cap=cap):
            val = jse.sharded_lookup(tab, ids, "dp", 2, cap)
            g = jax.grad(lambda t: jnp.sum(jse.sharded_lookup(t, ids, "dp", 2, cap) * c))(tab)
            return val, g

        val, g = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P("dp", None), P("dp"), P("dp", None)),
            out_specs=(P("dp", None), P("dp", None)), check_vma=False))(
            inp["table"], inp["idx"].reshape(-1), inp["ct"].reshape(-1, D))
        out[name] = (np.asarray(val).reshape(2, -1, D), np.asarray(g))
    plan = jse.build_static_plan(inp["sidx"], S, 2)
    arrs = jse.plan_arrays(plan)
    cap = plan["capacity"]

    def g_static(tab, own, pos, serve, c):
        own, pos, serve, c = own[0], pos[0], serve[0], c[0]
        val = jse.static_lookup(tab, own, pos, serve, "dp", 2, cap)
        g = jax.grad(lambda t: jnp.sum(jse.static_lookup(t, own, pos, serve, "dp", 2, cap)
                                       * c))(tab)
        return val[None], g

    val, g = jax.jit(jax.shard_map(
        g_static, mesh=mesh,
        in_specs=(P("dp", None), P("dp", None), P("dp", None), P("dp", None, None),
                  P("dp", None, None)),
        out_specs=(P("dp", None, None), P("dp", None)), check_vma=False))(
        inp["table"], arrs["own"], arrs["pos"], arrs["serve"], inp["sct"])
    out["static"] = (np.asarray(val), np.asarray(g))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The world's results and the JAX lookups, computed while it runs."""
    tmp = tmp_path_factory.mktemp("sharded_embedding")
    inp = _lookup_inputs()
    np.savez(tmp / "lookups.in.npz", **inp)
    np.savez(tmp / "row_collectives.in.npz", **_collective_inputs())
    world = World(tmp, {"lookups": {}, "row_collectives": {}})
    refs = _jax_lookups(inp)
    return world.result(timeout=120), refs, inp


@pytest.mark.parametrize("conv", ["gcn", "gat", "sage"])
def test_interleaved_graphs_match_jax(conv):
    """build_fused_metapath_graphs_interleaved on the tiny setup's edges
    (3 channels, 200 nodes, emb_rows 256): src, dst, w and rel of every
    step bitwise the JAX package's; the walks are the graph's own sorts."""
    cfg, edges, _, _ = tiny_a2a_setup(conv)
    got = tgraph.build_fused_metapath_graphs_interleaved(edges, 200, 256, conv)
    want = jgraph.build_fused_metapath_graphs_interleaved(edges, 200, 256, conv)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.num_nodes == 256 * 3 and g.num_edges == w.num_edges
        for f in ("src", "dst", "w", "rel"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(g.dst_sorted.numpy(), np.sort(g.dst.numpy()))
        np.testing.assert_array_equal(g.src.numpy()[g.src_perm.numpy()], g.src_sorted.numpy())


def test_interleaved_graphs_refuse_mixed_depths():
    _, edges, _, _ = tiny_a2a_setup("gcn")
    with pytest.raises(ValueError, match="same number of steps"):
        tgraph.build_fused_metapath_graphs_interleaved([edges[0][:1]] + edges[1:], 200, 256,
                                                       "gcn")


@pytest.mark.parametrize("which", ["src", "dst", "sage-node"])
def test_static_plan_matches_jax(which):
    """build_static_plan's own, pos, serve and capacity bitwise the JAX
    package's, on the tiny GAT union's two-way edge shards (src, dst with
    the sentinel at row 0, and SAGE step 1's node-space src)."""
    from graph_recsys_benchmark_tpu_torch.parallel.edge_parallel import shard_step_graph

    _, edges, _, _ = tiny_a2a_setup("gat")
    g = tgraph.build_fused_metapath_graphs_interleaved(edges, 200, 256, "gat")[0]
    shards = shard_step_graph(g, 2)
    ids = np.stack([getattr(s, "dst" if which == "dst" else "src").numpy() for s in shards])
    rows = 128 * 3
    if which == "dst":
        ids = np.where(ids >= 256 * 3, 0, ids)
    if which == "sage-node":
        ids, rows = ids // 3, 128
    got = tse.build_static_plan(ids, rows, 2)
    want = jse.build_static_plan(ids, rows, 2)
    assert got["capacity"] == want["capacity"] and got["S"] == want["S"]
    for k in ("own", "pos", "serve"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_row_collectives_and_their_transposes(setup):
    """all_to_all, all_gather and psum_scatter over two ranks against numpy
    (the JAX semantics: chunk p to rank p; tiled gather; tiled sum-scatter),
    each gradient its transpose's; int32 ids exchange too; STATS counts
    each collective by name."""
    res, _, _ = setup
    inp = _collective_inputs()
    for r in range(2):
        out = res["row_collectives"][r]
        x, ct = inp["a2a_x"], inp["a2a_ct"]
        np.testing.assert_array_equal(out["a2a_y"], np.concatenate([x[0][2 * r:2 * r + 2],
                                                                    x[1][2 * r:2 * r + 2]]))
        np.testing.assert_array_equal(out["a2a_dx"], np.concatenate([ct[0][2 * r:2 * r + 2],
                                                                     ct[1][2 * r:2 * r + 2]]))
        np.testing.assert_array_equal(out["ag_y"], inp["ag_x"].reshape(4, 3))
        np.testing.assert_allclose(out["ag_dx"], inp["ag_ct"].sum(0)[2 * r:2 * r + 2],
                                   rtol=1e-6)
        np.testing.assert_allclose(out["ps_y"], inp["ps_x"].sum(0)[2 * r:2 * r + 2], rtol=1e-6)
        np.testing.assert_array_equal(out["ps_dx"], inp["ps_ct"].reshape(4, 3))
        np.testing.assert_array_equal(out["ids"], [2 * r, 2 * r + 1, 10 + 2 * r, 11 + 2 * r])
        assert list(out["ops"]) == ["all_gather", "all_to_all", "psum_scatter"]


@pytest.mark.parametrize("name", ["dyn", "static"])
def test_lookups_match_jax(setup, name):
    """sharded_lookup (duplicate ids; rank 1 asking one owner only) and
    static_lookup on the port's own plan: values bitwise the JAX
    functions' (and the dense gather's), each rank's shard gradient within
    rtol / atol 1e-5 of JAX's (the JAX test's bars)."""
    res, refs, inp = setup
    val, grad = refs[name]
    ids = inp["idx"] if name == "dyn" else inp["sidx"]
    for r in range(2):
        out = res["lookups"][r]
        np.testing.assert_array_equal(out[f"{name}_out"], val[r])
        np.testing.assert_array_equal(out[f"{name}_out"], inp["table"][ids[r]])
        np.testing.assert_allclose(out[f"{name}_grad"], grad[r * S:(r + 1) * S], rtol=1e-5,
                                   atol=1e-5)
    assert not res["lookups"][0]["dyn_overflowed"]


def test_overflowed_bucket_drops(setup):
    """At capacity 5 rank 0's bucket for owner 1 (6 distinct rows) overflows
    (lookup_overflowed says so, as JAX's): the request past it reads zeros
    (JAX's forward clamps it to the bucket's last slot, another id's row)
    and its cotangent is dropped, as in JAX; every other value bitwise
    JAX's, every gradient within 1e-5 of JAX's."""
    res, refs, inp = setup
    val, grad = refs["over"]
    out0 = res["lookups"][0]
    assert out0["over_overflowed"] and not res["lookups"][1]["over_overflowed"]
    assert bool(jse.lookup_overflowed(jnp.asarray(inp["idx"][0]), S, 2, CAP_OVER))
    dropped = inp["idx"][0] == 25  # the 6th distinct id of owner 1
    assert dropped.sum() == 1
    np.testing.assert_array_equal(out0["over_out"][dropped], 0.0)
    np.testing.assert_array_equal(out0["over_out"][~dropped], val[0][~dropped])
    np.testing.assert_array_equal(res["lookups"][1]["over_out"], val[1])
    for r in range(2):
        np.testing.assert_allclose(res["lookups"][r]["over_grad"], grad[r * S:(r + 1) * S],
                                   rtol=1e-5, atol=1e-5)
