"""The edge-parallel pieces of the port (graph_recsys_benchmark_tpu_torch/
parallel/) against the JAX package's parallel/edge_parallel.py: the shards
of a step graph and the channel plan bitwise, the collectives' gradients,
the sharded softmax and aggregate on two ranks against the JAX functions
under a two-device shard_map, the streaming GAT's psum contract on two
ranks against the whole edge list in one process, and ShardedPEATrainer's
choice of the streaming route.

One two-rank gloo world on the CPU runs every rank-side case
(tests/torch_parallel_world.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.parallel import edge_parallel as jep
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.ops.stream_gat import stream_gat_attention_batched
from graph_recsys_benchmark_tpu_torch.parallel import edge_parallel as tep
from torch_parallel_world import (
    EDGE_CORE,
    EDGE_RAW,
    N_CHAN,
    STREAM_CORE,
    STREAM_RAW,
    run_world,
)

FIELDS = ("src", "dst", "w", "rel", "src_perm", "src_sorted")
N_SM, D_SM = 300, 8  # the softmax / aggregate graph: rows, message width
N_ST, KZ = 260, 8  # the streaming graph


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_edges(rng, n, e):
    return rng.integers(0, n, e), rng.integers(0, n, e)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The rank-side cases in one two-rank world, with their inputs."""
    tmp = tmp_path_factory.mktemp("pieces")
    rng = np.random.default_rng(0)
    src, dst = _random_edges(rng, N_SM, 1800)
    per = jep.shard_step_graph(jgraph.build_sage_graph(src, dst, N_SM), 2).src.shape[1]
    sm_in = dict(n=N_SM, src=src, dst=dst,
                 alpha=rng.normal(size=(2, per)).astype(np.float32) * 3,
                 msgs=rng.normal(size=(2, per, D_SM)).astype(np.float32),
                 wt=rng.normal(size=(2, per)).astype(np.float32),
                 ct=rng.normal(size=(2, N_SM, D_SM)).astype(np.float32))
    np.savez(tmp / "softmax_aggregate.in.npz", **sm_in)
    s2, d2 = _random_edges(rng, N_ST, 3000)
    ct = rng.normal(size=(2, N_ST, KZ)).astype(np.float32)
    st_in = dict(n=N_ST, src=s2, dst=d2,
                 z=rng.normal(size=(2, N_ST, KZ)).astype(np.float32),
                 a_src=rng.normal(size=(2, N_ST)).astype(np.float32),
                 a_dst=rng.normal(size=(2, N_ST)).astype(np.float32),
                 ct=np.stack([0.3 * ct, 0.7 * ct]))
    np.savez(tmp / "stream.in.npz", **st_in)
    res = run_world(tmp, {"collectives": {}, "softmax_aggregate": {}, "stream": {}})
    return res, sm_in, st_in


def _check_walks(s, num_nodes):
    """The port-only walks of shard `s`, built here from its own edges."""
    dst, src = s.dst.numpy(), s.src.numpy()
    perm = np.argsort(dst, kind="stable")
    np.testing.assert_array_equal(s.dst_perm.numpy(), perm)
    np.testing.assert_array_equal(s.dst_sorted.numpy(), dst[perm])
    nb = max(1, -(-num_nodes // 128))

    def bounds(ids):
        b = np.searchsorted(ids // 128, np.arange(nb + 1)).astype(np.int32)
        b[0], b[-1] = 0, ids.shape[0]
        return b

    np.testing.assert_array_equal(s.block_bounds.numpy(), bounds(dst))
    np.testing.assert_array_equal(s.src_block_bounds.numpy(),
                                  bounds(src[np.argsort(src, kind="stable")]))


def _check_shards(jsh, tsh, g):
    assert len(tsh) == jsh.src.shape[0]
    for s, t in enumerate(tsh):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(jsh, f))[s], err_msg=f)
        assert (t.num_nodes, t.num_edges, t.gat_loops) == (g.num_nodes, g.num_edges,
                                                           g.gat_loops)
        _check_walks(t, g.num_nodes)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_step_graph_matches_jax(n_shards):
    """Every union graph of GCN and GAT split as the JAX package splits it,
    array for array, with the port's walks of each shard."""
    kw = dict(**EDGE_CORE)
    jh = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(**EDGE_RAW), **kw)
    th = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**EDGE_RAW), **kw)
    for conv in ("gcn", "gat"):
        jf = jgraph.build_fused_metapath_graphs(jml.mlsmall_metapath_edges(jh), jh.num_nodes,
                                                conv)
        tf = tgraph.build_fused_metapath_graphs(tml.mlsmall_metapath_edges(th), th.num_nodes,
                                                conv)
        for jg, tg, jsh, tsh in zip(jf, tf, jep.shard_fused_graphs(jf, n_shards),
                                    tep.shard_fused_graphs(tf, n_shards)):
            _check_shards(jsh, tsh, tg)
            # every real edge in exactly one shard, each shard block-monotone
            real = [t.dst.numpy()[t.dst.numpy() < tg.num_nodes] for t in tsh]
            assert sum(r.size for r in real) == tg.num_edges
            assert all(np.all(np.diff(r // 128) >= 0) for r in real)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_plan_channel_shards_matches_jax(n_shards):
    """The streaming plan: the same groups, every distinct graph's shards
    the JAX package's."""
    jh = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(**STREAM_RAW), **STREAM_CORE)
    th = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**STREAM_RAW), **STREAM_CORE)
    jpc = jgraph.build_metapath_graphs(jml.mlsmall_metapath_edges(jh)[:N_CHAN], jh.num_nodes,
                                       "gat", analytic_gat_loops=True)
    tpc = tgraph.build_metapath_graphs(tml.mlsmall_metapath_edges(th)[:N_CHAN], th.num_nodes,
                                       "gat", analytic_gat_loops=True)
    jgroups, jdist = jep.plan_channel_shards(jpc, n_shards)
    tgroups, tdist = tep.plan_channel_shards(tpc, n_shards)
    assert tgroups == jgroups
    assert any(len(c) > 1 for step in tgroups for c, _ in step)  # a shared group
    for k, (jd, td) in enumerate(zip(jdist, tdist)):
        assert len(jd) == len(td)
        for gi, (jsh, tsh) in enumerate(zip(jd, td)):
            chans = [c for c, i in tgroups[k] if i == gi][0]
            _check_shards(jsh, tsh, tpc[chans[0]][k])


def test_psum_gradient_sums_the_ranks_cotangents(world):
    """psum: forward the sum, backward the sum of both ranks' cotangents;
    pmax carries no gradient; all_reduce_grads sums .grad and the loss in
    one buffer; the digests agree."""
    res = world[0]["collectives"]
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    c = [x + 10.0 * (r + 1) for r in range(2)]
    for r in range(2):
        out = res[r]
        np.testing.assert_array_equal(out["y"], x * 1 + x * 2)
        np.testing.assert_array_equal(out["grad"], c[0] + c[1])
        np.testing.assert_array_equal(out["m"], np.maximum(x, -2 * x))
        assert not out["m_grad"]
        np.testing.assert_array_equal(out["w_grad"], np.full((2, 3), 1.0 + 2.0))
        np.testing.assert_array_equal(out["b_grad"], np.full(2, 2.0))
        assert float(out["loss"]) == 2 * 3 * 1.0 + 2 * 3 * 2.0
        assert out["digests_equal"]


def test_sharded_softmax_and_aggregate_match_jax(world):
    """make_sharded_softmax and make_psum_aggregate on two ranks against the
    JAX functions under shard_map on two of conftest's fake devices: each
    rank's softmax, its gradient, the summed aggregate and its gradient."""
    res, inp, _ = world
    n = N_SM
    sh = jep.shard_step_graph(jgraph.build_sage_graph(inp["src"], inp["dst"], n), 2)
    softmax, aggregate = jep.make_sharded_softmax("dp"), jep.make_psum_aggregate("dp")

    def f(alpha, msgs, wt, ct, graph):
        g = jep._local_view(graph)
        sm, vjp = jax.vjp(lambda a: softmax(a, g.dst, n), alpha.reshape(-1))
        agg, vjp2 = jax.vjp(lambda m: aggregate(m, g), msgs.reshape(-1, D_SM))
        return (sm[None], vjp(wt.reshape(-1))[0][None], agg,
                vjp2(ct.reshape(n, D_SM))[0][None])

    mesh = JMesh(np.array(jax.devices()[:2]).reshape(2, 1), ("dp", "mp"))
    gspec = jax.tree_util.tree_map(lambda _: P("dp", None), sh)
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("dp"), P("dp"), P("dp"), P("dp"),
                                                        gspec),
                               out_specs=(P("dp"), P("dp"), P(), P("dp")), check_vma=False))
    sm, dalpha, agg, dmsgs = (np.asarray(a) for a in fn(
        jnp.asarray(inp["alpha"]), jnp.asarray(inp["msgs"]), jnp.asarray(inp["wt"]),
        jnp.asarray(inp["ct"]), sh))
    for r in range(2):
        out = res["softmax_aggregate"][r]
        np.testing.assert_allclose(out["sm"], sm[r], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["dalpha"], dalpha[r], rtol=1e-5,
                                   atol=1e-6 * np.abs(dalpha).max())
        np.testing.assert_allclose(out["agg"], agg, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["dmsgs"], dmsgs[r], rtol=1e-6, atol=1e-6)


def test_stream_gat_psum_contract(world):
    """StreamGAT on each rank's shard (psum_scale 1/2, a split cotangent)
    against the whole edge list in one process: the output on both ranks,
    and dz, da_src, da_dst summed over the ranks."""
    res, _, inp = world
    n = N_ST
    g = tgraph.build_gat_graph(inp["src"], inp["dst"], n, analytic_loops=True)
    z, a_s, a_d = (torch.from_numpy(inp[k]).requires_grad_() for k in ("z", "a_src", "a_dst"))
    out = stream_gat_attention_batched(z, a_s, a_d, g.src, g.dst, g.src_perm, g.src_sorted,
                                       n, True, 0.2, "f32", g.block_bounds, g.src_block_bounds)
    (out * torch.from_numpy(inp["ct"].sum(axis=0))).sum().backward()
    want = {"out": out.detach().numpy(), "dz": z.grad.numpy(), "da_src": a_s.grad.numpy(),
            "da_dst": a_d.grad.numpy()}
    for r in range(2):
        for k, w in want.items():
            got = res["stream"][r][k]
            assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), (r, k)


def test_edge_trainer_takes_the_stream_route_at_scale(monkeypatch):
    """ShardedPEATrainer(mode='edge') takes the streaming route exactly when
    a per-channel graph crosses the implicit-loop threshold (lowered here,
    as tests/test_stream_edge_sharded.py lowers the JAX package's), and at
    a world of one its epoch is the single-process grouped forward's."""
    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
    from graph_recsys_benchmark_tpu_torch.parallel.engine import ShardedPEATrainer
    from graph_recsys_benchmark_tpu_torch.parallel.mesh import Mesh
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig
    from torch_parallel_world import WIDTHS

    th = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**STREAM_RAW), **STREAM_CORE)
    cfg = PEAConfig(conv="gat", num_nodes=th.num_nodes, meta_path_steps=(2,) * N_CHAN,
                    **WIDTHS)
    tcfg = TrainConfig(batch_size=64, sampling_strategy="random", num_negative_samples=1)
    edges = tml.mlsmall_metapath_edges(th)[:N_CHAN]
    one = Mesh(dp=1, device=torch.device("cpu"))
    below = ShardedPEATrainer(th, cfg, tcfg, metapath_edges=edges, mesh=one)
    assert not hasattr(below, "_stream_edge_plan") and len(below._edge_graphs) == 2
    monkeypatch.setattr(tgraph, "STREAM_MIN_EDGES", 1024)
    sh = ShardedPEATrainer(th, cfg, tcfg, metapath_edges=edges, mesh=one)
    groups, local = sh._stream_edge_plan
    assert any(g.gat_loops for step in local for g in step)
    base = PEATrainer(th, cfg, tcfg, metapath_edges=edges, device="cpu")
    losses = []
    for tr in (base, sh):
        params = tr.init(2020)
        losses.append(float(tr.run_epoch(params, tr.optimizer(params),
                                         torch.Generator().manual_seed(5))))
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-3)
