"""The port's edge-sharded PEA steps on two ranks against the JAX package.

The union route (parallel/edge_parallel.make_edge_sharded_train_step:
GCN; GAT entity-aware on the edge-materialized route with the sharded
softmax; SAGE) against the JAX single-device ``pea_loss`` value and
gradient on the same parameters, and once against the JAX
``make_edge_sharded_train_step`` at dp 2 after an Adam step; the
streaming route (make_stream_edge_sharded_train_step, every graph with
implicit self-loops) against the JAX single-device per-channel
``pea_loss`` at tests/test_stream_edge_sharded.py's bars.  Four channels,
as that file cuts them, keep the JAX compiles short.

One two-rank gloo world on the CPU runs every rank-side case
(tests/torch_parallel_world.py); the parameters are the port's
``pea_init(0)``, handed to JAX with models/params.to_numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.models import pea as jpea
from graph_recsys_benchmark_tpu.parallel import edge_parallel as jep
from graph_recsys_benchmark_tpu.train.optim import make_optimizer as jmake_optimizer
from graph_recsys_benchmark_tpu_torch.models.params import to_numpy
from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig, pea_init
from torch_parallel_world import (
    EDGE_CORE,
    EDGE_RAW,
    N_CHAN,
    STREAM_CORE,
    STREAM_RAW,
    WIDTHS,
    World,
    flat,
)

B = 64
FUSED = {"gcn": ("gcn", False), "gat": ("gat", True), "sage": ("sage", False)}


def _edge_batch(hin, entity_aware):
    """The JAX test_edge_parallel.py batch (its _batch), the last 10 rows
    masked."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, len(hin.train_pos), B)
    cols = [hin.train_pos[rows, 0], hin.train_pos[rows, 1],
            hin.item_acc + rng.integers(0, hin.num_items, B)]
    if entity_aware:
        for _ in range(2):
            cols += [rng.integers(0, hin.num_nodes, B), rng.integers(0, hin.num_nodes, B),
                     rng.integers(0, 2, B)]
    mask = np.ones(B, np.float32)
    mask[-10:] = 0.0
    return np.stack(cols, axis=1).astype(np.int64), mask


def _stream_batch(hin):
    """tests/test_stream_edge_sharded.py's batch."""
    rng = np.random.default_rng(0)
    batch = np.stack([rng.integers(0, hin.num_users, B),
                      rng.integers(hin.num_users, hin.num_users + 30, B),
                      rng.integers(hin.num_users, hin.num_users + 30, B)], axis=1)
    return batch.astype(np.int64), np.ones(B, np.float32)


def _params(cfg):
    """The port's pea_init(0) as a JAX pytree."""
    tcfg = PEAConfig(**{f: getattr(cfg, f) for f in ("conv", "num_nodes", "meta_path_steps",
                                                       "emb_dim", "hidden_size", "repr_dim",
                                                       "entity_aware")})
    return jax.tree_util.tree_map(jnp.asarray,
                                  to_numpy(pea_init(torch.Generator().manual_seed(0), tcfg)))


def _jax_fused(hin, name):
    """The JAX single-device (loss, grads) of a union case."""
    conv, ent = FUSED[name]
    cfg = jpea.PEAConfig(conv=conv, num_nodes=hin.num_nodes, meta_path_steps=(2,) * N_CHAN,
                         entity_aware=ent, **WIDTHS)
    fused = jgraph.build_fused_metapath_graphs(jml.mlsmall_metapath_edges(hin)[:N_CHAN],
                                               hin.num_nodes, conv)
    batch, mask = _edge_batch(hin, ent)
    return jax.jit(jax.value_and_grad(
        lambda p: jpea.pea_loss(p, fused, cfg, jnp.asarray(batch, jnp.int32),
                                row_mask=jnp.asarray(mask))))(_params(cfg))


def _jax_sharded_adam(hin):
    """The JAX make_edge_sharded_train_step at dp 2, one Adam step on the
    GCN case: (loss, params after)."""
    cfg = jpea.PEAConfig(conv="gcn", num_nodes=hin.num_nodes, meta_path_steps=(2,) * N_CHAN,
                         **WIDTHS)
    fused = jgraph.build_fused_metapath_graphs(jml.mlsmall_metapath_edges(hin)[:N_CHAN],
                                               hin.num_nodes, "gcn")
    optimizer = jmake_optimizer("adam", 1e-3, 1e-3)
    params = _params(cfg)
    mesh = JMesh(np.array(jax.devices()[:2]).reshape(2, 1), ("dp", "mp"))
    step, place = jep.make_edge_sharded_train_step(cfg, jep.shard_fused_graphs(fused, 2),
                                                   optimizer, mesh)
    batch, mask = _edge_batch(hin, False)
    p1, _, loss = step(params, optimizer.init(params),
                       *place(jnp.asarray(batch, jnp.int32), jnp.asarray(mask)),
                       jax.random.PRNGKey(0))
    return loss, p1


def _jax_stream(shin):
    """The JAX single-device per-channel (loss, grads) of the stream case."""
    cfg = jpea.PEAConfig(conv="gat", num_nodes=shin.num_nodes, meta_path_steps=(2,) * N_CHAN,
                         entity_aware=False, **WIDTHS)
    per_channel = jgraph.build_metapath_graphs(jml.mlsmall_metapath_edges(shin)[:N_CHAN],
                                               shin.num_nodes, "gat", analytic_gat_loops=True)
    batch, mask = _stream_batch(shin)
    return jax.jit(jax.value_and_grad(
        lambda p: jpea.pea_loss(p, per_channel, cfg, jnp.asarray(batch, jnp.int32),
                                row_mask=jnp.asarray(mask), dropout_key=None)))(_params(cfg))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The world's results and the JAX references, computed while it runs."""
    tmp = tmp_path_factory.mktemp("edge")
    hin = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(**EDGE_RAW), **EDGE_CORE)
    shin = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(**STREAM_RAW), **STREAM_CORE)
    tasks = {}
    for name, (conv, ent) in FUSED.items():
        batch, mask = _edge_batch(hin, ent)
        np.savez(tmp / f"fused_{name}.in.npz", batch=batch, mask=mask)
        tasks[f"fused_{name}"] = dict(task="fused_step", conv=conv, entity_aware=ent,
                                      adam=name == "gcn")
    batch, mask = _stream_batch(shin)
    np.savez(tmp / "stream_step.in.npz", batch=batch, mask=mask)
    tasks["stream_step"] = {}
    world = World(tmp, tasks)
    refs = {f"fused_{name}": _jax_fused(hin, name) for name in FUSED}
    refs["adam"] = _jax_sharded_adam(hin)
    refs["stream_step"] = _jax_stream(shin)
    return world.result(), jax.tree_util.tree_map(np.asarray, refs)


def _leaf_errors(res, jgrads):
    """Per leaf: max error over the JAX leaf's largest value (an all-zero
    JAX leaf must be zero)."""
    want = flat("grad", jgrads)
    assert set(want) == {k for k in res if k.startswith("grad/")}
    errs = {}
    for k, w in want.items():
        got = res[k]
        assert got.shape == w.shape and np.isfinite(got).all(), k
        errs[k] = 0.0 if not w.any() and not got.any() else float(
            np.abs(got - w).max() / np.abs(w).max())
    return errs


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_edge_step_matches_jax_single_device(setup, name):
    """The two-rank union step's total loss within 1e-5 and every
    all-reduced gradient within 1e-5 of its largest value, on both ranks,
    against the JAX single-device pea_loss on the whole union graphs."""
    res, refs = setup
    loss, grads = refs[f"fused_{name}"]
    for r in range(2):
        out = res[f"fused_{name}"][r]
        np.testing.assert_allclose(float(out["loss"]), float(loss), rtol=1e-5)
        errs = _leaf_errors(out, grads)
        assert max(errs.values()) <= 1e-5, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def test_fused_edge_adam_step_matches_jax_sharded(setup):
    """GCN: the parameters after one Adam step of the two-rank port
    against the JAX make_edge_sharded_train_step at dp 2 (its own test's
    bars, tests/test_edge_parallel.py:102-108, on every leaf)."""
    res, refs = setup
    loss, p1 = refs["adam"]
    want = flat("param", p1)
    for r in range(2):
        out = res["fused_gcn"][r]
        np.testing.assert_allclose(float(out["loss"]), float(loss), rtol=1e-5)
        assert {k for k in out if k.startswith("param/")} == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(out[k], w, rtol=1e-4, atol=1e-6, err_msg=k)


def test_stream_edge_step_matches_jax_single_device(setup):
    """The two-rank streaming step (implicit self-loops on every graph, the
    loop term once, psum_scale 1/2) against the JAX single-device
    per-channel pea_loss: loss rtol 1e-5, gradients rtol 5e-3 / atol 5e-4
    (tests/test_stream_edge_sharded.py:97-104)."""
    res, refs = setup
    loss, grads = refs["stream_step"]
    want = flat("grad", grads)
    for r in range(2):
        out = res["stream_step"][r]
        np.testing.assert_allclose(float(out["loss"]), float(loss), rtol=1e-5)
        assert {k for k in out if k.startswith("grad/")} == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(out[k], w, rtol=5e-3, atol=5e-4, err_msg=k)
