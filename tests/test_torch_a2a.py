"""The port's a2a step (parallel/a2a.py: the row-sharded table, static
exchange plans on the interleaved union graphs, all-to-all lookups,
psum-scattered aggregates) on two ranks against the JAX package.

GCN, SAGE, GAT, GAT entity-aware and GAT with two heads on the JAX
tests/test_sharded_embedding.py tiny setup (200 nodes, 3 channels, emb 16):
the total loss and every gradient (x's re-assembled from the ranks' rows)
against the JAX single-device ``pea_loss`` on the fused union graphs, at
the JAX test_a2a_step_matches_replicated bars (loss rtol 2e-5, leaves rtol
5e-4 / atol 5e-5); GAT entity-aware after one Adam step against the JAX
``make_a2a_train_step`` at dp 2; the mixed-depth ValueError; attention
dropout trains with masks of each rank's own.

One two-rank gloo world on the CPU runs every rank-side case
(tests/torch_parallel_world.py); the parameters are the port's
``pea_init(0)``, handed to JAX with models/params.to_numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.models import pea as jpea
from graph_recsys_benchmark_tpu.parallel import a2a as ja2a
from graph_recsys_benchmark_tpu.train.optim import make_optimizer as jmake_optimizer
from graph_recsys_benchmark_tpu_torch.models.params import to_numpy
from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig, pea_init
from torch_parallel_world import World, flat, tiny_a2a_setup

CASES = {"gcn": ("gcn", False, 1), "sage": ("sage", False, 1), "gat": ("gat", False, 1),
         "gat_entity": ("gat", True, 1), "gat_heads2": ("gat", False, 2)}


def _jax_case(name):
    """(JAX PEAConfig, the port's pea_init(0) as a JAX pytree, batch, mask,
    metapath edges) of a case."""
    conv, ent, heads = CASES[name]
    cfg_kw, edges, batch, mask = tiny_a2a_setup(conv, ent, heads)
    params = to_numpy(pea_init(torch.Generator().manual_seed(0), PEAConfig(**cfg_kw)))
    return (jpea.PEAConfig(**cfg_kw), jax.tree_util.tree_map(jnp.asarray, params),
            jnp.asarray(batch), jnp.asarray(mask), edges)


def _jax_single(name):
    """The JAX single-device (loss, grads) on the fused union graphs."""
    cfg, params, batch, mask, edges = _jax_case(name)
    fused = jgraph.build_fused_metapath_graphs(edges, cfg.num_nodes, cfg.conv)
    return jax.jit(jax.value_and_grad(
        lambda p: jpea.pea_loss(p, fused, cfg, batch, row_mask=mask, training=True)))(params)


def _jax_a2a_adam(name):
    """The JAX make_a2a_train_step at dp 2, one Adam step: (loss, params)."""
    cfg, params, batch, mask, edges = _jax_case(name)
    optimizer = jmake_optimizer("adam", 1e-3, 1e-3)
    mesh = JMesh(np.array(jax.devices()[:2]), ("dp",))
    place, _ = ja2a.make_a2a_train_step(cfg, edges, optimizer, mesh)
    step, p, o = place(params, optimizer.init(params))
    p1, _, loss = step(p, o, batch, mask, jax.random.PRNGKey(0))
    return loss, p1


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The world's results and the JAX references, computed while it runs."""
    tmp = tmp_path_factory.mktemp("a2a")
    tasks = {name: dict(task="a2a_step", conv=conv, entity_aware=ent, heads=heads,
                        adam=name == "gat_entity")
             for name, (conv, ent, heads) in CASES.items()}
    tasks["a2a_dropout"] = {}
    world = World(tmp, tasks)
    refs = {name: _jax_single(name) for name in CASES}
    refs["adam"] = _jax_a2a_adam("gat_entity")
    return world.result(timeout=180), jax.tree_util.tree_map(np.asarray, refs)


def _whole(res, prefix):
    """{leaf: array} of both ranks' results, x's rows stacked in rank order."""
    out = {k: v for k, v in res[0].items() if k.startswith(prefix)}
    out[f"{prefix}/x"] = np.concatenate([r[f"{prefix}/x"] for r in res])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_a2a_step_matches_jax_single_device(setup, name):
    """Both ranks' total loss within rtol 2e-5 of the JAX single-device
    loss; every gradient leaf (x's two halves together) within rtol 5e-4 /
    atol 5e-5; the replicated leaves' gradients bitwise equal on the
    ranks; the step's collectives all-to-all, psum-scatter (backward:
    all-gather) and the one all-reduce."""
    res, refs = setup
    loss, grads = refs[name]
    out = res[name]
    for r in range(2):
        np.testing.assert_allclose(float(out[r]["loss"]), float(loss), rtol=2e-5)
        assert list(out[r]["ops"]) == ["all_gather", "all_reduce", "all_to_all",
                                       "psum_scatter"]
        for k, v in out[r].items():
            if k.startswith("grad/") and k != "grad/x":
                np.testing.assert_array_equal(v, out[0][k], err_msg=k)
    want = flat("grad", grads)
    got = _whole(out, "grad")
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=5e-4, atol=5e-5, err_msg=k)


def test_a2a_adam_step_matches_jax_sharded(setup):
    """GAT entity-aware: the parameters after one Adam step (lr 1e-3, weight
    decay 1e-3) on two ranks against the JAX make_a2a_train_step at dp 2,
    x's halves together, at rtol 5e-4 / atol 5e-5; the loss at rtol 2e-5."""
    res, refs = setup
    loss, p1 = refs["adam"]
    out = res["gat_entity"]
    np.testing.assert_allclose(float(out[0]["loss"]), float(loss), rtol=2e-5)
    want = flat("param", p1)
    got = _whole(out, "param")
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=5e-4, atol=5e-5, err_msg=k)


def test_a2a_mixed_depths_is_a_config_error():
    """A 1-step metapath beside 2-step ones: the JAX ValueError, naming the
    fix."""
    from graph_recsys_benchmark_tpu_torch.parallel.a2a import make_a2a_parts

    cfg_kw, edges, _, _ = tiny_a2a_setup("gcn")
    cfg = dataclasses.replace(PEAConfig(**cfg_kw), meta_path_steps=(1, 2, 2))
    with pytest.raises(ValueError, match="uniform meta_path_steps"):
        make_a2a_parts(cfg, [edges[0][:1]] + edges[1:], None)


def test_a2a_attention_dropout_trains(setup):
    """GAT at dropout 0.3: a finite loss with the masks, other than the
    loss without; each rank's masks of one step its own (a2a.rank_generator
    from the same epoch generator) and their keep rate within 4 sigma of
    0.7."""
    res, _ = setup
    out = res["a2a_dropout"]
    keeps = [o["keep"] for o in out]
    for o, keep in zip(out, keeps):
        off, on = o["losses"]
        assert np.isfinite(on) and on != off
        n = keep.size
        assert abs(keep.mean() - 0.7) <= 4 * np.sqrt(0.7 * 0.3 / n), keep.mean()
    assert out[0]["losses"][1] == out[1]["losses"][1]  # the total, summed over the ranks
    assert not np.array_equal(keeps[0], keeps[1])
