"""The port's dp mode (parallel/spmd.py: the batch split over every rank,
the table row-sharded over mp, all-gathered for the forward and
reduce-scattered in the backward, x's gradient then summed over dp and the
replicated leaves over the world) against the JAX single-device step.

On the JAX tests/test_sharded_embedding.py tiny setup (200 nodes, 3
channels, emb 16), the trainer's union graphs: PEAGAT entity-aware and
PEAGCN on two ranks (dp 1 x mp 2), and PEAGAT entity-aware in one
four-rank world (dp 2 x mp 2, rank = d * mp + m, the JAX layout), where a
wrong group would show.  The total loss at rtol 2e-5 and every gradient,
x's re-assembled from the mp shards, at rtol 5e-4 / atol 5e-5 (the JAX
test_a2a_step_matches_replicated bars); the ranks holding the same shard
hold the same x gradient bitwise.

Each world runs its rank-side cases once (tests/torch_parallel_world.py);
the parameters are the port's ``pea_init(0)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.models import pea as jpea
from graph_recsys_benchmark_tpu_torch.models.params import to_numpy
from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig, pea_init
from torch_parallel_world import World, flat, tiny_a2a_setup

CASES = {"two_gat": (2, "gat"), "two_gcn": (2, "gcn"), "four_gat": (4, "gat")}


def _jax_single(conv):
    """The JAX single-device (loss, grads) of the entity-aware case on the
    fused union graphs."""
    cfg_kw, edges, batch, mask = tiny_a2a_setup(conv, True)
    params = to_numpy(pea_init(torch.Generator().manual_seed(0), PEAConfig(**cfg_kw)))
    cfg = jpea.PEAConfig(**cfg_kw)
    fused = jgraph.build_fused_metapath_graphs(edges, cfg.num_nodes, conv)
    return jax.jit(jax.value_and_grad(
        lambda p: jpea.pea_loss(p, fused, cfg, jnp.asarray(batch), row_mask=jnp.asarray(mask),
                                training=True)))(jax.tree_util.tree_map(jnp.asarray, params))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both worlds' results (started together) and the JAX references."""
    worlds = {}
    for n in (2, 4):
        tasks = {name: dict(task="dp_step", conv=conv, entity_aware=True)
                 for name, (nprocs, conv) in CASES.items() if nprocs == n}
        worlds[n] = World(tmp_path_factory.mktemp(f"spmd{n}"), tasks, nprocs=n)
    refs = {conv: _jax_single(conv) for conv in ("gat", "gcn")}
    res = {}
    for w in worlds.values():
        res.update(w.result(timeout=180))
    return res, jax.tree_util.tree_map(np.asarray, refs)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_jax_single_device(setup, name):
    res, refs = setup
    nprocs, conv = CASES[name]
    loss, grads = refs[conv]
    out = res[name]
    coords = [tuple(o["coords"]) for o in out]
    assert coords == [(r // 2, r % 2) for r in range(nprocs)]
    by_m = {}
    for o in out:
        np.testing.assert_allclose(float(o["loss"]), float(loss), rtol=2e-5)
        d, m = o["coords"]
        if m in by_m:  # the same shard on another dp line: the same gradient
            np.testing.assert_array_equal(o["grad/x"], by_m[m])
        by_m[m] = o["grad/x"]
        for k, v in o.items():
            if k.startswith("grad/") and k != "grad/x":
                np.testing.assert_array_equal(v, out[0][k], err_msg=k)
    want = flat("grad", grads)
    got = {k: v for k, v in out[0].items() if k.startswith("grad/")}
    got["grad/x"] = np.concatenate([by_m[0], by_m[1]])
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=5e-4, atol=5e-5, err_msg=k)
