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

GAT attention dropout (rate P) in both worlds: the JAX package's union
masks, ``bernoulli(fold_in(key, k), 1 - P, [E, 1])`` a step, computed here
and handed to every rank (the ranks import no JAX), against the JAX
single-device ``pea_loss(fused, dropout_key=key)`` at the same bars; and
the masks the step draws itself from one seeded generator: the same on
every rank of the four, each step's keep rate within 4 sigma of 1 - P.

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

P = 0.3
KEY = 17
# name: (ranks, conv, dropout masks: None, the JAX package's, or the step's own)
CASES = {"two_gat": (2, "gat", None), "two_gcn": (2, "gcn", None),
         "four_gat": (4, "gat", None), "two_gat_dropout": (2, "gat", "jax"),
         "four_gat_dropout": (4, "gat", "jax"), "four_gat_own_masks": (4, "gat", "own")}


def _setup(conv, dropout=0.0):
    cfg_kw, edges, batch, mask = tiny_a2a_setup(conv, True)
    cfg = jpea.PEAConfig(**cfg_kw, dropout=dropout)
    return cfg_kw, cfg, jgraph.build_fused_metapath_graphs(edges, cfg.num_nodes, conv), \
        batch, mask


def _jax_masks():
    """The JAX package's union masks of the dropout cases, one a step."""
    _, _, fused, _, _ = _setup("gat")
    key = jax.random.PRNGKey(KEY)
    return {f"keep{k}": np.asarray(jax.random.bernoulli(jax.random.fold_in(key, k), 1.0 - P,
                                                        (g.dst.shape[0], 1)))
            for k, g in enumerate(fused)}


def _jax_single(conv, dropout=False):
    """The JAX single-device (loss, grads) of the entity-aware case on the
    fused union graphs (with `dropout`: at rate P under PRNGKey(KEY))."""
    cfg_kw, cfg, fused, batch, mask = _setup(conv, P if dropout else 0.0)
    params = to_numpy(pea_init(torch.Generator().manual_seed(0), PEAConfig(**cfg_kw)))
    key = jax.random.PRNGKey(KEY) if dropout else None
    return jax.jit(jax.value_and_grad(
        lambda p: jpea.pea_loss(p, fused, cfg, jnp.asarray(batch), row_mask=jnp.asarray(mask),
                                training=True, dropout_key=key)))(
        jax.tree_util.tree_map(jnp.asarray, params))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both worlds' results (started together) and the JAX references."""
    masks = _jax_masks()
    worlds = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"spmd{n}")
        tasks = {}
        for name, (nprocs, conv, drop) in CASES.items():
            if nprocs != n:
                continue
            tasks[name] = dict(task="dp_step", conv=conv, entity_aware=True,
                               dropout=P if drop else 0.0)
            if drop == "jax":
                np.savez(tmp / f"{name}.in.npz", **masks)
        worlds[n] = World(tmp, tasks, nprocs=n)
    refs = {(conv, drop): _jax_single(conv, drop)
            for conv, drop in (("gat", False), ("gcn", False), ("gat", True))}
    res = {}
    for w in worlds.values():
        res.update(w.result(timeout=180))
    return res, jax.tree_util.tree_map(np.asarray, refs), masks


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[2] != "own"])
def test_dp_step_matches_jax_single_device(setup, name):
    res, refs, masks = setup
    nprocs, conv, drop = CASES[name]
    loss, grads = refs[(conv, drop is not None)]
    out = res[name]
    coords = [tuple(o["coords"]) for o in out]
    assert coords == [(r // 2, r % 2) for r in range(nprocs)]
    by_m = {}
    for o in out:
        if drop:  # every rank ran under the JAX masks
            for k, keep in masks.items():
                np.testing.assert_array_equal(o[f"keep/{k[4:]}"], keep)
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
    if drop:  # the masks moved the loss ten times past its bar
        assert abs(float(loss) - float(refs[(conv, False)][0])) > 10 * 2e-5 * abs(float(loss))


def test_dp_step_draws_the_same_masks_on_every_rank(setup):
    res, refs, masks = setup
    out = res["four_gat_own_masks"]
    for k in ("keep/0", "keep/1"):
        keep = out[0][k]
        assert keep.dtype == bool and keep.shape == masks[f"keep{k[5:]}"].shape
        for o in out[1:]:
            np.testing.assert_array_equal(o[k], keep)
        rate = float(keep.mean())
        assert abs(rate - (1 - P)) <= 4 * np.sqrt(P * (1 - P) / keep.size), (k, rate)
    assert not np.array_equal(out[0]["keep/0"][:1000], out[0]["keep/1"][:1000])
    losses = {float(o["loss"]) for o in out}
    assert len(losses) == 1 and np.isfinite(losses.pop())
    # dropout moved the loss from the four-rank world's no-dropout one, ten
    # times past the loss bar
    plain = float(res["four_gat"][0]["loss"])
    assert abs(float(out[0]["loss"]) - plain) > 10 * 2e-5 * abs(plain)
