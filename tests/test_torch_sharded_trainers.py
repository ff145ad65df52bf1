"""ShardedPEATrainer in the row-sharded modes (parallel/engine.py: 'a2a'
and 'dp' at mp 2) on two ranks against the port's single-process
PEATrainer and the JAX package.

PEAGAT entity-aware on the trainers' world (the JAX
tests/test_parallel_engine.py setup, 9 channels, widths 16 / 16 / 8): two
epochs from the same seeds, the losses at rtol 2e-4, the eval's HR / NDCG
/ AUC at atol 5e-3 and its loss at rtol 2e-3 (the JAX
test_epoch_and_eval_parity bars); the full-catalog ranks of the a2a
sweep against the JAX single-device ``evaluate_full`` on the same trained
parameters; a checkpoint round trip with the sharded table (both ranks
save, rank 0 writes the whole table and its moments, a fresh init resumes
each rank's rows).

One two-rank gloo world on the CPU runs both modes
(tests/torch_parallel_world.py); the single-process trainer runs here
while it does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.models import pea as jpea
from graph_recsys_benchmark_tpu.train import pea_trainer as jtrainer
from torch_parallel_world import (
    EPOCH_SEED,
    EVAL_SEED,
    TRAIN_CORE,
    TRAIN_RAW,
    TRAIN_SEED,
    TRAIN_TCFG,
    WIDTHS,
    World,
    trainers_setup,
)

MODES = ("a2a", "dp")


def _single_process():
    """The port's PEATrainer: two epochs on one generator, the eval."""
    base, _ = trainers_setup(device="cpu")
    params = base.init(TRAIN_SEED)
    opt = base.optimizer(params)
    gen = torch.Generator().manual_seed(EPOCH_SEED)
    out = {"losses": np.asarray([float(base.run_epoch(params, opt, gen)) for _ in range(2)])}
    ev = base.evaluate(params, torch.Generator().manual_seed(EVAL_SEED))
    out.update({k: np.asarray(ev[k]) for k in ("HR", "NDCG", "AUC", "eval_loss")})
    return out


def _unflat(res):
    """The 'param/...' entries of a rank's result as the JAX pytree."""
    p = {k[len("param/"):]: v for k, v in res.items() if k.startswith("param/")}
    n_chan = 1 + max(int(k.split("/")[1]) for k in p if k.startswith("channels/"))
    channels = tuple(
        tuple({name: jnp.asarray(p[f"channels/{c}/{k}/{name}"])
               for name in ("w", "att", "b")} for k in range(2))
        for c in range(n_chan))
    return {"x": jnp.asarray(p["x"]), "channels": channels, "att": jnp.asarray(p["att"]),
            "fc1": {n: jnp.asarray(p[f"fc1/{n}"]) for n in ("w", "b")},
            "fc2": {n: jnp.asarray(p[f"fc2/{n}"]) for n in ("w", "b")}}


def _jax_full_ranks(res):
    """The JAX single-device PEATrainer.evaluate_full ranks on the a2a run's
    trained parameters."""
    hin = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(**TRAIN_RAW), **TRAIN_CORE)
    cfg = jpea.PEAConfig(conv="gat", num_nodes=hin.num_nodes, meta_path_steps=(2,) * 9,
                         entity_aware=True, **WIDTHS)
    tr = jtrainer.PEATrainer(hin, cfg, jtrainer.TrainConfig(**TRAIN_TCFG),
                             metapath_edges=jml.mlsmall_metapath_edges(hin))
    return np.asarray(tr.evaluate_full(_unflat(res))["ranks"])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    world = World(tmp_path_factory.mktemp("row_sharded_trainers"),
                  {mode: dict(task="row_sharded_trainer", mode=mode) for mode in MODES})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = _single_process()
    finally:
        torch.set_num_threads(n)
    res = world.result(timeout=180)
    return res, ref, _jax_full_ranks(res["a2a"][0])


@pytest.mark.parametrize("mode", MODES)
def test_row_sharded_trainer_matches_single_process(setup, mode):
    res, ref, _ = setup
    for out in res[mode]:
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=2e-4)
        for k in ("HR", "NDCG", "AUC"):
            np.testing.assert_allclose(out[k], ref[k], atol=5e-3, err_msg=k)
        np.testing.assert_allclose(out["eval_loss"], ref["eval_loss"], rtol=2e-3)
    for k, v in res[mode][0].items():  # every rank's eval, ranks and trained model alike
        if k != "param/x":
            np.testing.assert_array_equal(v, res[mode][1][k], err_msg=k)


def test_a2a_full_catalog_ranks_match_jax(setup):
    """The a2a sweep's ranks (each rank's catalog rows, the partial ranks
    summed) equal the JAX single-device evaluate_full's on the same
    parameters; the dp mode's (the single-process sweep over the gathered
    table) too."""
    res, _, jranks = setup
    for mode in MODES:
        for out in res[mode]:
            np.testing.assert_array_equal(out["full_ranks"], jranks, err_msg=mode)


@pytest.mark.parametrize("mode", MODES)
def test_checkpoint_round_trip_with_a_sharded_table(setup, mode):
    """Each rank holds half the table (a2a over the ranks, dp over mp); the
    file holds the whole table and its Adam moments; a fresh init resumed
    from it holds this rank's rows and moments bitwise."""
    res, _, _ = setup
    for out in res[mode]:
        assert out["x_rows"] == 128 and out["file_x_rows"] == out["file_moment_rows"] == 256
        assert out["same_params"] and out["same_moments"]
