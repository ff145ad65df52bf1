"""The port's multi-process runtime and sharded trainers
(graph_recsys_benchmark_tpu_torch/parallel/multihost.py, engine.py): the
runtime's resolution order and no-op, the backend rule, the per-rank feed
against the JAX package's HostBatchFeed, rank 0 as the only checkpoint
writer and a resume by both ranks, and ShardedPEATrainer (PEAGAT) and
the sharded KGAT trainer, one epoch each, on two ranks against the port's
single-process trainers at the JAX tests/test_parallel_engine.py bars.

One two-rank gloo world on the CPU runs every rank-side case
(tests/torch_parallel_world.py); the single-process trainers run here
while it does."""

import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu.parallel.multihost import HostBatchFeed as JHostBatchFeed
from graph_recsys_benchmark_tpu.parallel.multihost import make_pod_mesh as jmake_pod_mesh
from graph_recsys_benchmark_tpu_torch.parallel import multihost as mh
from graph_recsys_benchmark_tpu_torch.parallel.mesh import Mesh
from torch_parallel_world import World, train_and_eval, trainers_setup


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("multihost"), {"trainers": {}, "runtime": {}})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = train_and_eval(*trainers_setup())
    finally:
        torch.set_num_threads(n)
    return w.result(), ref


def test_resolution_order():
    """Explicit arguments, then GRB_*, then torchrun's MASTER_ADDR /
    WORLD_SIZE / RANK, else None; a bare host:port means tcp."""
    env = {"GRB_COORDINATOR": "h:1", "GRB_NUM_PROCESSES": "4", "GRB_PROCESS_ID": "3",
           "MASTER_ADDR": "m", "MASTER_PORT": "9", "WORLD_SIZE": "8", "RANK": "5"}
    assert mh.resolve_runtime("a:2", 2, 1, environ=env) == ("tcp://a:2", 2, 1)
    assert mh.resolve_runtime("file:///s", None, None, environ=env) == ("file:///s", 4, 3)
    assert mh.resolve_runtime(environ=env) == ("tcp://h:1", 4, 3)
    torchrun = {k: v for k, v in env.items() if not k.startswith("GRB")}
    assert mh.resolve_runtime(environ=torchrun) == ("tcp://m:9", 8, 5)
    assert mh.resolve_runtime(None, 2, 0, environ={}) is None
    with pytest.raises(ValueError, match="rank"):
        mh.resolve_runtime("a:2", 2, None, environ={})


def test_single_process_is_a_no_op(monkeypatch):
    for k in ("GRB_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert mh.initialize_runtime(device="cpu") is False
    mesh = mh.make_pod_mesh(mp=1, device="cpu")
    assert (mesh.dp, mesh.rank, mesh.size) == (1, 0, 1)
    with pytest.raises(ValueError, match="world of 1 rank"):
        mh.make_pod_mesh(mp=2, device="cpu")


def test_backend_rule():
    """NCCL only when every local rank has a card of its own; a shared
    card or the CPU takes gloo, and NCCL asked for there is refused with
    the layout named."""
    assert mh.choose_backend("cuda", 1, 1)[0] == "nccl"
    assert mh.choose_backend("cuda", 4, 4)[0] == "nccl"
    assert mh.choose_backend("cuda", 2, 1)[0] == "gloo"
    assert mh.choose_backend("cpu", 2, 0)[0] == "gloo"
    with pytest.raises(ValueError, match="2 local ranks on 1 card"):
        mh.check_backend("nccl", "cuda", 2, 1)
    with pytest.raises(ValueError, match="the CPU"):
        mh.check_backend("nccl", "cpu", 2, 0)
    mh.check_backend("gloo", "cuda", 2, 1)


def test_feed_matches_jax():
    """Each rank's rows and mask of every batch are its half of the JAX
    feed's global batch for the same seed."""
    jrows, jmasks = zip(*JHostBatchFeed(100, 32, jmake_pod_mesh(mp=1)).batches(7))
    for r in range(2):
        feed = mh.HostBatchFeed(100, 32, Mesh(dp=2, rank=r))
        rows, masks = zip(*feed.batches(7))
        assert len(rows) == len(jrows) == 4
        for a, m, ja, jm in zip(rows, masks, jrows, jmasks):
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja)[16 * r: 16 * (r + 1)])
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm)[16 * r: 16 * (r + 1)])


def test_runtime_in_a_world(world):
    """In a two-rank CPU world: initialize_runtime again is a no-op, the
    backend gloo, only rank 0's checkpoint exists, the feed's halves cover
    the permutation, and a Solver stopped after epoch 1 resumes on both
    ranks from rank 0's `latest` (each rank's parameters at the resumed
    epoch's start those the stopped run had there, every digest equal)."""
    res = world[0]["runtime"]
    want = np.random.default_rng(7).permutation(100)
    for r, out in enumerate(res):
        assert out["again"] and out["world"] == 2 and str(out["backend"]) == "gloo"
        assert list(out["exists"]) == [True, False]
        assert set(out["files"]) == {"global_logger.npz", "logger_file.txt", "run_1"}
        stopped, resumed = out["stopped"], out["resumed"]
        assert stopped.shape == (2, 2) and resumed.shape == (1, 2)
        assert len(set(stopped[1])) == 1 and set(resumed[0]) == set(stopped[1])
        assert len(set(out["final"])) == 1
    both = [np.concatenate([res[0][k].reshape(4, 16), res[1][k].reshape(4, 16)], axis=1)
            for k in ("rows", "masks")]
    np.testing.assert_array_equal(both[0].reshape(-1)[both[1].reshape(-1) > 0], want)


@pytest.mark.parametrize("name", ["pea", "kg"])
def test_sharded_trainers_match_single_process(world, name):
    """ShardedPEATrainer and the sharded KGAT trainer on two ranks, one
    epoch each, against the port's single-process trainers from the same
    seeds: the epoch's losses rtol 2e-4, HR / NDCG / AUC atol 5e-3, the
    eval loss rtol 2e-3 (the JAX tests/test_parallel_engine.py bars), the
    ranks' parameters bitwise equal."""
    res, ref = world
    for out in res["trainers"]:
        assert out[f"{name}/digests_equal"]
        np.testing.assert_allclose(out[f"{name}/train_loss"], ref[f"{name}/train_loss"],
                                   rtol=2e-4)
        if name == "kg":
            np.testing.assert_allclose(out["kg/kg_train_loss"], ref["kg/kg_train_loss"],
                                       rtol=2e-4)
        for k in ("HR", "NDCG", "AUC"):
            np.testing.assert_allclose(out[f"{name}/{k}"], ref[f"{name}/{k}"], atol=5e-3)
        np.testing.assert_allclose(out[f"{name}/eval_loss"], ref[f"{name}/eval_loss"],
                                   rtol=2e-3)
    assert res["trainers"][0]["pea/edge_graphs"] == 2  # the union route, a shard a step


@pytest.mark.parametrize("model", ["NGCF", "CFKG", "HeRec"])
def test_cli_parallel_refuses_other_models(model, tmp_path):
    """--parallel edge exits for a model the JAX CLI runs single-device."""
    from graph_recsys_benchmark_tpu_torch import cli

    args = cli.build_parser().parse_args(["--model", model, "--parallel", "edge", "--device",
                                          "cpu", "--cache_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="runs single-device"):
        cli.build_trainer(args, None, [])
