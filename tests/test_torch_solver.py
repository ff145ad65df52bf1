"""The port's RunLogger, Solver and checkpoints against the JAX package's.

* RunLogger: the same calls to both loggers write byte-equal
  ``logger_file.txt`` files and equal ``global_logger.npz`` arrays.
* Solver: one deterministic stub trainer per package (no model, no jit):
  params hold the run seed and an epoch counter, and every metric is a
  numpy function of those and of ``metapath_idx``.  Both Solvers run 2
  runs x 3 epochs with init_eval, save_epochs (1,), save_every_epoch 1,
  the metapath test (3 paths) and full ranking; their ``logger_file.txt``
  files must be equal line for line once the seconds of the "Duration"
  and "total" lines are stripped, their ``global_logger.npz`` arrays equal
  and their checkpoint file names the same.  Then the stubs raise in run
  2's third epoch (after epoch 2's ``latest`` checkpoint) and a second
  Solver resumes each: run 1 from the global logger, run 2 from its
  ``latest`` at epoch 2.  The resumed logs equal each other and the
  uninterrupted log.
* A checkpoint of the port's real PEATrainer on the CPU (tiny HIN): the
  params and Adam's step, exp_avg and exp_avg_sq come back bitwise, the
  next epoch's loss with the same generator seed is bitwise the
  uninterrupted one's, and the file loads under ``weights_only=True``.
"""

import copy
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu.train.solver import Solver as JSolver
from graph_recsys_benchmark_tpu.utils.logging import RunLogger as JRunLogger
from graph_recsys_benchmark_tpu_torch.data import build_mlsmall_hin, synthetic_mlsmall_raw
from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig
from graph_recsys_benchmark_tpu_torch.train.solver import Solver as TSolver
from graph_recsys_benchmark_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from graph_recsys_benchmark_tpu_torch.utils.logging import RunLogger as TRunLogger

NUM_PATHS = 3
SOLVER_ARGS = dict(runs=2, epochs=3, init_eval=True, save_epochs=(1,), save_every_epoch=1,
                   metapath_test=True, num_metapaths=NUM_PATHS, full_ranking=True)
CRASH = (2021, 2)  # (run seed, epochs done): run 2 raises in its third epoch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops beside the other pytest workers: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metrics(seed, epoch, mp=None):
    """The stubs' metrics: numpy float32, a function of the run seed, the
    epochs trained and the ablated path."""
    base = (seed % 13) / 13.0 + 0.02 * epoch - (0.0 if mp is None else 0.003 * (mp + 1))
    hr = np.clip(0.05 + 0.3 * base + 0.01 * np.arange(16), 0.0, 1.0).astype(np.float32)
    return {"HR": hr, "NDCG": (0.5 * hr).astype(np.float32),
            "AUC": np.float32(0.5 + 0.25 * base), "eval_loss": np.float32(3.0 - base)}


def _loss(seed, epoch):
    return np.float32(10.0 / (epoch + 1) + (seed % 5) * 0.1)


class JaxStub:
    """The JAX Solver's trainer API on numpy pytrees."""

    def __init__(self, crash=None):
        self.crash = crash

    def init(self, seed):
        return {"seed": np.array(seed), "epoch": np.array(0)}, {"count": np.array(0)}

    def run_epoch(self, params, opt_state, key):
        seed, epoch = int(params["seed"]), int(params["epoch"])
        if (seed, epoch) == self.crash:
            raise RuntimeError("stub crash")
        return ({"seed": params["seed"], "epoch": np.array(epoch + 1)},
                {"count": np.array(int(opt_state["count"]) + 1)}, _loss(seed, epoch + 1))

    def evaluate(self, params, key, metapath_idx=None):
        return {k: jnp.asarray(v) for k, v in
                _metrics(int(params["seed"]), int(params["epoch"]), metapath_idx).items()}

    def evaluate_full(self, params):
        m = _metrics(int(params["seed"]), int(params["epoch"]) + 1)
        return {"HR": m["HR"], "NDCG": m["NDCG"]}


class _StubParams(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(2))
        self.register_buffer("seed", torch.tensor(seed))
        self.register_buffer("epoch", torch.tensor(0))


class TorchStub:
    """The port Solver's trainer API on an nn.Module."""

    device = torch.device("cpu")

    def __init__(self, crash=None):
        self.crash = crash

    def init(self, seed):
        return _StubParams(seed)

    def optimizer(self, params):
        return torch.optim.SGD(params.parameters(), lr=0.0)

    def run_epoch(self, params, optimizer, generator):
        seed, epoch = int(params.seed), int(params.epoch)
        if (seed, epoch) == self.crash:
            raise RuntimeError("stub crash")
        params.epoch += 1
        return torch.tensor(_loss(seed, epoch + 1))

    def evaluate(self, params, generator, metapath_idx=None):
        return {k: torch.tensor(v) for k, v in
                _metrics(int(params.seed), int(params.epoch), metapath_idx).items()}

    def evaluate_full(self, params):
        m = _metrics(int(params.seed), int(params.epoch) + 1)
        return {"HR": torch.from_numpy(m["HR"]), "NDCG": torch.from_numpy(m["NDCG"])}


def _log(folder):
    """logger_file.txt's lines, the seconds of its timing lines stripped."""
    with open(os.path.join(folder, "logger_file.txt")) as f:
        lines = f.read().splitlines()
    return [re.sub(r"Duration: [0-9.]+s", "Duration: s", re.sub(r"\([0-9.]+s total\)",
                                                                 "(s total)", ln))
            for ln in lines]


def _npz(folder):
    with np.load(os.path.join(folder, "global_logger.npz")) as data:
        return {k: data[k] for k in data.files}


def _ckpts(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, files in os.walk(folder) for f in files if f.endswith(".ckpt"))


def test_run_logger_matches_jax(tmp_path):
    loggers = [JRunLogger(str(tmp_path / "jax")), TRunLogger(str(tmp_path / "torch"))]
    rng = np.random.default_rng(0)
    for run in (1, 2):
        hr = rng.random((3, 16)).astype(np.float32)
        ndcg = rng.random((3, 16)).astype(np.float32)
        auc, tl, el = rng.random(3), rng.random(3) * 100, rng.random(3) * 10
        for lg in loggers:
            lg.write(f"Initial performance run {run}")
            for e in range(3):
                lg.log_epoch(run, e + 1, hr[e], ndcg[e], auc[e], tl[e], el[e])
            lg.finish_run(hr, ndcg, auc.reshape(-1, 1), tl.reshape(-1, 1), el.reshape(-1, 1))
    with open(tmp_path / "jax" / "logger_file.txt", "rb") as f:
        with open(tmp_path / "torch" / "logger_file.txt", "rb") as g:
            assert f.read() == g.read()
    jz, tz = _npz(tmp_path / "jax"), _npz(tmp_path / "torch")
    assert sorted(jz) == sorted(tz)
    for k in jz:
        assert jz[k].dtype == tz[k].dtype
        np.testing.assert_array_equal(jz[k], tz[k])
    jo, to = loggers[0].overall(), loggers[1].overall()
    for k in jo:
        np.testing.assert_array_equal(jo[k], to[k])
    assert TRunLogger(str(tmp_path / "torch")).last_run == 2  # resumes from the npz


def _run_both(root, crash=None):
    """Both Solvers on their stubs in root/{jax,torch}: (overall, log) each;
    with a crash, the first Solver raises where the stub raises (the
    port's run 2 `latest` then holds epoch 2) and a second one resumes."""
    out = {}
    for name, solver_cls, stub in (("jax", JSolver, JaxStub), ("torch", TSolver, TorchStub)):
        folder = str(root / name)
        solver = solver_cls(stub(crash), folder, **SOLVER_ARGS)
        if crash is not None:
            with pytest.raises(RuntimeError, match="stub crash"):
                solver.run()
            if name == "torch":
                latest = os.path.join(folder, "run_2", "latest.ckpt")
                assert torch.load(latest, weights_only=True)["epoch"] == crash[1]
                assert TRunLogger(folder).last_run == 1
            solver = solver_cls(stub(), folder, **SOLVER_ARGS)
        out[name] = (solver.run(), _log(folder))
    return out


def test_solver_matches_jax_on_stubs(tmp_path):
    out = _run_both(tmp_path / "whole")
    (jo, jlog), (to, tlog) = out["jax"], out["torch"]
    assert tlog == jlog
    assert len(tlog) == 2 * (1 + 3 + NUM_PATHS + 1 + 1) + NUM_PATHS + 1
    assert tlog[-1].startswith("Overall HR@10")
    for k in jo:
        np.testing.assert_array_equal(np.asarray(jo[k]), np.asarray(to[k]))
    jz, tz = _npz(tmp_path / "whole" / "jax"), _npz(tmp_path / "whole" / "torch")
    for k in jz:
        np.testing.assert_array_equal(jz[k], tz[k])
    names = _ckpts(tmp_path / "whole" / "torch")
    assert names == _ckpts(tmp_path / "whole" / "jax")
    assert names == [f"run_{r}/{f}" for r in (1, 2) for f in ("epoch_1.ckpt", "latest.ckpt")]

    # a crash in run 2's third epoch, then a second Solver resumes each
    resumed = _run_both(tmp_path / "crash", crash=CRASH)
    assert resumed["torch"][1] == resumed["jax"][1] == tlog
    rz = _npz(tmp_path / "crash" / "torch")
    for k in tz:
        np.testing.assert_array_equal(rz[k], tz[k])


@pytest.fixture(scope="module")
def tiny_trainer():
    hin = build_mlsmall_hin(*synthetic_mlsmall_raw(seed=3, num_users=80, num_items=100),
                            num_core=3, num_feat_core=2)
    cfg = PEAConfig(conv="gat", num_nodes=hin.num_nodes, meta_path_steps=(2,) * 9,
                    emb_dim=8, hidden_size=8, repr_dim=4, entity_aware=True)
    return PEATrainer(hin, cfg, TrainConfig(batch_size=512), device="cpu")


def test_checkpoint_round_trip_on_pea_trainer(tiny_trainer, tmp_path):
    trainer = tiny_trainer
    params = trainer.init(0)
    opt = trainer.optimizer(params)
    trainer.run_epoch(params, opt, torch.Generator().manual_seed(1))  # Adam has state
    hist = {"HR": np.random.default_rng(0).random((1, 16)), "AUC": np.array([0.1 + 1e-12]),
            "train_loss": np.array([123.456789012345])}
    path = str(tmp_path / "run_1" / "latest.ckpt")
    save_checkpoint(path, params, opt, 1, hist)
    assert not os.path.exists(path + ".tmp")
    saved_params = copy.deepcopy(params.state_dict())
    saved_opt = copy.deepcopy(opt.state_dict())
    loss = trainer.run_epoch(params, opt, torch.Generator().manual_seed(2))

    payload = torch.load(path, weights_only=True)  # no pickled numpy inside
    assert payload["epoch"] == 1

    params2 = trainer.init(5)
    opt2 = trainer.optimizer(params2)
    p, o, epoch, rec = load_checkpoint(path, params2, opt2)
    assert p is params2 and o is opt2 and epoch == 1
    for k, v in saved_params.items():
        assert torch.equal(params2.state_dict()[k], v), k
    state = opt2.state_dict()["state"]
    assert state.keys() == saved_opt["state"].keys()
    for i, st in saved_opt["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state[i][k], st[k]), (i, k)
            assert state[i][k].device == st[k].device, (i, k)
    for k, v in hist.items():
        assert rec[k].dtype == np.float64
        np.testing.assert_array_equal(rec[k], v)
    loss2 = trainer.run_epoch(params2, opt2, torch.Generator().manual_seed(2))
    assert torch.equal(loss2, loss)

    missing = trainer.init(7)
    opt3 = trainer.optimizer(missing)
    p, o, epoch, rec = load_checkpoint(str(tmp_path / "none.ckpt"), missing, opt3)
    assert p is missing and o is opt3 and epoch == 0 and rec is None
