"""Port parity for the walk trainers (train/walk_trainers.py), the engine's
'mse' mode and the CLI's walk models against the JAX package on the CPU.

* The 'mse' batch (pair, rating) of the same rows bitwise the JAX engine's,
  with its row count and eval-loss form.
* Stage 2 of MetaPath2Vec and HeRec given the same frozen embeddings and
  the JAX stage-2 parameters (models/params): one step's loss, then the
  scores after one Adam step against the optax chain, at 1e-5.
* A small pretraining pass (trainer.init) whose loss is finite, then three
  stage-2 epochs whose loss falls, as JAX tests/test_walk_models.py holds.
* The stage-1 cache: written once, atomically, and read back by a second
  init without pretraining; a JAX ``.npz`` planted under the JAX CLI's own
  name is never read.
* cli.main(--model MetaPath2Vec | HeRec) at tiny walk flags on
  ``synthetic-ml`` and ``synthetic-yelp`` (MetaPath2Vec's walks from
  item_reviewcount there), the stage-1 files under <out_dir>/<hin>/<model>;
  without --device cpu and without a card the trainer raises.
Torch runs on one thread; JAX eagerly at walk length 6 (no JAX trainer
epoch, no JAX pretraining).
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.models import herec as jherec
from graph_recsys_benchmark_tpu.models import metapath2vec as jmp2v
from graph_recsys_benchmark_tpu.models import walk as jwalk
from graph_recsys_benchmark_tpu.train import walk_trainers as jwt
from graph_recsys_benchmark_tpu.train.optim import make_optimizer as jmake_optimizer
from graph_recsys_benchmark_tpu.train.pea_trainer import TrainConfig as JTrainConfig
from graph_recsys_benchmark_tpu_torch import cli as tcli
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.models import metapath2vec as tmp2v
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.train import walk_trainers as twt
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import TrainConfig

EMB = 16
TOL = 1e-5
B, PAD = 96, 17  # batch rows, of which the last PAD are padding
WALK = dict(embedding_dim=EMB, walk_length=6, context_size=3, walks_per_node=4,
            num_negative_samples=2)
TINY_WALK = ["--walk_length", "6", "--walks_per_node", "3", "--context_size", "3",
             "--rw_negative_samples", "2"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    kw = dict(num_core=3, num_feat_core=2)
    jh = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(seed=0), **kw)
    th = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(seed=0), **kw)
    return jh, th


def _cfg(mod, hin):
    return mod.MP2VConfig(**WALK, start_offset=hin.type_accs["uid"], num_start=hin.num_users,
                          num_nodes=hin.num_nodes)


def _mask():
    return (np.arange(B) < B - PAD).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    top = float(np.abs(want).max())
    return err / top if top > 0 else err


def test_mse_batch_matches_jax(world):
    jh, th = world
    jtr = jwt.HeRecTrainer(jh, _cfg(jmp2v, jh), JTrainConfig())
    ttr = twt.HeRecTrainer(th, _cfg(tmp2v, th), TrainConfig(), device="cpu")
    assert (ttr.n_rows, ttr.num_batches, ttr.eval_loss_form, ttr.loss_mode) == (
        jtr.n_rows, jtr.num_batches, jtr.eval_loss_form, "mse")
    assert ttr.n_rows == th.train_pos.shape[0]
    rows = torch.randperm(ttr.n_rows, generator=torch.Generator().manual_seed(0))[:B]
    pair, rating = ttr._build_batch(rows, torch.Generator().manual_seed(1))
    jpair, jrating = jtr._build_batch(jnp.asarray(rows.numpy()), jax.random.PRNGKey(0))
    assert pair.dtype == torch.int64 and rating.dtype == torch.float32
    np.testing.assert_array_equal(pair.numpy(), np.asarray(jpair))
    np.testing.assert_array_equal(rating.numpy(), np.asarray(jrating))


def _stage2(world, model):
    """(port trainer, JAX trainer, port params, JAX params) of `model`, the
    two trainers given the same frozen embeddings."""
    jh, th = world
    rng = np.random.default_rng(3)
    tc, jtc = TrainConfig(batch_size=B, lr=1e-2), JTrainConfig(batch_size=B, lr=1e-2)
    if model == "MetaPath2Vec":
        embs = rng.normal(size=(1, th.num_nodes, EMB)).astype(np.float32)
        jtr = jwt.MetaPath2VecTrainer(jh, _cfg(jmp2v, jh), jtc)
        ttr = twt.MetaPath2VecTrainer(th, _cfg(tmp2v, th), tc, device="cpu")
        jtr.embedding, ttr.embedding = jnp.asarray(embs[0]), torch.from_numpy(embs[0])
        tree = jwalk.walk_init(jax.random.PRNGKey(4), EMB)
        to_port = tparams.walk_from_jax_numpy
    else:
        embs = rng.normal(size=(2, th.num_nodes, EMB)).astype(np.float32)
        jtr = jwt.HeRecTrainer(jh, _cfg(jmp2v, jh), jtc)
        ttr = twt.HeRecTrainer(th, _cfg(tmp2v, th), tc, device="cpu")
        jtr.rk_embeddings = tuple(jnp.asarray(e) for e in embs)
        ttr.rk_embeddings = tuple(torch.from_numpy(e) for e in embs)
        tree = jherec.herec_init(jax.random.PRNGKey(4), th.num_users, th.num_items, EMB, 2)
        to_port = tparams.herec_from_jax_numpy
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return ttr, jtr, to_port(tree), tree


def _jax_batch(batch):
    if isinstance(batch, tuple):
        return tuple(jnp.asarray(b.numpy()) for b in batch)
    return jnp.asarray(batch.numpy())


@pytest.mark.parametrize("model", ["MetaPath2Vec", "HeRec"])
def test_stage2_step_and_scores_match_jax(world, model):
    ttr, jtr, params, tree = _stage2(world, model)
    gen = torch.Generator().manual_seed(0)
    batch = ttr._build_batch(torch.randperm(ttr.n_rows, generator=gen)[:B], gen)
    mask = _mask()
    jb, jm = _jax_batch(batch), jnp.asarray(mask)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtr._batch_loss(p, jb, jm, jax.random.PRNGKey(0)))(tree)
    opt = ttr.optimizer(params)
    loss = ttr._step(params, opt, lambda: ttr.batch_loss(params, batch, torch.from_numpy(mask)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    jopt = jmake_optimizer("adam", ttr.tcfg.lr, ttr.tcfg.weight_decay)
    upd, _ = jopt.update(jgrads, jopt.init(tree), tree)
    jparams = optax.apply_updates(tree, upd)
    # every test user against 20 items, after the step
    tables = ttr.tables
    u = tables.test_users.long().repeat_interleave(20)
    i = tables.item_lo + torch.arange(20).repeat(tables.test_users.shape[0])
    with torch.no_grad():
        got = ttr.scorer(params)(u, i)
    ju, ji = jnp.asarray(u.numpy()), jnp.asarray(i.numpy())
    if model == "MetaPath2Vec":
        want = jwalk.walk_predict(jparams, jtr.embedding, ju, ji)
    else:
        want = jherec.herec_predict(jparams, jtr.rk_embeddings, jtr.acc_uids, jtr.acc_iids,
                                    ju, ji)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("model", ["MetaPath2Vec", "HeRec"])
def test_pretrain_then_stage2_loss_falls(world, model):
    _, th = world
    cfg = tmp2v.MP2VConfig(**{**WALK, "walks_per_node": 8},
                           start_offset=th.type_accs["uid"], num_start=th.num_users,
                           num_nodes=th.num_nodes)
    cls = twt.MetaPath2VecTrainer if model == "MetaPath2Vec" else twt.HeRecTrainer
    tc = TrainConfig(batch_size=256, sampling_strategy="random")
    tr = cls(th, cfg, tc, device="cpu")
    params = tr.init(2020)
    embs = [tr.embedding] if model == "MetaPath2Vec" else list(tr.rk_embeddings)
    assert len(embs) == (1 if model == "MetaPath2Vec" else 2)
    for e in embs:
        assert e.shape == (th.num_nodes, EMB) and not e.requires_grad
        assert bool(torch.isfinite(e).all())
    if model == "MetaPath2Vec":
        assert np.isfinite(tr.rw_loss)
    opt = tr.optimizer(params)
    gen = torch.Generator().manual_seed(0)
    losses = [float(tr.run_epoch(params, opt, gen)) for _ in range(3)]
    assert losses[-1] < losses[0], losses
    m = tr.evaluate(params, gen)
    assert np.isfinite(float(m["AUC"])) and m["HR"].shape == (16,)


def test_stage1_cache_written_once_and_never_reads_a_jax_npz(world, tmp_path, monkeypatch):
    jh, th = world
    cache = str(tmp_path)
    jcfg, tcfg = _cfg(jmp2v, jh), _cfg(tmp2v, th)
    # the JAX CLI's stage-1 file for the same recipe (JAX walk_trainers.py:99-103),
    # planted as bytes that no loader reads
    key = hashlib.sha1(repr(("mp2v", jwt.ML_MP2V_STEPS, jcfg, 1e-3, 8, 2020,
                             jh.num_nodes)).encode()).hexdigest()[:16]
    jax_file = tmp_path / f"random_walk_mp2v_{key}.npz"
    jax_file.write_bytes(b"not an npz")
    calls = []
    real = twt.pretrain_mp2v

    def spy(*args, **kw):
        calls.append(args[3])
        return real(*args, **kw)

    monkeypatch.setattr(twt, "pretrain_mp2v", spy)
    tr = twt.MetaPath2VecTrainer(th, tcfg, TrainConfig(), cache_dir=cache, device="cpu")
    tr.init(2020)
    first = tr.embedding.clone()
    files = sorted(os.listdir(cache))
    path = twt.stage1_path(cache, "mp2v", th, twt.ML_MP2V_STEPS, tcfg, 2020,
                           torch.device("cpu"))
    assert calls == [2020] and files == sorted([jax_file.name, os.path.basename(path)])
    assert os.path.basename(path).startswith("random_walk_torch_mp2v_")
    tr.init(2020)  # read back, no pretraining
    assert calls == [2020] and torch.equal(tr.embedding, first)
    assert sorted(os.listdir(cache)) == files and jax_file.read_bytes() == b"not an npz"
    tr.init(2021)  # another seed, another file
    assert calls == [2020, 2021] and len(os.listdir(cache)) == 3
    assert not torch.equal(tr.embedding, first)


@pytest.mark.parametrize("model,dataset", [
    ("MetaPath2Vec", "synthetic-ml"), ("HeRec", "synthetic-ml"),
    ("MetaPath2Vec", "synthetic-yelp"), ("HeRec", "synthetic-yelp")])
def test_main_runs_each_walk_model(model, dataset, tmp_path, capsys):
    argv = (["--model", model, "--dataset", dataset, "--emb_dim", "8", "--runs", "1",
             "--epochs", "2", "--device", "cpu", "--metapath_test", "true",
             "--full_ranking", "true", "--out_dir", str(tmp_path / "runs"),
             "--cache_dir", str(tmp_path / "cache")] + TINY_WALK)
    overall = tcli.main(argv)
    assert np.isfinite(np.ravel(overall["HR"])).all() and 0.0 <= overall["HR"][5] <= 1.0
    assert "Overall HR@10:" in capsys.readouterr().out
    args = tcli.build_parser().parse_args(argv)
    hin, mp = tcli.load_hin(args)
    trainer, n = tcli.build_trainer(args, hin, mp)
    assert n == 0 and trainer.device.type == "cpu"
    start = "item_reviewcount" if (model, dataset) == ("MetaPath2Vec", "synthetic-yelp") \
        else "uid"
    assert (trainer.cfg.start_offset, trainer.cfg.num_start) == (
        hin.type_accs[start], hin.num_nodes_dict[start])
    assert (trainer.cfg.walk_length, trainer.cfg.walks_per_node) == (6, 3)
    stage1 = os.path.join(str(tmp_path / "runs"), hin.name, model)
    want = 1 if model == "MetaPath2Vec" else 2
    assert len([f for f in os.listdir(stage1) if f.endswith(".pt")]) == want
    with open(os.path.join(tcli.run_dir(args, hin), "logger_file.txt")) as f:
        text = f.read()
    assert "full-ranking HR@10" in text and "exclude path" not in text


def test_walk_model_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--model", "HeRec", "--out_dir", str(tmp_path / "runs"),
                   "--cache_dir", str(tmp_path / "cache")] + TINY_WALK)
    assert not os.path.exists(tmp_path / "runs")
