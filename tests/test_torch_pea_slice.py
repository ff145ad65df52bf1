"""Port parity for slice 1 as a whole: PEAGAT inference on the hybrid plan.

JAX `pea_init` weights go through the converter into the port; the cached
representation (`pea_forward`, f32, rtol/atol 2e-5), the pair scores
(`pea_predict`, 2e-5) and the 99-negative HR/NDCG/AUC (`evaluate_ranking`,
within 1/U: one user's rank may flip on a near-tie) are held against the JAX
package on one small HIN, with the negatives one numpy array fed to both.
Off the TPU the JAX hybrid forward runs `batch_gat_reference` and the
composed union path, so this file compares in f32; the kernels' bf16
rounding is held per module in test_torch_gat_ops.py.

Also: the converter round-trips exactly, the port's negative sampler draws
only unseen items and near-uniformly (the distribution parity of
train/sampling.py:21-27), the trainer runs end to end on the CPU, and the
port imports neither JAX nor the JAX package."""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.eval import ranking as jrank
from graph_recsys_benchmark_tpu.models import pea as jpea
from graph_recsys_benchmark_tpu.train import sampling as jsamp
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.eval import ranking as trank
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.models import pea as tpea
from graph_recsys_benchmark_tpu_torch.train import sampling as tsamp
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "graph_recsys_benchmark_tpu_torch")
RAW = dict(seed=3, num_users=80, num_items=100)
SMALL = dict(conv="gat", meta_path_steps=(2,) * 9, emb_dim=16, hidden_size=16,
             repr_dim=8)
JAX_ONLY = dict(entity_aware=True)  # read by the JAX training loss alone


@pytest.fixture(scope="module")
def world():
    kw = dict(num_core=5, num_feat_core=3)
    jh = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(**RAW), **kw)
    th = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**RAW), **kw)
    n = jh.num_nodes
    jg = jgraph.build_metapath_graphs(jml.mlsmall_metapath_edges(jh), n, "gat")
    tg = tgraph.build_metapath_graphs(tml.mlsmall_metapath_edges(th), n, "gat")
    return jh, th, jg, tg


def _models(world, aggr, heads=1):
    jh, th, jg, tg = world
    n = jh.num_nodes
    jcfg = jpea.PEAConfig(num_nodes=n, channel_aggr=aggr, num_heads=heads, **SMALL,
                          **JAX_ONLY)
    tcfg = tpea.PEAConfig(num_nodes=n, channel_aggr=aggr, num_heads=heads, **SMALL)
    params = jpea.pea_init(jax.random.PRNGKey(0), jcfg)
    model = tparams.from_jax_numpy(jax.tree_util.tree_map(np.asarray, params))
    jplan = jpea.build_hybrid_gat_plan(jg, n, jcfg)
    tplan = tpea.build_hybrid_gat_plan(tg, n, tcfg)
    return params, model, jcfg, tcfg, jplan, tplan


@pytest.mark.parametrize("aggr,heads", [("att", 1), ("mean", 1), ("concat", 1), ("att", 2)])
def test_forward_matches_jax(world, aggr, heads):
    """heads 2: step 1 runs its union graph once per head and concatenates."""
    params, model, jcfg, tcfg, jplan, tplan = _models(world, aggr, heads)
    mask = np.ones(9, np.float32)
    mask[3] = 0.0
    jrep = jpea.pea_forward(params, jplan, jcfg, channel_mask=jnp.asarray(mask))
    with torch.no_grad():
        trep = tpea.pea_forward(model, tplan, tcfg, channel_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(trep.numpy(), np.asarray(jrep), rtol=2e-5, atol=2e-5)


def test_scores_and_ranking_metrics_match_jax(world, monkeypatch):
    jh, th, _, _ = world
    params, model, jcfg, tcfg, jplan, tplan = _models(world, "att")
    jrep = jpea.pea_forward(params, jplan, jcfg)
    with torch.no_grad():
        trep = tpea.pea_forward(model, tplan, tcfg)

    # the same [U, 99] negatives for both: uniform over each user's unseen items
    rng = np.random.default_rng(11)
    cand, counts = th.candidates.cand, th.candidates.neg_counts
    u = cand.shape[0]
    negs = np.stack([cand[i, 1 + rng.integers(0, counts[i], 99)] for i in range(u)])
    monkeypatch.setattr(jsamp, "sample_eval_negatives", lambda *a, **k: jnp.asarray(negs))
    monkeypatch.setattr(tsamp, "sample_eval_negatives", lambda *a, **k: torch.from_numpy(negs))

    uids = np.repeat(th.candidates.test_users, 5)
    iids = negs[:, :5].reshape(-1)
    js = jpea.pea_predict(params, jrep, jnp.asarray(uids), jnp.asarray(iids))
    with torch.no_grad():
        ts = tpea.pea_predict(model, trep, torch.from_numpy(uids).long(),
                              torch.from_numpy(iids).long())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-5, atol=2e-5)

    jres = jrank.evaluate_ranking(
        jax.random.PRNGKey(0),
        lambda a, b: jpea.pea_predict(params, jrep, a, b),
        jsamp.build_device_tables(jh), 99,
    )
    with torch.no_grad():
        tres = trank.evaluate_ranking(
            torch.Generator().manual_seed(0),
            lambda a, b: tpea.pea_predict(model, trep, a.long(), b.long()),
            tsamp.build_device_tables(th, "cpu"), 99,
        )
    for k in ("HR", "NDCG", "AUC"):
        np.testing.assert_allclose(tres[k].numpy(), np.asarray(jres[k]), atol=1.0 / u + 1e-6)
    np.testing.assert_allclose(float(tres["eval_loss"]), float(jres["eval_loss"]), rtol=1e-4)


def test_converter_round_trips_exactly():
    cfg = jpea.PEAConfig(num_nodes=300, **SMALL, **JAX_ONLY)
    tree = jax.tree_util.tree_map(np.asarray, jpea.pea_init(jax.random.PRNGKey(1), cfg))
    back = tparams.to_numpy(tparams.from_jax_numpy(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the port's own init draws the JAX layout
    port = tparams.to_numpy(tpea.pea_init(torch.Generator().manual_seed(0),
                                          tpea.PEAConfig(num_nodes=300, **SMALL)))
    assert jax.tree_util.tree_structure(port) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(port)):
        assert a.shape == b.shape and a.dtype == b.dtype
    bound = np.sqrt(6.0 / (300 + 16))
    assert np.abs(port["x"]).max() <= bound


def test_eval_negatives_unseen_and_uniform(world):
    th = world[1]
    tables = tsamp.build_device_tables(th, "cpu")
    draws = 3000
    negs = tsamp.sample_eval_negatives(torch.Generator().manual_seed(5), tables, draws).numpy()
    cand, counts = th.candidates.cand, th.candidates.neg_counts
    chi2, dof = 0.0, 0
    for i in range(cand.shape[0]):
        unseen = cand[i, 1 : 1 + counts[i]]
        pos = np.searchsorted(unseen, negs[i])
        assert np.all(unseen[np.minimum(pos, counts[i] - 1)] == negs[i])
        hist = np.bincount(pos, minlength=counts[i])
        expect = draws / counts[i]
        chi2 += float(((hist - expect) ** 2 / expect).sum())
        dof += int(counts[i]) - 1
    assert abs(chi2 - dof) < 5 * np.sqrt(2 * dof)


def test_eval_negatives_refuse_generator_on_other_device(world):
    """The draw never crosses devices quietly: a generator that does not
    live with the tables raises."""
    tables = tsamp.build_device_tables(world[1], "meta")
    with pytest.raises(ValueError):
        tsamp.sample_eval_negatives(torch.Generator().manual_seed(0), tables, 99)


def test_trainer_evaluates_end_to_end_on_cpu(world):
    th = world[1]
    cfg = tpea.PEAConfig(num_nodes=th.num_nodes, **SMALL)
    for transport in ("f32", "bf16"):
        trainer = PEATrainer(th, cfg, TrainConfig(), device="cpu", transport=transport)
        assert [c for _, c in trainer.graphs.steps[1][0]] == [(0, 2, 3, 4, 5, 6, 7), (1, 8)]
        params = trainer.init(2020)
        res = trainer.evaluate(params, torch.Generator().manual_seed(0))
        assert res["HR"].shape == (16,) and res["NDCG"].shape == (16,)
        assert all(torch.isfinite(res[k]).all() for k in ("HR", "NDCG", "AUC", "eval_loss"))
        assert 0.0 <= float(res["AUC"]) <= 1.0
    ablated = trainer.evaluate(params, torch.Generator().manual_seed(0), metapath_idx=0)
    assert torch.isfinite(ablated["AUC"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PEATrainer(th, cfg, TrainConfig())


def test_port_imports_without_jax():
    mods = sorted(
        os.path.relpath(os.path.join(d, f), REPO)[:-3].replace(os.sep, ".")
        for d, _, files in os.walk(PKG) for f in files if f.endswith(".py")
    )
    # the training modules, the edge ops, the mode switches and the
    # parallel layer are among them
    assert {f"graph_recsys_benchmark_tpu_torch.{m}" for m in (
        "train.engine", "train.optim", "ops.segment_kernels", "ops.gather", "nn.conv",
        "ops.config", "parallel.multihost", "parallel.collectives", "parallel.edge_parallel",
        "parallel.engine", "parallel.a2a", "parallel.sharded_embedding", "parallel.spmd",
    )} <= set(mods)
    code = (
        "import sys\n"
        "for m in ('jax', 'optax', 'graph_recsys_benchmark_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value


def test_port_and_chip_smoke_name_no_jax_module():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    for path in files:
        for mod in _imported_modules(path):
            root = str(mod).split(".")[0]
            assert root not in ("jax", "optax", "graph_recsys_benchmark_tpu"), (path, mod)
