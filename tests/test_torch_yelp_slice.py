"""Port parity for the Yelp slice as a whole: PEAGAT on the CLI's
synthetic-yelp HIN (``synthetic_yelp_raw(seed=0)``, ``num_core=4``: 420
nodes, 314 users, 2,228 train interactions), its 11 two-step metapaths at
small widths.

* The per-channel GAT graphs equal the JAX package's array for array, with
  the same channels sharing one graph object, both composed (the auto
  rule: every graph below the streaming threshold) and with every graph
  loop-free (``_analytic_gat_loops = True``).
* The hybrid plan (the CLI's route on this HIN) groups the channels as the
  JAX ``build_hybrid_gat_plan`` does: per step the same batched shares and
  the same union channels.
* On the streaming layout, ``pea_loss`` (entity-aware, a partial row mask)
  and every gradient are held against ``jax.value_and_grad`` in f32 (loss
  1e-6, every gradient 2e-5 of its largest value: test_torch_ml25m_slice.py's
  bar; off the TPU the JAX package runs ``stream_gat_reference``, the port
  the kernels' plain versions).
* A few CPU training steps through the trainer on the hybrid plan and an
  eval: the loss falls, the metrics are finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.data import yelp as jyelp
from graph_recsys_benchmark_tpu.models import pea as jpea
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.data import yelp as tyelp
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.models import pea as tpea
from graph_recsys_benchmark_tpu_torch.train import sampling as tsamp
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

SMALL = dict(conv="gat", meta_path_steps=(2,) * 11, emb_dim=16, hidden_size=16, repr_dim=8,
             entity_aware=True)
FIELDS = ("src", "dst", "w", "rel", "src_perm", "src_sorted")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread beside the other pytest workers
    (test_torch_ml25m_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    jh = jyelp.build_yelp_hin(*jsyn.synthetic_yelp_raw(seed=0), num_core=4)
    th = tyelp.build_yelp_hin(*tsyn.synthetic_yelp_raw(seed=0), num_core=4)
    return jh, th


def _per_channel(world, analytic):
    jh, th = world
    jg = jgraph.build_metapath_graphs(jyelp.yelp_metapath_edges(jh), jh.num_nodes, "gat",
                                      analytic_gat_loops=analytic)
    tg = tgraph.build_metapath_graphs(tyelp.yelp_metapath_edges(th), th.num_nodes, "gat",
                                      analytic_gat_loops=analytic)
    return jg, tg


@pytest.mark.parametrize("analytic", [None, True], ids=["composed", "stream"])
def test_per_channel_graphs_equal_jax(world, analytic):
    jg, tg = _per_channel(world, analytic)
    assert len(tg) == 11
    for k in range(2):
        jids = [id(ch[k]) for ch in jg]
        tids = [id(ch[k]) for ch in tg]
        assert [jids.index(i) for i in jids] == [tids.index(i) for i in tids]
        for jc, tc in zip(jg, tg, strict=True):
            a, b = jc[k], tc[k]
            for f in FIELDS:
                np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f).numpy(),
                                              err_msg=f)
            assert (a.num_nodes, a.num_edges, a.src_span, a.gat_loops) == (
                b.num_nodes, b.num_edges, b.src_span, b.gat_loops)
    assert all(g.gat_loops == bool(analytic) for ch in tg for g in ch)
    # step 2: i2u shared by channels 1-6 (6), u2i by 0 and 7-10 (5)
    shares = {}
    for c, ch in enumerate(tg):
        shares.setdefault(id(ch[1]), []).append(c)
    assert sorted(len(v) for v in shares.values()) == [5, 6]


def test_hybrid_plan_groups_equal_jax(world):
    jh, th = world
    jg, tg = _per_channel(world, None)
    jplan = jpea.build_hybrid_gat_plan(jg, jh.num_nodes,
                                       jpea.PEAConfig(num_nodes=jh.num_nodes, **SMALL))
    tplan = tpea.build_hybrid_gat_plan(tg, th.num_nodes,
                                       tpea.PEAConfig(num_nodes=th.num_nodes, **SMALL))
    assert len(tplan.steps) == len(jplan.steps) == 2
    for (jb, ju, jr), (tb, tu, tr) in zip(jplan.steps, tplan.steps, strict=True):
        assert [c for _, c in tb] == [c for _, c in jb]
        assert tr == jr
        assert (tu is None) == (ju is None)
        if tu is not None:
            for f in ("src", "dst"):
                np.testing.assert_array_equal(np.asarray(getattr(ju, f)),
                                              getattr(tu, f).numpy())
    assert tplan.per_channel == tuple(tg)
    assert [len(tplan.steps[k][2]) for k in range(2)] == [11, 0]
    assert sorted(len(c) for _, c in tplan.steps[1][0]) == [5, 6]


def _trained_like(params):
    """Off the init regime (test_torch_train_slice.py:_trained_like)."""
    params = dict(params)
    params["x"] = params["x"] * 10.0
    params["fc1"] = dict(params["fc1"], b=params["fc1"]["b"] * 0.1)
    return params


def _batch(th, b=96, pad=23, seed=0):
    tables = tsamp.build_device_tables(th, "cpu")
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, th.train_pos.shape[0], b)
    u = torch.from_numpy(th.train_pos[rows, 0]).int()
    pos = torch.from_numpy(th.train_pos[rows, 1]).int()
    gen = torch.Generator().manual_seed(seed)
    neg = tsamp.sample_cf_negatives(gen, u, tables, "random")
    ent = tsamp.sample_entities(gen, u, pos, tables)
    batch = torch.cat([u[:, None], pos[:, None], neg[:, None], ent], dim=1).long().numpy()
    mask = np.ones(b, np.float32)
    mask[b - pad:] = 0.0
    return batch, mask


def _grad_tree(m):
    def g(layer):
        return {k: v.grad.numpy() for k, v in layer.items()}

    return {"x": m.x.grad.numpy(), "att": m.att.grad.numpy(),
            "channels": tuple(tuple(g(layer) for layer in ch) for ch in m.channels),
            "fc1": g(m.fc1), "fc2": g(m.fc2)}


def test_loss_and_grads_match_jax(world):
    jh, th = world
    jg, tg = _per_channel(world, True)
    n = jh.num_nodes
    jcfg = jpea.PEAConfig(num_nodes=n, **SMALL)
    tcfg = tpea.PEAConfig(num_nodes=n, **SMALL)
    params = _trained_like(tparams.to_numpy(tpea.pea_init(torch.Generator().manual_seed(0),
                                                          tcfg)))
    batch, mask = _batch(th)
    jloss, jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.value_and_grad(
        lambda q: jpea.pea_loss(q, jg, jcfg, jnp.asarray(batch),
                                row_mask=jnp.asarray(mask))))(params))
    model = tparams.from_jax_numpy(jax.tree_util.tree_map(np.asarray, params))
    loss = tpea.pea_loss(model, tg, tcfg, torch.from_numpy(batch),
                         row_mask=torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    tgrads = _grad_tree(model)
    assert jax.tree_util.tree_structure(tgrads) == jax.tree_util.tree_structure(jgrads)
    errs = []
    for t, j in zip(jax.tree_util.tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        assert t.shape == j.shape and np.isfinite(t).all()
        if not j.any():  # fc2's bias cancels in pos - neg
            assert not t.any()
            continue
        errs.append(float(np.abs(t - j).max() / np.abs(j).max()))
    assert max(errs) <= 2e-5, sorted(errs)


def test_train_steps_and_eval_on_cpu(world):
    th = world[1]
    cfg = tpea.PEAConfig(num_nodes=th.num_nodes, **SMALL)
    trainer = PEATrainer(th, cfg, TrainConfig(batch_size=1024, sampling_strategy="random"),
                         tyelp.yelp_metapath_edges(th), device="cpu")
    assert isinstance(trainer.graphs, tpea.HybridGATPlan)
    params = trainer.init(0)
    opt = trainer.optimizer(params)
    gen = torch.Generator().manual_seed(0)
    first = float(trainer.run_epoch(params, opt, gen))
    for _ in range(2):
        last = float(trainer.run_epoch(params, opt, gen))
    assert np.isfinite([first, last]).all() and last < first
    res = trainer.evaluate(params, torch.Generator().manual_seed(0))
    assert res["HR"].shape == (16,)
    assert all(torch.isfinite(res[k]).all() for k in ("HR", "NDCG", "AUC", "eval_loss"))
