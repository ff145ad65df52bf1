"""Port parity for slice 2 as a whole: PEAGAT training (BPR + the
entity-aware regularizer, Adam) on the hybrid plan.

On slice 1's small HIN, JAX `pea_init` weights go through the converter
into the port; `pea_loss` and every parameter gradient are held against
``jax.value_and_grad(pea_loss)`` on one numpy batch of the 9 entity-aware
columns with a partial `row_mask` (f32; within 1e-4 of each gradient's
largest value).  Off the TPU the JAX hybrid forward runs its XLA reference
paths, so this file compares in f32; the kernels' bf16 rounding points are
held per module in test_torch_gat_grads.py.  Three optimizer steps are held
against optax's chain on the same gradients (1e-6).  The samplers are held
to distribution parity (train/sampling.py:21-27), and the epoch runs end
to end on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.models import pea as jpea
from graph_recsys_benchmark_tpu.train import optim as joptim
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.models import pea as tpea
from graph_recsys_benchmark_tpu_torch.train import optim as toptim
from graph_recsys_benchmark_tpu_torch.train import sampling as tsamp
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

RAW = dict(seed=3, num_users=80, num_items=100)
SMALL = dict(conv="gat", meta_path_steps=(2,) * 9, emb_dim=16, hidden_size=16,
             repr_dim=8, entity_aware=True)
AGGRS = ("att", "mean")


@pytest.fixture(scope="module")
def world():
    kw = dict(num_core=5, num_feat_core=3)
    jh = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(**RAW), **kw)
    th = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**RAW), **kw)
    n = jh.num_nodes
    jg = jgraph.build_metapath_graphs(jml.mlsmall_metapath_edges(jh), n, "gat")
    tg = tgraph.build_metapath_graphs(tml.mlsmall_metapath_edges(th), n, "gat")
    return jh, th, jg, tg


def _batch(th, b=96, pad=23, seed=0):
    """One numpy batch of the 9 entity-aware columns, its last `pad` rows
    masked as the epoch's padding rows are."""
    tables = tsamp.build_device_tables(th, "cpu")
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, th.train_pos.shape[0], b)
    u = torch.from_numpy(th.train_pos[rows, 0]).int()
    pos = torch.from_numpy(th.train_pos[rows, 1]).int()
    gen = torch.Generator().manual_seed(seed)
    neg = tsamp.sample_cf_negatives(gen, u, tables, "unseen")
    ent = tsamp.sample_entities(gen, u, pos, tables)
    batch = torch.cat([u[:, None], pos[:, None], neg[:, None], ent], dim=1).long().numpy()
    mask = np.ones(b, np.float32)
    mask[b - pad:] = 0.0
    return batch, mask


def _grad_tree(m):
    def g(layer):
        return {k: v.grad.numpy() for k, v in layer.items()}

    tree = {"x": m.x.grad.numpy(),
            "channels": tuple(tuple(g(layer) for layer in ch) for ch in m.channels),
            "fc1": g(m.fc1), "fc2": g(m.fc2)}
    if m.att is not None:
        tree["att"] = m.att.grad.numpy()
    return tree


def _trained_like(params):
    """Init weights moved off the init regime, where the representations
    are so small that fc1's bias alone sets its ReLU masks: the masks then
    agree for the positive and the negative item, and the gradients of the
    user representations (so of the i2u channels' step-2 attention) vanish
    in exact arithmetic, leaving float32 noise to compare.  Larger
    embeddings and a smaller fc1 bias make every gradient generic."""
    params = dict(params)
    params["x"] = params["x"] * 10.0
    params["fc1"] = dict(params["fc1"], b=params["fc1"]["b"] * 0.1)
    return params


@pytest.fixture(scope="module")
def loss_jax(world):
    """JAX's loss and gradients on the batch, once per channel fusion."""
    jh, th, jg, _ = world
    batch, mask = _batch(th)
    out = {}
    for aggr in AGGRS:
        cfg = jpea.PEAConfig(num_nodes=jh.num_nodes, channel_aggr=aggr, **SMALL)
        params = _trained_like(jpea.pea_init(jax.random.PRNGKey(0), cfg))
        plan = jpea.build_hybrid_gat_plan(jg, jh.num_nodes, cfg)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b, m: jpea.pea_loss(p, plan, cfg, b, row_mask=m)
        ))(params, jnp.asarray(batch), jnp.asarray(mask))
        out[aggr] = (params, float(loss), jax.tree_util.tree_map(np.asarray, grads))
    return batch, mask, out


@pytest.mark.parametrize("aggr", AGGRS)
def test_loss_and_grads_match_jax(world, loss_jax, aggr):
    _, th, _, tg = world
    batch, mask, out = loss_jax
    params, jloss, jgrads = out[aggr]
    cfg = tpea.PEAConfig(num_nodes=th.num_nodes, channel_aggr=aggr, **SMALL)
    model = tparams.from_jax_numpy(jax.tree_util.tree_map(np.asarray, params))
    plan = tpea.build_hybrid_gat_plan(tg, th.num_nodes, cfg)
    loss = tpea.pea_loss(model, plan, cfg, torch.from_numpy(batch),
                         row_mask=torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    tgrads = _grad_tree(model)
    assert jax.tree_util.tree_structure(tgrads) == jax.tree_util.tree_structure(jgrads)
    # fc2's bias cancels in pos − neg: its gradient is exactly 0 in both
    for tgl, jgl in zip(jax.tree_util.tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        assert tgl.shape == jgl.shape
        scale = max(float(np.abs(jgl).max()), 1e-30)
        assert float(np.abs(tgl - jgl).max()) <= 1e-4 * scale
    # the padding rows add nothing: the masked batch's loss is the unmasked
    # loss of its real rows
    real = torch.from_numpy(batch[mask > 0])
    with torch.no_grad():
        np.testing.assert_allclose(float(tpea.pea_loss(model, plan, cfg, real)),
                                   float(loss.detach()), rtol=1e-6)
    # a dropout rate without keep masks drops nothing (JAX: no dropout key)
    with torch.no_grad():
        np.testing.assert_allclose(
            float(tpea.pea_loss(model, plan, dataclasses.replace(cfg, dropout=0.1),
                                torch.from_numpy(batch), row_mask=torch.from_numpy(mask))),
            float(loss.detach()), rtol=1e-6)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_optimizer_steps_match_optax(opt):
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 5), "b": (5,), "x": (4, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    grads[1]["x"][2] = 0.0  # an untouched embedding row still decays (L2)
    tx = joptim.make_optimizer(opt, 1e-3, 1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    topt = toptim.make_optimizer(opt, 1e-3, 1e-3)(list(tp.values()))
    for g in grads:
        updates, state = update(g, state, jp)
        jp = jax.tree_util.tree_map(np.add, jp, updates)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k].copy())
        topt.step()
    for k, t in tp.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    assert toptim.make_optimizer("sparseadam").func is toptim.SparseAdam
    with pytest.raises(ValueError):
        toptim.make_optimizer("adagrad")


def test_cf_negatives_unseen_and_uniform(world):
    th = world[1]
    tables = tsamp.build_device_tables(th, "cpu")
    cand, counts = th.candidates.cand, th.candidates.neg_counts
    users = th.candidates.test_users
    draws = 2000
    u = torch.from_numpy(np.repeat(users, draws)).int()
    negs = tsamp.sample_cf_negatives(torch.Generator().manual_seed(3), u, tables, "unseen")
    negs = negs.numpy().reshape(len(users), draws)
    chi2, dof = 0.0, 0
    for i in range(len(users)):
        allowed = np.sort(cand[i, : 1 + counts[i]])  # test item + never-interacted
        pos = np.searchsorted(allowed, negs[i])
        assert np.all(allowed[np.minimum(pos, counts[i])] == negs[i])
        hist = np.bincount(pos, minlength=counts[i] + 1)
        expect = draws / (counts[i] + 1)
        chi2 += float(((hist - expect) ** 2 / expect).sum())
        dof += int(counts[i])
    assert abs(chi2 - dof) < 5 * np.sqrt(2 * dof)
    rand = tsamp.sample_cf_negatives(torch.Generator().manual_seed(4), u[:500], tables,
                                     "random").numpy()
    assert rand.min() >= th.item_acc and rand.max() < th.item_acc + th.num_items


def test_entities_empty_lists_and_type_ranges(world):
    th = world[1]
    tables = tsamp.build_device_tables(th, "cpu")
    # empty the feature lists of the first 5 items and users
    icnt, ucnt = tables.item_feat_counts.clone(), tables.user_feat_counts.clone()
    icnt[:5] = 0
    ucnt[:5] = 0
    tables = dataclasses.replace(tables, item_feat_counts=icnt, user_feat_counts=ucnt)
    b = 4000
    rng = np.random.default_rng(2)
    u = torch.from_numpy(tables.user_lo + rng.integers(0, th.num_users, b)).int()
    i = torch.from_numpy(tables.item_lo + rng.integers(0, th.num_items, b)).int()
    ent = tsamp.sample_entities(torch.Generator().manual_seed(5), u, i, tables).numpy()
    lo, hi = th.entity_feats.ent_lo, th.entity_feats.ent_hi
    for cols, ids, base, counts, feat in (
        ((0, 1, 2), i.numpy() - tables.item_lo, tables.item_lo, icnt.numpy(),
         th.entity_feats.item_feat),
        ((3, 4, 5), u.numpy() - tables.user_lo, tables.user_lo, ucnt.numpy(),
         th.entity_feats.user_feat),
    ):
        pos, neg, mask = (ent[:, c] for c in cols)
        empty = counts[ids] == 0
        assert empty.any() and (~empty).any()
        assert np.all(pos[empty] == 0) and np.all(neg[empty] == 0) and np.all(mask[empty] == 0)
        full = ~empty
        assert np.all(mask[full] == 1)
        # the positive is on the node's own list, the negative in its type range
        for p, idx in zip(pos[full], ids[full]):
            assert p in feat[idx, : counts[idx]]
        assert np.all(neg[full] >= lo[pos[full]]) and np.all(neg[full] < hi[pos[full]])


def test_run_epoch_on_cpu(world):
    """A tiny epoch end to end on the CPU: several steps, the last batch
    partial and masked, a finite mean loss that falls in the second epoch."""
    th = world[1]
    cfg = tpea.PEAConfig(num_nodes=th.num_nodes, **SMALL)
    tcfg = TrainConfig(batch_size=1000, num_negative_samples=1, lr=1e-2)
    trainer = PEATrainer(th, cfg, tcfg, device="cpu")
    assert trainer.n_rows == th.train_pos.shape[0] and trainer.n_rows % 1000 != 0
    params = trainer.init(0)
    opt = trainer.optimizer(params)
    gen = torch.Generator().manual_seed(0)
    first = trainer.run_epoch(params, opt, gen)
    second = trainer.run_epoch(params, opt, gen)
    assert first.shape == () and torch.isfinite(first) and torch.isfinite(second)
    assert float(second) < float(first)
    assert all(torch.isfinite(p).all() for p in params.parameters())
