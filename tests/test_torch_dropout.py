"""Port parity for GAT attention dropout: the keep masks are data.

Every function of the port that drops takes its masks from its caller
(``nn/conv.gat_apply(keep=...)``, ``ops/stream_gat.stream_gat_reference
(edge_keep=, loop_keep=)``, ``pea_loss(masks=DropoutMasks)``), so the
JAX package's own masks, recomputed here under its key schedule, go
through the port and the results are compared exactly as far as f32
allows:

  * a channel's step keys are ``split(fold_in(key, c), num_steps)``;
  * a composed conv draws ``bernoulli(dk, 1 - p, [E, H])`` (JAX
    nn/conv.py:154);
  * a `gat_loops` conv splits ``fold_in(dk, head)`` into the edge key and
    the loop key (nn/conv.py:125-130);
  * union step k (the fused forward: every channel over one union graph)
    draws ``bernoulli(fold_in(key, k), 1 - p, [E, H])`` (models/pea.py:269-271,
    :309-310).

Held: ``gat_apply`` composed (2 heads) and on a `gat_loops` graph, and
``stream_gat_reference`` with both masks, forward and gradients (f32:
outputs 1e-5, gradients 1e-4 of their largest value); ``pea_loss`` with
dropout on the hybrid plan (which hands a training forward to its
per-channel graphs) and every gradient against ``jax.value_and_grad``
(1e-5 / 1e-4, slice 2's bar); all-keep masks at rate 0 give the
no-dropout loss.  ``pea_loss`` on the union graphs under the union
masks (heads 1 and 2: the composed route in place of the flash one)
against JAX ``pea_loss(fused, dropout_key=...)`` at the same bars; GCN
and SAGE unions with masks give the no-dropout loss, and so does their
``--parallel dp`` step at a mesh of one with dropout set.  The port's own
draws (``DropoutMasks`` from a torch generator) are held to distribution
parity: the keep rate within 4 sigma of 1 - p, different masks per
channel, step, head and training step, none drawn by an eval.  A spy shows that a training forward with dropout never
calls the streaming kernels' wrappers (K9-K11) and an eval does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.models import pea as jpea
from graph_recsys_benchmark_tpu.nn import conv as jconv
from graph_recsys_benchmark_tpu.ops import stream_gat as jsg
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.models import pea as tpea
from graph_recsys_benchmark_tpu_torch.nn import conv as tconv
from graph_recsys_benchmark_tpu_torch.ops import stream_gat as tsg
from graph_recsys_benchmark_tpu_torch.parallel.engine import ShardedPEATrainer
from graph_recsys_benchmark_tpu_torch.parallel.multihost import make_pod_mesh
from graph_recsys_benchmark_tpu_torch.train import sampling as tsamp
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

RAW = dict(seed=3, num_users=80, num_items=100)
SMALL = dict(conv="gat", meta_path_steps=(2,) * 9, emb_dim=16, hidden_size=16,
             repr_dim=8, entity_aware=True)
P = 0.3


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
    kw = dict(num_core=5, num_feat_core=3)
    jh = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(**RAW), **kw)
    th = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**RAW), **kw)
    n = jh.num_nodes
    jg = jgraph.build_metapath_graphs(jml.mlsmall_metapath_edges(jh), n, "gat")
    tg = tgraph.build_metapath_graphs(tml.mlsmall_metapath_edges(th), n, "gat")
    return jh, th, jg, tg


def _t(a):
    return torch.from_numpy(np.array(a))


class JaxMasks(tpea.DropoutMasks):
    """The JAX package's masks under its key schedule (module docstring)."""

    def __init__(self, p, key, num_steps):
        super().__init__(p)
        self.key, self.num_steps = key, num_steps

    def draw(self, c, k, g, heads):
        if c is None:  # union step k
            return conv_masks(jax.random.fold_in(self.key, k), self.p, g, heads)
        dk = jax.random.split(jax.random.fold_in(self.key, c), self.num_steps)[k]
        return conv_masks(dk, self.p, g, heads)


def conv_masks(dk, p, g, heads):
    """One conv's masks from its key, as JAX's gat_apply draws them."""
    num_edges = g.dst.shape[0]
    if g.gat_loops:
        out = []
        for hh in range(heads):
            k1, k2 = jax.random.split(jax.random.fold_in(dk, hh))
            out.append((_t(jax.random.bernoulli(k1, 1.0 - p, (num_edges,))),
                        _t(jax.random.bernoulli(k2, 1.0 - p, (g.num_nodes,)))))
        return tuple(out)
    return _t(jax.random.bernoulli(dk, 1.0 - p, (num_edges, heads)))


class AllKeep(tpea.DropoutMasks):
    def draw(self, c, k, g, heads):
        if g.gat_loops:
            return tuple((torch.ones(g.dst.shape[0], dtype=torch.bool),
                          torch.ones(g.num_nodes, dtype=torch.bool)) for _ in range(heads))
        return torch.ones(g.dst.shape[0], heads, dtype=torch.bool)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _conv_graphs(world, loops):
    """Channel 1's step-0 graph (a composed one, or rebuilt with implicit
    self-loops)."""
    jh, th, jg, tg = world
    if not loops:
        return jg[1][0], tg[1][0]
    n = jh.num_nodes
    jgs = jgraph.build_metapath_graphs(jml.mlsmall_metapath_edges(jh), n, "gat",
                                       analytic_gat_loops=True)
    tgs = tgraph.build_metapath_graphs(tml.mlsmall_metapath_edges(th), n, "gat",
                                       analytic_gat_loops=True)
    return jgs[1][0], tgs[1][0]


@pytest.mark.parametrize("loops", [False, True], ids=["composed", "gat_loops"])
def test_gat_apply_matches_jax_under_its_masks(world, loops):
    jgr, tgr = _conv_graphs(world, loops)
    assert jgr.gat_loops == tgr.gat_loops == loops
    n, heads, c = jgr.num_nodes, 2, 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    params = {"w": rng.standard_normal((12, heads * c)).astype(np.float32) * 0.5,
              "att": rng.standard_normal((1, heads, 2 * c)).astype(np.float32),
              "b": rng.standard_normal(heads * c).astype(np.float32)}
    gout = rng.standard_normal((n, heads * c)).astype(np.float32)
    dk = jax.random.PRNGKey(7)

    def jloss(q, xx):
        out = jconv.gat_apply(q, xx, jgr, heads=heads, dropout=P, dropout_key=dk)
        return jnp.sum(out * gout), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, x)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    keep = conv_masks(dk, P, tgr, heads)
    out = tconv.gat_apply(tp, tx, tgr, heads=heads, dropout=P, keep=keep)
    (out * torch.from_numpy(gout)).sum().backward()
    assert _rel(out.detach(), jout) <= 1e-5
    assert _rel(tx.grad, jgx) <= 1e-4
    for k in params:
        assert _rel(tp[k].grad, jgp[k]) <= 1e-4, k
    # the masks dropped something, and the dropout changed the output
    flat = keep if not loops else torch.cat([torch.cat(m) for m in keep])
    assert 0 < int((~flat).sum()) < flat.numel()
    nodrop = tconv.gat_apply(tp, tx, tgr, heads=heads)
    assert _rel(nodrop.detach(), out.detach()) > 1e-3


def test_stream_reference_matches_jax_under_masks(world):
    _, tgr = _conv_graphs(world, True)
    jgr = _conv_graphs(world, True)[0]
    n, kz = tgr.num_nodes, 8
    rng = np.random.default_rng(1)
    z = rng.standard_normal((n, kz)).astype(np.float32)
    a_src = rng.standard_normal(n).astype(np.float32)
    a_dst = rng.standard_normal(n).astype(np.float32)
    gout = rng.standard_normal((n, kz)).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    ek = jax.random.bernoulli(k1, 1.0 - P, jgr.dst.shape)
    lk = jax.random.bernoulli(k2, 1.0 - P, (n,))

    def jloss(zz, s, d):
        out = jsg.stream_gat_reference(zz, s, d, jgr.src, jgr.dst, n, True, 0.2,
                                       edge_keep=ek, loop_keep=lk, dropout=P)
        return jnp.sum(out * gout), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        z, a_src, a_dst)
    tz, ts, td = (torch.from_numpy(v.copy()).requires_grad_() for v in (z, a_src, a_dst))
    out = tsg.stream_gat_reference(tz, ts, td, tgr.src, tgr.dst, n, True, 0.2,
                                   edge_keep=_t(ek), loop_keep=_t(lk), dropout=P)
    (out * torch.from_numpy(gout)).sum().backward()
    assert _rel(out.detach(), jout) <= 1e-5
    for t, j in zip((tz, ts, td), jgrads):
        assert _rel(t.grad, j) <= 1e-4


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
    neg = tsamp.sample_cf_negatives(gen, u, tables, "unseen")
    ent = tsamp.sample_entities(gen, u, pos, tables)
    batch = torch.cat([u[:, None], pos[:, None], neg[:, None], ent], dim=1).long().numpy()
    mask = np.ones(b, np.float32)
    mask[b - pad:] = 0.0
    return batch, mask


def _grad_leaves(m):
    def g(layer):
        return {k: v.grad.numpy() for k, v in layer.items()}

    tree = {"x": m.x.grad.numpy(), "att": m.att.grad.numpy(),
            "channels": tuple(tuple(g(layer) for layer in ch) for ch in m.channels),
            "fc1": g(m.fc1), "fc2": g(m.fc2)}
    return tree


def test_pea_loss_with_dropout_matches_jax(world):
    jh, th, jg, tg = world
    n = jh.num_nodes
    jcfg = jpea.PEAConfig(num_nodes=n, dropout=P, **SMALL)
    tcfg = tpea.PEAConfig(num_nodes=n, dropout=P, **SMALL)
    params = _trained_like(tparams.to_numpy(tpea.pea_init(torch.Generator().manual_seed(0),
                                                          tcfg)))
    batch, mask = _batch(th)
    key = jax.random.PRNGKey(11)
    jplan = jpea.build_hybrid_gat_plan(jg, n, jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q: jpea.pea_loss(q, jplan, jcfg, jnp.asarray(batch), row_mask=jnp.asarray(mask),
                                training=True, dropout_key=key)))(params)
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    plan = tpea.build_hybrid_gat_plan(tg, n, tcfg)
    model = tparams.from_jax_numpy(jax.tree_util.tree_map(np.asarray, params))
    masks = JaxMasks(P, key, 2)
    loss = tpea.pea_loss(model, plan, tcfg, torch.from_numpy(batch),
                         row_mask=torch.from_numpy(mask), masks=masks)
    loss.backward()
    assert len(masks._drawn) == 18  # every conv of the 9 channels, one draw each
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    tgrads = _grad_leaves(model)
    assert jax.tree_util.tree_structure(tgrads) == jax.tree_util.tree_structure(jgrads)
    for t, j in zip(jax.tree_util.tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        assert t.shape == j.shape
        assert float(np.abs(t - j).max()) <= 1e-4 * max(float(np.abs(j).max()), 1e-30)
    # without dropout the loss moves: the masks were used
    with torch.no_grad():
        plain = tpea.pea_loss(model, plan, tcfg, torch.from_numpy(batch),
                              row_mask=torch.from_numpy(mask))
    assert abs(float(plain) - float(loss.detach())) > 1e-3 * abs(float(plain))


def test_all_keep_masks_give_the_no_dropout_loss(world):
    _, th, _, tg = world
    cfg = tpea.PEAConfig(num_nodes=th.num_nodes, **SMALL)  # dropout 0
    model = tpea.pea_init(torch.Generator().manual_seed(1), cfg)
    plan = tpea.build_hybrid_gat_plan(tg, th.num_nodes, cfg)
    batch, mask = _batch(th, seed=1)
    b, m = torch.from_numpy(batch), torch.from_numpy(mask)
    with torch.no_grad():
        want = tpea.pea_loss(model, plan, cfg, b, row_mask=m)
        got = tpea.pea_loss(model, plan, cfg, b, row_mask=m, masks=AllKeep(0.0))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


class _StreamTrainer(PEATrainer):
    _analytic_gat_loops = True


def _trainer(th, loops, dropout=P):
    cfg = tpea.PEAConfig(num_nodes=th.num_nodes, dropout=dropout, **SMALL)
    cls = _StreamTrainer if loops else PEATrainer
    return cls(th, cfg, TrainConfig(batch_size=256), tml.mlsmall_metapath_edges(th),
               device="cpu")


def test_port_draws_keep_rate_and_independence(world):
    th, tg = world[1], world[3]
    gen = torch.Generator().manual_seed(0)
    masks = tpea.DropoutMasks(P, gen)
    m10 = masks.gat(1, 0, tg[1][0], 2)
    assert m10 is masks.gat(1, 0, tg[1][0], 2)  # drawn once per conv
    m20, m11 = masks.gat(2, 0, tg[2][0], 2), masks.gat(1, 1, tg[1][1], 2)
    flat = torch.cat([m10.flatten(), m20.flatten(), m11.flatten()]).float()
    nn_ = flat.numel()
    assert abs(float(flat.mean()) - (1 - P)) <= 4 * np.sqrt(P * (1 - P) / nn_)
    assert not torch.equal(m10[:, 0], m10[:, 1])  # per head
    k = min(m10.shape[0], m20.shape[0])
    assert not torch.equal(m10[:k], m20[:k])  # per channel
    # a gat_loops graph: one (edge, loop) pair a head, each its own draw
    lg = _conv_graphs(world, True)[1]
    pairs = masks.gat(3, 0, lg, 2)
    assert [tuple(t.shape) for pr in pairs for t in pr] == [
        (lg.dst.shape[0],), (lg.num_nodes,)] * 2
    assert not torch.equal(pairs[0][0], pairs[1][0])
    # moved masks replay the same draws
    moved = masks.to("cpu")
    assert torch.equal(moved.gat(1, 0, None, 2), m10)

    # the trainer: a new draw each training step, none in an eval
    trainer = _trainer(th, loops=False)
    drawn = []
    orig = tpea.DropoutMasks.draw

    def spy(self, c, k, g, heads):
        out = orig(self, c, k, g, heads)
        drawn.append(out)
        return out

    tpea.DropoutMasks.draw = spy
    try:
        params = trainer.init(0)
        opt = trainer.optimizer(params)
        gen = torch.Generator().manual_seed(0)
        rows = torch.arange(256)
        for _ in range(2):
            trainer.train_step(params, opt, rows, torch.ones(256), gen)
        assert len(drawn) == 2 * 18
        assert not torch.equal(drawn[0], drawn[18])  # per step
        trainer.evaluate(params, torch.Generator().manual_seed(0))
        assert len(drawn) == 2 * 18
    finally:
        tpea.DropoutMasks.draw = orig


def test_streaming_kernels_skip_a_training_forward_with_dropout(world, monkeypatch):
    th = world[1]
    trainer = _trainer(th, loops=True)
    assert all(g.gat_loops for ch in trainer.graphs for g in ch)
    calls = []
    for name in ("stream_gat_fwd", "stream_gat_bwd_dst", "stream_gat_bwd_src"):
        fn = getattr(tsg, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(tsg, name, spy)
    params = trainer.init(0)
    opt = trainer.optimizer(params)
    gen = torch.Generator().manual_seed(0)
    losses = [float(trainer.train_step(params, opt, torch.arange(256), torch.ones(256), gen))
              for _ in range(2)]
    assert np.isfinite(losses).all()
    assert calls == []
    for p in params.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()
    trainer.evaluate(params, torch.Generator().manual_seed(0))
    assert "stream_gat_fwd" in calls
    calls.clear()
    nodrop = _trainer(th, loops=True, dropout=0.0)  # no dropout: the kernels train
    nodrop.train_step(params, nodrop.optimizer(params), torch.arange(256), torch.ones(256),
                      gen)
    assert {"stream_gat_fwd", "stream_gat_bwd_dst", "stream_gat_bwd_src"} <= set(calls)


def _fused(world, conv):
    jh, th = world[0], world[1]
    n = jh.num_nodes
    return (jgraph.build_fused_metapath_graphs(jml.mlsmall_metapath_edges(jh), n, conv),
            tgraph.build_fused_metapath_graphs(tml.mlsmall_metapath_edges(th), n, conv))


@pytest.mark.parametrize("heads", [1, 2])
def test_union_dropout_loss_matches_jax(world, heads):
    jh, th = world[0], world[1]
    n = jh.num_nodes
    kw = dict(SMALL, num_nodes=n, dropout=P, num_heads=heads)
    jcfg, tcfg = jpea.PEAConfig(**kw), tpea.PEAConfig(**kw)
    params = _trained_like(tparams.to_numpy(tpea.pea_init(torch.Generator().manual_seed(0),
                                                          tcfg)))
    batch, mask = _batch(th)
    key = jax.random.PRNGKey(5)
    jfused, tfused = _fused(world, "gat")
    for jg_, tg_ in zip(jfused, tfused):  # the masks fall on the same edges
        np.testing.assert_array_equal(np.asarray(jg_.src), tg_.src.numpy())
        np.testing.assert_array_equal(np.asarray(jg_.dst), tg_.dst.numpy())
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q: jpea.pea_loss(q, jfused, jcfg, jnp.asarray(batch),
                                row_mask=jnp.asarray(mask), training=True,
                                dropout_key=key)))(params)
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    model = tparams.from_jax_numpy(jax.tree_util.tree_map(np.asarray, params))
    masks = JaxMasks(P, key, 2)
    loss = tpea.pea_loss(model, tfused, tcfg, torch.from_numpy(batch),
                         row_mask=torch.from_numpy(mask), masks=masks)
    loss.backward()
    assert sorted(masks._drawn) == [(None, 0), (None, 1)]  # one mask a union step
    assert [tuple(m.shape) for m in masks._drawn.values()] == [
        (g.dst.shape[0], h) for g, h in zip(tfused, (heads, 1))]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    tgrads = _grad_leaves(model)
    assert jax.tree_util.tree_structure(tgrads) == jax.tree_util.tree_structure(jgrads)
    for t, j in zip(jax.tree_util.tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        assert t.shape == j.shape
        assert float(np.abs(t - j).max()) <= 1e-4 * max(float(np.abs(j).max()), 1e-30)
    with torch.no_grad():  # without dropout (the flash route) the loss moves
        plain = tpea.pea_loss(model, tfused, tcfg, torch.from_numpy(batch),
                              row_mask=torch.from_numpy(mask))
    assert abs(float(plain) - float(loss.detach())) > 1e-3 * abs(float(plain))


@pytest.mark.parametrize("conv", ["gcn", "sage"])
def test_union_masks_leave_gcn_and_sage_alone(world, conv):
    th = world[1]
    cfg = tpea.PEAConfig(num_nodes=th.num_nodes, **dict(SMALL, conv=conv, dropout=P))
    tfused = _fused(world, conv)[1]
    model = tpea.pea_init(torch.Generator().manual_seed(2), cfg)
    batch, mask = _batch(th, seed=2)
    b, m = torch.from_numpy(batch), torch.from_numpy(mask)
    masks = tpea.DropoutMasks(P, torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = tpea.pea_loss(model, tfused, cfg, b, row_mask=m)
        got = tpea.pea_loss(model, tfused, cfg, b, row_mask=m, masks=masks)
    assert float(got) == float(want)
    assert masks._drawn == {}
    # --parallel dp at a mesh of one builds and steps with dropout set
    sh = ShardedPEATrainer(th, cfg, TrainConfig(batch_size=96), mesh=make_pod_mesh(device="cpu"),
                           mode="dp")
    params = sh.init(2)
    loss = sh.loss_and_grads(params, b, m, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
