"""Port parity for slice 3 as a whole: PEAGCN and PEASage on the fused
union-graph path (``pea_forward_fused``), forward, loss and every gradient.

On a small HIN (the other slices' world) both packages build the fused
metapath graphs, which must be equal array for array.  JAX ``pea_init``
weights, moved off the init regime as test_torch_train_slice.py does, go
through the converter into the port; ``pea_forward`` and the entity-aware
``pea_loss`` with a partial row mask are held against the JAX package, and
every gradient against ``jax.value_and_grad``.  Off the TPU the JAX package
runs its XLA paths, whose rounding points are the kernels' (the messages
cast by ``msg_cast``, f32 sums, the gather's cotangent cast back to the
primal dtype).  The JAX side is compiled with ``xla_allow_excess_precision``
off: by default XLA's CPU compiler may keep excess precision across a bf16
cast and round at fewer points than the same JAX code does op by op
(measured here: GCN's median gradient leaf 2.6e-3 off with it on, 1.3e-6
with it off or op by op).  f32: forward and loss 1e-5 relative, every
gradient 1e-5 of its largest value.  bf16 transport, against the JAX package's own bf16 path
(``SEGSUM_TRANSPORT = "bf16"``): forward and loss 1e-3, the median gradient
leaf 1e-3 and every leaf 5e-2 (sums in another order can move one bf16
rounding of a scattered gradient row, and a ReLU input at 0 its node's
contribution).  The GAT conv on the fused graphs is held in f32 (forward).
A tiny epoch runs on the CPU for each conv.
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
from graph_recsys_benchmark_tpu.ops import config as jconfig
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.models import pea as tpea
from graph_recsys_benchmark_tpu_torch.train import sampling as tsamp
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

RAW = dict(seed=3, num_users=80, num_items=100)
SMALL = dict(meta_path_steps=(2,) * 9, emb_dim=16, hidden_size=16, repr_dim=8,
             entity_aware=True)
CONVS = ("gcn", "sage")
EXACT_BF16 = {"xla_allow_excess_precision": False}
FIELDS = ("src", "dst", "w", "rel", "src_perm", "src_sorted")


@pytest.fixture(scope="module")
def world():
    kw = dict(num_core=5, num_feat_core=3)
    jh = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(**RAW), **kw)
    th = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**RAW), **kw)
    n = jh.num_nodes
    graphs = {}
    for conv in CONVS + ("gat",):
        graphs[conv] = (
            jgraph.build_fused_metapath_graphs(jml.mlsmall_metapath_edges(jh), n, conv),
            tgraph.build_fused_metapath_graphs(tml.mlsmall_metapath_edges(th), n, conv),
        )
    return jh, th, graphs


@pytest.mark.parametrize("conv", CONVS + ("gat",))
def test_fused_graphs_equal_jax(world, conv):
    jg, tg = world[2][conv]
    assert len(jg) == len(tg) == 2
    for a, b in zip(jg, tg):
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f).numpy(),
                                          err_msg=f)
            assert getattr(b, f).dtype == (torch.float32 if f == "w" else torch.int32)
        assert (a.num_nodes, a.num_edges, a.src_span) == (b.num_nodes, b.num_edges, b.src_span)


@pytest.fixture(scope="module")
def jax_params(world):
    """JAX pea_init weights per conv, moved off the init regime."""
    n = world[0].num_nodes
    return {conv: _trained_like(jpea.pea_init(jax.random.PRNGKey(0),
                                              jpea.PEAConfig(conv=conv, num_nodes=n, **SMALL)))
            for conv in CONVS}


def _trained_like(params):
    """Off the init regime (test_torch_train_slice.py:_trained_like): at init
    fc1's bias alone sets the ReLU masks and the user representations'
    gradients vanish to float noise."""
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


def _grad_tree(m):
    def g(layer):
        return {k: v.grad.numpy() for k, v in layer.items()}

    return {"x": m.x.grad.numpy(), "att": m.att.grad.numpy(),
            "channels": tuple(tuple(g(layer) for layer in ch) for ch in m.channels),
            "fc1": g(m.fc1), "fc2": g(m.fc2)}


def _leaf_errors(tgrads, jgrads):
    """Per-leaf max error over the JAX leaf's largest value; leaves that are
    exactly zero in JAX (fc2's bias cancels in pos − neg) must be zero."""
    assert jax.tree_util.tree_structure(tgrads) == jax.tree_util.tree_structure(jgrads)
    errs = []
    for t, j in zip(jax.tree_util.tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        assert t.shape == j.shape and np.isfinite(t).all()
        if not j.any():
            assert not t.any()
            continue
        errs.append(float(np.abs(t - j).max() / np.abs(j).max()))
    return sorted(errs)


@pytest.mark.parametrize("transport", ["f32", "bf16"])
@pytest.mark.parametrize("conv", CONVS)
def test_forward_loss_and_grads_match_jax(world, jax_params, monkeypatch, conv, transport):
    jh, th, graphs = world
    jg, tg = graphs[conv]
    n = jh.num_nodes
    jcfg = jpea.PEAConfig(conv=conv, num_nodes=n, **SMALL)
    tcfg = tpea.PEAConfig(conv=conv, num_nodes=n, **SMALL)
    params = jax_params[conv]
    batch, mask = _batch(th)
    monkeypatch.setattr(jconfig, "SEGSUM_TRANSPORT", transport)  # read at trace time

    def fwd_loss_grads(p):
        loss, grads = jax.value_and_grad(
            lambda q: jpea.pea_loss(q, jg, jcfg, jnp.asarray(batch), row_mask=jnp.asarray(mask))
        )(p)
        return jpea.pea_forward(p, jg, jcfg), loss, grads

    jrep, jloss, jgrads = jax.tree_util.tree_map(
        np.asarray, jax.jit(fwd_loss_grads, compiler_options=EXACT_BF16)(params))

    model = tparams.from_jax_numpy(jax.tree_util.tree_map(np.asarray, params))
    for layer in model.channels[0]:  # the layer dicts of this conv
        assert set(layer) == ({"w", "b"} if conv == "gcn" else {"w_rel", "b_rel", "w_root"})
    with torch.no_grad():
        trep = tpea.pea_forward(model, tg, tcfg, transport=transport)
    loss = tpea.pea_loss(model, tg, tcfg, torch.from_numpy(batch),
                         row_mask=torch.from_numpy(mask), transport=transport)
    loss.backward()
    tol = 1e-5 if transport == "f32" else 1e-3
    assert trep.shape == jrep.shape
    assert np.abs(trep.numpy() - jrep).max() <= tol * np.abs(jrep).max()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=tol)
    errs = _leaf_errors(_grad_tree(model), jgrads)
    if transport == "f32":
        assert errs[-1] <= 1e-5, errs
    else:
        assert errs[len(errs) // 2] <= 1e-3 and errs[-1] <= 5e-2, errs


@pytest.mark.parametrize("conv", CONVS)
def test_converter_and_init_layout(world, jax_params, conv):
    """models/params carries GCN's {w, b} and SAGE's {w_rel, b_rel,
    w_root} layers both ways exactly, and the port's pea_init draws the JAX
    layout for each conv."""
    tree = jax.tree_util.tree_map(np.asarray, jax_params[conv])
    back = tparams.to_numpy(tparams.from_jax_numpy(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    cfg = tpea.PEAConfig(conv=conv, num_nodes=world[0].num_nodes, **SMALL)
    port = tparams.to_numpy(tpea.pea_init(torch.Generator().manual_seed(0), cfg))
    assert jax.tree_util.tree_structure(port) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(port)):
        assert a.shape == b.shape and a.dtype == b.dtype
    if conv == "gcn":  # zero biases, as PyG's GCNConv
        assert not port["channels"][0][0]["b"].any()


def test_gat_on_fused_graphs_matches_jax(world):
    """pea_forward dispatches a tuple of StepGraphs to the fused path for
    GAT too (one union flash pass a step)."""
    jh, _, graphs = world
    jg, tg = graphs["gat"]
    cfg = dict(conv="gat", num_nodes=jh.num_nodes, **SMALL)
    params = jpea.pea_init(jax.random.PRNGKey(1), jpea.PEAConfig(**cfg))
    want = np.asarray(jax.jit(lambda p: jpea.pea_forward(p, jg, jpea.PEAConfig(**cfg)))(params))
    model = tparams.from_jax_numpy(jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tpea.pea_forward(model, tg, tpea.PEAConfig(**cfg)).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


@pytest.mark.parametrize("conv", CONVS)
def test_run_epoch_on_cpu(world, conv):
    """A tiny epoch end to end on the CPU through the trainer, which builds
    the fused graphs itself: a finite mean loss that falls in the second."""
    th = world[1]
    cfg = tpea.PEAConfig(conv=conv, num_nodes=th.num_nodes, **SMALL)
    trainer = PEATrainer(th, cfg, TrainConfig(batch_size=1000, num_negative_samples=1,
                                              lr=1e-2), device="cpu")
    for a, b in zip(trainer.graphs, world[2][conv][1]):
        assert torch.equal(a.dst, b.dst) and torch.equal(a.w, b.w)
    params = trainer.init(0)
    opt = trainer.optimizer(params)
    gen = torch.Generator().manual_seed(0)
    first = trainer.run_epoch(params, opt, gen)
    second = trainer.run_epoch(params, opt, gen)
    assert torch.isfinite(first) and torch.isfinite(second)
    assert float(second) < float(first)
    res = trainer.evaluate(params, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(res[k]).all() for k in ("HR", "NDCG", "AUC"))
    mixed = tpea.PEAConfig(conv=conv, num_nodes=th.num_nodes,
                           **dict(SMALL, meta_path_steps=(2,) * 8 + (1,)))
    with pytest.raises(NotImplementedError):  # the per-channel path
        PEATrainer(th, mixed, TrainConfig(), device="cpu")
