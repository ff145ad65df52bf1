"""Port parity for the baselines' models, engine modes, trainers, Solver and
CLI (NGCF, KGAT, KGCN, CFKG, NFM) against the JAX package on the CPU.

On the ``synthetic-ml`` HIN (392 nodes, 8 relations) at emb 16 / hidden 16,
JAX ``*_init`` weights go through models/params into the port, and one
batch that the port's trainer builds goes through both packages' losses:
* NGCF (f32, bf16 transport, entity-aware, dropout under the JAX package's
  own masks), KGAT and KGCN CF losses (f32, bf16, dropout) under the
  attention map, TransR, CFKG and NFM (with and without dropout): loss and
  every gradient leaf at the bars of tests/test_torch_gcn_sage_slice.py
  (f32 1e-5; bf16 1e-3, median leaf 1e-3, every leaf 5e-2; the bf16 JAX
  reference rounds its segment-sums as the TPU path at the baselines'
  sizes, test_torch_baselines._tpu_segment_sum).  NFM's masked BatchNorm
  statistics and the eval forward on running statistics at 1e-5; its
  statistics are buffers that no optimizer step decays.
* The engine's 'kg' and 'bce' batch columns, row counts and eval-loss
  forms; an 'mse' engine on the same tables (one row per rated
  interaction, the batch (pair, rating), its eval-loss form 'mse').
* One KG-phase step, in which the conv weights get no gradient, then one CF
  step, against the optax chain (JAX train/optim.py): every leaf, the conv
  weights moved by the weight decay as in optax, every Adam step count 2.
* One epoch of each trainer on the CPU; the Solver with a dict loss against
  the JAX Solver (stubs); cli.main for each model, an NFM resume that
  restores the BatchNorm buffers.
The JAX functions run under jax.jit at these tiny sizes; no JAX trainer
epoch is jitted.  Torch runs on one thread.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.eval import ranking as jrank
from graph_recsys_benchmark_tpu.models import cfkg as jcfkg
from graph_recsys_benchmark_tpu.models import kg as jkg
from graph_recsys_benchmark_tpu.models import nfm as jnfm
from graph_recsys_benchmark_tpu.models import ngcf as jngcf
from graph_recsys_benchmark_tpu.nn import conv as jconv
from graph_recsys_benchmark_tpu.ops import config as jconfig
from graph_recsys_benchmark_tpu.ops import gather as jgather
from graph_recsys_benchmark_tpu.train import baseline_trainers as jbt
from graph_recsys_benchmark_tpu.train.optim import make_optimizer as jmake_optimizer
from graph_recsys_benchmark_tpu.train.pea_trainer import TrainConfig as JTrainConfig
from graph_recsys_benchmark_tpu.train.solver import Solver as JSolver
from graph_recsys_benchmark_tpu_torch import cli as tcli
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.eval import ranking as trank
from graph_recsys_benchmark_tpu_torch.models import cfkg as tcfkg
from graph_recsys_benchmark_tpu_torch.models import kg as tkg
from graph_recsys_benchmark_tpu_torch.models import nfm as tnfm
from graph_recsys_benchmark_tpu_torch.models import ngcf as tngcf
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.train import baseline_trainers as tbt
from graph_recsys_benchmark_tpu_torch.train.engine import GraphEpochEngine
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import TrainConfig
from graph_recsys_benchmark_tpu_torch.train.solver import Solver as TSolver
from graph_recsys_benchmark_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_baselines import _tpu_segment_sum
from test_torch_solver import JaxStub, TorchStub, _log, _npz

EXACT_BF16 = {"xla_allow_excess_precision": False}
EMB = 16
TCFG = TrainConfig(batch_size=1024)
B, PAD = 96, 23  # batch rows, of which the last PAD are padding


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
    n = th.num_nodes
    typed = jbt._typed_edges(jh)
    src = np.concatenate([typed[:, 0], typed[:, 1]])
    dst = np.concatenate([typed[:, 1], typed[:, 0]])
    rel = np.concatenate([typed[:, 2], -typed[:, 2]])
    graphs = {"ngcf": jgraph.build_ngcf_graph(*jbt._bidirectional_user_item(jh), n),
              "kg": jgraph.build_kg_graph(src, dst, rel, n)}
    return jh, th, graphs


def _mask():
    m = np.ones(B, np.float32)
    m[B - PAD:] = 0.0
    return m


def _batch(trainer, seed=0):
    """B rows of the trainer's loss mode, built by the port's engine."""
    gen = torch.Generator().manual_seed(seed)
    rows = torch.randperm(trainer.n_rows, generator=gen)[:B]
    return trainer._build_batch(rows, gen).numpy()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _grads(module):
    """Every parameter's gradient, zeros where the loss did not reach it."""
    return {k: (np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy())
            for k, p in module.named_parameters()}


def _check(transport, tloss, jloss, tgrads, jgrads):
    """Loss and every gradient leaf at the slice's bars; a leaf whose exact
    gradient is 0 (NFM's fc1.b and bn0_bias, whose shifts the next
    BatchNorm removes) is held to 1e-6 of the largest gradient."""
    jgrads = _flat(jgrads)
    assert sorted(tgrads) == sorted(jgrads)
    tol = 1e-5 if transport == "f32" else 1e-3
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol)
    errs = []
    top = max(np.abs(j).max() for j in jgrads.values())
    for k, j in jgrads.items():
        t = tgrads[k]
        assert t.shape == j.shape and np.isfinite(t).all(), k
        if np.abs(j).max() <= 1e-6 * top:  # zero but for rounding noise
            assert np.abs(t).max() <= 1e-6 * top, k
            continue
        errs.append(float(np.abs(t - j).max() / np.abs(j).max()))
    errs.sort()
    if transport == "f32":
        assert errs[-1] <= 1e-5, errs
    else:
        assert errs[len(errs) // 2] <= 1e-3 and errs[-1] <= 5e-2, errs


def _tpu_path(monkeypatch, transport):
    monkeypatch.setattr(jconfig, "SEGSUM_TRANSPORT", transport)
    monkeypatch.setattr(jconv, "segment_sum_auto", _tpu_segment_sum)
    monkeypatch.setattr(jgather, "segment_sum_auto", _tpu_segment_sum)


class JaxMasks(tngcf.KeepMasks):
    """The JAX package's own dropout masks, layer i from key i of `keys`."""

    def __init__(self, p, keys):
        super().__init__(p)
        self.keys = keys

    def draw(self, i, shape):
        return torch.from_numpy(np.array(jax.random.bernoulli(self.keys[i], 1.0 - self.p,
                                                              shape)))


DKEY = jax.random.PRNGKey(7)


@pytest.mark.parametrize("transport,entity_aware,dropout", [
    ("f32", False, 0.0), ("bf16", False, 0.0), ("f32", True, 0.0), ("f32", False, 0.2)])
def test_ngcf_loss_and_grads_match_jax(world, monkeypatch, transport, entity_aware, dropout):
    jh, th, graphs = world
    kw = dict(num_nodes=th.num_nodes, emb_dim=EMB, hidden_size=EMB, dropout=dropout,
              entity_aware=entity_aware)
    jcfg, tcfg = jngcf.NGCFConfig(**kw), tngcf.NGCFConfig(**kw)
    trainer = tbt.NGCFTrainer(th, tcfg, TCFG, device="cpu", transport=transport)
    batch, mask = _batch(trainer), _mask()
    assert batch.shape[1] == (9 if entity_aware else 3)
    jp = jngcf.ngcf_init(jax.random.PRNGKey(0), jcfg)
    _tpu_path(monkeypatch, transport)
    key = DKEY if dropout else None
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jngcf.ngcf_loss(
        p, graphs["ngcf"], jcfg, jnp.asarray(batch), jnp.asarray(mask), training=True,
        dropout_key=key)), compiler_options=EXACT_BF16)(jp)
    model = tparams.ngcf_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp))
    masks = JaxMasks(dropout, jax.random.split(DKEY, 3)) if dropout else None
    loss = tngcf.ngcf_loss(model, trainer.graph, tcfg, torch.from_numpy(batch),
                           torch.from_numpy(mask), transport=transport, masks=masks)
    loss.backward()
    _check(transport, loss.detach(), jloss, _grads(model), jgrads)
    with torch.no_grad():
        rep = tngcf.ngcf_forward(model, trainer.graph, tcfg, transport=transport)
    jrep = np.asarray(jax.jit(lambda p: jngcf.ngcf_forward(p, graphs["ngcf"], jcfg),
                              compiler_options=EXACT_BF16)(jp))
    assert rep.shape == jrep.shape == (th.num_nodes, EMB + EMB // 2 + EMB // 4)
    assert np.abs(rep.numpy() - jrep).max() <= (1e-5 if transport == "f32" else 1e-3)


@pytest.mark.parametrize("variant,transport,dropout", [
    ("kgat", "f32", 0.0), ("kgat", "bf16", 0.0), ("kgcn", "f32", 0.0), ("kgcn", "bf16", 0.0),
    ("kgat", "f32", 0.2)])
def test_kg_cf_loss_and_grads_match_jax(world, monkeypatch, variant, transport, dropout):
    jh, th, graphs = world
    kw = dict(variant=variant, num_nodes=th.num_nodes, num_relations=th.num_edge_types,
              emb_dim=EMB, hidden_size=EMB, dropout=dropout)
    jcfg, tcfg = jkg.KGConfig(**kw), tkg.KGConfig(**kw)
    trainer = tbt.KGTrainer(th, tcfg, TCFG, device="cpu", transport=transport)
    batch, mask = _batch(trainer), _mask()
    jp = jkg.kg_init(jax.random.PRNGKey(1), jcfg)
    model = tparams.kg_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jatt = jax.jit(lambda p: jkg.compute_att_map(p, graphs["kg"], jcfg))(jp)
    att = trainer.att_snapshot(model)
    e = trainer.graph.num_edges
    np.testing.assert_allclose(att[:e].numpy(), np.asarray(jatt)[:e], rtol=1e-5, atol=1e-6)
    _tpu_path(monkeypatch, transport)
    key = DKEY if dropout else None
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jkg.kg_cf_loss(
        p, graphs["kg"], jcfg, jnp.asarray(att.numpy()), jnp.asarray(batch), jnp.asarray(mask),
        training=True, dropout_key=key)), compiler_options=EXACT_BF16)(jp)
    masks = JaxMasks(dropout, jax.random.split(DKEY, 3)) if dropout else None
    loss = tkg.kg_cf_loss(model, trainer.graph, tcfg, att, torch.from_numpy(batch),
                          torch.from_numpy(mask), transport=transport, masks=masks)
    loss.backward()
    grads = _grads(model)
    assert not grads["r"].any() and not grads["proj"].any()  # the map is frozen
    _check(transport, loss.detach(), jloss, grads, jgrads)


def test_transr_and_cfkg_losses_match_jax(world):
    jh, th, _ = world
    n, nr = th.num_nodes, th.num_edge_types
    kcfg = tkg.KGConfig(variant="kgat", num_nodes=n, num_relations=nr, emb_dim=EMB,
                        hidden_size=EMB)
    trainer = tbt.CFKGTrainer(th, tcfkg.CFKGConfig(n, nr, th.edge_type_dict["user2item"],
                                                   EMB), TCFG, device="cpu")
    batch, mask = _batch(trainer), _mask()
    assert batch.shape == (B, 4)
    # TransR (the KG phase of KGAT/KGCN)
    jcfg = jkg.KGConfig(**{f: getattr(kcfg, f) for f in ("variant", "num_nodes",
                                                           "num_relations", "emb_dim",
                                                           "hidden_size")})
    jp = jkg.kg_init(jax.random.PRNGKey(2), jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jkg.transr_kg_loss(p, jnp.asarray(batch), jnp.asarray(mask))))(jp)
    model = tparams.kg_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp))
    loss = tkg.transr_kg_loss(model, torch.from_numpy(batch), torch.from_numpy(mask))
    loss.backward()
    assert all(p.grad is None for k, p in model.named_parameters() if k.startswith("conv"))
    _check("f32", loss.detach(), jloss, _grads(model), jgrads)
    # CFKG: loss, gradients and the ranking score
    ccfg = trainer.cfg
    jc = jcfkg.cfkg_init(jax.random.PRNGKey(3), jcfkg.CFKGConfig(
        ccfg.num_nodes, ccfg.num_relations, ccfg.user2item_rel, EMB))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jcfkg.cfkg_kg_loss(p, jnp.asarray(batch), jnp.asarray(mask))))(jc)
    cmodel = tparams.cfkg_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jc))
    loss = tcfkg.cfkg_kg_loss(cmodel, torch.from_numpy(batch), torch.from_numpy(mask))
    loss.backward()
    _check("f32", loss.detach(), jloss, _grads(cmodel), jgrads)
    u, i = batch[:, 0], batch[:, 1]
    want = np.asarray(jcfkg.cfkg_predict(jc, ccfg, jnp.asarray(u), jnp.asarray(i)))
    with torch.no_grad():
        got = trainer.scorer(cmodel)(torch.from_numpy(u), torch.from_numpy(i))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_nfm_loss_grads_and_state_match_jax(world, dropout):
    jh, th, _ = world
    kw = dict(num_users=th.num_users, num_items=th.num_items, emb_dim=EMB, hidden_size=EMB,
              dropout=dropout)
    jcfg, tcfg = jnfm.NFMConfig(**kw), tnfm.NFMConfig(**kw)
    trainer = tbt.NFMTrainer(th, tcfg, TCFG, device="cpu")
    batch, mask = _batch(trainer), _mask()
    jt = jnfm.nfm_init(jax.random.PRNGKey(4), jcfg)
    key = DKEY if dropout else None
    (jloss, jstate), jgrads = jax.jit(jax.value_and_grad(lambda p: jnfm.nfm_mse_loss(
        {"params": p, "state": jt["state"]}, jcfg, jnp.asarray(batch), jnp.asarray(mask),
        dropout_key=key), has_aux=True))(jt["params"])
    model = tparams.nfm_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jt))
    masks = JaxMasks(dropout, jax.random.split(DKEY)) if dropout else None
    loss, state = tnfm.nfm_mse_loss(model, tcfg, torch.from_numpy(batch),
                                    torch.from_numpy(mask), masks=masks)
    loss.backward()
    _check("f32", loss.detach(), jloss, _grads(model), jgrads)
    for k in tnfm.STATE:  # masked batch statistics, unbiased running variance
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]), rtol=1e-5,
                                   atol=1e-7)
    # the eval forward on the new running statistics
    jt2 = {"params": jt["params"], "state": jstate}
    model.set_state(state)
    u, i = torch.from_numpy(batch[:, 0]), torch.from_numpy(batch[:, 1])
    want = np.asarray(jnfm.nfm_forward(jt2, jcfg, jnp.asarray(batch[:, 0]),
                                       jnp.asarray(batch[:, 1]))[0])
    with torch.no_grad():
        got = tnfm.nfm_forward(model, tcfg, u, i)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    back = tparams.nfm_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jt))


def test_nfm_state_is_buffers_that_no_step_decays(world):
    th = world[1]
    cfg = tnfm.NFMConfig(th.num_users, th.num_items, emb_dim=8, hidden_size=8)
    trainer = tbt.NFMTrainer(th, cfg, TrainConfig(batch_size=256, weight_decay=0.5),
                             device="cpu")
    model = trainer.init(0)
    names = {k for k, _ in model.named_parameters()}
    assert not names & set(tnfm.STATE) and set(tnfm.STATE) <= set(model.state_dict())
    opt = trainer.optimizer(model)
    assert sum(p.numel() for g in opt.param_groups for p in g["params"]) == sum(
        p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(0)
    rows, mask = torch.arange(256), torch.ones(256)
    batch = trainer._build_batch(rows, gen)
    with torch.no_grad():
        _, want = tnfm.nfm_mse_loss(model, cfg, batch, mask,
                                    masks=tngcf.KeepMasks(cfg.dropout, gen))
    trainer.train_step(model, opt, rows, mask, torch.Generator().manual_seed(0))
    for k in tnfm.STATE:
        assert torch.equal(getattr(model, k), want[k]), k
    assert not torch.equal(model.bn0_var, torch.ones_like(model.bn0_var))


def test_engine_batch_columns_and_rows(world):
    jh, th, _ = world
    n, nr = th.num_nodes, th.num_edge_types
    ei = th.train_pos.shape[0]
    jtc = JTrainConfig()
    cf = tbt.CFKGTrainer(th, tcfkg.CFKGConfig(n, nr, 7, 8), TCFG, device="cpu")
    nf = tbt.NFMTrainer(th, tnfm.NFMConfig(th.num_users, th.num_items, 8, 8), TCFG,
                        device="cpu")
    ng = tbt.NGCFTrainer(th, tngcf.NGCFConfig(n, 8, 8, entity_aware=True), TCFG,
                         device="cpu")
    kg = tbt.KGTrainer(th, tkg.KGConfig("kgcn", n, nr, 8, 8), TCFG, device="cpu")
    jcf = jbt.CFKGTrainer(jh, jcfkg.CFKGConfig(n, nr, 7, 8), jtc)
    jnf = jbt.NFMTrainer(jh, jnfm.NFMConfig(th.num_users, th.num_items, 8, 8), jtc)
    jkt = jbt.KGTrainer(jh, jkg.KGConfig("kgcn", n, nr, 8, 8), jtc)
    for t, j in ((cf, jcf), (nf, jnf), (kg, jkt)):
        assert (t.n_rows, t.num_batches, t.eval_loss_form) == (j.n_rows, j.num_batches,
                                                               j.eval_loss_form)
    assert (kg.kg_rows, kg.kg_batches) == (jkt.kg_rows, jkt.kg_batches)
    assert cf.n_rows == 4289 and nf.n_rows == 5 * ei and ng.n_rows == 4 * ei
    assert (ng.eval_loss_form, nf.mf_offsets) == ("bpr", jnf.mf_offsets)
    np.testing.assert_array_equal(kg.kg_edges.numpy(), np.asarray(jkt.kg_edges))
    gen = torch.Generator().manual_seed(0)
    # kg: (h, t, uniform tail, rel) of the typed edges
    rows = torch.randperm(cf.n_rows, generator=gen)[:512]
    b = cf._build_batch(rows, gen)
    e = cf.kg_edges[rows].long()
    assert torch.equal(b[:, [0, 1, 3]], e) and b[:, 2].min() >= 0 and b[:, 2].max() < n
    # bce: the positives (label 1) then negatives (label 0), 0-based ids
    rows = torch.cat([torch.arange(300), ei + torch.arange(300)])
    b = nf._build_batch(rows, gen)
    u_lo, i_lo = nf.mf_offsets
    tp = torch.from_numpy(th.train_pos)
    assert torch.equal(b[:300, 2], torch.ones(300, dtype=b.dtype)) and not b[300:, 2].any()
    assert torch.equal(b[:300, :2], tp[:300] - torch.tensor([u_lo, i_lo]))
    assert torch.equal(b[300:, 0], tp[:300, 0] - u_lo)
    assert b[:, 0].max() < th.num_users and b[:, 1].min() >= 0 and b[:, 1].max() < th.num_items
    seen = {(int(u), int(i)) for u, i in th.train_pos}
    assert not any((int(u) + u_lo, int(i) + i_lo) in seen for u, i in b[300:, :2])
    # bpr with the entity-aware columns
    b = ng._build_batch(torch.arange(64), gen)
    assert b.shape == (64, 9) and torch.equal(b[:, :2], tp[:64])
    # mse: one row per rated interaction, (pair, rating) with no sampling
    mse = GraphEpochEngine(ng.tables, TCFG, ng.batch_loss, loss_mode="mse")
    assert (mse.n_rows, mse.eval_loss_form) == (ei, "mse")
    pair, rating = mse._build_batch(torch.arange(64), gen)
    assert torch.equal(pair, tp[:64]) and torch.equal(rating, torch.from_numpy(th.ratings[:64]))


@pytest.mark.parametrize("form", ["bpr", "bce", "mse", "zero"])
def test_eval_loss_forms_match_jax(form):
    rng = np.random.default_rng(5)
    pos = rng.normal(size=40).astype(np.float32)
    neg = rng.normal(size=(40, 99)).astype(np.float32)
    want = np.asarray(jrank.eval_loss_per_user(jnp.asarray(pos), jnp.asarray(neg), form))
    got = trank.eval_loss_per_user(torch.from_numpy(pos), torch.from_numpy(neg), form)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_kg_phase_adam_step_moves_every_leaf_as_optax(world):
    """Step 1 (TransR) reaches x, r and proj only; optax still decays and
    moves the conv weights (their Adam moments see wd * w) and counts one
    global step.  Step 2 is a CF step under the map of the new weights."""
    jh, th, graphs = world
    kw = dict(variant="kgat", num_nodes=th.num_nodes, num_relations=th.num_edge_types,
              emb_dim=EMB, hidden_size=EMB)
    jcfg, tcfg = jkg.KGConfig(**kw), tkg.KGConfig(**kw)
    tc = TrainConfig(batch_size=B, lr=1e-2, weight_decay=1e-2)
    trainer = tbt.KGTrainer(th, tcfg, tc, device="cpu")
    gen = torch.Generator().manual_seed(0)
    kg_batch = trainer._kg_batch(torch.randperm(trainer.kg_rows, generator=gen)[:B], gen)
    cf_batch = _batch(trainer)
    mask = torch.from_numpy(_mask())
    jp = jkg.kg_init(jax.random.PRNGKey(6), jcfg)
    model = tparams.kg_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp))
    conv0 = model.conv1["w_add"].detach().clone()

    opt = trainer.optimizer(model)
    trainer._step(model, opt, lambda: tkg.transr_kg_loss(model, kg_batch, mask))
    assert not torch.equal(model.conv1["w_add"], conv0)
    att = trainer.att_snapshot(model)
    trainer._step(model, opt, lambda: tkg.kg_cf_loss(model, trainer.graph, tcfg, att,
                                                     torch.from_numpy(cf_batch), mask))
    assert {int(s["step"]) for s in opt.state.values()} == {2}
    assert len(opt.state) == len(list(model.parameters()))

    jopt = jmake_optimizer("adam", tc.lr, tc.weight_decay)
    jm = jnp.asarray(mask.numpy())

    @jax.jit
    def two_steps(p):
        state = jopt.init(p)
        g1 = jax.grad(lambda q: jkg.transr_kg_loss(q, jnp.asarray(kg_batch.numpy()), jm))(p)
        upd, state = jopt.update(g1, state, p)
        p = optax.apply_updates(p, upd)
        att = jkg.compute_att_map(p, graphs["kg"], jcfg)
        g2 = jax.grad(lambda q: jkg.kg_cf_loss(q, graphs["kg"], jcfg, att,
                                               jnp.asarray(cf_batch), jm))(p)
        upd, state = jopt.update(g2, state, p)
        return optax.apply_updates(p, upd), state

    jp, state = two_steps(jp)
    jp = _flat(jp)
    mu, nu = _flat(state[1].mu), _flat(state[1].nu)
    assert int(state[1].count) == 2
    for k, p in model.named_parameters():
        st = opt.state[p]
        for got, want in ((st["exp_avg"], mu[k]), (st["exp_avg_sq"], nu[k])):
            assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max(), k
        # Adam's m / sqrt(v) magnifies a gradient's rounding where the
        # gradient is near 0: the weights to 0.2 % of a step
        np.testing.assert_allclose(p.detach().numpy(), jp[k], rtol=1e-5,
                                   atol=2e-3 * tc.lr, err_msg=k)


@pytest.mark.parametrize("model", ["NGCF", "KGCN", "CFKG", "NFM"])
def test_trainer_epoch_on_cpu(world, model):
    th = world[1]
    n, nr = th.num_nodes, th.num_edge_types
    make = {
        "NGCF": lambda: tbt.NGCFTrainer(th, tngcf.NGCFConfig(n, 8, 8, dropout=0.1), TCFG,
                                        device="cpu"),
        "KGCN": lambda: tbt.KGTrainer(th, tkg.KGConfig("kgcn", n, nr, 8, 8, dropout=0.1),
                                      TCFG, device="cpu"),
        "CFKG": lambda: tbt.CFKGTrainer(th, tcfkg.CFKGConfig(n, nr, 7, 8), TCFG, device="cpu"),
        "NFM": lambda: tbt.NFMTrainer(th, tnfm.NFMConfig(th.num_users, th.num_items, 8, 8),
                                      TCFG, device="cpu"),
    }[model]
    trainer = make()
    params = trainer.init(0)
    opt = trainer.optimizer(params)
    gen = torch.Generator().manual_seed(0)
    out = trainer.run_epoch(params, opt, gen)
    if model == "KGCN":
        assert set(out) == {"train_loss", "kg_train_loss"}
        assert np.isfinite(float(out["kg_train_loss"]))
        out = out["train_loss"]
    assert out.dim() == 0 and np.isfinite(float(out))
    m = trainer.evaluate(params, gen)
    assert m["HR"].shape == (16,) and 0.0 <= float(m["HR"][5]) <= 1.0
    assert np.isfinite(float(m["AUC"])) and np.isfinite(float(m["eval_loss"]))
    if model == "CFKG":
        assert float(m["eval_loss"]) == 0.0
    full = trainer.evaluate_full(params)
    assert full["HR"].shape == (16,)


class JaxDictStub(JaxStub):
    def run_epoch(self, params, opt_state, key):
        p, o, loss = super().run_epoch(params, opt_state, key)
        return p, o, {"train_loss": loss, "kg_train_loss": loss * np.float32(0.5)}


class TorchDictStub(TorchStub):
    def run_epoch(self, params, optimizer, generator):
        loss = super().run_epoch(params, optimizer, generator)
        return {"train_loss": loss, "kg_train_loss": loss * 0.5}


def test_solver_takes_a_dict_loss_as_jax(tmp_path):
    args = dict(runs=2, epochs=3, save_epochs=(1,), save_every_epoch=1)
    JSolver(JaxDictStub(), str(tmp_path / "jax"), **args).run()
    TSolver(TorchDictStub(), str(tmp_path / "torch"), **args).run()
    log = _log(tmp_path / "torch")
    assert log == _log(tmp_path / "jax")
    assert sum("kg train loss: " in ln for ln in log) == 6
    jz, tz = _npz(tmp_path / "jax"), _npz(tmp_path / "torch")
    for k in jz:
        np.testing.assert_array_equal(jz[k], tz[k])
    ck = torch.load(tmp_path / "torch" / "run_2" / "latest.ckpt", weights_only=True)
    np.testing.assert_allclose(ck["rec_metrics"]["kg_train_loss"].numpy(),
                               0.5 * ck["rec_metrics"]["train_loss"].numpy(), rtol=1e-6)


SMALL = ["--emb_dim", "8", "--hidden_size", "8", "--runs", "1", "--epochs", "1",
         "--device", "cpu"]


@pytest.mark.parametrize("model,extra", [
    ("NGCF", ["--entity_aware", "true"]), ("KGAT", ["--message_dtype", "bf16"]),
    ("KGCN", []), ("CFKG", []), ("NFM", ["--save_every_epoch", "0"])])
def test_main_runs_each_baseline(model, extra, tmp_path, capsys):
    argv = ["--model", model] + SMALL + extra + ["--out_dir", str(tmp_path / "runs"),
                                                 "--cache_dir", str(tmp_path / "cache")]
    overall = tcli.main(argv)
    assert np.isfinite(np.ravel(overall["HR"])).all() and 0.0 <= overall["HR"][5] <= 1.0
    assert "Overall HR@10:" in capsys.readouterr().out
    args = tcli.build_parser().parse_args(argv)
    hin, mp = tcli.load_hin(args)
    trainer, n = tcli.build_trainer(args, hin, mp)
    assert n == 0 and trainer.device.type == "cpu"
    folder = tcli.run_dir(args, hin)
    with open(os.path.join(folder, "logger_file.txt")) as f:
        text = f.read()
    assert ("kg train loss: " in text) == (model in ("KGAT", "KGCN"))
    if model == "KGAT":
        assert trainer.transport == "bf16"
    if model == "NFM":  # dropout 0.3 by default; the resume restores the buffers
        assert trainer.cfg.dropout == 0.3
        saved = torch.load(os.path.join(folder, "run_1", "latest.ckpt"),
                           weights_only=True)["params"]
        fresh = trainer.init(2020)
        assert torch.equal(fresh.bn1_var, torch.ones_like(fresh.bn1_var))
        load_checkpoint(os.path.join(folder, "run_1", "latest.ckpt"), fresh,
                        trainer.optimizer(fresh))
        for k in tnfm.STATE:
            assert torch.equal(getattr(fresh, k), saved[k]) and not torch.equal(
                getattr(fresh, k), getattr(trainer.init(2020), k)), k


@pytest.mark.parametrize("family", ["ngcf", "kgat", "kgcn", "cfkg", "nfm"])
def test_converters_round_trip_and_init_layout(world, family):
    """models/params carries each family's JAX tree both ways exactly, and
    the port's *_init draws the JAX layout (shapes, dtypes, names)."""
    th = world[1]
    n, nr = th.num_nodes, th.num_edge_types
    key = jax.random.PRNGKey(8)
    gen = torch.Generator().manual_seed(0)
    if family == "ngcf":
        tree = jngcf.ngcf_init(key, jngcf.NGCFConfig(n, EMB, EMB))
        conv = (tparams.ngcf_from_jax_numpy, tparams.ngcf_to_numpy)
        port = tngcf.ngcf_init(gen, tngcf.NGCFConfig(n, EMB, EMB))
    elif family in ("kgat", "kgcn"):
        tree = jkg.kg_init(key, jkg.KGConfig(family, n, nr, EMB, EMB))
        conv = (tparams.kg_from_jax_numpy, tparams.kg_to_numpy)
        port = tkg.kg_init(gen, tkg.KGConfig(family, n, nr, EMB, EMB))
    elif family == "cfkg":
        tree = jcfkg.cfkg_init(key, jcfkg.CFKGConfig(n, nr, 7, EMB))
        conv = (tparams.cfkg_from_jax_numpy, tparams.cfkg_to_numpy)
        port = tcfkg.cfkg_init(gen, tcfkg.CFKGConfig(n, nr, 7, EMB))
    else:
        tree = jnfm.nfm_init(key, jnfm.NFMConfig(th.num_users, th.num_items, EMB, EMB))
        conv = (tparams.nfm_from_jax_numpy, tparams.nfm_to_numpy)
        port = tnfm.nfm_init(gen, tnfm.NFMConfig(th.num_users, th.num_items, EMB, EMB))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    back = conv[1](conv[0](tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    drawn = conv[1](port)
    assert jax.tree_util.tree_structure(drawn) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(drawn)):
        assert a.shape == b.shape and a.dtype == b.dtype
