"""Port parity for slice 4 as a whole: PEAGAT at the ML-25M scale's
structure (13 two-step metapath channels, implicit self-loops, rejection
sampling) on a small synthetic ML-25M HIN.

Both packages build the HIN straight from numpy (data/synthetic.py
``synthetic_ml25m_hin``), the rejection tables, the 13 metapaths and the
per-channel GAT graphs; all must be equal array for array, and identical
step lists must be one graph object in both.  ``sample_complement``'s map
from a uniform index to an unseen item is compared bitwise for the same
indices; the draws are held to distribution parity (never a seen item,
uniform over the complement).

The slice: ``pea_init`` weights (the port's, in the JAX layout), moved off
the init regime as test_torch_train_slice.py does, go through the
converter into the port,
and ``pea_loss`` (entity-aware, a partial row mask) and every gradient are
held against ``jax.value_and_grad`` in f32 on two graph layouts:
  * "stream": every step graph loop-free (``_analytic_gat_loops = True``),
    so every conv runs the streaming GAT (K9-K11; shares of 2 and 7
    channels batched);
  * "mixed": the auto rule with the threshold lowered so that, as at the
    ML-25M scale, the u2i and i2u graphs stream and the rest run the
    composed GAT (K8 softmax, gather_src, gather_dst, K5).
Off the TPU the JAX package runs ``stream_gat_reference`` (exact max, f32)
and the XLA composed path; the port runs the kernels' plain versions
(bound-shift softmax).  f32: loss 1e-6 and every gradient 2e-5 of its
largest value (the shifts differ, so the exps round apart; measured
1.1e-7 and 2.4e-6).  A third layout, "composed" (every graph with its
self-loops as edges, so every conv runs the composed GAT), is held in
bf16 transport at the GCN/SAGE slice's bf16 bar (loss 1e-3, the median
gradient leaf 1e-3, every leaf 5e-2; measured: loss equal, 5.0e-4 and
1.6e-2).  A few training steps and one evaluation run on the CPU
through the trainer.
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
from graph_recsys_benchmark_tpu.ops import stream_gat as jstream
from graph_recsys_benchmark_tpu.train import sampling as jsamp
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.models import pea as tpea
from graph_recsys_benchmark_tpu_torch.train import sampling as tsamp
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

HIN = dict(num_users=400, num_items=300, target_interactions=8000, num_core=3,
           num_directors=20, num_actors=40, num_writers=20, num_tags=30,
           num_genome_tags=40, tagging_rows=1500)
SMALL = dict(meta_path_steps=(2,) * 13, emb_dim=16, hidden_size=16, repr_dim=8,
             entity_aware=True)
FIELDS = ("src", "dst", "w", "rel", "src_perm", "src_sorted")
# "mixed": the 7,8xx-edge u2i / i2u graphs stream, the <= 1,500-edge rest not
MIXED_THRESHOLD = 4000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run hundreds of small CPU ops; beside the other pytest
    workers, torch's intra-op threads oversubscribe the cores and slow
    every worker (measured: the CPU steps here 2.4 s alone, 39 s in the
    suite).  One thread for this module; the old count comes back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    jh, th = jsyn.synthetic_ml25m_hin(**HIN), tsyn.synthetic_ml25m_hin(**HIN)
    return jh, th


def test_hin_and_tables_equal_jax(world):
    jh, th = world
    assert jh.num_nodes == th.num_nodes == 880
    assert jh.type_accs == th.type_accs and jh.num_nodes_dict == th.num_nodes_dict
    assert list(jh.edge_index) == list(th.edge_index)
    for k in jh.edge_index:
        np.testing.assert_array_equal(jh.edge_index[k], th.edge_index[k], err_msg=k)
    for a, b in ((jh.train_pos, th.train_pos), (jh.ratings, th.ratings)):
        np.testing.assert_array_equal(a, b)
    for f in ("test_users", "seen", "seen_counts"):
        np.testing.assert_array_equal(getattr(jh.candidates, f), getattr(th.candidates, f))
    for f in ("item_feat", "item_feat_counts", "user_feat", "user_feat_counts", "ent_lo",
              "ent_hi"):
        np.testing.assert_array_equal(getattr(jh.entity_feats, f), getattr(th.entity_feats, f))
    for jm, tm in zip(jml.ml25m_metapath_edges(jh), tml.ml25m_metapath_edges(th),
                      strict=True):
        for (js, jd), (ts, td) in zip(jm, tm, strict=True):
            np.testing.assert_array_equal(js, ts)
            np.testing.assert_array_equal(jd, td)
    jt, tt = jsamp.build_device_tables(jh), tsamp.build_device_tables(th, "cpu")
    assert jt.mode == tt.mode == "rejection"
    for f in ("train_pos", "test_users", "test_items", "seen_all", "seen_train", "cnt_all",
              "cnt_train"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)), getattr(tt, f).numpy(),
                                      err_msg=f)


def _per_channel(world, layout, monkeypatch):
    """Both packages' per-channel GAT graphs for `layout` 'stream' (every
    graph loop-free), 'mixed' (the auto rule at MIXED_THRESHOLD) or
    'composed' (every graph with its self-loops as edges)."""
    jh, th = world
    analytic = {"stream": True, "mixed": None, "composed": False}[layout]
    if layout == "mixed":
        monkeypatch.setattr(jstream, "STREAM_MIN_EDGES", MIXED_THRESHOLD)
        monkeypatch.setattr(tgraph, "STREAM_MIN_EDGES", MIXED_THRESHOLD)
    jg = jgraph.build_metapath_graphs(jml.ml25m_metapath_edges(jh), jh.num_nodes, "gat",
                                      analytic_gat_loops=analytic)
    tg = tgraph.build_metapath_graphs(tml.ml25m_metapath_edges(th), th.num_nodes, "gat",
                                      analytic_gat_loops=analytic)
    return jg, tg


@pytest.mark.parametrize("layout", ["stream", "mixed"])
def test_per_channel_graphs_equal_jax(world, monkeypatch, layout):
    jg, tg = _per_channel(world, layout, monkeypatch)
    for k in range(2):
        jids = [id(ch[k]) for ch in jg]
        tids = [id(ch[k]) for ch in tg]
        # the same channels share one graph object (the dedup identity)
        assert [jids.index(i) for i in jids] == [tids.index(i) for i in tids]
        for jc, tc in zip(jg, tg):
            a, b = jc[k], tc[k]
            for f in FIELDS:
                np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f).numpy(),
                                              err_msg=f)
            assert (a.num_nodes, a.num_edges, a.src_span, a.gat_loops) == (
                b.num_nodes, b.num_edges, b.src_span, b.gat_loops)
    loops = [[g.gat_loops for g in ch] for ch in tg]
    if layout == "mixed":  # u2i (channels 0, 9, 10) and i2u (0-6, 9) stream
        assert loops[0] == [True, True] and loops[9] == [True, True]
        assert loops[1] == [False, True] and loops[7] == [False, False]
    else:
        assert all(all(ch) for ch in loops)


def test_complement_map_matches_jax(world):
    """The same uniform indices through both packages' maps (JAX:
    sample_complement's loop, fed the indices its key draws), bitwise; the
    port's draws never hit a seen item and spread evenly over the
    complement."""
    jt = jsamp.build_device_tables(world[0])
    tt = tsamp.build_device_tables(world[1], "cpu")
    key = jax.random.PRNGKey(3)
    u = jt.test_users.shape[0]
    u_local = jnp.arange(u, dtype=jnp.int32)
    want = jsamp.sample_complement(key, u_local, jt.seen_all, jt.cnt_all, jt.num_items,
                                   (u, 99))
    free = (jt.num_items - jt.cnt_all)[:, None]
    idx = jnp.minimum(jnp.floor(jax.random.uniform(key, (u, 99)) * free.astype(jnp.float32))
                      .astype(jnp.int32), free - 1)
    got = tsamp.complement_map(torch.from_numpy(np.array(idx)), tt.seen_all, tt.cnt_all)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = tsamp.complement_map(torch.from_numpy(np.array(idx[:, 0])), tt.seen_all,
                                tt.cnt_all)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want)[:, 0])
    # distribution: user 0's draws over its unseen items
    gen = torch.Generator().manual_seed(0)
    draws = tsamp.sample_complement(gen, torch.zeros(1, dtype=torch.int32), tt.seen_train,
                                    tt.cnt_train, tt.num_items, (1, 60000))[0].numpy()
    seen = set(tt.seen_train[0, : tt.cnt_train[0]].tolist())
    counts = np.bincount(draws, minlength=tt.num_items)
    assert not any(counts[i] for i in seen)
    unseen = counts[[i for i in range(tt.num_items) if i not in seen]]
    assert unseen.min() > 0.7 * unseen.mean() and unseen.max() < 1.3 * unseen.mean()
    negs = tsamp.sample_eval_negatives(gen, tt, 99).numpy() - tt.item_lo
    for row, r_seen, cnt in zip(negs, tt.seen_all.numpy(), tt.cnt_all.numpy()):
        assert not set(row.tolist()) & set(r_seen[:cnt].tolist())


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


@pytest.mark.parametrize("layout", ["stream", "mixed", "composed"])
def test_loss_and_grads_match_jax(world, monkeypatch, layout):
    """'composed' runs bf16 transport: every conv composed (K8 softmax,
    gather_src, gather_dst, K5), against JAX under SEGSUM_TRANSPORT 'bf16'
    compiled with xla_allow_excess_precision off (test_torch_gcn_sage_slice.py:
    XLA's CPU jit otherwise skips bf16 roundings), at that file's bf16 bar
    (loss 1e-3, the median leaf 1e-3, every leaf 5e-2).  A streaming
    layout cannot be held in bf16 here: off the TPU the JAX package
    streams through stream_gat_reference, which is f32 whatever the
    transport."""
    jh, th = world
    transport = "bf16" if layout == "composed" else "f32"
    monkeypatch.setattr(jconfig, "SEGSUM_TRANSPORT", transport)  # read at trace time
    jg, tg = _per_channel(world, layout, monkeypatch)
    n = jh.num_nodes
    jcfg = jpea.PEAConfig(conv="gat", num_nodes=n, **SMALL)
    tcfg = tpea.PEAConfig(conv="gat", num_nodes=n, **SMALL)
    # the port's pea_init draws the JAX layout (test_torch_gcn_sage_slice.py
    # checks it); JAX's op-by-op init of 26 layers would cost seconds
    params = _trained_like(tparams.to_numpy(tpea.pea_init(torch.Generator().manual_seed(0),
                                                          tcfg)))
    batch, mask = _batch(th)

    loss_grads = jax.jit(jax.value_and_grad(
        lambda q: jpea.pea_loss(q, jg, jcfg, jnp.asarray(batch), row_mask=jnp.asarray(mask))),
        compiler_options={"xla_allow_excess_precision": False} if transport == "bf16" else None)
    jloss, jgrads = jax.tree_util.tree_map(np.asarray, loss_grads(params))
    model = tparams.from_jax_numpy(jax.tree_util.tree_map(np.asarray, params))
    loss = tpea.pea_loss(model, tg, tcfg, torch.from_numpy(batch),
                         row_mask=torch.from_numpy(mask), transport=transport)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-6 if transport == "f32" else 1e-3)
    tgrads = _grad_tree(model)
    assert jax.tree_util.tree_structure(tgrads) == jax.tree_util.tree_structure(jgrads)
    errs = []
    for t, j in zip(jax.tree_util.tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        assert t.shape == j.shape and np.isfinite(t).all()
        if not j.any():  # fc2's bias cancels in pos - neg
            assert not t.any()
            continue
        errs.append(float(np.abs(t - j).max() / np.abs(j).max()))
    errs.sort()
    if transport == "f32":
        assert errs[-1] <= 2e-5, errs
    else:
        assert errs[len(errs) // 2] <= 1e-3 and errs[-1] <= 5e-2, errs


class _StreamTrainer(PEATrainer):
    _analytic_gat_loops = True


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_train_steps_and_eval_on_cpu(world, transport):
    """The ML-25M path end to end on the CPU through the trainer: the
    13-channel metapaths, implicit self-loops on every graph, 'random'
    negatives, rejection-mode eval."""
    th = world[1]
    cfg = tpea.PEAConfig(conv="gat", num_nodes=th.num_nodes, **SMALL)
    trainer = _StreamTrainer(th, cfg, TrainConfig(batch_size=512, sampling_strategy="random"),
                             tml.ml25m_metapath_edges(th), device="cpu", transport=transport)
    assert trainer.tables.mode == "rejection"
    assert trainer.graphs[0][1] is trainer.graphs[6][1]  # i2u shared by channels 0-6
    params = trainer.init(0)
    opt = trainer.optimizer(params)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for step in range(4):
        rows = torch.randint(0, trainer.n_rows, (512,), generator=gen)
        losses.append(float(trainer.train_step(params, opt, rows, torch.ones(512), gen)))
    assert np.isfinite(losses).all()
    res = trainer.evaluate(params, torch.Generator().manual_seed(0))
    assert res["HR"].shape == (16,)
    assert all(torch.isfinite(res[k]).all() for k in ("HR", "NDCG", "AUC", "eval_loss"))
    assert 0.0 <= float(res["AUC"]) <= 1.0
    # attention dropout on the streaming layout: stream_gat_reference per conv
    with torch.no_grad():
        loss = tpea.pea_loss(params, trainer.graphs,
                             tpea.PEAConfig(conv="gat", num_nodes=th.num_nodes, dropout=0.1,
                                            **SMALL),
                             torch.zeros((4, 9), dtype=torch.long),
                             masks=tpea.DropoutMasks(0.1, torch.Generator().manual_seed(0)))
    assert torch.isfinite(loss)
