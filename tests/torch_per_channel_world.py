"""The small world of the port's per-channel parity tests
(test_torch_per_channel*.py): the HIN of test_torch_gcn_sage_slice.py built
by both packages, two metapath tables, the port's trainer per conv and
table, weights off the init regime, a batch, and the parity check of
forward, loss and every gradient against the JAX package.

Tables: 'mixed', whose channel 0 takes only its first step
(``meta_path_steps=(1,) + (2,) * 8``, ``edges[0][:1]``, as the JAX
package's tests/test_parallel_engine.py:88-99), fused left on (a mixed
table runs the per-channel graphs whatever it says); 'unfused', the
uniform table with ``fused=False``.  The JAX side is one jitted
value_and_grad a check, compiled with ``xla_allow_excess_precision`` off
under bf16 (test_torch_gcn_sage_slice.py: XLA's CPU compiler otherwise
skips bf16 roundings)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.models import pea as jpea
from graph_recsys_benchmark_tpu.ops import config as jconfig
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.models import pea as tpea
from graph_recsys_benchmark_tpu_torch.train import sampling as tsamp
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

RAW = dict(seed=3, num_users=80, num_items=100)
SMALL = dict(emb_dim=16, hidden_size=16, repr_dim=8, entity_aware=True)
MIXED = (1,) + (2,) * 8
FIELDS = ("src", "dst", "w", "rel", "src_perm", "src_sorted")


@dataclasses.dataclass
class World:
    jhin: object
    thin: object
    tables: dict  # name -> (meta_path_steps, JAX edges, the port's edges)
    cache: dict


def build_world():
    kw = dict(num_core=5, num_feat_core=3)
    jh = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(**RAW), **kw)
    th = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**RAW), **kw)
    je, te = jml.mlsmall_metapath_edges(jh), tml.mlsmall_metapath_edges(th)
    tables = {"mixed": (MIXED, [je[0][:1]] + list(je[1:]), [te[0][:1]] + list(te[1:])),
              "unfused": ((2,) * 9, je, te)}
    return World(jh, th, tables, {})


def configs(world, conv, table, **kw):
    """(JAX PEAConfig, the port's PEAConfig) of a conv and table."""
    kw = dict(conv=conv, num_nodes=world.jhin.num_nodes, meta_path_steps=world.tables[table][0],
              fused=table == "mixed", **SMALL, **kw)
    return jpea.PEAConfig(**kw), tpea.PEAConfig(**kw)


def setup(world, conv, table):
    """(JAX per-channel graphs, the port's PEATrainer on the CPU, weights
    as a numpy pytree), once per conv and table.  The weights are JAX
    ``pea_init``'s off the init regime."""
    key = (conv, table)
    if key not in world.cache:
        _, jedges, tedges = world.tables[table]
        jcfg, tcfg = configs(world, conv, table)
        jg = jgraph.build_metapath_graphs(jedges, world.jhin.num_nodes, conv)
        trainer = PEATrainer(world.thin, tcfg, TrainConfig(), metapath_edges=tedges,
                             device="cpu")
        params = trained_like(jax.tree_util.tree_map(
            np.asarray, jpea.pea_init(jax.random.PRNGKey(0), jcfg)))
        world.cache[key] = (jg, trainer, params)
    return world.cache[key]


def trained_like(params):
    """Off the init regime (test_torch_train_slice.py:_trained_like): at init
    fc1's bias alone sets the ReLU masks and the user representations'
    gradients vanish to float noise."""
    params = dict(params)
    params["x"] = params["x"] * 10.0
    params["fc1"] = dict(params["fc1"], b=params["fc1"]["b"] * 0.1)
    return params


def make_batch(th, b=96, pad=23, seed=0):
    """An entity-aware batch of b rows whose last `pad` rows are masked."""
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


def grad_tree(m):
    def g(layer):
        return {k: v.grad.numpy() for k, v in layer.items()}

    return {"x": m.x.grad.numpy(), "att": m.att.grad.numpy(),
            "channels": tuple(tuple(g(layer) for layer in ch) for ch in m.channels),
            "fc1": g(m.fc1), "fc2": g(m.fc2)}


def leaf_errors(tgrads, jgrads):
    """Per-leaf max error over the JAX leaf's largest value, sorted; leaves
    that are exactly zero in JAX (fc2's bias cancels in pos - neg) must be
    zero."""
    assert jax.tree_util.tree_structure(tgrads) == jax.tree_util.tree_structure(jgrads)
    errs = []
    for t, j in zip(jax.tree_util.tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        assert t.shape == j.shape and np.isfinite(t).all()
        if not j.any():
            assert not t.any()
            continue
        errs.append(float(np.abs(t - j).max() / np.abs(j).max()))
    return sorted(errs)


def jax_reference(monkeypatch, jg, jcfg, params, batch, mask, transport, **loss_kw):
    """(forward, loss, gradients) of the JAX package as numpy, one jitted
    program under SEGSUM_TRANSPORT = transport (read at trace time)."""
    monkeypatch.setattr(jconfig, "SEGSUM_TRANSPORT", transport)

    def loss_and_rep(q):
        loss = jpea.pea_loss(q, jg, jcfg, jnp.asarray(batch), row_mask=jnp.asarray(mask),
                             **loss_kw)
        return loss, jpea.pea_forward(q, jg, jcfg)

    fn = jax.jit(jax.value_and_grad(loss_and_rep, has_aux=True),
                 compiler_options={"xla_allow_excess_precision": False}
                 if transport == "bf16" else None)
    (loss, rep), grads = jax.tree_util.tree_map(np.asarray, fn(params))
    return rep, loss, grads


def check_parity(world, monkeypatch, conv, table, transport, median_bf16=1e-3):
    """Forward, loss and every gradient of the port against the JAX
    package: f32 1e-5 relative (gradients 1e-5 of their largest value);
    bf16 1e-3, the median leaf `median_bf16`, every leaf 5e-2."""
    jg, trainer, params = setup(world, conv, table)
    jcfg, tcfg = configs(world, conv, table)
    batch, mask = make_batch(world.thin)
    jrep, jloss, jgrads = jax_reference(monkeypatch, jg, jcfg, params, batch, mask, transport)
    model = tparams.from_jax_numpy(params)
    with torch.no_grad():
        trep = tpea.pea_forward(model, trainer.graphs, tcfg, transport=transport)
    loss = tpea.pea_loss(model, trainer.graphs, tcfg, torch.from_numpy(batch),
                         row_mask=torch.from_numpy(mask), transport=transport)
    loss.backward()
    tol = 1e-5 if transport == "f32" else 1e-3
    assert trep.shape == jrep.shape == (tcfg.num_nodes, tcfg.repr_dim)
    assert np.abs(trep.numpy() - jrep).max() <= tol * np.abs(jrep).max()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=tol)
    errs = leaf_errors(grad_tree(model), jgrads)
    if transport == "f32":
        assert errs[-1] <= 1e-5, errs
    else:
        assert errs[len(errs) // 2] <= median_bf16 and errs[-1] <= 5e-2, errs


def check_routing(world, conv, table):
    """The port's trainer runs the per-channel graphs (each distinct one
    moved once, channels that share a graph share one object), equal to
    the JAX package's array for array."""
    jg, trainer, _ = setup(world, conv, table)
    tg = trainer.graphs
    assert isinstance(tg, tuple) and len(tg) == len(jg) == 9
    assert [len(ch) for ch in tg] == list(world.tables[table][0])
    distinct = {id(g) for ch in tg for g in ch}
    assert len(distinct) == len({id(g) for ch in jg for g in ch}) < sum(len(ch) for ch in tg)
    for jch, tch in zip(jg, tg):
        for a, b in zip(jch, tch):
            for f in FIELDS:
                np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f).numpy(),
                                              err_msg=f)
            assert (a.num_nodes, a.num_edges, a.gat_loops) == (b.num_nodes, b.num_edges,
                                                               b.gat_loops)
