"""Port parity for the walk models' modules (models/metapath2vec.py,
models/walk.py, models/herec.py) against the JAX package on the CPU.

* build_relation_csr and metapath_from_hin bitwise the JAX package's, on
  ``synthetic-ml``'s MetaPath2Vec metapath and ``synthetic-yelp``'s two
  HeRec metapaths, and for an empty relation.
* walk_from_uniforms bitwise the JAX ``sample_pos_walks`` under the JAX
  walker's own uniforms (the ``jax.random`` draws of its keys): on
  ``synthetic-ml``'s ML_MP2V_STEPS from the users, and on
  ``synthetic-yelp``'s HeRec metapath 0 from the users, whose first
  relation has fewer rows than there are users (the gathers past the
  tables that XLA clamps); a zero-degree last row likewise.
* Negative walks stay within each position's type range.
* mp2v_loss and its embedding gradient on the same walks; walk_bpr_loss
  and herec_mse_loss and every gradient after converting the JAX
  parameters (models/params): f32, within 1e-5 of JAX.
* The converters carry the JAX trees both ways exactly; the port's inits
  draw the JAX layout.
JAX runs eagerly at walk length 12; torch on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.data import yelp as jyelp
from graph_recsys_benchmark_tpu.models import herec as jherec
from graph_recsys_benchmark_tpu.models import metapath2vec as jmp2v
from graph_recsys_benchmark_tpu.models import walk as jwalk
from graph_recsys_benchmark_tpu.train import walk_trainers as jwt
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.data import yelp as tyelp
from graph_recsys_benchmark_tpu_torch.models import herec as therec
from graph_recsys_benchmark_tpu_torch.models import metapath2vec as tmp2v
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.models import walk as twalk
from graph_recsys_benchmark_tpu_torch.train import walk_trainers as twt

EMB = 16
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hins():
    """{dataset: (JAX HIN, port HIN)}, built as the CLIs build them."""
    kw = dict(num_core=3, num_feat_core=2)
    ml = (jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(seed=0), **kw),
          tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(seed=0), **kw))
    yelp = (jyelp.build_yelp_hin(*jsyn.synthetic_yelp_raw(seed=0), num_core=4),
            tyelp.build_yelp_hin(*tsyn.synthetic_yelp_raw(seed=0), num_core=4))
    return {"synthetic-ml": ml, "synthetic-yelp": yelp}


# (dataset, metapath name, the JAX table, the port's table)
METAPATHS = {
    "ml-mp2v": ("synthetic-ml", jwt.ML_MP2V_STEPS, twt.ML_MP2V_STEPS),
    "yelp-herec0": ("synthetic-yelp", jyelp.YELP_HEREC_METAPATHS[0],
                    tyelp.YELP_HEREC_METAPATHS[0]),
    "yelp-herec1": ("synthetic-yelp", jyelp.YELP_HEREC_METAPATHS[1],
                    tyelp.YELP_HEREC_METAPATHS[1]),
}


def _cfg(mod, hin, start="uid", wpn=3, walk_length=12, context_size=5, neg=2):
    """A small walk config of package `mod`, walks from the users (HeRec's
    start, JAX cli.py:323-329) or another type."""
    return mod.MP2VConfig(
        embedding_dim=EMB, walk_length=walk_length, context_size=context_size,
        walks_per_node=wpn, num_negative_samples=neg, start_offset=hin.type_accs[start],
        num_start=hin.num_nodes_dict[start], num_nodes=hin.num_nodes)


def _assert_csr_equal(t, j):
    for f in ("rowptr", "col", "deg"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == torch.int32 and b.dtype == np.int32, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    assert (t.dst_offset, t.dst_count) == (j.dst_offset, j.dst_count)


def _jax_uniforms(key, cfg, n):
    """The uniforms the JAX walker draws for n walks: step i's from key i
    of split(key, walk_length) (JAX models/metapath2vec.py:98-104)."""
    keys = jax.random.split(key, cfg.walk_length)
    return torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(keys[i], (n,))) for i in range(cfg.walk_length)]))


@pytest.mark.parametrize("name", sorted(METAPATHS))
def test_metapath_csr_matches_jax(hins, name):
    dataset, jsteps, tsteps = METAPATHS[name]
    assert tsteps == jsteps
    jh, th = hins[dataset]
    jcsr = jmp2v.metapath_from_hin(jh, jsteps)
    tcsr = tmp2v.metapath_from_hin(th, tsteps)
    assert len(tcsr) == len(jcsr)
    for t, j in zip(tcsr, jcsr):
        _assert_csr_equal(t, j)


def test_empty_relation_csr_matches_jax():
    j = jmp2v.build_relation_csr([], [], 4, 10, 7)
    t = tmp2v.build_relation_csr([], [], 4, 10, 7)
    _assert_csr_equal(t, j)
    assert t.col.tolist() == [0]


@pytest.mark.parametrize("name", ["ml-mp2v", "yelp-herec0"])
def test_pos_walks_bitwise_under_jax_uniforms(hins, name):
    dataset, jsteps, tsteps = METAPATHS[name]
    jh, th = hins[dataset]
    jcfg, tcfg = _cfg(jmp2v, jh), _cfg(tmp2v, th)
    jcsr = jmp2v.metapath_from_hin(jh, jsteps)
    tcsr = tmp2v.metapath_from_hin(th, tsteps)
    starts = np.arange(jcfg.num_start, dtype=np.int32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jmp2v.sample_pos_walks(key, jnp.asarray(starts), jcsr, jcfg))
    u = _jax_uniforms(key, jcfg, starts.size * jcfg.walks_per_node)
    got = tmp2v.walk_from_uniforms(torch.from_numpy(starts), tcsr, tcfg, u)
    assert got.shape == want.shape == (starts.size * 3, 13)
    np.testing.assert_array_equal(got.numpy(), want)
    rows_first = int(tcsr[0].deg.shape[0])
    if name == "yelp-herec0":
        # the users past the first relation's rows read its last degree and
        # rowptr[-1] = len(col): every one steps to col[-1]
        assert rows_first < starts.size
        past = want[rows_first:starts.size, 1]
        assert (past == int(tcsr[0].col[-1]) + tcsr[0].dst_offset).all(), past
    else:
        assert rows_first == starts.size


def test_zero_degree_last_row_walks_as_jax():
    """rowptr[n] + 0 = len(col) on a zero-degree last row: XLA clamps the
    col gather; so does the port."""
    src, dst = [0, 0, 1, 2, 2], [1, 3, 0, 2, 4]
    mk = [(m.build_relation_csr(src, dst, 4, 0, 5), m.build_relation_csr(dst, src, 5, 0, 4))
          for m in (jmp2v, tmp2v)]
    kw = dict(embedding_dim=4, walk_length=6, context_size=3, walks_per_node=2,
              num_negative_samples=1, num_start=4, num_nodes=9)
    jcfg, tcfg = jmp2v.MP2VConfig(**kw), tmp2v.MP2VConfig(**kw)
    starts = np.array([3, 3, 1, 0], np.int32)  # row 3 has no edge
    key = jax.random.PRNGKey(3)
    want = np.asarray(jmp2v.sample_pos_walks(key, jnp.asarray(starts), mk[0], jcfg))
    got = tmp2v.walk_from_uniforms(torch.from_numpy(starts), mk[1], tcfg,
                                   _jax_uniforms(key, jcfg, starts.size * 2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 1] == 4  # col[-1] of the first relation


def test_neg_walks_stay_in_type_ranges(hins):
    _, th = hins["synthetic-yelp"]
    steps = tyelp.YELP_MP2V_STEPS
    cfg = _cfg(tmp2v, th, start="item_reviewcount")
    csr = tmp2v.metapath_from_hin(th, steps)
    starts = torch.arange(cfg.num_start, dtype=torch.int32)
    rw = tmp2v.sample_neg_walks(torch.Generator().manual_seed(0), starts, csr, cfg)
    assert rw.shape == (cfg.num_start * 3 * 2, 13)
    assert torch.equal(rw[:, 0], starts.long().repeat(6) + cfg.start_offset)
    for pos in range(1, cfg.walk_length + 1):
        rel = csr[(pos - 1) % len(csr)]
        col = rw[:, pos]
        assert int(col.min()) >= rel.dst_offset and int(col.max()) < rel.dst_offset + \
            rel.dst_count, pos
    # the positive walks stay in type too, and follow real edges
    pos_rw = tmp2v.sample_pos_walks(torch.Generator().manual_seed(1), starts, csr, cfg)
    edges = set(map(tuple, th.edge_index["reviewcount2item"].T))
    assert all((int(a), int(b)) in edges for a, b in pos_rw[:, :2])


def _rel(got, want):
    """max |got - want| over max |want|; the error itself where want is all
    zero (fc2's bias cancels in pos - neg)."""
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    top = float(np.abs(want).max())
    return err / top if top > 0 else err


def test_mp2v_loss_and_grad_match_jax(hins):
    jh, th = hins["synthetic-ml"]
    jcfg, tcfg = _cfg(jmp2v, jh, wpn=2), _cfg(tmp2v, th, wpn=2)
    jcsr = jmp2v.metapath_from_hin(jh, jwt.ML_MP2V_STEPS)
    starts = jnp.arange(8, dtype=jnp.int32)
    pos = jmp2v.sample_pos_walks(jax.random.PRNGKey(0), starts, jcsr, jcfg)
    neg = jmp2v.sample_neg_walks(jax.random.PRNGKey(1), starts, jcsr, jcfg)
    emb = jmp2v.mp2v_init(jax.random.PRNGKey(2), jcfg)["emb"]
    jloss, jgrad = jax.value_and_grad(
        lambda e: jmp2v.mp2v_loss({"emb": e}, pos, neg, jcfg))(emb)
    params = tmp2v.MP2V({"emb": torch.from_numpy(np.array(emb))})
    loss = tmp2v.mp2v_loss(params, torch.from_numpy(np.array(pos)).long(),
                           torch.from_numpy(np.array(neg)).long(), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    assert _rel(params.emb.grad.numpy(), jgrad) <= TOL


def test_walk_bpr_loss_and_grads_match_jax(hins):
    _, th = hins["synthetic-ml"]
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(th.num_nodes, EMB)).astype(np.float32)
    b = 64
    batch = np.stack([rng.integers(0, th.num_users, b), th.item_acc
                      + rng.integers(0, th.num_items, b),
                      th.item_acc + rng.integers(0, th.num_items, b)], 1)
    mask = (np.arange(b) < b - 9).astype(np.float32)
    tree = jax.tree_util.tree_map(np.asarray, jwalk.walk_init(jax.random.PRNGKey(4), EMB))
    jloss, jgrads = jax.value_and_grad(lambda p: jwalk.walk_bpr_loss(
        p, jnp.asarray(emb), jnp.asarray(batch), jnp.asarray(mask)))(tree)
    model = tparams.walk_from_jax_numpy(tree)
    loss = twalk.walk_bpr_loss(model, torch.from_numpy(emb), torch.from_numpy(batch),
                               torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    for fc in ("fc1", "fc2"):
        for k in ("w", "b"):
            assert _rel(getattr(model, fc)[k].grad.numpy(), jgrads[fc][k]) <= TOL, (fc, k)


def test_herec_mse_loss_and_grads_match_jax(hins):
    _, th = hins["synthetic-ml"]
    rng = np.random.default_rng(1)
    rks = [rng.normal(size=(th.num_nodes, EMB)).astype(np.float32) for _ in range(2)]
    b = 64
    u_lo, i_lo = th.type_accs[th.types[0]], th.item_acc
    pair = np.stack([u_lo + rng.integers(0, th.num_users, b),
                     i_lo + rng.integers(0, th.num_items, b)], 1)
    rating = rng.uniform(0.5, 5.0, b).astype(np.float32)
    mask = (np.arange(b) < b - 5).astype(np.float32)
    tree = jax.tree_util.tree_map(np.asarray, jherec.herec_init(
        jax.random.PRNGKey(5), th.num_users, th.num_items, EMB, 2))
    jloss, jgrads = jax.value_and_grad(lambda p: jherec.herec_mse_loss(
        p, tuple(jnp.asarray(r) for r in rks), u_lo, i_lo, jnp.asarray(pair),
        jnp.asarray(rating), jnp.asarray(mask)))(tree)
    model = tparams.herec_from_jax_numpy(tree)
    loss = therec.herec_mse_loss(model, tuple(torch.from_numpy(r) for r in rks), u_lo, i_lo,
                                 torch.from_numpy(pair), torch.from_numpy(rating),
                                 torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    grads = tparams._map(lambda p: p.grad.numpy(), model.tree())
    flat_t = jax.tree_util.tree_leaves(grads)
    flat_j = jax.tree_util.tree_leaves(jgrads)
    assert jax.tree_util.tree_structure(grads) == jax.tree_util.tree_structure(jgrads)
    for t, j in zip(flat_t, flat_j):
        assert _rel(t, j) <= TOL


@pytest.mark.parametrize("family", ["walk", "herec"])
def test_walk_converters_round_trip_and_init_layout(hins, family):
    _, th = hins["synthetic-ml"]
    key, gen = jax.random.PRNGKey(8), torch.Generator().manual_seed(0)
    if family == "walk":
        tree = jwalk.walk_init(key, EMB)
        conv = (tparams.walk_from_jax_numpy, tparams.walk_to_numpy)
        port = twalk.walk_init(gen, EMB)
    else:
        tree = jherec.herec_init(key, th.num_users, th.num_items, EMB, 2)
        conv = (tparams.herec_from_jax_numpy, tparams.herec_to_numpy)
        port = therec.herec_init(gen, th.num_users, th.num_items, EMB, 2)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    back = conv[1](conv[0](tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    drawn = conv[1](port)
    assert jax.tree_util.tree_structure(drawn) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(drawn)):
        assert a.shape == b.shape and a.dtype == b.dtype
