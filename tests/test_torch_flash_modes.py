"""Port parity for the flash-GAT variant routes (ops/config.FlashGATMode):
the online-max forward (K12-online), the unfused glue backward with the
src scatter (K13 + K6) and the one-pass backward (K14), on CPU
tensors (the kernels' plain versions), against the JAX package's Pallas
kernels in interpret mode under the same switches (FLASH_SOFTMAX_SHIFT,
FLASH_BWD_MEGA; the K13 route sits behind a 13 MiB literal gate, so its
runner ``_bwd_glue_impl(fused_scatter=False)`` is called directly, as
tests/test_flash_gat.py reaches private routes).

Inputs come from one numpy seed, on a block-ordered edge list whose
padding edges carry src 0 (a real row, as graph.py pads) and fall inside
the last, partial 128-row dst block; one row has no edge.  Tolerances, of
each output's largest value: forwards f32 5e-6 and bf16 4e-3
(test_torch_gat_ops.py: the JAX online kernel rounds p·z at its running
shift and rescales, the port rounds at the final shift), the row max m
bitwise; backwards f32 1e-5 and bf16 1e-4 (test_torch_gat_grads.py: both
round at the same points, so a dropped bf16 rounding point, ~1e-3,
fails).  The one exception is the gradient through the online forward in
bf16, 1e-2: the backward reads the forward's out and s, which differ from
the JAX online kernel's by up to the forward's 4e-3, and the table's
gradient comes back rounded to bf16 (measured 6e-4 to 3.8e-3 of the
largest value over four seeds, d a_dst 1.7e-3 to 3.7e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu.ops import config as jcfg
from graph_recsys_benchmark_tpu.ops import flash_gat as jfg
from graph_recsys_benchmark_tpu_torch.ops import flash_gat as tfg
from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as tsk
from graph_recsys_benchmark_tpu_torch.ops.config import FlashGATMode

FWD_TOL = {"f32": 5e-6, "bf16": 4e-3}
BWD_TOL = {"f32": 1e-5, "bf16": 1e-4}
ONLINE_BF16_BWD_TOL = 1e-2
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
MODES = [FlashGATMode(shift, bwd) for shift in ("bound", "online")
         for bwd in ("fused", "glue", "onepass")]
COUNTERS = (tfg.flash_gat_fwd, tfg.gat_rowmax, tfg.flash_gat_fwd_online, tfg.flash_gat_bwd,
            tfg.flash_gat_bwd_glue, tfg.flash_gat_bwd_onepass, tsk.localized_scatter_add)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops beside the other pytest workers: one torch thread, as
    the slice-4 test files use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launches():
    return [c.launches for c in COUNTERS]


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol}"


def _case(seed, n=260, e=2000, kz=12, pad=48, empty_row=5):
    """A block-ordered edge list (graph.py's order) with `pad` padding
    edges (dst n, src 0) and row `empty_row` without an edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = dst != empty_row
    src, dst = src[keep], dst[keep]
    order = np.lexsort((dst, src, dst // 128))
    src = np.concatenate([src[order], np.zeros(pad, np.int64)]).astype(np.int32)
    dst = np.concatenate([dst[order], np.full(pad, n)]).astype(np.int32)
    z_t = rng.standard_normal((kz, n)).astype(np.float32)
    a_src = rng.standard_normal(n).astype(np.float32)
    a_dst = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal((n, kz)).astype(np.float32)
    return n, kz, z_t, a_src, a_dst, g, src, dst


def _rows(z_t, a_src, transport):
    """The port's row-major [z | a_src] table in the transport dtype."""
    return torch.from_numpy(np.concatenate([z_t.T, a_src[:, None]], axis=1)).to(TDT[transport])


def _jax_packed(z_t, a_src, n, transport):
    return jfg.pack_gat_table(jnp.asarray(z_t), jnp.asarray(a_src), n, JDT[transport])


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_online_forward_matches_jax_k12_online(transport, monkeypatch):
    n, kz, z_t, a_src, a_dst, _, src, dst = _case(0)
    monkeypatch.setattr(jcfg, "FLASH_SOFTMAX_SHIFT", "online")
    jout, jm, js = jfg._flash_forward_impl(_jax_packed(z_t, a_src, n, transport),
                                           jnp.asarray(a_dst), src, dst, n, kz, 0.2, True,
                                           transport)
    table = _rows(z_t, a_src, transport)
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    before = _launches()
    adst_r, m = tfg.online_shift(table, torch.from_numpy(a_dst), ts, td, n, kz)
    acc = tfg.flash_gat_fwd_online(table, adst_r, m, ts, td, n, kz)
    assert _launches() == before  # CPU tensors: the plain versions, no launch
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))  # bitwise
    assert m[5] == 0.0  # the row without an edge
    s = acc[:, kz]
    out = acc[:, :kz] / (s[:, None] + 1e-16)
    _close(out, jout, FWD_TOL[transport], "out")
    _close(s, js, FWD_TOL[transport], "s")
    # the walk is K1/K12's: with m as the shift its plain version is the same
    np.testing.assert_array_equal(
        acc.numpy(), tfg.flash_gat_fwd_plain(table, adst_r, m, ts, td, n, kz).numpy())


def test_online_shift_is_exact_at_any_logit_spread(monkeypatch):
    """Row 3's best logit sits 202 below the bound m̂ = leaky(a_dst + max
    a_src): exp underflows and the bound route reads 0 there, while the
    online route, in the port and in JAX, gives the exact softmax."""
    n, kz, z_t, a_src, a_dst, _, src, dst = _case(1)
    low = np.arange(20, 40)
    a_src[low] = -10.0
    a_src[7] = 200.0
    a_dst[3] = 0.0
    row3 = dst == 3
    src[row3] = low[np.arange(row3.sum()) % low.size]
    order = np.lexsort((dst, src, dst // 128))
    src, dst = src[order], dst[order]
    jp = _jax_packed(z_t, a_src, n, "f32")
    ref = jfg.flash_gat_reference(jp, jnp.asarray(a_dst), src, dst, n, kz)
    ref3 = np.asarray(ref)[3]
    assert np.abs(ref3).max() > 0.1
    monkeypatch.setattr(jcfg, "FLASH_SOFTMAX_SHIFT", "online")
    jout = jfg._flash_forward_impl(jp, jnp.asarray(a_dst), src, dst, n, kz, 0.2, True,
                                   "f32")[0]
    _close(np.asarray(jout)[3], ref3, FWD_TOL["f32"], "JAX online row 3")
    tp = tfg.pack_gat_table(torch.from_numpy(z_t), torch.from_numpy(a_src), n, torch.float32)
    args = (tp, torch.from_numpy(a_dst), torch.from_numpy(src), torch.from_numpy(dst), None,
            None, n, kz, 0.2, "f32")
    online = tfg.flash_gat_attention(*args, mode=FlashGATMode(softmax_shift="online"))
    _close(online[3], ref3, FWD_TOL["f32"], "port online row 3")
    bound = tfg.flash_gat_attention(*args)
    assert float(bound[3].abs().max()) <= 1e-6 * np.abs(ref3).max()


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_glue_backward_matches_jax_k13(transport, monkeypatch):
    """K13's per-edge cotangent rows (padding rows exact zeros) and da_dst
    against ``_bwd_glue_impl(fused_scatter=False)``; then K6's plain version
    scatters the rows by src, against ``jax.ops.segment_sum`` of JAX's."""
    monkeypatch.setattr(jcfg, "SEGSUM_TRANSPORT", transport)  # JAX's ct dtype
    n, kz, z_t, a_src, a_dst, g, src, dst = _case(2)
    table = _rows(z_t, a_src, transport)
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    adst_r, mhat = tfg.bound_shift(torch.from_numpy(a_dst), table[:, kz], 0.2, TDT[transport])
    acc = tfg.flash_gat_fwd_plain(table, adst_r, mhat, ts, td, n, kz)
    s = acc[:, kz]
    out = acc[:, :kz] / (s[:, None] + 1e-16)
    gt = torch.from_numpy(g)
    g_r = gt.to(TDT[transport]).float()
    gout = (gt * out).sum(dim=1)
    logden = mhat + torch.log(s + 1e-16)
    before = _launches()
    ct, da = tfg.flash_gat_bwd_glue(table, torch.cat([g_r, gout[:, None]], dim=1), logden,
                                    adst_r, ts, td, n, kz)
    dpk = tsk.localized_scatter_add(ct, ts, n, transport)
    assert _launches() == before
    assert ct.dtype == TDT[transport] and ct.shape == (dst.size, kz + 1)

    kg_pad = max(8, -(-(kz + 3) // 8) * 8)
    n_pad = -(-(n + 1) // 128) * 128
    gtab_t = np.zeros((kg_pad, n_pad), np.float32)
    gtab_t[:kz, :n] = g_r.numpy().T
    gtab_t[kz, :n] = gout.numpy()
    gtab_t[kz + 1, :n] = logden.numpy()
    gtab_t[kz + 2, :n] = adst_r.numpy()
    ct_t, jda = jfg._bwd_glue_impl(_jax_packed(z_t, a_src, n, transport), jnp.asarray(gtab_t),
                                   src, dst, n, kz, 0.2, True, transport, fused_scatter=False)
    jct = np.asarray(ct_t.astype(jnp.float32))[: kz + 1, : dst.size].T
    pad = dst >= n
    assert not ct[torch.from_numpy(pad)].float().any() and not jct[pad].any()
    _close(ct.float(), jct, BWD_TOL[transport], "ct")
    _close(da, jda, BWD_TOL[transport], "da_dst")
    jdpk = jax.ops.segment_sum(ct_t.astype(jnp.float32).T[: dst.size], src, n)[:, : kz + 1]
    _close(dpk, jdpk, BWD_TOL[transport], "dpk")


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's (d packed, d a_dst) for _case(3) per (shift, one-pass,
    transport), computed on first use: the fused and glue routes share
    JAX's default backward (the same function; K13 is held on its own
    above)."""
    case = _case(3)
    cache = {}

    def get(shift, onepass, transport):
        key = (shift, onepass, transport)
        if key not in cache:
            n, kz, z_t, a_src, a_dst, g, src, dst = case
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jcfg, "SEGSUM_TRANSPORT", transport)
                mp.setattr(jcfg, "FLASH_SOFTMAX_SHIFT", shift)
                mp.setattr(jcfg, "FLASH_BWD_MEGA", onepass)
                perm = np.argsort(src, kind="stable").astype(np.int32)
                _, vjp = jax.vjp(
                    lambda p, a: jfg.flash_gat_attention(p, a, src, dst, perm, src[perm], n,
                                                         kz, 0.2, True, transport),
                    _jax_packed(z_t, a_src, n, transport), jnp.asarray(a_dst))
                cache[key] = vjp(jnp.asarray(g))
        return cache[key]

    return case, get


def _port_grads(case, transport, mode):
    n, kz, z_t, a_src, a_dst, g, src, dst = case
    tp = tfg.pack_gat_table(torch.from_numpy(z_t), torch.from_numpy(a_src), n,
                            TDT[transport]).requires_grad_()
    ta = torch.from_numpy(a_dst).requires_grad_()
    out = tfg.flash_gat_attention(tp, ta, torch.from_numpy(src), torch.from_numpy(dst), None,
                                  None, n, kz, 0.2, transport, mode=mode)
    return torch.autograd.grad(out, (tp, ta), torch.from_numpy(g))


@pytest.mark.parametrize("transport", ["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"{m.softmax_shift}-{m.bwd}")
def test_every_mode_grads_match_jax(jax_grads, mode, transport):
    case, get = jax_grads
    jdp, jda = get(mode.softmax_shift, mode.bwd == "onepass", transport)
    before = _launches()
    tdp, tda = _port_grads(case, transport, mode)
    assert _launches() == before
    assert tdp.dtype == TDT[transport] and jdp.dtype == JDT[transport]
    tol = BWD_TOL[transport]
    if mode.softmax_shift == "online" and transport == "bf16":
        tol = ONLINE_BF16_BWD_TOL
    _close(tdp.float().numpy(), jdp.astype(jnp.float32), tol, "d packed")
    _close(tda.numpy(), jda, tol, "d a_dst")


@pytest.mark.parametrize("mode", MODES[1:], ids=lambda m: f"{m.softmax_shift}-{m.bwd}")
def test_zero_edge_graphs_give_exact_zeros(mode):
    n, kz = 100, 8
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.standard_normal((n, kz)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    e = torch.zeros(0, dtype=torch.int32)
    packed = tfg.pack_gat_table(z.t(), a, n, torch.bfloat16).requires_grad_()
    ad = a.clone().requires_grad_()
    out = tfg.flash_gat_attention(packed, ad, e, e, e, e, n, kz, 0.2, "bf16", mode=mode)
    dp, da = torch.autograd.grad(out, (packed, ad), torch.ones_like(out))
    assert not out.any() and not dp.any() and not da.any()
    assert dp.dtype == torch.bfloat16 and da.shape == (n,)


def test_mode_rejects_unknown_values():
    assert FlashGATMode() == FlashGATMode("bound", "fused")
    with pytest.raises(ValueError, match="softmax_shift"):
        FlashGATMode(softmax_shift="running")
    with pytest.raises(ValueError, match="bwd"):
        FlashGATMode(bwd="mega")
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer

    with pytest.raises(TypeError, match="FlashGATMode"):
        PEATrainer(None, None, None, device="cpu", flash_mode="online")


# ---------------------------------------------------------------- the slice

RAW = dict(seed=3, num_users=80, num_items=100)
SMALL = dict(conv="gat", meta_path_steps=(2,) * 9, emb_dim=16, hidden_size=16,
             repr_dim=8, entity_aware=True)


@pytest.fixture(scope="module")
def slice_world():
    """test_torch_train_slice.py's small HIN, JAX weights moved off the
    init regime (its _trained_like), one numpy batch of the 9 entity-aware
    columns with a partial row mask."""
    from graph_recsys_benchmark_tpu import graph as jgraph
    from graph_recsys_benchmark_tpu.data import movielens as jml
    from graph_recsys_benchmark_tpu.data import synthetic as jsyn
    from graph_recsys_benchmark_tpu.models import pea as jpea
    from graph_recsys_benchmark_tpu_torch.data import movielens as tml
    from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
    from graph_recsys_benchmark_tpu_torch.train import sampling as tsamp

    kw = dict(num_core=5, num_feat_core=3)
    jh = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(**RAW), **kw)
    th = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**RAW), **kw)
    jg = jgraph.build_metapath_graphs(jml.mlsmall_metapath_edges(jh), jh.num_nodes, "gat")
    cfg = jpea.PEAConfig(num_nodes=jh.num_nodes, **SMALL)
    params = dict(jpea.pea_init(jax.random.PRNGKey(0), cfg))
    params["x"] = params["x"] * 10.0
    params["fc1"] = dict(params["fc1"], b=params["fc1"]["b"] * 0.1)
    tables = tsamp.build_device_tables(th, "cpu")
    rng = np.random.default_rng(0)
    b = 96
    rows = rng.integers(0, th.train_pos.shape[0], b)
    u = torch.from_numpy(th.train_pos[rows, 0]).int()
    pos = torch.from_numpy(th.train_pos[rows, 1]).int()
    gen = torch.Generator().manual_seed(0)
    neg = tsamp.sample_cf_negatives(gen, u, tables, "unseen")
    ent = tsamp.sample_entities(gen, u, pos, tables)
    batch = torch.cat([u[:, None], pos[:, None], neg[:, None], ent], dim=1).long().numpy()
    mask = np.ones(b, np.float32)
    mask[b - 23:] = 0.0
    plan = jpea.build_hybrid_gat_plan(jg, jh.num_nodes, cfg)
    return th, cfg, plan, jax.tree_util.tree_map(np.asarray, params), batch, mask


@pytest.mark.parametrize("mode", [FlashGATMode("online", "fused"), FlashGATMode("bound", "glue"),
                                  FlashGATMode("bound", "onepass")],
                         ids=lambda m: f"{m.softmax_shift}-{m.bwd}")
def test_trainer_step_matches_jax_in_each_mode(slice_world, monkeypatch, mode):
    """One PEATrainer loss and backward per non-default mode against
    ``jax.value_and_grad(pea_loss)`` under the same switches, with the JAX
    union flash pass forced onto its interpret-mode kernels (off the TPU
    the JAX model otherwise takes its XLA reference): loss 1e-5, every
    gradient leaf 1e-4 of its largest value (test_torch_train_slice.py's
    bars, f32)."""
    from graph_recsys_benchmark_tpu.models import pea as jpea
    from graph_recsys_benchmark_tpu_torch.models import params as tparams
    from graph_recsys_benchmark_tpu_torch.models import pea as tpea
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

    th, jcfg_model, plan, params, batch, mask = slice_world
    kernel, traced = jfg.flash_gat_attention, []

    def interpreted(*a):  # the model passes interpret=False (argument 9)
        traced.append(a[6])
        return kernel(*a[:9], True, *a[10:])

    monkeypatch.setattr(jfg, "flash_gat_enabled", lambda *a, **k: True)
    monkeypatch.setattr(jfg, "flash_gat_attention", interpreted)
    monkeypatch.setattr(jcfg, "FLASH_SOFTMAX_SHIFT", mode.softmax_shift)
    monkeypatch.setattr(jcfg, "FLASH_BWD_MEGA", mode.bwd == "onepass")
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jpea.pea_loss(p, plan, jcfg_model, jnp.asarray(batch),
                                row_mask=jnp.asarray(mask))))(params)
    assert traced  # the step-1 union graph took the interpret-mode kernels

    cfg = tpea.PEAConfig(num_nodes=th.num_nodes, **SMALL)
    trainer = PEATrainer(th, cfg, TrainConfig(), device="cpu", flash_mode=mode)
    assert trainer.flash_mode == mode
    model = tparams.from_jax_numpy(params)
    before = _launches()
    loss = trainer.batch_loss(model, torch.from_numpy(batch), torch.from_numpy(mask))
    loss.backward()
    assert _launches() == before
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    tgrads = _grad_tree(model)
    assert jax.tree_util.tree_structure(tgrads) == jax.tree_util.tree_structure(jgrads)
    for t, j in zip(jax.tree_util.tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
        j = np.asarray(j)
        assert t.shape == j.shape and np.isfinite(t).all()
        assert np.abs(t - j).max() <= 1e-4 * max(float(np.abs(j).max()), 1e-30)


def _grad_tree(m):
    """The model's gradients in the JAX params' tree layout."""
    def g(layer):
        return {k: v.grad.numpy() for k, v in layer.items()}

    return {"x": m.x.grad.numpy(), "att": m.att.grad.numpy(),
            "channels": tuple(tuple(g(layer) for layer in ch) for ch in m.channels),
            "fc1": g(m.fc1), "fc2": g(m.fc2)}
