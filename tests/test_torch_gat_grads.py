"""Port parity for the GAT backwards: the port's autograd Functions, which
run the kernels' plain versions for CPU tensors, against the JAX package's
custom VJPs with the Pallas kernels in interpret mode.

ops/flash_gat: ``jax.vjp`` of ``flash_gat_attention(..., interpret=True)``
reaches the fused backward glue kernel (K2, ``fused_scatter=True``), whose
cotangent dtype is read from the global ``SEGSUM_TRANSPORT``: the tests set
it to the transport under test.  ops/batch_gat: ``batch_gat_attention(...,
interpret=True)`` reaches K4.  Inputs and the output cotangent come from
one numpy seed.  Tolerances, of each gradient's largest value: f32 1e-5
(the sums run in another order); bf16 1e-4, where both round at the same
points, so a dropped bf16 rounding point (~1e-3) fails."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu.graph import build_gat_graph
from graph_recsys_benchmark_tpu.ops import batch_gat as jbg
from graph_recsys_benchmark_tpu.ops import config as jcfg
from graph_recsys_benchmark_tpu.ops import flash_gat as jfg
from graph_recsys_benchmark_tpu_torch.ops import batch_gat as tbg
from graph_recsys_benchmark_tpu_torch.ops import flash_gat as tfg

TOL = {"f32": 1e-5, "bf16": 1e-4}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _close(got, want, transport, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL[transport], f"{what} {transport}: relative error {err:.3e}"


def _flash_case(seed, n=200, e=1000, kz=16, pad=40):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=e).astype(np.int32)
    dst = rng.integers(0, n, size=e).astype(np.int32)
    order = np.lexsort((src, dst // 128))
    src, dst = src[order], dst[order]
    src = np.concatenate([src, np.full(pad, n, np.int32)])
    dst = np.concatenate([dst, np.full(pad, n, np.int32)])
    z_t = rng.standard_normal((kz, n)).astype(np.float32)
    a_src = rng.standard_normal(n).astype(np.float32)
    a_dst = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal((n, kz)).astype(np.float32)
    perm = np.argsort(src, kind="stable").astype(np.int32)
    return n, kz, z_t, a_src, a_dst, g, src, dst, perm, src[perm]


def _torch_flash_grads(case, transport):
    n, kz, z_t, a_src, a_dst, g, src, dst, perm, srt = case
    tp = tfg.pack_gat_table(torch.from_numpy(z_t), torch.from_numpy(a_src), n,
                            TDT[transport]).requires_grad_()
    ta = torch.from_numpy(a_dst).requires_grad_()
    out = tfg.flash_gat_attention(tp, ta, torch.from_numpy(src), torch.from_numpy(dst),
                                  perm, srt, n, kz, 0.2, transport)
    return torch.autograd.grad(out, (tp, ta), torch.from_numpy(g))


@pytest.fixture(scope="module")
def flash_jax():
    """JAX's K2 gradients, once per transport for the module."""
    case = _flash_case(0)
    n, kz, z_t, a_src, a_dst, g, src, dst, perm, srt = case
    grads = {}
    for transport in ("f32", "bf16"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcfg, "SEGSUM_TRANSPORT", transport)
            jp = jfg.pack_gat_table(jnp.asarray(z_t), jnp.asarray(a_src), n, JDT[transport])
            _, vjp = jax.vjp(
                lambda p, a: jfg.flash_gat_attention(p, a, src, dst, perm, srt, n, kz,
                                                     0.2, True, transport),
                jp, jnp.asarray(a_dst),
            )
            grads[transport] = vjp(jnp.asarray(g))
    return case, grads


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_flash_grads_match_jax_k2(flash_jax, transport):
    case, grads = flash_jax
    jdp, jda = grads[transport]
    launches = tfg.flash_gat_bwd.launches
    tdp, tda = _torch_flash_grads(case, transport)
    assert tfg.flash_gat_bwd.launches == launches  # CPU: plain version, no launch
    # the table's gradient comes back in the table's (transport) dtype
    assert tdp.dtype == TDT[transport] and jdp.dtype == JDT[transport]
    _close(tdp.float().numpy(), jdp.astype(jnp.float32), transport, "d packed")
    _close(tda.numpy(), jda, transport, "d a_dst")


def _batch_case(seed, n_ch, n=200, e=1200, kz=16):
    rng = np.random.default_rng(seed)
    gr = build_gat_graph(rng.integers(0, n, e), rng.integers(0, n, e), n,
                         analytic_loops=False)
    z = (rng.standard_normal((n_ch, n, kz)) * 0.3).astype(np.float32)
    a_src = (rng.standard_normal((n_ch, n)) * 0.5).astype(np.float32)
    a_dst = (rng.standard_normal((n_ch, n)) * 0.5).astype(np.float32)
    g = rng.standard_normal((n_ch, n, kz)).astype(np.float32)
    return n, z, a_src, a_dst, g, np.array(gr.src), np.array(gr.dst)


def _torch_batch_grads(case, transport):
    n, z, a_src, a_dst, g, src, dst = case
    ins = [torch.from_numpy(a).requires_grad_() for a in (z, a_src, a_dst)]
    out = tbg.batch_gat_attention(*ins, torch.from_numpy(src), torch.from_numpy(dst),
                                  n, 0.2, transport)
    return torch.autograd.grad(out, ins, torch.from_numpy(g))


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_batch_grads_match_jax_k4(transport):
    case = _batch_case(2, 7)
    n, z, a_src, a_dst, g, src, dst = case
    _, vjp = jax.vjp(
        lambda *a: jbg.batch_gat_attention(*a, src, dst, n, 0.2, True, transport),
        jnp.asarray(z), jnp.asarray(a_src), jnp.asarray(a_dst),
    )
    jgrads = vjp(jnp.asarray(g))
    launches = tbg.batch_gat_bwd.launches
    tgrads = _torch_batch_grads(case, transport)
    assert tbg.batch_gat_bwd.launches == launches
    for name, tg, jg in zip(("dz", "da_src", "da_dst"), tgrads, jgrads):
        assert tg.dtype == torch.float32  # z's dtype: f32, unrounded
        _close(tg.numpy(), jg, transport, name)


def test_batch_two_channels_grads_match_flash_per_channel():
    """The 2-channel share (step 2's u2i group): in f32, where K2 and K4
    round nowhere, its gradients equal per-channel flash gradients."""
    n, z, a_src, a_dst, g, src, dst = _batch_case(3, 2)
    dz, das, dad = _torch_batch_grads((n, z, a_src, a_dst, g, src, dst), "f32")
    for c in range(2):
        kz = z.shape[2]
        dp, da = _torch_flash_grads(
            (n, kz, z[c].T.copy(), a_src[c], a_dst[c], g[c], src, dst, None, None), "f32")
        _close(dz[c].numpy(), dp[:kz, :n].t().numpy(), "f32", "dz")
        _close(das[c].numpy(), dp[kz, :n].numpy(), "f32", "da_src")
        _close(dad[c].numpy(), da.numpy(), "f32", "da_dst")


def test_zero_edge_graphs_give_exact_zero_grads():
    n, kz, n_ch = 100, 8, 3
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.standard_normal((n_ch, n, kz)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((n_ch, n)).astype(np.float32))
    e = torch.zeros(0, dtype=torch.int32)
    ins = [t.clone().requires_grad_() for t in (z, a, a)]
    out = tbg.batch_gat_attention(*ins, e, e, n, 0.2, "bf16")
    grads = torch.autograd.grad(out, ins, torch.ones_like(out))
    assert all(gr.shape == t.shape and not gr.any() for gr, t in zip(grads, ins))
    packed = tfg.pack_gat_table(z[0].t(), a[0], n, torch.bfloat16).requires_grad_()
    ad = a[0].clone().requires_grad_()
    out = tfg.flash_gat_attention(packed, ad, e, e, e, e, n, kz, 0.2, "bf16")
    dp, da = torch.autograd.grad(out, (packed, ad), torch.ones_like(out))
    assert not out.any() and not dp.any() and not da.any()
    assert dp.dtype == torch.bfloat16


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_padding_edges_add_nothing(transport):
    """Sentinel edges (dst == num_rows) with any src, even past the table,
    change no gradient bit."""
    n, z, a_src, a_dst, g, src, dst = _batch_case(5, 3)
    real = dst < n
    base = _torch_batch_grads((n, z, a_src, a_dst, g, src[real], dst[real]), transport)
    pad_src = np.concatenate([src[real], np.array([0, n - 1, 7] * 50, np.int32)])
    pad_dst = np.concatenate([dst[real], np.full(150, n, np.int32)])
    padded = _torch_batch_grads((n, z, a_src, a_dst, g, pad_src, pad_dst), transport)
    for a, b in zip(base, padded):
        assert torch.equal(a, b)
    case = _flash_case(6, n=150, e=900, pad=0)
    fn, kz, z_t, fa_src, fa_dst, fg, fsrc, fdst, perm, srt = case
    base = _torch_flash_grads(case, transport)
    psrc = np.concatenate([fsrc, np.full(64, fn, np.int32)])
    pdst = np.concatenate([fdst, np.full(64, fn, np.int32)])
    padded = _torch_flash_grads((fn, kz, z_t, fa_src, fa_dst, fg, psrc, pdst, perm, srt),
                                transport)
    for a, b in zip(base, padded):
        assert torch.equal(a, b)
