"""K5, K6 and K7 on rows wider than the kernels' MAX_COLS (256 columns a
launch), and the glue route that reaches K6 at kz + 1 columns, on the CPU.

The wrappers take any width on both devices: on the card K5 and K6 run in
passes of at most MAX_COLS columns and K7 gathers a row wider than
GATHER_ROW_BYTES as pieces of it (tests/test_torch_kernels.py,
test_segment_kernels_past_max_cols); here their plain versions run, and
the piece ids are held to a numpy gather.  At
D = 300 the port's sorted_segment_sum (K5) and localized_scatter_add (K6)
are held against the JAX package's ``ops/segment.segment_sum`` of the
messages rounded to the transport dtype (f32 sums in another order: 1e-6
of the largest value), and sorted_broadcast (K7) against a numpy row
gather (bitwise), in both transports.  The glue route
(``FlashGATMode(bwd="glue")``: K13, then K6 on its kz + 1 columns) runs
at kz 300 on a graph of a few hundred edges against the JAX glue backward
``_bwd_glue_impl(fused_scatter=False)`` in interpret mode, called as
tests/test_torch_flash_modes.py::test_glue_backward_matches_jax_k13 calls
it, at that file's backward tolerances (f32 1e-5, bf16 1e-4 of the
largest value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu.ops import config as jcfg
from graph_recsys_benchmark_tpu.ops import flash_gat as jfg
from graph_recsys_benchmark_tpu.ops.segment import segment_sum as jsegment_sum
from graph_recsys_benchmark_tpu_torch.ops import flash_gat as tfg
from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as tsk
from graph_recsys_benchmark_tpu_torch.ops.config import FlashGATMode

TRANSPORTS = ["f32", "bf16"]
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
SUM_TOL = 1e-6
BWD_TOL = {"f32": 1e-5, "bf16": 1e-4}
WIDE = 300


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops beside the other pytest workers: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol}"


def _edges(rng, n, e, pad):
    """A block-ordered edge list (graph.py's order) and `pad` padding edges
    (dst n, src 0)."""
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    order = np.lexsort((dst, src, dst // 128))
    src = np.concatenate([src[order], np.zeros(pad, np.int64)]).astype(np.int32)
    dst = np.concatenate([dst[order], np.full(pad, n)]).astype(np.int32)
    return src, dst


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_wide_rows_match_jax_and_numpy(transport):
    rng = np.random.default_rng(0)
    n, e = 150, 900
    src, dst = _edges(rng, n, e, 20)
    msgs = rng.standard_normal((dst.size, WIDE)).astype(np.float32)
    rounded = np.asarray(jnp.asarray(msgs, JDT[transport]).astype(jnp.float32))
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    before = (tsk.sorted_segment_sum.launches, tsk.sorted_broadcast.launches,
              tsk.localized_scatter_add.launches)

    got = tsk.sorted_segment_sum(torch.from_numpy(msgs), td, n, transport)
    assert got.shape == (n, WIDE) and got.dtype == torch.float32
    _close(got, jsegment_sum(rounded, dst, n), SUM_TOL, "K5 by dst")

    # K6 by a shuffled idx; its input in the transport dtype, as the path hands it
    perm = rng.permutation(dst.size)
    ct = torch.from_numpy(msgs[perm]).to(TDT[transport])
    got = tsk.localized_scatter_add(ct, torch.from_numpy(src[perm]), n, transport)
    assert got.shape == (n, WIDE)
    _close(got, jsegment_sum(rounded[perm], src[perm], n), SUM_TOL, "K6 by src")

    table = torch.from_numpy(msgs[:n]).to(TDT[transport])
    got = tsk.sorted_broadcast(table, td, n)
    want = np.concatenate([table.float().numpy(), np.zeros((1, WIDE), np.float32)])[dst]
    assert got.dtype == TDT[transport]
    np.testing.assert_array_equal(got.float().numpy(), want)
    after = (tsk.sorted_segment_sum.launches, tsk.sorted_broadcast.launches,
             tsk.localized_scatter_add.launches)
    assert after == before  # CPU tensors: the plain versions, no launch


@pytest.mark.parametrize("k, elem_bytes, m", [(300, 4, 1), (1024, 4, 1), (2100, 4, 3),
                                               (2100, 2, 2), (1031, 4, 1031)])
def test_wide_gather_pieces_match_numpy(k, elem_bytes, m):
    """K7 on the card gathers a row wider than GATHER_ROW_BYTES as m equal
    pieces of it, the rows of the table seen as [N * m, k / m], in one
    launch: the fewest pieces of at most GATHER_ROW_BYTES (a prime width
    past it, one column a piece), and the gather of _piece_ids over that
    view, by the plain version the kernel is held to, equal bitwise to a
    numpy row gather with zero rows for the padding ids."""
    assert tsk._gather_pieces(k, elem_bytes) == m
    rng = np.random.default_rng(2)
    n, e = 9, 40
    table = rng.standard_normal((n, k)).astype(np.float32)
    idx = rng.integers(0, n, e).astype(np.int32)
    idx[[3, 17, 39]] = [n, n, n + 5]  # padding ids, one past the sentinel
    ids = tsk._piece_ids(torch.from_numpy(idx), n, m)
    assert ids.dtype == torch.int32 and ids.shape == (e * m,)
    got = tsk.sorted_broadcast_plain(torch.from_numpy(table).reshape(n * m, k // m), ids, n * m)
    want = np.concatenate([table, np.zeros((1, k), np.float32)])[np.minimum(idx, n)]
    np.testing.assert_array_equal(got.reshape(e, k).numpy(), want)


def _glue_case(seed, n=200, e=360, kz=WIDE, pad=24):
    rng = np.random.default_rng(seed)
    src, dst = _edges(rng, n, e, pad)
    z_t = rng.standard_normal((kz, n)).astype(np.float32)
    a_src = rng.standard_normal(n).astype(np.float32)
    a_dst = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal((n, kz)).astype(np.float32)
    return n, kz, z_t, a_src, a_dst, g, src, dst


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_glue_route_at_kz_300_matches_jax(transport, monkeypatch):
    """K13's rows and da_dst, then K6 on the rows' kz + 1 = 301 columns,
    against JAX's glue backward; then the route itself
    (flash_gat_attention with FlashGATMode(bwd="glue")): its d a_dst and
    its gradient of the packed table against the same JAX values."""
    monkeypatch.setattr(jcfg, "SEGSUM_TRANSPORT", transport)  # JAX's ct dtype
    n, kz, z_t, a_src, a_dst, g, src, dst = _glue_case(1)
    t_dtype = TDT[transport]
    table = torch.from_numpy(np.concatenate([z_t.T, a_src[:, None]], axis=1)).to(t_dtype)
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    adst_r, mhat = tfg.bound_shift(torch.from_numpy(a_dst), table[:, kz], 0.2, t_dtype)
    acc = tfg.flash_gat_fwd_plain(table, adst_r, mhat, ts, td, n, kz)
    s = acc[:, kz]
    out = acc[:, :kz] / (s[:, None] + 1e-16)
    gt = torch.from_numpy(g)
    g_r = gt.to(t_dtype).float()
    gout = (gt * out).sum(dim=1)
    logden = mhat + torch.log(s + 1e-16)
    ct, da = tfg.flash_gat_bwd_glue(table, torch.cat([g_r, gout[:, None]], dim=1), logden,
                                    adst_r, ts, td, n, kz)
    dpk = tsk.localized_scatter_add(ct, ts, n, transport)
    assert ct.shape == (dst.size, kz + 1) and dpk.shape == (n, kz + 1)

    kg_pad = max(8, -(-(kz + 3) // 8) * 8)
    n_pad = -(-(n + 1) // 128) * 128
    gtab_t = np.zeros((kg_pad, n_pad), np.float32)
    gtab_t[:kz, :n] = g_r.numpy().T
    gtab_t[kz, :n] = gout.numpy()
    gtab_t[kz + 1, :n] = logden.numpy()
    gtab_t[kz + 2, :n] = adst_r.numpy()
    packed = jfg.pack_gat_table(jnp.asarray(z_t), jnp.asarray(a_src), n, JDT[transport])
    ct_t, jda = jfg._bwd_glue_impl(packed, jnp.asarray(gtab_t), src, dst, n, kz, 0.2, True,
                                   transport, fused_scatter=False)
    jct = np.asarray(ct_t.astype(jnp.float32))[: kz + 1, : dst.size].T
    _close(ct.float(), jct, BWD_TOL[transport], "ct")
    _close(da, jda, BWD_TOL[transport], "da_dst")
    jdpk = jsegment_sum(ct_t.astype(jnp.float32).T[: dst.size], src, n)[:, : kz + 1]
    _close(dpk, jdpk, BWD_TOL[transport], "dpk")

    tp = tfg.pack_gat_table(torch.from_numpy(z_t), torch.from_numpy(a_src), n,
                            t_dtype).requires_grad_()
    ta = torch.from_numpy(a_dst).requires_grad_()
    route = tfg.flash_gat_attention(tp, ta, ts, td, None, None, n, kz, 0.2, transport,
                                    mode=FlashGATMode(bwd="glue"))
    rdp, rda = torch.autograd.grad(route, (tp, ta), gt)
    assert rdp.dtype == t_dtype and rdp.shape == tp.shape
    _close(rda, jda, BWD_TOL[transport], "route d a_dst")
    want = np.asarray(jnp.asarray(jdpk).astype(JDT[transport]).astype(jnp.float32))
    _close(rdp[: kz + 1, :n].float().numpy().T, want, BWD_TOL[transport], "route d packed")
    assert not rdp[kz + 1:].any() and not rdp[:, n:].any()
