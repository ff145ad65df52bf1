"""The port's streaming GAT (K9-K11, ops/stream_gat.StreamGAT), segment
softmax (K8, ops/segment_kernels.segment_softmax) and dst gather
(ops/gather.gather_dst, K7 forward with its own VJP) against the JAX
package's TPU kernels run in Pallas interpret mode, as its own tests run
them (tests/test_stream_gat.py, tests/test_softmax_gather_kernels.py).

On the CPU the port's wrappers take their plain versions; these hold the
semantics the CUDA kernels are held to on the card
(tests/test_torch_kernels.py).  Inputs come from numpy seeds.  The JAX side
runs under ``jax.jit`` with ``xla_allow_excess_precision`` off, so that its
bf16 casts round where the code says (tests/test_torch_gcn_sage_slice.py).

Tolerances, relative to the largest value:
  * StreamGAT forward and the gradients of z, a_src and a_dst: 1e-5 in both
    transports.  The port rounds at the interpret kernels' points (p, z·p,
    the stat table, g·z, att, dpre and att·g through the transport dtype)
    and differs only in the order of f32 sums (measured up to 1.5e-6); a
    lost bf16 rounding point shows at ~1e-3.
  * segment_softmax: forward 1e-6 (the TPU kernel rescales a running sum,
    the port sums exp(a - max) once), gradients 1e-6; softmax_stats' max is
    exact.
  * gather_dst: forward bitwise (a copy); its VJP, an f32 segment-sum,
    1e-6.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.ops import config as jconfig
from graph_recsys_benchmark_tpu.ops import stream_gat as jsg
from graph_recsys_benchmark_tpu.ops.pallas_segment import (
    _softmax_stats,
    segment_softmax_pallas,
    sorted_broadcast_pallas,
)
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.ops import gather as tgather
from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as tsk
from graph_recsys_benchmark_tpu_torch.ops import stream_gat as tsg

EXACT_BF16 = {"xla_allow_excess_precision": False}
N, E = 300, 3000
# (n_ch, kz, self_loops, transport): each n_ch in {1, 2, 7}, kz in {16, 64},
# loops on and off and both transports appear
STREAM_CASES = [
    (1, 64, True, "f32"),
    (2, 16, False, "bf16"),
    (7, 16, False, "f32"),
    (7, 64, True, "bf16"),
]
STREAM_TOL = 1e-5


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


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
def graphs():
    """One loop-free `gat_loops` graph built by both packages; row 0 has
    real out-edges (the padding edges, src 0, sort into its src run)."""
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    src[:25] = 0
    jg = jgraph.build_gat_graph(src, dst, N, analytic_loops=True)
    tg = tgraph.build_gat_graph(src, dst, N, analytic_loops=True)
    return jg, tg


def test_analytic_graph_equals_jax(graphs):
    jg, tg = graphs
    assert jg.gat_loops and tg.gat_loops
    for f in ("src", "dst", "w", "rel", "src_perm", "src_sorted"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, f)), getattr(tg, f).numpy(),
                                      err_msg=f)
    assert (jg.num_nodes, jg.num_edges, jg.src_span) == (tg.num_nodes, tg.num_edges,
                                                         tg.src_span)
    # loop-free, padded to a multiple of 2048; in src order the padding
    # (src 0) sits inside row 0's run, after its real edges
    assert tg.dst.shape[0] % 2048 == 0 and not bool((tg.src == tg.dst).any())
    pad = tg.dst.shape[0] - tg.num_edges
    row0 = int((tg.src[: tg.num_edges] == 0).sum())
    assert row0 >= 20
    head = tg.dst[tg.src_perm.long()[: row0 + pad]]
    assert bool((head[:row0] < N).all()) and bool((head[row0:] == N).all())
    with pytest.raises(ValueError):  # implicit loops cannot be fused
        tgraph.fuse_step_graphs([tg], N)


def _stream_inputs(seed, n_ch, kz):
    rng = np.random.default_rng(seed)
    z = (0.5 * rng.standard_normal((n_ch, N, kz))).astype(np.float32)
    a_src = rng.standard_normal((n_ch, N)).astype(np.float32)
    a_dst = rng.standard_normal((n_ch, N)).astype(np.float32)
    g = rng.standard_normal((n_ch, N, kz)).astype(np.float32)
    return z, a_src, a_dst, g


def _jax_stream(jg, n, self_loops, transport, z, a_src, a_dst, g):
    def f(z, a_src, a_dst, g):
        out, vjp = jax.vjp(
            lambda z, s, d: jsg.stream_gat_attention_batched(
                z, s, d, jg.src, jg.dst, jg.src_perm, jg.src_sorted, n, self_loops, 0.2,
                True, transport),
            z, a_src, a_dst)
        return out, vjp(g)

    return jax.jit(f, compiler_options=EXACT_BF16)(z, a_src, a_dst, g)


def _torch_stream(tg, n, self_loops, transport, z, a_src, a_dst, g):
    ins = [torch.from_numpy(x).requires_grad_() for x in (z, a_src, a_dst)]
    out = tsg.stream_gat_attention_batched(*ins, tg.src, tg.dst, tg.src_perm, tg.src_sorted,
                                           n, self_loops, 0.2, transport)
    out.backward(torch.from_numpy(g))
    return out, [t.grad for t in ins]


@pytest.mark.parametrize("n_ch,kz,self_loops,transport", STREAM_CASES)
def test_stream_gat_matches_interpret_kernels(graphs, n_ch, kz, self_loops, transport):
    jg, tg = graphs
    args = _stream_inputs(n_ch * 100 + kz, n_ch, kz)
    jout, jgrads = _jax_stream(jg, N, self_loops, transport, *args)
    tout, tgrads = _torch_stream(tg, N, self_loops, transport, *args)
    assert tout.shape == (n_ch, N, kz) and tout.dtype == torch.float32
    assert _rel(tout, jout) <= STREAM_TOL
    for name, a, b in zip(("dz", "da_src", "da_dst"), tgrads, jgrads):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _rel(a, b) <= STREAM_TOL, name


def test_stream_gat_zero_edges_is_the_loop_term():
    """A gat_loops graph with no real edge: the output is the loop term
    alone (att_ii = 1, so out = z rounded to the transport); dz matches the
    JAX package's (bf16), and the logits' gradients, exactly 0 in exact
    arithmetic (a one-term softmax), are finite float noise in both."""
    empty = np.zeros(0, np.int64)
    jg = jgraph.build_gat_graph(empty, empty, 130, analytic_loops=True)
    tg = tgraph.build_gat_graph(empty, empty, 130, analytic_loops=True)
    assert tg.num_edges == 0 and tg.dst.shape[0] == 2048
    rng = np.random.default_rng(5)
    z = (0.3 * rng.standard_normal((1, 130, 8))).astype(np.float32)
    a = rng.standard_normal((2, 1, 130)).astype(np.float32)
    g = rng.standard_normal((1, 130, 8)).astype(np.float32)
    for transport in ("f32", "bf16"):
        tout, tgrads = _torch_stream(tg, 130, True, transport, z, a[0], a[1], g)
        zr = torch.from_numpy(z).to(torch.bfloat16 if transport == "bf16" else torch.float32)
        np.testing.assert_allclose(tout.detach().numpy(), zr.float().numpy(), rtol=1e-6)
        assert all(torch.isfinite(x).all() for x in tgrads)
        for x in tgrads[1:]:
            assert float(x.abs().max()) <= 1e-6 * np.abs(g).max()
    _, jgrads = _jax_stream(jg, 130, True, "bf16", z, a[0], a[1], g)
    assert _rel(tgrads[0], jgrads[0]) <= STREAM_TOL
    assert all(float(np.abs(y).max()) <= 1e-6 * np.abs(g).max() for y in jgrads[1:])


def test_stream_plain_kernels_drop_padding_and_match_reference(graphs):
    """The plain versions of K9-K11 against the exact-max oracle
    (stream_gat_reference, the JAX package's off-TPU path) in f32, and the
    padding edges (in row 0's src run) adding nothing to row 0."""
    _, tg = graphs
    z, a_src, a_dst, g = _stream_inputs(3, 1, 16)
    tz, ts, td = (torch.from_numpy(x[0]).requires_grad_() for x in (z, a_src, a_dst))
    out = tsg.stream_gat_attention(tz, ts, td, tg.src, tg.dst, tg.src_perm, tg.src_sorted, N)
    out.backward(torch.from_numpy(g[0]))
    rz, rs, rd = (torch.from_numpy(x[0]).requires_grad_() for x in (z, a_src, a_dst))
    ref = tsg.stream_gat_reference(rz, rs, rd, tg.src, tg.dst, N)
    ref.backward(torch.from_numpy(g[0]))
    assert _rel(out, ref.detach()) <= 2e-6
    for a, b in ((tz, rz), (ts, rs), (td, rd)):
        assert _rel(a.grad, b.grad) <= 2e-5
    # the src-side backward over a graph whose every edge is padding but
    # whose src-sorted order still starts at row 0: zeros
    table = torch.randn(N, 17)
    stat = torch.randn(N, 19) * 50.0
    pad = torch.full((64,), N, dtype=torch.int32)
    zero_ids = torch.zeros(64, dtype=torch.int32)
    dpk = tsg.stream_gat_bwd_src(table, stat, torch.arange(64, dtype=torch.int32), zero_ids,
                                 pad, N, 16)
    assert not dpk.any()
    # attention dropout keeping every alpha scales the output by 1 / (1 - p)
    with torch.no_grad():
        kept = tsg.stream_gat_reference(rz, rs, rd, tg.src, tg.dst, N, dropout=0.1,
                                        edge_keep=torch.ones(tg.dst.shape[0], dtype=torch.bool),
                                        loop_keep=torch.ones(N, dtype=torch.bool))
    assert _rel(kept * 0.9, ref.detach()) <= 1e-6
    with pytest.raises(ValueError):  # past the kernels' layout limits
        tsg.stream_gat_attention_batched(torch.zeros(9, N, 4), torch.zeros(9, N),
                                         torch.zeros(9, N), tg.src, tg.dst, tg.src_perm,
                                         tg.src_sorted, N)
    assert not tsg.stream_gat_enabled(n_ch=9) and not tsg.stream_gat_enabled(kz=126)
    assert tsg.stream_gat_enabled(kz=125, n_ch=8)


def _softmax_inputs(seed, n=300, e=2600, n_pad=37):
    """Block-ordered dst over n rows with rows 128..255 empty, then
    padding sentinels (dst == n) carrying large logits."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, e)
    dst = np.where(dst // 128 == 1, dst + 128, dst)
    src = rng.integers(0, n, e)
    dst = dst[np.lexsort((dst, src, dst // 128))]
    dst = np.concatenate([dst, np.full(n_pad, n)]).astype(np.int32)
    alpha = (3.0 * rng.standard_normal(dst.shape[0])).astype(np.float32)
    alpha[-n_pad:] = 80.0
    g = rng.standard_normal(dst.shape[0]).astype(np.float32)
    return alpha, dst, g


def test_softmax_stats_match_interpret_kernel():
    alpha, dst, _ = _softmax_inputs(1)
    jmax, jsum = _softmax_stats(jnp.asarray(alpha), jnp.asarray(dst), 300, interpret=True)
    got = tsk.softmax_stats(torch.from_numpy(alpha), torch.from_numpy(dst), 300)
    assert got.shape == (300, 2) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(jmax))  # -inf rows too
    assert bool(torch.isinf(got[128:256, 0]).all()) and not got[128:256, 1].any()
    assert _rel(got[:, 1], jsum) <= 1e-6


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_segment_softmax_matches_interpret_kernel(monkeypatch, transport):
    alpha, dst, g = _softmax_inputs(2)
    monkeypatch.setattr(jconfig, "SEGSUM_TRANSPORT", transport)  # its VJP's segment-sum

    def f(a, g):
        att, vjp = jax.vjp(lambda x: segment_softmax_pallas(x, jnp.asarray(dst), 300, True), a)
        return att, vjp(g)[0]

    jatt, jgrad = jax.jit(f, compiler_options=EXACT_BF16)(alpha, g)
    ta = torch.from_numpy(alpha).requires_grad_()
    att = tsk.segment_softmax(ta, torch.from_numpy(dst), 300, transport)
    att.backward(torch.from_numpy(g))
    assert _rel(att, jatt) <= 1e-6 and _rel(ta.grad, jgrad) <= 1e-6
    assert not att[-37:].any() and not ta.grad[-37:].any()  # padding: att 0, no gradient
    # [E, H] logits: one pass per head
    two = tsk.segment_softmax(torch.from_numpy(np.stack([alpha, -alpha], 1)),
                              torch.from_numpy(dst), 300, transport)
    np.testing.assert_array_equal(two[:, 0].detach().numpy(), att.detach().numpy())


@pytest.mark.parametrize("k", [1, 2])
def test_gather_dst_and_its_vjp_match_jax(k):
    """gather_dst: K7 forward; the VJP ``_bc_bwd`` sums the cotangent by
    dst (exact f32 here: the JAX interpret kernel's VJP runs XLA's
    segment-sum off the TPU) and casts to the table's dtype."""
    rng = np.random.default_rng(k)
    _, dst, _ = _softmax_inputs(k + 7)
    shape = (300,) if k == 1 else (300, k)
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal((dst.shape[0],) + shape[1:]).astype(np.float32)

    def f(x, ct):
        out, vjp = jax.vjp(lambda v: sorted_broadcast_pallas(v, jnp.asarray(dst), 300, True), x)
        return out, vjp(ct)[0]

    jout, jgrad = jax.jit(f)(x, ct)
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    g = types.SimpleNamespace(dst=torch.from_numpy(dst), num_nodes=300,
                              dst_perm=torch.from_numpy(perm),
                              dst_sorted=torch.from_numpy(dst[perm]))
    for dtype in (torch.float32, torch.bfloat16):
        tx = torch.from_numpy(x).to(dtype).requires_grad_()
        out = tgather.gather_dst(tx, g)
        assert out.dtype == dtype
        want = np.asarray(jout) if dtype == torch.float32 else x[np.minimum(dst, 299)]
        want = np.where((dst < 300).reshape((-1,) + (1,) * (len(shape) - 1)), want, 0.0)
        np.testing.assert_array_equal(out.detach().float().numpy(),
                                      torch.from_numpy(want).to(dtype).float().numpy())
        out.backward(torch.from_numpy(ct).to(dtype))
        assert tx.grad.dtype == dtype
        if dtype == torch.float32:
            assert _rel(tx.grad, jgrad) <= 1e-6
