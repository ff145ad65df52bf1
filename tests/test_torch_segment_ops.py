"""The port's segment-sum (K5), row gather (K7) and scatter-add (K6), and
their autograd Functions, against the JAX package's TPU kernels run in
Pallas interpret mode (as tests/test_localized_kernels.py and
tests/test_segment_ops.py run them) and the JAX VJPs.

On the CPU the port's wrappers take their plain versions; these hold the
semantics the CUDA kernels are held to on the card
(tests/test_torch_kernels.py).  Inputs come from numpy seeds: block-ordered
dst with an empty 128-row block and nonzero messages on padding-sentinel
edges (dropped by both), idx shuffled for K6, widths 1, 16 and 64 (the
flagship's) and 65, 17 and 2 (the ML-25M composed GAT's), f32 and bf16.  Tolerances: f32 sums 1e-6 of the largest value (the two sum in
different orders); bf16 copies bitwise; bf16 transport rounds each message
once and sums in f32, held at 1e-6 too.  The VJP tests compare bitwise:
their summed values are small integers, so every sum is exact in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu.ops import gather as jgather
from graph_recsys_benchmark_tpu.ops.pallas_segment import (
    localized_scatter_add_pallas,
    sorted_broadcast_pallas,
    sorted_segment_sum_pallas,
)
from graph_recsys_benchmark_tpu_torch.ops import gather as tgather
from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as tsk

# (rows, edges, width): the flagship's widths and the ML-25M composed GAT's
# odd ones (65 and 17: the [h | a_src] rows; 2: the softmax stats)
SHAPES = [(300, 2600, 16), (130, 700, 64), (13, 77, 1), (300, 2600, 65), (200, 1800, 17),
          (130, 700, 2)]
TRANSPORTS = ["f32", "bf16"]
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _block_dst(rng, n, e, n_pad=37):
    """Block-monotone dst over n rows with no edge in block 1 (rows
    128..255) when n > 256, then `n_pad` padding sentinels (dst == n)."""
    dst = rng.integers(0, n, e)
    if n > 256:
        dst = np.where(dst // 128 == 1, dst + 128, dst)
    src = rng.integers(0, n, e)
    order = np.lexsort((dst, src, dst // 128))
    return np.concatenate([dst[order], np.full(n_pad, n)]).astype(np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("n,e,d", SHAPES)
def test_segment_sum_matches_interpret_kernel(transport, n, e, d):
    rng = np.random.default_rng(0)
    dst = _block_dst(rng, n, e)
    msgs = rng.standard_normal((dst.shape[0], d)).astype(np.float32)
    want = sorted_segment_sum_pallas(jnp.asarray(msgs), jnp.asarray(dst), n, True, transport)
    got = tsk.sorted_segment_sum(_t(msgs), _t(dst), n, transport)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    assert _rel(got.numpy(), want) <= 1e-6
    if n > 256:  # the empty block sums to exact zeros
        assert not got[128:256].any()
    np.testing.assert_array_equal(
        tsk.sorted_segment_sum_plain(_t(msgs), _t(dst), n, transport).numpy(), got.numpy())
    # [E] messages give [num_rows]
    flat = tsk.sorted_segment_sum(_t(msgs[:, 0]), _t(dst), n, transport)
    np.testing.assert_array_equal(flat.numpy(), got[:, 0].numpy())


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("n,e,k", SHAPES)
def test_broadcast_matches_interpret_kernel(transport, n, e, k):
    rng = np.random.default_rng(1)
    idx = rng.permutation(_block_dst(rng, n, e))  # any order; sentinels read zeros
    v = rng.standard_normal((n, k)).astype(np.float32)
    vj = jnp.asarray(v, JDT[transport])
    vt = _t(v, TDT[transport])
    want = np.asarray(sorted_broadcast_pallas(vj, jnp.asarray(idx), n, True), np.float32)
    got = tsk.sorted_broadcast(vt, _t(idx), n)
    assert got.dtype == TDT[transport] and got.shape == (idx.shape[0], k)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[torch.from_numpy(idx == n)].any()
    # the vector form [N] -> [E]
    np.testing.assert_array_equal(tsk.sorted_broadcast(vt[:, 0].contiguous(), _t(idx), n)
                                  .float().numpy(), want[:, 0])
    np.testing.assert_array_equal(tsk.sorted_broadcast_plain(vt, _t(idx), n).float().numpy(),
                                  want)


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("n,e,k", SHAPES)
def test_scatter_add_matches_interpret_kernel(transport, n, e, k):
    rng = np.random.default_rng(2)
    idx = rng.integers(0, n, e).astype(np.int32)  # no order at all
    ct = rng.standard_normal((e, k)).astype(np.float32)
    # padding edges: zero ct at idx 0, as graph.py pads src; plus a few
    # sentinel ids with nonzero ct, which both drop
    idx = np.concatenate([idx, np.zeros(9, np.int32), np.full(4, n, np.int32)])
    ct = np.concatenate([ct, np.zeros((9, k), np.float32),
                         rng.standard_normal((4, k)).astype(np.float32)])
    perm = rng.permutation(idx.shape[0])
    idx, ct = idx[perm], ct[perm]
    want = localized_scatter_add_pallas(jnp.asarray(ct), jnp.asarray(idx), n, interpret=True,
                                        transport=transport)
    got = tsk.localized_scatter_add(_t(ct), _t(idx), n, transport)
    assert got.dtype == torch.float32 and got.shape == (n, k)
    assert _rel(got.numpy(), want) <= 1e-6
    np.testing.assert_array_equal(
        tsk.localized_scatter_add_plain(_t(ct), _t(idx), n, transport).numpy(), got.numpy())


def _small_ints(rng, shape):
    return rng.integers(-8, 9, shape).astype(np.float32)


@pytest.mark.parametrize("msg_t,transport", [("f32", "f32"), ("bf16", "bf16"),
                                             ("f32", "bf16")])
def test_segment_sum_vjp_matches_jax(msg_t, transport):
    """SegmentSum's backward (K7 by dst, cast to the messages' dtype)
    against jax.vjp of sorted_segment_sum_pallas: bitwise."""
    rng = np.random.default_rng(3)
    n, d = 300, 16
    dst = _block_dst(rng, n, 2000)
    msgs = _small_ints(rng, (dst.shape[0], d))
    # a gather of g is exact: full-precision g shows any extra rounding
    g = rng.standard_normal((n, d)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda m: sorted_segment_sum_pallas(m, jnp.asarray(dst), n, True, transport),
        jnp.asarray(msgs, JDT[msg_t]))
    (want,) = vjp(jnp.asarray(g))
    m = _t(msgs, TDT[msg_t]).requires_grad_()
    got = tsk.sorted_segment_sum(m, _t(dst), n, transport)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(_t(g))
    assert m.grad.dtype == TDT[msg_t]
    np.testing.assert_array_equal(m.grad.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("shape", [(300, 16), (130, 2, 8)])
def test_gather_rows_vjp_matches_jax(transport, shape):
    """GatherRows forward (K7) and backward (K6, cast to x's dtype; a 3-D
    x reshapes its cotangent to 2-D) against jax.vjp of gather_rows."""
    rng = np.random.default_rng(4)
    n = shape[0]
    idx = rng.integers(0, n, 3000).astype(np.int32)
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    x = _small_ints(rng, shape)
    ct = _small_ints(rng, (idx.shape[0],) + shape[1:])
    out, vjp = jax.vjp(
        lambda a: jgather.gather_rows(a, jnp.asarray(idx), jnp.asarray(perm),
                                      jnp.asarray(idx[perm]), n),
        jnp.asarray(x, JDT[transport]))
    (want,) = vjp(jnp.asarray(ct, JDT[transport]))
    xt = _t(x, TDT[transport]).requires_grad_()
    got = tgather.gather_rows(xt, _t(idx), transport)
    assert got.dtype == TDT[transport]
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(out, np.float32))
    got.backward(_t(ct, TDT[transport]))
    assert xt.grad.dtype == TDT[transport] and xt.grad.shape == shape
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(want, np.float32))


def test_wrappers_refuse_what_they_cannot_do():
    v = torch.zeros((5, 3), requires_grad=True)
    ids = torch.zeros(4, dtype=torch.int32)
    # K7 has its own VJP (_bc_bwd: the K5 sum by idx): four rows of id 0
    tsk.sorted_broadcast(v, ids, 5).sum().backward()
    np.testing.assert_array_equal(v.grad.numpy()[:, 0], [4.0, 0.0, 0.0, 0.0, 0.0])
    with pytest.raises(NotImplementedError):  # K6 is a backward only
        tsk.localized_scatter_add(v[:4], ids, 5)
    with pytest.raises(ValueError):  # rows of no column (any width >= 1 is taken)
        tsk.sorted_segment_sum(torch.zeros((4, 0)), ids, 5)
    with pytest.raises(ValueError):  # table rows != num_rows
        tsk.sorted_broadcast(v.detach(), ids, 6)
    with pytest.raises(ValueError):
        tsk.sorted_segment_sum(torch.zeros((4, 3)), ids, 5, transport="f16")
