"""The block bounds that K9 (stream_gat_fwd) and K8 (softmax_stats) take on
the card, on the CPU.

On the card both kernels cut their work at the graph's 128-row dst blocks
(StepGraph.block_bounds): K9 in pieces of a chunk of edges, K8 one CTA a
block.  Their plain versions, which CPU tensors take, read no bounds: with
the graph's bounds, with none and with bounds that cut the edges evenly
(no block's edges) they give the same arrays, bitwise, and those still
match the JAX package's TPU kernels run in Pallas interpret mode, as its
own tests run them: K9 (``_stream_forward``) at 1e-5 of the largest value
in both transports (tests/test_torch_stream_gat.py's bound: the same
rounding points, f32 sums in another order), K8 (``_softmax_stats``) with
its max exact and its sums at 1e-6 (the TPU kernel rescales a running
sum).

K8's kernel takes a block-monotone dst, as the JAX kernel does: every
composed (loop-edge) StepGraph that build_gat_graph makes, here and in
the small ML-25M HIN's 13 channels, has one, and its block_bounds are
the ranges of its 128-row dst blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu.ops import stream_gat as jsg
from graph_recsys_benchmark_tpu.ops.pallas_segment import _softmax_stats
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.ops import flash_gat as tfg
from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as tsk
from graph_recsys_benchmark_tpu_torch.ops import stream_gat as tsg

EXACT_BF16 = {"xla_allow_excess_precision": False}
N, E = 300, 3000
STREAM_TOL = 1e-5
SOFTMAX_TOL = 1e-6
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bounds(g_bounds, e):
    """The three bound tables each plain version is run with: the graph's,
    none, and an even cut of [0, e) into as many ranges."""
    n_blocks = g_bounds.numel() - 1
    even = torch.linspace(0, e, n_blocks + 1).round().to(torch.int32)
    return {"graph": g_bounds, "none": None, "even": even}


@pytest.fixture(scope="module")
def graph():
    """A loop-free gat_loops graph over N rows with a hot dst block and
    padding; row 0 has real out-edges."""
    rng = np.random.default_rng(21)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    dst[:900] = rng.integers(128, 256, 900)
    src[:25] = 0
    g = tgraph.build_gat_graph(src, dst, N, analytic_loops=True)
    assert g.dst.shape[0] > g.num_edges
    return g


def _jax_k9(table, adst_r, mhat, g, kz, n_ch, t_dtype):
    """The JAX package's K9 in interpret mode on the same values: the
    port's [n, n_ch*(kz+1)] table re-laid into its padded bands."""
    jt = jnp.bfloat16 if t_dtype == torch.bfloat16 else jnp.float32
    k_pad, _, n_out = jsg._layout(N, kz, n_ch)
    kb = jsg._band_for(kz)
    bands = np.zeros((N, n_ch, kb), np.float32)
    bands[:, :, : kz + 1] = table.float().view(N, n_ch, kz + 1).numpy()
    packed = np.zeros((n_out, k_pad), np.float32)
    packed[:N, : n_ch * kb] = bands.reshape(N, -1)
    adst2 = np.zeros((n_out, 16), np.float32)
    adst2[:N, :n_ch] = adst_r.numpy().T
    adst2[:N, 8:8 + n_ch] = mhat.numpy().T

    def f(packed, adst2, src, dst):
        packed_e = packed.astype(jt)[src]
        return jsg._stream_forward(packed_e, adst2, dst, N, kz, n_ch, 0.2, True, jt)

    acc = jax.jit(f, compiler_options=EXACT_BF16)(packed, adst2, g.src.numpy(), g.dst.numpy())
    return np.asarray(acc)[:N, : n_ch * kb].reshape(N, n_ch, kb)[:, :, : kz + 1]


@pytest.mark.parametrize("n_ch,kz,transport", [(1, 64, "f32"), (7, 16, "bf16"),
                                               (2, 16, "f32")])
def test_plain_k9_reads_no_bounds_and_matches_interpret_kernel(graph, n_ch, kz, transport):
    t_dtype = TDT[transport]
    rng = np.random.default_rng(n_ch * 10 + kz)
    z = torch.from_numpy((0.5 * rng.standard_normal((n_ch, N, kz))).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((2, n_ch, N)).astype(np.float32))
    band = torch.cat([z.to(t_dtype), a[0][:, :, None].to(t_dtype)], dim=2)
    table = band.permute(1, 0, 2).reshape(N, n_ch * (kz + 1)).contiguous()
    adst_r, mhat = tfg.bound_shift(a[1], band[:, :, kz], 0.2, t_dtype)
    before = tsg.stream_gat_fwd.launches
    accs = {name: tsg.stream_gat_fwd(table, adst_r, mhat, graph.src, graph.dst, N, kz,
                                     block_bounds=b)
            for name, b in _bounds(graph.block_bounds, graph.dst.shape[0]).items()}
    assert tsg.stream_gat_fwd.launches == before  # CPU tensors: the plain version
    for name, acc in accs.items():
        assert torch.equal(acc, accs["graph"]), name
    # every pieces size leaves the plain version alone too
    assert torch.equal(tsg.stream_gat_fwd(table, adst_r, mhat, graph.src, graph.dst, N, kz,
                                          block_bounds=graph.block_bounds, piece_edges=7),
                       accs["graph"])
    want = _jax_k9(table, adst_r, mhat, graph, kz, n_ch, t_dtype)
    assert _rel(accs["none"].view(N, n_ch, kz + 1).numpy(), want) <= STREAM_TOL


def test_plain_k8_reads_no_bounds_and_matches_interpret_kernel(graph):
    """K8 on a composed graph's block-monotone dst with padding logits of
    80 (they must drop out) and an empty block."""
    rng = np.random.default_rng(22)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    dst = np.where(dst // 128 == 1, dst + 128, dst)  # block 1 empty
    g = tgraph.build_gat_graph(src, dst, N)
    real = g.dst < N
    alpha = (3.0 * rng.standard_normal(g.dst.shape[0])).astype(np.float32)
    alpha[~real.numpy()] = 80.0
    jmax, jsum = _softmax_stats(jnp.asarray(alpha), jnp.asarray(g.dst.numpy()), N,
                                interpret=True)
    ta = torch.from_numpy(alpha)
    before = tsk.softmax_stats.launches
    stats = {name: tsk.softmax_stats(ta, g.dst, N, b)
             for name, b in _bounds(g.block_bounds, g.dst.shape[0]).items()}
    assert tsk.softmax_stats.launches == before
    for name, st in stats.items():
        assert torch.equal(st, stats["graph"]), name
    got = stats["none"]
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(jmax))
    assert _rel(got[:, 1].numpy(), jsum) <= SOFTMAX_TOL
    # rows 128..255 hold only their self-loops
    assert bool(torch.isfinite(got[:, 0]).all())
    # the softmax passes the bounds through and reads none on the CPU
    att = [tsk.segment_softmax(ta, g.dst, N, "f32", b) for b in (None, g.block_bounds)]
    assert torch.equal(att[0], att[1]) and not att[0][~real].any()


def _assert_block_monotone(g):
    """dst block-monotone over the padded edge list (padding, dst ==
    num_nodes, last) and block_bounds the ranges of its 128-row blocks."""
    n = g.num_nodes
    n_blocks = max(1, -(-n // 128))
    blk = torch.clamp(g.dst.long(), max=n - 1) // 128
    blk[g.dst >= n] = n_blocks - 1  # the padding sits in the last range
    assert bool((blk[1:] >= blk[:-1]).all())
    bb = g.block_bounds.long()
    assert g.block_bounds.dtype == torch.int32 and bb.numel() == n_blocks + 1
    assert int(bb[0]) == 0 and int(bb[-1]) == g.dst.shape[0]
    counts = torch.bincount(blk, minlength=n_blocks)
    assert torch.equal(torch.diff(bb), counts)
    assert torch.equal(g.block_bounds, tfg.dst_block_bounds(g.dst, n))


@pytest.mark.parametrize("seed,n", [(31, 300), (32, 1000), (33, 256)])
def test_composed_graphs_are_block_monotone(seed, n):
    rng = np.random.default_rng(seed)
    e = 6 * n
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    dst[: e // 3] = rng.integers(0, min(n, 128), e // 3)  # a hot first block
    g = tgraph.build_gat_graph(src, dst, n)
    assert not g.gat_loops
    _assert_block_monotone(g)


def test_ml25m_composed_graphs_are_block_monotone():
    """Every composed step graph of the small ML-25M HIN's 13 channels, as
    the trainer builds them (build_gat_graph, loop edges)."""
    hin = tsyn.synthetic_ml25m_hin(num_users=400, num_items=300, target_interactions=8000,
                                   num_core=3, num_directors=20, num_actors=40,
                                   num_writers=20, num_tags=30, num_genome_tags=40,
                                   tagging_rows=1500)
    seen = 0
    for channel in tml.ml25m_metapath_edges(hin):
        for src, dst in channel:
            g = tgraph.build_gat_graph(src, dst, hin.num_nodes, analytic_loops=False)
            _assert_block_monotone(g)
            seen += 1
    assert seen == 26
