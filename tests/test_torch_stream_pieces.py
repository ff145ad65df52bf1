"""The work split and stat layout of the streaming GAT backwards K10
(stream_gat_bwd_dst) and K11 (stream_gat_bwd_src) on the CPU.

  * StepGraph.src_block_bounds equals a numpy searchsorted over the
    src-sorted ids at multiples of 128, as block_bounds does over dst.
  * The piece plan the kernels walk (CTA k takes chunk k of piece_edges
    edges, cut at the blocks' bounds; written out here as _stream_pieces,
    as csrc/stream_gat.cu computes it per CTA) puts every edge in exactly
    one piece and each piece inside one block and one chunk, on graphs with
    empty blocks and with the padding in row 0's src run.
  * The stat table's rows are padded to a multiple of 8 values
    (stat_width); the plain versions on the padded table equal, bitwise,
    the plain versions of the unpadded layout (frozen below as they were),
    in both transports.
"""

import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.ops import stream_gat as tsg
from graph_recsys_benchmark_tpu_torch.ops.segment import segment_sum

N = 700


def _stream_pieces(bounds, piece_edges):
    """(lo, hi, block) int64[n_pieces] of K10's or K11's pieces in CTA
    order: each nonempty intersection of a chunk ``[k·piece_edges,
    (k+1)·piece_edges)`` of the walk's order with a 128-row block's range
    ``[bounds[b], bounds[b+1])``, as the kernels' CTA k walks chunk k."""
    bb = bounds.long()
    cuts = torch.unique(torch.cat([bb, torch.arange(0, int(bb[-1]), piece_edges)]))
    lo, hi = cuts[:-1], cuts[1:]
    return lo, hi, torch.searchsorted(bb, lo, right=True) - 1


def _graph(seed, empty_block=True, hot=True):
    """A loop-free gat_loops graph over N rows: dst and src block 2 empty,
    one hot dst block and one hot source, real out-edges on row 0."""
    rng = np.random.default_rng(seed)
    e = 5000
    src, dst = rng.integers(0, N, e), rng.integers(0, N, e)
    if hot:
        dst[:1500] = rng.integers(384, 512, 1500)
        src[1500:2500] = 77
    src[:20] = 0
    if empty_block:
        src = np.where(src // 128 == 2, src + 128, src)
        dst = np.where(dst // 128 == 2, dst + 128, dst)
    return tgraph.build_gat_graph(src, dst, N, analytic_loops=True)


@pytest.mark.parametrize("conv", ["gat_loops", "gat", "gcn", "sage"])
def test_src_block_bounds_is_searchsorted(conv):
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, N, 4000), rng.integers(0, N, 4000)
    src = np.where(src // 128 == 2, src + 128, src)
    if conv == "gat_loops":
        g = tgraph.build_gat_graph(src, dst, N, analytic_loops=True)
    else:
        g = {"gat": tgraph.build_gat_graph, "gcn": tgraph.build_gcn_graph,
             "sage": tgraph.build_sage_graph}[conv](src, dst, N)
    s = g.src_sorted.numpy()
    want = np.searchsorted(s, np.arange(0, -(-N // 128) + 1) * 128).astype(np.int32)
    want[-1] = s.shape[0]
    assert g.src_block_bounds.dtype == torch.int32
    np.testing.assert_array_equal(g.src_block_bounds.numpy(), want)
    if conv in ("gat_loops", "sage"):  # the others add a self-loop on every row
        assert int(g.src_block_bounds[3] - g.src_block_bounds[2]) == 0  # the empty block
    # the padding (src 0) lies in block 0's range
    pad = g.dst.shape[0] - g.num_edges
    assert int(g.src_block_bounds[1]) >= pad
    moved = g.to("cpu")
    assert torch.equal(moved.src_block_bounds, g.src_block_bounds)


def test_src_block_bounds_of_a_fused_graph():
    rng = np.random.default_rng(2)
    gs = [tgraph.build_gat_graph(rng.integers(0, N, 900), rng.integers(0, N, 900), N)
          for _ in range(3)]
    u = tgraph.fuse_step_graphs(gs, N)
    s = u.src_sorted.numpy()
    want = np.searchsorted(s, np.arange(0, -(-3 * N // 128) + 1) * 128)
    want[-1] = s.shape[0]
    np.testing.assert_array_equal(u.src_block_bounds.numpy(), want)


@pytest.mark.parametrize("piece", [1, 7, 128, 300, 2048])
@pytest.mark.parametrize("side", ["dst", "src"])
def test_piece_plan_covers_every_edge_once(piece, side):
    g = _graph(3)
    bounds = g.block_bounds if side == "dst" else g.src_block_bounds
    ids = g.dst if side == "dst" else g.src_sorted
    e = g.dst.shape[0]
    lo, hi, blk = _stream_pieces(bounds, piece)
    assert bool((lo < hi).all())
    # in CTA order the pieces tile [0, E): every edge once
    assert int(lo[0]) == 0 and int(hi[-1]) == e and torch.equal(lo[1:], hi[:-1])
    bb = bounds.long()
    assert bool((bb[blk] <= lo).all()) and bool((hi <= bb[blk + 1]).all())
    assert bool((lo // piece == (hi - 1) // piece).all())  # inside one chunk
    assert 2 not in blk.tolist()  # the empty block gets no piece
    # each edge's piece is the block of its row (padding: dst's last block,
    # src 0's block 0)
    pos = torch.arange(e)
    which = torch.repeat_interleave(blk, hi - lo)
    row_block = torch.clamp(ids.long(), max=N - 1) // 128
    assert torch.equal(which[pos], row_block)
    if side == "src":
        pad = e - g.num_edges
        head = g.dst[g.src_perm.long()[: int(hi[blk == 0].max())]]
        assert int((head == N).sum()) == pad
    # the per-CTA load: a chunk's pieces hold at most `piece` edges
    chunk = lo // piece
    assert int(torch.bincount(chunk, weights=(hi - lo).double()).max()) <= piece


# The plain versions as they were before the stat rows were padded
# (stat [num_rows, n_ch*(kz+3)]), frozen here as the reference.


def _old_edge_grads(table, stat, s, d, kz, n_ch, slope):
    t_dtype = table.dtype
    rows = table[s].float().view(-1, n_ch, kz + 1)
    st = stat[d].float().view(-1, n_ch, kz + 3)
    pre = st[:, :, kz + 2] + rows[:, :, kz]
    act = torch.where(pre > 0, pre, slope * pre)
    att = torch.exp(torch.clamp(act - st[:, :, kz + 1], max=60.0))
    datt = (st[:, :, :kz] * rows[:, :, :kz]).to(t_dtype).float().sum(dim=2)
    dalpha = att * (datt - st[:, :, kz])
    dpre = torch.where(pre > 0, dalpha, dalpha * slope)
    return st, att, dpre


def _old_bwd_dst(table, stat, src, dst, num_rows, kz, n_ch):
    real = dst < num_rows
    s, d = src[real].long(), dst[real].long()
    _, _, dpre = _old_edge_grads(table, stat, s, d, kz, n_ch, 0.2)
    return segment_sum(dpre.to(table.dtype).float(), d, num_rows).t().contiguous()


def _old_bwd_src(table, stat, src_perm, src_sorted, dst, num_rows, kz, n_ch):
    d_e = dst[src_perm.long()]
    real = d_e < num_rows
    s, d = src_sorted[real].long(), d_e[real].long()
    st, att, dpre = _old_edge_grads(table, stat, s, d, kz, n_ch, 0.2)
    t_dtype = table.dtype
    att_t = att.to(t_dtype).float()
    ct = torch.cat([(st[:, :, :kz] * att_t[:, :, None]).to(t_dtype).float(),
                    dpre.to(t_dtype).float()[:, :, None]], dim=2)
    dpk = torch.zeros((table.shape[0], n_ch * (kz + 1)))
    return dpk.index_add_(0, s, ct.reshape(-1, n_ch * (kz + 1)))


@pytest.mark.parametrize("n_ch,kz", [(1, 64), (7, 16), (2, 16), (3, 1), (1, 5)])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_padded_stat_plain_equals_unpadded(n_ch, kz, transport):
    g = _graph(5)
    t_dtype = torch.float32 if transport == "f32" else torch.bfloat16
    rng = np.random.default_rng(n_ch * 100 + kz)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    table = torch.cat([randn(N, n_ch, kz, scale=0.5), randn(N, n_ch, 1)], dim=2)
    table = table.reshape(N, -1).to(t_dtype)
    gz, gout, logden, adst = randn(n_ch, N, kz), randn(n_ch, N), randn(n_ch, N), randn(n_ch, N)
    stat = tsg.stat_table(gz, gout, logden + 3.0, adst, t_dtype)
    width = tsg.stat_width(n_ch, kz)
    # (1, 5): a band of 8 values, already a multiple of 8, gets no padding
    assert stat.shape == (N, width) and width % 8 == 0 and width - n_ch * (kz + 3) < 8
    assert not stat[:, n_ch * (kz + 3):].any()  # the padding is zero
    flat = stat[:, : n_ch * (kz + 3)].contiguous()
    want = torch.cat([gz, gout[:, :, None], (logden + 3.0)[:, :, None], adst[:, :, None]], 2)
    assert torch.equal(flat, want.permute(1, 0, 2).reshape(N, -1).to(t_dtype))
    before = (tsg.stream_gat_bwd_dst.launches, tsg.stream_gat_bwd_src.launches)
    da = tsg.stream_gat_bwd_dst(table, stat, g.src, g.dst, N, kz, block_bounds=g.block_bounds)
    assert torch.equal(da, _old_bwd_dst(table, flat, g.src, g.dst, N, kz, n_ch))
    dpk = tsg.stream_gat_bwd_src(table, stat, g.src_perm, g.src_sorted, g.dst, N, kz,
                                 src_block_bounds=g.src_block_bounds)
    assert torch.equal(dpk, _old_bwd_src(table, flat, g.src_perm, g.src_sorted, g.dst, N, kz,
                                         n_ch))
    # CPU tensors take the plain versions: no launch is counted
    assert (tsg.stream_gat_bwd_dst.launches, tsg.stream_gat_bwd_src.launches) == before


def test_attention_with_graph_bounds_equals_computed():
    g = _graph(6)
    rng = np.random.default_rng(7)
    z = torch.from_numpy((0.5 * rng.standard_normal((2, N, 16))).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((2, 2, N)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((2, N, 16)).astype(np.float32))
    grads = []
    for bounds in ((None, None), (g.block_bounds, g.src_block_bounds)):
        ins = [t.clone().requires_grad_() for t in (z, a[0], a[1])]
        out = tsg.stream_gat_attention_batched(*ins, g.src, g.dst, g.src_perm, g.src_sorted,
                                               N, True, 0.2, "bf16", *bounds)
        out.backward(ct)
        grads.append([out.detach()] + [t.grad for t in ins])
    for x, y in zip(*grads):
        assert torch.equal(x, y)
