"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: every test skips without a CUDA device (decided in a fixture,
never at import, so every xdist worker collects the same tests).  Shapes are
the flagship's (bench.py:42-59): the step-1 union graph (kz 64, 15,210 rows,
169,472 padded edges) for flash_gat_fwd and flash_gat_bwd, the step-2
shared i2u/u2i graph (kz 16, 1,690 rows, 73,728 padded edges, 7 and 2
channels) for batch_gat_fwd and batch_gat_bwd.  Random block-ordered edges
from a numpy seed stand in for the graphs; the forwards walk the edges'
stable sort by dst (flash_gat.dst_walk, as StepGraph.dst_perm /
dst_sorted), the backwards get the stats of the forward on the same inputs
and walk the edges' stable sort by source (flash_gat.src_walk, as
StepGraph.src_perm / src_sorted), and K4 also
runs on a graph where one source holds 20,000 of the 73,611 edges, each
row of its sums held to the rounding bound of an f32 sum in any order
(_sum_bound, below) of the float64 sums of its plain version's terms.
The forwards' walk also runs at each worker layout (K1/K12 at kz 32 to
300, past its widest layout; K3 at 1 to 8 channels and kz 16 to 125) and
on a graph where one dst row holds 60,000 edges, K2 at kz 257 and 512
(its passes past the widest layout), each row held to _sum_bound.
Tolerances: a kernel against its plain
version on the card, 1e-5 of the largest value in both transports (the two
round at the same points and differ only in the order the atomics add, so
a lost bf16 rounding point, ~1e-3, fails); the card's whole op against the
CPU's, f32 1e-5 and bf16 4e-3 (the JAX tests' bf16 bound: the CPU's exp may
differ from the card's in a last bit, which can move one bf16 rounding);
one training step's loss and median gradient against the CPU's, f32 1e-4
and bf16 2e-2 (chip_smoke.py's forward tolerances: a last-bit difference
in a step-1 output can move a bf16 rounding of step 2's input), every
gradient 5e-2 (a flipped ReLU input, chip_smoke.py KINK_TOL); PEAGCN's and
PEASage's step at the flagship's width over 25 batches, the rows at the
scorer's ReLU kink left out (chip_smoke.kink_rows).

The streaming GAT kernels of csrc/stream_gat.cu (stream_gat_fwd K9,
stream_gat_bwd_dst K10, stream_gat_bwd_src K11) run at the ML-25M shapes'
widths ((n_ch, kz) = (1, 64), (7, 16), (2, 16), and (8, 125), the widest
layout, which K10 and K11 run unstaged) over 68,830 rows and two
loop-free graphs: 400,000 zipf-skewed edges (row 0 with real out-edges;
its src-sorted run also holds the padding), held to the same sums taken
in float64 at 1e-5 of the largest value in both transports (they round at
the plain version's points; f32 atomics in another order over in-degrees
in the thousands); and 300,000 edges with one dst block of 60,000 and one
source of 40,000 (both across many of K10's and K11's pieces, also at
pieces of 300 edges), an empty block and padding, K10 and K11 held row
by row to the rounding bound of an f32 sum in any order (_sum_bound,
chip_smoke.py's gamma_(k-1) * sum |t| rule with each term's own error),
K9 at 1e-5 of the largest value at both piece sizes; K9 and K10 also on
the edges out of block order and K11 on an unsorted src order.
StreamGAT on the card is held to the CPU's at the whole-op tolerances
above.  softmax_stats (K8, one CTA a 128-row dst block of a block-monotone
dst) gets the composed GAT's shape (68,830 rows, 197,000 edges) with an
empty block and padding: its max equals the plain version's bitwise, its
sums the float64 sums at 1e-6; and a block of 60,000 edges, past what a
CTA stages in shared memory, its sums held row by row to _sum_bound.

The edge kernels of csrc/segment.cu (sorted_segment_sum K5,
sorted_broadcast K7, localized_scatter_add K6) run at the flagship's
PEAGCN/PEASage union-graph shapes (15,210 rows; 169,472 or 647,680 padded
edges; D 64 and 16) with padding sentinels and an empty dst block; K6 gets
an unordered idx.  At the ML-25M composed convs' shapes (68,830 rows, a
block-ordered graph of ~169k edges with one 16,282-edge dst block, widths
1, 2, 16, 17, 64 and 65, f32 and bf16) K5 and K6 run on the graph's
sorted walks, on the edges' own order and on an idx out of block order,
and at each of scatter_add's slices on a sorted, an edge-order and a
shuffled walk, each walk first checked to be ids[perm].  K5 and K6 sum
in f32 in another order than the plain version, so each is held to the
same sums taken in float64, row by row within the rounding bound of an
f32 sum in any order (_sum_bound; 1e-6 of the largest value, the bound
before, refused a right K6 at 1.047e-6 at PEASage step 2's shape); K7 is
a copy and equals the plain version bitwise.

The flash-GAT variant routes (ops/config.FlashGATMode) run at the step-1
union shape: gat_rowmax (K12-online's row max) equals its plain version
bitwise and flash_gat_fwd_online (its walk) within KERNEL_TOL;
flash_gat_bwd_glue (K13, on the walk by dst) at kz 16, 64 and 257 on the
union, a hot row, a shuffled edge order, an all-padding and a zero-edge
graph: its stored cotangent rows each within one unit of the transport's
last place of the plain version's (and, at kz 16 and 257, in the dpre
column, the bound on datt summed in two orders), its padding rows exact zeros, its da_dst row
by row within _sum_bound, and K6 on its rows within _sum_bound of the
float64 sums; flash_gat_bwd_onepass (K14) on a skewed graph (one dst
block with 12x the mean's edges), with the default and with 64-edge
pieces and with the edges out of block order, within KERNEL_TOL.
FlashGAT in every mode on the card is held to the CPU's at the whole-op
tolerances.

Run on a machine with the card and nvcc (this file needs neither JAX nor
the repo's conftest):
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import copy

import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu_torch.data import build_mlsmall_hin, synthetic_mlsmall_raw
from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
from graph_recsys_benchmark_tpu_torch.ops import batch_gat as tbg
from graph_recsys_benchmark_tpu_torch.ops import flash_gat as tfg
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as tsk
from graph_recsys_benchmark_tpu_torch.ops import stream_gat as tsg
from graph_recsys_benchmark_tpu_torch.ops.segment import segment_sum
from graph_recsys_benchmark_tpu_torch.train import sampling as tsamp
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

pytestmark = pytest.mark.gpu

KERNEL_TOL = 1e-5
TOL = {"f32": 1e-5, "bf16": 4e-3}
STEP_TOL = {"f32": 1e-4, "bf16": 2e-2}
KINK_TOL = 5e-2
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _edges(rng, n, e_real, e_pad, dev):
    src = rng.integers(0, n, e_real)
    dst = rng.integers(0, n, e_real)
    order = np.lexsort((dst, src, dst // 128))
    src = np.concatenate([src[order], np.zeros(e_pad - e_real, np.int64)])
    dst = np.concatenate([dst[order], np.full(e_pad - e_real, n)])
    return (torch.from_numpy(src.astype(np.int32)).to(dev),
            torch.from_numpy(dst.astype(np.int32)).to(dev))


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_flash_kernel_matches_plain(cuda, transport):
    rng = np.random.default_rng(0)
    n, kz = 15210, 64
    src, dst = _edges(rng, n, 169155, 169472, cuda)
    z_t = torch.from_numpy(rng.standard_normal((kz, n), dtype=np.float32)).to(cuda)
    a_src = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(cuda)
    a_dst = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(cuda)
    table = torch.cat([z_t.t(), a_src[:, None]], dim=1).to(TDT[transport])
    adst_r, mhat = tfg.bound_shift(a_dst, table[:, kz], 0.2, TDT[transport])
    perm, srt = tfg.dst_walk(dst)
    before = tfg.flash_gat_fwd.launches
    got = tfg.flash_gat_fwd(table, adst_r, mhat, src, dst, n, kz, dst_perm=perm,
                            dst_sorted=srt)
    torch.cuda.synchronize()
    assert tfg.flash_gat_fwd.launches == before + 1
    want = tfg.flash_gat_fwd_plain(table, adst_r, mhat, src, dst, n, kz)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= KERNEL_TOL


@pytest.mark.parametrize("n_ch", [7, 2])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_batch_kernel_matches_plain(cuda, transport, n_ch):
    rng = np.random.default_rng(1)
    n, kz = 1690, 16
    src, dst = _edges(rng, n, 73611, 73728, cuda)
    z = torch.from_numpy(rng.standard_normal((n_ch, n, kz), dtype=np.float32)).to(cuda)
    a_src = torch.from_numpy(rng.standard_normal((n_ch, n), dtype=np.float32)).to(cuda)
    a_dst = torch.from_numpy(rng.standard_normal((n_ch, n), dtype=np.float32)).to(cuda)
    table, adst_r, mhat = tbg._pack_tables(z, a_src, a_dst, n, kz, n_ch, 0.2, TDT[transport])
    perm, srt = tfg.dst_walk(dst)
    before = tbg.batch_gat_fwd.launches
    got = tbg.batch_gat_fwd(table, adst_r, mhat, src, dst, n, kz, dst_perm=perm,
                            dst_sorted=srt)
    torch.cuda.synchronize()
    assert tbg.batch_gat_fwd.launches == before + 1
    want = tbg.batch_gat_fwd_plain(table, adst_r, mhat, src, dst, n, kz)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= KERNEL_TOL


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_attention_on_card_matches_cpu(cuda, transport):
    """Whole ops on a small graph: CUDA path vs the CPU plain path."""
    rng = np.random.default_rng(2)
    n, kz, n_ch = 700, 16, 3
    src, dst = _edges(rng, n, 6000, 6144, torch.device("cpu"))
    z = torch.from_numpy(rng.standard_normal((n_ch, n, kz), dtype=np.float32))
    a_src = torch.from_numpy(rng.standard_normal((n_ch, n), dtype=np.float32))
    a_dst = torch.from_numpy(rng.standard_normal((n_ch, n), dtype=np.float32))
    cpu = tbg.batch_gat_attention(z, a_src, a_dst, src, dst, n, 0.2, transport)
    gpu = tbg.batch_gat_attention(z.to(cuda), a_src.to(cuda), a_dst.to(cuda),
                                  src.to(cuda), dst.to(cuda), n, 0.2, transport)
    assert _rel_err(gpu.cpu(), cpu) <= TOL[transport]
    packed = tfg.pack_gat_table(z[0].t(), a_src[0], n, TDT[transport])
    cpu = tfg.flash_gat_attention(packed, a_dst[0], src, dst, None, None, n, kz, 0.2, transport)
    gpu = tfg.flash_gat_attention(packed.to(cuda), a_dst[0].to(cuda), src.to(cuda),
                                  dst.to(cuda), None, None, n, kz, 0.2, transport)
    assert _rel_err(gpu.cpu(), cpu) <= TOL[transport]


def _bwd_inputs(table, adst_r, mhat, acc, kz, rng, t_dtype):
    """The backward's stats from the forward accumulator on the same
    inputs and a random output cotangent g, as the autograd Functions
    build them."""
    n_ch, num_rows = adst_r.shape
    acc_b = acc.view(num_rows, n_ch, kz + 1)
    s = acc_b[:, :, kz].t()
    out = acc_b[:, :, :kz] / (acc_b[:, :, kz:] + 1e-16)
    g = torch.from_numpy(rng.standard_normal(out.shape, dtype=np.float32)).to(acc.device)
    gtab = torch.cat([g.to(t_dtype).float(), (g * out).sum(dim=2, keepdim=True)], dim=2)
    logden = mhat + torch.log(s + 1e-16)
    return gtab.reshape(num_rows, -1).contiguous(), logden.contiguous()


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_flash_bwd_kernel_matches_plain(cuda, transport):
    rng = np.random.default_rng(3)
    n, kz, t_dtype = 15210, 64, TDT[transport]
    src, dst = _edges(rng, n, 169155, 169472, cuda)
    table = torch.from_numpy(rng.standard_normal((n, kz + 1), dtype=np.float32)).to(cuda)
    table = table.to(t_dtype)
    a_dst = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(cuda)
    adst_r, mhat = tfg.bound_shift(a_dst, table[:, kz], 0.2, t_dtype)
    acc = tfg.flash_gat_fwd_plain(table, adst_r, mhat, src, dst, n, kz)
    gtab, logden = _bwd_inputs(table, adst_r[None], mhat[None], acc, kz, rng, t_dtype)
    args = (table, gtab, logden[0], adst_r, src, dst, n, kz)
    perm, srt = tfg.src_walk(src)
    before = tfg.flash_gat_bwd.launches
    got = tfg.flash_gat_bwd(*args, src_perm=perm, src_sorted=srt)
    torch.cuda.synchronize()
    assert tfg.flash_gat_bwd.launches == before + 1
    want = tfg.flash_gat_bwd_plain(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert _rel_err(a, b) <= KERNEL_TOL


@pytest.mark.parametrize("n_ch", [7, 2])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_batch_bwd_kernel_matches_plain(cuda, transport, n_ch):
    rng = np.random.default_rng(4)
    n, kz, t_dtype = 1690, 16, TDT[transport]
    src, dst = _edges(rng, n, 73611, 73728, cuda)
    z = torch.from_numpy(rng.standard_normal((n_ch, n, kz), dtype=np.float32)).to(cuda)
    a_src = torch.from_numpy(rng.standard_normal((n_ch, n), dtype=np.float32)).to(cuda)
    a_dst = torch.from_numpy(rng.standard_normal((n_ch, n), dtype=np.float32)).to(cuda)
    table, adst_r, mhat = tbg._pack_tables(z, a_src, a_dst, n, kz, n_ch, 0.2, t_dtype)
    acc = tbg.batch_gat_fwd_plain(table, adst_r, mhat, src, dst, n, kz)
    gtab, logden = _bwd_inputs(table, adst_r, mhat, acc, kz, rng, t_dtype)
    args = (table, gtab, logden, adst_r, src, dst, n, kz)
    perm, srt = tfg.src_walk(src)
    before = tbg.batch_gat_bwd.launches
    got = tbg.batch_gat_bwd(*args, src_perm=perm, src_sorted=srt)
    torch.cuda.synchronize()
    assert tbg.batch_gat_bwd.launches == before + 1
    want = tbg.batch_gat_bwd_plain(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert _rel_err(a, b) <= KERNEL_TOL


@pytest.mark.parametrize("n_ch", [7, 2])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_batch_bwd_kernel_on_a_hot_source(cuda, transport, n_ch):
    """K4 at the step-2 shape with one source holding 20,000 of the 73,611
    edges (its run across many warps' slices, beside row 0's run with the
    padding): dpk by src and da_dst by dst, each row within _sum_bound of
    the float64 sums of the plain version's terms (each dpre term with its
    own error, _gat_bwd_terms)."""
    rng = np.random.default_rng(5)
    n, kz, t_dtype, e_real, e_pad = 1690, 16, TDT[transport], 73611, 73728
    src, dst = rng.integers(0, n, e_real), rng.integers(0, n, e_real)
    src[:20000] = 777
    order = np.lexsort((dst, src, dst // 128))
    src = np.concatenate([src[order], np.zeros(e_pad - e_real, np.int64)])
    dst = np.concatenate([dst[order], np.full(e_pad - e_real, n)])
    src, dst = (torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (src, dst))
    z = torch.from_numpy(rng.standard_normal((n_ch, n, kz), dtype=np.float32)).to(cuda)
    a_src = torch.from_numpy(rng.standard_normal((n_ch, n), dtype=np.float32)).to(cuda)
    a_dst = torch.from_numpy(rng.standard_normal((n_ch, n), dtype=np.float32)).to(cuda)
    table, adst_r, mhat = tbg._pack_tables(z, a_src, a_dst, n, kz, n_ch, 0.2, t_dtype)
    acc = tbg.batch_gat_fwd_plain(table, adst_r, mhat, src, dst, n, kz)
    gtab, logden = _bwd_inputs(table, adst_r, mhat, acc, kz, rng, t_dtype)
    perm, srt = tfg.src_walk(src)
    dpk, da_dst = tbg.batch_gat_bwd(table, gtab, logden, adst_r, src, dst, n, kz,
                                    src_perm=perm, src_sorted=srt)
    torch.cuda.synchronize()
    real = dst < n
    s, d = src[real].long(), dst[real].long()
    dpre_t, err, ct, ct_err = _gat_bwd_terms(table, gtab, logden, adst_r, s, d, kz, t_dtype)
    assert torch.isfinite(dpk).all() and torch.isfinite(da_dst).all()
    assert (torch.bincount(s, minlength=n)[777] >= 20000).item()
    assert ((dpk.double() - segment_sum(ct, s, n)).abs()
            <= _sum_bound(ct, s, n, ct_err)).all()
    assert ((da_dst.t().double() - segment_sum(dpre_t, d, n)).abs()
            <= _sum_bound(dpre_t, d, n, err)).all()


# every worker layout of csrc/gat_bwd.cu's walk (launch_walk): K2 at kz
# <= 32, 64, 128 and 256 and past it (257 and 512: 256-column passes), K4
# at kz <= 16 (up to 2, 4 and 8 channels), 32, 64 and 128 (the flagship's
# own K2 kz 64 and K4 kz 16 at 7 and 2 channels are tested above)
LAYOUT_CASES = [("K2", 1, 32), ("K2", 1, 100), ("K2", 1, 200), ("K2", 1, 257),
                ("K2", 1, 512), ("K4", 3, 16), ("K4", 3, 32), ("K4", 7, 32), ("K4", 3, 64),
                ("K4", 7, 64), ("K4", 3, 125), ("K4", 7, 125)]


@pytest.mark.parametrize("kernel,n_ch,kz", LAYOUT_CASES)
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_gat_bwd_kernel_at_each_layout(cuda, transport, kernel, n_ch, kz):
    """K2 and K4 at each worker layout: dpk by src and da_dst by dst, each
    row within _sum_bound of the float64 sums of the plain version's terms
    (each dpre term with its own error, _gat_bwd_terms).  Not KERNEL_TOL of
    the largest value: the kernel sums datt's kz products in another order
    than torch, and at kz 200 in bf16 that moves a round_T(dpre) by one
    unit of bf16 (2.2e-5 of the largest value on the H100)."""
    rng = np.random.default_rng(6)
    n, t_dtype = 1000, TDT[transport]
    src, dst = _edges(rng, n, 12000, 12288, cuda)
    z = torch.from_numpy(rng.standard_normal((n_ch, n, kz), dtype=np.float32)).to(cuda)
    a_src = torch.from_numpy(rng.standard_normal((n_ch, n), dtype=np.float32)).to(cuda)
    a_dst = torch.from_numpy(rng.standard_normal((n_ch, n), dtype=np.float32)).to(cuda)
    table, adst_r, mhat = tbg._pack_tables(z, a_src, a_dst, n, kz, n_ch, 0.2, t_dtype)
    acc = tbg.batch_gat_fwd_plain(table, adst_r, mhat, src, dst, n, kz)
    gtab, logden = _bwd_inputs(table, adst_r, mhat, acc, kz, rng, t_dtype)
    perm, srt = tfg.src_walk(src)
    if kernel == "K2":
        wrapper = tfg.flash_gat_bwd
        args = (table, gtab, logden[0], adst_r[0], src, dst, n, kz)
    else:
        wrapper = tbg.batch_gat_bwd
        args = (table, gtab, logden, adst_r, src, dst, n, kz)
    before = wrapper.launches
    dpk, da_dst = wrapper(*args, src_perm=perm, src_sorted=srt)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert dpk.shape == (n, n_ch * (kz + 1)) and da_dst.numel() == n_ch * n
    assert torch.isfinite(dpk).all() and torch.isfinite(da_dst).all()
    real = dst < n
    s, d = src[real].long(), dst[real].long()
    da_t, da_err, ct, ct_err = _gat_bwd_terms(table, gtab, logden, adst_r, s, d, kz, t_dtype,
                                              kernel == "K4")
    assert ((dpk.double() - segment_sum(ct, s, n)).abs()
            <= _sum_bound(ct, s, n, ct_err)).all()
    assert ((da_dst.reshape(n_ch, n).t().double() - segment_sum(da_t, d, n)).abs()
            <= _sum_bound(da_t, d, n, da_err)).all()


# every worker layout of csrc/gat_fwd.cu's walk (launch_walk): K1/K12 at kz
# <= 32, 64, 128, 256 and past it (300: two 256-column passes), K3 at each
# of 1, 2, 3, 7 and 8 channels with kz 16, 32, 64 and 125
FWD_LAYOUT_CASES = ([("K1", 1, kz) for kz in (32, 64, 100, 200, 300)]
                    + [("K3", n_ch, kz) for n_ch in (1, 2, 3, 7, 8)
                       for kz in (16, 32, 64, 125)])


def _fwd_call(cuda, rng, kernel, n_ch, kz, t_dtype, src, dst, n):
    """(wrapper, args) of a forward call on random tables, and the float64
    terms its plain version sums by dst for the real edges."""
    z = torch.from_numpy(rng.standard_normal((n_ch, n, kz), dtype=np.float32)).to(cuda)
    a_src = torch.from_numpy(rng.standard_normal((n_ch, n), dtype=np.float32)).to(cuda)
    a_dst = torch.from_numpy(rng.standard_normal((n_ch, n), dtype=np.float32)).to(cuda)
    table, adst_r, mhat = tbg._pack_tables(z, a_src, a_dst, n, kz, n_ch, 0.2, t_dtype)
    real = dst < n
    terms = tfg._fwd_edge_terms(table, adst_r, mhat, src[real].long(), dst[real].long(), kz,
                                kernel == "K3", 0.2).double()
    if kernel == "K1":
        return tfg.flash_gat_fwd, (table, adst_r[0], mhat[0], src, dst, n, kz), terms
    return tbg.batch_gat_fwd, (table, adst_r, mhat, src, dst, n, kz), terms


def _check_fwd(wrapper, args, terms, dst, n, n_ch, kz):
    """One launch on the walk by dst; each row within _sum_bound of the
    float64 sums of the plain version's terms (the kernel adds the same
    f32 terms, the same expf and products, in another order)."""
    perm, srt = tfg.dst_walk(dst)
    before = wrapper.launches
    acc = wrapper(*args, dst_perm=perm, dst_sorted=srt)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert acc.shape == (n, n_ch * (kz + 1)) and torch.isfinite(acc).all()
    d = dst[dst < n].long()
    assert ((acc.double() - segment_sum(terms, d, n)).abs() <= _sum_bound(terms, d, n)).all()


@pytest.mark.parametrize("kernel,n_ch,kz", FWD_LAYOUT_CASES)
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_gat_fwd_kernel_at_each_layout(cuda, transport, kernel, n_ch, kz):
    """K1/K12 and K3 at each worker layout, on the walk by dst."""
    rng = np.random.default_rng(7)
    n = 1000
    src, dst = _edges(rng, n, 12000, 12288, cuda)
    wrapper, args, terms = _fwd_call(cuda, rng, kernel, n_ch, kz, TDT[transport], src, dst, n)
    _check_fwd(wrapper, args, terms, dst, n, n_ch, kz)


@pytest.mark.parametrize("kernel,n_ch,kz", [("K1", 1, 64), ("K3", 7, 16)])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_gat_fwd_kernel_on_a_hot_row(cuda, transport, kernel, n_ch, kz):
    """The flagship's K1/K12 and K3 layouts with one dst row holding 60,000
    of 100,000 edges: its run crosses many workers' slices."""
    rng = np.random.default_rng(8)
    n, e_real, e_pad = 1690, 100000, 100352
    src, dst = rng.integers(0, n, e_real), rng.integers(0, n, e_real)
    dst[:60000] = 777
    order = np.lexsort((dst, src, dst // 128))
    src = np.concatenate([src[order], np.zeros(e_pad - e_real, np.int64)])
    dst = np.concatenate([dst[order], np.full(e_pad - e_real, n)])
    src, dst = (torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (src, dst))
    wrapper, args, terms = _fwd_call(cuda, rng, kernel, n_ch, kz, TDT[transport], src, dst, n)
    assert (torch.bincount(dst[dst < n].long(), minlength=n)[777] >= 60000).item()
    _check_fwd(wrapper, args, terms, dst, n, n_ch, kz)


def _gat_bwd_terms(table, gtab, logden, adst_r, s, d, kz, t_dtype, round_att_first=True):
    """The float64 terms K4 (round_att_first) or K2 adds for real edges (s,
    d), as its plain version computes them: da_dst's [E, n_ch] (K4
    round_T(dpre), K2 dpre) and the rows [E, n_ch*(kz+1)] [round_T(g * a) |
    round_T(dpre)], with a bound on each dpre term's own error, by
    _bwd_terms' rule: the kernel sums datt's kz products (K4 rounded) in
    another order than torch's (at most twice gamma_(kz-1) * sum |p|
    apart), which att and leaky' scale, three roundings after it add 6
    units of |dpre|, and bf16's rounding of a moved dpre one unit of bf16.
    att is the same f32 computation in both."""
    n_ch = adst_r.shape[0]
    rows = table[s].float().view(-1, n_ch, kz + 1)
    g = gtab[d].view(-1, n_ch, kz + 1)
    pre = adst_r[:, d].t() + rows[:, :, kz]
    act = torch.where(pre > 0, pre, 0.2 * pre)
    att = torch.exp(torch.clamp(act - logden[:, d].t(), max=60.0))
    ct, dpre = tfg._bwd_edge_terms(table, gtab, logden, adst_r, s, d, kz, round_att_first,
                                   0.2)
    prod = g[:, :, :kz] * rows[:, :, :kz]
    prod = (prod.to(t_dtype).float() if round_att_first else prod).abs().sum(2).double()
    gam = (kz - 1) * U_SUM / (1 - (kz - 1) * U_SUM)
    sigma = torch.where(pre > 0, 1.0, 0.2).double()
    err = 2 * gam * prod * att.double() * sigma * (1 + 4 * U_SUM) + 6 * U_SUM * dpre.abs().double()
    err_t = err
    if t_dtype == torch.bfloat16:
        err_t = err + 2.0 ** -7 * (dpre.abs().double() + err)
    ct_err = torch.zeros((len(s), n_ch, kz + 1), dtype=torch.float64, device=ct.device)
    ct_err[:, :, kz] = err_t
    ct_err = ct_err.reshape(len(s), -1)
    if round_att_first:
        return dpre.to(t_dtype).double(), err_t, ct.double(), ct_err
    return dpre.double(), err, ct.double(), ct_err


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_training_step_on_card_matches_cpu(cuda, transport):
    """One step's loss and every parameter gradient: the card (kernels)
    against a CPU copy (plain versions) on the same weights and batch."""
    hin = build_mlsmall_hin(*synthetic_mlsmall_raw(seed=3, num_users=80, num_items=100),
                            num_core=5, num_feat_core=3)
    cfg = PEAConfig(conv="gat", num_nodes=hin.num_nodes, meta_path_steps=(2,) * 9,
                    emb_dim=16, hidden_size=16, repr_dim=8, entity_aware=True)
    tr = {d: PEATrainer(hin, cfg, TrainConfig(), device=d, transport=transport)
          for d in ("cuda", "cpu")}
    params = {"cuda": tr["cuda"].init(0)}
    with torch.no_grad():  # off the init regime, where the user
        params["cuda"].x.mul_(10.0)  # representations' gradients vanish
        params["cuda"].fc1["b"].mul_(0.1)  # (test_torch_train_slice.py)
    params["cpu"] = copy.deepcopy(params["cuda"]).cpu()
    batch = tr["cpu"]._build_batch(torch.arange(256), torch.Generator().manual_seed(0))
    mask = (torch.arange(256) < 200).float()
    launches = [k.launches for k in (tfg.flash_gat_fwd, tbg.batch_gat_fwd,
                                     tfg.flash_gat_bwd, tbg.batch_gat_bwd)]
    losses = {}
    for d in ("cuda", "cpu"):
        losses[d] = tr[d].batch_loss(params[d], batch.to(d), mask.to(d))
        losses[d].backward()
    torch.cuda.synchronize()
    after = [k.launches for k in (tfg.flash_gat_fwd, tbg.batch_gat_fwd,
                                  tfg.flash_gat_bwd, tbg.batch_gat_bwd)]
    assert [a - b for a, b in zip(after, launches)] == [1, 2, 1, 2]
    tol = STEP_TOL[transport]
    card, cpu = (float(losses[d].detach()) for d in ("cuda", "cpu"))
    assert abs(card - cpu) <= tol * abs(cpu)
    errs = []
    for (name, pg), pc in zip(params["cuda"].named_parameters(), params["cpu"].parameters()):
        assert pg.grad is not None and torch.isfinite(pg.grad).all(), name
        if pc.grad.any():
            errs.append(_rel_err(pg.grad.cpu(), pc.grad))
        else:  # fc2's bias cancels in pos − neg, on both devices
            assert not pg.grad.any(), name
    # a ReLU / leaky input at 0 can flip between the devices' summation
    # orders and move one node's contribution (chip_smoke.py KINK_TOL)
    errs.sort()
    assert errs[len(errs) // 2] <= tol and errs[-1] <= KINK_TOL, errs


@pytest.fixture(scope="module")
def flagship(cuda):
    """chip_smoke.py's flagship HIN and trainers (PEAGCN and PEASage on the
    fused path, full width and depth)."""
    import chip_smoke

    return chip_smoke.build_flagship()[1]


@pytest.mark.parametrize("transport", ["f32", "bf16"])
@pytest.mark.parametrize("conv", ["gcn", "sage"])
def test_fused_step_grads_match_cpu_over_batches(flagship, conv, transport):
    """chip_smoke.py's PEAGCN / PEASage step check (the median leaf at
    STEP_TOL, every leaf at KINK_TOL, weights off the init regime, a
    partial batch) over 25 seeded batches, with the rows that
    chip_smoke.kink_rows finds at the scorer's ReLU kink left out of both
    sides: no batch may fail, whichever rows it draws."""
    import chip_smoke
    from graph_recsys_benchmark_tpu_torch.models.pea import pea_forward, pea_loss

    tr = flagship[conv][transport]
    cfg, bs = tr.cfg, tr.tcfg.batch_size
    cpu_graphs = tuple(g.to("cpu") for g in tr.graphs)
    base = tr.init(2020)
    with torch.no_grad():
        base.x.mul_(10.0)
        base.fc1["b"].mul_(0.1)
    cpu_base = copy.deepcopy(base).cpu()
    tol = STEP_TOL[transport]
    for seed in range(25):
        rows = torch.randperm(tr.n_rows, device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(1000 + seed))
        batch = tr._build_batch(rows[:bs], torch.Generator(device="cuda").manual_seed(seed))
        kinks = chip_smoke.kink_rows(f"{conv} {transport} batch {seed}", batch,
                                     (base, tr.eval_forward), (cpu_base, lambda m: pea_forward(
                                         m, cpu_graphs, cfg, transport=transport)))
        mask = ((torch.arange(bs) < bs - 100) & ~kinks).float()
        card, cpu = copy.deepcopy(base), copy.deepcopy(cpu_base)
        tr.batch_loss(card, batch, mask.cuda()).backward()
        pea_loss(cpu, cpu_graphs, cfg, batch.cpu(), row_mask=mask, transport=transport).backward()
        torch.cuda.synchronize()
        errs = chip_smoke.leaf_errors(f"{conv} {transport}", card, cpu)
        assert errs[len(errs) // 2][0] <= tol and errs[-1][0] <= KINK_TOL, (seed, errs)


def test_wrappers_reject_bad_inputs(cuda):
    n, kz = 300, 8
    table = torch.zeros((n + 1, kz + 1), device=cuda)
    stat = torch.zeros(n, device=cuda)
    ids = torch.zeros(16, dtype=torch.int32, device=cuda)
    fwalk = dict(dst_perm=ids, dst_sorted=ids)
    before = (tfg.flash_gat_fwd.launches, tbg.batch_gat_fwd.launches)
    with pytest.raises(ValueError):  # int64 ids
        tfg.flash_gat_fwd(table, stat, stat, ids.long(), ids, n, kz, **fwalk)
    with pytest.raises(ValueError):  # ids on the CPU
        tfg.flash_gat_fwd(table, stat, stat, ids.cpu(), ids, n, kz, **fwalk)
    with pytest.raises(ValueError):  # f16 table
        tfg.flash_gat_fwd(table.half(), stat, stat, ids, ids, n, kz, **fwalk)
    with pytest.raises(ValueError):  # 9 channels
        tbg.batch_gat_fwd(torch.zeros((n, 9 * (kz + 1)), device=cuda),
                          torch.zeros((9, n), device=cuda), torch.zeros((9, n), device=cuda),
                          ids, ids, n, kz, **fwalk)
    with pytest.raises(ValueError, match="dst_perm"):  # no walk: a CUDA call never sorts
        tfg.flash_gat_fwd(table, stat, stat, ids, ids, n, kz)
    with pytest.raises(ValueError, match="dst_perm"):  # no walk
        tbg.batch_gat_fwd(table, stat[None], stat[None], ids, ids, n, kz)
    with pytest.raises(ValueError):  # an int64 walk
        tfg.flash_gat_fwd(table, stat, stat, ids, ids, n, kz, dst_perm=ids.long(),
                          dst_sorted=ids)
    with pytest.raises(ValueError):  # a walk shorter than the edges
        tbg.batch_gat_fwd(table, stat[None], stat[None], ids, ids, n, kz, dst_perm=ids[:8],
                          dst_sorted=ids[:8])
    assert (tfg.flash_gat_fwd.launches, tbg.batch_gat_fwd.launches) == before
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    out = tfg.flash_gat_fwd(table, stat, stat, empty, empty, n, kz, dst_perm=empty,
                            dst_sorted=empty)
    assert out.shape == (n, kz + 1) and not out.any()
    assert (tfg.flash_gat_fwd.launches, tbg.batch_gat_fwd.launches) == before
    gtab = torch.zeros((n, kz + 1), device=cuda)
    walk = dict(src_perm=ids, src_sorted=ids)
    before = (tfg.flash_gat_bwd.launches, tbg.batch_gat_bwd.launches)
    with pytest.raises(ValueError):  # bf16 stat table
        tfg.flash_gat_bwd(table, gtab.bfloat16(), stat, stat, ids, ids, n, kz, **walk)
    with pytest.raises(ValueError):  # stat table of the wrong width
        tfg.flash_gat_bwd(table, gtab[:, :kz].contiguous(), stat, stat, ids, ids, n, kz,
                          **walk)
    with pytest.raises(ValueError):  # int64 ids
        tfg.flash_gat_bwd(table, gtab, stat, stat, ids, ids.long(), n, kz, **walk)
    with pytest.raises(ValueError):  # non-contiguous table
        tfg.flash_gat_bwd(table.t().contiguous().t(), gtab, stat, stat, ids, ids, n, kz,
                          **walk)
    with pytest.raises(ValueError):  # 9 channels
        tbg.batch_gat_bwd(torch.zeros((n, 9 * (kz + 1)), device=cuda),
                          torch.zeros((n, 9 * (kz + 1)), device=cuda),
                          torch.zeros((9, n), device=cuda), torch.zeros((9, n), device=cuda),
                          ids, ids, n, kz, **walk)
    with pytest.raises(ValueError):  # no walk: a CUDA call never sorts for itself
        tfg.flash_gat_bwd(table, gtab, stat, stat, ids, ids, n, kz)
    with pytest.raises(ValueError):  # no walk
        tbg.batch_gat_bwd(table, gtab, stat[None], stat[None], ids, ids, n, kz)
    with pytest.raises(ValueError):  # a walk shorter than the edges
        tfg.flash_gat_bwd(table, gtab, stat, stat, ids, ids, n, kz, src_perm=ids[:8],
                          src_sorted=ids[:8])
    with pytest.raises(ValueError):  # an int64 walk
        tfg.flash_gat_bwd(table, gtab, stat, stat, ids, ids, n, kz, src_perm=ids.long(),
                          src_sorted=ids)
    with pytest.raises(ValueError):  # the walk on the CPU
        tbg.batch_gat_bwd(table, gtab, stat[None], stat[None], ids, ids, n, kz,
                          src_perm=ids, src_sorted=ids.cpu())
    wide = torch.zeros((n, 2 * 127), device=cuda)
    with pytest.raises(ValueError, match="kz 126"):  # K4 past its wrapper's limit, 125
        tbg.batch_gat_bwd(wide, wide, torch.zeros((2, n), device=cuda),
                          torch.zeros((2, n), device=cuda), ids, ids, n, 126, **walk)
    dpk, da = tfg.flash_gat_bwd(table, gtab, stat, stat, empty, empty, n, kz, src_perm=empty,
                                src_sorted=empty)
    assert dpk.shape == (n + 1, kz + 1) and da.shape == (n,)
    assert not dpk.any() and not da.any()
    assert (tfg.flash_gat_bwd.launches, tbg.batch_gat_bwd.launches) == before


def test_eval_negatives_draw_on_the_card(cuda):
    """A generator named 'cuda' serves tables on cuda:N; a CPU generator is
    refused rather than drawing on the CPU."""
    cand = torch.arange(12, dtype=torch.int32, device=cuda).view(2, 6)
    ids = torch.zeros(2, dtype=torch.int32, device=cuda)
    z = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    tables = tsamp.DeviceTables(
        train_pos=z, test_users=ids, test_items=cand[:, 0], mode="dense", cand=cand,
        neg_counts=torch.full((2,), 5, dtype=torch.int32, device=cuda), seen_all=z,
        seen_train=z, cnt_all=z[0], cnt_train=z[0], item_lo=0,
        num_items=12, user_lo=0, item_feat=z, item_feat_counts=z[0], user_feat=z,
        user_feat_counts=z[0], ent_lo=z[0], ent_hi=z[0])
    negs = tsamp.sample_eval_negatives(torch.Generator(device="cuda").manual_seed(0), tables, 7)
    assert negs.device == cand.device and negs.shape == (2, 7)
    assert bool(((negs >= cand[:, 1:2]) & (negs <= cand[:, 5:6])).all())
    with pytest.raises(ValueError):
        tsamp.sample_eval_negatives(torch.Generator().manual_seed(0), tables, 7)


SEG_TOL = 1e-6


def _exact(rows, ids, n, transport):
    """The sums in float64 of the rows rounded to the transport dtype."""
    return segment_sum(rows.to(TDT[transport]).double(), ids, n)
# (rows, real edges, padded edges, D): GCN step 1 and step 2, SAGE step 2
SEG_SHAPES = [(15210, 169155, 169472, 64), (15210, 662499, 662528, 16),
              (15210, 647289, 647680, 64)]


def _seg_inputs(rng, n, e_real, e_pad, d, dev, empty_block=3):
    """Block-ordered edges (no dst in 128-row block `empty_block`), padding
    sentinels, and random f32 rows per edge."""
    src, dst = _edges(rng, n, e_real, e_pad, torch.device("cpu"))
    dst[dst // 128 == empty_block] -= 128  # into the block before, then re-sorted
    order = torch.from_numpy(np.lexsort((dst.numpy(), src.numpy(), dst.numpy() // 128)))
    src, dst = src[order].to(dev), dst[order].to(dev)
    rows = torch.from_numpy(rng.standard_normal((e_pad, d), dtype=np.float32)).to(dev)
    return src, dst, rows


@pytest.mark.parametrize("transport", ["f32", "bf16"])
@pytest.mark.parametrize("n,e_real,e_pad,d", SEG_SHAPES)
def test_segment_kernels_match_plain(cuda, transport, n, e_real, e_pad, d):
    rng = np.random.default_rng(5)
    src, dst, rows = _seg_inputs(rng, n, e_real, e_pad, d, cuda)
    t_dtype = TDT[transport]
    before = (tsk.sorted_segment_sum.launches, tsk.sorted_broadcast.launches,
              tsk.localized_scatter_add.launches)
    # K5 (messages rounded to the transport dtype inside)
    got = tsk.sorted_segment_sum(rows, dst, n, transport)
    want = tsk.sorted_segment_sum_plain(rows, dst, n, transport)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape and torch.isfinite(got).all()
    terms = rows.to(t_dtype).double()
    assert ((got.double() - _exact(rows, dst, n, transport)).abs()
            <= _sum_bound(terms, dst, n)).all()
    assert not got[3 * 128:4 * 128].any()  # the empty block (3)
    # K7 by src (the gather) and by dst (K5's backward), in the table's dtype
    table = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(cuda).to(t_dtype)
    for idx in (src, dst):
        got = tsk.sorted_broadcast(table, idx, n)
        assert got.dtype == t_dtype
        assert torch.equal(got, tsk.sorted_broadcast_plain(table, idx, n))
    assert not got[dst == n].any()
    # K6 by an unordered idx
    perm = torch.from_numpy(rng.permutation(e_pad)).to(cuda)
    idx, ct = src[perm].contiguous(), rows[perm].to(t_dtype)
    got = tsk.localized_scatter_add(ct, idx, n, transport)
    want = tsk.localized_scatter_add_plain(ct, idx, n, transport)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape and torch.isfinite(got).all()
    assert ((got.double() - _exact(ct, idx, n, transport)).abs()
            <= _sum_bound(ct.double(), idx, n)).all()
    after = (tsk.sorted_segment_sum.launches, tsk.sorted_broadcast.launches,
             tsk.localized_scatter_add.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 2, 1]


@pytest.mark.parametrize("k", [1, 3, 17, 256])
def test_segment_kernels_odd_widths(cuda, k):
    """Widths that no 16-byte vector divides (K7's narrow words, K5's and
    K6's scalar loads into a padded accumulator), [E] vectors, and a table
    view that is not 16-byte aligned."""
    rng = np.random.default_rng(6)
    n = 300
    src, dst, rows = _seg_inputs(rng, n, 2900, 3072, k, cuda, empty_block=1)
    for transport in ("f32", "bf16"):
        assert _rel_err(tsk.sorted_segment_sum(rows, dst, n, transport).double(),
                        _exact(rows, dst, n, transport)) <= SEG_TOL
        assert _rel_err(tsk.localized_scatter_add(rows, src, n, transport).double(),
                        _exact(rows, src, n, transport)) <= SEG_TOL
        table = rows[: n + 1].to(TDT[transport])[1:]  # offset by one row
        assert torch.equal(tsk.sorted_broadcast(table, src, n),
                           tsk.sorted_broadcast_plain(table, src, n))
        vec = table[:, 0].contiguous()
        assert torch.equal(tsk.sorted_broadcast(vec, src, n),
                           tsk.sorted_broadcast_plain(vec, src, n))


@pytest.mark.parametrize("walk", [False, True])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
@pytest.mark.parametrize("d", [257, 300, 512, 1031, 2100])
def test_segment_kernels_past_max_cols(cuda, d, transport, walk):
    """K5, K6 and K7 on rows wider than MAX_COLS: K5 and K6 one counted
    launch a pass of at most MAX_COLS columns, each row within _sum_bound
    of the float64 sums, with and without the graph's walk by id; K7 one
    launch, a bitwise copy, from a table view that is not 16-byte aligned
    (past GATHER_ROW_BYTES in f32, 1031 and 2100, as pieces of the row:
    1031 of one column, 3 of 700)."""
    rng = np.random.default_rng(7)
    n = 300
    src, dst, rows = _seg_inputs(rng, n, 2900, 3072, d, cuda, empty_block=1)
    passes = -(-d // tsk.MAX_COLS)
    t_dtype = TDT[transport]
    counters = (tsk.sorted_segment_sum, tsk.sorted_broadcast, tsk.localized_scatter_add)
    before = [c.launches for c in counters]
    dst_order = tfg.dst_walk(dst) if walk else None
    src_order = tfg.src_walk(src) if walk else None
    got = tsk.sorted_segment_sum(rows, dst, n, transport, dst_order)
    torch.cuda.synchronize()
    assert got.shape == (n, d) and got.dtype == torch.float32
    terms = rows.to(t_dtype).double()
    assert ((got.double() - _exact(rows, dst, n, transport)).abs()
            <= _sum_bound(terms, dst, n)).all()
    ct = rows.to(t_dtype)
    got = tsk.localized_scatter_add(ct, src, n, transport, src_order)
    torch.cuda.synchronize()
    assert got.shape == (n, d)
    assert ((got.double() - _exact(ct, src, n, transport)).abs()
            <= _sum_bound(ct.double(), src, n)).all()
    table = rows[: n + 1].to(t_dtype)[1:]  # offset by one row
    got = tsk.sorted_broadcast(table, src, n)
    assert torch.equal(got, tsk.sorted_broadcast_plain(table, src, n))
    assert [c.launches - b for c, b in zip(counters, before)] == [passes, 1, passes]


def test_segment_kernels_reject_bad_inputs(cuda):
    ids = torch.zeros(16, dtype=torch.int32, device=cuda)
    rows = torch.zeros((16, 8), device=cuda)
    before = (tsk.sorted_segment_sum.launches, tsk.sorted_broadcast.launches,
              tsk.localized_scatter_add.launches)
    with pytest.raises(ValueError):  # int64 ids
        tsk.sorted_segment_sum(rows, ids.long(), 10)
    with pytest.raises(ValueError):  # ids on the CPU
        tsk.localized_scatter_add(rows, ids.cpu(), 10)
    with pytest.raises(ValueError):  # f16 table
        tsk.sorted_broadcast(rows[:10].half(), ids, 10)
    with pytest.raises(ValueError):  # rows of no column (any width >= 1 is taken)
        tsk.localized_scatter_add(torch.zeros((16, 0), device=cuda), ids, 10)
    with pytest.raises(ValueError):  # one id short
        tsk.sorted_segment_sum(rows, ids[:15], 10)
    after = (tsk.sorted_segment_sum.launches, tsk.sorted_broadcast.launches,
             tsk.localized_scatter_add.launches)
    assert after == before
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    out = tsk.sorted_segment_sum(rows[:0], empty, 10)  # no edges: zeros
    assert out.shape == (10, 8) and not out.any()


ML_ROWS = 68830
ML_HOT_EDGES = 16282


@pytest.fixture(scope="module")
def ml25m_graph(cuda):
    """An ML-25M composed-GAT-like graph in block order over 68,830 rows:
    a loop edge a row, 84,000 random edges and one 128-row dst block
    (rows 0..127) of 16,282 edges, as u2t's and i2t's busiest; padded."""
    rng = np.random.default_rng(9)
    n, hot = ML_ROWS, ML_HOT_EDGES - 128
    src = np.concatenate([np.arange(n), rng.integers(0, n, 84_000), rng.integers(0, n, hot)])
    dst = np.concatenate([np.arange(n), rng.integers(128, n, 84_000), rng.integers(0, 128, hot)])
    return tgraph.build_sage_graph(src, dst, n).to(cuda)


@pytest.mark.parametrize("d", [1, 2, 16, 17, 64, 65])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_segment_kernels_at_ml25m_shapes(cuda, ml25m_graph, transport, d):
    """K7 bitwise, K5 and K6 row by row within _sum_bound, at the ML-25M
    composed convs' rows and widths: on the graph's sorted walks (as the
    path), on the edges' own order, and on an idx out of block order with
    and without its own sorted walk."""
    g = ml25m_graph
    n, e = g.num_nodes, g.dst.numel()
    assert int(torch.diff(g.block_bounds).max()) == ML_HOT_EDGES
    rng = np.random.default_rng(d)
    t_dtype = TDT[transport]

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda)

    perm = torch.from_numpy(rng.permutation(e)).to(cuda)
    shuffled = g.src[perm].contiguous()
    table = randn(n, d).to(t_dtype)
    for idx in (g.src, g.dst, shuffled):
        got = tsk.sorted_broadcast(table, idx, n)
        assert got.dtype == t_dtype and torch.equal(got, tsk.sorted_broadcast_plain(table, idx, n))
    assert not tsk.sorted_broadcast(table, g.dst, n)[g.dst == n].any()  # padding: zeros
    rows = randn(e, d)
    terms = rows.to(t_dtype).double()
    for order in ((g.dst_perm, g.dst_sorted), None):
        if order is not None:  # the kernel sums by the walk's ids: ids[perm]
            assert torch.equal(order[1], g.dst[order[0].long()])
        got = tsk.sorted_segment_sum(rows, g.dst, n, transport, order)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (n, d)
        assert ((got.double() - _exact(rows, g.dst, n, transport)).abs()
                <= _sum_bound(terms, g.dst, n)).all()
    ct = rows.to(t_dtype)
    ct[g.num_edges:] = 0  # padding edges carry zero cotangent (graph.py)
    sp = torch.argsort(shuffled, stable=True).to(torch.int32)
    for idx, c, order in ((g.src, ct, (g.src_perm, g.src_sorted)), (shuffled, ct[perm], None),
                          (shuffled, ct[perm], (sp, shuffled[sp.long()].contiguous()))):
        if order is not None:
            assert torch.equal(order[1], idx[order[0].long()])
        got = tsk.localized_scatter_add(c, idx, n, transport, order)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (n, d)
        assert ((got.double() - _exact(c, idx, n, transport)).abs()
                <= _sum_bound(c.double(), idx, n)).all()


@pytest.mark.parametrize("d,e_real", [(2, 2900), (17, 2900), (17, 9000)])
def test_scatter_add_walks_at_each_slice(cuda, d, e_real):
    """scatter_add picks its slice from the call's shape: 4 positions a
    group at width 2, 8 at 17, 16 at 17 where the call averages more than
    4 edges a row.  At each, K5 by dst and K6 by src on the sorted walk, on
    the edges' own order and on a shuffled walk (perm random, the walk
    ids[perm]) hold row by row to _sum_bound."""
    rng = np.random.default_rng(d + e_real)
    n = 2000
    src, dst, rows = _seg_inputs(rng, n, e_real, -(-e_real // 512) * 512, d, cuda)
    e = dst.numel()
    shuffle = torch.from_numpy(rng.permutation(e)).to(cuda)
    for ids, wrapper in ((dst, tsk.sorted_segment_sum), (src, tsk.localized_scatter_add)):
        sp = torch.argsort(ids, stable=True)
        for order in ((sp.to(torch.int32), ids[sp]), None,
                      (shuffle.to(torch.int32), ids[shuffle])):
            if order is not None:
                assert torch.equal(order[1], ids[order[0].long()])
            got = wrapper(rows, ids, n, "f32", order)
            torch.cuda.synchronize()
            assert got.dtype == torch.float32 and got.shape == (n, d)
            assert ((got.double() - _exact(rows, ids, n, "f32")).abs()
                    <= _sum_bound(rows.double(), ids, n)).all()


STREAM_ROWS = 68830
# f32 sums against float64 (sum_bound, as chip_smoke.py's): one f32
# addition's unit roundoff plus the float64 reference's, a flushed
# subnormal per addition
U_SUM = 2.0 ** -24 + 2.0 ** -53
F32_TINY = 2.0 ** -126


@pytest.fixture(scope="module")
def stream_graph(cuda):
    """A loop-free graph over the ML-25M node count with zipf-skewed
    sources (tens of thousands of out-edges on the top rows) and real
    out-edges on row 0."""
    rng = np.random.default_rng(11)
    e = 400_000
    pop = 1.0 / np.arange(1, STREAM_ROWS + 1) ** 0.8
    src = rng.choice(STREAM_ROWS, size=e, p=pop / pop.sum())
    dst = rng.integers(0, STREAM_ROWS, e)
    src[:50] = 0
    return tgraph.build_gat_graph(src, dst, STREAM_ROWS, analytic_loops=True).to(cuda)


@pytest.fixture(scope="module")
def skewed_graph(cuda):
    """A loop-free graph whose dst block 5 holds 60,000 of 300,000 edges and
    whose source 777 has 40,000 out-edges, so that both span many pieces of
    K10 and K11; dst block 3 and src block 3 are empty; row 0 has real
    out-edges and its src run holds the padding."""
    rng = np.random.default_rng(12)
    e = 300_000
    src, dst = rng.integers(0, STREAM_ROWS, e), rng.integers(0, STREAM_ROWS, e)
    dst[:60_000] = rng.integers(640, 768, 60_000)
    src[60_000:100_000] = 777
    src[:50] = 0
    src = np.where(src // 128 == 3, src + 128, src)
    dst = np.where(dst // 128 == 3, dst + 128, dst)
    g = tgraph.build_gat_graph(src, dst, STREAM_ROWS, analytic_loops=True)
    assert g.dst.shape[0] > g.num_edges  # padding present
    return g.to(cuda)


def _stream_tables(rng, n_ch, kz, t_dtype, dev):
    """The kernels' inputs as StreamGAT builds them, from random z, a_src,
    a_dst, an output cotangent and the forward kernel's own stats."""
    n = STREAM_ROWS

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    band = torch.cat([(0.5 * randn(n_ch, n, kz)).to(t_dtype),
                      randn(n_ch, n, 1).to(t_dtype)], dim=2)
    table = band.permute(1, 0, 2).reshape(n, -1).contiguous()
    adst_r, mhat = tfg.bound_shift(randn(n_ch, n), band[:, :, kz], 0.2, t_dtype)
    return table, adst_r, mhat, randn(n_ch, n, kz)


def _stat_table(acc, mhat, adst_r, g, n_ch, kz, t_dtype):
    n = acc.shape[0]
    acc_b = acc.view(n, n_ch, kz + 1)
    s = acc_b[:, :, kz].t()
    out = acc_b[:, :, :kz].permute(1, 0, 2) / (s[:, :, None] + 1e-16)
    return tsg.stat_table(g, (g * out).sum(2), mhat + torch.log(s + 1e-16), adst_r, t_dtype)


def _sum_bound(terms, ids, n, term_err=None):
    """Per-row bound on |f32 sum - exact sum| of float64 `terms` [E, k] by
    `ids` (ids >= n dropped) in any order: gamma_(k-1) * sum |t| (Higham,
    eq. 4.4), a flushed subnormal per addition, and each term's own error
    where given."""
    absum = segment_sum(terms.abs(), ids, n)
    k = torch.bincount(ids.long().clamp(max=n), minlength=n + 1)[:n].double()[:, None]
    gamma = (k - 1).clamp(min=0) * U_SUM
    gamma = gamma / (1 - gamma)
    bound = gamma * absum + k * F32_TINY
    if term_err is not None:
        bound = bound + segment_sum(term_err, ids, n) * (1 + gamma)
    return bound


def _bwd_terms(table, stat, s, d, kz, t_dtype):
    """The float64 terms K10 and K11 add for real edges (s, d), computed
    as the plain versions compute them: round_T(dpre) [E, n_ch] and K11's
    rows [E, n_ch*(kz+1)], with a bound on each round_T(dpre)'s own error.
    The kernel's datt sums kz rounded products in another order than
    torch's: each is within gamma_(kz-1) * sum |p| of the exact sum, so they
    differ by at most twice that, which att and leaky' scale; the three
    roundings after it add 6 units of |dpre|, and bf16's rounding of a
    moved dpre one more unit of bf16 (2^-7 of it).  att itself is the same
    f32 computation in both (the same expf), so K11's dz terms are exact."""
    n_ch = table.shape[1] // (kz + 1)
    st, att, dpre = tsg._edge_grads(table, stat, s, d, kz, n_ch, 0.2)
    rows = table[s].float().view(-1, n_ch, kz + 1)
    pre = st[:, :, kz + 2] + rows[:, :, kz]
    prod = (st[:, :, :kz] * rows[:, :, :kz]).to(t_dtype).float().abs().sum(2).double()
    gam = (kz - 1) * U_SUM / (1 - (kz - 1) * U_SUM)
    sigma = torch.where(pre > 0, 1.0, 0.2).double()
    err = 2 * gam * prod * att.double() * sigma * (1 + 4 * U_SUM) + 6 * U_SUM * dpre.abs().double()
    if t_dtype == torch.bfloat16:
        err = err + 2.0 ** -7 * (dpre.abs().double() + err)
    dpre_t = dpre.to(t_dtype).double()
    att_t = att.to(t_dtype).float()
    ct = torch.cat([(st[:, :, :kz] * att_t[:, :, None]).to(t_dtype).double(),
                    dpre_t[:, :, None]], dim=2)
    ct_err = torch.cat([torch.zeros_like(ct[:, :, :kz]), err[:, :, None]], dim=2)
    return dpre_t, err, ct.reshape(len(s), -1), ct_err.reshape(len(s), -1)


@pytest.mark.parametrize("n_ch,kz", [(1, 64), (7, 16), (2, 16), (8, 125)])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
@pytest.mark.parametrize("graph", ["popular", "skewed"])
def test_stream_kernels_match_plain(cuda, stream_graph, skewed_graph, graph, transport, n_ch,
                                    kz):
    """K9-K11 against the float64 sums of their plain versions' terms:
    K9 at 1e-5 of the largest value; K10 and K11 on the zipf graph at 1e-5
    of the largest value, on the skewed graph each row within _sum_bound;
    each at the default pieces and, on the skewed graph, at pieces of 300
    edges (a block and a source across many CTAs)."""
    g, n = (stream_graph if graph == "popular" else skewed_graph), STREAM_ROWS
    t_dtype = TDT[transport]
    rng = np.random.default_rng(n_ch * 1000 + kz)
    table, adst_r, mhat, gz = _stream_tables(rng, n_ch, kz, t_dtype, cuda)
    fargs = (table, adst_r, mhat, g.src, g.dst, n, kz)
    pieces = [None] if graph == "popular" else [None, 300]
    before = tuple(f.launches for f in (tsg.stream_gat_fwd, tsg.stream_gat_bwd_dst,
                                        tsg.stream_gat_bwd_src))
    exact = tsg.stream_gat_fwd_plain(*fargs, acc_dtype=torch.float64)
    for piece in pieces:
        acc = tsg.stream_gat_fwd(*fargs, block_bounds=g.block_bounds, piece_edges=piece)
        torch.cuda.synchronize()
        assert torch.isfinite(acc).all() and _rel_err(acc.double(), exact) <= KERNEL_TOL
    stat = _stat_table(acc, mhat, adst_r, gz, n_ch, kz, t_dtype)
    assert stat.shape == (n, tsg.stat_width(n_ch, kz)) and stat.shape[1] % 8 == 0
    dargs = (table, stat, g.src, g.dst, n, kz)
    sargs = (table, stat, g.src_perm, g.src_sorted, g.dst, n, kz)
    dkw, skw = dict(block_bounds=g.block_bounds), dict(src_block_bounds=g.src_block_bounds)
    exact_d = tsg.stream_gat_bwd_dst_plain(*dargs, acc_dtype=torch.float64)
    exact_s = tsg.stream_gat_bwd_src_plain(*sargs, acc_dtype=torch.float64)
    if graph == "skewed":
        real = g.dst < n
        s, d = g.src[real].long(), g.dst[real].long()
        dpre_t, err, ct, ct_err = _bwd_terms(table, stat, s, d, kz, t_dtype)
        bound_d = _sum_bound(dpre_t, d, n, err).t()
        bound_s = _sum_bound(ct, s, n, ct_err)
    for piece in pieces:
        da = tsg.stream_gat_bwd_dst(*dargs, piece_edges=piece, **dkw)
        dpk = tsg.stream_gat_bwd_src(*sargs, piece_edges=piece, **skw)
        torch.cuda.synchronize()
        assert da.shape == (n_ch, n) and dpk.shape == (n, n_ch * (kz + 1))
        assert torch.isfinite(da).all() and torch.isfinite(dpk).all()
        if graph == "popular":
            assert _rel_err(da.double(), exact_d) <= KERNEL_TOL
            assert _rel_err(dpk.double(), exact_s) <= KERNEL_TOL
        else:
            assert bool(((da.double() - exact_d).abs() <= bound_d).all())
            assert bool(((dpk.double() - exact_s).abs() <= bound_s).all())
    after = tuple(f.launches for f in (tsg.stream_gat_fwd, tsg.stream_gat_bwd_dst,
                                       tsg.stream_gat_bwd_src))
    assert after == tuple(b + len(pieces) for b in before)


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_stream_backwards_take_any_order(cuda, skewed_graph, transport):
    """K9 and K10 on edges out of block order (an edge's dst may lie
    outside its piece's block: its a_dst, m^ or stats and its sums go
    through global memory) and K11 on a src order that is not sorted (its
    runs break at every change), each with block bounds that cut the edges
    evenly, against the float64 sums of every real edge (the plain
    versions read no bounds) at 1e-5 of the largest value."""
    g, n, n_ch, kz = skewed_graph, STREAM_ROWS, 2, 16
    t_dtype = TDT[transport]
    rng = np.random.default_rng(13)
    table, adst_r, mhat, gz = _stream_tables(rng, n_ch, kz, t_dtype, cuda)
    acc = tsg.stream_gat_fwd(table, adst_r, mhat, g.src, g.dst, n, kz,
                             block_bounds=g.block_bounds)
    stat = _stat_table(acc, mhat, adst_r, gz, n_ch, kz, t_dtype)
    e = g.dst.numel()
    order = torch.from_numpy(rng.permutation(e).astype(np.int32)).to(cuda)
    n_blocks = -(-n // 128)
    bounds = torch.linspace(0, e, n_blocks + 1, device=cuda).round().to(torch.int32)
    fargs = (table, adst_r, mhat, g.src[order.long()].contiguous(),
             g.dst[order.long()].contiguous(), n, kz)
    got = tsg.stream_gat_fwd(*fargs, block_bounds=bounds)
    exact = tsg.stream_gat_fwd_plain(*fargs, acc_dtype=torch.float64)
    torch.cuda.synchronize()
    assert _rel_err(got.double(), exact) <= KERNEL_TOL
    dargs = (table, stat, g.src[order.long()].contiguous(), g.dst[order.long()].contiguous(),
             n, kz)
    da = tsg.stream_gat_bwd_dst(*dargs, block_bounds=bounds)
    exact = tsg.stream_gat_bwd_dst_plain(*dargs, acc_dtype=torch.float64)
    torch.cuda.synchronize()
    assert _rel_err(da.double(), exact) <= KERNEL_TOL
    sargs = (table, stat, order, g.src[order.long()].contiguous(), g.dst, n, kz)
    dpk = tsg.stream_gat_bwd_src(*sargs, src_block_bounds=bounds)
    exact = tsg.stream_gat_bwd_src_plain(*sargs, acc_dtype=torch.float64)
    torch.cuda.synchronize()
    assert _rel_err(dpk.double(), exact) <= KERNEL_TOL


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_stream_gat_on_card_matches_cpu(cuda, transport):
    rng = np.random.default_rng(4)
    n, e = 3000, 40_000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    src[:30] = 0
    g = tgraph.build_gat_graph(src, dst, n, analytic_loops=True)
    z = (0.5 * rng.standard_normal((7, n, 16))).astype(np.float32)
    a = rng.standard_normal((2, 7, n)).astype(np.float32)
    ct = rng.standard_normal((7, n, 16)).astype(np.float32)
    outs = []
    for dev, gg in (("cuda", g.to(cuda)), ("cpu", g)):
        ins = [torch.from_numpy(x).to(dev).requires_grad_() for x in (z, a[0], a[1])]
        out = tsg.stream_gat_attention_batched(*ins, gg.src, gg.dst, gg.src_perm,
                                               gg.src_sorted, n, True, 0.2, transport)
        out.backward(torch.from_numpy(ct).to(dev))
        outs.append([out.detach().cpu()] + [t.grad.cpu() for t in ins])
    for got, want in zip(*outs):
        assert _rel_err(got, want) <= TOL[transport]


def test_softmax_kernels_match_plain(cuda):
    rng = np.random.default_rng(8)
    n, e = STREAM_ROWS, 197_000
    dst = rng.integers(0, n, e)
    dst = np.where(dst // 128 == 3, dst + 128, dst)  # block 3 empty
    src = rng.integers(0, n, e)
    dst = dst[np.lexsort((dst, src, dst // 128))]
    dst = torch.from_numpy(np.concatenate([dst, np.full(1000, n)]).astype(np.int32)).to(cuda)
    alpha = torch.from_numpy((3.0 * rng.standard_normal(e + 1000)).astype(np.float32)).to(cuda)
    alpha[e:] = 90.0  # padding: large logits that must drop out
    bounds = tfg.dst_block_bounds(dst, n)
    before = tsk.softmax_stats.launches
    stats = tsk.softmax_stats(alpha, dst, n, bounds)
    plain = tsk.softmax_stats_plain(alpha, dst, n)
    exact = tsk.softmax_stats_plain(alpha.double(), dst, n)
    torch.cuda.synchronize()
    assert tsk.softmax_stats.launches == before + 1
    assert torch.equal(stats[:, 0], plain[:, 0])
    assert bool(torch.isinf(stats[384:512, 0]).all()) and not stats[384:512, 1].any()
    assert _rel_err(stats[:, 1].double(), exact[:, 1]) <= SEG_TOL
    # the softmax and its gradient on the card against the CPU
    g = torch.from_numpy(rng.standard_normal(e + 1000).astype(np.float32))
    res = []
    for dev in ("cuda", "cpu"):
        a = alpha.detach().to(dev).requires_grad_()
        att = tsk.segment_softmax(a, dst.to(dev), n, "f32", bounds.to(dev))
        att.backward(g.to(dev))
        res.append((att.detach().cpu(), a.grad.cpu()))
    for got, want in zip(*res):
        assert _rel_err(got, want) <= SEG_TOL
    assert not res[0][0][e:].any()


def test_softmax_kernel_on_a_hot_block(cuda):
    """K8 on a block-monotone dst whose block 5 holds 60,000 of 150,000
    edges, past the edges a CTA stages in shared memory (the rest it reads
    again from global memory), with padding logits of 90 and an empty
    block 3: its max equals the plain version's bitwise, its sums the
    float64 sums row by row within _sum_bound (each term exp(a - max)
    carries the f32 subtraction's rounding and expf's 2 ulp)."""
    rng = np.random.default_rng(9)
    n, e, pad = STREAM_ROWS, 150_000, 1024
    dst = rng.integers(0, n, e)
    dst[:60_000] = rng.integers(640, 768, 60_000)
    dst = np.where(dst // 128 == 3, dst + 128, dst)
    dst = np.sort(dst, kind="stable")
    dst = torch.from_numpy(np.concatenate([dst, np.full(pad, n)]).astype(np.int32)).to(cuda)
    alpha = torch.from_numpy((3.0 * rng.standard_normal(e + pad)).astype(np.float32)).to(cuda)
    alpha[e:] = 90.0
    bounds = tfg.dst_block_bounds(dst, n)
    assert int(bounds[6] - bounds[5]) >= 60_000 and int(bounds[4] - bounds[3]) == 0
    before = tsk.softmax_stats.launches
    stats = tsk.softmax_stats(alpha, dst, n, bounds)
    plain = tsk.softmax_stats_plain(alpha, dst, n)
    exact = tsk.softmax_stats_plain(alpha.double(), dst, n)
    torch.cuda.synchronize()
    assert tsk.softmax_stats.launches == before + 1
    assert torch.equal(stats[:, 0], plain[:, 0])
    assert bool(torch.isinf(stats[384:512, 0]).all()) and not stats[384:512, 1].any()
    a64, dst64 = alpha.double(), torch.clamp(dst.long(), max=n)
    shift = torch.cat([torch.nan_to_num(exact[:, 0], neginf=0.0), a64.new_zeros(1)])
    d = a64 - shift[dst64]
    t = torch.exp(d)
    t_err = t * (torch.expm1(U_SUM * d.abs()) * (1 + 2.0 ** -22) + 2.0 ** -22)
    bound = _sum_bound(t[:, None], dst, n, t_err[:, None])[:, 0]
    assert bool(((stats[:, 1].double() - exact[:, 1]).abs() <= bound).all())


def test_stream_wrappers_reject_bad_inputs(cuda):
    n, kz = 300, 8
    ids = torch.zeros(16, dtype=torch.int32, device=cuda)
    table = torch.zeros((n, kz + 1), device=cuda)
    stat = torch.zeros((n, tsg.stat_width(1, kz)), device=cuda)
    v = torch.zeros((1, n), device=cuda)
    bb = torch.tensor([0, 16, 16, 16], dtype=torch.int32, device=cuda)  # 3 blocks
    dkw, skw = dict(block_bounds=bb), dict(src_block_bounds=bb)
    before = (tsg.stream_gat_fwd.launches, tsg.stream_gat_bwd_dst.launches,
              tsg.stream_gat_bwd_src.launches, tsk.softmax_stats.launches)
    with pytest.raises(ValueError):  # int64 ids
        tsg.stream_gat_fwd(table, v, v, ids.long(), ids, n, kz)
    with pytest.raises(ValueError):  # kz past the layout limit
        tsg.stream_gat_fwd(torch.zeros((n, 127), device=cuda), v, v, ids, ids, n, 126)
    with pytest.raises(ValueError):  # stat table in another dtype than the table
        tsg.stream_gat_bwd_dst(table, stat.bfloat16(), ids, ids, n, kz, **dkw)
    with pytest.raises(ValueError):  # stat table of the wrong width
        tsg.stream_gat_bwd_src(table, stat[:, :kz].contiguous(), ids, ids, ids, n, kz, **skw)
    with pytest.raises(ValueError):  # stat table with unpadded rows
        tsg.stream_gat_bwd_dst(table, stat[:, :kz + 3].contiguous(), ids, ids, n, kz, **dkw)
    with pytest.raises(ValueError):  # ids on the CPU
        tsg.stream_gat_bwd_src(table, stat, ids, ids.cpu(), ids, n, kz, **skw)
    with pytest.raises(ValueError):  # block bounds of the wrong length
        tsg.stream_gat_bwd_dst(table, stat, ids, ids, n, kz, block_bounds=ids[:2])
    with pytest.raises(ValueError):  # no block bounds: the kernels need the graph's
        tsg.stream_gat_bwd_src(table, stat, ids, ids, ids, n, kz)
    with pytest.raises(ValueError):  # a chunk past K11's shared-memory ids
        tsg.stream_gat_bwd_src(table, stat, ids, ids, ids, n, kz,
                               piece_edges=tsg.MAX_SRC_PIECE_EDGES + 1, **skw)
    with pytest.raises(ValueError):  # bf16 logits
        tsk.softmax_stats(torch.zeros(16, device=cuda, dtype=torch.bfloat16), ids, n, bb)
    with pytest.raises(ValueError):  # no block bounds: K8 needs the graph's
        tsk.softmax_stats(torch.zeros(16, device=cuda), ids, n)
    with pytest.raises(ValueError):  # K8's block bounds of the wrong length
        tsk.softmax_stats(torch.zeros(16, device=cuda), ids, n, bb[:3])
    with pytest.raises(ValueError):  # no block bounds: K9 needs the graph's
        tsg.stream_gat_fwd(table, v, v, ids, ids, n, kz)
    with pytest.raises(ValueError):  # K9's block bounds in int64
        tsg.stream_gat_fwd(table, v, v, ids, ids, n, kz, block_bounds=bb.long())
    with pytest.raises(ValueError):  # a chunk past K9's shared-memory sort
        tsg.stream_gat_fwd(table, v, v, ids, ids, n, kz, block_bounds=bb,
                           piece_edges=tsg.MAX_FWD_PIECE_EDGES + 1)
    after = (tsg.stream_gat_fwd.launches, tsg.stream_gat_bwd_dst.launches,
             tsg.stream_gat_bwd_src.launches, tsk.softmax_stats.launches)
    assert after == before


# ---------------------------------------------------------------- the
# flash-GAT variant routes (ops/config.FlashGATMode): K12-online
# (gat_rowmax + flash_gat_fwd_online) and K13 (flash_gat_bwd_glue, then K6)
# at the flagship's step-1 union shape, K14 (flash_gat_bwd_onepass) at each
# of its layouts and on a hot source


def _ulp(x, t_dtype):
    """One unit in the last place of |x| in `t_dtype` (f32 24 bits, bf16 8)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x.float()), e - (24 if t_dtype == torch.float32 else 8))


def _flagship_union(rng, cuda, t_dtype, skew=False):
    """The step-1 union shape with random block-ordered edges; `skew` puts
    12x the mean block's edges into dst block 3 (the flagship's busiest
    block holds 12.6x)."""
    n, kz = 15210, 64
    src, dst = _edges(rng, n, 169155, 169472, torch.device("cpu"))
    if skew:
        real = dst < n
        heavy = torch.from_numpy(rng.random(dst.shape[0]) < 0.1) & real
        dst = torch.where(heavy, 384 + dst % 128, dst)
        order = torch.from_numpy(np.lexsort((dst.numpy(), src.numpy(), dst.numpy() // 128)))
        src, dst = src[order], dst[order]
    table = torch.from_numpy(rng.standard_normal((n, kz + 1), dtype=np.float32)).to(t_dtype)
    a_dst = torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
    return n, kz, src.to(cuda), dst.to(cuda), table.to(cuda), a_dst.to(cuda)


@pytest.mark.parametrize("graph", ["union", "hot row"])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_online_kernels_match_plain(cuda, transport, graph):
    """K12-online on the walk by dst: gat_rowmax's m equals the plain
    version's bitwise (one max, rounded once); the walk's sums within
    KERNEL_TOL, as K1/K12's.  "hot row": dst row 777 takes 60,000 of the
    edges, its run across many warps' slices of the row max and many
    workers' of the walk, each row of the walk's sums within _sum_bound of
    the float64 sums of the plain version's terms."""
    rng = np.random.default_rng(10)
    t_dtype = TDT[transport]
    n, kz, src, dst, table, a_dst = _flagship_union(rng, cuda, t_dtype)
    if graph == "hot row":
        real = dst < n
        dst = torch.where(real & (torch.arange(dst.numel(), device=cuda) < 60000), 777, dst)
        order = np.lexsort((dst.cpu().numpy(), src.cpu().numpy(), dst.cpu().numpy() // 128))
        order = torch.from_numpy(order).to(cuda)
        src, dst = src[order].contiguous(), dst[order].contiguous()
        assert int((dst == 777).sum()) >= 60000
    adst_r = a_dst.to(t_dtype).float()
    walk = dict(zip(("dst_perm", "dst_sorted"), tfg.dst_walk(dst)))
    before = (tfg.gat_rowmax.launches, tfg.flash_gat_fwd_online.launches)
    m = tfg.gat_rowmax(table, adst_r, src, dst, n, kz, **walk)
    acc = tfg.flash_gat_fwd_online(table, adst_r, m, src, dst, n, kz, **walk)
    torch.cuda.synchronize()
    assert (tfg.gat_rowmax.launches, tfg.flash_gat_fwd_online.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(m, tfg.gat_rowmax_plain(table, adst_r, src, dst, n, kz))
    assert torch.isfinite(acc).all() and acc.shape == (n, kz + 1)
    if graph == "union":
        want = tfg.flash_gat_fwd_plain(table, adst_r, m, src, dst, n, kz)
        assert _rel_err(acc, want) <= KERNEL_TOL
    else:
        d = dst[dst < n].long()
        terms = tfg._fwd_edge_terms(table, adst_r[None], m[None], src[dst < n].long(), d, kz,
                                    False, 0.2).double()
        assert ((acc.double() - segment_sum(terms, d, n)).abs()
                <= _sum_bound(terms, d, n)).all()
    empty = dst.new_zeros(0)
    assert not tfg.gat_rowmax(table, adst_r, empty, empty, n, kz, dst_perm=empty,
                              dst_sorted=empty).any()
    assert tfg.gat_rowmax.launches == before[0] + 1


def _mode_bwd_inputs(rng, n, kz, src, dst, table, a_dst, t_dtype):
    """K2/K13's stat inputs (g rounded) and K14's stat table (g unrounded)
    from the plain forward on the same inputs and a random cotangent."""
    adst_r, mhat = tfg.bound_shift(a_dst, table[:, kz], 0.2, t_dtype)
    acc = tfg.flash_gat_fwd_plain(table, adst_r, mhat, src, dst, n, kz)
    s = acc[:, kz]
    out = acc[:, :kz] / (s[:, None] + 1e-16)
    g = torch.from_numpy(rng.standard_normal((n, kz), dtype=np.float32)).to(table.device)
    gout = (g * out).sum(dim=1, keepdim=True)
    logden = mhat + torch.log(s + 1e-16)
    gtab = torch.cat([g.to(t_dtype).float(), gout], dim=1)
    stat = torch.cat([g, gout, logden[:, None], adst_r[:, None]], dim=1)
    return adst_r, gtab, logden, stat


def _glue_edges(rng, graph, cuda):
    """(n, src, dst) of K13's card cases: the flagship's step-1 union shape
    ("union"); 1,690 rows and 73,611 edges with dst row 777 holding 20,000
    of them ("hot row": its run across many workers' slices); the union's
    edges in a shuffled order ("shuffled": the walk by dst is then no
    longer the block order's runs); 4,096 padding edges and no real one
    ("all padding"); no edges at all ("no edges")."""
    if graph == "hot row":
        n, e_real, e_pad = 1690, 73611, 73728
        src, dst = rng.integers(0, n, e_real), rng.integers(0, n, e_real)
        dst[:20000] = 777
        order = np.lexsort((dst, src, dst // 128))
        src = np.concatenate([src[order], np.zeros(e_pad - e_real, np.int64)])
        dst = np.concatenate([dst[order], np.full(e_pad - e_real, n)])
        return n, *(torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (src, dst))
    if graph in ("all padding", "no edges"):
        n, e = 1690, 4096 if graph == "all padding" else 0
        return (n, torch.zeros(e, dtype=torch.int32, device=cuda),
                torch.full((e,), n, dtype=torch.int32, device=cuda))
    n = 15210
    src, dst = _edges(rng, n, 169155, 169472, cuda)
    if graph == "shuffled":
        perm = torch.from_numpy(rng.permutation(dst.numel())).to(cuda)
        src, dst = src[perm].contiguous(), dst[perm].contiguous()
    return n, src, dst


@pytest.mark.parametrize("kz", [16, 64, 257])
@pytest.mark.parametrize("graph", ["union", "hot row", "shuffled", "all padding", "no edges"])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_glue_kernel_matches_plain(cuda, transport, graph, kz):
    """K13 on the walk by dst (flash_gat.dst_walk, as StepGraph.dst_perm /
    dst_sorted), at the widths of its layouts (kz 16 and 64) and past the
    widest (257: 32-column passes): the stored cotangent rows each within
    one unit of the transport's last place of the plain version's (at kz
    16 and 257, where datt sums in another order than torch's, plus, in
    the dpre column, the bound on two orders of datt's sum,
    _gat_bwd_terms; at kz 64 the kernel keeps torch's order); the
    padding rows exact zeros though ct starts as torch.empty over NaNs;
    da_dst row by row within _sum_bound of the float64 sums of the plain
    version's terms; K6 on the rows within _sum_bound of the float64 sums
    of the same rows (and on the union at kz 64, as before, within 1e-6 of
    the largest), past MAX_COLS columns too (K6's passes); one launch
    a call, none without edges."""
    rng = np.random.default_rng(11)
    t_dtype = TDT[transport]
    n, src, dst = _glue_edges(rng, graph, cuda)
    table = torch.from_numpy(rng.standard_normal((n, kz + 1), dtype=np.float32)).to(cuda)
    table = table.to(t_dtype)
    a_dst = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(cuda)
    adst_r, gtab, logden, _ = _mode_bwd_inputs(rng, n, kz, src, dst, table, a_dst, t_dtype)
    args = (table, gtab, logden, adst_r, src, dst, n, kz)
    perm, srt = tfg.dst_walk(dst)
    before = tfg.flash_gat_bwd_glue.launches
    # leave NaNs where ct's torch.empty will land: every row must be written
    torch.full((dst.numel(), kz + 1), float("nan"), dtype=t_dtype, device=cuda)
    ct, da = tfg.flash_gat_bwd_glue(*args, dst_perm=perm, dst_sorted=srt)
    torch.cuda.synchronize()
    assert tfg.flash_gat_bwd_glue.launches == before + (1 if dst.numel() else 0)
    want_ct, want_da = tfg.flash_gat_bwd_glue_plain(*args)
    assert ct.dtype == t_dtype and ct.shape == want_ct.shape and da.shape == (n,)
    real = dst < n
    assert not ct[~real].any()
    if not real.any():  # all padding, or no edges: zero rows, no sums
        assert not da.any()
        return
    s, d = src[real].long(), dst[real].long()
    da_t, da_err, _, row_err = _gat_bwd_terms(table, gtab, logden[None], adst_r[None], s, d,
                                              kz, t_dtype, False)
    ct_err = torch.zeros(ct.shape, dtype=torch.float64, device=cuda)
    if kz != 64:  # datt's order is torch's at kz 64 only
        ct_err[real] = row_err
    diff = (ct.float() - want_ct.float()).abs().double()
    assert (diff <= torch.maximum(_ulp(ct, t_dtype), _ulp(want_ct, t_dtype)).double()
            + ct_err).all()
    assert ((da[:, None].double() - segment_sum(da_t, d, n)).abs()
            <= _sum_bound(da_t, d, n, da_err)).all()
    dpk = tsk.localized_scatter_add(ct, src, n, transport)
    exact = segment_sum(ct.double(), src, n)
    assert ((dpk.double() - exact).abs() <= _sum_bound(ct.double(), src, n)).all()
    if graph == "union" and kz == 64:
        assert _rel_err(dpk.double(), exact) <= 1e-6


def _check_onepass(table, stat, src, dst, n, kz, t_dtype):
    """K14 on the walk by source: one launch; dpk by src and da_dst by dst,
    each row within _sum_bound of the float64 sums of its plain version's
    terms (K2's rounding points on the stat table's columns, each dpre
    term with its own error, _gat_bwd_terms)."""
    perm, srt = tfg.src_walk(src)
    before = tfg.flash_gat_bwd_onepass.launches
    dpk, da_dst = tfg.flash_gat_bwd_onepass(table, stat, src, dst, n, kz, src_perm=perm,
                                            src_sorted=srt)
    torch.cuda.synchronize()
    assert tfg.flash_gat_bwd_onepass.launches == before + 1
    assert dpk.shape == (table.shape[0], kz + 1) and da_dst.shape == (n,)
    assert torch.isfinite(dpk).all() and torch.isfinite(da_dst).all()
    real = dst < n
    s, d = src[real].long(), dst[real].long()
    da_t, da_err, ct, ct_err = _gat_bwd_terms(table, stat[:, : kz + 1], stat[None, :, kz + 1],
                                              stat[None, :, kz + 2], s, d, kz, t_dtype, False)
    assert ((dpk.double() - segment_sum(ct, s, table.shape[0])).abs()
            <= _sum_bound(ct, s, table.shape[0], ct_err)).all()
    assert ((da_dst[:, None].double() - segment_sum(da_t, d, n)).abs()
            <= _sum_bound(da_t, d, n, da_err)).all()


def _onepass_stat(rng, table, src, dst, n, kz, t_dtype):
    """K14's stat table [g | gout | logden | round_T(a_dst)] (g unrounded)
    from the plain forward on the same inputs and a random cotangent."""
    adst_r, mhat = tfg.bound_shift(torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
                                   .to(table.device), table[:n, kz], 0.2, t_dtype)
    acc = tfg.flash_gat_fwd_plain(table, adst_r, mhat, src, dst, n, kz)
    s = acc[:, kz]
    out = acc[:, :kz] / (s[:, None] + 1e-16)
    g = torch.from_numpy(rng.standard_normal((n, kz), dtype=np.float32)).to(table.device)
    return torch.cat([g, (g * out).sum(dim=1, keepdim=True),
                      (mhat + torch.log(s + 1e-16))[:, None], adst_r[:, None]], dim=1)


@pytest.mark.parametrize("kz", [16, 64, 125, 200, 257])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_onepass_kernel_matches_plain(cuda, transport, kz):
    """K14 at each of K2's worker layouts (kz <= 32, 64, 128, 256) and past
    the widest (257: 256-column passes; the design before refused kz >
    125), on the walk by source, each row within _sum_bound."""
    rng = np.random.default_rng(12)
    n, t_dtype = 1000, TDT[transport]
    src, dst = _edges(rng, n, 12000, 12288, cuda)
    table = torch.from_numpy(rng.standard_normal((n, kz + 1), dtype=np.float32)).to(cuda)
    table = table.to(t_dtype)
    _check_onepass(table, _onepass_stat(rng, table, src, dst, n, kz, t_dtype), src, dst, n,
                   kz, t_dtype)


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_onepass_kernel_on_a_hot_source(cuda, transport):
    """K14 at the flagship's layout (kz 64) with one source holding 20,000
    of 73,611 edges (its run across many workers' slices), then on the same
    edges out of block order (the walk of a shuffled src)."""
    rng = np.random.default_rng(14)
    n, kz, t_dtype, e_real, e_pad = 1690, 64, TDT[transport], 73611, 73728
    src, dst = rng.integers(0, n, e_real), rng.integers(0, n, e_real)
    src[:20000] = 777
    order = np.lexsort((dst, src, dst // 128))
    src = np.concatenate([src[order], np.zeros(e_pad - e_real, np.int64)])
    dst = np.concatenate([dst[order], np.full(e_pad - e_real, n)])
    src, dst = (torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (src, dst))
    table = torch.from_numpy(rng.standard_normal((n, kz + 1), dtype=np.float32)).to(cuda)
    table = table.to(t_dtype)
    stat = _onepass_stat(rng, table, src, dst, n, kz, t_dtype)
    assert (torch.bincount(src[dst < n].long(), minlength=n)[777] >= 20000).item()
    _check_onepass(table, stat, src, dst, n, kz, t_dtype)
    perm = torch.from_numpy(rng.permutation(dst.numel())).to(cuda)
    _check_onepass(table, stat, src[perm].contiguous(), dst[perm].contiguous(), n, kz, t_dtype)


@pytest.mark.parametrize("bwd", ["fused", "glue", "onepass"])
@pytest.mark.parametrize("shift", ["bound", "online"])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_flash_modes_on_card_match_cpu(cuda, transport, shift, bwd):
    """FlashGAT's output and gradients in every mode: the card (kernels)
    against the CPU (plain versions), at the whole-op tolerances."""
    from graph_recsys_benchmark_tpu_torch.ops.config import FlashGATMode

    mode = FlashGATMode(shift, bwd)
    rng = np.random.default_rng(13)
    n, kz = 700, 16
    src, dst = _edges(rng, n, 6000, 6144, torch.device("cpu"))
    packed = tfg.pack_gat_table(torch.from_numpy(rng.standard_normal((kz, n), dtype=np.float32)),
                                torch.from_numpy(rng.standard_normal(n, dtype=np.float32)), n,
                                TDT[transport])
    a_dst = torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((n, kz), dtype=np.float32))
    res = {}
    for d in ("cuda", "cpu"):
        p = packed.to(d).requires_grad_()
        a = a_dst.to(d).requires_grad_()
        out = tfg.flash_gat_attention(p, a, src.to(d), dst.to(d), None, None, n, kz, 0.2,
                                      transport, mode=mode)
        res[d] = (out.detach(),) + torch.autograd.grad(out, (p, a), g.to(d))
    torch.cuda.synchronize()
    for got, want in zip(res["cuda"], res["cpu"]):
        assert _rel_err(got.float().cpu(), want.float()) <= TOL[transport]


def test_mode_wrappers_reject_bad_inputs(cuda):
    n, kz = 300, 8
    table = torch.zeros((n + 1, kz + 1), device=cuda)
    vec = torch.zeros(n, device=cuda)
    ids = torch.zeros(16, dtype=torch.int32, device=cuda)
    gtab = torch.zeros((n, kz + 1), device=cuda)
    stat = torch.zeros((n, kz + 3), device=cuda)
    fwalk = dict(dst_perm=ids, dst_sorted=ids)
    walk = dict(src_perm=ids, src_sorted=ids)
    before = [c.launches for c in (tfg.gat_rowmax, tfg.flash_gat_fwd_online,
                                   tfg.flash_gat_bwd_glue, tfg.flash_gat_bwd_onepass)]
    with pytest.raises(ValueError):  # int64 ids
        tfg.gat_rowmax(table, vec, ids.long(), ids, n, kz, **fwalk)
    with pytest.raises(ValueError, match="dst_perm"):  # no walk: a CUDA call never sorts
        tfg.gat_rowmax(table, vec, ids, ids, n, kz)
    with pytest.raises(ValueError):  # m of the wrong length
        tfg.flash_gat_fwd_online(table, vec, vec[:-1], ids, ids, n, kz, **fwalk)
    with pytest.raises(ValueError, match="dst_perm"):  # no walk
        tfg.flash_gat_fwd_online(table, vec, vec, ids, ids, n, kz)
    with pytest.raises(ValueError):  # bf16 stat table
        tfg.flash_gat_bwd_glue(table, gtab.bfloat16(), vec, vec, ids, ids, n, kz, **fwalk)
    with pytest.raises(ValueError, match="dst_perm"):  # no walk: a CUDA call never sorts
        tfg.flash_gat_bwd_glue(table, gtab, vec, vec, ids, ids, n, kz)
    with pytest.raises(ValueError):  # an int64 walk
        tfg.flash_gat_bwd_glue(table, gtab, vec, vec, ids, ids, n, kz, dst_perm=ids.long(),
                               dst_sorted=ids)
    with pytest.raises(ValueError):  # K2's stat table for K14
        tfg.flash_gat_bwd_onepass(table, gtab, ids, ids, n, kz, **walk)
    with pytest.raises(ValueError, match="src_perm"):  # no walk
        tfg.flash_gat_bwd_onepass(table, stat, ids, ids, n, kz)
    with pytest.raises(ValueError):  # an int64 walk
        tfg.flash_gat_bwd_onepass(table, stat, ids, ids, n, kz, src_perm=ids.long(),
                                  src_sorted=ids)
    after = [c.launches for c in (tfg.gat_rowmax, tfg.flash_gat_fwd_online,
                                  tfg.flash_gat_bwd_glue, tfg.flash_gat_bwd_onepass)]
    assert after == before
