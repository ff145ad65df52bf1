"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: every test skips without a CUDA device (decided in a fixture,
never at import, so every xdist worker collects the same tests).  Shapes are
the flagship's (bench.py:42-59): the step-1 union graph (kz 64, 15,210 rows,
169,472 padded edges) for flash_gat_fwd and flash_gat_bwd, the step-2
shared i2u/u2i graph (kz 16, 1,690 rows, 73,728 padded edges, 7 and 2
channels) for batch_gat_fwd and batch_gat_bwd.  Random block-ordered edges
from a numpy seed stand in for the graphs; the backwards get the stats of
the forward on the same inputs.  Tolerances: a kernel against its plain
version on the card, 1e-5 of the largest value in both transports (the two
round at the same points and differ only in the order the atomics add, so
a lost bf16 rounding point, ~1e-3, fails); the card's whole op against the
CPU's, f32 1e-5 and bf16 4e-3 (the JAX tests' bf16 bound: the CPU's exp may
differ from the card's in a last bit, which can move one bf16 rounding);
one training step's loss and median gradient against the CPU's, f32 1e-4
and bf16 2e-2 (chip_smoke.py's forward tolerances: a last-bit difference
in a step-1 output can move a bf16 rounding of step 2's input), every
gradient 5e-2 (a flipped ReLU input, chip_smoke.py KINK_TOL).

The streaming GAT kernels of csrc/stream_gat.cu (stream_gat_fwd K9,
stream_gat_bwd_dst K10, stream_gat_bwd_src K11) run at the ML-25M shapes'
widths ((n_ch, kz) = (1, 64), (7, 16), (2, 16), and (8, 125), the widest
layout) over 68,830 rows and a loop-free graph of 400,000 skewed edges
(row 0 with real out-edges; its src-sorted run also holds the padding):
each is held to the same sums taken in float64 at 1e-5 of the largest
value in both transports (they round at the plain version's points; f32
atomics in another order over in-degrees in the thousands).
StreamGAT on the card is held to the CPU's at the whole-op tolerances
above.  softmax_stats (K8) gets the composed GAT's shape (68,830 rows,
197,000 edges) with an empty block and padding: its max equals the plain
version's bitwise, its sums the float64 sums at 1e-6.

The edge kernels of csrc/segment.cu (sorted_segment_sum K5,
sorted_broadcast K7, localized_scatter_add K6) run at the flagship's
PEAGCN/PEASage union-graph shapes (15,210 rows; 169,472 or 647,680 padded
edges; D 64 and 16) with padding sentinels and an empty dst block; K6 gets
an unordered idx.  K5 and K6 sum in f32 in another order than the plain
version, so each is held to the same sums taken in float64, at 1e-6 of
the largest value (two f32 orders can differ by more than either differs
from the exact sum: 1.04e-6 measured at PEASage step 2); K7 is a copy and
equals the plain version bitwise.

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
    before = tfg.flash_gat_fwd.launches
    got = tfg.flash_gat_fwd(table, adst_r, mhat, src, dst, n, kz)
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
    before = tbg.batch_gat_fwd.launches
    got = tbg.batch_gat_fwd(table, adst_r, mhat, src, dst, n, kz)
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
    before = tfg.flash_gat_bwd.launches
    got = tfg.flash_gat_bwd(*args)
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
    before = tbg.batch_gat_bwd.launches
    got = tbg.batch_gat_bwd(*args)
    torch.cuda.synchronize()
    assert tbg.batch_gat_bwd.launches == before + 1
    want = tbg.batch_gat_bwd_plain(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert _rel_err(a, b) <= KERNEL_TOL


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


def test_wrappers_reject_bad_inputs(cuda):
    n, kz = 300, 8
    table = torch.zeros((n + 1, kz + 1), device=cuda)
    stat = torch.zeros(n, device=cuda)
    ids = torch.zeros(16, dtype=torch.int32, device=cuda)
    before = tfg.flash_gat_fwd.launches
    with pytest.raises(ValueError):  # int64 ids
        tfg.flash_gat_fwd(table, stat, stat, ids.long(), ids, n, kz)
    with pytest.raises(ValueError):  # ids on the CPU
        tfg.flash_gat_fwd(table, stat, stat, ids.cpu(), ids, n, kz)
    with pytest.raises(ValueError):  # f16 table
        tfg.flash_gat_fwd(table.half(), stat, stat, ids, ids, n, kz)
    with pytest.raises(ValueError):  # 9 channels
        tbg.batch_gat_fwd(torch.zeros((n, 9 * (kz + 1)), device=cuda),
                          torch.zeros((9, n), device=cuda), torch.zeros((9, n), device=cuda),
                          ids, ids, n, kz)
    assert tfg.flash_gat_fwd.launches == before
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    out = tfg.flash_gat_fwd(table, stat, stat, empty, empty, n, kz)
    assert out.shape == (n, kz + 1) and not out.any()
    assert tfg.flash_gat_fwd.launches == before
    gtab = torch.zeros((n, kz + 1), device=cuda)
    before = (tfg.flash_gat_bwd.launches, tbg.batch_gat_bwd.launches)
    with pytest.raises(ValueError):  # bf16 stat table
        tfg.flash_gat_bwd(table, gtab.bfloat16(), stat, stat, ids, ids, n, kz)
    with pytest.raises(ValueError):  # stat table of the wrong width
        tfg.flash_gat_bwd(table, gtab[:, :kz].contiguous(), stat, stat, ids, ids, n, kz)
    with pytest.raises(ValueError):  # int64 ids
        tfg.flash_gat_bwd(table, gtab, stat, stat, ids, ids.long(), n, kz)
    with pytest.raises(ValueError):  # non-contiguous table
        tfg.flash_gat_bwd(table.t().contiguous().t(), gtab, stat, stat, ids, ids, n, kz)
    with pytest.raises(ValueError):  # 9 channels
        tbg.batch_gat_bwd(torch.zeros((n, 9 * (kz + 1)), device=cuda),
                          torch.zeros((n, 9 * (kz + 1)), device=cuda),
                          torch.zeros((9, n), device=cuda), torch.zeros((9, n), device=cuda),
                          ids, ids, n, kz)
    dpk, da = tfg.flash_gat_bwd(table, gtab, stat, stat, empty, empty, n, kz)
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
    assert _rel_err(got.double(), _exact(rows, dst, n, transport)) <= SEG_TOL
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
    assert _rel_err(got.double(), _exact(ct, idx, n, transport)) <= SEG_TOL
    after = (tsk.sorted_segment_sum.launches, tsk.sorted_broadcast.launches,
             tsk.localized_scatter_add.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 2, 1]


@pytest.mark.parametrize("k", [1, 3, 17, 256])
def test_segment_kernels_odd_widths(cuda, k):
    """The kernels' scalar paths: widths that no 16-byte vector divides,
    [E] vectors, and a table view that is not 16-byte aligned."""
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
    with pytest.raises(ValueError):  # too wide
        tsk.localized_scatter_add(torch.zeros((16, tsk.MAX_COLS + 1), device=cuda), ids, 10)
    with pytest.raises(ValueError):  # one id short
        tsk.sorted_segment_sum(rows, ids[:15], 10)
    after = (tsk.sorted_segment_sum.launches, tsk.sorted_broadcast.launches,
             tsk.localized_scatter_add.launches)
    assert after == before
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    out = tsk.sorted_segment_sum(rows[:0], empty, 10)  # no edges: zeros
    assert out.shape == (10, 8) and not out.any()


STREAM_ROWS = 68830


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
    logden = mhat + torch.log(s + 1e-16)
    gband = torch.cat([g, (g * out).sum(2, keepdim=True), logden[:, :, None],
                       adst_r[:, :, None]], dim=2)
    return gband.permute(1, 0, 2).reshape(n, -1).to(t_dtype).contiguous()


@pytest.mark.parametrize("n_ch,kz", [(1, 64), (7, 16), (2, 16), (8, 125)])
@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_stream_kernels_match_plain(cuda, stream_graph, transport, n_ch, kz):
    g, n = stream_graph, STREAM_ROWS
    t_dtype = TDT[transport]
    rng = np.random.default_rng(n_ch * 1000 + kz)
    table, adst_r, mhat, gz = _stream_tables(rng, n_ch, kz, t_dtype, cuda)
    fargs = (table, adst_r, mhat, g.src, g.dst, n, kz)
    before = tuple(f.launches for f in (tsg.stream_gat_fwd, tsg.stream_gat_bwd_dst,
                                        tsg.stream_gat_bwd_src))
    acc = tsg.stream_gat_fwd(*fargs)
    exact = tsg.stream_gat_fwd_plain(*fargs, acc_dtype=torch.float64)
    torch.cuda.synchronize()
    assert torch.isfinite(acc).all() and _rel_err(acc.double(), exact) <= KERNEL_TOL
    stat = _stat_table(acc, mhat, adst_r, gz, n_ch, kz, t_dtype)
    dargs = (table, stat, g.src, g.dst, n, kz)
    da = tsg.stream_gat_bwd_dst(*dargs)
    exact = tsg.stream_gat_bwd_dst_plain(*dargs, acc_dtype=torch.float64)
    torch.cuda.synchronize()
    assert da.shape == (n_ch, n) and _rel_err(da.double(), exact) <= KERNEL_TOL
    sargs = (table, stat, g.src_perm, g.src_sorted, g.dst, n, kz)
    dpk = tsg.stream_gat_bwd_src(*sargs)
    exact = tsg.stream_gat_bwd_src_plain(*sargs, acc_dtype=torch.float64)
    torch.cuda.synchronize()
    assert dpk.shape == (n, n_ch * (kz + 1)) and torch.isfinite(dpk).all()
    assert _rel_err(dpk.double(), exact) <= KERNEL_TOL
    after = tuple(f.launches for f in (tsg.stream_gat_fwd, tsg.stream_gat_bwd_dst,
                                       tsg.stream_gat_bwd_src))
    assert after == tuple(b + 1 for b in before)


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
    before = tsk.softmax_stats.launches
    stats = tsk.softmax_stats(alpha, dst, n)
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
        att = tsk.segment_softmax(a, dst.to(dev), n)
        att.backward(g.to(dev))
        res.append((att.detach().cpu(), a.grad.cpu()))
    for got, want in zip(*res):
        assert _rel_err(got, want) <= SEG_TOL
    assert not res[0][0][e:].any()


def test_stream_wrappers_reject_bad_inputs(cuda):
    n, kz = 300, 8
    ids = torch.zeros(16, dtype=torch.int32, device=cuda)
    table = torch.zeros((n, kz + 1), device=cuda)
    stat = torch.zeros((n, kz + 3), device=cuda)
    v = torch.zeros((1, n), device=cuda)
    before = (tsg.stream_gat_fwd.launches, tsg.stream_gat_bwd_dst.launches,
              tsg.stream_gat_bwd_src.launches, tsk.softmax_stats.launches)
    with pytest.raises(ValueError):  # int64 ids
        tsg.stream_gat_fwd(table, v, v, ids.long(), ids, n, kz)
    with pytest.raises(ValueError):  # kz past the layout limit
        tsg.stream_gat_fwd(torch.zeros((n, 127), device=cuda), v, v, ids, ids, n, 126)
    with pytest.raises(ValueError):  # stat table in another dtype than the table
        tsg.stream_gat_bwd_dst(table, stat.bfloat16(), ids, ids, n, kz)
    with pytest.raises(ValueError):  # stat table of the wrong width
        tsg.stream_gat_bwd_src(table, stat[:, :kz].contiguous(), ids, ids, ids, n, kz)
    with pytest.raises(ValueError):  # ids on the CPU
        tsg.stream_gat_bwd_src(table, stat, ids, ids.cpu(), ids, n, kz)
    with pytest.raises(ValueError):  # bf16 logits
        tsk.softmax_stats(torch.zeros(16, device=cuda, dtype=torch.bfloat16), ids, n)
    after = (tsg.stream_gat_fwd.launches, tsg.stream_gat_bwd_dst.launches,
             tsg.stream_gat_bwd_src.launches, tsk.softmax_stats.launches)
    assert after == before
