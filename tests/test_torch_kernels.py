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
        train_pos=z, test_users=ids, test_items=cand[:, 0], cand=cand,
        neg_counts=torch.full((2,), 5, dtype=torch.int32, device=cuda), item_lo=0,
        num_items=12, user_lo=0, item_feat=z, item_feat_counts=z[0], user_feat=z,
        user_feat_counts=z[0], ent_lo=z[0], ent_hi=z[0])
    negs = tsamp.sample_eval_negatives(torch.Generator(device="cuda").manual_seed(0), tables, 7)
    assert negs.device == cand.device and negs.shape == (2, 7)
    assert bool(((negs >= cand[:, 1:2]) & (negs <= cand[:, 5:6])).all())
    with pytest.raises(ValueError):
        tsamp.sample_eval_negatives(torch.Generator().manual_seed(0), tables, 7)
