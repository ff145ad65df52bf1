"""The walk of the GAT backwards K2 (flash_gat_bwd), K4 (batch_gat_bwd),
K14 (flash_gat_bwd_onepass) and K13 (flash_gat_bwd_glue) on the CPU, torch
only.

csrc/gat_bwd.cu walks the graph's stable sort by source (StepGraph.src_perm
/ src_sorted) for K2, K4 and K14 and sums each source's run before it
writes; K13 walks its sort by dst (dst_perm / dst_sorted), loads each dst
row's stats once a run and adds the run's da_dst with one atomic.  The
kernels run on the card only (tests/test_torch_kernels.py, chip_smoke.py).
Here:
  * the plain versions accept the walk and do not read it: the same
    results, bitwise, with the walk, without it and with a wrong one, so
    they stay an independent reference for the kernel's walk;
  * the flagship's plan, built at a tiny size, hands each GAT backward its
    StepGraph's own walk (a spy on the wrappers during one step, in the
    default mode, with the one-pass backward and with the glue backward,
    whose K13 gets the walk by dst and its K6 the walk by source), and
    every step graph's walk is src[src_perm] with the padding edges at the
    end of row 0's run, after its real edges;
  * the entry points hand a backward the sort of bare edges (src_walk's;
    K13 dst_walk's);
  * check_walk, the argument check of a CUDA call, refuses a missing or
    mismatched walk, and src_walk builds the graph's stable sort for
    callers with bare edges; the glue wrapper refuses a bad walk by dst
    (check_dst_walk) before its launch, and hands the C entry as many
    arguments as its ctypes signature takes (on the meta device, with the
    launch replaced by a recorder).
"""

import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu_torch.data import build_mlsmall_hin, synthetic_mlsmall_raw
from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
from graph_recsys_benchmark_tpu_torch.ops import batch_gat as tbg
from graph_recsys_benchmark_tpu_torch.ops import flash_gat as tfg
from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as tsk
from graph_recsys_benchmark_tpu_torch.ops.config import FlashGATMode
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WRAPPERS = {"K2": (tfg.flash_gat_bwd, tfg.flash_gat_bwd_plain),
            "K4": (tbg.batch_gat_bwd, tbg.batch_gat_bwd_plain),
            "K14": (tfg.flash_gat_bwd_onepass, tfg.flash_gat_bwd_onepass_plain),
            "K13": (tfg.flash_gat_bwd_glue, tfg.flash_gat_bwd_glue_plain)}


def _bwd_case(kernel, transport, seed=0):
    """A small backward call (args of flash_gat_bwd, batch_gat_bwd,
    flash_gat_bwd_onepass or flash_gat_bwd_glue) on a block-ordered graph
    with padding, and the ids of its walk (src; K13 dst)."""
    rng = np.random.default_rng(seed)
    n, e_real, e_pad = 300, 2000, 2048
    n_ch, kz = (3, 4) if kernel == "K4" else (1, 8)
    src, dst = rng.integers(0, n, e_real), rng.integers(0, n, e_real)
    order = np.lexsort((dst, src, dst // 128))
    src = torch.from_numpy(np.concatenate([src[order], np.zeros(e_pad - e_real)]).astype(np.int32))
    dst = torch.from_numpy(np.concatenate([dst[order], np.full(e_pad - e_real, n)]).astype(np.int32))

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    table = randn(n, n_ch * (kz + 1)).to(TDT[transport])
    gtab = randn(n, n_ch * (kz + 1))
    logden, adst = randn(n_ch, n), randn(n_ch, n)
    if kernel == "K14":  # [g | gout | logden | a_dst], g unrounded
        return (table, torch.cat([gtab, logden.t(), adst.t()], 1), src, dst, n, kz), src
    if kernel == "K2":
        return (table, gtab, logden[0], adst[0], src, dst, n, kz), src
    if kernel == "K13":  # K2's inputs, walked by dst
        return (table, gtab, logden[0], adst[0], src, dst, n, kz), dst
    return (table, gtab, logden, adst, src, dst, n, kz), src


@pytest.mark.parametrize("transport", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["K2", "K4", "K14", "K13"])
def test_plain_backwards_do_not_read_the_walk(kernel, transport):
    wrapper, plain = WRAPPERS[kernel]
    args, ids = _bwd_case(kernel, transport)
    want = plain(*args)
    assert all(w.abs().sum() > 0 for w in want)
    side, walk_of = ("dst", tfg.dst_walk) if kernel == "K13" else ("src", tfg.src_walk)
    perm, srt = walk_of(ids)
    wrong = torch.flip(perm, [0])[:100]  # drops and reorders edges
    for walk in ((perm, srt), (wrong, ids[wrong.long()])):
        got = plain(*args, **{f"{side}_perm": walk[0], f"{side}_sorted": walk[1]})
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # the wrapper on CPU tensors: the plain version, no launch
    before = wrapper.launches
    for a, b in zip(wrapper(*args, **{f"{side}_perm": perm, f"{side}_sorted": srt}), want):
        assert torch.equal(a, b)
    assert wrapper.launches == before


@pytest.fixture(scope="module")
def flagship_plan():
    """The flagship's configuration (9 two-step GAT channels, the hybrid
    plan: one step-1 union graph, step-2 shares of 7 and 2 channels) at a
    tiny size, on the CPU."""
    hin = build_mlsmall_hin(*synthetic_mlsmall_raw(seed=3, num_users=80, num_items=100),
                            num_core=5, num_feat_core=3)
    cfg = PEAConfig(conv="gat", num_nodes=hin.num_nodes, meta_path_steps=(2,) * 9,
                    emb_dim=8, hidden_size=8, repr_dim=4, entity_aware=True)
    return PEATrainer(hin, cfg, TrainConfig(batch_size=64), device="cpu")


def _spy(seen, kind, plain):
    def call(*args, src_perm=None, src_sorted=None, **kw):
        seen[kind].append((src_perm, src_sorted))
        return plain(*args, **kw)
    return call


@pytest.mark.parametrize("bwd", ["fused", "onepass"])
def test_models_pass_the_step_graphs_walk(flagship_plan, monkeypatch, bwd):
    """K2 (the default mode) or K14 (bwd='onepass') on the union graph, K4
    on the step-2 shares."""
    tr = flagship_plan
    (_, union, rest), (shares, _, _) = tr.graphs.steps
    assert rest and len(shares) == 2
    seen = {"flash": [], "batch": []}
    if bwd == "onepass":
        monkeypatch.setattr(tr, "flash_mode", FlashGATMode(bwd="onepass"))
        monkeypatch.setattr(tfg, "flash_gat_bwd", None)  # must not run
        monkeypatch.setattr(tfg, "flash_gat_bwd_onepass",
                            _spy(seen, "flash", tfg.flash_gat_bwd_onepass_plain))
    else:
        monkeypatch.setattr(tfg, "flash_gat_bwd", _spy(seen, "flash", tfg.flash_gat_bwd_plain))
    monkeypatch.setattr(tbg, "batch_gat_bwd", _spy(seen, "batch", tbg.batch_gat_bwd_plain))
    params = tr.init(0)
    batch = tr._build_batch(torch.arange(64), torch.Generator().manual_seed(0))
    tr.batch_loss(params, batch, torch.ones(64)).backward()
    # the StepGraph's own tensors, one backward each (autograd's order):
    # no copy and no sort a step
    want = {"flash": [union], "batch": [g for g, _ in shares]}
    for kind, graphs in want.items():
        got = sorted((perm.data_ptr(), srt.data_ptr()) for perm, srt in seen[kind])
        assert got == sorted((g.src_perm.data_ptr(), g.src_sorted.data_ptr()) for g in graphs)


def _glue_spies(seen, monkeypatch):
    """Spies on K13 (seen["glue"]: its walk by dst) and on K6 (seen["scatter"]:
    its ids and order), each calling the real CPU path."""
    def glue(*args, dst_perm=None, dst_sorted=None, **kw):
        seen["glue"].append((dst_perm, dst_sorted))
        return tfg.flash_gat_bwd_glue_plain(*args, **kw)

    scatter_add = tsk.localized_scatter_add

    def scatter(ct, idx, num_rows, transport="f32", order=None):
        seen["scatter"].append((idx, order))
        return scatter_add(ct, idx, num_rows, transport, order=order)

    monkeypatch.setattr(tfg, "flash_gat_bwd_glue", glue)
    monkeypatch.setattr(tsk, "localized_scatter_add", scatter)


def test_glue_backward_gets_the_step_graphs_walks(flagship_plan, monkeypatch):
    """bwd='glue': K13 on the union graph gets its StepGraph's own walk by
    dst, K6 on K13's rows the union graph's src in its own order (the
    design call kept it: K6 reads ct's rows in order), and K4 on the step-2
    shares their walks by source."""
    tr = flagship_plan
    (_, union, _), (shares, _, _) = tr.graphs.steps
    seen = {"glue": [], "scatter": [], "batch": []}
    monkeypatch.setattr(tr, "flash_mode", FlashGATMode(bwd="glue"))
    monkeypatch.setattr(tfg, "flash_gat_bwd", None)  # must not run
    _glue_spies(seen, monkeypatch)
    monkeypatch.setattr(tbg, "batch_gat_bwd", _spy(seen, "batch", tbg.batch_gat_bwd_plain))
    params = tr.init(0)
    batch = tr._build_batch(torch.arange(64), torch.Generator().manual_seed(0))
    tr.batch_loss(params, batch, torch.ones(64)).backward()
    (perm, srt), = seen["glue"]
    assert (perm.data_ptr(), srt.data_ptr()) == (union.dst_perm.data_ptr(),
                                                 union.dst_sorted.data_ptr())
    (idx, order), = seen["scatter"]
    assert idx.data_ptr() == union.src.data_ptr() and order is None
    got = sorted((perm.data_ptr(), srt.data_ptr()) for perm, srt in seen["batch"])
    assert got == sorted((g.src_perm.data_ptr(), g.src_sorted.data_ptr()) for g, _ in shares)


@pytest.mark.parametrize("entry", ["flash", "flash onepass", "flash glue", "batch"])
def test_entry_points_sort_bare_edges_by_src(entry, monkeypatch):
    """flash_gat_attention and batch_gat_attention without a walk hand K2,
    K14 and K4 src_walk's sort of their src; K13's glue kernel gets
    dst_walk's sort of their dst, and its K6 walks the edges' own order."""
    seen = {"flash": [], "batch": [], "glue": [], "scatter": []}
    monkeypatch.setattr(tfg, "flash_gat_bwd", _spy(seen, "flash", tfg.flash_gat_bwd_plain))
    monkeypatch.setattr(tfg, "flash_gat_bwd_onepass",
                        _spy(seen, "flash", tfg.flash_gat_bwd_onepass_plain))
    monkeypatch.setattr(tbg, "batch_gat_bwd", _spy(seen, "batch", tbg.batch_gat_bwd_plain))
    _glue_spies(seen, monkeypatch)
    rng = np.random.default_rng(4)
    n, kz, n_ch, e = 200, 4, 2, 1024
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dst = torch.from_numpy(np.where(np.arange(e) < 1000, rng.integers(0, n, e), n).astype(np.int32))
    z = torch.from_numpy(rng.standard_normal((n_ch, n, kz)).astype(np.float32)).requires_grad_()
    a = torch.from_numpy(rng.standard_normal((n_ch, n)).astype(np.float32))
    if entry == "batch":
        out = tbg.batch_gat_attention(z, a, a, src, dst, n)
    else:
        bwd = entry.split()[1] if " " in entry else "fused"
        packed = tfg.pack_gat_table(z[0].t(), a[0], n, torch.float32)
        out = tfg.flash_gat_attention(packed, a[1], src, dst, None, None, n, kz,
                                      mode=FlashGATMode(bwd=bwd))
    grad, = torch.autograd.grad(out, z, torch.ones_like(out))
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    kind = "batch" if entry == "batch" else "flash"
    if entry == "flash glue":
        assert seen["flash"] == [] and seen["batch"] == []
        (perm, srt), = seen["glue"]
        want = tfg.dst_walk(dst)
        assert torch.equal(perm, want[0]) and torch.equal(srt, want[1])
        (idx, order), = seen["scatter"]
        assert torch.equal(idx, src) and order is None
        return
    assert seen["glue"] == [] and seen["scatter"] == []
    (perm, srt), = seen[kind]
    want = tfg.src_walk(src)
    assert torch.equal(perm, want[0]) and torch.equal(srt, want[1])


def test_step_graph_walks_hold_the_padding_in_row_0(flagship_plan):
    tr = flagship_plan
    (_, union, rest), (shares, _, _) = tr.graphs.steps
    n = tr.cfg.num_nodes
    graphs = [(union, len(rest) * n)] + [(g, n) for g, _ in shares]
    for g, rows in graphs:
        perm = g.src_perm.long()
        assert torch.equal(g.src_sorted, g.src[perm])
        assert torch.equal(torch.sort(perm).values, torch.arange(perm.numel()))
        assert bool((g.src_sorted[1:] >= g.src_sorted[:-1]).all())
        pad = torch.nonzero(g.dst[perm] >= rows).flatten()
        assert pad.numel() == g.dst.numel() - g.num_edges > 0
        # one block at the end of row 0's run, after its real edges
        assert torch.equal(pad, torch.arange(int(pad[0]), int(pad[-1]) + 1))
        assert not g.src_sorted[pad].any()
        end = int(pad[-1]) + 1
        assert end == perm.numel() or int(g.src_sorted[end]) > 0
        assert bool((g.dst[perm[:int(pad[0])]] < rows).all())


@pytest.mark.parametrize("bad", ["no perm", "no sorted", "short", "int64", "strided"])
def test_check_walk_refuses_a_bad_walk(bad):
    src = torch.tensor([3, 1, 2, 1, 0], dtype=torch.int32)
    perm, srt = tfg.src_walk(src)
    tfg.check_walk(src, perm, srt)  # the good walk passes
    walk = {"no perm": (None, srt), "no sorted": (perm, None), "short": (perm[:4], srt[:4]),
            "int64": (perm.long(), srt), "strided": (perm, torch.stack([srt, srt], 1)[:, 0])}
    with pytest.raises(ValueError):
        tfg.check_walk(src, *walk[bad])


@pytest.mark.parametrize("bad", ["none", "no perm", "no sorted", "short", "int64", "strided"])
def test_glue_wrapper_checks_the_walk_by_dst(bad, monkeypatch):
    """flash_gat_bwd_glue off the CPU (the meta device here: shapes and
    dtypes, no data and no card; the table check and the launch replaced)
    refuses a missing or mismatched walk by dst with check_dst_walk's
    error, before any launch; with a good walk it launches once, with as
    many arguments as the C entry's ctypes signature takes."""
    calls = []
    monkeypatch.setattr(tfg, "_check_table",
                        lambda name, table, n_ch, kz: (table.device, n_ch * (kz + 1)))
    monkeypatch.setattr(tfg._cuda, "launch", lambda name, dev, *args: calls.append((name, args)))
    meta = torch.device("meta")
    n, kz, e = 30, 8, 50
    table = torch.empty((n + 1, kz + 1), device=meta)
    gtab = torch.empty((n, kz + 1), device=meta)
    vec = torch.empty(n, device=meta)
    ids, perm, srt = (torch.empty(e, dtype=torch.int32, device=meta) for _ in range(3))
    walk = {"none": (perm, srt), "no perm": (None, srt), "no sorted": (perm, None),
            "short": (perm[:-1], srt[:-1]), "int64": (perm, srt.long()),
            "strided": (torch.stack([perm, perm], 1)[:, 0], srt)}[bad]
    args = (table, gtab, vec, vec, ids, ids, n, kz)
    before = tfg.flash_gat_bwd_glue.launches
    if bad != "none":
        with pytest.raises(ValueError, match="dst_"):
            tfg.flash_gat_bwd_glue(*args, dst_perm=walk[0], dst_sorted=walk[1])
        assert calls == [] and tfg.flash_gat_bwd_glue.launches == before
        return
    ct, da = tfg.flash_gat_bwd_glue(*args, dst_perm=walk[0], dst_sorted=walk[1])
    assert ct.shape == (e, kz + 1) and da.shape == (n,)
    (name, cargs), = calls
    # the C entry's argtypes less the device and the stream, which launch adds
    assert name == "gat_bwd_glue" and len(cargs) == len(tfg._cuda._SIGNATURES[name][1]) - 2
    assert tfg.flash_gat_bwd_glue.launches == before + 1


def test_src_walk_is_the_graphs_stable_sort(flagship_plan):
    (_, union, _), _ = flagship_plan.graphs.steps
    perm, srt = tfg.src_walk(union.src)
    assert torch.equal(perm, union.src_perm) and torch.equal(srt, union.src_sorted)
    given = tfg.src_walk(union.src, union.src_perm, union.src_sorted)
    assert given[0] is union.src_perm and given[1] is union.src_sorted
    with pytest.raises(ValueError):
        tfg.src_walk(union.src, union.src_perm, None)
