"""The walk of the GAT forwards K1/K12 (flash_gat_fwd), K3 (batch_gat_fwd)
and K12-online (gat_rowmax, then flash_gat_fwd_online) on the CPU, torch
only.

csrc/gat_fwd.cu walks the graph's stable sort by dst (StepGraph.dst_perm /
dst_sorted) and sums each dst row's run before it writes (the row max
takes one atomic a run); the kernels run on the card only
(tests/test_torch_kernels.py, chip_smoke.py).  Here:
  * the plain versions accept the walk and do not read it: the same
    results, bitwise, with the walk, without it and with a wrong one, so
    they stay an independent reference for the kernel's walk;
  * the flagship's plan, built at a tiny size, hands each GAT forward its
    StepGraph's own walk by dst (a spy on the wrappers during one step:
    pea_forward_hybrid's batched shares and _fused_gat_step's union, in
    the default mode and with the online shift), and the entry points
    build dst_walk's sort for callers with bare edges;
  * every step graph's walk is dst[dst_perm] with the padding edges last;
  * check_dst_walk, the argument check of a CUDA call, refuses a missing,
    non-int32 or wrong-length walk, and dst_walk builds the graph's stable
    sort.
"""

import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu_torch.data import build_mlsmall_hin, synthetic_mlsmall_raw
from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
from graph_recsys_benchmark_tpu_torch.ops import batch_gat as tbg
from graph_recsys_benchmark_tpu_torch.ops import flash_gat as tfg
from graph_recsys_benchmark_tpu_torch.ops.config import FlashGATMode
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fwd_case(kernel, transport, seed=0):
    """A small forward call (args of flash_gat_fwd, batch_gat_fwd,
    gat_rowmax or flash_gat_fwd_online) on a block-ordered graph with
    padding, and its dst."""
    rng = np.random.default_rng(seed)
    n, e_real, e_pad = 300, 2000, 2048
    n_ch, kz = (3, 4) if kernel == "K3" else (1, 8)
    src, dst = rng.integers(0, n, e_real), rng.integers(0, n, e_real)
    order = np.lexsort((dst, src, dst // 128))
    src = torch.from_numpy(np.concatenate([src[order], np.zeros(e_pad - e_real)]).astype(np.int32))
    dst = torch.from_numpy(np.concatenate([dst[order], np.full(e_pad - e_real, n)]).astype(np.int32))
    z = torch.from_numpy(rng.standard_normal((n_ch, n, kz)).astype(np.float32))
    a_src, a_dst = (torch.from_numpy(rng.standard_normal((n_ch, n)).astype(np.float32))
                    for _ in range(2))
    table, adst_r, mhat = tbg._pack_tables(z, a_src, a_dst, n, kz, n_ch, 0.2, TDT[transport])
    if kernel == "K12-online row max":
        return (table, adst_r[0], src, dst, n, kz), dst
    if kernel == "K12-online walk":  # the row max as the shift
        m = tfg.gat_rowmax_plain(table, adst_r[0], src, dst, n, kz)
        return (table, adst_r[0], m, src, dst, n, kz), dst
    if kernel == "K1":
        return (table, adst_r[0], mhat[0], src, dst, n, kz), dst
    return (table, adst_r, mhat, src, dst, n, kz), dst


WRAPPERS = {"K1": (tfg.flash_gat_fwd, tfg.flash_gat_fwd_plain),
            "K3": (tbg.batch_gat_fwd, tbg.batch_gat_fwd_plain),
            "K12-online row max": (tfg.gat_rowmax, tfg.gat_rowmax_plain),
            "K12-online walk": (tfg.flash_gat_fwd_online, tfg.flash_gat_fwd_plain)}


@pytest.mark.parametrize("transport", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_plain_forwards_do_not_read_the_walk(kernel, transport):
    wrapper, plain = WRAPPERS[kernel]
    args, dst = _fwd_case(kernel, transport)
    want = plain(*args)
    assert want.abs().sum() > 0
    perm, srt = tfg.dst_walk(dst)
    wrong = torch.flip(perm, [0])[:100]  # drops and reorders edges
    for walk in ((perm, srt), (wrong, dst[wrong.long()])):
        assert torch.equal(plain(*args, dst_perm=walk[0], dst_sorted=walk[1]), want)
    # the wrapper on CPU tensors: the plain version, no launch
    before = wrapper.launches
    assert torch.equal(wrapper(*args, dst_perm=perm, dst_sorted=srt), want)
    assert torch.equal(wrapper(*args), want)
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
    def call(*args, dst_perm=None, dst_sorted=None, **kw):
        seen[kind].append((dst_perm, dst_sorted))
        return plain(*args, **kw)
    return call


@pytest.mark.parametrize("shift", ["bound", "online"])
def test_models_pass_the_step_graphs_dst_walk(flagship_plan, monkeypatch, shift):
    """K1/K12 (the default mode) or K12-online's row max and walk
    (softmax_shift='online') on the union graph, K3 on the step-2 shares."""
    tr = flagship_plan
    (_, union, rest), (shares, _, _) = tr.graphs.steps
    assert rest and len(shares) == 2
    seen = {"flash": [], "rowmax": [], "batch": []}
    if shift == "online":
        monkeypatch.setattr(tr, "flash_mode", FlashGATMode(softmax_shift="online"))
        monkeypatch.setattr(tfg, "flash_gat_fwd", None)  # must not run
        monkeypatch.setattr(tfg, "gat_rowmax", _spy(seen, "rowmax", tfg.gat_rowmax_plain))
        monkeypatch.setattr(tfg, "flash_gat_fwd_online",
                            _spy(seen, "flash", tfg.flash_gat_fwd_plain))
    else:
        monkeypatch.setattr(tfg, "flash_gat_fwd", _spy(seen, "flash", tfg.flash_gat_fwd_plain))
    monkeypatch.setattr(tbg, "batch_gat_fwd", _spy(seen, "batch", tbg.batch_gat_fwd_plain))
    params = tr.init(0)
    batch = tr._build_batch(torch.arange(64), torch.Generator().manual_seed(0))
    tr.batch_loss(params, batch, torch.ones(64)).backward()
    # the StepGraph's own tensors, one forward each: no copy and no sort a
    # step (_fused_gat_step on the union graph, pea_forward_hybrid on the
    # shares)
    want = {"flash": [union], "rowmax": [union] if shift == "online" else [],
            "batch": [g for g, _ in shares]}
    for kind, graphs in want.items():
        got = sorted((perm.data_ptr(), srt.data_ptr()) for perm, srt in seen[kind])
        assert got == sorted((g.dst_perm.data_ptr(), g.dst_sorted.data_ptr()) for g in graphs)


@pytest.mark.parametrize("entry", ["flash", "flash online", "batch"])
def test_entry_points_sort_bare_edges_by_dst(entry, monkeypatch):
    """flash_gat_attention and batch_gat_attention without a walk hand the
    forward dst_walk's sort of their dst; in the online shift both the row
    max and the walk get it."""
    seen = {"flash": [], "rowmax": [], "batch": []}
    monkeypatch.setattr(tfg, "flash_gat_fwd", _spy(seen, "flash", tfg.flash_gat_fwd_plain))
    monkeypatch.setattr(tfg, "flash_gat_fwd_online", _spy(seen, "flash", tfg.flash_gat_fwd_plain))
    monkeypatch.setattr(tfg, "gat_rowmax", _spy(seen, "rowmax", tfg.gat_rowmax_plain))
    monkeypatch.setattr(tbg, "batch_gat_fwd", _spy(seen, "batch", tbg.batch_gat_fwd_plain))
    rng = np.random.default_rng(4)
    n, kz, n_ch, e = 200, 4, 2, 1024
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dst = torch.from_numpy(np.where(np.arange(e) < 1000, rng.integers(0, n, e), n).astype(np.int32))
    z = torch.from_numpy(rng.standard_normal((n_ch, n, kz)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((n_ch, n)).astype(np.float32))
    if entry == "batch":
        out = tbg.batch_gat_attention(z, a, a, src, dst, n)
    else:
        mode = FlashGATMode(softmax_shift="online" if entry == "flash online" else "bound")
        packed = tfg.pack_gat_table(z[0].t(), a[0], n, torch.float32)
        out = tfg.flash_gat_attention(packed, a[1], src, dst, None, None, n, kz, mode=mode)
    assert torch.isfinite(out).all()
    kind = "batch" if entry == "batch" else "flash"
    kinds = [kind, "rowmax"] if entry == "flash online" else [kind]
    assert sorted(k for k, v in seen.items() if v) == sorted(kinds)
    want = tfg.dst_walk(dst)
    for k in kinds:
        (perm, srt), = seen[k]
        assert torch.equal(perm, want[0]) and torch.equal(srt, want[1])


def test_step_graph_dst_walks_put_the_padding_last(flagship_plan):
    tr = flagship_plan
    (_, union, rest), (shares, _, _) = tr.graphs.steps
    n = tr.cfg.num_nodes
    graphs = [(union, len(rest) * n)] + [(g, n) for g, _ in shares]
    for g, rows in graphs:
        perm = g.dst_perm.long()
        assert torch.equal(g.dst_sorted, g.dst[perm])
        assert torch.equal(torch.sort(perm).values, torch.arange(perm.numel()))
        assert bool((g.dst_sorted[1:] >= g.dst_sorted[:-1]).all())
        pad = torch.nonzero(g.dst_sorted >= rows).flatten()
        assert pad.numel() == g.dst.numel() - g.num_edges > 0
        # the padding is the walk's tail: the kernel stops adding there
        assert torch.equal(pad, torch.arange(g.num_edges, perm.numel()))
        # a stable sort: each row's run keeps the edges' own order
        runs_ordered = (g.dst_sorted[1:] != g.dst_sorted[:-1]) | (perm[1:] > perm[:-1])
        assert bool(runs_ordered.all())


@pytest.mark.parametrize("bad", ["no perm", "no sorted", "short", "int64", "strided"])
def test_check_dst_walk_refuses_a_bad_walk(bad):
    dst = torch.tensor([3, 1, 2, 1, 5], dtype=torch.int32)
    perm, srt = tfg.dst_walk(dst)
    tfg.check_dst_walk(dst, perm, srt)  # the good walk passes
    walk = {"no perm": (None, srt), "no sorted": (perm, None), "short": (perm[:4], srt[:4]),
            "int64": (perm, srt.long()), "strided": (torch.stack([perm, perm], 1)[:, 0], srt)}
    with pytest.raises(ValueError, match="dst_"):
        tfg.check_dst_walk(dst, *walk[bad])


def test_dst_walk_is_the_graphs_stable_sort(flagship_plan):
    (_, union, _), (shares, _, _) = flagship_plan.graphs.steps
    for g in [union] + [g for g, _ in shares]:
        perm, srt = tfg.dst_walk(g.dst)
        assert torch.equal(perm, g.dst_perm) and torch.equal(srt, g.dst_sorted)
    given = tfg.dst_walk(union.dst, union.dst_perm, union.dst_sorted)
    assert given[0] is union.dst_perm and given[1] is union.dst_sorted
    with pytest.raises(ValueError):
        tfg.dst_walk(union.dst, None, union.dst_sorted)
