"""The port's profiling and roofline utilities (utils/profiling.py,
utils/roofline.py, ops/cost.py) on the CPU, torch only.

* ``trace`` writes a trace file that parses as JSON (Chrome trace events,
  what Perfetto and TensorBoard open) and holds a StepTimer's named range;
  ``StepTimer``, ``timed`` and ``block_on`` give positive seconds here.
* ``roofline_report``: the JAX package's keys and rounding on hand-made
  numbers, ``{}`` for no time or no bytes.
* ``cost_numbers`` of a matrix product: ``FlopCounterMode``'s flops and the
  inputs' and output's bytes.
* Every kernel wrapper declares the terms of its JAX call site's
  ``pl.CostEstimate`` (transcribed here from the JAX source, its padded
  sizes the true ones and its TPU tile factors 1), at two shapes each,
  with the plain version running inside and counted no more.
* One small PEAGCN training step: the wrappers' declarations (4 K7, 2 K5
  and 2 K6 calls) equal a hand sum of the formulas over the union graphs'
  shapes, and no op of a plain version (``index_add``) is counted beside
  them.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
from graph_recsys_benchmark_tpu_torch.ops import batch_gat as bg
from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg
from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk
from graph_recsys_benchmark_tpu_torch.ops import stream_gat as sg
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig
from graph_recsys_benchmark_tpu_torch.utils import profiling, roofline

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# (rows, edges, kz, channels, transport)
SHAPES = [(300, 2600, 16, 3, "f32"), (130, 700, 64, 1, "bf16")]


def test_trace_writes_a_readable_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as prof:
        with profiling.StepTimer("pea_step") as t:
            out = torch.randn(64, 64) @ torch.randn(64, 64)
            t.block_on(out)
    assert t.elapsed > 0
    (name,) = os.listdir(log_dir)
    assert name.endswith(".pt.trace.json")
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "pea_step" in names and "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_timed_and_block_on_on_the_cpu():
    a = torch.randn(128, 128)
    secs = profiling.timed(torch.mm, a, a, iters=3, warmup=1)
    assert secs > 0
    profiling.block_on({"x": [a, (a, 1)]})  # CPU tensors: nothing to wait for


def test_roofline_report_arithmetic():
    rep = roofline.roofline_report((6.7e10, 3.35e9), 0.01, steps=2)
    assert rep == {"bytes_per_step": 1675000000, "flops_per_step": 33500000000,
                   "hbm_gbps": 335.0, "hbm_util": 0.1, "mfu": 0.1, "arith_intensity": 20.0}
    assert roofline.roofline_report((1.0, 2.0), 0.0) == {}
    assert roofline.roofline_report((1.0, 2.0), -1.0) == {}
    assert roofline.roofline_report((1.0, 0.0), 1.0) == {}
    bf16 = roofline.roofline_report((9.89e11, 1.0), 1.0,
                                    flops_peak=roofline.H100_BF16_TENSOR_FLOPS)
    assert bf16["mfu"] == 0.001
    assert (roofline.H100_HBM_BYTES_PER_S, roofline.H100_F32_FLOPS,
            roofline.H100_BF16_TENSOR_FLOPS) == (3.35e12, 67e12, 989e12)


@pytest.mark.parametrize("m,k,n", [(30, 40, 50), (7, 129, 3)])
def test_cost_numbers_of_a_matmul(m, k, n):
    a, b = torch.randn(m, k), torch.randn(k, n)
    flops, nbytes = roofline.cost_numbers(torch.mm, a, b)
    with FlopCounterMode(display=False) as fm:
        torch.mm(a, b)
    assert flops == fm.get_total_flops() == 2 * m * k * n
    assert nbytes == (m * k + k * n + m * n) * 4
    # views move nothing and count nothing
    assert roofline.cost_numbers(lambda x: x.reshape(-1)[:5].unsqueeze(0).t(), a) == (0.0, 0.0)


def _edges(rng, n, e):
    """Block-ordered dst over n rows and random src, plus 37 padding edges
    (dst == n, src 0)."""
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    order = np.lexsort((dst, src, dst // 128))
    src = np.concatenate([src[order], np.zeros(37, np.int64)]).astype(np.int32)
    dst = np.concatenate([dst[order], np.full(37, n)]).astype(np.int32)
    return torch.from_numpy(src), torch.from_numpy(dst)


def _calls(n, e, kz, n_ch, transport):
    """{wrapper name: (call, the JAX formula's (flops, bytes))} at one
    shape.  The formulas are the JAX sites' ``pl.CostEstimate`` with e_pad
    = E (the edges given, padding included), k_pad the row width, n_pad /
    n_src_pad / n_out the rows and _R = _BR = _FC = n_tiles = 1."""
    rng = np.random.default_rng(n)
    src, dst = _edges(rng, n, e)
    E = dst.shape[0]
    t = TDT[transport]
    isz = torch.finfo(t).bits // 8

    def r(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    k1, kg = kz + 1, kz + 3
    perm = torch.argsort(src.long(), stable=True).to(torch.int32)
    sw = sg.stat_width(n_ch, kz)
    kb = n_ch * kg  # the streaming band, unpadded
    kc = n_ch * k1
    calls = {
        # pallas_segment.py:203
        "sorted_segment_sum": (lambda: sk.sorted_segment_sum(r(E, kz), dst, n, transport),
                               (2 * 1 * E * kz, E * kz * isz + E * 4 + n * kz * 4)),
        # pallas_segment.py:580
        "sorted_broadcast": (lambda: sk.sorted_broadcast(r(n, kz, dtype=t), dst, n),
                             (2 * 1 * E * kz, E * (4 + 4 * kz) + n * isz * kz)),
        # pallas_segment.py:741
        "localized_scatter_add": (lambda: sk.localized_scatter_add(r(E, kz), src, n, transport),
                                  (2 * 1 * E * kz, 1 * E * (4 + isz * kz) + 1 * n * 4 * kz)),
        # no JAX site: alpha and dst read, [max | sum] written
        "softmax_stats": (lambda: sk.softmax_stats(r(E), dst, n), (2 * E, E * 8 + n * 8)),
        # flash_gat.py:654
        "flash_gat_fwd": (lambda: fg.flash_gat_fwd(r(n, k1, dtype=t), r(n), r(n), src, dst, n,
                                                   kz),
                          (2 * E * k1 * (1 + 2 * 1), E * 8 + k1 * n * isz + n * (k1 + 8) * 4)),
        # no JAX site of its own (the online kernel's first pass)
        "gat_rowmax": (lambda: fg.gat_rowmax(r(n, k1, dtype=t), r(n), src, dst, n, kz),
                       (2 * E, E * 8 + n * isz + n * 8)),
        # flash_gat.py:803
        "flash_gat_fwd_online": (
            lambda: fg.flash_gat_fwd_online(r(n, k1, dtype=t), r(n), r(n), src, dst, n, kz),
            (2 * E * k1 * (1 + 1), E * 8 + E // 1 * 2 * 1 * k1 * isz + n * (k1 + 3) * 4)),
        # flash_gat.py:1061, fused_scatter
        "flash_gat_bwd": (
            lambda: fg.flash_gat_bwd(r(n, k1, dtype=t), r(n, k1), r(n), r(n), src, dst, n, kz),
            (2 * E * (k1 * 1 * 2 + kg * 2 * 1 + 1),
             E * 8 + k1 * n * isz + kg * n * 4 + k1 * n * 4 + n * 4)),
        # flash_gat.py:1061, not fused_scatter
        "flash_gat_bwd_glue": (
            lambda: fg.flash_gat_bwd_glue(r(n, k1, dtype=t), r(n, k1), r(n), r(n), src, dst, n,
                                          kz),
            (2 * E * (k1 * 1 * 1 + kg * 2 * 1 + 1),
             E * 8 + k1 * n * isz + kg * n * 4 + k1 * E * isz + n * 4)),
        # flash_gat.py:1295
        "flash_gat_bwd_onepass": (
            lambda: fg.flash_gat_bwd_onepass(r(n, k1, dtype=t), r(n, kg), src, dst, n, kz),
            (2 * E * (k1 + kg) * (1 + 1) * 2, E * 8 + n * kg * 4 + k1 * n * (isz + 4))),
        # batch_gat.py:473
        "batch_gat_fwd": (
            lambda: bg.batch_gat_fwd(r(n, kc, dtype=t), r(n_ch, n), r(n_ch, n), src, dst, n,
                                     kz),
            (2 * E * kc * (2 * 1 + 16), E * 8 + kc * n * isz + n * (kc + 16) * 4)),
        # batch_gat.py:595
        "batch_gat_bwd": (
            lambda: bg.batch_gat_bwd(r(n, kc, dtype=t), r(n, kc), r(n_ch, n), r(n_ch, n), src,
                                     dst, n, kz),
            (2 * E * kc * (4 * 1 + 48), E * 8 + kc * (n * isz + n * 4) + n * kc * 4 + n * 32)),
        # stream_gat.py:518
        "stream_gat_fwd": (
            lambda: sg.stream_gat_fwd(r(n, kc, dtype=t), r(n_ch, n), r(n_ch, n), src, dst, n,
                                      kz),
            (2 * E * kb * 2 * 1, E * (kb * isz + 4) + n * kb * 12)),
        # stream_gat.py:536
        "stream_gat_bwd_dst": (
            lambda: sg.stream_gat_bwd_dst(r(n, kc, dtype=t), r(n, sw, dtype=t), src, dst, n,
                                          kz),
            (2 * E * kb * 2 * 1, E * (kb * isz + 4) + n * kb * 8)),
        # stream_gat.py:553
        "stream_gat_bwd_src": (
            lambda: sg.stream_gat_bwd_src(r(n, kc, dtype=t), r(n, sw, dtype=t), perm,
                                          src[perm.long()], dst, n, kz),
            (2 * E * kb * 4 * 1, E * (kb * isz + 4) + n * kb * 12)),
    }
    return calls


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}-e{s[1]}-kz{s[2]}-{s[4]}")
def test_each_wrapper_declares_its_jax_formula(shape):
    calls = _calls(*shape)
    assert len(calls) == 15  # every kernel wrapper of the port
    for name, (call, (flops, nbytes)) in calls.items():
        count = roofline.count_cost(call)
        assert count.by_name[name] == (flops, nbytes, 1), name
        # the plain version ran inside the region and counted nothing more:
        # only the inputs' setup outside (random draws and casts) remains
        inner = {k for k in count.by_name if k != name}
        assert not inner & {"aten.index_add", "aten.scatter_reduce", "aten.exp"}, (name, inner)


def test_pea_gcn_step_counts_its_declarations():
    th = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(seed=3, num_users=80, num_items=100),
                               num_core=5, num_feat_core=3)
    cfg = PEAConfig(conv="gcn", num_nodes=th.num_nodes, meta_path_steps=(2,) * 9, emb_dim=16,
                    hidden_size=16, repr_dim=8, entity_aware=True)
    trainer = PEATrainer(th, cfg, TrainConfig(batch_size=128, num_negative_samples=1),
                         device="cpu", transport="bf16")
    params = trainer.init(0)
    opt = trainer.optimizer(params)
    rows, mask = torch.arange(128), torch.ones(128)
    count = roofline.count_cost(trainer.train_step, params, opt, rows, mask,
                                torch.Generator().manual_seed(0))
    g1, g2 = trainer.graphs
    want = {"sorted_broadcast": [0, 0, 0], "sorted_segment_sum": [0, 0, 0],
            "localized_scatter_add": [0, 0, 0]}

    def add(name, cost):
        want[name] = [want[name][0] + cost[0], want[name][1] + cost[1], want[name][2] + 1]

    # per step: the source rows' gather (K7, bf16 rows) and the sum by dst
    # (K5); backward: K6 of the gathered rows' cotangent, K7 of the sum's
    for g, d_in, d_out in ((g1, 16, 16), (g2, 16, 8)):
        e, n = g.dst.shape[0], g.num_nodes
        add("sorted_broadcast", (2 * e * d_out, e * (4 + 4 * d_out) + n * 2 * d_out))
        add("sorted_segment_sum", (2 * e * d_out, e * d_out * 2 + e * 4 + n * d_out * 4))
        add("localized_scatter_add", (2 * e * d_out, e * (4 + 2 * d_out) + n * 4 * d_out))
        add("sorted_broadcast", (2 * e * d_out, e * (4 + 4 * d_out) + n * 4 * d_out))
    for name, (f, b, calls) in want.items():
        assert count.by_name[name] == (f, b, calls), name
    assert "aten.index_add" not in count.by_name  # the plain versions' sums
    declared = sum(count.by_name[k][1] for k in want)
    aten = sum(v[1] for k, v in count.by_name.items() if k.startswith("aten."))
    assert count.bytes == declared + aten and count.flops > 0
    with torch.no_grad():
        fwd = roofline.count_cost(trainer.eval_forward, params)
        assert roofline.cost_numbers(trainer.eval_forward, params) == (fwd.flops, fwd.bytes)
    assert fwd.by_name["sorted_broadcast"][2] == fwd.by_name["sorted_segment_sum"][2] == 2
