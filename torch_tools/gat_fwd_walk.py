#!/usr/bin/env python3
"""The flagship's GAT forwards, K1/K12 (flash_gat_fwd) and K3
(batch_gat_fwd), on the port's package of a checkout, and csrc/gat_fwd.cu's
walk by dst against its alternatives:

    python3 torch_tools/gat_fwd_walk.py [ROOT]

ROOT is the root of this repo (the default) or of another checkout of it,
such as a parent commit's ``git archive``, so that two trees can be read
side by side on one card in one call.  The script imports chip_smoke.py of
this repo and graph_recsys_benchmark_tpu_torch of ROOT, builds ROOT's
kernels into ROOT's _build/, prints the card's name and power limit, then
runs chip_smoke.kernel_phase on the flagship's PEAGAT plan (per transport:
K1/K12 and K2 on the step-1 union graph, K3 and K4 on the step-2 shares of
7 and 2 channels; each checked against its plain version, its ms, plain ms
and bound; the id_runs of each graph's sources and dsts) and times
K12-online's walk (flash_gat_fwd_online, the per-edge kernel) on the union
graph.  A ROOT whose forwards take no walk (before csrc/gat_fwd.cu summed
each dst row's run) is called without it.  On a ROOT with the walk it then
times the alternatives at the same calls, each checked against the plain
version first (chip_smoke.check_kernel: KERNEL_TOL of the largest value)
unless VARIANTS marks it a diagnostic: the edges' own order (the walk perm
= arange, ids = dst), and csrc/gat_fwd.cu with some of its lines replaced
(VARIANTS: the slice, the worker layouts, plain 16-byte stores for the
runs that lie inside one slice, the kernel without its atomics or without
any work; built by torch_tools/cu_variants.py, one nvcc a variant, all
started together, into _build/variants/).  Times are device ms
(chip_smoke.device_ms) of the zeroing and the launch, K3's summed over its
two calls.  Needs a CUDA device (exit 2 without one); prints no result
line.
"""

import functools
import importlib.util
import inspect
import os
import subprocess
import sys
import time

from cu_variants import build, entry

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SLICE = "const int slice = 8;"
_K1 = "else if (kz <= 64) GAT_FWD_WALK(8, 8, 8);"
_K3_2 = "if (kz <= 16 && n_ch <= 2) GAT_FWD_WALK(8, 4, 4);"
_K3_7 = "else if (kz <= 16) GAT_FWD_WALK(32, 4, 4);"
_PASS = "  for (int base = 0; base < kz; base += kCols) {\n"
_CUR = "    int cur = -1;  // the run's row; -1 before the slice's first real edge\n"
_FLUSH = "    auto flush = [&]() {\n"
_WRITE = "for (int q = wl; q < span / 4; q += GE) atomicAdd(out + q, b4[q]);"
_FRESH = "          if (cur >= 0) flush();\n          cur = d;\n"
_END = "    if (cur >= 0) flush();\n    __syncwarp(wmask);"
_HEAD = "  constexpr int kWorkers = 32 / GE;  // a warp's\n"
# variant -> (whether its results are checked, [(text of csrc/gat_fwd.cu,
# its replacement)]): the slice replaced by a constant, other worker
# layouts (lanes an edge, lanes a channel, columns a lane) for K1/K12 at kz
# 64 and K3 at 2 and 7 channels (the first the backward's, gat_bwd.cu), the
# runs inside one slice stored, and two diagnostics whose results are
# wrong and not checked: the kernel without its atomics, and without any
# work (the launch of the same grid)
VARIANTS = {
    **{f"slice {k}": (True, [(_SLICE, f"const int slice = {k};")]) for k in (4, 16)},
    "layouts K1 (16, 16, 4), K3 (16, 8, 2) / (16, 2, 8)": (True, [
        (_K1, "else if (kz <= 64) GAT_FWD_WALK(16, 16, 4);"),
        (_K3_2, "if (kz <= 16 && n_ch <= 2) GAT_FWD_WALK(16, 8, 2);"),
        (_K3_7, "else if (kz <= 16) GAT_FWD_WALK(16, 2, 8);")]),
    "layouts K1 (4, 4, 16), K3 (16, 4, 4) / (8, 1, 16)": (True, [
        (_K1, "else if (kz <= 64) GAT_FWD_WALK(4, 4, 16);"),
        (_K3_2, "if (kz <= 16 && n_ch <= 2) GAT_FWD_WALK(16, 4, 4);"),
        (_K3_7, "else if (kz <= 16) GAT_FWD_WALK(8, 1, 16);")]),
    # a run that starts and ends inside one worker's slice has no other
    # writer: its row is stored, not added (the ids just before and after
    # the slice tell whether the slice's first and last runs go on there)
    "stores for whole runs": (True, [
        (_PASS, "  int before = -1, after = -1;\n"
                "  if (k0 > 0 && k0 - 1 < num_edges) before = __ldg(ids + k0 - 1);\n"
                "  if (k0 + slice < num_edges) after = __ldg(ids + k0 + slice);\n" + _PASS),
        (_CUR, _CUR + "    bool alone = false;\n"),
        (_FLUSH, "    auto flush = [&](bool ends_here) {\n"),
        (_WRITE, "for (int q = wl; q < span / 4; q += GE) {\n"
                 "        if (alone && ends_here) out[q] = b4[q];\n"
                 "        else atomicAdd(out + q, b4[q]);\n      }"),
        (_FRESH, "          if (cur >= 0) flush(true);\n"
                 "          alone = cur >= 0 || d != before;\n          cur = d;\n"),
        (_END, "    if (cur >= 0) flush(cur != after);\n    __syncwarp(wmask);")]),
    "no atomics (unchecked)": (False, [(_WRITE, "(void)b4;")]),
    "no work (unchecked)": (False, [(_HEAD, "  if (num_edges >= 0) return;\n" + _HEAD)]),
}


def forward_calls(cs, plan, num_nodes, transport):
    """The flagship forward's calls on random inputs, as
    chip_smoke.kernel_phase makes them: [(kernel, table, adst_r, mhat, g,
    rows, n_ch, kz, round_p_first)], K1/K12 on the union graph, then K3 on
    the two step-2 shares."""
    import numpy as np
    import torch

    from graph_recsys_benchmark_tpu_torch.ops import batch_gat as bg
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg

    dev, t_dtype = torch.device("cuda"), cs.TDT[transport]
    rng = np.random.default_rng(2)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    (_, union, rest), (shares, _, _) = plan.steps
    n_v = len(rest) * num_nodes
    table = randn(n_v, 65).to(t_dtype)
    adst_r, mhat = fg.bound_shift(randn(n_v), table[:, 64], 0.2, t_dtype)
    calls = [("K1/K12", table, adst_r[None], mhat[None], union, n_v, 1, 64, False)]
    for g, chans in shares:
        n_ch = len(chans)
        tab, ad, mh = bg._pack_tables(randn(n_ch, num_nodes, 16), randn(n_ch, num_nodes),
                                      randn(n_ch, num_nodes), num_nodes, 16, n_ch, 0.2, t_dtype)
        calls.append(("K3", tab, ad, mh, g, num_nodes, n_ch, 16, True))
    return calls


def alternatives(cs, plan, num_nodes):
    """Per transport and kernel, the walk's alternatives at the flagship's
    calls: each checked against the plain version, then timed."""
    import torch

    from graph_recsys_benchmark_tpu_torch.ops import _cuda
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg

    t0 = time.perf_counter()
    libs = build("gat_fwd.cu", {name: rules for name, (_, rules) in VARIANTS.items()})
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    cands = [("default", _cuda.load("gat_fwd"), True, True),
             ("edge order", _cuda.load("gat_fwd"), False, True)]
    cands += [(name, entry(lib, "gat_fwd"), True, VARIANTS[name][0])
              for name, lib in libs.items()]
    for transport in cs.TDT:
        calls = forward_calls(cs, plan, num_nodes, transport)
        for kernel in ("K1/K12", "K3"):
            mine = [c for c in calls if c[0] == kernel]
            wants = [fg.gat_fwd_plain(table, ad, mh, g.src, g.dst, rows, kz, rnd)
                     for _, table, ad, mh, g, rows, _, kz, rnd in mine]
            res = []
            for name, fn, walk, checked in cands:
                runs, outs = [], []
                for _, table, ad, mh, g, rows, n_ch, kz, rnd in mine:
                    # acc's rows padded to 16 bytes, as flash_gat.gat_fwd
                    # allocates it
                    width = n_ch * (kz + 1)
                    stride = -(-width // 4) * 4
                    acc = torch.zeros(rows, stride, device=table.device)
                    perm, ids = ((g.dst_perm, g.dst_sorted) if walk else
                                 (torch.arange(g.dst.numel(), dtype=torch.int32,
                                               device=g.dst.device), g.dst))
                    args = (table.device.index, table.data_ptr(),
                            int(table.dtype == torch.bfloat16), int(rnd), ad.data_ptr(),
                            mh.data_ptr(), perm.data_ptr(), ids.data_ptr(), g.src.data_ptr(),
                            acc.data_ptr(), g.dst.numel(), rows, kz, n_ch, stride, 0.2)
                    runs.append((acc, perm, args))
                    outs.append(acc[:, :width])

                def run():
                    stream = torch.cuda.current_stream().cuda_stream
                    for acc, _, args in runs:
                        acc.zero_()
                        rc = fn(*args, stream)
                        if rc != 0:
                            raise RuntimeError(f"{name}: CUDA error {rc} at launch")
                run()
                for got, want in zip(outs, wants if checked else []):
                    cs.check_kernel(f"{kernel} {name}", transport, [got], [want])
                res.append((name, round(cs.device_ms(run), 5)))
            print(f"{kernel} {transport} alternatives (ms of the forward's "
                  f"{len(mine)} call{'s' if len(mine) > 1 else ''}): {res}", flush=True)


def without_walk(fn):
    """`fn` (a forward wrapper that takes no walk) taking the walk's
    keywords and dropping them."""
    @functools.wraps(fn)
    def call(*args, dst_perm=None, dst_sorted=None):
        return fn(*args)
    return call


def main(argv):
    root = os.path.abspath(argv[1] if len(argv) > 1 else HERE)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("gat_fwd_walk: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import graph_recsys_benchmark_tpu_torch as pkg
    from graph_recsys_benchmark_tpu_torch.ops import _cuda
    from graph_recsys_benchmark_tpu_torch.ops import batch_gat as bg
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    print(f"package {os.path.dirname(pkg.__file__)}", flush=True)
    t0 = time.perf_counter()
    logs = _cuda.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    cs.ptxas_summary(logs)
    has_walk = "dst_perm" in inspect.signature(fg.flash_gat_fwd).parameters
    if not has_walk:  # the forwards before the walk: called without it
        for mod, name in ((fg, "flash_gat_fwd"), (bg, "batch_gat_fwd")):
            setattr(mod, name, without_walk(getattr(mod, name)))
    t0 = time.perf_counter()
    hin, trainers = cs.build_flagship()
    plan = trainers["gat"]["f32"].graphs
    del trainers
    print(f"flagship built in {time.perf_counter() - t0:.1f} s", flush=True)
    res = cs.kernel_phase(plan, hin.num_nodes)
    for (kind, transport), r in res.items():
        print(f"{kind} {transport}: ms {r['ms']:.5f} bound_ms {r['bound_ms']:.6f} "
              f"(share {r['bound_ms'] / r['ms']:.4f}, {r['bound_by']}) plain_ms "
              f"{r['plain_ms']:.4f} max_abs_err {r['max_abs_err']:.3e}", flush=True)
    for transport in cs.TDT:
        _, table, ad, mh, g, rows, _, kz, _ = forward_calls(
            cs, plan, hin.num_nodes, transport)[0]
        args = (table, ad[0], mh[0], g.src, g.dst, rows, kz)
        cs.check_kernel("flash_gat_fwd_online", transport, [fg.flash_gat_fwd_online(*args)],
                        [fg.flash_gat_fwd_plain(*args)])
        print(f"K12-online flash_gat_fwd_online {transport}: ms "
              f"{cs.device_ms(lambda: fg.flash_gat_fwd_online(*args)):.5f}", flush=True)
    if has_walk:
        alternatives(cs, plan, hin.num_nodes)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
