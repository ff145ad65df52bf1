#!/usr/bin/env python3
"""csrc/segment.cu's work split against its alternatives, on one card:

    python3 torch_tools/segment_variants.py

row_gather's (K7) words a thread and grid cap, and scatter_add's (K5, K6)
slice and walk, at the calls of one ML-25M f32 training step and of one
PEAGCN and one PEASage f32 step of the flagship
(chip_smoke.record_edge_calls), per group of the calls of one kernel, row
width and dtype.  Each variant is csrc/segment.cu with one rule replaced by
a constant (VARIANTS), built by torch_tools/cu_variants.py with the port's
nvcc flags into graph_recsys_benchmark_tpu_torch/_build/variants/ (one nvcc
a variant, all started together) and bound by ctypes beside the package's
own build, which is the default; "edge order" is the default build
walking the edges' own order instead of the graph's sort by id.  Every call of every variant is
checked first (K7 bitwise; K5 and K6 row by row within chip_smoke.sum_bound
of the float64 sums), then each group is timed back to back
(chip_smoke.device_ms) into outputs allocated once, one a shape, as
chip_smoke.sum_alone does: the kernels without K5's and K6's zeroing.  Prints the card's name and
power limit, then per group [(variant, ms)], the default first.  Needs a
CUDA device (exit 2 without one); prints no result line.
"""

import os
import subprocess
import sys
import time

from cu_variants import build, entry

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORDS = "int u = sizeof(W) == 16 ? 2 : 4;"
_GRID = "constexpr long long kMaxCtas = 132LL * 32;"
_SLICE = "const int slice = d <= 2 ? 4 : num_edges > 4LL * num_rows ? 16 : 8;"
# variant -> (the kernel it changes, the text of csrc/segment.cu it replaces,
# the replacement)
VARIANTS = {
    "words a thread 2": ("gather", _WORDS, "int u = 2;"),
    "words a thread 4": ("gather", _WORDS, "int u = 4;"),
    "words a thread 8": ("gather", _WORDS, "int u = 8;"),
    "grid 132 x 8 CTAs": ("gather", _GRID, "constexpr long long kMaxCtas = 132LL * 8;"),
    **{f"slice {k}": ("sum", _SLICE, f"const int slice = {k};") for k in (2, 4, 8, 16)},
}


def runner(fn, kind, group, sorted_walk, shared):
    """(run, outs): run() launches `fn` on every call of `group` into
    outputs allocated here, zeroed once for K5 and K6: one a call
    (shared=False; outs, [E, width] for K7 and the first D columns for K5
    and K6, are then each call's result) or one a shape, shared by the
    calls as chip_smoke.sum_alone shares them (for timing)."""
    import torch

    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk

    args, outs, by_shape = [], [], {}

    def output(shape, dtype, dev):
        if not shared:
            return torch.zeros(shape, dtype=dtype, device=dev)
        if shape not in by_shape:
            by_shape[shape] = torch.zeros(shape, dtype=dtype, device=dev)
        return by_shape[shape]

    for rec in group:
        v, ids, n = rec[:3]
        if kind == "gather":
            v2 = v.reshape(n, -1)
            out = output((ids.numel(), v2.shape[1]), v.dtype, v.device)
            args.append((v2.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.numel(), n,
                         v2.shape[1] * v2.element_size()))
            outs.append(out)
        else:
            d = v.shape[1]
            out = output((n, sk.acc_width(d)), torch.float32, v.device)
            perm, walk = rec[3] if sorted_walk else (None, ids)
            args.append((v.data_ptr(), int(v.dtype == torch.bfloat16),
                         None if perm is None else perm.data_ptr(), walk.data_ptr(),
                         out.data_ptr(), v.shape[0], n, d, out.shape[1], d, out.shape[1]))
            outs.append(out[:, :d])
    dev = group[0][0].device
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        for a in args:
            rc = fn(dev.index, *a, stream)
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc} at launch")
    return run, outs


def main():
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("segment_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from graph_recsys_benchmark_tpu_torch.ops import _cuda
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk
    from graph_recsys_benchmark_tpu_torch.ops.segment import segment_sum

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    t0 = time.perf_counter()
    _cuda.build_all()
    libs = build("segment.cu", {name: [(old, new)] for name, (_, old, new) in VARIANTS.items()})
    print(f"built the package and {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _, ml25m = cs.build_ml25m()
    _, flagship = cs.build_flagship()
    groups = {}  # (source, kernel, width, dtype) -> (kind, calls)
    for label, trainer in (("ml25m", ml25m["f32"]), ("PEAGCN", flagship["gcn"]["f32"]),
                           ("PEASage", flagship["sage"]["f32"])):
        for kind, recs in cs.record_edge_calls(trainer).items():
            for rec in recs:
                v, _, n = rec[:3]
                width = v.reshape(n, -1).shape[1] if kind == "gather" else v.shape[1]
                key = (label, cs.SEG_KERNELS[kind], width, str(v.dtype).split(".")[-1])
                groups.setdefault(key, (kind, []))[1].append(rec)
    del ml25m, flagship
    for (label, kernel, width, dtype), (kind, group) in groups.items():
        if kind == "gather":
            default = _cuda.load("row_gather")
            cands = [("default", default, True)] + [
                (name, entry(libs[name], "row_gather"), True)
                for name, (k, _, _) in VARIANTS.items() if k == "gather"]
            wants = [sk.sorted_broadcast_plain(v.reshape(n, -1), ids, n)
                     for v, ids, n, *_ in group]
        else:
            cs.check(all(rec[3] is not None for rec in group), f"{label} {kernel}: no walk")
            default = _cuda.load("scatter_add")
            cands = [("default", default, True), ("edge order", default, False)] + [
                (name, entry(libs[name], "scatter_add"), True)
                for name, (k, _, _) in VARIANTS.items() if k == "sum"]
            wants = [(segment_sum(v.double(), ids, n), cs.sum_bound(v.double(), ids, n))
                     for v, ids, n, _ in group]
        res = []
        for name, fn, sorted_walk in cands:
            run, outs = runner(fn, kind, group, sorted_walk, shared=False)
            run()
            torch.cuda.synchronize()
            for out, want in zip(outs, wants):
                if kind == "gather":
                    cs.check(torch.equal(out, want), f"{label} {kernel} {name}: not a copy")
                else:
                    cs.check_sum(f"{label} {kernel} {name}", out, *want)
            del run, outs
            run, kept = runner(fn, kind, group, sorted_walk, shared=True)
            res.append((name, round(cs.device_ms(run, reps=10), 5)))
            del run, kept
        print(f"{label} {kernel} width {width} {dtype} ({len(group)} calls): {res}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
