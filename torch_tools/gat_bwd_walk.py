#!/usr/bin/env python3
"""The flagship's GAT backwards, K2 (flash_gat_bwd) and K4 (batch_gat_bwd),
on the port's package of a checkout, and csrc/gat_bwd.cu's walk against its
alternatives:

    python3 torch_tools/gat_bwd_walk.py [ROOT]

ROOT is the root of this repo (the default) or of another checkout of it,
such as a parent commit's ``git archive``, so that two trees can be read
side by side on one card in one call.  The script imports chip_smoke.py of
this repo and graph_recsys_benchmark_tpu_torch of ROOT, builds ROOT's
kernels into ROOT's _build/, prints the card's name and power limit, then
runs chip_smoke.kernel_phase on the flagship's PEAGAT plan (per transport:
K1/K12 and K2 on the step-1 union graph, K3 and K4 on the step-2 shares of
7 and 2 channels; each checked against its plain version, its ms, plain ms
and bound; the id_runs of each graph's sources) and times K13
(flash_gat_bwd_glue, the stored cotangent rows) on the union graph.  A
ROOT whose backwards take no walk (before csrc/gat_bwd.cu summed each
source's run) is called without it.  On a ROOT with the walk it then times
the alternatives at the same calls, each checked against the plain version
first (KERNEL_TOL of the largest value) unless VARIANTS marks it a
diagnostic: the edges' own order (the walk perm = arange, ids = src), and
csrc/gat_bwd.cu with some of its lines replaced (VARIANTS: the slice rule,
the worker layouts, the kernel without its atomics or without any work;
built by torch_tools/cu_variants.py, one nvcc a variant, all started
together, into _build/variants/).  Times
are device ms (chip_smoke.device_ms) of the zeroing and the launch, K4's
summed over its two calls.  Needs a CUDA device (exit 2 without one);
prints no result line.
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

_SLICE = "const int slice = !bf16 && !round_att_first ? 16 : 4;"
_K2 = "else if (kz <= 64) GAT_BWD_WALK(16, 16, 4, false);"
_K4_7 = "else if (kz <= 16) GAT_BWD_WALK(32, 4, 4, false);"
_DA = "atomicAdd(dadst + (long long)d * n_ch + c, RoundAttFirst ? dpre_t : dpre);"
_DPK = "atomicAdd(out + q, b4[q]);"
_HEAD = "  constexpr int kWorkers = 32 / GE;  // a warp's\n"
# variant -> (whether its results are checked, [(text of csrc/gat_bwd.cu,
# its replacement)]): the slice rule replaced by a constant, other worker
# layouts (lanes an edge, lanes a channel, columns a lane) for K2 at kz 64
# and K4 at 7 channels, and two diagnostics whose results are wrong and not
# checked: the kernel without its atomics, and without any work (the
# launch of the same grid)
VARIANTS = {
    **{f"slice {k}": (True, [(_SLICE, f"const int slice = {k};")]) for k in (4, 8, 16, 32)},
    "workers 32, 16 lanes a channel": (True, [
        (_K2, "else if (kz <= 64) GAT_BWD_WALK(32, 32, 2, false);"),
        (_K4_7, "else if (kz <= 16) GAT_BWD_WALK(16, 2, 8, false);")]),
    "workers 8": (True, [
        (_K2, "else if (kz <= 64) GAT_BWD_WALK(8, 8, 8, false);"),
        (_K4_7, "else if (kz <= 16) GAT_BWD_WALK(8, 1, 16, false);")]),
    "no atomics (unchecked)": (False, [(_DA, "(void)dpre_t;"), (_DPK, "(void)b4;")]),
    "no work (unchecked)": (False, [(_HEAD, "  if (num_edges >= 0) return;\n" + _HEAD)]),
}


def backward_calls(cs, plan, num_nodes, transport):
    """The flagship step's backward calls on random inputs, as
    chip_smoke.kernel_phase makes them: [(kernel, table, gtab, logden,
    adst_r, g, n_ch, kz, round_att_first)], K2 on the union graph, then K4
    on the two step-2 shares."""
    import numpy as np
    import torch

    from graph_recsys_benchmark_tpu_torch.ops import batch_gat as bg
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg

    dev, t_dtype = torch.device("cuda"), cs.TDT[transport]
    rng = np.random.default_rng(1)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    (_, union, rest), (shares, _, _) = plan.steps
    n_v = len(rest) * num_nodes
    table = randn(n_v, 65).to(t_dtype)
    adst_r, mhat = fg.bound_shift(randn(n_v), table[:, 64], 0.2, t_dtype)
    acc = fg.flash_gat_fwd_plain(table, adst_r, mhat, union.src, union.dst, n_v, 64)
    gtab, logden = cs.bwd_stats(acc, mhat, 1, 64, t_dtype, randn(n_v, 1, 64))
    calls = [("K2", table, gtab, logden, adst_r[None], union, 1, 64, False)]
    for g, chans in shares:
        n_ch = len(chans)
        tab, ad, mh = bg._pack_tables(randn(n_ch, num_nodes, 16), randn(n_ch, num_nodes),
                                      randn(n_ch, num_nodes), num_nodes, 16, n_ch, 0.2, t_dtype)
        acc = bg.batch_gat_fwd_plain(tab, ad, mh, g.src, g.dst, num_nodes, 16)
        gtab, logden = cs.bwd_stats(acc, mh, n_ch, 16, t_dtype, randn(num_nodes, n_ch, 16))
        calls.append(("K4", tab, gtab, logden, ad, g, n_ch, 16, True))
    return calls


def alternatives(cs, plan, num_nodes):
    """Per transport and kernel, the walk's alternatives at the flagship's
    calls: each checked against the plain version, then timed."""
    import torch

    from graph_recsys_benchmark_tpu_torch.ops import _cuda
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg

    t0 = time.perf_counter()
    libs = build("gat_bwd.cu", {name: rules for name, (_, rules) in VARIANTS.items()})
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    cands = [("default", _cuda.load("gat_bwd"), True, True),
             ("edge order", _cuda.load("gat_bwd"), False, True)]
    cands += [(name, entry(lib, "gat_bwd"), True, VARIANTS[name][0])
              for name, lib in libs.items()]
    for transport in cs.TDT:
        calls = backward_calls(cs, plan, num_nodes, transport)
        for kernel in ("K2", "K4"):
            mine = [c for c in calls if c[0] == kernel]
            wants = [fg.gat_bwd_plain(table, gtab, logden, ad, g.src, g.dst, ad.shape[1], kz,
                                      rnd) for _, table, gtab, logden, ad, g, _, kz, rnd in mine]
            res = []
            for name, fn, walk, checked in cands:
                runs, outs = [], []
                for _, table, gtab, logden, ad, g, n_ch, kz, rnd in mine:
                    # one zeroed buffer for dpk (rows padded to 16 bytes) and
                    # da_dst ([rows, n_ch]), as flash_gat.gat_bwd allocates it
                    n, rows, width = table.shape[0], ad.shape[1], n_ch * (kz + 1)
                    stride = -(-width // 4) * 4
                    out = torch.zeros(n * stride + rows * n_ch, device=table.device)
                    dpk, da = out[: n * stride].view(n, stride), out[n * stride:]
                    perm, ids = ((g.src_perm, g.src_sorted) if walk else
                                 (torch.arange(g.src.numel(), dtype=torch.int32,
                                               device=g.src.device), g.src))
                    args = (table.device.index, table.data_ptr(),
                            int(table.dtype == torch.bfloat16), int(rnd), gtab.data_ptr(),
                            logden.data_ptr(), ad.data_ptr(), perm.data_ptr(), ids.data_ptr(),
                            g.dst.data_ptr(), dpk.data_ptr(), da.data_ptr(), g.dst.numel(),
                            rows, kz, n_ch, stride, 0.2)
                    runs.append((out, perm, args))
                    outs.append((dpk[:, :width], da.view(rows, n_ch).t()))

                def run():
                    stream = torch.cuda.current_stream().cuda_stream
                    for out, _, args in runs:
                        out.zero_()
                        rc = fn(*args, stream)
                        if rc != 0:
                            raise RuntimeError(f"{name}: CUDA error {rc} at launch")
                run()
                for got, want in zip(outs, wants if checked else []):
                    cs.check_kernel(f"{kernel} {name}", transport, got, want)
                res.append((name, round(cs.device_ms(run), 5)))
            print(f"{kernel} {transport} alternatives (ms of the step's "
                  f"{len(mine)} call{'s' if len(mine) > 1 else ''}): {res}", flush=True)


def without_walk(fn):
    """`fn` (a backward wrapper that takes no walk) taking the walk's
    keywords and dropping them."""
    @functools.wraps(fn)
    def call(*args, src_perm=None, src_sorted=None):
        return fn(*args)
    return call


def main(argv):
    root = os.path.abspath(argv[1] if len(argv) > 1 else HERE)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("gat_bwd_walk: no CUDA device", file=sys.stderr)
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
    has_walk = "src_perm" in inspect.signature(fg.flash_gat_bwd).parameters
    if not has_walk:  # the backwards before the walk: called without it
        for mod, name in ((fg, "flash_gat_bwd"), (bg, "batch_gat_bwd")):
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
    (_, union, rest), _ = plan.steps
    for transport in cs.TDT:
        _, table, gtab, logden, ad, g, _, kz, _ = backward_calls(
            cs, plan, hin.num_nodes, transport)[0]
        args = (table, gtab, logden[0], ad[0], g.src, g.dst, ad.shape[1], kz)
        got = fg.flash_gat_bwd_glue(*args)
        cs.check_kernel("flash_gat_bwd_glue", transport, [got[1]],
                        [fg.flash_gat_bwd_glue_plain(*args)[1]])
        print(f"K13 flash_gat_bwd_glue {transport}: ms "
              f"{cs.device_ms(lambda: fg.flash_gat_bwd_glue(*args)):.5f}", flush=True)
    if has_walk:
        alternatives(cs, plan, hin.num_nodes)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
