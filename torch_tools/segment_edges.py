#!/usr/bin/env python3
"""One ML-25M training step's K7, K5 and K6 calls, replayed per width group
(chip_smoke.ml25m_edge_kernel_phase), on the port's package of a checkout:

    python3 torch_tools/segment_edges.py [--wide] [ROOT]

With --wide, K5, K7 and K6 at 300 columns on the flagship's PEAGCN step-1
union graph (chip_smoke.edge_cases on chip_smoke.build_flagship's graph:
15,210 rows, 169,155 edges), in place of the ML-25M step.

ROOT is the root of this repo (the default) or of another checkout of it,
such as a parent commit's ``git archive``, so that two trees can be read
side by side on one card in one call.  The script imports chip_smoke.py of
this repo and graph_recsys_benchmark_tpu_torch of ROOT, builds ROOT's
kernels into ROOT's _build/, and prints the card's name and power limit,
then the phase's lines.  ROOT's scatter_add may be the C entry before the
graph's sorted walks (no walk, no padded accumulator); its kernel-alone
time is then taken through that entry.  Needs a CUDA device (exit 2
without one); prints no result line.
"""

import importlib.util
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def edge_order_sum_alone(group):
    """chip_smoke.sum_alone for the scatter_add entry without a walk:
    (device, rows, bf16, ids, out, num_edges, num_rows, d, stream), out an
    unpadded f32 [num_rows, d], one a shape as there."""
    import torch

    from graph_recsys_benchmark_tpu_torch.ops import _cuda

    outs, args = {}, []
    for v, ids, n, *_ in group:
        shape = (n, v.shape[1])
        if shape not in outs:
            outs[shape] = torch.zeros(shape, dtype=torch.float32, device=v.device)
        args.append((v.device, v.data_ptr(), int(v.dtype == torch.bfloat16), ids.data_ptr(),
                     outs[shape].data_ptr(), v.shape[0], n, v.shape[1]))

    def run():
        for a in args:
            _cuda.launch("scatter_add", *a)
    run.outs = outs  # kept alive with run
    return run


def main(argv):
    wide = "--wide" in argv
    argv = [a for a in argv if a != "--wide"]
    root = os.path.abspath(argv[1] if len(argv) > 1 else HERE)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("segment_edges: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import graph_recsys_benchmark_tpu_torch as pkg
    from graph_recsys_benchmark_tpu_torch.ops import _cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    print(f"package {os.path.dirname(pkg.__file__)}", flush=True)
    t0 = time.perf_counter()
    logs = _cuda.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    if wide:
        import numpy as np

        _, trainers = cs.build_flagship()
        t0 = time.perf_counter()
        cs.edge_cases(trainers["gcn"]["f32"].graphs[0], 300, "PEAGCN hidden 300 step 1",
                      "gcn", np.random.default_rng(1), {})
        print(f"wide edge cases {time.perf_counter() - t0:.1f} s", flush=True)
        return 0
    if len(_cuda._SIGNATURES["scatter_add"][1]) == 9:  # the entry without a walk
        cs.sum_alone = edge_order_sum_alone
    _, trainers = cs.build_ml25m()
    t0 = time.perf_counter()
    cs.ml25m_edge_kernel_phase(trainers)
    print(f"ml25m edge phase {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
