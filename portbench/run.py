"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port
(``graph_recsys_benchmark_tpu_torch``).  The cell is an entry of
``BENCHMARK.json``; its configuration, traffic mix, limits and metric
readers are files under ``portbench/`` (pbcore/spec.py).  The last line of
standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; ``checks`` last,
each number compared with its limit, which also end standard error.

Exits 2 without as many CUDA cards as the cell asks for, and 1 where the
run fails or the process holds JAX or the JAX package after the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CORES = (2, 3)


def steady_host():
    """One thread pool of one thread, on a fixed pair of cores (CORES, or the
    first two this process may use), so that the host, which paces every
    cell, runs the same few threads in every run.  Pinned and unpinned runs
    spread alike on a sandboxed host whose pace drifts (PERF.md).  Runs
    before torch is imported, so that every thread it starts inherits both."""
    os.environ["OMP_NUM_THREADS"] = "1"
    allowed = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, [c for c in CORES if c in allowed] or allowed[:2])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    steady_host()
    sys.path[:0] = [HERE, ROOT]
    from pbcore import runner, spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, _ = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    bad = runner.forbidden_modules()
    if bad:
        print(f"the process holds {bad} after the window", file=sys.stderr)
        return 1
    runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
