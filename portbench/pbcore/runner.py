"""One run of one cell: set-up, the window, the check, the result line."""

from __future__ import annotations

import gc
import importlib
import json
import sys
import traceback
import types

import torch

from . import check, counts, spec
from .setup import prepare

FORBIDDEN = ("jax", "jaxlib", "flax", "graph_recsys_benchmark_tpu")


def forbidden_modules():
    """Top-level names in sys.modules that no run may hold, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def precision_departures(config):
    """1 where the process's float32 matrix products are not the
    configuration's (float32 with TF32 off), else 0."""
    if config["precision"]["tf32"]:
        return 0
    off = (not torch.backends.cuda.matmul.allow_tf32
           and torch.get_float32_matmul_precision() == "highest")
    return 0 if off else 1


def run_cell(cell: spec.Cell, seed, seconds, trace, t_start, device="cuda"):
    """Run `cell` once; returns the result line's object and the checks."""
    env = prepare(cell.config, cell.traffic, device)
    driver = importlib.import_module(f"{__package__}.{cell.traffic['driver']}")
    readings, record, state = driver.run(env, seed, seconds, trace, t_start)
    dev = env.device
    readings.peak_bytes = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    departures = precision_departures(cell.config)
    sl = readings.slice.read()
    readings.slice = sl
    readings.config = cell.config
    readings.num_nodes = env.hin.num_nodes
    readings.steps_per_channel = env.steps_per_channel
    readings.groups = counts.graph_groups(env.hin.edge_index, cell.config["metapaths"],
                                          cell.config["stream_min_edges"])
    # the program's state goes before the reference runs
    del state
    env.trainer = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    try:
        if readings.kind == "train":
            numbers, notes = check.train_check(env, record)
        else:
            numbers, notes = check.eval_check(env, record)
        numbers["reference_error"] = 0
    except Exception:  # the check reports, the run ends incorrect
        traceback.print_exc()
        numbers, notes = {"reference_error": 1}, {}
    numbers["window_nonfinite"] = readings.failed
    numbers["precision_departures"] = departures
    checks = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    # every number of the cell's limits file read, and each within its limit
    correct = set(numbers) == set(cell.limits) and all(
        v <= cell.limits[k] for k, v in numbers.items())

    metrics = {}
    entries = cell.per_layer if trace else cell.end_to_end
    for m in entries:
        value = spec.metric_reader(m["name"], cell.bench_dir)(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(readings.peak_bytes),
    }
    result = {"correct": bool(correct), "attempted": readings.units,
              "failed": readings.failed, "metrics": metrics, "device": device_info}
    if trace:  # a window too short for its slice reads 0 here
        device_info["busy_s"] = sl.busy_s() if sl else 0.0
        device_info["window_s"] = sl.window_s() if sl else 0.0
        result["breakdown"] = {"device_ops": sl.top_ops(10) if sl else [],
                               "idle_gaps": sl.idle_gaps(10) if sl else []}
    result["notes"] = notes
    result["checks"] = checks
    return result, types.SimpleNamespace(readings=readings, record=record, env=env)


def emit(result):
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
