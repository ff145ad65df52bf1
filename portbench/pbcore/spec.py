"""Find a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix.  Everything else is found by file name alone, so a later
change adds a cell, a configuration or a metric by adding files:

  portbench/configs/<config>.json   the configuration (sizes, recipe, data)
  portbench/traffic/<traffic>.json  the traffic mix (window driver, overrides)
  portbench/limits/<cell>.json      the limit of each number that decides
                                    ``correct`` in that cell
  portbench/metrics/<metric>.py     one reader a metric: ``read(r)`` returns
                                    the metric's value from the run's
                                    readings, or None where it finds nothing

A cell reports each end-to-end metric whose ``workloads`` names it (or
that has no ``workloads``), and each per-layer metric whose ``workloads``
names it (or, without the key, whose ``moves`` metric the cell reports).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file, the traffic's overrides applied
    traffic: dict
    limits: dict  # number name -> limit
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list
    bench_dir: str = BENCH_DIR


def read_json(path):
    with open(path) as fh:
        return json.load(fh)


def _applies(metric, cell_name, reported):
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name, root=ROOT, bench_dir=None) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files from
    `bench_dir` (default: root/portbench)."""
    bench_dir = bench_dir or os.path.join(root, "portbench")
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = entries[0]
    config = read_json(os.path.join(bench_dir, "configs", w["config"] + ".json"))
    traffic = read_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    config = merge(config, traffic.get("overrides", {}))
    limits = read_json(os.path.join(bench_dir, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, None)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)


def merge(base: dict, overrides: dict) -> dict:
    """`base` with `overrides` applied key by key (nested dicts merged)."""
    out = dict(base)
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return out


def metric_reader(name, bench_dir=BENCH_DIR):
    """The ``read`` function of portbench/metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
