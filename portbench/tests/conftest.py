"""The benchmark's own tests, run with ``python -m pytest portbench/tests``
from the repository's root: on the CPU at a tiny size, the program's plain
kernel versions standing in for the card's; tests marked ``gpu`` skip
without a card.

``tiny_root`` builds a checkout-like root with two cells of a tiny
ML-25M-shaped configuration (400 users, 300 items, the published widths),
the real traffic mixes, metric readers and the ML-25M cells' limits.  The
program's streaming threshold is lowered so that, as at full size, the
user-item graphs stream and the small graphs run the composed convs.
"""

import json
import os
import shutil
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

TINY_DATA = dict(seed=0, num_users=400, num_items=300, target_interactions=8000, num_core=3,
                 num_directors=20, num_actors=40, num_writers=20, num_tags=30,
                 num_genome_tags=40, tagging_rows=1500)
TINY_STREAM = 4000


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


def make_root(path):
    """A root with BENCHMARK.json naming tiny.train and tiny.eval, and a
    bench directory with their files."""
    bench = os.path.join(path, "portbench")
    for sub in ("configs", "traffic", "limits", "metrics"):
        os.makedirs(os.path.join(bench, sub), exist_ok=True)
    cfg = json.load(open(os.path.join(BENCH, "configs", "peagat-ml25m.json")))
    cfg["name"] = "tiny-ml25m"
    cfg["dataset"]["pipeline"][0]["kwargs"] = TINY_DATA
    cfg["stream_min_edges"] = TINY_STREAM
    json.dump(cfg, open(os.path.join(bench, "configs", "tiny-ml25m.json"), "w"))
    for t in ("train", "eval"):
        shutil.copy(os.path.join(BENCH, "traffic", t + ".json"), os.path.join(bench, "traffic"))
    for f in os.listdir(os.path.join(BENCH, "metrics")):
        shutil.copy(os.path.join(BENCH, "metrics", f), os.path.join(bench, "metrics"))
    bm = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bm["workloads"] = [
        {"name": "tiny.train", "config": "tiny-ml25m", "traffic": "train", "chips": 1,
         "why": "tiny"},
        {"name": "tiny.eval", "config": "tiny-ml25m", "traffic": "eval", "chips": 1,
         "why": "tiny"}]
    for m in bm["end_to_end"] + bm["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.train" if w.endswith(".train") else "tiny.eval"
                              for w in m["workloads"]][:1]
    json.dump(bm, open(os.path.join(path, "BENCHMARK.json"), "w"))
    for cell, src in (("tiny.train", "peagat-ml25m.train"), ("tiny.eval", "peagat-ml25m.eval")):
        shutil.copy(os.path.join(BENCH, "limits", src + ".json"),
                    os.path.join(bench, "limits", cell + ".json"))
    return bench


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("root"))
    make_root(path)
    return path


@pytest.fixture
def run_tiny(tiny_root, monkeypatch, tmp_path_factory):
    """run_tiny(cell, seed, seconds, trace) -> the result line's object,
    on the CPU."""
    import torch

    from pbcore import runner, setup, spec
    import graph_recsys_benchmark_tpu_torch.graph as graph

    torch.set_num_threads(2)
    monkeypatch.setattr(graph, "STREAM_MIN_EDGES", TINY_STREAM)
    monkeypatch.setattr(setup, "CACHE_DIR", str(tmp_path_factory.getbasetemp() / "cache"))

    def run(cell_name, seed=3_000_000_017, seconds=1.0, trace=False):
        cell = spec.load_cell(cell_name, tiny_root, os.path.join(tiny_root, "portbench"))
        result, _ = runner.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                                    device="cpu")
        return result

    return run
