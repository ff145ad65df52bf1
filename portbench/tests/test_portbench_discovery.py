"""A new cell, configuration, traffic mix or metric is found by its file
name alone: nothing of the harness is edited."""

import json
import os
import shutil


def test_new_files_are_found(run_tiny, tiny_root, tmp_path):
    from pbcore import spec

    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny_root, "portbench"), os.path.join(root, "portbench"))
    bench = os.path.join(root, "portbench")
    bm = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    # a configuration of its own, a traffic mix with an override, a metric
    cfg = json.load(open(os.path.join(bench, "configs", "tiny-ml25m.json")))
    cfg["name"] = "tiny-b"
    json.dump(cfg, open(os.path.join(bench, "configs", "tiny-b.json"), "w"))
    json.dump({**json.load(open(os.path.join(bench, "traffic", "train.json"))),
               "overrides": {"train": {"batch_size": 512}}},
              open(os.path.join(bench, "traffic", "train.small.json"), "w"))
    shutil.copy(os.path.join(bench, "limits", "tiny.train.json"),
                os.path.join(bench, "limits", "tiny-b.train.small.json"))
    with open(os.path.join(bench, "metrics", "batches_per_s.train.py"), "w") as fh:
        fh.write("def read(r):\n    return r.units / r.window_s\n")
    bm["workloads"].append({"name": "tiny-b.train.small", "config": "tiny-b",
                            "traffic": "train.small", "chips": 1, "why": "new"})
    bm["per_layer"].append({"name": "batches_per_s.train", "unit": "1/s", "better": "higher",
                            "source": "host_clock", "layer": "trainer / engine",
                            "moves": "peak_mem_gib",
                            "workloads": ["tiny.train", "tiny-b.train.small"]})
    json.dump(bm, open(os.path.join(root, "BENCHMARK.json"), "w"))

    cell = spec.load_cell("tiny-b.train.small", root, bench)
    assert cell.config["name"] == "tiny-b" and cell.config["train"]["batch_size"] == 512
    assert [m["name"] for m in cell.per_layer][-1] == "batches_per_s.train"
    # the old cell that the metric names reports it too; the other does not
    assert "batches_per_s.train" in [m["name"] for m in spec.load_cell(
        "tiny.train", root, bench).per_layer]
    assert "batches_per_s.train" not in [m["name"] for m in spec.load_cell(
        "tiny.eval", root, bench).per_layer]
    read = spec.metric_reader("batches_per_s.train", bench)
    assert read(type("R", (), {"units": 10, "window_s": 2.0})()) == 5.0
