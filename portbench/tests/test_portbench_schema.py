"""The result line at a tiny size on the CPU: its keys, the metrics each
cell reports, the checks last, and ``correct`` true on a sound run."""

import json

import pytest

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,trace", [("tiny.train", False), ("tiny.eval", False),
                                        ("tiny.train", True), ("tiny.eval", True)])
def test_result_line(run_tiny, cell, trace, capsys):
    from pbcore import runner

    result = run_tiny(cell, seconds=1.5, trace=trace)
    runner.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    dev = line["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert isinstance(m["value"], float) and m["unit"]
    kind = cell.split(".")[1]
    if trace:
        assert set(dev) >= {"busy_s", "window_s"} and "breakdown" in line
        assert f"host_issue_ms.{kind}" in line["metrics"]
        # the ML-25M cells' throughput, read per layer in the traced run
        assert (("train_examples_per_s.ml25m" if kind == "train" else "eval_users_per_s.ml25m")
                in line["metrics"])
        # no device operation on the CPU: the device readers find nothing
        assert f"device_idle.{kind}" not in line["metrics"]
    else:
        # no throughput end to end (PERF.md): set-up, and peak memory on a card
        assert "setup_s" in line["metrics"]
        assert set(line["metrics"]) <= {"setup_s", "peak_mem_gib"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)
