"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level names compared whole
(the port's name begins with the JAX package's)."""

import ast
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "graph_recsys_benchmark_tpu"}
PROGRAM = "graph_recsys_benchmark_tpu_torch"


def imported(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def strings(path):
    tree = ast.parse(open(path).read(), path)
    return {n.value.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def python_files():
    for d, _, files in os.walk(BENCH):
        if ".cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_imports_jax():
    files = list(python_files())
    assert len(files) > 20
    for path in files:
        assert not imported(path) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    path = os.path.join(BENCH, "pbcore", "reference.py")
    assert imported(path) <= {"__future__", "math", "numpy", "torch"}
    assert PROGRAM not in strings(path)


def test_configs_name_only_the_port():
    import json

    for f in os.listdir(os.path.join(BENCH, "configs")):
        text = json.dumps(json.load(open(os.path.join(BENCH, "configs", f))))
        for word in text.replace('"', " ").split():
            head = word.split(".")[0]
            assert head not in JAX, (f, word)


def test_the_harness_refuses_a_process_holding_jax(monkeypatch):
    import sys
    import types

    from pbcore import runner

    assert runner.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "graph_recsys_benchmark_tpu.graph", types.ModuleType("x"))
    assert "graph_recsys_benchmark_tpu" in runner.forbidden_modules()
    monkeypatch.delitem(sys.modules, "graph_recsys_benchmark_tpu.graph")
    monkeypatch.setitem(sys.modules, PROGRAM + ".graph", types.ModuleType("y"))
    assert "graph_recsys_benchmark_tpu" not in runner.forbidden_modules()
