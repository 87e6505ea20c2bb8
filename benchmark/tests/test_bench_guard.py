"""The import guard, and the reference's independence of the measured
package, compared by whole top-level module names."""

import ast
import os
import sys
import types

import pytest
import torch

from benchmark import harness as H
from benchmark.tests import bench_tiny as B


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub):
    """The Python files under ``benchmark/<sub>``, its camera models too."""
    base = os.path.join(B.BENCH, sub)
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(base) for f in fs
                  if f.endswith(".py"))


def test_reference_imports_nothing_of_the_measured_package():
    files = _files("reference")
    assert any(os.path.basename(f) == "pinhole.py" for f in files)
    for path in files:
        tops = set(_imports(path))
        assert not tops & {"splat_one_tpu_torch", "splat_one_tpu", "jax", "jaxlib", "flax"}, path
        assert tops <= {"__future__", "contextlib", "importlib", "math", "os", "typing",
                        "numpy", "torch", "benchmark"}, path


def test_no_benchmark_file_imports_the_jax_stack():
    files = [os.path.join(d, f) for d, _, fs in os.walk(B.BENCH) for f in fs
             if f.endswith(".py")]
    for path in files:
        assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "splat_one_tpu"}, path


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "splat_one_tpu_torch_like", types.ModuleType("x"))
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert H.forbidden_modules() == ["jax"]
    with pytest.raises(H.Refused, match="jax"):
        H.guard_imports("after the window")


def test_a_run_that_loads_the_jax_package_gives_no_result(monkeypatch, tmp_path, capsys):
    root = B.copy_checkout(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    import json
    with open(os.path.join(bench, "configs", "room.json"), "w") as f:
        json.dump(B.tiny_config("room", n=500, cap=512, w=32, h=32), f)
    monkeypatch.setitem(sys.modules, "splat_one_tpu", types.ModuleType("splat_one_tpu"))
    with pytest.raises(H.Refused, match="splat_one_tpu"):
        H.run_cell("room.view_360", 1, 0.2, False, torch.device("cpu"), 0.0, root, bench)
    assert capsys.readouterr().out == ""
