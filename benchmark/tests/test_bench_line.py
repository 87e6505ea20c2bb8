"""The result line's keys, and the runs that must give none."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness as H
from benchmark.tests import bench_tiny as B

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_line_keys_end_to_end_and_traced(tmp_path, capsys):
    root = B.copy_checkout(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "garden.json"), "w") as f:
        json.dump(B.tiny_config("garden", n=800, cap=1024, w=48, h=32), f)
    for trace in (False, True):
        line = H.run_cell("garden.view", 5, 0.5, trace, torch.device("cpu"), 0.0, root, bench)
        assert list(line) == (KEYS[:5] + ["breakdown", "checks"] if trace else KEYS)
        assert line["attempted"] >= 1 and line["failed"] == 0
        assert set(line["checks"]) == set(B.limits("garden.view"))
        assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        if trace:
            assert {"busy_s", "window_s"} <= set(line["device"])
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
            assert "mfu.view" in line["metrics"]
        else:
            assert set(line["metrics"]) == {"view_p95_ms", "peak_mem_gib", "setup_s"}
        assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
        assert _line(capsys.readouterr().out) == line


def test_run_without_a_card_exits_nonzero_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = subprocess.run([sys.executable, os.path.join(B.BENCH, "run.py"), "--workload",
                        "garden.view", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=B.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_benchmark_alone_exits_nonzero_with_no_result(tmp_path):
    """In a checkout of BENCHMARK.json and the benchmark's folder only, the
    run fails when it reaches for the measured package."""
    root = B.copy_checkout(str(tmp_path))
    code = ("import sys, time, torch; sys.path[:0] = [%r]; "
            "from benchmark import harness as H; "
            "H.run_cell('garden.view', 1, 0.5, False, torch.device('cpu'), time.perf_counter())"
            % root)
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode != 0 and p.stdout == ""
    assert "splat_one_tpu_torch" in p.stderr
