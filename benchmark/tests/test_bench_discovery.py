"""The harness finds every configuration, traffic mix, per-layer metric
and limit by name, and a configuration and a metric added as files only
run with no edit."""

import json
import os

import pytest
import torch

from benchmark import drivers as D
from benchmark import harness as H
from benchmark.tests import bench_tiny as B


def test_every_cell_finds_its_files():
    spec = H.load_spec()
    assert [w["name"] for w in spec["workloads"]] == ["garden.view", "room.view_360"]
    for w in spec["workloads"]:
        cell, cfg, mix, limits = H.cell_files(spec, w["name"])
        assert cfg["name"] == w["config"] and mix["kind"] in D.KINDS and limits
        assert {c["name"] for c in spec["configs"]} >= {w["config"]}
        names = [m["name"] for m in H.end_to_end_for(spec, w["name"])]
        assert "setup_s" in names and len(names) >= 2
        layer = H.per_layer_for(spec, w["name"])
        assert layer
        for m in layer:
            assert callable(H.load_metric(m["name"]).read)


def test_per_layer_without_workloads_follows_its_moved_metric():
    spec = {"end_to_end": [{"name": "a", "workloads": ["x"]}, {"name": "setup_s"}],
            "per_layer": [{"name": "m1", "moves": "a"}, {"name": "m2", "moves": "b"},
                          {"name": "m3", "moves": "b", "workloads": ["x"]}]}
    assert [m["name"] for m in H.per_layer_for(spec, "x")] == ["m1", "m3"]
    assert H.per_layer_for(spec, "y") == []


def test_config_and_metric_added_as_files_only(tmp_path, capsys):
    root = B.copy_checkout(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(B.tiny_config("room", n=600, cap=1024, w=48, h=32), f)
    with open(os.path.join(bench, "metrics", "requests_traced.view.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.units)\n")
    with open(os.path.join(bench, "limits", "tiny.view.json"), "w") as f:
        json.dump({"frame_mae": 1.0, "rgb_mae": 1e-3, "alpha_mae": 1e-3, "depth_rel": 1e-3}, f)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny", "source": "a test", "reduced": [], "why": "a test",
                            "file": "benchmark/configs/tiny.json"})
    spec["workloads"].append({"name": "tiny.view", "config": "tiny", "traffic": "view",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "requests_traced.view", "unit": "requests",
                              "better": "higher", "source": "program_counter",
                              "layer": "entry", "moves": "view_p95_ms",
                              "workloads": ["tiny.view"]})
    next(m for m in spec["end_to_end"] if m["name"] == "view_p95_ms")["workloads"].append(
        "tiny.view")
    # a metric with no file of its own is read by its stem's shared reader
    spec["per_layer"].append({"name": "mfu.tiny", "unit": "%", "better": "higher",
                              "source": "host_clock", "layer": "whole request",
                              "moves": "view_p95_ms", "workloads": ["tiny.view"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    line = H.run_cell("tiny.view", 3, 0.5, True, torch.device("cpu"), 0.0, root, bench)
    assert line["metrics"]["requests_traced.view"]["value"] == 8.0
    assert line["metrics"]["mfu.tiny"]["value"] > 0
    assert line["correct"] is True
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line


def test_unknown_workload_is_refused():
    with pytest.raises(H.Refused):
        H.cell_files(H.load_spec(), "nowhere.view")
