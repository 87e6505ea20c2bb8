"""The harness finds every configuration, model, traffic mix, kind,
camera model, per-layer metric and limit by name, and a configuration, a
metric, a model, a kind and a camera model added as files only run with
no edit."""

import hashlib
import json
import os

import pytest
import torch

from benchmark import harness as H
from benchmark.tests import bench_tiny as B


def test_every_cell_finds_its_files():
    spec = H.load_spec()
    assert [w["name"] for w in spec["workloads"]] == ["garden.view", "room.view_360"]
    for w in spec["workloads"]:
        cell, cfg, mix, limits = H.cell_files(spec, w["name"])
        assert cfg["name"] == w["config"] and limits
        for sub, name in (("kinds", mix["kind"]), ("models", H.model_name(cfg)),
                          ("reference/cameras", mix["camera_model"])):
            assert os.path.exists(os.path.join(B.BENCH, sub, name + ".py")), (sub, name)
        assert callable(H.load_kind(mix["kind"]).run)
        assert callable(H.load_model(cfg).make_weights)
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
    # the first request is the one checked: it falls in any window
    with open(os.path.join(bench, "traffic", "tiny_view.json"), "w") as f:
        json.dump(B.mix("view", expect_requests=1, check_requests=2), f)
    with open(os.path.join(bench, "metrics", "requests_traced.view.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.units)\n")
    with open(os.path.join(bench, "limits", "tiny.view.json"), "w") as f:
        json.dump({"frame_mae": 1.0, "rgb_mae": 1e-3, "alpha_mae": 1e-3, "depth_rel": 1e-3}, f)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny", "source": "a test", "reduced": [], "why": "a test",
                            "file": "benchmark/configs/tiny.json"})
    spec["workloads"].append({"name": "tiny.view", "config": "tiny", "traffic": "tiny_view",
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


RGB_MODEL = '''"""Gaussians with plain colours: the port serves sigmoid(colors)."""
import torch

from benchmark.models import gaussians as G
from benchmark.reference import render as R

OPS_PER_GAUSSIAN = G.OPS_PER_GAUSSIAN - 14 - 35 - 102  # no view direction, no SH
BYTES_PER_GAUSSIAN = 12 + 16 + 12 + 4 + 12


def make_weights(cfg, seed, dev):
    w, alive = G.make_weights(cfg, seed, dev)
    rgb = w.pop("sh0")[:, 0] * G.SH_C0 + 0.5
    del w["shN"]
    w["colors"] = torch.logit(rgb)
    return w, alive


def program(weights, alive, cfg, mix, dev):
    from splat_one_tpu_torch.app.viewer import Renderer

    return Renderer(weights, alive, cfg["width"], cfg["height"],
                    camera_model=mix["camera_model"], device=dev)


def reference_rows(weights, alive):
    live = {k: v[alive] for k, v in weights.items()}
    return dict(R.activate(live), colors=torch.sigmoid(live["colors"]))


def color(rows, front, dirs, dtype):
    return rows["colors"].to(dtype)[front]
'''

ORTHO_CAMERA = '''"""The orthographic camera: fx and fy pixels a unit, no division."""
import torch

WRAP = False


def depth(x, y, z):
    return z


def screen(x, y, z, fx, fy, cx, cy, width, height):
    return fx * x + cx, fy * y + cy


def jacobian(x, y, z, fx, fy, width, height):
    zero = torch.zeros_like(x)
    return torch.stack([zero + fx, zero, zero, zero, zero + fy, zero], -1).reshape(-1, 2, 3)
'''

# a kind of its own that runs the view kind of the same folder
RELAY_KIND = '''import os

from benchmark import harness


def run(*args):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return harness.load_kind("view", here).run(*args)
'''

NEEDED_PAIRS = '''def read(ctx):
    rows = ctx.work()["rows"]
    return sum(r["pairs"] for r in rows) / len(rows)
'''


def _digests(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            if "__pycache__" not in d:
                path = os.path.join(d, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_model_kind_and_camera_added_as_files_only(tmp_path, capsys):
    """A cell of a model with plain colours, seen by an orthographic camera,
    run by a kind of its own: new files and appended entries, nothing
    else, and the line reads correct."""
    root = B.copy_checkout(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    before = _digests(root)
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec0 = json.load(f)
    cfg = B.tiny_config("garden", n=600, cap=1024, w=48, h=32)
    cfg.update(name="tiny_rgb", model="rgb", focal_px=6.0)
    files = {"configs/tiny_rgb.json": json.dumps(cfg),
             "models/rgb.py": RGB_MODEL,
             "reference/cameras/ortho.py": ORTHO_CAMERA,
             "kinds/relay.py": RELAY_KIND,
             "traffic/ortho.json": json.dumps(B.mix("view", kind="relay", camera_model="ortho",
                                                    expect_requests=1, check_requests=2)),
             "metrics/needed_pairs.ortho.py": NEEDED_PAIRS,
             "limits/tiny_rgb.ortho.json": json.dumps(B.limits("garden.view"))}
    for rel, text in files.items():
        with open(os.path.join(bench, rel), "w") as f:
            f.write(text)
    spec = json.loads(json.dumps(spec0))
    spec["configs"].append({"name": "tiny_rgb", "source": "a test", "reduced": [],
                            "why": "a test", "file": "benchmark/configs/tiny_rgb.json"})
    spec["workloads"].append({"name": "tiny_rgb.ortho", "config": "tiny_rgb",
                              "traffic": "ortho", "chips": 1, "why": "a test"})
    next(m for m in spec["end_to_end"] if m["name"] == "view_p95_ms")["workloads"].append(
        "tiny_rgb.ortho")
    spec["per_layer"].append({"name": "needed_pairs.ortho", "unit": "pairs/req",
                              "better": "lower", "source": "program_counter",
                              "layer": "kernels", "moves": "view_p95_ms",
                              "workloads": ["tiny_rgb.ortho"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    for trace in (False, True):
        line = H.run_cell("tiny_rgb.ortho", 2147483651, 0.5, trace, torch.device("cpu"), 0.0,
                          root, bench)
        assert line["correct"] is True, line["checks"]
        assert line["failed"] == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert set(line["metrics"]) == {"needed_pairs.ortho"}
    assert line["metrics"]["needed_pairs.ortho"]["value"] > 1000  # the frame is not empty
    # every file that was there is as it was, but BENCHMARK.json, which
    # holds the original entries and the appended ones
    after = _digests(root)
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) == {"benchmark/" + k for k in files}
    with open(spec_path) as f:
        spec1 = json.load(f)
    assert spec1["configs"][:-1] == spec0["configs"]
    assert spec1["workloads"][:-1] == spec0["workloads"]
    assert spec1["per_layer"][:-1] == spec0["per_layer"]
    for m0, m1 in zip(spec0["end_to_end"], spec1["end_to_end"], strict=True):
        if m0["name"] == "view_p95_ms":
            assert m1["workloads"][:-1] == m0["workloads"]
            m1 = dict(m1, workloads=m0["workloads"])
        assert m1 == m0
    assert {k: v for k, v in spec1.items() if k not in ("configs", "workloads", "per_layer",
                                                         "end_to_end")} == \
        {k: v for k, v in spec0.items() if k not in ("configs", "workloads", "per_layer",
                                                     "end_to_end")}


def test_unknown_workload_is_refused():
    with pytest.raises(H.Refused):
        H.cell_files(H.load_spec(), "nowhere.view")
