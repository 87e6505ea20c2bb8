"""Finds a cell's files by name and turns one run into its result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found from the names in ``BENCHMARK.json``
and in those files; a cell is added with new files and new entries alone:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- its model: ``models/<model>.py`` for the configuration's key ``model``
  (``gaussians``, 3DGS with SH 3, where there is none): ``make_weights``,
  ``program``, ``reference_rows``, ``color``, ``OPS_PER_GAUSSIAN`` and
  ``BYTES_PER_GAUSSIAN`` (``models/gaussians.py`` says what each is);
- a traffic mix: ``traffic/<traffic>.json``, the parameters of its kind;
- a traffic kind: ``kinds/<kind>.py`` for the mix's ``kind``, whose
  ``run`` keeps the contract in ``drivers``;
- a camera model, for a mix that names a ``camera_model``:
  ``reference/cameras/<camera_model>.py`` (``reference/cameras/pinhole.py``
  says what it gives);
- a per-layer metric: ``metrics/<name>.py`` with ``read(ctx)`` returning a
  number or None (nothing to read: the metric is left out of the line), or,
  where there is no such file, the shared reader ``metrics/<stem>.py`` of
  the name's part before its first dot (``idle_share.view360`` is read by
  ``idle_share.py``);
- a cell's limits: ``limits/<cell>.json``, each compared number's limit.

A run prints each compared number beside its limit as its last lines on
standard error, and one JSON object as its last line on standard output.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "splat_one_tpu")
DEFAULT_MODEL = "gaussians"


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden import, ...)."""


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(spec: dict, cell_name: str, root: str = ROOT, bench: str = HERE):
    """(cell, configuration, mix, limits) of a cell, by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise Refused(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = _json(os.path.join(root, conf["file"]))
    mix = _json(os.path.join(bench, "traffic", cell["traffic"] + ".json"))
    limits = _json(os.path.join(bench, "limits", cell_name + ".json"))
    return cell, cfg, mix, limits


def end_to_end_for(spec: dict, cell_name: str) -> List[dict]:
    return [m for m in spec["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer_for(spec: dict, cell_name: str) -> List[dict]:
    mine = {m["name"] for m in end_to_end_for(spec, cell_name)}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def _module(sub: str, name: str, bench: str):
    """``<bench>/<sub>/<name>.py``, loaded; Refused where there is none."""
    path = os.path.join(bench, sub, name + ".py")
    if not os.path.exists(path):
        raise Refused(f"no {sub}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{sub}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, bench: str = HERE):
    if os.path.exists(os.path.join(bench, "metrics", name + ".py")):
        return _module("metrics", name, bench)
    return _module("metrics", name.split(".")[0], bench)


def load_kind(name: str, bench: str = HERE):
    return _module("kinds", name, bench)


def model_name(cfg: dict) -> str:
    return cfg.get("model", DEFAULT_MODEL)


def load_model(cfg: dict, bench: str = HERE):
    return _module("models", model_name(cfg), bench)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is the JAX stack or the JAX
    package (compared whole: the measured package's name begins with it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def guard_imports(where: str):
    found = forbidden_modules()
    if found:
        raise Refused(f"{where}: loaded {', '.join(found)}")


class Context:
    """What a per-layer reader reads: the trace, the units of work it
    covers, the untraced window's time per unit, the counted work and the
    configuration's model file (its work per gaussian)."""

    def __init__(self, cell: dict, cfg: dict, mix: dict, outcome: dict, model):
        self.cell, self.cfg, self.mix, self.model = cell, cfg, mix, model
        self.trace = outcome.get("trace")
        self.units = outcome.get("units", 0)
        self.unit_s = outcome.get("unit_s")
        self._work_fn = outcome.get("work")
        self._work = None

    def work(self) -> dict:
        if self._work is None:
            self._work = self._work_fn()
        return self._work


def read_per_layer(metrics: List[dict], ctx: Context, bench: str = HERE) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = load_metric(m["name"], bench).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {value, limit}}): every number at or under its limit."""
    missing = set(limits) - set(numbers)
    if missing:
        raise Refused(f"the check gave no {sorted(missing)}")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def result_line(correct: bool, outcome: dict, metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict], breakdown: Optional[dict] = None) -> str:
    line = {"correct": bool(correct), "attempted": int(outcome["attempted"]),
            "failed": int(outcome["failed"]), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, dev, t0: float,
             root: str = ROOT, bench: str = HERE) -> dict:
    """One run of a cell on ``dev`` (the caller has looked for the card):
    the window, then the per-layer or end-to-end metrics, then the check.
    Prints each compared number beside its limit on standard error and the
    result line on standard output, and returns the line."""
    import torch

    from benchmark import trace as T

    spec = load_spec(root)
    cell, cfg, mix, limits = cell_files(spec, workload, root, bench)
    kind, model = load_kind(mix["kind"], bench), load_model(cfg, bench)
    tf32 = bool(cfg.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)  # the context, before the peak is reset
        torch.cuda.reset_peak_memory_stats(dev)

    def setup_clock():
        guard_imports("after set-up")
        return time.perf_counter() - t0

    out = kind.run(cfg, mix, seed, seconds, trace, dev, setup_clock)
    guard_imports("after the window")
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": int(cell["chips"]), "memory_peak_bytes": int(out["peak_bytes"])}
    breakdown = None
    if trace:
        tr = out["trace"]
        device["busy_s"] = T.busy_us(tr) * 1e-6
        device["window_s"] = T.window_us(tr) * 1e-6
        breakdown = {"device_ops": T.top_device_ops(tr), "idle_gaps": T.idle_gaps(tr)}
        ctx = Context(cell, cfg, mix, out, model)
        metrics = read_per_layer(per_layer_for(spec, workload), ctx, bench)
    else:
        values = dict(out["values"], setup_s=out["setup_s"],
                      peak_mem_gib=out["peak_bytes"] / 2 ** 30)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in end_to_end_for(spec, workload)}
    numbers = out["check"]()
    correct, checks = judge(numbers, limits)
    correct = correct and out["failed"] == 0
    for k in sorted(set(numbers) - set(limits)):
        print(f"note {k} {numbers[k]!r}", file=sys.stderr)
    print(f"attempted {out['attempted']} failed {out['failed']}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    line = result_line(correct, out, metrics, device, checks, breakdown)
    print(line, flush=True)
    return json.loads(line)
