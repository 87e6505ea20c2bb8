"""Tiny stand-ins of the benchmark's cells for the CPU tests."""

import json
import math
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def tiny_config(name: str, n: int = 1500, cap: int = 2048, w: int = 64, h: int = 48) -> dict:
    """A configuration's scene at a size the CPU holds: the same layout,
    fewer and larger gaussians, a smaller image and focal length."""
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    k = (cfg["n_gaussians"] / n) ** 0.5
    for r in cfg["scene"]["regions"]:
        r["log_scale"] = [r["log_scale"][0] + math.log(k),
                          *r["log_scale"][1:]]
    cfg.update(n_gaussians=n, capacity=cap, width=w, height=h,
               focal_px=cfg["focal_px"] * w / cfg["width"])
    return cfg


def mix(name: str, **over) -> dict:
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        d = json.load(f)
    d.update(over)
    return d


def limits(cell: str) -> dict:
    with open(os.path.join(BENCH, "limits", cell + ".json")) as f:
        return json.load(f)


def copy_checkout(dst: str) -> str:
    """BENCHMARK.json and the benchmark's folder under ``dst``."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst
