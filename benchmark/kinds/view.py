"""The ``view`` kind: one viewer client in a closed loop, no think time,
calling the configuration's model's entry (``models/<model>.py``'s
``program``: a uint8 frame on the host) with the mix's ``camera_model``;
the 95th percentile of the requests' latencies is reported as ``metric``.

The client cycles through a list of ``poses`` that is the same for every
seed (``path: orbit`` walks the capture's orbit with smooth wobbles in
radius, height and aim; ``path: inside`` stands at jittered grid points of
the configuration's ``interior`` box with stratified yaw); the seed picks
where in the list it starts, the model's row order and the checked
requests. The reference renders each checked request again with the
camera model ``reference/cameras/<camera_model>.py`` and the model's own
rows and colour.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from benchmark import drivers as D
from benchmark import harness
from benchmark import scene as S
from benchmark import trace as T
from benchmark.reference import render as R

# the benchmark folder this file is in: a cell's model and camera files are
# looked up beside it
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def view_poses(cfg: dict, mix: dict, seed: int):
    """The client's pose list (c2w [P, 4, 4]): the same poses for every
    seed, from a start that the seed picks."""
    rng = S.np_rng(S.LAYOUT_SEED, 5)
    P = int(mix["poses"])
    out = []
    if mix["path"] == "orbit":
        cam = cfg["cameras"]
        phase = rng.uniform(0, 2 * math.pi)
        ph = rng.uniform(0, 2 * math.pi, 4)
        wr, wh, wt = mix["radius_wobble"], mix["height_wobble"], mix["target_wobble"]
        for k in range(P):
            a = phase + 2 * math.pi * k / P
            out.append(S.orbit_pose(cam, a, wr * math.sin(2 * a + ph[0]),
                                    wh * math.sin(3 * a + ph[1]),
                                    (wt * math.sin(a + ph[2]), 0.0, wt * math.cos(a + ph[3]))))
    elif mix["path"] == "inside":
        box = cfg["interior"]
        lo, hi = np.array(box["min"]), np.array(box["max"])
        side = int(math.ceil(P ** 0.5))
        cells = rng.permutation(side * side)[:P]
        for j, c in enumerate(cells):
            fx = (c % side + rng.uniform()) / side
            fz = (c // side + rng.uniform()) / side
            eye = lo + np.array([fx, rng.uniform(), fz]) * (hi - lo)
            yaw = 2 * math.pi * (j + rng.uniform()) / P
            out.append(S.yaw_pose(eye, yaw, rng.uniform(-0.2, 0.2)))
    else:
        raise ValueError(f"unknown path {mix['path']!r}")
    start = int(S.np_rng(seed, 5).integers(0, P))
    return np.roll(np.stack(out).astype(np.float32), -start, axis=0)


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, dev,
        setup_clock: Callable[[], float]) -> dict:
    su = setup(cfg, mix, seed, dev, [])
    weights, alive = su.model.make_weights(cfg, seed, dev)
    camera_model = mix["camera_model"]
    W, H = int(cfg["width"]), int(cfg["height"])
    rd = su.model.program(weights, alive, cfg, mix, dev)
    del weights
    poses = view_poses(cfg, mix, seed)
    K = su.K
    P = len(poses)
    for i in range(int(mix["warmup"])):
        rd(poses[(P // 2 + i) % P], K, camera_model)
    D._sync(dev)
    rng = S.np_rng(seed, 6)
    keep = {int(rng.integers(0, 32))}
    keep |= {int(x) for x in rng.integers(0, int(mix["expect_requests"]),
                                          int(mix["check_requests"]) - 1)}
    frames, lat, failed = {}, [], 0
    setup_s = setup_clock()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    i = 0
    while time.perf_counter() < t_end:
        ta = time.perf_counter()
        try:
            f = rd(poses[i % P], K, camera_model)
        except RuntimeError:
            failed += 1
            f = None
        lat.append(time.perf_counter() - ta)
        if i in keep and f is not None:
            frames[i] = f
        i += 1
    wall = time.perf_counter() - t0
    lat_ms = np.asarray(lat) * 1e3
    out = dict(setup_s=setup_s, attempted=i, failed=failed, units=i,
               values={mix["metric"]: float(np.percentile(lat_ms, 95))})
    out["peak_bytes"] = D._peak(dev)
    if trace:
        units = int(mix["trace_units"])
        j0 = i

        def traced():
            for j in range(j0, j0 + units):
                rd(poses[j % P], K, camera_model)
            D._sync(dev)

        out["trace"] = T.capture(traced)
        out["units"] = units
        out["unit_s"] = wall / i
        traced_poses = [poses[j % P] for j in range(j0, j0 + units)]
    # the program's float outputs at the checked requests' poses, through
    # the same entry, before its state is freed
    prog = {}
    for r in sorted(frames):
        rgb, ed, a, _ = rd.render(poses[r % P], K, camera_model)
        prog[r] = (rgb.clone(), ed.clone(), a.clone())
    del rd
    D._free()

    su = su._replace(poses=[poses[r % P] for r in sorted(frames)])

    def work():
        act = view_rows(su)
        rows = []
        for pose in traced_poses:
            r = R.render(act, pose, K, W, H, su.camera, su.model.color)
            rows.append(dict(pairs=r.needed, visible=r.visible))
        return dict(rows=rows, n_alive=int(cfg["n_gaussians"]), pixels=W * H)

    def check():
        got = [(frames[r], *prog[r]) for r in sorted(frames)]
        return D.compare_view(got, reference_view(su))

    out["check"] = check
    out["work"] = work
    return out


class ViewSetup(NamedTuple):
    cfg: dict
    mix: dict
    seed: int
    dev: torch.device
    K: np.ndarray
    poses: list  # of the checked requests
    model: object  # the configuration's models/<model>.py
    camera: object  # the mix's reference/cameras/<camera_model>.py


def setup(cfg: dict, mix: dict, seed: int, dev, poses: list) -> ViewSetup:
    """The model and camera files of a cell, and what the reference needs
    to render the checked requests again."""
    camera = R.camera(mix["camera_model"], os.path.join(BENCH, "reference", "cameras"))
    return ViewSetup(cfg, mix, seed, dev, S.intrinsics(cfg), poses,
                     harness.load_model(cfg, BENCH), camera)


def view_rows(su: ViewSetup):
    """The live gaussians of the seed's weights, in their buffer order."""
    w, alive = su.model.make_weights(su.cfg, su.seed, su.dev)
    return su.model.reference_rows(w, alive)


def reference_view(su: ViewSetup, precision: str = "f32"):
    """The reference's render of each checked request's pose."""
    act = view_rows(su)
    out = []
    with R.precision(precision) as dtype:
        for pose in su.poses:
            out.append(R.render(act, pose, su.K, int(su.cfg["width"]), int(su.cfg["height"]),
                                su.camera, su.model.color, dtype=dtype))
    return out


def control_readings(cfg: dict, mix: dict, seed: int, dev, precisions) -> dict:
    """The compared numbers of the reference in the program's place at each
    lower precision, and of the fault that answers each request with the
    one before it, over the mix's checked number of requests."""
    poses = view_poses(cfg, mix, seed)[: int(mix["check_requests"])]
    su = setup(cfg, mix, seed, dev, list(poses))
    ref = reference_view(su)
    out = {p: D.compare_view([D.as_answer(r) for r in reference_view(su, p)], ref)
           for p in precisions}
    stale = [D.as_answer(ref[(i - 1) % len(ref)]) for i in range(len(ref))]
    out["stale_answer"] = D.compare_view(stale, ref)
    return out
