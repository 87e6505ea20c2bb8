"""The one traffic generator: drives the measured package as a mix file
says.

A mix (``traffic/<name>.json``) names its ``kind`` and its parameters.
``view``: one viewer client in a closed loop, no think time, calling
``Renderer.__call__`` (uint8 frame on the host) with ``camera_model``; the
95th percentile of the requests' latencies is reported as ``metric``. The
client cycles through a list of ``poses`` that is the same for every seed
(``path: orbit`` walks the capture's orbit with smooth wobbles in radius,
height and aim; ``path: inside`` stands at jittered grid points of the
configuration's ``interior`` box with stratified yaw); the seed picks
where in the list it starts, the scene's gaussians and the checked
requests.

The driver returns a dict: ``setup_s``, ``values`` (the end-to-end
metrics it measures), ``attempted``, ``failed``, ``peak_bytes``, a
``check`` that runs the reference once the program is freed, and in a
traced run the ``trace``, its ``units`` of work, the untraced window's
seconds a unit (``unit_s``) and a ``work`` counter for the per-layer
readers.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from benchmark import scene as S
from benchmark import trace as T
from benchmark.reference import render as R


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- view
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


def run_view(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, dev,
             setup_clock: Callable[[], float]) -> dict:
    from splat_one_tpu_torch.app.viewer import Renderer

    weights, alive = S.make_weights(cfg, seed, dev)
    model = mix["camera_model"]
    W, H = int(cfg["width"]), int(cfg["height"])
    rd = Renderer(weights, alive, W, H, sh_degree=int(cfg["sh_degree"]),
                  camera_model=model, device=dev)
    del weights
    poses = view_poses(cfg, mix, seed)
    K = S.intrinsics(cfg)
    P = len(poses)
    for i in range(int(mix["warmup"])):
        rd(poses[(P // 2 + i) % P], K, model)
    _sync(dev)
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
            f = rd(poses[i % P], K, model)
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
    out["peak_bytes"] = _peak(dev)
    if trace:
        units = int(mix["trace_units"])
        j0 = i

        def traced():
            for j in range(j0, j0 + units):
                rd(poses[j % P], K, model)
            _sync(dev)

        out["trace"] = T.capture(traced)
        out["units"] = units
        out["unit_s"] = wall / i
        traced_poses = [poses[j % P] for j in range(j0, j0 + units)]
    # the program's float outputs at the checked requests' poses, through
    # the same entry, before its state is freed
    prog = {}
    for r in sorted(frames):
        rgb, ed, a, _ = rd.render(poses[r % P], K, model)
        prog[r] = (rgb.clone(), ed.clone(), a.clone())
    del rd
    _free()

    su = ViewSetup(cfg, mix, seed, dev, K, [poses[r % P] for r in sorted(frames)])

    def work():
        act = view_rows(su)
        rows = []
        for pose in traced_poses:
            r = R.render(act, pose, K, W, H, model)
            rows.append(dict(pairs=r.needed, visible=r.visible))
        return dict(rows=rows, n_alive=int(cfg["n_gaussians"]), pixels=W * H)

    def check():
        got = [(frames[r], *prog[r]) for r in sorted(frames)]
        return compare_view(got, reference_view(su))

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


def view_rows(su: ViewSetup):
    """The live gaussians of the seed's weights, in their buffer order."""
    w, alive = S.make_weights(su.cfg, su.seed, su.dev)
    return R.activate({k: v[alive] for k, v in w.items()})


def reference_view(su: ViewSetup, precision: str = "f32"):
    """The reference's render of each checked request's pose."""
    act = view_rows(su)
    out = []
    with R.precision(precision) as dtype:
        for pose in su.poses:
            out.append(R.render(act, pose, su.K, int(su.cfg["width"]), int(su.cfg["height"]),
                                su.mix["camera_model"], dtype=dtype))
    return out


def as_answer(r: R.Render) -> tuple:
    """A reference render in the program's place: (frame, rgb, ed, alpha)."""
    return frame_of(r.rgb), r.rgb, r.depth, r.alpha


def frame_of(rgb: torch.Tensor) -> np.ndarray:
    """The viewer's uint8 frame of a float rgb image."""
    return (torch.clamp(rgb.float(), 0, 1) * 255).to(torch.uint8).cpu().numpy()


def _worst(xs) -> float:
    """The largest, or NaN where any is NaN (a NaN must fail the check)."""
    xs = [float(x) for x in xs]
    return float("nan") if any(np.isnan(xs)) else max(xs)


def compare_view(got: list, refs: list) -> Dict[str, float]:
    """The worst over the checked requests of each number (NaN, which
    fails, where no request was checked)."""
    worst = {k: 0.0 if got else float("nan")
             for k in ("frame_mae", "rgb_mae", "alpha_mae", "depth_rel")}
    for g, ref in zip(got, refs):
        one = compare_request(*g, ref)
        worst = {k: _worst([worst[k], one[k]]) for k in worst}
    return worst


def compare_request(frame, rgb, ed, alpha, ref) -> Dict[str, float]:
    """The compared numbers of one request:

    - ``frame_mae``: mean |frame - reference frame| in uint8 levels, over
      the frame the window served;
    - ``rgb_mae``, ``alpha_mae``: mean absolute error of the float outputs;
    - ``depth_rel``: mean |ED - reference| over pixels with reference alpha
      above 0.5, over the mean reference ED there."""
    fr = frame_of(ref.rgb).astype(np.int16)
    frame_mae = float(np.mean(np.abs(frame.astype(np.int16) - fr)))
    rgb_mae = float(torch.mean(torch.abs(rgb.float() - ref.rgb.float())))
    alpha_mae = float(torch.mean(torch.abs(alpha.float() - ref.alpha.float())))
    m = ref.alpha.float() > 0.5
    if bool(m.any()):
        d = torch.abs(ed.float() - ref.depth.float())[m]
        depth_rel = float(d.mean() / ref.depth.float()[m].mean())
    else:
        depth_rel = 0.0
    return {"frame_mae": frame_mae, "rgb_mae": rgb_mae, "alpha_mae": alpha_mae,
            "depth_rel": depth_rel}


KINDS = {"view": run_view}
