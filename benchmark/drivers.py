"""What every traffic kind shares: the contract of a kind, the device
helpers, and the comparison of a rendered answer with the reference's.

A mix (``traffic/<name>.json``) names its ``kind`` and its parameters; the
harness runs ``kinds/<kind>.py``'s

    run(cfg, mix, seed, seconds, trace, dev, setup_clock) -> dict

It makes the configuration's model from the seed (``models/<model>.py``),
warms up every shape its traffic uses, calls ``setup_clock()`` once
set-up is done, measures for ``seconds`` and returns a dict:
``setup_s``, ``values`` (the end-to-end metrics it measures),
``attempted``, ``failed``, ``peak_bytes``, a ``check`` that runs the
reference once the program is freed and returns the compared numbers,
and in a traced run the ``trace``, its ``units`` of work, the untraced
window's seconds a unit (``unit_s``) and a ``work`` counter for the
per-layer readers. A kind that the control can stand in for also gives
``control_readings(cfg, mix, seed, dev, precisions) -> dict``
(``control.py``).
"""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np
import torch

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
