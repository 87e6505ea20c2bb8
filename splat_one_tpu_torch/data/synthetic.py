"""Synthetic scenes for tests and benchmarks (camera rigs and GT gaussians).

Counterpart of ``splat_one_tpu/data/synthetic.py``: ``look_at``,
``ring_cameras`` and ``make_gt_gaussians`` are numpy-only and identical.
``make_synthetic_scene`` (which renders ground-truth images and builds a
trainer's SceneData) comes with the training slice.
"""

from __future__ import annotations

import numpy as np


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)):
    """c2w with +z forward (OpenCV convention, y down)."""
    f = target - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, np.float64)
    r = np.cross(f, up)
    r = r / (np.linalg.norm(r) + 1e-12)
    d = np.cross(f, r)
    R = np.stack([r, d, f], axis=1)  # columns: right, down, forward
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = R
    c2w[:3, 3] = eye
    return c2w


def ring_cameras(n: int, radius: float, height: float, fov_deg: float,
                 width: int, height_px: int):
    c2ws, Ks = [], []
    f = 0.5 * width / np.tan(np.radians(fov_deg) / 2)
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = np.array(
            [radius * np.cos(a), height, radius * np.sin(a)], np.float64
        )
        c2ws.append(look_at(eye, np.zeros(3)))
        Ks.append(
            np.array(
                [[f, 0, width / 2], [0, f, height_px / 2], [0, 0, 1]],
                np.float32,
            )
        )
    return np.stack(c2ws), np.stack(Ks)


def make_gt_gaussians(n: int, seed: int = 0, extent: float = 1.0,
                      surface: bool = False):
    """Random GT gaussians. Two regimes:

    - volumetric (default): semi-transparent blobs filling a sphere
      volume. Good for stressing the rasterizer, but NOT identifiable
      from a few dozen views — many volumetric configurations reproduce
      the training images exactly (measured r5: a 12k-step fit reached
      train-view PSNR 31 while held-out views rendered fog at 10.6), so
      held-out PSNR does not measure trainer quality on it.
    - surface: near-opaque splats on a bumpy sphere SHELL with smooth
      position-dependent color — the opaque-surface regime real scenes
      (and the reference's Mip-NeRF-style evals) live in, where
      multi-view photometric consistency pins the geometry and held-out
      views are predictive."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if surface:
        # bumpy shell: radius field varies smoothly with direction
        bump = (0.12 * np.sin(3.0 * d[:, 0:1] * np.pi)
                * np.cos(2.0 * d[:, 1:2] * np.pi)
                + 0.08 * np.sin(4.0 * d[:, 2:3] * np.pi))
        r = extent * (0.8 + bump + rng.normal(0, 0.004, (n, 1)))
        means = (d * r).astype(np.float32)
        quats = rng.normal(size=(n, 4)).astype(np.float32)
        scales = np.exp(rng.uniform(-4.6, -3.9, (n, 3))).astype(
            np.float32) * extent
        opac = rng.uniform(0.85, 0.99, n).astype(np.float32)
        # smooth color field + texture noise: neighboring views see
        # consistent, interpolatable appearance
        rgb = np.stack(
            [
                0.5 + 0.35 * np.sin(2.5 * np.pi * means[:, 0] / extent),
                0.5 + 0.35 * np.cos(2.0 * np.pi * means[:, 1] / extent),
                0.5 + 0.35 * np.sin(1.5 * np.pi * means[:, 2] / extent
                                    + 1.0),
            ],
            axis=1,
        ) + rng.normal(0, 0.05, (n, 3))
        rgb = np.clip(rgb, 0.05, 0.95).astype(np.float32)
        return means, quats, scales, opac, rgb
    # clustered blobs on a sphere surface + volume fill
    r = extent * np.abs(rng.normal(0.7, 0.25, (n, 1)))
    means = (d * r).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-4.2, -3.0, (n, 3))).astype(np.float32) * extent
    opac = rng.uniform(0.4, 0.95, n).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    return means, quats, scales, opac, rgb
