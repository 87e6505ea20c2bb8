"""Synthetic scenes for tests and benchmarks.

Counterpart of ``splat_one_tpu/data/synthetic.py``: ``look_at``,
``ring_cameras`` and ``make_gt_gaussians`` are numpy-only and identical;
``make_synthetic_scene`` renders ground-truth images of a known gaussian
scene through the port's gen-1 ``impl="tiled"`` rasterizer, as the JAX
package does, and returns the port's ``SceneData``.
"""

from __future__ import annotations

import numpy as np
import torch

from splat_one_tpu_torch.core.sh import rgb_to_sh
from splat_one_tpu_torch.core.transforms import invert_se3
from splat_one_tpu_torch.ops.intersect import IsectCaps
from splat_one_tpu_torch.render.rasterization import rasterization
from splat_one_tpu_torch.utils.device import resolve as resolve_device


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


def _surface_cameras(n_cameras: int, width: int, height: int, seed: int):
    """Three interleaved rings at different heights and radii, each camera
    jittered in radius and height and re-aimed at the origin (see
    ``splat_one_tpu/data/synthetic.py``: a single ring leaves a blind
    region in front of every camera where training parks floaters)."""
    rings = [(3.0, -0.8), (2.4, -2.1), (2.7, 0.9)]
    c2w_l, K_l = [], []
    for j, (rad, hgt) in enumerate(rings):
        nj = n_cameras // len(rings) + (1 if j < n_cameras % len(rings) else 0)
        c2, K2 = ring_cameras(nj, rad, hgt, 60.0, width, height)
        c2w_l.append(c2)
        K_l.append(K2)
    order = np.argsort(np.concatenate(
        [np.arange(len(c)) * len(rings) + j for j, c in enumerate(c2w_l)]))
    c2ws = np.concatenate(c2w_l)[order]
    Ks = np.concatenate(K_l)[order]
    rngc = np.random.default_rng(seed + 7)
    eyes = c2ws[:, :3, 3]
    radial = eyes * np.array([1.0, 0.0, 1.0])
    rn = np.linalg.norm(radial, axis=1, keepdims=True)
    jit_r = rngc.uniform(0.75, 1.25, (len(eyes), 1))
    eyes = (radial / rn) * (rn * jit_r) + np.array([0.0, 1.0, 0.0]) * (
        eyes[:, 1:2] + rngc.uniform(-0.35, 0.35, (len(eyes), 1)))
    c2ws = np.stack([look_at(e, np.zeros(3)) for e in eyes])
    return c2ws, Ks


def make_synthetic_scene(
    n_gaussians: int = 2000,
    n_cameras: int = 12,
    width: int = 128,
    height: int = 128,
    n_points: int = 500,
    seed: int = 0,
    camera_model: str = "pinhole",
    surface: bool = False,
    device="cuda",
):
    """Returns ``(SceneData, gt_params)``: GT images of a known gaussian
    scene (``make_gt_gaussians``) rendered one camera at a time through
    ``impl="tiled"`` with ``IsectCaps.choose`` defaults, as the JAX
    package renders them (it does not check overflow either), plus
    SfM-like init points. Cameras: spherical (identity rotations, jittered
    centres), ``surface`` (three jittered rings) or one ring. Renders on
    CUDA unless ``device="cpu"``."""
    from splat_one_tpu_torch.train.trainer import SceneData

    dev = resolve_device(device)
    means, quats, scales, opac, rgb = make_gt_gaussians(n_gaussians, seed, surface=surface)
    if camera_model == "spherical":
        c2ws = np.tile(np.eye(4, dtype=np.float32), (n_cameras, 1, 1))
        rng = np.random.default_rng(seed + 1)
        c2ws[:, :3, 3] = rng.uniform(-0.3, 0.3, (n_cameras, 3))
        Ks = np.tile(np.eye(3, dtype=np.float32), (n_cameras, 1, 1))
    elif surface:
        c2ws, Ks = _surface_cameras(n_cameras, width, height, seed)
    else:
        c2ws, Ks = ring_cameras(n_cameras, 3.0, -0.8, 60.0, width, height)

    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    g = [t(x) for x in (means, quats, scales, opac)]
    sh0 = rgb_to_sh(t(rgb))[:, None, :]
    viewmats = invert_se3(t(c2ws))
    Kt = t(Ks)
    caps = IsectCaps.choose(n_gaussians, 1, (-(-width // 16)) * (-(-height // 16)))
    with torch.no_grad():
        images = np.stack([
            torch.clamp(rasterization(*g, sh0, viewmats[i:i + 1], Kt[i:i + 1],
                                      width, height, sh_degree=0,
                                      camera_model=camera_model, caps=caps)[0][0],
                        0.0, 1.0).cpu().numpy()
            for i in range(n_cameras)])

    # SfM-like init points: subsample GT means with colour noise
    rng = np.random.default_rng(seed + 2)
    sel = rng.choice(n_gaussians, size=min(n_points, n_gaussians), replace=False)
    points = means[sel] + rng.normal(0, 0.01, (len(sel), 3)).astype(np.float32)
    points_rgb = np.clip(rgb[sel] + rng.normal(0, 0.05, (len(sel), 3)), 0, 1).astype(np.float32)
    scene = SceneData(
        camtoworlds=c2ws, Ks=Ks, images=images.astype(np.float32),
        points=points, points_rgb=points_rgb,
        # max camera distance from the camera centroid x 1.1, the
        # COLMAP / OpenSfM parsers' convention
        scene_scale=float(np.linalg.norm(
            c2ws[:, :3, 3] - c2ws[:, :3, 3].mean(0), axis=-1).max() * 1.1),
        camera_model=camera_model,
    )
    gt = dict(means=means, quats=quats, scales=scales, opacities=opac, rgb=rgb)
    return scene, gt
