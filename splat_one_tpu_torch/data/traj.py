"""Render-trajectory generators: the port's own copy of
``splat_one_tpu/data/traj.py`` (host-side numpy). Catmull-Rom paths
through the training cameras, ellipse orbits about the scene focus (z-up
or y-up) and forward-facing spirals.
"""

from __future__ import annotations

import numpy as np


def _normalize(v):
    return v / (np.linalg.norm(v) + 1e-12)


def _look_at_c2w(eye, target, up):
    d = target - eye
    if np.linalg.norm(d) < 1e-8:  # degenerate: eye at target
        d = np.array([0.0, 0.0, 1.0])
    fwd = _normalize(d)
    r = np.cross(up, fwd)
    if np.linalg.norm(r) < 1e-8:  # up parallel to forward
        alt = np.array([1.0, 0.0, 0.0])
        if abs(fwd @ alt) > 0.9:
            alt = np.array([0.0, 1.0, 0.0])
        r = np.cross(alt, fwd)
    right = _normalize(r)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


def generate_interpolated_path(
    c2ws: np.ndarray, n_interp: int = 4, spline_degree: int = 3
) -> np.ndarray:
    """Smooth path through the given camera poses (Catmull-Rom-style cubic
    interpolation of positions and look-at targets; scipy-free)."""
    n = len(c2ws)
    if n < 2:
        return c2ws.copy()
    pos = c2ws[:, :3, 3]
    fwd = c2ws[:, :3, 2]
    targets = pos + fwd  # unit look-ahead targets
    ups = -c2ws[:, :3, 1]

    def interp(points, t_all):
        # piecewise Catmull-Rom over the control sequence
        out = []
        for t in t_all:
            i = min(int(np.floor(t)), n - 2)
            f = t - i
            p0 = points[max(i - 1, 0)]
            p1 = points[i]
            p2 = points[i + 1]
            p3 = points[min(i + 2, n - 1)]
            out.append(
                0.5
                * (
                    (2 * p1)
                    + (-p0 + p2) * f
                    + (2 * p0 - 5 * p1 + 4 * p2 - p3) * f * f
                    + (-p0 + 3 * p1 - 3 * p2 + p3) * f * f * f
                )
            )
        return np.stack(out)

    t_all = np.linspace(0, n - 1, n_interp * (n - 1), endpoint=False)
    p = interp(pos, t_all)
    tg = interp(targets, t_all)
    up = interp(ups, t_all)
    return np.stack(
        [_look_at_c2w(pi, ti, _normalize(ui)) for pi, ti, ui in zip(p, tg, up)]
    ).astype(np.float32)


def generate_ellipse_path_z(
    c2ws: np.ndarray,
    n_frames: int = 120,
    variation: float = 0.0,
    phase: float = 0.0,
    height_offset: float = 0.0,
) -> np.ndarray:
    """Elliptical orbit in the xy-plane around the camera centroid (z-up
    worlds, i.e. after normalization; reference traj.py:82-142)."""
    pos = c2ws[:, :3, 3]
    center = pos.mean(axis=0)
    # ellipse radii from camera spread (90th percentile for robustness)
    offsets = np.percentile(np.abs(pos - center), 90, axis=0)
    z = float(np.median(pos[:, 2])) + height_offset
    thetas = np.linspace(0, 2 * np.pi, n_frames, endpoint=False) + phase
    eyes = np.stack(
        [
            center[0] + offsets[0] * np.cos(thetas),
            center[1]
            + offsets[1] * np.sin(thetas) * (1 + variation * np.cos(thetas)),
            np.full_like(thetas, z),
        ],
        axis=-1,
    )
    return np.stack(
        [_look_at_c2w(e, center, np.array([0.0, 0.0, 1.0])) for e in eyes]
    ).astype(np.float32)


def generate_ellipse_path_y(
    c2ws: np.ndarray, n_frames: int = 120, variation: float = 0.0,
    phase: float = 0.0, height_offset: float = 0.0,
) -> np.ndarray:
    """Same orbit for y-up worlds (reference traj.py:145-203)."""
    pos = c2ws[:, :3, 3]
    center = pos.mean(axis=0)
    offsets = np.percentile(np.abs(pos - center), 90, axis=0)
    y = float(np.median(pos[:, 1])) + height_offset
    thetas = np.linspace(0, 2 * np.pi, n_frames, endpoint=False) + phase
    eyes = np.stack(
        [
            center[0] + offsets[0] * np.cos(thetas),
            np.full_like(thetas, y),
            center[2]
            + offsets[2] * np.sin(thetas) * (1 + variation * np.cos(thetas)),
        ],
        axis=-1,
    )
    return np.stack(
        [_look_at_c2w(e, center, np.array([0.0, -1.0, 0.0])) for e in eyes]
    ).astype(np.float32)


def generate_spiral_path(
    c2ws: np.ndarray,
    n_frames: int = 120,
    n_rots: int = 2,
    zrate: float = 0.5,
    radius_scale: float = 0.5,
) -> np.ndarray:
    """Forward-facing spiral around the average pose (reference
    traj.py:43-79)."""
    pos = c2ws[:, :3, 3]
    center_pose = c2ws[len(c2ws) // 2]
    center = pos.mean(axis=0)
    rad = np.percentile(np.abs(pos - center), 90, axis=0) * radius_scale
    up = -center_pose[:3, 1]
    out = []
    for theta in np.linspace(0, 2 * np.pi * n_rots, n_frames, endpoint=False):
        offset = np.array(
            [np.cos(theta), np.sin(theta), np.sin(theta * zrate)]
        ) * rad
        eye = center_pose[:3, 3] + center_pose[:3, :3] @ offset
        target = eye + center_pose[:3, 2]
        out.append(_look_at_c2w(eye, target, up))
    return np.stack(out).astype(np.float32)
