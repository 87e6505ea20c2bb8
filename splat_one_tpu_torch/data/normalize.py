"""World-space normalization: the port's own copy of
``splat_one_tpu/data/normalize.py`` (host-side numpy, run once at data
load). Aligns the average camera "up" to +z, recentres on the cameras'
focus point (or pose centroid), rescales by the median camera distance,
then aligns the points' principal axes; plus the point and camera
transform helpers.
"""

from __future__ import annotations

import numpy as np


def _rotation_aligning(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b (Rodrigues)."""
    c = float(a @ b)
    if c < -1 + 1e-8:
        # antiparallel: rotate 180 deg about any axis orthogonal to a
        axis = np.eye(3)[np.argmin(np.abs(a))]
        axis = axis - a * (axis @ a)
        axis /= np.linalg.norm(axis)
        K = np.array(
            [
                [0, -axis[2], axis[1]],
                [axis[2], 0, -axis[0]],
                [-axis[1], axis[0], 0],
            ]
        )
        return np.eye(3) + 2.0 * K @ K
    v = np.cross(a, b)
    K = np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]
    )
    return np.eye(3) + K + K @ K / (1.0 + c)


def similarity_from_cameras(
    c2w: np.ndarray,
    strict_scaling: bool = False,
    center_method: str = "focus",
):
    """Similarity transform normalizing OpenCV-convention c2w cameras.

    Returns (T [4,4], scale): apply as ``T @ c2w`` then scale translations.
    """
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]

    # world-up estimate: average of camera up axes (-y rows in OpenCV frames)
    ups = R @ np.array([0.0, -1.0, 0.0])
    world_up = ups.mean(axis=0)
    world_up /= np.linalg.norm(world_up)
    R_align = _rotation_aligning(world_up, np.array([0.0, 0.0, 1.0]))

    R_new = R_align @ R
    t_new = t @ R_align.T
    fwds = R_new @ np.array([0.0, 0.0, 1.0])

    if center_method == "focus":
        # closest point to origin along each camera's forward ray
        nearest = t_new + ((fwds * -t_new).sum(-1))[:, None] * fwds
        translate = -np.median(nearest, axis=0)
    elif center_method == "poses":
        translate = -np.median(t_new, axis=0)
    else:
        raise ValueError(f"unknown center_method {center_method!r}")

    T = np.eye(4)
    T[:3, :3] = R_align
    T[:3, 3] = translate

    scale_fn = np.max if strict_scaling else np.median
    scale = float(1.0 / scale_fn(np.linalg.norm(t_new + translate, axis=-1)))
    return T, scale


def align_principal_axes(points: np.ndarray) -> np.ndarray:
    """PCA alignment: rotate so point-cloud principal axes map to xyz, with a
    right-handed, mostly-up-preserving sign convention (reference
    normalize.py:66-97)."""
    centered = points - np.median(points, axis=0)
    cov = centered.T @ centered
    _, eigvecs = np.linalg.eigh(cov)
    # largest variance -> x, smallest -> z
    R = eigvecs[:, ::-1].T
    if np.linalg.det(R) < 0:
        R[2] *= -1
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ np.median(points, axis=0)
    return T


def transform_points(T: np.ndarray, points: np.ndarray) -> np.ndarray:
    return points @ T[:3, :3].T + T[:3, 3]


def transform_cameras(T: np.ndarray, c2w: np.ndarray):
    """Apply T to camera-to-world matrices; returns new c2w (rotation part
    re-orthonormalized against scale)."""
    out = np.einsum("ij,njk->nik", T, c2w)
    # remove any scale leaked into the rotation block
    scales = np.linalg.norm(out[:, :3, :3], axis=1, keepdims=True)
    out[:, :3, :3] = out[:, :3, :3] / np.clip(scales, 1e-12, None)
    return out


def normalize_scene(c2w: np.ndarray, points: np.ndarray):
    """Full reference normalization pipeline (opensfm.py:165-180 /
    colmap.py): similarity from cameras, then PCA alignment of the points.

    Returns (c2w', points', transform [4,4])."""
    T1, scale = similarity_from_cameras(c2w)
    c2w = transform_cameras(T1, c2w)
    points = transform_points(T1, points)
    c2w[:, :3, 3] *= scale
    points = points * scale
    S = np.diag([scale, scale, scale, 1.0])

    if len(points) == 0:
        # shots-only reconstruction: PCA alignment has nothing to fit and
        # np.median of an empty array would NaN every camera pose
        return c2w, points, S @ T1

    T2 = align_principal_axes(points)
    c2w = transform_cameras(T2, c2w)
    points = transform_points(T2, points)
    return c2w, points, T2 @ S @ T1
