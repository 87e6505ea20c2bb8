"""Sparse depth supervision from tracked SfM points: the port's own copy
of ``splat_one_tpu/data/depth_supervision.py`` (host-side numpy).

The 3D points an image observes are projected into that view to form a
sparse depth map, fed to the Trainer as ``SceneData.depths`` with
``Config.depth_loss=True``. Pinhole views store z-depth, spherical ones
the radial distance.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def sparse_depth_map(
    points: np.ndarray,  # [P, 3] world points observed by this image
    c2w: np.ndarray,  # [4, 4]
    K: np.ndarray,  # [3, 3]
    width: int,
    height: int,
    camera_model: str = "pinhole",
) -> np.ndarray:
    """Project points into the view; returns [H, W, 1] float32 depth map
    with zeros where no supervision exists."""
    out = np.zeros((height, width, 1), np.float32)
    if len(points) == 0:
        return out
    w2c = np.linalg.inv(c2w)
    p = points @ w2c[:3, :3].T + w2c[:3, 3]
    if camera_model == "spherical":
        depth = np.linalg.norm(p, axis=-1)
        lon = np.arctan2(p[:, 0], p[:, 2])
        lat = np.arcsin(
            np.clip(-p[:, 1] / np.maximum(depth, 1e-9), -1, 1)
        )
        u = (lon / (2 * np.pi) + 0.5) * width
        v = (0.5 - lat / np.pi) * height
        ok = depth > 1e-6
    else:
        depth = p[:, 2]
        ok = depth > 1e-6
        zs = np.maximum(depth, 1e-9)
        u = K[0, 0] * p[:, 0] / zs + K[0, 2]
        v = K[1, 1] * p[:, 1] / zs + K[1, 2]
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    ok &= (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    # nearest point wins per pixel: assign in descending-depth order so the
    # smallest depth is written last (numpy fancy assignment keeps the last)
    order = np.argsort(-depth[ok])
    out[vi[ok][order], ui[ok][order], 0] = depth[ok][order]
    return out


def depth_maps_from_tracks(
    tracks: List[Dict[int, int]],
    points: Dict[int, np.ndarray],
    camtoworlds: np.ndarray,  # [M, 4, 4]
    Ks: np.ndarray,  # [M, 3, 3]
    width: int,
    height: int,
    camera_model: str = "pinhole",
) -> np.ndarray:
    """Per-image sparse depth maps from an SfM reconstruction:
    ``[M, H, W, 1]`` with zeros where unsupervised. Feed as
    ``SceneData.depths`` with ``Config.depth_loss=True``."""
    M = len(camtoworlds)
    pts_of_img: List[List[np.ndarray]] = [[] for _ in range(M)]
    for tid, tr in enumerate(tracks):
        if tid not in points:
            continue
        for img in tr:
            if 0 <= img < M:
                pts_of_img[img].append(points[tid])
    out = np.zeros((M, height, width, 1), np.float32)
    for i in range(M):
        if pts_of_img[i]:
            out[i] = sparse_depth_map(
                np.stack(pts_of_img[i]), camtoworlds[i], Ks[i],
                width, height, camera_model,
            )
    return out
