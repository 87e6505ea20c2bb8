"""Camera models: pinhole, ortho, fisheye, spherical (equirectangular).

Counterpart of ``splat_one_tpu/core/cameras.py`` (``project``,
``in_image``, ``visible_depth``). Camera frame is OpenCV-style (+x right,
+y down, +z forward). Equirectangular mapping: ``u = (lon/2pi + 0.5) * W``,
``v = (0.5 - lat/pi) * H`` with ``lon = atan2(x, z)``, ``lat = asin(-y/r)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

CAMERA_MODELS = ("pinhole", "ortho", "fisheye", "spherical")


def _check_model(camera_model: str) -> None:
    if camera_model not in CAMERA_MODELS:
        raise ValueError(
            f"camera_model must be one of {CAMERA_MODELS}, got {camera_model!r}"
        )


def project(
    p_cam: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    camera_model: str = "pinhole",
    dist: Optional[torch.Tensor] = None,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Camera-frame points ``[..., 3]`` -> pixel coords ``[..., 2]``.

    ``K`` is ``[..., 3, 3]`` broadcastable against the points' leading dims
    (ignored for spherical); ``dist`` is the optional fisheye theta
    polynomial ``[4]`` (k1..k4)."""
    _check_model(camera_model)
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]

    if camera_model == "pinhole":
        zs = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
        u = fx * x / zs + cx
        v = fy * y / zs + cy
    elif camera_model == "ortho":
        u = fx * x + cx
        v = fy * y + cy
    elif camera_model == "fisheye":
        r = torch.sqrt(x * x + y * y)
        theta = torch.atan2(r, z)
        if dist is not None:
            t2 = theta * theta
            theta_d = theta * (
                1.0
                + dist[..., 0] * t2
                + dist[..., 1] * t2 * t2
                + dist[..., 2] * t2 * t2 * t2
                + dist[..., 3] * t2 * t2 * t2 * t2
            )
        else:
            theta_d = theta
        scale = theta_d / torch.clamp(r, min=eps)
        u = fx * x * scale + cx
        v = fy * y * scale + cy
    else:
        r = torch.sqrt(x * x + y * y + z * z)
        lon = torch.atan2(x, z)
        lat = torch.asin(torch.clamp(-y / torch.clamp(r, min=eps), -1.0, 1.0))
        u = (lon / (2.0 * math.pi) + 0.5) * width
        v = (0.5 - lat / math.pi) * height
    return torch.stack([u, v], dim=-1)


def in_image(uv: torch.Tensor, width: int, height: int, margin: float = 0.0):
    """Boolean mask of pixels inside the image (with optional margin)."""
    u, v = uv[..., 0], uv[..., 1]
    return (
        (u >= -margin) & (u < width + margin) & (v >= -margin) & (v < height + margin)
    )


def visible_depth(p_cam: torch.Tensor, camera_model: str) -> torch.Tensor:
    """Sort/cull depth: z for pinhole/ortho/fisheye, radial for spherical."""
    if camera_model == "spherical":
        return torch.linalg.norm(p_cam, dim=-1)
    return p_cam[..., 2]
