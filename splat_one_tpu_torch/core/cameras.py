"""Camera models: pinhole, ortho, fisheye, spherical (equirectangular).

Counterpart of ``splat_one_tpu/core/cameras.py`` (``project``,
``projection_jacobian``, ``unproject``, ``in_image``, ``visible_depth``). Camera frame is OpenCV-style (+x right,
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


def projection_jacobian(
    p_cam: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    camera_model: str = "pinhole",
    dist: Optional[torch.Tensor] = None,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Exact Jacobian d(uv)/d(p_cam): ``[..., 2, 3]``. Closed forms for
    pinhole, ortho, spherical and undistorted fisheye; the distorted
    fisheye goes through ``torch.func.jacfwd`` of ``project``."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    zero = torch.zeros_like(x)
    if camera_model == "pinhole":
        zs = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
        inv_z = 1.0 / zs
        row_u = torch.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], dim=-1)
        row_v = torch.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], dim=-1)
        return torch.stack([row_u, row_v], dim=-2)
    if camera_model == "ortho":
        one = torch.ones_like(x)
        row_u = torch.stack([fx * one, zero, zero], dim=-1)
        row_v = torch.stack([zero, fy * one, zero], dim=-1)
        return torch.stack([row_u, row_v], dim=-2)
    if camera_model == "spherical":
        rxz2 = torch.clamp(x * x + z * z, min=eps)
        r2 = torch.clamp(x * x + y * y + z * z, min=eps)
        cu = width / (2.0 * math.pi)
        du = torch.stack([cu * z / rxz2, zero, -cu * x / rxz2], dim=-1)
        rxz = torch.sqrt(rxz2)
        cv = -height / math.pi
        dv = torch.stack([cv * (x * y / (r2 * rxz)), cv * (-rxz / r2),
                          cv * (z * y / (r2 * rxz))], dim=-1)
        return torch.stack([du, dv], dim=-2)
    if camera_model == "fisheye" and dist is None:
        x2, y2, xy = x * x, y * y, x * y
        r2 = torch.clamp(x2 + y2, min=1e-7)
        L2 = r2 + z * z
        inv_L2 = 1.0 / torch.clamp(L2, min=1e-7)
        theta = torch.atan2(torch.sqrt(r2), z)
        b_f = theta / (r2 * torch.sqrt(r2))
        a_f = z * inv_L2 / r2
        du = torch.stack([fx * (x2 * a_f + y2 * b_f), fx * xy * (a_f - b_f),
                          -fx * x * inv_L2], dim=-1)
        dv = torch.stack([fy * xy * (a_f - b_f), fy * (y2 * a_f + x2 * b_f),
                          -fy * y * inv_L2], dim=-1)
        return torch.stack([du, dv], dim=-2)

    def f(p):
        return project(p, K, width, height, camera_model, dist)

    flat = p_cam.reshape(-1, 3)
    J = torch.func.vmap(torch.func.jacfwd(f))(flat)
    return J.reshape(p_cam.shape[:-1] + (2, 3))


def unproject(
    uv: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    camera_model: str = "pinhole",
    eps: float = 1e-8,
) -> torch.Tensor:
    """Pixel coords ``[..., 2]`` -> unit bearing vectors ``[..., 3]``
    (the undistorted equidistant model for fisheye)."""
    _check_model(camera_model)
    u, v = uv[..., 0], uv[..., 1]
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    if camera_model == "pinhole":
        x = (u - cx) / fx
        y = (v - cy) / fy
        b = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    elif camera_model == "ortho":
        x = (u - cx) / fx
        y = (v - cy) / fy
        z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=eps))
        b = torch.stack([x, y, z], dim=-1)
    elif camera_model == "fisheye":
        mx = (u - cx) / fx
        my = (v - cy) / fy
        theta = torch.sqrt(mx * mx + my * my)
        s = torch.sin(theta) / torch.clamp(theta, min=eps)
        b = torch.stack([mx * s, my * s, torch.cos(theta)], dim=-1)
    else:
        lon = (u / width - 0.5) * 2.0 * math.pi
        lat = (0.5 - v / height) * math.pi
        x = torch.cos(lat) * torch.sin(lon)
        z = torch.cos(lat) * torch.cos(lon)
        y = -torch.sin(lat)
        b = torch.stack([x, y, z], dim=-1)
    return b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=eps)


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
