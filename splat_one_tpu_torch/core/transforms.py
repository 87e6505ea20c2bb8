"""Rotation / rigid-transform utilities on torch tensors.

Counterpart of ``splat_one_tpu/core/transforms.py``. Quaternions are
``[w, x, y, z]`` (scalar-first); every function is batched over leading
axes.
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along ``dim``."""
    return v / torch.clamp(torch.linalg.norm(v, dim=dim, keepdim=True), min=eps)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) ``[..., 4]`` (wxyz, normalized here) -> ``[..., 3, 3]``."""
    q = normalize(quat)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)],
        [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)],
        [2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``[..., 3, 3]`` -> quaternions ``[..., 4]`` (wxyz).

    Shepperd-style: all four candidates, the largest pivot selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    q1 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
         1.0 + m22 - m00 - m11],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1, keepdim=True)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # [..., 4, 4]
    q = torch.take_along_dim(cands, best[..., None].expand(best.shape + (4,)), dim=-2)
    q = q[..., 0, :]
    piv = torch.take_along_dim(pivots, best, dim=-1)
    q = q / (2.0 * torch.sqrt(torch.clamp(piv, min=1e-12)))
    q = torch.where(q[..., :1] < 0, -q, q)
    return normalize(q)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions (wxyz), batched."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation (Zhou et al., CVPR 2019) -> ``[..., 3, 3]``."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = normalize(a1)
    b2 = normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rotation_6d_to_matrix` (first two rows, flattened)."""
    return torch.cat([R[..., 0, :], R[..., 1, :]], dim=-1)


def se3_compose(R1, t1, R2, t2):
    """(R1, t1) after (R2, t2): x -> R1 (R2 x + t2) + t1."""
    return R1 @ R2, (R1 @ t2[..., None])[..., 0] + t1


def _rigid4(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def make_viewmat(R_c2w: torch.Tensor, t_c2w: torch.Tensor) -> torch.Tensor:
    """4x4 world->camera matrix from camera-to-world rotation/translation."""
    R_w2c = R_c2w.transpose(-1, -2)
    return _rigid4(R_w2c, -(R_w2c @ t_c2w[..., None])[..., 0])


def invert_se3(mat4: torch.Tensor) -> torch.Tensor:
    """Invert a batch of 4x4 rigid transforms."""
    Rt = mat4[..., :3, :3].transpose(-1, -2)
    return _rigid4(Rt, -(Rt @ mat4[..., :3, 3][..., None])[..., 0])
