"""Real spherical-harmonics basis evaluation (degrees 0..4) on torch tensors.

Counterpart of ``splat_one_tpu/core/sh.py``: the same constants and the
same per-term expressions.
"""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)

MAX_SH_DEGREE = 4


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh_bases(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """SH basis values ``[..., (degree+1)**2]`` at unit directions ``[..., 3]``."""
    if not 0 <= degree <= MAX_SH_DEGREE:
        raise ValueError(f"SH degree must be in [0,{MAX_SH_DEGREE}], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full(dirs.shape[:-1], _C0, dtype=dirs.dtype, device=dirs.device)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        out += [
            _C4[0] * xy * (xx - yy),
            _C4[1] * yz * (3.0 * xx - yy),
            _C4[2] * xy * (7.0 * zz - 1.0),
            _C4[3] * yz * (7.0 * zz - 3.0),
            _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            _C4[5] * xz * (7.0 * zz - 3.0),
            _C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            _C4[7] * xz * (xx - 3.0 * yy),
            _C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(degree: int, coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Raw SH colour ``[..., D]``: sum_k basis_k(dir) * coeffs[..., k, :].

    ``coeffs`` is ``[..., K, D]`` with K >= (degree+1)**2; the caller adds
    the 0.5 offset and clamps, as in 3DGS."""
    n = num_sh_bases(degree)
    basis = eval_sh_bases(degree, dirs)
    return torch.einsum("...k,...kd->...d", basis, coeffs[..., :n, :])


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0, 1] -> degree-0 SH coefficient."""
    return (rgb - 0.5) / _C0


def sh_to_rgb(sh0: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_sh`."""
    return sh0 * _C0 + 0.5
