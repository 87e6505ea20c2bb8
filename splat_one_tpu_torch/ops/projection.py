"""EWA projection of 3D Gaussians to screen space on torch tensors.

Counterpart of ``splat_one_tpu/ops/projection.py``: pinhole, ortho,
fisheye and spherical cameras, antialiased opacity compensation, near/far
and radius culling, the ``alive`` mask, SH colours and per-camera colours.
The float expressions are the JAX package's own, term for term, so the
``valid`` decisions agree exactly. ``project_gaussians_plain`` is written
struct-of-arrays over [C, N]: every intermediate is a flat
per-(camera, gaussian) tensor, and autograd runs through it.

``project_gaussians`` takes the kernel (``project_fwd``,
``csrc/project_fwd.cu``: the same expressions in one pass over the rows)
for CUDA inputs that autograd does not record through, and the plain
version for everything else: the training forward and every CPU call.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from splat_one_tpu_torch.core import cameras as cam
from splat_one_tpu_torch.core import sh as shlib
from splat_one_tpu_torch.utils import cuda_build

EPS2D = 0.3  # standard 3DGS screen-space low-pass filter

# Contribution cutoff (gsplat's 1/255); the compositors kill alpha below it.
ALPHA_CUT = 1.0 / 255.0


def opacity_extent(opacity: torch.Tensor) -> torch.Tensor:
    """Membership extent in sigmas: min(3, sqrt(2 ln(opa / ALPHA_CUT))).

    Beyond it ``opa * exp(-sigma) < ALPHA_CUT``, so every compositor kills
    the contribution anyway; the +1e-3 sigma margin absorbs rounding
    between this expression and the per-pixel sigma."""
    s2 = 2.0 * torch.log(torch.clamp(opacity, min=1e-12) * (1.0 / ALPHA_CUT))
    return torch.clamp(torch.sqrt(torch.clamp(s2, min=0.0)) + 1e-3, max=3.0)


def conic_ellipse_radii(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        opacity: torch.Tensor | None = None):
    """Axis-aligned half-extents (rx, ry) of the membership ellipse from the
    conic (a, b, c) = inverse 2D covariance: s * sqrt(cov_xx), s *
    sqrt(cov_yy), with s = 3 or ``opacity_extent(opacity)``. The one
    membership definition shared by the stream builder, the compositing
    kernel's per-tile gate and the oracle."""
    det = torch.clamp(a * c - b * b, min=1e-30)
    inv = 1.0 / det
    s = 3.0 if opacity is None else opacity_extent(opacity)
    rx = s * torch.sqrt(torch.clamp(c * inv, min=0.0))
    ry = s * torch.sqrt(torch.clamp(a * inv, min=0.0))
    return rx, ry


class Projected(NamedTuple):
    """Per-(camera, gaussian) screen-space quantities. Leading dims [C, N]."""

    means2d: torch.Tensor  # [C, N, 2] pixel coords
    conics: torch.Tensor  # [C, N, 3] inverse 2D covariance (a, b, c)
    depths: torch.Tensor  # [C, N] sort/cull depth (z or radial for spherical)
    radii: torch.Tensor  # [C, N] 3-sigma screen radius (0 => culled)
    colors: torch.Tensor  # [C, N, D]
    opacities: torch.Tensor  # [C, N] (after antialiasing compensation)
    valid: torch.Tensor  # [C, N] bool


def _rotmat_soa(quats):
    """Quaternion -> rotation matrix as nine [N] component tensors."""
    q = quats / torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True) + 1e-24)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def project_gaussians_plain(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4] wxyz (unnormalized ok)
    scales: torch.Tensor,  # [N, 3] positive
    opacities: torch.Tensor,  # [N] in [0, 1]
    viewmats: torch.Tensor,  # [C, 4, 4] world->camera
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    *,
    sh_coeffs: Optional[torch.Tensor] = None,  # [N, K, 3]
    sh_degree: int = 0,
    colors: Optional[torch.Tensor] = None,  # [N, D] or [C, N, D]
    camera_model: str = "pinhole",
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps2d: float = EPS2D,
    antialiased: bool = False,
    alive: Optional[torch.Tensor] = None,  # [N] bool
) -> Projected:
    """Project all gaussians into all cameras: the plain PyTorch version."""
    if camera_model not in cam.CAMERA_MODELS:
        raise ValueError(f"unknown camera_model {camera_model!r}")
    if sh_coeffs is None and colors is None:
        raise ValueError("either sh_coeffs or colors must be given")
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = _rotmat_soa(quats)
    sx, sy, sz = scales[..., 0], scales[..., 1], scales[..., 2]
    m00, m01, m02 = m00 * sx, m01 * sy, m02 * sz
    m10, m11, m12 = m10 * sx, m11 * sy, m12 * sz
    m20, m21, m22 = m20 * sx, m21 * sy, m22 * sz
    mx, my, mz = means[..., 0], means[..., 1], means[..., 2]

    # per-camera scalars as [C, 1] columns broadcasting against [N] rows
    R = [[viewmats[:, i, j, None] for j in range(3)] for i in range(3)]
    t = [viewmats[:, i, 3, None] for i in range(3)]
    px = R[0][0] * mx + R[0][1] * my + R[0][2] * mz + t[0]
    py = R[1][0] * mx + R[1][1] * my + R[1][2] * mz + t[1]
    pz = R[2][0] * mx + R[2][1] * my + R[2][2] * mz + t[2]
    if camera_model == "spherical":
        depth = torch.sqrt(px * px + py * py + pz * pz + 1e-24)
    else:
        depth = pz

    def rot_row(r0, r1, r2):
        return (
            r0 * m00 + r1 * m10 + r2 * m20,
            r0 * m01 + r1 * m11 + r2 * m21,
            r0 * m02 + r1 * m12 + r2 * m22,
        )

    b00, b01, b02 = rot_row(*R[0])
    b10, b11, b12 = rot_row(*R[1])
    b20, b21, b22 = rot_row(*R[2])

    fx, fy = Ks[:, 0, 0, None], Ks[:, 1, 1, None]
    eps = 1e-8
    zero = torch.zeros_like(px)
    if camera_model == "pinhole":
        zs = torch.clamp(pz, min=1e-6)
        lim_x = 1.3 * 0.5 * width / fx
        lim_y = 1.3 * 0.5 * height / fy
        xc = zs * torch.clamp(px / zs, -lim_x, lim_x)
        yc = zs * torch.clamp(py / zs, -lim_y, lim_y)
        inv_z = 1.0 / torch.where(torch.abs(pz) < eps, torch.full_like(pz, eps), pz)
        j00, j01, j02 = fx * inv_z, zero, -fx * xc * inv_z * inv_z
        j10, j11, j12 = zero, fy * inv_z, -fy * yc * inv_z * inv_z
    elif camera_model == "ortho":
        one = torch.ones_like(px)
        j00, j01, j02 = fx * one, 0.0 * one, 0.0 * one
        j10, j11, j12 = 0.0 * one, fy * one, 0.0 * one
    elif camera_model == "spherical":
        rxz2 = torch.clamp(px * px + pz * pz, min=eps)
        r2 = torch.clamp(px * px + py * py + pz * pz, min=eps)
        rxz = torch.sqrt(rxz2)
        cu = width / (2.0 * math.pi)
        cv = -height / math.pi
        j00, j01, j02 = cu * pz / rxz2, zero, -cu * px / rxz2
        j10 = cv * px * py / (r2 * rxz)
        j11 = cv * -rxz / r2
        j12 = cv * pz * py / (r2 * rxz)
    else:
        # closed-form equidistant fisheye: with rho^2 = x^2+y^2 (clamped
        # at 1e-7), L^2 = rho^2+z^2, theta = atan2(rho, z),
        # a = z/(L^2 rho^2), b = theta/rho^3
        eps_f = 1e-7
        x2, y2, xy = px * px, py * py, px * py
        r2 = torch.clamp(x2 + y2, min=eps_f)
        L2 = r2 + pz * pz
        inv_L2 = 1.0 / torch.clamp(L2, min=eps_f)
        theta = torch.atan2(torch.sqrt(r2), pz)
        b_f = theta / (r2 * torch.sqrt(r2))
        a_f = pz * inv_L2 / r2
        j00 = fx * (x2 * a_f + y2 * b_f)
        j01 = fx * xy * (a_f - b_f)
        j02 = -fx * px * inv_L2
        j10 = fy * xy * (a_f - b_f)
        j11 = fy * (y2 * a_f + x2 * b_f)
        j12 = -fy * py * inv_L2

    # A = J @ B (2x3), cov2d = A A^T
    a00 = j00 * b00 + j01 * b10 + j02 * b20
    a01 = j00 * b01 + j01 * b11 + j02 * b21
    a02 = j00 * b02 + j01 * b12 + j02 * b22
    a10 = j10 * b00 + j11 * b10 + j12 * b20
    a11 = j10 * b01 + j11 * b11 + j12 * b21
    a12 = j10 * b02 + j11 * b12 + j12 * b22
    ca = a00 * a00 + a01 * a01 + a02 * a02
    cb = a00 * a10 + a01 * a11 + a02 * a12
    cc = a10 * a10 + a11 * a11 + a12 * a12

    det_raw = ca * cc - cb * cb
    ca = ca + eps2d
    cc = cc + eps2d
    det = ca * cc - cb * cb
    inv_det = 1.0 / torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([cc * inv_det, -cb * inv_det, ca * inv_det], dim=-1)

    if antialiased:
        comp = torch.sqrt(torch.clamp(det_raw, min=0.0) * inv_det)
    else:
        comp = torch.ones_like(det)
    opac = opacities * comp

    # 3-sigma screen radius from the larger eigenvalue of cov2d
    mid = 0.5 * (ca + cc)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radius = 3.0 * torch.sqrt(torch.clamp(mid + disc, min=0.0))

    p_cam = torch.stack([px, py, pz], dim=-1)
    uv = cam.project(p_cam, Ks[:, None], width, height, camera_model)

    ok = (depth > near_plane) & (depth < far_plane) & (det > 0)
    ok &= radius > radius_clip
    # cull ellipses whose bbox misses the image (spherical wraps in
    # azimuth, so only v there): the cov-diagonal form of
    # conic_ellipse_radii, same opacity-aware extents
    ext = opacity_extent(opac)
    rx = ext * torch.sqrt(torch.clamp(ca, min=0.0))
    ry = ext * torch.sqrt(torch.clamp(cc, min=0.0))
    u, v = uv[..., 0], uv[..., 1]
    inside_v = (v + ry > 0) & (v - ry < height)
    if camera_model == "spherical":
        ok &= inside_v
    else:
        ok &= inside_v & (u + rx > 0) & (u - rx < width)
    if alive is not None:
        ok &= alive

    radius = torch.where(ok, radius, torch.zeros_like(radius))

    C, N = px.shape
    if sh_coeffs is not None:
        Rm = viewmats[:, :3, :3]
        campos = -(Rm.transpose(-1, -2) @ viewmats[:, :3, 3, None])[..., 0]
        dx = mx - campos[:, 0, None]
        dy = my - campos[:, 1, None]
        dz = mz - campos[:, 2, None]
        # sqrt(sum + eps) keeps dirs finite for dead slots at the origin
        dn = torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-20)
        dirs = torch.stack([dx / dn, dy / dn, dz / dn], dim=-1)
        coeffs = sh_coeffs.expand((C,) + sh_coeffs.shape)
        col = torch.clamp(shlib.eval_sh(sh_degree, coeffs, dirs) + 0.5, min=0.0)
    elif colors.ndim == 2:
        col = colors.expand((C,) + colors.shape)
    else:
        col = colors
    return Projected(uv, conic, depth, radius, col, opac, ok)


def records_grad(*tensors) -> bool:
    """Whether autograd records through a call on ``tensors`` (None
    entries skipped): grad mode on and some input requiring grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _staged(t):
    """``t`` contiguous and 16-byte aligned, as the kernel stages it: a
    copy only where it is neither (a camera sliced out of a stack of
    ``Ks`` is not aligned)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def project_gaussians(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4] wxyz (unnormalized ok)
    scales: torch.Tensor,  # [N, 3] positive
    opacities: torch.Tensor,  # [N] in [0, 1]
    viewmats: torch.Tensor,  # [C, 4, 4] world->camera
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    *,
    sh_coeffs: Optional[torch.Tensor] = None,  # [N, K, 3]
    sh_degree: int = 0,
    colors: Optional[torch.Tensor] = None,  # [N, D] or [C, N, D]
    camera_model: str = "pinhole",
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    eps2d: float = EPS2D,
    antialiased: bool = False,
    alive: Optional[torch.Tensor] = None,  # [N] bool
) -> Projected:
    """Project all gaussians into all cameras.

    CUDA inputs that autograd does not record through (``records_grad``)
    launch the kernel (``project_fwd``, whose checks raise; the inputs
    staged contiguous and aligned first); everything else runs
    ``project_gaussians_plain``."""
    if means.device.type != "cuda" or records_grad(
            means, quats, scales, opacities, viewmats, Ks, sh_coeffs, colors):
        return project_gaussians_plain(
            means, quats, scales, opacities, viewmats, Ks, width, height,
            sh_coeffs=sh_coeffs, sh_degree=sh_degree, colors=colors,
            camera_model=camera_model, near_plane=near_plane, far_plane=far_plane,
            radius_clip=radius_clip, eps2d=eps2d, antialiased=antialiased, alive=alive)
    if sh_coeffs is None and colors is None:
        raise ValueError("either sh_coeffs or colors must be given")
    ins = [_staged(t) for t in (means, quats, scales, opacities, viewmats, Ks)]
    uv, conic, depth, radius, col, opac, ok = project_fwd(
        *ins, width, height, sh_coeffs=None if sh_coeffs is None else _staged(sh_coeffs),
        sh_degree=sh_degree, camera_model=camera_model, near_plane=near_plane,
        far_plane=far_plane, radius_clip=radius_clip, eps2d=eps2d, antialiased=antialiased,
        alive=None if alive is None else alive.contiguous())
    if col is None:
        col = colors.expand((viewmats.shape[0],) + colors.shape) if colors.ndim == 2 else colors
    return Projected(uv, conic, depth, radius, col, opac, ok)


def _check_cuda(named, dev):
    """Raise unless every ``(name, tensor, _)`` lies on CUDA device ``dev``."""
    for name, t, _ in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be on the CUDA device {dev}, got {t.device}")


_MODEL_IDS = {"pinhole": 0, "ortho": 1, "fisheye": 2, "spherical": 3}
_ROWS = 128  # rows a tile of the kernel
_MAX_K = 25  # SH coefficients a row the kernel stages (degree 4)


def project_fwd(means, quats, scales, opacities, viewmats, Ks, width: int, height: int, *,
                sh_coeffs=None, sh_degree: int = 0, camera_model: str = "pinhole",
                near_plane: float = 0.01, far_plane: float = 1e10,
                radius_clip: float = 0.0, eps2d: float = EPS2D,
                antialiased: bool = False, alive=None):
    """The kernel (built from ``csrc/project_fwd.cu`` at first use) ->
    ``(means2d [C, N, 2], conics [C, N, 3], depths, radii, colors [C, N,
    3] or None without ``sh_coeffs``, opacities, valid)``, the plain
    version's fields. Inputs: float32, contiguous, 16-byte aligned, on
    one CUDA device; ``alive`` bool; raises on anything else."""
    if camera_model not in _MODEL_IDS:
        raise ValueError(f"unknown camera_model {camera_model!r}")
    N, C = means.shape[0], viewmats.shape[0]
    named = [("means", means, (N, 3)), ("quats", quats, (N, 4)), ("scales", scales, (N, 3)),
             ("opacities", opacities, (N,)), ("viewmats", viewmats, (C, 4, 4)),
             ("Ks", Ks, (C, 3, 3))]
    nb = (sh_degree + 1) ** 2
    if sh_coeffs is not None:
        if not 0 <= sh_degree <= shlib.MAX_SH_DEGREE:
            raise ValueError(f"SH degree must be in [0,{shlib.MAX_SH_DEGREE}], got {sh_degree}")
        K = sh_coeffs.shape[1] if sh_coeffs.dim() == 3 else 0
        if not nb <= K <= _MAX_K:
            raise ValueError(f"sh_coeffs must hold {nb} to {_MAX_K} coefficients a row at "
                             f"degree {sh_degree}, got shape {tuple(sh_coeffs.shape)}")
        named.append(("sh_coeffs", sh_coeffs, (N, K, 3)))
    for name, t, shape in named:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if alive is not None:
        if alive.dtype != torch.bool or tuple(alive.shape) != (N,) or not alive.is_contiguous():
            raise ValueError(f"alive must be contiguous bool ({N},), got {alive.dtype} "
                             f"{tuple(alive.shape)}")
        named.append(("alive", alive, None))
    if N >= 2**31 - _ROWS:
        raise ValueError(f"{N} rows: the kernel indexes rows with 32-bit ints")
    dev = means.device
    _check_cuda(named, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    uv = torch.empty((C, N, 2), **f32)
    conic = torch.empty((C, N, 3), **f32)
    depth = torch.empty((C, N), **f32)
    radius = torch.empty((C, N), **f32)
    col = None if sh_coeffs is None else torch.empty((C, N, 3), **f32)
    opac = torch.empty((C, N), **f32)
    ok = torch.empty((C, N), dtype=torch.bool, device=dev)
    sh_ptr, alive_ptr, col_ptr = (None if t is None else t.data_ptr()
                                  for t in (sh_coeffs, alive, col))
    lib = cuda_build.library("project_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.project_fwd(
            means.data_ptr(), quats.data_ptr(), scales.data_ptr(), opacities.data_ptr(),
            sh_ptr, alive_ptr, viewmats.data_ptr(), Ks.data_ptr(),
            uv.data_ptr(), conic.data_ptr(), depth.data_ptr(), radius.data_ptr(), col_ptr,
            opac.data_ptr(), ok.data_ptr(), N, C,
            0 if sh_coeffs is None else sh_coeffs.shape[1], nb, _MODEL_IDS[camera_model],
            int(antialiased), int(width), int(height), float(near_plane), float(far_plane),
            float(radius_clip), float(eps2d), stream)
    cuda_build.check(lib, rc, "project_fwd")
    cuda_build.launch_counts["project_fwd"] += 1
    return uv, conic, depth, radius, col, opac, ok
