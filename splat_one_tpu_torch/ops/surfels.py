"""2D Gaussian Splatting's forward: surfels projected, packed and
composited by ray-splat intersection (Huang et al., "2D Gaussian Splatting
for Geometrically Accurate Radiance Fields", SIGGRAPH 2024; gsplat's
``rasterization_2dgs``).

A surfel is a flat disc: centre p, tangent axes t_u, t_v (the first two
columns of its rotation), scales s_u, s_v (the first two of its three).
Per camera (R, t, K) its ray transform is ``T = K [s_u R t_u, s_v R t_v,
R p + t]``, with rows u, v, w: a splat point (a, b) lands at the
homogeneous pixel ``T (a, b, 1)``. Its alpha at a pixel centre (x, y) is
``min(0.999, o exp(-min(a^2 + b^2, 2 |(x, y) - mean2d|^2) / 2))``, where
``(a, b)`` is the pixel ray's intersection with its plane (killed where
the ray lies in the plane, and below 1/255), and ``mean2d`` the centre of
the bounding box of the unit disc's image (gsplat's). The second term is
the paper's object-space low-pass filter (eq. 11).

- ``project_surfels``: per (camera, surfel) ``T``, ``mean2d``, the box
  that holds every pixel with alpha >= 1/255 (``surfel_footprint``), the
  depth (the camera-frame z of the centre,
  which orders and culls), the SH colour at the centre's view direction
  (as for 3D gaussians) and ``valid``. The kernel ``csrc/surfel_project.cu``
  on CUDA tensors that autograd does not record through, the plain
  ``project_surfels_plain`` otherwise;
- the build (``ops.stream_isect``) takes the boxes for membership;
- ``pack_surfel_fields``: the slot-major table of ``SURF_*`` rows (the
  kernel ``csrc/surfel_pack.cu``; ``pack_stream(surfel_field_columns())``
  on the CPU);
- ``surfel_fwd``: the supertile-stream forward with the surfel's alpha
  (the kernel ``csrc/surfel_fwd.cu``; ``surfel_fwd_plain`` on the CPU),
  the stream layout's output [CS, NT, OUT_CH, P].

Forward only: the kernels have no backward, and their wrappers raise
``ValueError`` where autograd records through an input.

Rule for a disc that crosses the camera plane: a surfel is drawn only
where its disc of radius max(1, r), r^2 = 2 ln(255 o), lies wholly in
front of the camera plane (then both discs' images are bounded
ellipses); otherwise it is culled, as it is where o <= 1/255.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from splat_one_tpu_torch.core import sh as shlib
from splat_one_tpu_torch.ops import stream_isect as si
from splat_one_tpu_torch.ops import stream_raster as sr
from splat_one_tpu_torch.ops.projection import _check_cuda, _rotmat_soa, _staged, records_grad
from splat_one_tpu_torch.utils import cuda_build

# Column layout of the surfel's [rows, 16] stream table (64-byte rows).
SURF_X = 0
SURF_Y = 1
SURF_T = 2  # the ray transform's 9 values, rows u, v, w
SURF_OPAC = 11
SURF_RGB = 12  # r, g, b, then the depth
SURF_DEPTH = 15
# The boxes' margin (csrc/surfel_common.cuh's EXT_SCALE, EXT_ABS)
EXT_SCALE = 1.001
EXT_ABS = 0.05


class SurfelProjected(NamedTuple):
    """Per-(camera, surfel) screen quantities. Leading dims [C, N]."""

    means2d: torch.Tensor  # [C, N, 2] the unit disc's box centre
    transforms: torch.Tensor  # [C, N, 9] T's rows u, v, w
    depths: torch.Tensor  # [C, N] camera-frame z of the centre
    boxes: torch.Tensor  # [C, N, 4] centre x, y and half widths x, y
    colors: torch.Tensor  # [C, N, 3]
    opacities: torch.Tensor  # [C, N]
    valid: torch.Tensor  # [C, N] bool


def surfel_footprint(t, opac):
    """``(mx, my, bx, by, rx, ry, dist, dr, r2)`` of surfels with ray
    transforms ``t`` (9 tensors: u0, u1, u2, v0, v1, v2, w0, w1, w2) and
    opacities ``opac``: mean2d; the centre and half widths of the box that
    holds every pixel with alpha >= 1/255 (the r2-disc's image box, from
    the dual conic ``T diag(r2, r2, -1) T^T``, and the filter's circle of
    radius sqrt(r2 / 2) about mean2d, both in one box; its half widths
    widened by ``EXT_SCALE`` and ``EXT_ABS`` for rounding); the unit and
    r2-discs' w-w entries (< 0 where the disc lies wholly in front of the
    camera plane) and ``r2 = 2 ln(255 o)``. The one definition of the
    membership the build, the forward's gate and the kernels
    (``csrc/surfel_common.cuh``) share."""
    u0, u1, u2, v0, v1, v2, w0, w1, w2 = t
    dist = (w0 * w0 + w1 * w1) - w2 * w2
    inv = 1.0 / torch.where(dist == 0, torch.ones_like(dist), dist)
    mx = ((u0 * w0 + u1 * w1) - u2 * w2) * inv
    my = ((v0 * w0 + v1 * w1) - v2 * w2) * inv
    r2 = 2.0 * torch.log(torch.clamp(opac, min=1e-12) * 255.0)
    rc = torch.clamp(r2, min=0.0)
    dr = rc * (w0 * w0 + w1 * w1) - w2 * w2
    invr = 1.0 / torch.where(dr == 0, torch.ones_like(dr), dr)
    cx = (rc * (u0 * w0 + u1 * w1) - u2 * w2) * invr
    cy = (rc * (v0 * w0 + v1 * w1) - v2 * w2) * invr
    hx = torch.sqrt(torch.clamp(cx * cx - (rc * (u0 * u0 + u1 * u1) - u2 * u2) * invr, min=0.0))
    hy = torch.sqrt(torch.clamp(cy * cy - (rc * (v0 * v0 + v1 * v1) - v2 * v2) * invr, min=0.0))
    rf = torch.sqrt(torch.clamp(0.5 * r2, min=0.0))
    x0, x1 = torch.minimum(cx - hx, mx - rf), torch.maximum(cx + hx, mx + rf)
    y0, y1 = torch.minimum(cy - hy, my - rf), torch.maximum(cy + hy, my + rf)
    bx, by = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
    rx = 0.5 * (x1 - x0) * EXT_SCALE + EXT_ABS
    ry = 0.5 * (y1 - y0) * EXT_SCALE + EXT_ABS
    return mx, my, bx, by, rx, ry, dist, dr, r2


def project_surfels_plain(means, quats, scales, opacities, viewmats, Ks, width: int,
                          height: int, sh_coeffs, sh_degree: int, near_plane: float = 0.01,
                          far_plane: float = 1e10) -> SurfelProjected:
    """Project surfels into pinhole cameras: the plain PyTorch version,
    struct-of-arrays over [C, N] (``scales`` [N, 2 or 3]: the first two
    are read; ``sh_coeffs`` [N, K, 3])."""
    m00, m01, _, m10, m11, _, m20, m21, _ = _rotmat_soa(quats)
    su, sv = scales[..., 0], scales[..., 1]
    m00, m10, m20 = m00 * su, m10 * su, m20 * su
    m01, m11, m21 = m01 * sv, m11 * sv, m21 * sv
    mx, my, mz = means[..., 0], means[..., 1], means[..., 2]
    R = [[viewmats[:, i, j, None] for j in range(3)] for i in range(3)]
    t = [viewmats[:, i, 3, None] for i in range(3)]
    px = R[0][0] * mx + R[0][1] * my + R[0][2] * mz + t[0]
    py = R[1][0] * mx + R[1][1] * my + R[1][2] * mz + t[1]
    pz = R[2][0] * mx + R[2][1] * my + R[2][2] * mz + t[2]
    # the tangent axes in the camera frame
    a = [R[i][0] * m00 + R[i][1] * m10 + R[i][2] * m20 for i in range(3)]
    b = [R[i][0] * m01 + R[i][1] * m11 + R[i][2] * m21 for i in range(3)]
    fx, fy = Ks[:, 0, 0, None], Ks[:, 1, 1, None]
    cx, cy = Ks[:, 0, 2, None], Ks[:, 1, 2, None]
    tr = (fx * a[0] + cx * a[2], fx * b[0] + cx * b[2], fx * px + cx * pz,
          fy * a[1] + cy * a[2], fy * b[1] + cy * b[2], fy * py + cy * pz,
          a[2], b[2], pz)
    mx2, my2, bx, by, rx, ry, dist, dr, r2 = surfel_footprint(tr, opacities)
    ok = (pz > near_plane) & (pz < far_plane)
    ok &= (dist < 0) & (dr < 0) & (r2 > 0)
    ok &= (bx + rx > 0) & (bx - rx < width) & (by + ry > 0) & (by - ry < height)
    C, N = px.shape
    Rm = viewmats[:, :3, :3]
    campos = -(Rm.transpose(-1, -2) @ viewmats[:, :3, 3, None])[..., 0]
    dx = mx - campos[:, 0, None]
    dy = my - campos[:, 1, None]
    dz = mz - campos[:, 2, None]
    dn = torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-20)
    dirs = torch.stack([dx / dn, dy / dn, dz / dn], dim=-1)
    coeffs = sh_coeffs.expand((C,) + sh_coeffs.shape)
    col = torch.clamp(shlib.eval_sh(sh_degree, coeffs, dirs) + 0.5, min=0.0)
    return SurfelProjected(torch.stack([mx2, my2], -1), torch.stack(tr, -1), pz,
                           torch.stack([bx, by, rx, ry], -1), col,
                           opacities.expand(C, N), ok)


def _forward_only(*tensors):
    if records_grad(*tensors):
        raise ValueError("autograd records through the inputs: the surfel kernels have no "
                         "backward (2DGS is served forward only on CUDA)")


def project_surfels(means, quats, scales, opacities, viewmats, Ks, width: int, height: int,
                    sh_coeffs, sh_degree: int, near_plane: float = 0.01,
                    far_plane: float = 1e10) -> SurfelProjected:
    """Project surfels: CPU tensors take ``project_surfels_plain``; CUDA
    tensors launch the kernel (``surfel_project``, whose checks raise, on
    inputs staged contiguous and aligned)."""
    args = (means, quats, scales, opacities, viewmats, Ks, width, height, sh_coeffs, sh_degree,
            near_plane, far_plane)
    if means.device.type == "cpu":
        return project_surfels_plain(*args)
    out = surfel_project(*(_staged(t) if torch.is_tensor(t) else t for t in args))
    C, N = out[2].shape
    return SurfelProjected(*out[:5], opacities.expand(C, N), out[5])


_ROWS = 128  # rows a tile of the projection kernel
_MAX_K = 25  # SH coefficients a row the kernel stages (degree 4)


def surfel_project(means, quats, scales, opacities, viewmats, Ks, width: int, height: int,
                   sh_coeffs, sh_degree: int, near_plane: float = 0.01, far_plane: float = 1e10):
    """The kernel (built from ``csrc/surfel_project.cu`` at first use) ->
    ``(means2d [C, N, 2], transforms [C, N, 9], depths, boxes [C, N, 4],
    colors [C, N, 3], valid)``, the plain version's fields. Inputs:
    float32, contiguous, 16-byte aligned, on one CUDA device, none that
    autograd records through (``scales`` [N, 3]); raises ``ValueError`` on
    anything else before the library is loaded."""
    N, C = means.shape[0], viewmats.shape[0]
    nb = (sh_degree + 1) ** 2
    if not 0 <= sh_degree <= shlib.MAX_SH_DEGREE:
        raise ValueError(f"SH degree must be in [0,{shlib.MAX_SH_DEGREE}], got {sh_degree}")
    K = sh_coeffs.shape[1] if sh_coeffs.dim() == 3 else 0
    if not nb <= K <= _MAX_K:
        raise ValueError(f"sh_coeffs must hold {nb} to {_MAX_K} coefficients a row at "
                         f"degree {sh_degree}, got shape {tuple(sh_coeffs.shape)}")
    named = [("means", means, (N, 3)), ("quats", quats, (N, 4)), ("scales", scales, (N, 3)),
             ("opacities", opacities, (N,)), ("viewmats", viewmats, (C, 4, 4)),
             ("Ks", Ks, (C, 3, 3)), ("sh_coeffs", sh_coeffs, (N, K, 3))]
    for name, t, shape in named:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    _forward_only(*(t for _, t, _ in named))
    if N >= 2**31 - _ROWS:
        raise ValueError(f"{N} rows: the kernel indexes rows with 32-bit ints")
    dev = means.device
    _check_cuda(named, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    uv = torch.empty((C, N, 2), **f32)
    tr = torch.empty((C, N, 9), **f32)
    depth = torch.empty((C, N), **f32)
    box = torch.empty((C, N, 4), **f32)
    col = torch.empty((C, N, 3), **f32)
    ok = torch.empty((C, N), dtype=torch.bool, device=dev)
    lib = cuda_build.library("surfel_project")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.surfel_project(
            *(t.data_ptr() for t in (means, quats, scales, opacities, sh_coeffs, viewmats, Ks,
                                     uv, tr, depth, box, col, ok)),
            N, C, K, nb, int(width), int(height), float(near_plane), float(far_plane), stream)
    cuda_build.check(lib, rc, "surfel_project")
    cuda_build.launch_counts["surfel_project"] += 1
    return uv, tr, depth, box, col, ok


def surfel_field_columns(means2d, transforms, opacities, colors, depths) -> torch.Tensor:
    """[M0, 16] table of ``SURF_*`` rows from the [C, N, ...] projection
    outputs: the one definition of the layout the kernels index."""
    C, N = opacities.shape
    M0 = C * N
    return torch.cat([means2d.reshape(M0, 2), transforms.reshape(M0, 9),
                      opacities.reshape(M0, 1), colors.reshape(M0, 3),
                      depths.reshape(M0, 1)], dim=1)


def pack_surfel_fields(proj: SurfelProjected, isect: si.StreamIsect,
                       caps: si.StreamCaps) -> torch.Tensor:
    """[packed_rows, 16] slot-major surfel table: CPU tensors take
    ``si.pack_stream(surfel_field_columns(...))``; other tensors launch the
    kernel (``surfel_pack``), whose checks raise, on contiguous copies."""
    fields = (proj.means2d, proj.transforms, proj.opacities, proj.colors, proj.depths)
    if proj.means2d.device.type == "cpu":
        return si.pack_stream(surfel_field_columns(*fields), isect, caps)
    return surfel_pack(*(t.contiguous() for t in fields), isect.sorted_g.contiguous(), caps)


def surfel_pack(means2d, transforms, opacities, colors, depths, sorted_g,
                caps: si.StreamCaps) -> torch.Tensor:
    """The kernel -> [packed_rows, 16] f32, every row written: row p holds
    slot p's surfel ``sorted_g[p]`` (sentinel ``C * N``: zeros) in the
    ``SURF_*`` layout, the rows past ``exp_cap`` zeros. Inputs: f32 [C, N,
    2], [C, N, 9], [C, N], [C, N, 3], [C, N] and int32 [exp_cap],
    contiguous, on one CUDA device, none that autograd records through;
    raises ``ValueError`` on anything else before the library is loaded."""
    if opacities.dim() != 2:
        raise ValueError(f"opacities must be [C, N], got {tuple(opacities.shape)}")
    C, N = opacities.shape
    named = [("means2d", means2d, (C, N, 2)), ("transforms", transforms, (C, N, 9)),
             ("opacities", opacities, (C, N)), ("colors", colors, (C, N, 3)),
             ("depths", depths, (C, N)), ("sorted_g", sorted_g, (caps.exp_cap,))]
    for name, t, shape in named:
        dtype = torch.int32 if name == "sorted_g" else torch.float32
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"{name} must be contiguous and 8-byte aligned")
    _forward_only(means2d, transforms, opacities, colors, depths)
    dev = means2d.device
    _check_cuda(named, dev)
    if C * N >= 2**31 or caps.packed_rows >= 2**31:
        raise ValueError(f"{C * N} surfels, {caps.packed_rows} rows: the kernel indexes "
                         "them with 32-bit ints")
    packed = torch.empty((caps.packed_rows, si.NF), dtype=torch.float32, device=dev)
    lib = cuda_build.library("surfel_pack")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.surfel_pack(
            sorted_g.data_ptr(), means2d.data_ptr(), transforms.data_ptr(),
            opacities.data_ptr(), colors.data_ptr(), depths.data_ptr(), packed.data_ptr(),
            caps.exp_cap, C * N, caps.packed_rows, stream)
    cuda_build.check(lib, rc, "surfel_pack")
    cuda_build.launch_counts["surfel_pack"] += 1
    return packed


def _surfel_gate(cfg: sr.StreamCfg, chunk, tx, ty, rowmask):
    """Per-(tile, slot) membership [S, NT, G]: the slot belongs to the
    supertile's range and its footprint's box, recomputed from the row's
    T and opacity, covers the tile."""
    t = [chunk[:, None, :, SURF_T + i] for i in range(9)]
    _, _, bx, by, rx, ry, _, _, _ = surfel_footprint(t, chunk[:, None, :, SURF_OPAC])
    return sr.box_gate(cfg, bx, by, rx, ry, tx, ty, rowmask)


def _surfel_alpha(c, px, py):
    """The surfel's unclamped alpha at the pixel centres (px, py) and where
    it is killed (the ray in its plane, sigma < 0, or below 1/255): ``c``
    one slot's row per supertile, [S, NF, 1, 1]."""
    u0, u1, u2, v0, v1, v2, w0, w1, w2 = (c[:, SURF_T + i] for i in range(9))
    hu0, hu1, hu2 = px * w0 - u0, px * w1 - u1, px * w2 - u2
    hv0, hv1, hv2 = py * w0 - v0, py * w1 - v1, py * w2 - v2
    cx = hu1 * hv2 - hu2 * hv1
    cy = hu2 * hv0 - hu0 * hv2
    cz = hu0 * hv1 - hu1 * hv0
    su, sv = cx / cz, cy / cz
    g3 = su * su + sv * sv
    dx = c[:, SURF_X] - px
    dy = c[:, SURF_Y] - py
    g2 = 2.0 * (dx * dx + dy * dy)
    sigma = 0.5 * torch.where(g3 < g2, g3, g2)
    alpha_raw = c[:, SURF_OPAC] * torch.exp(-sigma)
    return alpha_raw, (cz == 0) | (sigma < 0.0) | (alpha_raw < sr.ALPHA_MIN)


def surfel_fwd_plain(cfg: sr.StreamCfg, st_starts: torch.Tensor,
                     packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the surfel forward kernel: the stream walk
    of ``stream_raster.stream_fwd_plain`` with the surfel's gate and alpha
    and the table's colour and depth columns."""
    return sr.walk_plain(cfg, st_starts, packed, _surfel_gate, _surfel_alpha, SURF_RGB)


def surfel_fwd(cfg: sr.StreamCfg, st_starts: torch.Tensor,
               packed: torch.Tensor) -> torch.Tensor:
    """Surfel forward compositing -> [CS, NT, OUT_CH, P] f32 (rgb, alpha,
    accumulated depth, n_chunks). CPU tensors take the plain version; CUDA
    tensors launch the kernel (built from ``csrc/surfel_fwd.cu`` at first
    use), pinhole only, or raise ``ValueError``."""
    if packed.device.type == "cpu":
        return surfel_fwd_plain(cfg, st_starts, packed)
    if cfg.wrap_x or cfg.cs_local:
        raise ValueError("the surfel forward serves whole pinhole grids")
    st_starts, packed = sr._check_kernel_inputs("surfel_fwd", cfg, st_starts, packed)
    _forward_only(packed)
    out = torch.empty((cfg.cs, cfg.nt, sr.OUT_CH, cfg.npix), dtype=torch.float32,
                      device=packed.device)
    lib = cuda_build.library("surfel_fwd")
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.surfel_fwd(st_starts.data_ptr(), packed.data_ptr(), out.data_ptr(), cfg.cs,
                            cfg.sw, cfg.sh, float(cfg.term_thresh), stream)
    cuda_build.check(lib, rc, "surfel_fwd")
    cuda_build.launch_counts["surfel_fwd"] += 1
    return out
