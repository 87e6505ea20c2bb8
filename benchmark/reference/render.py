"""Plain-PyTorch projection and compositing of 3D gaussians.

What it computes, from the published 3DGS model (Kerbl et al. 2023) with
the conventions the measured renderer documents for its output:

- Projection (EWA): camera-frame mean ``p = R_w2c m + t``, 3D covariance
  ``Sigma = R(q) S S R(q)^T``, screen covariance ``J R_w2c Sigma R_w2c^T
  J^T + 0.3 I`` with the camera model's Jacobian; conic = its inverse;
  colours as the model's ``color`` gives them (``max(SH_3(dir) + 0.5, 0)``
  for 3DGS's own).
- A camera model is a file, ``cameras/<name>.py`` (``camera``): its
  ``depth`` (for the near and far test, the order and the expected
  depth), its ``screen`` position, its ``jacobian`` and ``WRAP``, whether
  the image wraps in u (an equirectangular one does).
- A gaussian is kept when its depth lies in (near, far), its screen
  covariance is positive definite and the box of its
  membership ellipse meets the image (only in v where the image wraps).
  The ellipse has ``s = min(3, sqrt(2 ln(255 opacity))) + 1e-3`` sigmas.
- Membership: a gaussian reaches the 16 px tiles, and the 32 px supertiles,
  that the axis-aligned box of that ellipse covers (in u modulo the
  width where the image wraps).
- Order: each supertile lists its gaussians by depth, ties in gaussian
  order; the supertiles' lists follow one another in row-major order and
  are read in chunks of 128 slots aligned to multiples of 128 in that one
  stream.
- Compositing, front to back per pixel: ``alpha = min(o exp(-sigma),
  0.999)`` with ``sigma = (a dx^2 + c dy^2) / 2 + b dx dy``, zero where
  ``sigma < 0`` or the unclamped value is below 1/255. A tile stops at the
  first chunk at whose start every one of its 256 pixels has
  transmittance below 1e-5; until then all its pixels take every gaussian
  of every chunk.
- Output: rgb and depth as sums of ``w_i c_i`` and ``w_i z_i``, alpha = 1 -
  transmittance, expected depth = depth / alpha.

This module follows those rules with dense [tiles, 256 pixels, list]
blocks, so it is exact where a sequential implementation is, up to the
order of floating-point sums. ``needed`` counts the work any renderer of
this model must do, independent of how: the (pixel, gaussian) pairs inside
a gaussian's membership with ``alpha >= 1/255`` that the pixel reaches
while its own transmittance is still at least 1e-5.
"""

from __future__ import annotations

import contextlib
import importlib.util
import os
from typing import Dict, NamedTuple

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
EPS2D = 0.3
TERM_THRESH = 1e-5
TILE = 16
SUPER = 2  # tiles per supertile side
CHUNK = 128
NPIX = TILE * TILE
# (pixel, list entry) elements of one dense block
BLOCK_ELEMS = 1 << 24

_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435)


@contextlib.contextmanager
def precision(name: str):
    """The reference's arithmetic: ``f32`` (TF32 off), ``tf32`` (matmul and
    cuDNN in TF32) or ``bf16`` (bfloat16 tensors); yields the dtype."""
    if name not in ("f32", "tf32", "bf16"):
        raise ValueError(f"unknown precision {name!r}")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = name == "tf32"
    try:
        yield torch.bfloat16 if name == "bf16" else torch.float32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def alpha_max(dtype) -> float:
    """``ALPHA_MAX``, or the largest number below 1 that ``dtype`` holds
    where it cannot hold 0.999 (bfloat16 rounds it to 1, and a transmittance
    of 0 then gives log(0))."""
    return min(ALPHA_MAX, 1.0 - torch.finfo(dtype).eps / 2)


def activate(raw: Dict[str, torch.Tensor]):
    """Stored geometry (log scales, logit opacities) -> render values."""
    return dict(means=raw["means"], quats=raw["quats"], scales=torch.exp(raw["scales"]),
                opacities=torch.sigmoid(raw["opacities"]))


def sh_basis3(d: torch.Tensor) -> torch.Tensor:
    """Real SH basis of degree 3 at unit directions [N, 3] -> [N, 16]."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    c2, c3 = _SH_C2, _SH_C3
    return torch.stack([
        torch.full_like(x, _SH_C0),
        -_SH_C1 * y, _SH_C1 * z, -_SH_C1 * x,
        c2[0] * x * y, c2[1] * y * z, c2[2] * (2 * zz - xx - yy), c2[3] * x * z,
        c2[4] * (xx - yy),
        c3[0] * y * (3 * xx - yy), c3[1] * x * y * z, c3[2] * y * (4 * zz - xx - yy),
        c3[3] * z * (2 * zz - 3 * xx - 3 * yy), c3[4] * x * (4 * zz - xx - yy),
        c3[5] * z * (xx - yy), c3[6] * x * (xx - 3 * yy),
    ], dim=-1)


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def opacity_extent(o: torch.Tensor) -> torch.Tensor:
    s2 = 2.0 * torch.log(torch.clamp(o, min=1e-12) * 255.0)
    return torch.clamp(torch.sqrt(torch.clamp(s2, min=0.0)) + 1e-3, max=3.0)


def ellipse_extents(conic: torch.Tensor, o: torch.Tensor):
    """Half-extents of the membership ellipse's box from the conic."""
    a, b, c = conic.unbind(-1)
    inv = 1.0 / torch.clamp(a * c - b * b, min=1e-30)
    s = opacity_extent(o)
    return (s * torch.sqrt(torch.clamp(c * inv, min=0.0)),
            s * torch.sqrt(torch.clamp(a * inv, min=0.0)))


class Proj(NamedTuple):
    uv: torch.Tensor  # [N, 2]
    conic: torch.Tensor  # [N, 3]
    opac: torch.Tensor  # [N]
    color: torch.Tensor  # [N, 3]
    depth: torch.Tensor  # [N]
    valid: torch.Tensor  # [N] bool


def world_to_camera(c2w) -> tuple:
    """(R [3, 3], t [3]) of the world-to-camera map, in float64."""
    c2w = torch.as_tensor(c2w, dtype=torch.float64)
    R = c2w[:3, :3].T
    return R, -R @ c2w[:3, 3]


CAMERAS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cameras")


def camera(name: str, folder: str = CAMERAS):
    """The camera model ``<folder>/<name>.py``."""
    path = os.path.join(folder, name + ".py")
    if not os.path.exists(path):
        raise ValueError(f"camera model {name!r} is not in the reference")
    spec = importlib.util.spec_from_file_location("benchmark_camera_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def project(act, c2w, K, width: int, height: int, cam, color, near: float = 0.01,
            far: float = 1e10, dtype=torch.float32) -> Proj:
    """Screen-space gaussians in one camera: ``cam`` a camera model
    (``camera``), ``color(act, front, dirs, dtype)`` the colour of the
    rows ``front`` seen along the unit directions ``dirs``."""
    dev = act["means"].device
    cast = lambda x: x.to(dtype)
    means, quats, scales, opac = (cast(act[k]) for k in ("means", "quats", "scales",
                                                          "opacities"))
    R64, t64 = world_to_camera(c2w)
    R = R64.to(dev, dtype)
    t = t64.to(dev, dtype)
    K = torch.as_tensor(K, dtype=torch.float64)
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
    p = means @ R.T + t
    x, y, z = p.unbind(-1)
    depth_all = cam.depth(x, y, z)
    # only gaussians inside (near, far) go on: the rest are culled before
    # their Jacobians (at z near 0) are formed
    front = torch.nonzero((depth_all > near) & (depth_all < far))[:, 0].detach()
    n_all = means.shape[0]
    p, quats, scales, opac_f = p[front], quats[front], scales[front], opac[front]
    x, y, z = p.unbind(-1)
    M = quat_rotmat(quats) * scales[:, None, :]
    sigma3 = M @ M.transpose(1, 2)
    J = cam.jacobian(x, y, z, fx, fy, width, height)
    depth = cam.depth(x, y, z)
    u, v = cam.screen(x, y, z, fx, fy, cx, cy, width, height)
    T = J @ R
    cov = T @ sigma3 @ T.transpose(1, 2)
    a = cov[:, 0, 0] + EPS2D
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + EPS2D
    det = a * c - b * b
    inv = 1.0 / torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    radius = 3.0 * torch.sqrt(torch.clamp(mid + torch.sqrt(torch.clamp(mid * mid - det,
                                                                      min=0.01)), min=0.0))
    ext = opacity_extent(opac_f)
    rx = ext * torch.sqrt(torch.clamp(a, min=0.0))
    ry = ext * torch.sqrt(torch.clamp(c, min=0.0))
    ok = (det > 0) & (radius > 0) & (v + ry > 0) & (v - ry < height)
    if not cam.WRAP:
        ok &= (u + rx > 0) & (u - rx < width)
    campos = torch.as_tensor(c2w, dtype=torch.float64)[:3, 3].to(dev, dtype)
    d = means[front] - campos
    d = d / torch.sqrt(torch.sum(d * d, -1, keepdim=True) + 1e-20)
    col = color(act, front, d, dtype)

    def full(x, fill=0.0):
        out = torch.full((n_all,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev)
        return out.index_put((front,), x)

    valid = torch.zeros(n_all, dtype=torch.bool, device=dev)
    valid[front] = ok.detach()
    return Proj(full(torch.stack([u, v], -1)), full(conic), full(opac_f), full(col),
                full(depth, -1.0), valid)


class Lists(NamedTuple):
    """Per-tile lists: entry e is gaussian ``g[e]`` in tile ``tile[e]`` at
    chunk ``chunk[e]`` of its supertile; entries of a tile are contiguous,
    in stream order, from ``start[t]`` for ``length[t]``."""

    g: torch.Tensor
    chunk: torch.Tensor
    start: torch.Tensor
    length: torch.Tensor
    n_isect: int  # (gaussian, supertile) slots
    longest_supertile: int
    visible: int  # gaussians with at least one tile


def grid(width: int, height: int):
    tw, th = -(-width // TILE), -(-height // TILE)
    return tw, th, -(-tw // SUPER), -(-th // SUPER)


@torch.no_grad()
def build_lists(proj: Proj, width: int, height: int, wrap: bool) -> Lists:
    """Membership, stream order and chunks of every (gaussian, tile)."""
    dev = proj.depth.device
    tw, th, sw, sh = grid(width, height)
    u, v = proj.uv[:, 0].float(), proj.uv[:, 1].float()
    rx, ry = ellipse_extents(proj.conic.float(), proj.opac.float())
    sps = float(TILE * SUPER)
    sy0 = torch.clamp(torch.floor((v - ry) / sps), 0, sh).long()
    span_y = torch.clamp(torch.clamp(torch.ceil((v + ry) / sps), 0, sh).long() - sy0, min=0)
    if wrap:
        sx0 = torch.floor((u - rx) / sps).long()
        span_x = torch.clamp(torch.ceil((u + rx) / sps).long() - sx0, max=sw)
        sx0 = torch.remainder(sx0, sw)
    else:
        sx0 = torch.clamp(torch.floor((u - rx) / sps), 0, sw).long()
        span_x = torch.clamp(torch.clamp(torch.ceil((u + rx) / sps), 0, sw).long() - sx0, min=0)
    counts = torch.where(proj.valid, span_x * span_y, torch.zeros_like(span_x))
    n = int(counts.sum())
    gs = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts)
    offsets = torch.cumsum(counts, 0) - counts
    local = torch.arange(n, device=dev) - offsets[gs]
    spx = torch.clamp(span_x[gs], min=1)
    stx = sx0[gs] + torch.remainder(local, spx)
    if wrap:
        stx = torch.remainder(stx, sw)
    sty = sy0[gs] + torch.div(local, spx, rounding_mode="floor")
    del local, spx
    dbits = proj.depth.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    key = ((sty * sw + stx) << 32) | dbits[gs]
    del stx, sty
    key, order = torch.sort(key, stable=True)
    gs = gs[order]
    st = key >> 32
    del key, order
    st_starts = torch.searchsorted(st, torch.arange(sw * sh + 1, device=dev))
    longest = int((st_starts[1:] - st_starts[:-1]).max()) if n else 0
    base0 = torch.div(st_starts[:-1], CHUNK, rounding_mode="floor") * CHUNK
    chunk_of_slot = torch.div(torch.arange(n, device=dev) - base0[st], CHUNK,
                              rounding_mode="floor")
    # the four tiles of each slot's supertile, gated by the ellipse's box
    j = torch.arange(SUPER * SUPER, device=dev)
    tx = (torch.remainder(st, sw) * SUPER)[:, None] + j % SUPER
    ty = (torch.div(st, sw, rounding_mode="floor") * SUPER)[:, None] + j // SUPER
    xs, ys = u[gs][:, None], v[gs][:, None]
    erx, ery = rx[gs][:, None], ry[gs][:, None]
    txf, tyf = tx.float(), ty.float()
    ts = float(TILE)
    in_y = (tyf >= torch.floor((ys - ery) / ts)) & (tyf < torch.ceil((ys + ery) / ts))
    if wrap:
        tx0 = torch.floor((xs - erx) / ts)
        span = torch.clamp(torch.ceil((xs + erx) / ts) - tx0, max=float(tw))
        in_x = torch.remainder(txf - tx0, float(tw)) < span
    else:
        in_x = (txf >= torch.floor((xs - erx) / ts)) & (txf < torch.ceil((xs + erx) / ts))
    keep = in_x & in_y & (tx < tw) & (ty < th)
    del in_x, in_y, xs, ys, erx, ery, txf, tyf
    slot_i, j_i = torch.nonzero(keep, as_tuple=True)
    tile = ty[slot_i, j_i] * tw + tx[slot_i, j_i]
    tile, order = torch.sort(tile, stable=True)
    slot_i = slot_i[order]
    length = torch.bincount(tile, minlength=tw * th)
    start = torch.cumsum(length, 0) - length
    g_e = gs[slot_i]
    visible = int(torch.unique(g_e).numel())
    return Lists(g_e, chunk_of_slot[slot_i], start, length, n, longest, visible)


def _blocks(length: torch.Tensor, elems: int):
    """Tiles in blocks of similar list length: (tile ids, longest list)."""
    lens = length.cpu()
    order = torch.argsort(lens, descending=True)
    lens = lens[order]
    i, n = 0, int((lens > 0).sum())
    while i < n:
        L = int(lens[i])
        k = max(1, elems // (NPIX * L))
        yield order[i:i + k], L
        i += k


def _tile_pixels(tiles: torch.Tensor, tw: int, dtype):
    local = torch.arange(NPIX, device=tiles.device)
    tx, ty = tiles % tw, torch.div(tiles, tw, rounding_mode="floor")
    px = (tx[:, None] * TILE + local % TILE).to(dtype) + 0.5
    py = (ty[:, None] * TILE + torch.div(local, TILE, rounding_mode="floor")).to(dtype) + 0.5
    return px, py


def _composite_block(fields, lists: Lists, tiles, L, width, height, wrap, dtype):
    """One block of tiles -> (rgb [T, P, 3], depth [T, P], final T [T, P],
    needed pairs of each pixel [T, P], 0 outside the image)."""
    uv, conic, opac, color, depth = fields
    dev = uv.device
    tw, _, _, _ = grid(width, height)
    tiles = tiles.to(dev)
    idx = lists.start[tiles][:, None] + torch.arange(L, device=dev)
    pad = torch.arange(L, device=dev)[None, :] >= lists.length[tiles][:, None]
    idx = torch.where(pad, torch.zeros_like(idx), idx)
    g = lists.g[idx]
    ck = torch.where(pad, torch.full_like(idx, -1), lists.chunk[idx])
    px, py = _tile_pixels(tiles, tw, dtype)
    dx = uv[g][:, None, :, 0] - px[:, :, None]
    if wrap:
        dx = dx - width * torch.round(dx * (1.0 / width))
    dy = uv[g][:, None, :, 1] - py[:, :, None]
    cg = conic[g]
    sig = 0.5 * (cg[:, None, :, 0] * dx * dx + cg[:, None, :, 2] * dy * dy) \
        + cg[:, None, :, 1] * dx * dy
    # sigma < 0 is killed below; clamped here so exp cannot overflow
    araw = opac[g][:, None, :] * torch.exp(-torch.clamp(sig, min=0.0))
    kill = (sig < 0) | (araw < ALPHA_MIN) | pad[:, None, :]
    alpha = torch.where(kill, torch.zeros_like(araw), torch.clamp(araw, max=alpha_max(dtype)))
    logt = torch.log1p(-alpha)
    cum = torch.cumsum(logt, -1)
    t_excl = torch.exp(cum - logt)
    # transmittance at the start of each entry's chunk decides the tile
    pos = torch.arange(L, device=dev).expand_as(ck)
    first = torch.cat([torch.ones_like(ck[:, :1], dtype=torch.bool),
                       ck[:, 1:] != ck[:, :-1]], 1)
    first = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 1).values
    t_chunk = torch.gather(t_excl, 2, first[:, None, :].expand_as(t_excl))
    live = (t_chunk.amax(1) >= TERM_THRESH) & ~pad
    inside = ((px < width) & (py < height))[:, :, None]
    needed = torch.sum((alpha > 0) & (t_excl >= TERM_THRESH) & inside, -1)
    livef = live[:, None, :].to(dtype)
    w = alpha * t_excl * livef
    rgb = torch.einsum("tpl,tlc->tpc", w, color[g])
    dep = torch.einsum("tpl,tl->tp", w, depth[g])
    t_final = torch.exp(torch.sum(logt * livef, -1))
    return rgb, dep, t_final, needed


def _to_image(x: torch.Tensor, width: int, height: int):
    """[TW * TH, P, ...] tile-major -> [H, W, ...]."""
    tw, th, _, _ = grid(width, height)
    rest = x.shape[2:]
    x = x.reshape(th, tw, TILE, TILE, *rest).transpose(1, 2)
    return x.reshape(th * TILE, tw * TILE, *rest)[:height, :width]


class Render(NamedTuple):
    rgb: torch.Tensor  # [H, W, 3]
    alpha: torch.Tensor  # [H, W, 1]
    depth: torch.Tensor  # [H, W, 1] expected depth
    needed: int
    n_isect: int
    longest_supertile: int
    visible: int
    needed_px: torch.Tensor  # [H, W] needed pairs of each pixel


@torch.no_grad()
def composite(proj: Proj, lists: Lists, width: int, height: int, wrap: bool,
              dtype=torch.float32, elems: int = BLOCK_ELEMS) -> Render:
    """The image of ``proj``, in blocks of tiles of about ``elems``
    (pixel, list entry) elements."""
    tw, th, _, _ = grid(width, height)
    dev = proj.depth.device
    fields = (proj.uv, proj.conic, proj.opac, proj.color, proj.depth)
    rgb = torch.zeros((tw * th, NPIX, 3), device=dev, dtype=dtype)
    dep = torch.zeros((tw * th, NPIX), device=dev, dtype=dtype)
    tfin = torch.ones((tw * th, NPIX), device=dev, dtype=dtype)
    needed = torch.zeros((tw * th, NPIX), device=dev, dtype=torch.int64)
    for tiles, L in _blocks(lists.length, elems):
        td = tiles.to(dev)
        rgb[td], dep[td], tfin[td], needed[td] = _composite_block(fields, lists, tiles, L, width,
                                                                  height, wrap, dtype)
    alpha = 1.0 - tfin
    ed = dep / torch.clamp(alpha, min=1e-10)
    return Render(_to_image(rgb, width, height), _to_image(alpha[..., None], width, height),
                  _to_image(ed[..., None], width, height), int(needed.sum()),
                  lists.n_isect, lists.longest_supertile, lists.visible,
                  _to_image(needed, width, height))


@torch.no_grad()
def render(act, c2w, K, width: int, height: int, cam, color, near: float = 0.01,
           far: float = 1e10, dtype=torch.float32, elems: int = BLOCK_ELEMS) -> Render:
    """Forward render of one view (``project``'s arguments)."""
    proj = project(act, c2w, K, width, height, cam, color, near, far, dtype=dtype)
    lists = build_lists(proj, width, height, cam.WRAP)
    return composite(proj, lists, width, height, cam.WRAP, dtype=dtype, elems=elems)
