"""Plain-PyTorch forward render of 2D Gaussian Splatting's surfels.

What it computes, from the 2DGS paper (Huang, Yu, Chen, Geiger, Gao,
SIGGRAPH 2024, arXiv:2403.17888) and gsplat's ``rasterization_2dgs`` (its
names below), written out here again from the model's own rows:

- A surfel: centre p, tangent axes t_u, t_v (the first two columns of
  R(q)), scales s_u, s_v (the first two scale columns).
- Projection: ``T = K [s_u R_cw t_u, s_v R_cw t_v, R_cw p + t_cw]`` (3x3,
  rows u_M, v_M, w_M). With ``f = (1, 1, -1) / sum((1, 1, -1) w_M^2)``,
  ``mean2d = (sum f u_M w_M, sum f v_M w_M)``. Depth: the camera-frame z
  of p, for the near and far test, the order and the expected depth.
  Colour: the model's ``color`` at the centre's view direction.
- Per pixel centre (x, y): ``h_u = x w_M - u_M``, ``h_v = y w_M - v_M``,
  ``c = h_u x h_v``, skipped where ``c_z = 0``, ``(a, b) = (c_x, c_y) /
  c_z``; ``G3 = a^2 + b^2``, ``G2 = 2 |(x, y) - mean2d|^2``,
  ``alpha = min(0.999, o exp(-min(G3, G2) / 2))``, skipped below 1/255.
- Compositing, front to back per pixel in the port's stream order and
  tile stop (``render.py``'s rules: supertile lists by depth, chunks of
  128, a tile stops at the first chunk at whose start all its pixels have
  transmittance below 1e-5); rgb and depth as sums of ``w_i c_i`` and
  ``w_i z_i``, alpha = 1 - transmittance, expected depth = depth / alpha.

Support and membership. alpha >= 1/255 only where ``min(G3, G2) <= r2 =
2 ln(255 o)``: the image of the disc ``a^2 + b^2 <= r2`` (its bounding box
from the dual conic ``T diag(r2, r2, -1) T^T``: centre ``C02 / C22``, half
width ``sqrt(centre^2 - C00 / C22)``, and so in y) and the circle of
radius ``sqrt(r2 / 2)`` about mean2d. A surfel reaches the tiles of the
box that holds both, its half widths widened by 0.1 % and 0.05 px for
rounding. The pairs are evaluated exhaustively over that support.

Departures from gsplat, each kept alike in the port:

- ED depth: each surfel's centre depth is accumulated (gsplat's
  ``rasterization_2dgs`` appends its projection's ``depths`` to the
  colours for ``RGB+ED``); the 2DGS paper's rasterizer uses the
  per-pixel intersection depth ``a w_M.x + b w_M.y + w_M.z``;
- extents: gsplat's square of 3 x the unit disc's largest half extent
  cuts pixels with alpha >= 1/255 (sqrt(2 ln 255) = 3.33 > 3); here the
  union box above holds them all;
- a disc crossing the camera plane: gsplat culls only where ``sum((1, 1,
  -1) w_M^2) = 0``; here a surfel is drawn only where its disc of radius
  max(1, r) lies wholly in front of the camera plane (both conics' w-w
  entries negative), and o > 1/255;
- termination: the port's tile stop at 1e-5 (gsplat stops each pixel at
  1e-4).

``needed`` counts the (pixel, surfel) pairs with alpha >= 1/255 inside the
image that the pixel reaches with transmittance at least 1e-5; ``visible``
the surfels that reach a tile. ``camera``, ``precision`` and ``render``
have ``render.py``'s signatures; it imports nothing of the measured
package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import render as R

precision = R.precision
CHUNK, NPIX, TILE, SUPER = R.CHUNK, R.NPIX, R.TILE, R.SUPER
# (pixel, list entry) elements of one dense block: each holds ~30 floats
BLOCK_ELEMS = 1 << 22
EXT_SCALE, EXT_ABS = 1.001, 0.05  # the boxes' widening for rounding


def camera(name: str, folder: str = R.CAMERAS):
    """The camera model ``<folder>/<name>.py``: pinhole alone (2DGS's
    projection is a pinhole's K)."""
    if name != "pinhole":
        raise ValueError(f"2DGS is rendered through pinhole cameras, not {name!r}")
    return R.camera(name, folder)


class Surfels(NamedTuple):
    T: torch.Tensor  # [N, 3, 3] rows u_M, v_M, w_M
    mean2d: torch.Tensor  # [N, 2]
    box: torch.Tensor  # [N, 4] the support's box: centre x, y, half widths x, y
    opac: torch.Tensor  # [N]
    color: torch.Tensor  # [N, 3]
    depth: torch.Tensor  # [N]
    valid: torch.Tensor  # [N] bool


def _dual_box(T: torch.Tensor, d: torch.Tensor):
    """Bounding box (centre [N, 2], half widths [N, 2], w-w entry [N]) of
    the image of the conic whose dual is ``T diag(d) T^T`` (``d`` [N, 3])."""
    u, v, w = T[:, 0], T[:, 1], T[:, 2]
    cww = torch.sum(d * w * w, -1)
    inv = 1.0 / torch.where(cww == 0, torch.ones_like(cww), cww)
    cu = torch.sum(d * u * w, -1) * inv
    cv = torch.sum(d * v * w, -1) * inv
    hu = torch.sqrt(torch.clamp(cu * cu - torch.sum(d * u * u, -1) * inv, min=0.0))
    hv = torch.sqrt(torch.clamp(cv * cv - torch.sum(d * v * v, -1) * inv, min=0.0))
    return torch.stack([cu, cv], -1), torch.stack([hu, hv], -1), cww


def project(act, c2w, K, width: int, height: int, cam, color, near: float = 0.01,
            far: float = 1e10, dtype=torch.float32) -> Surfels:
    """The surfels of ``act`` in one pinhole camera, in ``dtype``."""
    if cam.WRAP:
        raise ValueError("2DGS is rendered through pinhole cameras")
    dev = act["means"].device
    means, quats, scales, opac = (act[k].to(dtype) for k in ("means", "quats", "scales",
                                                           "opacities"))
    R64, t64 = R.world_to_camera(c2w)
    Rc, t = R64.to(dev, dtype), t64.to(dev, dtype)
    Kt = torch.as_tensor(K, dtype=torch.float64).to(dev, dtype)
    rot = R.quat_rotmat(quats)
    tu = rot[:, :, 0] * scales[:, 0:1]
    tv = rot[:, :, 1] * scales[:, 1:2]
    p = means @ Rc.T + t
    M = torch.stack([tu @ Rc.T, tv @ Rc.T, p], -1)  # columns
    T = Kt @ M
    n = means.shape[0]
    one = torch.ones(n, device=dev, dtype=dtype)
    mean2d, _, dist = _dual_box(T, torch.stack([one, one, -one], -1))
    r2 = 2.0 * torch.log(torch.clamp(opac, min=1e-12) * 255.0)
    rc = torch.clamp(r2, min=0.0)
    centre, half, dr = _dual_box(T, torch.stack([rc, rc, -one], -1))
    rf = torch.sqrt(torch.clamp(0.5 * r2, min=0.0))[:, None]
    lo = torch.minimum(centre - half, mean2d - rf)
    hi = torch.maximum(centre + half, mean2d + rf)
    box = torch.cat([0.5 * (lo + hi), 0.5 * (hi - lo) * EXT_SCALE + EXT_ABS], -1)
    lo, hi = box[:, :2] - box[:, 2:], box[:, :2] + box[:, 2:]
    depth = p[:, 2]
    valid = ((depth > near) & (depth < far) & (dist < 0) & (dr < 0) & (r2 > 0)
             & (hi[:, 0] > 0) & (lo[:, 0] < width) & (hi[:, 1] > 0) & (lo[:, 1] < height))
    col = torch.zeros((n, 3), device=dev, dtype=dtype)
    front = torch.nonzero(valid)[:, 0]
    campos = torch.as_tensor(c2w, dtype=torch.float64)[:3, 3].to(dev, dtype)
    dvec = means[front] - campos
    dvec = dvec / torch.sqrt(torch.sum(dvec * dvec, -1, keepdim=True) + 1e-20)
    col[front] = color(act, front, dvec, dtype).to(dtype)
    return Surfels(T, mean2d, box, opac, col, depth, valid)


class Lists(NamedTuple):
    """Per-tile lists in stream order (``render.Lists``' fields)."""

    g: torch.Tensor
    chunk: torch.Tensor
    start: torch.Tensor
    length: torch.Tensor
    n_isect: int
    visible: int


@torch.no_grad()
def build_lists(s: Surfels, width: int, height: int) -> Lists:
    """Membership (the surfel's box), stream order and chunks of every
    (surfel, tile): ``render.build_lists``' rules over the surfels' boxes."""
    dev = s.depth.device
    tw, th, sw, sh = R.grid(width, height)
    u, v, rx, ry = s.box.float().unbind(-1)
    sps = float(TILE * SUPER)
    sx0 = torch.clamp(torch.floor((u - rx) / sps), 0, sw).long()
    span_x = torch.clamp(torch.clamp(torch.ceil((u + rx) / sps), 0, sw).long() - sx0, min=0)
    sy0 = torch.clamp(torch.floor((v - ry) / sps), 0, sh).long()
    span_y = torch.clamp(torch.clamp(torch.ceil((v + ry) / sps), 0, sh).long() - sy0, min=0)
    counts = torch.where(s.valid, span_x * span_y, torch.zeros_like(span_x))
    n = int(counts.sum())
    gs = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts)
    local = torch.arange(n, device=dev) - (torch.cumsum(counts, 0) - counts)[gs]
    spx = torch.clamp(span_x[gs], min=1)
    stx = sx0[gs] + torch.remainder(local, spx)
    sty = sy0[gs] + torch.div(local, spx, rounding_mode="floor")
    dbits = s.depth.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    key, order = torch.sort(((sty * sw + stx) << 32) | dbits[gs], stable=True)
    gs = gs[order]
    st = key >> 32
    st_starts = torch.searchsorted(st, torch.arange(sw * sh + 1, device=dev))
    base0 = torch.div(st_starts[:-1], CHUNK, rounding_mode="floor") * CHUNK
    chunk_of_slot = torch.div(torch.arange(n, device=dev) - base0[st], CHUNK,
                              rounding_mode="floor")
    j = torch.arange(SUPER * SUPER, device=dev)
    tx = (torch.remainder(st, sw) * SUPER)[:, None] + j % SUPER
    ty = (torch.div(st, sw, rounding_mode="floor") * SUPER)[:, None] + j // SUPER
    ts = float(TILE)
    xs, ys, erx, ery = u[gs][:, None], v[gs][:, None], rx[gs][:, None], ry[gs][:, None]
    txf, tyf = tx.float(), ty.float()
    keep = ((txf >= torch.floor((xs - erx) / ts)) & (txf < torch.ceil((xs + erx) / ts))
            & (tyf >= torch.floor((ys - ery) / ts)) & (tyf < torch.ceil((ys + ery) / ts))
            & (tx < tw) & (ty < th))
    slot_i, j_i = torch.nonzero(keep, as_tuple=True)
    tile, order = torch.sort(ty[slot_i, j_i] * tw + tx[slot_i, j_i], stable=True)
    slot_i = slot_i[order]
    length = torch.bincount(tile, minlength=tw * th)
    g_e = gs[slot_i]
    return Lists(g_e, chunk_of_slot[slot_i], torch.cumsum(length, 0) - length, length, n,
                 int(torch.unique(g_e).numel()))


def _composite_block(s: Surfels, lists: Lists, tiles, L, width, height, dtype):
    """One block of tiles -> (rgb [T, P, 3], depth [T, P], final T [T, P],
    needed pairs of each pixel [T, P])."""
    dev = s.depth.device
    tw = R.grid(width, height)[0]
    tiles = tiles.to(dev)
    idx = lists.start[tiles][:, None] + torch.arange(L, device=dev)
    pad = torch.arange(L, device=dev)[None, :] >= lists.length[tiles][:, None]
    idx = torch.where(pad, torch.zeros_like(idx), idx)
    g = lists.g[idx]
    ck = torch.where(pad, torch.full_like(idx, -1), lists.chunk[idx])
    px, py = R._tile_pixels(tiles, tw, dtype)
    px, py = px[:, :, None], py[:, :, None]
    T = s.T[g]  # [T, L, 3, 3]
    u, v, w = (T[:, None, :, i] for i in range(3))  # [T, 1, L, 3]
    hu = px[..., None] * w - u
    hv = py[..., None] * w - v
    cx = hu[..., 1] * hv[..., 2] - hu[..., 2] * hv[..., 1]
    cy = hu[..., 2] * hv[..., 0] - hu[..., 0] * hv[..., 2]
    cz = hu[..., 0] * hv[..., 1] - hu[..., 1] * hv[..., 0]
    del hu, hv
    zero_z = cz == 0
    cz = torch.where(zero_z, torch.ones_like(cz), cz)
    g3 = (cx / cz) ** 2 + (cy / cz) ** 2
    del cx, cy, cz
    m = s.mean2d[g]
    g2 = 2.0 * ((m[:, None, :, 0] - px) ** 2 + (m[:, None, :, 1] - py) ** 2)
    sigma = 0.5 * torch.minimum(g3, g2)
    del g3, g2
    araw = s.opac[g][:, None, :] * torch.exp(-torch.clamp(sigma, min=0.0))
    kill = zero_z | (sigma < 0) | (araw < R.ALPHA_MIN) | pad[:, None, :]
    alpha = torch.where(kill, torch.zeros_like(araw), torch.clamp(araw, max=R.alpha_max(dtype)))
    del araw, kill, sigma, zero_z
    logt = torch.log1p(-alpha)
    cum = torch.cumsum(logt, -1)
    t_excl = torch.exp(cum - logt)
    pos = torch.arange(L, device=dev).expand_as(ck)
    first = torch.cat([torch.ones_like(ck[:, :1], dtype=torch.bool), ck[:, 1:] != ck[:, :-1]], 1)
    first = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 1).values
    t_chunk = torch.gather(t_excl, 2, first[:, None, :].expand_as(t_excl))
    live = (t_chunk.amax(1) >= R.TERM_THRESH) & ~pad
    inside = ((px < width) & (py < height))
    needed = torch.sum((alpha > 0) & (t_excl >= R.TERM_THRESH) & inside, -1)
    wgt = alpha * t_excl * live[:, None, :].to(dtype)
    rgb = torch.einsum("tpl,tlc->tpc", wgt, s.color[g])
    dep = torch.einsum("tpl,tl->tp", wgt, s.depth[g])
    t_final = torch.exp(torch.sum(logt * live[:, None, :].to(dtype), -1))
    return rgb, dep, t_final, needed


@torch.no_grad()
def composite(s: Surfels, lists: Lists, width: int, height: int, dtype=torch.float32,
              elems: int = BLOCK_ELEMS) -> R.Render:
    """The image of the surfels ``s``, in blocks of tiles of about
    ``elems`` (pixel, list entry) elements."""
    tw, th, _, _ = R.grid(width, height)
    dev = s.depth.device
    rgb = torch.zeros((tw * th, NPIX, 3), device=dev, dtype=dtype)
    dep = torch.zeros((tw * th, NPIX), device=dev, dtype=dtype)
    tfin = torch.ones((tw * th, NPIX), device=dev, dtype=dtype)
    needed = torch.zeros((tw * th, NPIX), device=dev, dtype=torch.int64)
    for tiles, L in R._blocks(lists.length, elems):
        td = tiles.to(dev)
        rgb[td], dep[td], tfin[td], needed[td] = _composite_block(s, lists, tiles, L, width,
                                                                  height, dtype)
    alpha = 1.0 - tfin
    ed = dep / torch.clamp(alpha, min=1e-10)
    return R.Render(R._to_image(rgb, width, height),
                    R._to_image(alpha[..., None], width, height),
                    R._to_image(ed[..., None], width, height), int(needed.sum()),
                    lists.n_isect, 0, lists.visible, R._to_image(needed, width, height))


@torch.no_grad()
def render(act, c2w, K, width: int, height: int, cam, color, near: float = 0.01,
           far: float = 1e10, dtype=torch.float32, elems: int = BLOCK_ELEMS) -> R.Render:
    """Forward render of one view (``project``'s arguments), as
    ``render.render`` returns it (``longest_supertile`` not counted: 0)."""
    s = project(act, c2w, K, width, height, cam, color, near, far, dtype=dtype)
    return composite(s, build_lists(s, width, height), width, height, dtype=dtype,
                     elems=elems)
