"""Dense reference compositor: the port's in-package numerical oracle.

Counterpart of ``splat_one_tpu/ops/reference.py``: O(N_gauss x N_pix)
front-to-back compositing in plain torch, a Python loop over depth-sorted
chunks of gaussians. Semantics shared with the stream compositor:
  - gaussians composited in increasing depth order,
  - ``alpha = min(opacity * exp(-sigma), ALPHA_MAX)`` with
    ``sigma = 0.5*(a*dx^2 + c*dy^2) + b*dx*dy``,
  - contributions with ``sigma < 0`` or ``alpha < ALPHA_MIN`` are skipped,
  - a gaussian reaches only pixels of the 16 px tiles its opacity-aware
    ellipse bbox covers (``conic_ellipse_radii``),
  - no early termination,
  - the depth channel accumulates ``w_i * depth_i``.
"""

from __future__ import annotations

import torch

from splat_one_tpu_torch.ops.projection import (ALPHA_CUT, Projected,
                                                conic_ellipse_radii)

ALPHA_MIN = ALPHA_CUT  # 1/255
ALPHA_MAX = 0.999


def composite_reference(
    proj: Projected,
    width: int,
    height: int,
    chunk: int = 256,
    wrap_x: bool = False,
    tile_size: int = 16,
):
    """Composite projected gaussians over a full image, per camera.

    Returns rgb ``[C, H, W, D]``, alpha ``[C, H, W, 1]``, depth
    ``[C, H, W, 1]``."""
    C, N = proj.depths.shape
    D = proj.colors.shape[-1]
    dev = proj.depths.device
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :].repeat(height, 1)
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None].repeat(1, width)
    px = px.reshape(-1)
    py = py.reshape(-1)
    TW = -(-width // tile_size)
    TH = -(-height // tile_size)
    ptx = torch.floor(px / tile_size).long()
    pty = torch.floor(py / tile_size).long()

    rgbs, alphas, depths = [], [], []
    for ci in range(C):
        valid = proj.valid[ci]
        key = torch.where(valid, proj.depths[ci], torch.full_like(proj.depths[ci], float("inf")))
        order = torch.argsort(key, stable=True)
        opac = torch.where(valid, proj.opacities[ci], torch.zeros_like(proj.opacities[ci]))[order]
        xy = proj.means2d[ci][order]
        con = proj.conics[ci][order]
        col = proj.colors[ci][order]
        dep = proj.depths[ci][order]

        T = torch.ones(px.shape, dtype=torch.float32, device=dev)
        rgb = torch.zeros(px.shape + (D,), dtype=torch.float32, device=dev)
        dsum = torch.zeros(px.shape + (1,), dtype=torch.float32, device=dev)
        for s in range(0, N, chunk):
            o = opac[s:s + chunk, None]
            u, v = xy[s:s + chunk, 0:1], xy[s:s + chunk, 1:2]
            dx = u - px[None, :]
            if wrap_x:
                dx = dx - width * torch.round(dx * (1.0 / width))
            dy = v - py[None, :]
            a, b, c = con[s:s + chunk, 0:1], con[s:s + chunk, 1:2], con[s:s + chunk, 2:3]
            sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
            alpha = o * torch.exp(-sigma)
            alpha = torch.where(sigma < 0, torch.zeros_like(alpha), alpha)
            alpha = torch.clamp(alpha, max=ALPHA_MAX)
            alpha = torch.where(alpha < ALPHA_MIN, torch.zeros_like(alpha), alpha)
            rx, ry = conic_ellipse_radii(a, b, c, o)
            ty0 = torch.clamp(torch.floor((v - ry) / tile_size), 0, TH)
            ty1 = torch.clamp(torch.ceil((v + ry) / tile_size), 0, TH)
            in_y = (pty[None, :] >= ty0) & (pty[None, :] < ty1)
            if wrap_x:
                tx0 = torch.floor((u - rx) / tile_size)
                tx1 = torch.ceil((u + rx) / tile_size)
                span = torch.clamp(tx1 - tx0, max=TW)
                in_x = torch.remainder(ptx[None, :] - tx0.long(), TW) < span
            else:
                tx0 = torch.clamp(torch.floor((u - rx) / tile_size), 0, TW)
                tx1 = torch.clamp(torch.ceil((u + rx) / tile_size), 0, TW)
                in_x = (ptx[None, :] >= tx0) & (ptx[None, :] < tx1)
            alpha = torch.where(in_x & in_y, alpha, torch.zeros_like(alpha))
            logt = torch.log1p(-alpha)
            cum_excl = torch.cumsum(logt, dim=0) - logt
            w = alpha * torch.exp(cum_excl) * T[None, :]  # [G, P]
            rgb = rgb + w.T @ col[s:s + chunk]
            dsum = dsum + w.T @ dep[s:s + chunk, None]
            T = T * torch.exp(torch.sum(logt, dim=0))
        rgbs.append(rgb.reshape(height, width, D))
        alphas.append((1.0 - T).reshape(height, width, 1))
        depths.append(dsum.reshape(height, width, 1))
    return torch.stack(rgbs), torch.stack(alphas), torch.stack(depths)
