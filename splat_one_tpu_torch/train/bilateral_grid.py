"""Learnable per-view bilateral grids for exposure and colour correction:
counterpart of ``splat_one_tpu/train/bilateral_grid.py``.

Each training view owns a low-resolution 3-D grid (x, y, gray guidance)
of 3x4 colour affines; a rendered pixel is transformed by the affine
sliced trilinearly at its position and gray value (``slice_grid``, with
``total_variation_loss`` as the grid's regulariser). Also the low-rank
4-D variant sliced by world position (``init_cp4d``, ``slice_cp4d``,
``apply_cp4d``, ``total_variation_loss_cp4d``) and the per-channel
quadratic ``color_correct`` that ``Trainer.eval`` uses for ``cc_psnr``.
Slicing is gathers and lerps in PyTorch: no kernel of its own.
"""

from __future__ import annotations

import math

import torch

# fixed RGB -> gray guidance weights (ITU-R BT.601)
_GRAY = (0.299, 0.587, 0.114)
_IDENTITY = (1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0)


def _gray_w(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_GRAY, dtype=x.dtype, device=x.device)


def init_bilateral_grids(n_images: int, shape=(16, 16, 8), device="cpu") -> torch.Tensor:
    """``[n_images, gz, gy, gx, 12]`` identity affines (``shape`` is
    (gx, gy, gz))."""
    gx, gy, gz = shape
    ident = torch.tensor(_IDENTITY, dtype=torch.float32, device=device)
    return ident.repeat(n_images, gz, gy, gx, 1)


def slice_grid(grids: torch.Tensor,  # [B, gz, gy, gx, 12]
               rgb: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3] in [0, 1]
    """Apply the per-pixel affines sliced at (x, y, gray(rgb)). Differentiable
    in both arguments."""
    B, gz, gy, gx, _ = grids.shape
    _, H, W, _ = rgb.shape
    dev = rgb.device
    gray = torch.clamp(torch.einsum("bhwc,c->bhw", rgb, _gray_w(rgb)), 0.0, 1.0)
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W * gx - 0.5
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H * gy - 0.5
    zs = gray * gz - 0.5

    x0 = torch.clamp(torch.floor(xs), 0, gx - 1).long()
    y0 = torch.clamp(torch.floor(ys), 0, gy - 1).long()
    z0 = torch.clamp(torch.floor(zs), 0, gz - 1).long()
    x1 = torch.clamp(x0 + 1, max=gx - 1)
    y1 = torch.clamp(y0 + 1, max=gy - 1)
    z1 = torch.clamp(z0 + 1, max=gz - 1)
    fx = torch.clamp(xs - x0, 0.0, 1.0)[None, None, :, None]  # [1, 1, W, 1]
    fy = torch.clamp(ys - y0, 0.0, 1.0)[None, :, None, None]  # [1, H, 1, 1]
    fz = torch.clamp(zs - z0, 0.0, 1.0)[..., None]  # [B, H, W, 1]

    flat = grids.reshape(B, gz * gy * gx, 12)
    bidx = torch.arange(B, device=dev)[:, None, None]

    def take(zi, yi, xi):
        # zi [B, H, W], yi [H], xi [W] -> the cells' affines [B, H, W, 12]
        return flat[bidx, (zi * gy + yi[None, :, None]) * gx + xi[None, None, :]]

    c00 = take(z0, y0, x0) * (1 - fx) + take(z0, y0, x1) * fx
    c01 = take(z0, y1, x0) * (1 - fx) + take(z0, y1, x1) * fx
    c10 = take(z1, y0, x0) * (1 - fx) + take(z1, y0, x1) * fx
    c11 = take(z1, y1, x0) * (1 - fx) + take(z1, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    aff = (c0 * (1 - fz) + c1 * fz).reshape(B, H, W, 3, 4)
    rgb1 = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    return torch.einsum("bhwij,bhwj->bhwi", aff, rgb1)


def total_variation_loss(grids: torch.Tensor) -> torch.Tensor:
    """Mean squared difference between neighbouring cells, over the three
    grid axes, averaged."""
    d = 0.0
    for ax in (1, 2, 3):
        diff = torch.diff(grids, dim=ax)
        d = d + torch.mean(diff * diff)
    return d / 3.0


def init_cp4d(generator: torch.Generator, grid_x: int = 16, grid_y: int = 16,
              grid_z: int = 16, grid_w: int = 8, rank: int = 5,
              learn_gray: bool = True, gray_mlp_width: int = 8,
              gray_mlp_depth: int = 2, init_noise_scale: float = 1e-6,
              bound: float = 2.0) -> dict:
    """Low-rank (CP-factored) 4-D bilateral grid over (x, y, z, guidance):
    the identity affine in rank 0 (coefficient row 0 and each factor's row
    0 of ones) plus ``init_noise_scale`` noise in every rank, drawn from
    ``generator`` on its device."""
    dev = generator.device
    randn = lambda *shape: torch.randn(shape, generator=generator, device=dev)
    mix = randn(rank, 12) * init_noise_scale
    mix[0] += torch.tensor(_IDENTITY, device=dev)
    params = {"mix": mix}
    for name, size in (("fx", grid_x), ("fy", grid_y), ("fz", grid_z), ("fw", grid_w)):
        f = randn(rank, size) * init_noise_scale
        f[0] += 1.0
        params[name] = f
    params["bound"] = torch.tensor(bound, dtype=torch.float32, device=dev)
    if learn_gray:
        widths = [3] + [gray_mlp_width] * (gray_mlp_depth - 1) + [1]
        params["gray_mlp"] = [{"w": randn(a, b) * (1.0 / math.sqrt(a)),
                               "b": torch.zeros((b,), device=dev)}
                              for a, b in zip(widths[:-1], widths[1:])]
    return params


def _interp_factor(fac: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of a [rank, S] factor at normalized coords in
    [-1, 1] (align-corners, border-clamped) -> [rank, N]."""
    S = fac.shape[1]
    t = torch.clamp((coord + 1.0) * 0.5, 0.0, 1.0) * (S - 1)
    i0 = torch.clamp(torch.floor(t), 0, S - 1).long()
    i1 = torch.clamp(i0 + 1, max=S - 1)
    f = t - i0
    return fac[:, i0] * (1.0 - f) + fac[:, i1] * f


def slice_cp4d(params: dict, xyz: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Per-point 3x4 affines ``[..., 3, 4]`` from the low-rank grid, at
    world coordinates ``xyz [..., 3]`` and colours ``rgb [..., 3]``."""
    shp = xyz.shape[:-1]
    p = xyz.reshape(-1, 3) / params["bound"]
    c = rgb.reshape(-1, 3)
    if "gray_mlp" in params:
        h = c
        n = len(params["gray_mlp"])
        for i, layer in enumerate(params["gray_mlp"]):
            h = h @ layer["w"] + layer["b"]
            if i < n - 1:
                h = torch.relu(h)
        gray = 2.0 * torch.tanh(h[:, 0] / 2.0)  # scaled tanh into [-2, 2]
    else:
        gray = (c @ _gray_w(c)) * 2.0 - 1.0
    coef = (_interp_factor(params["fx"], p[:, 0]) * _interp_factor(params["fy"], p[:, 1])
            * _interp_factor(params["fz"], p[:, 2]) * _interp_factor(params["fw"], gray))
    return (coef.T @ params["mix"]).reshape(*shp, 3, 4)


def apply_cp4d(params: dict, xyz: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Slice and apply: colour-corrected ``rgb`` of the same shape."""
    aff = slice_cp4d(params, xyz, rgb)
    rgb1 = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    return torch.einsum("...ij,...j->...i", aff, rgb1)


def total_variation_loss_cp4d(params: dict) -> torch.Tensor:
    """TV over the four 1-D factors, averaged."""
    d = 0.0
    for name in ("fx", "fy", "fz", "fw"):
        diff = torch.diff(params[name], dim=1)
        d = d + torch.mean(diff * diff)
    return d / 4.0


def color_correct(pred: torch.Tensor,  # [H, W, 3]
                  gt: torch.Tensor,  # [H, W, 3]
                  eps: float = 0.5 / 255.0) -> torch.Tensor:
    """Per-channel quadratic colour correction fitted to ``gt`` by least
    squares over a 10-term basis (1, rgb, rgb^2, cross terms), clipped to
    [0, 1]: evaluation's colour-corrected image."""
    H, W, _ = pred.shape
    p = pred.reshape(-1, 3)
    g = gt.reshape(-1, 3)
    feats = torch.cat([torch.ones_like(p[:, :1]), p, p * p, p[:, :1] * p[:, 1:2],
                       p[:, :1] * p[:, 2:3], p[:, 1:2] * p[:, 2:3]], dim=1)  # [P, 10]
    A = feats.T @ feats + eps * torch.eye(feats.shape[1], device=p.device)
    out = [feats @ torch.linalg.solve(A, feats.T @ g[:, c]) for c in range(3)]
    return torch.clamp(torch.stack(out, dim=-1).reshape(H, W, 3), 0.0, 1.0)
