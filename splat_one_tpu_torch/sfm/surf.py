"""SURF features (integral-image fast-Hessian detector): the port of
``splat_one_tpu/sfm/surf.py``.

- One integral image of the image x 255, an f32 table as in JAX; every
  box-filter response is 4 shifted reads of it, in f32. At 1024x768 the
  sums reach ~1e8, where the f32 spacing is 8, so a small lobe's box sum
  carries the table's rounding. A scan in f32 rounds by its order, which
  differs between the card's parallel scan and the CPU's serial one (and
  XLA's): most keypoints of a 1024-px view then differ between the two.
  So both prefix sums accumulate in float64 and the table is rounded to
  f32 once: the correctly rounded sums, the same bits on either device
  (within 2e-7 of the largest sum of JAX's f32 scan). Both scan the
  contiguous dimension (the columns' through a transpose): torch's CUDA
  ``cumsum`` over an outer dimension is a slow serial scan.
- Fast-Hessian pyramid: lobe size L = 2^octave * (layer + 1) + 1,
  det(H) = Dxx*Dyy - (0.9*Dxy)^2 over the filter area^2, evaluated at
  every pixel; 3x3x3 NMS inside an octave; ``hessian_threshold`` on
  OpenCV's [0, 255] scale.
- Orientation + M-SURF descriptor from ``sfm.akaze`` over the Gaussian
  gradients at the detection scale; ``upright`` (U-SURF) skips the
  orientation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from splat_one_tpu_torch.sfm.akaze import _msurf_desc, _orientation, _scharr, _select
from splat_one_tpu_torch.sfm.features import Features, _gaussian_blur, top_k


def _integral(img: torch.Tensor) -> torch.Tensor:
    """Zero-padded f32 integral image: ii[y, x] = sum img[:y, :x], summed in
    float64 (the column sums first, as JAX; each scan along the contiguous
    dimension) and rounded once."""
    cols = torch.cumsum(img.to(torch.float64).t().contiguous(), dim=1).t()
    ii = torch.cumsum(cols.contiguous(), dim=1).to(torch.float32)
    return F.pad(ii, (1, 0, 1, 0))


def _box(ii: torch.Tensor, H: int, W: int, y0: int, y1: int, x0: int, x1: int):
    """Per-pixel sum of img[y+y0 : y+y1, x+x0 : x+x1] (half-open, clamped at
    the borders) for every pixel: 4 shifted reads of the integral image."""
    dev = ii.device

    def at(dy, dx):
        ys = torch.clamp(torch.arange(H, device=dev) + dy, 0, H)
        xs = torch.clamp(torch.arange(W, device=dev) + dx, 0, W)
        return ii[ys][:, xs]

    return at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0)


def _hessian_response(ii, H, W, L):
    """Fast-Hessian response for lobe size L (filter size 3L)."""
    l2 = L // 2
    # Dyy: three stacked (L x 2L-1) lobes, the middle weighted -2
    dyy = _box(ii, H, W, -(L + l2), L + l2 + 1, -(L - 1), L) - 3.0 * _box(
        ii, H, W, -l2, l2 + 1, -(L - 1), L)
    dxx = _box(ii, H, W, -(L - 1), L, -(L + l2), L + l2 + 1) - 3.0 * _box(
        ii, H, W, -(L - 1), L, -l2, l2 + 1)
    # Dxy: four LxL lobes at the quadrant corners (+1 ur/ll, -1 ul/lr)
    ur = _box(ii, H, W, -L, 0, 1, L + 1)
    ll = _box(ii, H, W, 1, L + 1, -L, 0)
    ul = _box(ii, H, W, -L, 0, -L, 0)
    lr = _box(ii, H, W, 1, L + 1, 1, L + 1)
    dxy = ur + ll - ul - lr
    area = float(3 * L * (2 * L - 1))  # Dxx/Dyy filter area
    dxx = dxx / area
    dyy = dyy / area
    dxy = dxy / area
    return dxx * dyy - (0.9 * dxy) ** 2


def surf_from_integral(
    image: torch.Tensor,  # [H, W] grayscale float in [0, 1]
    ii: torch.Tensor,  # [H + 1, W + 1]: _integral(image * 255)
    max_keypoints: int = 2048,
    hessian_threshold: float = 3000.0,
    n_octaves: int = 4,
    n_layers: int = 2,
    upright: bool = False,
) -> Features:
    """``extract_surf`` from its integral image."""
    image = image.to(torch.float32)
    H, W = image.shape
    dev = image.device
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    all_xy, all_scale, all_theta, all_desc, all_score = [], [], [], [], []
    per_oct = -(-max_keypoints // n_octaves)
    per_lvl = -(-per_oct // n_layers)
    # n_layers usable layers need n_layers + 2 filter sizes per octave
    for o in range(n_octaves):
        step = 2**o
        Ls = [step * (k + 1) + 1 for k in range(n_layers + 2)]
        # the equivalent Gaussian scale of filter size 3L (Bay et al.)
        resp = torch.stack([_hessian_response(ii, H, W, L) for L in Ls])
        sigmas = [1.2 * (3 * L) / 9.0 for L in Ls]
        for j in range(1, n_layers + 1):
            r = resp[j]
            mx = F.max_pool2d(r[None, None], 3, stride=1, padding=1)[0, 0]
            peak = (r >= mx) & (r > hessian_threshold)
            peak &= (r >= resp[j - 1]) & (r >= resp[j + 1])
            b = int(np.ceil(12 * sigmas[j])) + 2
            peak &= (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
            flat = torch.where(peak, r, torch.full_like(r, -torch.inf)).reshape(-1)
            top, idx = top_k(flat, per_lvl)
            ok = torch.isfinite(top) & (top > 0)
            ys = torch.clamp(idx // W, 1, H - 2).to(torch.float32)
            xs = torch.clamp(idx % W, 1, W - 2).to(torch.float32)
            s = sigmas[j]
            s_arr = torch.full((per_lvl,), s, dtype=torch.float32, device=dev)
            # gradients at the detection scale for orientation/descriptor
            d = max(1, int(round(s)))
            Lsm = _gaussian_blur(image, s)
            Lx = _scharr(Lsm, 1, d)
            Ly = _scharr(Lsm, 0, d)
            if upright:
                theta = torch.zeros((per_lvl,), device=dev)
            else:
                theta = _orientation(Lx, Ly, ys, xs, s_arr)
            desc = _msurf_desc(Lx, Ly, ys, xs, s_arr, theta)
            all_xy.append(torch.stack([xs, ys], -1))
            all_scale.append(s_arr)
            all_theta.append(theta)
            all_desc.append(torch.where(ok[:, None], desc, torch.zeros_like(desc)))
            all_score.append(torch.where(ok, top, torch.zeros_like(top)))
    return _select(all_xy, all_scale, all_theta, all_desc, all_score, max_keypoints)


def extract_surf(
    image: torch.Tensor,  # [H, W] grayscale float in [0, 1]
    max_keypoints: int = 2048,
    hessian_threshold: float = 3000.0,  # surf_hessian_threshold
    n_octaves: int = 4,  # surf_n_octaves
    n_layers: int = 2,  # surf_n_octavelayers
    upright: bool = False,  # surf_upright
) -> Features:
    """SURF features in the shared ``Features`` layout, on the image's
    device (the threshold is OpenCV's, for [0, 255] images)."""
    image = image.to(torch.float32)
    return surf_from_integral(image, _integral(image * 255.0), max_keypoints, hessian_threshold,
                              n_octaves, n_layers, upright)
