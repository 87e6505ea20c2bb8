"""SSIM with an 11x11 Gaussian window (differentiable by autograd).

Counterpart of ``splat_one_tpu/ops/ssim.py`` (the training loss's
``fused-ssim`` replacement, ``padding="valid"``). The five window blurs
are one depthwise ``F.conv2d`` each, as the JAX package leaves them to
XLA outside any Pallas kernel. On a CUDA card cuDNN runs f32 convolutions
in TF32 (about three decimal digits) unless
``torch.backends.cudnn.allow_tf32`` is False; the parity tests and
``chip_smoke.py`` turn it off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=4)
def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return np.outer(g, g)  # [size, size]


def _blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 'valid' convolution of an NCHW input with one 2D window."""
    c = x.shape[1]
    return F.conv2d(x, window.expand(c, 1, *window.shape[-2:]), groups=c)


def ssim(
    pred: torch.Tensor,  # [N, H, W, C] in [0, 1]
    gt: torch.Tensor,  # [N, H, W, C]
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01 ** 2,
    c2: float = 0.03 ** 2,
) -> torch.Tensor:
    """Mean SSIM over the batch (``padding='valid'`` like fused-ssim)."""
    win = torch.as_tensor(_gaussian_window(window_size, sigma), device=pred.device)
    p = pred.permute(0, 3, 1, 2)
    g = gt.permute(0, 3, 1, 2)
    mu_p = _blur(p, win)
    mu_g = _blur(g, win)
    mu_pp = mu_p * mu_p
    mu_gg = mu_g * mu_g
    mu_pg = mu_p * mu_g
    sig_p = _blur(p * p, win) - mu_pp
    sig_g = _blur(g * g, win) - mu_gg
    sig_pg = _blur(p * g, win) - mu_pg
    ssim_map = ((2 * mu_pg + c1) * (2 * sig_pg + c2)) / (
        (mu_pp + mu_gg + c1) * (sig_p + sig_g + c2))
    return torch.mean(ssim_map)


def d_ssim_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """``1 - SSIM`` (the form used in the training loss)."""
    return 1.0 - ssim(pred, gt)
