"""Training losses: counterpart of ``splat_one_tpu/train/losses.py``.

loss = (1 - ssim_lambda) * L1 + ssim_lambda * (1 - SSIM)
       [+ depth_lambda * disparity L1]
       [+ opacity_reg * mean sigmoid(opacity) + scale_reg * mean exp(scale)]
"""

from __future__ import annotations

from typing import Dict

import torch

from splat_one_tpu_torch.ops.ssim import ssim


def image_loss(pred: torch.Tensor, gt: torch.Tensor,
               ssim_lambda: float = 0.2) -> Dict[str, torch.Tensor]:
    """``pred``, ``gt`` [B, H, W, 3] -> {"loss", "l1", "ssim"}."""
    l1 = torch.mean(torch.abs(pred - gt))
    s = ssim(pred, gt)
    loss = (1.0 - ssim_lambda) * l1 + ssim_lambda * (1.0 - s)
    return {"loss": loss, "l1": l1, "ssim": s}


def depth_loss(render_depth: torch.Tensor, gt_depth: torch.Tensor,
               scene_scale: float = 1.0) -> torch.Tensor:
    """Disparity L1 of the expected depth [B, H, W, 1] against supervision
    depth (0 = missing), scaled by ``scene_scale``."""
    valid = gt_depth > 1e-6
    zero = torch.zeros_like(render_depth)
    disp = torch.where(valid, 1.0 / torch.clamp(render_depth, min=1e-6), zero)
    disp_gt = torch.where(valid, 1.0 / torch.clamp(gt_depth, min=1e-6), zero)
    n = torch.clamp(torch.sum(valid), min=1)
    return torch.sum(torch.abs(disp - disp_gt)) / n * scene_scale


def regularizers(params, alive: torch.Tensor, opacity_reg: float = 0.0,
                 scale_reg: float = 0.0) -> torch.Tensor:
    """Opacity and scale penalties, averaged over the alive gaussians."""
    out = torch.zeros((), device=alive.device)
    n = torch.clamp(torch.sum(alive).float(), min=1.0)
    if opacity_reg > 0:
        o = torch.sigmoid(params["opacities"])
        out = out + opacity_reg * torch.sum(torch.where(alive, o, torch.zeros_like(o))) / n
    if scale_reg > 0:
        s = torch.exp(params["scales"])
        out = out + scale_reg * torch.sum(
            torch.where(alive[:, None], s, torch.zeros_like(s))) / (3.0 * n)
    return out


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))
