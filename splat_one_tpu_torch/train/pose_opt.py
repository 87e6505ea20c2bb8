"""Camera pose optimisation: counterpart of ``splat_one_tpu/train/pose_opt.py``.

Each image owns a 9-D embedding, 3 translation and 6 rotation (the
continuous 6-D form) parameters, applied as a right multiplication of its
camera-to-world matrix and zero at the identity. The Trainer learns the
embeddings with Adam; their gradients reach them through
``apply_pose_adjust``, ``invert_se3`` and the projection by autograd.
"""

from __future__ import annotations

import torch

from splat_one_tpu_torch.core.transforms import rotation_6d_to_matrix

_ROT_OFFSET = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)  # zeros decode to the identity


def init_pose_params(n_images: int, device="cpu") -> torch.Tensor:
    """[n_images, 9] zeros: every pose unadjusted."""
    return torch.zeros((n_images, 9), dtype=torch.float32, device=device)


def apply_pose_adjust(camtoworlds: torch.Tensor,  # [B, 4, 4]
                      embeds: torch.Tensor) -> torch.Tensor:  # [B, 9]
    """``camtoworlds @ delta(embeds)``: the identity at zero embeddings."""
    dx = embeds[:, :3]
    drot = embeds[:, 3:] + torch.tensor(_ROT_OFFSET, dtype=embeds.dtype,
                                        device=embeds.device)
    R = rotation_6d_to_matrix(drot)  # [B, 3, 3]
    top = torch.cat([R, dx[..., None]], dim=-1)  # [B, 3, 4]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=embeds.dtype,
                          device=embeds.device).expand(embeds.shape[0], 1, 4)
    return camtoworlds @ torch.cat([top, bottom], dim=-2)


def perturb_poses(noise: torch.Tensor, camtoworlds: torch.Tensor,
                  std: float) -> torch.Tensor:
    """Test-time pose noise: ``noise`` [B, 9] standard normal draws, scaled
    by ``std`` and applied as an embedding."""
    return apply_pose_adjust(camtoworlds, noise * std)
