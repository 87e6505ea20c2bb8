"""LPIPS perceptual metric (AlexNet backbone): the port of
``splat_one_tpu/models/lpips.py``.

The weights are not in the repository, so the metric is gated on a
weight file: ``$SPLAT_ONE_TPU_LPIPS_WEIGHTS`` (the variable the JAX
package reads), else ``weights/lpips_alex.npz`` at the repository root.
The file is the ``.npz`` that ``scripts/convert_weights.py lpips``
writes (conv{i}_w HWIO, conv{i}_b, lin{i}_w [1, 1, c, 1]); one file
serves both packages. Without it ``load_weights`` returns None and
``Trainer.eval`` reports ``lpips: None``.

Images cross the API channels-last, [N, H, W, 3] in [0, 1], as in JAX;
inside, the convolutions run NCHW through ``features._f32_conv`` (cuDNN,
TF32 off), the bias added after the convolution as JAX adds it.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from splat_one_tpu_torch.sfm.features import _f32_conv
from splat_one_tpu_torch.utils.device import resolve as resolve_device

# AlexNet feature extractor: (out_channels, kernel, stride, padding)
_ALEX_LAYERS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}  # 3x3 / 2 max pool after these layers
# LPIPS' scaling layer
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

DEFAULT_WEIGHTS = os.environ.get(
    "SPLAT_ONE_TPU_LPIPS_WEIGHTS",
    str(Path(__file__).resolve().parents[2] / "weights" / "lpips_alex.npz"))


def lpips_available(path: Optional[str] = None) -> bool:
    return os.path.exists(path or DEFAULT_WEIGHTS)


def params_from_numpy(d, device="cuda") -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS dict (numpy; HWIO convolutions and linear
    heads) as the port's tensors on ``device`` (OIHW)."""
    dev = resolve_device(device)
    out = {}
    for k, v in d.items():
        a = np.asarray(v, np.float32)
        if a.ndim == 4:  # HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.tensor(np.ascontiguousarray(a), device=dev)
    return out


def load_weights(path: Optional[str] = None, device="cuda") -> Optional[Dict]:
    """The weight file's parameters on ``device``, or None where there is
    no file."""
    path = path or DEFAULT_WEIGHTS
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return params_from_numpy({k: z[k] for k in z.files}, device)


def _conv(h, w, b=None, stride=1, pad=0):
    with _f32_conv():
        y = F.conv2d(h, w, stride=stride, padding=pad)
    return y if b is None else y + b[:, None, None]


def _alex_features(params: Dict, x: torch.Tensor):
    """x: [N, H, W, 3] in [-1, 1] -> the 5 feature maps, NCHW."""
    dev = x.device
    h = (x - torch.as_tensor(_SHIFT, device=dev)) / torch.as_tensor(_SCALE, device=dev)
    h = h.permute(0, 3, 1, 2)
    feats = []
    for i, (_, _, s, p) in enumerate(_ALEX_LAYERS):
        h = torch.relu(_conv(h, params[f"conv{i}_w"], params[f"conv{i}_b"], s, p))
        feats.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h, 3, 2)
    return feats


def lpips(params: Dict, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """LPIPS distance (mean over the batch) of [N, H, W, 3] images in [0, 1]."""
    fa = _alex_features(params, pred * 2.0 - 1.0)
    fb = _alex_features(params, gt * 2.0 - 1.0)
    total = 0.0
    for i, (a, b) in enumerate(zip(fa, fb)):
        a = a / torch.clamp(torch.sqrt((a * a).sum(1, keepdim=True)), min=1e-10)
        b = b / torch.clamp(torch.sqrt((b * b).sum(1, keepdim=True)), min=1e-10)
        total = total + torch.mean(_conv((a - b) ** 2, params[f"lin{i}_w"]))
    return total
