"""Fixed-capacity Gaussian-splat parameters as a dict of torch tensors.

Counterpart of ``splat_one_tpu/core/gaussians.py`` with the same storage
convention, so checkpoints of the JAX package load unchanged:
  - ``means``      [CAP, 3]   world positions
  - ``scales``     [CAP, 3]   log-scales (``exp`` at render)
  - ``quats``      [CAP, 4]   unnormalized wxyz
  - ``opacities``  [CAP]      logits (``sigmoid`` at render)
  - ``sh0``        [CAP, 1, 3]  DC SH coefficients
  - ``shN``        [CAP, K-1, 3] higher-order SH coefficients
An ``alive`` bool mask [CAP] marks the live rows. Buffers are made on
CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from splat_one_tpu_torch.core.sh import num_sh_bases, rgb_to_sh
from splat_one_tpu_torch.utils.device import resolve as resolve_device

Params = Dict[str, torch.Tensor]


def init_splats_from_points(
    points: np.ndarray,  # [N, 3]
    rgbs: np.ndarray,  # [N, 3] in [0, 1]
    capacity: int,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    init_scale: float = 1.0,
    seed: int = 0,
    feature_dim: int = 0,
    device: str | torch.device = "cuda",
) -> Tuple[Params, torch.Tensor]:
    """SfM-point initialization: scales from the mean 3-NN distance, random
    quats (numpy ``default_rng(seed)``), logit opacity. Returns
    ``(params, alive)`` with capacity-padded buffers on ``device``."""
    device = resolve_device(device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"capacity {capacity} < number of points {n}")
    rng = np.random.default_rng(seed)

    d_avg = _knn_mean_dist(points, k=3)
    scales = np.log(np.clip(d_avg * init_scale, 1e-7, None))[:, None].repeat(3, 1)

    K = num_sh_bases(sh_degree)
    sh0 = rgb_to_sh(torch.as_tensor(rgbs, dtype=torch.float32)).numpy()[:, None, :]
    shN = np.zeros((n, K - 1, 3), np.float32)
    quats = rng.uniform(size=(n, 4)).astype(np.float32)
    opac = np.full((n,), _logit(init_opacity), np.float32)

    def padded(x, cap_val=0.0):
        out = np.full((capacity,) + x.shape[1:], cap_val, np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=device)

    params = {
        "means": padded(points.astype(np.float32)),
        "scales": padded(scales.astype(np.float32), cap_val=-10.0),
        "quats": padded(quats, cap_val=1.0),
        "opacities": padded(opac, cap_val=-10.0),
    }
    if feature_dim > 0:
        feats = rng.uniform(size=(n, feature_dim)).astype(np.float32)
        rgbc = np.clip(rgbs.astype(np.float32), 1e-3, 1 - 1e-3)
        params["features"] = padded(feats)
        params["colors"] = padded(np.log(rgbc / (1 - rgbc)))
    else:
        params["sh0"] = padded(sh0.astype(np.float32))
        params["shN"] = padded(shN)
    alive = torch.arange(capacity, device=device) < n
    return params, alive


def init_splats_random(
    capacity: int,
    n: int,
    extent: float,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    init_scale: float = 1.0,
    seed: int = 0,
    feature_dim: int = 0,
    device: str | torch.device = "cuda",
) -> Tuple[Params, torch.Tensor]:
    """Random-init variant: uniform points in a cube of half-size ``extent``."""
    resolve_device(device)  # refuse before the k-NN work
    rng = np.random.default_rng(seed)
    points = (rng.uniform(size=(n, 3)) * 2 - 1) * extent
    rgbs = rng.uniform(size=(n, 3))
    return init_splats_from_points(
        points, rgbs, capacity, sh_degree, init_opacity, init_scale, seed,
        feature_dim=feature_dim, device=device,
    )


def activated(params: Params, alive: Optional[torch.Tensor] = None):
    """Render-ready values: (means, quats, scales, opacities, sh_coeffs)."""
    scales = torch.exp(params["scales"])
    opac = torch.sigmoid(params["opacities"])
    sh = torch.cat([params["sh0"], params["shN"]], dim=1)
    return params["means"], params["quats"], scales, opac, sh


def n_alive(alive: torch.Tensor) -> torch.Tensor:
    return torch.sum(alive.to(torch.int32))


def grow_capacity(params: Params, alive: torch.Tensor, new_capacity: int):
    """Pad every buffer (and ``alive``) with zero rows up to
    ``new_capacity``; a smaller or equal capacity returns them unchanged."""
    cap = alive.shape[0]
    if new_capacity <= cap:
        return params, alive
    pad = new_capacity - cap

    def padf(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)

    return {k: padf(v) for k, v in params.items()}, padf(alive)


def _logit(p: float) -> float:
    return float(np.log(p / (1.0 - p)))


def _knn_mean_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean distance to the k nearest neighbours (host-side init path):
    scipy's cKDTree when present, else chunked brute force."""
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        n = points.shape[0]
        out = np.empty(n, np.float32)
        chunk = 2048
        for i in range(0, n, chunk):
            d2 = ((points[i:i + chunk, None] - points[None]) ** 2).sum(-1)
            d2.sort(axis=1)
            out[i:i + chunk] = np.sqrt(d2[:, 1:k + 1].mean(axis=1))
        return out
    d, _ = cKDTree(points).query(points, k=k + 1)
    return np.sqrt((d[:, 1:] ** 2).mean(axis=1)).astype(np.float32)
