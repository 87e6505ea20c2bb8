"""Promptable segmentation for the Masks stage: the port of
``splat_one_tpu/models/segmentation.py``.

``build_predictor`` picks the backend from the checkpoint, as JAX does:
a converted SAM 2.1 ``.npz`` (``image_encoder.trunk.*`` keys) gives the
faithful ``sam2_hiera.SAM2Predictor``, any other ``.npz`` the compact
``sam2_hiera.HieraPredictor`` (its ``enc_*`` / ``dec_*`` keys over a
seeded init), no file the ``ClassicalPredictor``. The learned backends
run on ``device`` (CUDA unless ``device="cpu"``).

``ClassicalPredictor`` (promptable region growing: a colour + spatial
geodesic distance from the positive clicks, cut by the negative ones) is
numpy, a copy of JAX's, so its masks are the same bits. ``save_mask``
writes the inverted PNG that the SfM stages read.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


class ClassicalPredictor:
    """Promptable segmentation by seeded geodesic region growing."""

    def __init__(self, sigma_color: float = 0.12, n_iters: int = 256):
        self.sigma_color = sigma_color
        self.n_iters = n_iters
        self._image: Optional[np.ndarray] = None

    def set_image(self, image: np.ndarray):
        """image: [H, W, 3] uint8 or float in [0, 1]."""
        img = image.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        self._image = img

    def predict(
        self,
        point_coords: np.ndarray,  # [N, 2] (x, y) pixels
        point_labels: np.ndarray,  # [N] 1 = foreground, 0 = background
        multimask_output: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, None]:
        """(masks [1, H, W] bool, scores [1], logits None): the
        ``SAM2ImagePredictor`` return shape."""
        if self._image is None:
            raise RuntimeError("call set_image first")
        img = self._image
        H, W, _ = img.shape
        pos = point_coords[point_labels > 0].astype(int)
        neg = point_coords[point_labels == 0].astype(int)

        # smoothed image for the colour affinity
        sm = img
        for ax in (0, 1):
            k = np.array([0.25, 0.5, 0.25])
            sm = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), ax, sm)
        INF = 1e9
        cost = np.full((H, W), INF, np.float32)
        for x, y in pos:
            if 0 <= y < H and 0 <= x < W:
                cost[y, x] = 0.0
        neg_cost = np.full((H, W), INF, np.float32)
        for x, y in neg:
            if 0 <= y < H and 0 <= x < W:
                neg_cost[y, x] = 0.0

        def sweep(c):
            # iterative geodesic distance transform (4-neighbourhood,
            # colour-gradient edge weights), alternating sweeps
            for _ in range(self.n_iters):
                before = c.copy()
                for sl_a, sl_b in ((np.s_[1:, :], np.s_[:-1, :]),
                                   (np.s_[:-1, :], np.s_[1:, :]),
                                   (np.s_[:, 1:], np.s_[:, :-1]),
                                   (np.s_[:, :-1], np.s_[:, 1:])):
                    w = np.linalg.norm(sm[sl_a] - sm[sl_b], axis=-1) / self.sigma_color + 1e-3
                    c[sl_a] = np.minimum(c[sl_a], c[sl_b] + w)
                if np.allclose(before, c, atol=1e-4):
                    break
            return c

        cost = sweep(cost)
        if len(neg):
            neg_cost = sweep(neg_cost)
            mask = cost < neg_cost
        else:
            thr = np.percentile(cost[np.isfinite(cost)], 60)
            mask = cost < max(thr, 1.0)
        return mask[None], np.array([float(mask.mean())]), None


def build_predictor(checkpoint: Optional[str] = None, config: str = "hiera_l",
                    device="cuda"):
    """The reference's ``build_sam2(cfg, ckpt)`` + predictor: the faithful
    SAM 2.1 for a converted checkpoint (original key names), the compact
    net for an ``enc_*`` / ``dec_*`` one, else the classical region
    grower."""
    if checkpoint and os.path.exists(checkpoint):
        with np.load(checkpoint) as z:
            keys = z.files
        if any(k.startswith("image_encoder.trunk.") for k in keys):
            from splat_one_tpu_torch.models.sam2_hiera import SAM2Predictor

            return SAM2Predictor(checkpoint, config=config, device=device)
        from splat_one_tpu_torch.models.sam2_hiera import HieraPredictor

        return HieraPredictor(checkpoint, device=device)
    return ClassicalPredictor()


def save_mask(mask: np.ndarray, path: str, invert: bool = True):
    """Write the mask PNG the SfM and splat stages read (inverted, as the
    reference writes it)."""
    from PIL import Image

    m = (~mask if invert else mask).astype(np.uint8) * 255
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(m).save(path)
