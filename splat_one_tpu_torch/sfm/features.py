"""Feature detection + description: the port of ``splat_one_tpu/sfm/features.py``.

A DoG (SIFT-style) detector and a Hessian (HAHOG) detector, both with the
4x4x8 gradient-orientation-histogram descriptor:

  - Gaussian scale pyramid -> DoG extrema (3x3x3 non-max, contrast + edge
    rejection) or scale-normalized Hessian determinant extrema, a fixed
    top-K of keypoints per image (static shapes, the analog of
    ``feature_min_frames``), subpixel quadratic refinement;
  - per-keypoint dominant orientation (36-bin histogram);
  - 4x4x8 gradient-histogram descriptor over an oriented 16x16 patch,
    L2-normalize -> clip 0.2 -> renormalize -> square root (rootSIFT).

Everything is batched over the keypoints of one image and runs on the
image tensor's device in f32. The blur is a separable convolution with
"SAME" zero padding; on CUDA it runs through cuDNN with TF32 switched off
for the call (``_f32_conv``), so the card blurs in f32 as the CPU does.
Keypoints are pixel coordinates (x, y); ``normalized_image_coordinates``
gives OpenSfM's centred, max-dimension-scaled ones.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Features(NamedTuple):
    xys: torch.Tensor  # [K, 2] pixel coords (x, y)
    scales: torch.Tensor  # [K] detection scale (pixels)
    orientations: torch.Tensor  # [K] radians
    descriptors: torch.Tensor  # [K, 128] L2-normalized
    scores: torch.Tensor  # [K] detection response
    valid: torch.Tensor  # [K] bool


def _f32_conv():
    """cuDNN's flags with TF32 off, the rest as they are: a scope for one
    convolution (torch's default lets cuDNN convolve in TF32 on the card)."""
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=b.benchmark,
                   deterministic=b.deterministic, allow_tf32=False)


def _gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / torch.sum(k)
    with _f32_conv():
        h = F.conv2d(img[None, None], k.reshape(1, 1, 1, -1), padding=(0, radius))
        v = F.conv2d(h, k.reshape(1, 1, -1, 1), padding=(radius, 0))
    return v[0, 0]


def _shift2(x, dy, dx):
    return torch.roll(torch.roll(x, dy, dims=-2), dx, dims=-1)


def _local_extrema(vol: torch.Tensor):
    """(is_max, is_min) over the 26 neighbours of each sample of ``vol``
    [L, H, W], every axis wrapping as ``torch.roll`` does."""
    is_max = torch.ones_like(vol, dtype=torch.bool)
    is_min = torch.ones_like(vol, dtype=torch.bool)
    for ds in (-1, 0, 1):
        rs = torch.roll(vol, ds, dims=0)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                nb = _shift2(rs, dy, dx)
                is_max &= vol > nb
                is_min &= vol < nb
    return is_max, is_min


def _candidate_grid(shape, sigmas, device):
    """The interior-level and scale-dependent border mask of a [L, H, W]
    response volume: levels 1..L-2 and at least max(20, ceil(4.5 sigma))
    pixels from every edge (the 16x16 descriptor grid samples out to
    ~8.5 scale pixels)."""
    L, H, W = shape
    s_grid = torch.arange(L, device=device)[:, None, None]
    borders = torch.as_tensor([max(20, int(np.ceil(4.5 * s_))) for s_ in sigmas[:L]],
                              dtype=torch.int64, device=device)[:, None, None]
    ys = torch.arange(H, device=device)[None, :, None]
    xs = torch.arange(W, device=device)[None, None, :]
    return ((s_grid > 0) & (s_grid < L - 1)
            & (ys >= borders) & (ys < H - borders)
            & (xs >= borders) & (xs < W - borders))


def _hog_machinery(grad_x, grad_y, H, W):
    """Orientation + 128-D HOG descriptor over per-level gradient stacks
    [L, H, W], batched over keypoints: shared by the SIFT (DoG) and HAHOG
    (Hessian) tiers."""
    dev = grad_x.device
    gxf, gyf = grad_x.reshape(-1), grad_y.reshape(-1)

    def bilinear(flat, s_i, yy, xx):
        x0 = torch.clamp(torch.floor(xx).to(torch.int64), 0, W - 2)
        y0 = torch.clamp(torch.floor(yy).to(torch.int64), 0, H - 2)
        fx = xx - x0
        fy = yy - y0
        base = s_i[:, None, None] * (H * W) + y0 * W + x0
        return (flat[base] * (1 - fx) * (1 - fy)
                + flat[base + 1] * fx * (1 - fy)
                + flat[base + W] * (1 - fx) * fy
                + flat[base + W + 1] * fx * fy)

    def orientation(s_i, yy, xx, sc):
        K = s_i.shape[0]
        rr = torch.arange(-8, 9, dtype=torch.float32, device=dev)
        dy, dx = torch.meshgrid(rr, rr, indexing="ij")
        rad = (sc * 0.75)[:, None, None]
        py = yy[:, None, None] + dy * rad / 4.0
        px = xx[:, None, None] + dx * rad / 4.0
        gx = bilinear(gxf, s_i, py, px)
        gy = bilinear(gyf, s_i, py, px)
        mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
        ang = torch.atan2(gy, gx)
        w = torch.exp(-(dx * dx + dy * dy) / (2 * 6.0 ** 2))
        bins = torch.floor((ang + math.pi) / (2 * math.pi) * 36).to(torch.int64) % 36
        hist = torch.zeros(K, 36, device=dev).scatter_add_(
            1, bins.reshape(K, -1), (mag * w).reshape(K, -1))
        b = torch.argmax(hist, dim=1)
        return (b.to(torch.float32) + 0.5) / 36.0 * 2 * math.pi - math.pi

    def descriptor(s_i, yy, xx, sc, theta):
        K = s_i.shape[0]
        rr = torch.arange(-7.5, 8.5, dtype=torch.float32, device=dev)
        v, u = torch.meshgrid(rr, rr, indexing="ij")
        ct = torch.cos(theta)[:, None, None]
        st = torch.sin(theta)[:, None, None]
        step = (sc * 0.8)[:, None, None]
        px = xx[:, None, None] + (u * ct - v * st) * step
        py = yy[:, None, None] + (u * st + v * ct) * step
        gx = bilinear(gxf, s_i, py, px)
        gy = bilinear(gyf, s_i, py, px)
        mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
        ang = torch.atan2(gy, gx) - theta[:, None, None]
        w = torch.exp(-(u * u + v * v) / (2 * 8.0 ** 2))
        obin = torch.floor((ang + 3 * math.pi) / (2 * math.pi) * 8).to(torch.int64) % 8
        sx = torch.clamp(((u + 8.0) / 4.0).to(torch.int64), 0, 3)
        sy = torch.clamp(((v + 8.0) / 4.0).to(torch.int64), 0, 3)
        flat_bin = (sy * 4 + sx) * 8 + obin
        desc = torch.zeros(K, 128, device=dev).scatter_add_(
            1, flat_bin.reshape(K, -1), (mag * w).reshape(K, -1))
        desc = desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True), min=1e-8)
        desc = torch.clamp(desc, max=0.2)
        desc = desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True), min=1e-8)
        return torch.sqrt(desc)

    return orientation, descriptor


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries of 1-D ``x`` in ``jax.lax.top_k``'s order:
    descending, ties by the lower index first (a stable sort; ``torch.topk``
    promises no order among ties on the card). Returns (values, indices)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _top_keypoints(resp, cand, max_keypoints):
    """Top-K of the candidates' scores over the flattened [L, H, W]
    volume: (scores, valid, level, y, x)."""
    L, H, W = resp.shape
    score = torch.where(cand, resp, torch.zeros_like(resp)).reshape(-1)
    k = min(max_keypoints, score.shape[0])
    top_scores, top_idx = torch.topk(score, k)
    rem = top_idx % (H * W)
    return top_scores, top_scores > 0, top_idx // (H * W), rem // W, rem % W


def _gradients(blurred):
    gx = torch.stack([0.5 * (_shift2(b, 0, -1) - _shift2(b, 0, 1)) for b in blurred])
    gy = torch.stack([0.5 * (_shift2(b, -1, 0) - _shift2(b, 1, 0)) for b in blurred])
    return gx, gy


def extract_features(
    image: torch.Tensor,  # [H, W] grayscale float in [0, 1]
    max_keypoints: int = 2048,
    n_scales: int = 5,
    contrast_threshold: float = 0.015,
    edge_ratio: float = 10.0,
) -> Features:
    """SIFT-style DoG keypoints and rootSIFT descriptors of one image, on
    its device. ``n_scales`` usable levels: two extra DoG levels give every
    usable level a full 3x3x3 neighbourhood; the levels do not wrap into
    each other (only the interior ones may hold a keypoint)."""
    image = image.to(torch.float32)
    blurred = [_gaussian_blur(image, s) for s in sift_sigmas(n_scales)]
    return sift_from_pyramid(blurred, max_keypoints, n_scales, contrast_threshold, edge_ratio)


def sift_sigmas(n_scales: int = 5):
    """The blur sigmas of ``extract_features``: ``n_scales + 3`` levels,
    one step finer than the first usable one (sigma 1.2)."""
    return [1.2 * (1.6 ** (i - 1)) for i in range(n_scales + 3)]


def sift_from_pyramid(blurred, max_keypoints: int = 2048, n_scales: int = 5,
                      contrast_threshold: float = 0.015,
                      edge_ratio: float = 10.0) -> Features:
    """``extract_features`` from its blurred levels (``sift_sigmas``)."""
    H, W = blurred[0].shape
    device = blurred[0].device
    n_dog = n_scales + 2
    sigmas = sift_sigmas(n_scales)
    dogs = torch.stack([blurred[i + 1] - blurred[i] for i in range(n_dog)])

    is_max, is_min = _local_extrema(dogs)
    resp = torch.abs(dogs)
    cand = (is_max | is_min) & (resp > contrast_threshold)
    # edge rejection via the Hessian trace/det ratio on the DoG
    dxx = _shift2(dogs, 0, 1) + _shift2(dogs, 0, -1) - 2 * dogs
    dyy = _shift2(dogs, 1, 0) + _shift2(dogs, -1, 0) - 2 * dogs
    dxy = 0.25 * (_shift2(dogs, 1, 1) + _shift2(dogs, -1, -1)
                  - _shift2(dogs, 1, -1) - _shift2(dogs, -1, 1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    cand &= (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
    cand &= _candidate_grid(dogs.shape, sigmas, device)

    top_scores, valid, s_idx, yi, xi = _top_keypoints(resp, cand, max_keypoints)
    # subpixel refinement: 2D quadratic fit on the DoG
    gx_d = 0.5 * (_shift2(dogs, 0, -1) - _shift2(dogs, 0, 1))
    gy_d = 0.5 * (_shift2(dogs, -1, 0) - _shift2(dogs, 1, 0))
    g1 = gx_d[s_idx, yi, xi]
    g2 = gy_d[s_idx, yi, xi]
    h11 = dxx[s_idx, yi, xi]
    h22 = dyy[s_idx, yi, xi]
    h12 = dxy[s_idx, yi, xi]
    det_h = h11 * h22 - h12 * h12
    det_h = torch.where(torch.abs(det_h) < 1e-12, torch.full_like(det_h, 1e-12), det_h)
    off_x = torch.clamp(-(h22 * g1 - h12 * g2) / det_h, -0.5, 0.5)
    off_y = torch.clamp(-(h11 * g2 - h12 * g1) / det_h, -0.5, 0.5)
    y = yi.to(torch.float32) + off_y
    x = xi.to(torch.float32) + off_x
    scale = torch.as_tensor(sigmas[:-1], dtype=torch.float32, device=device)[s_idx]

    grad_x, grad_y = _gradients(blurred[:-1])
    orientation, descriptor = _hog_machinery(grad_x, grad_y, H, W)
    thetas = orientation(s_idx, y, x, scale)
    descs = descriptor(s_idx, y, x, scale, thetas)
    return Features(
        xys=torch.stack([x, y], dim=-1),
        scales=scale,
        orientations=thetas,
        descriptors=torch.where(valid[:, None], descs, torch.zeros_like(descs)),
        scores=top_scores,
        valid=valid,
    )


def extract_hahog(
    image: torch.Tensor,  # [H, W] grayscale float in [0, 1]
    max_keypoints: int = 2048,
    n_scales: int = 5,
    peak_threshold: float = 1e-5,  # hahog_peak_threshold
    edge_threshold: float = 10.0,  # hahog_edge_threshold
) -> Features:
    """HAHOG tier: scale-normalized Hessian determinant (sigma^4 det H)
    over a Gaussian pyramid with 3x3x3 scale-space NMS, trace^2/det edge
    rejection and per-axis quadratic subpixel refinement; the SIFT tier's
    descriptor. Circular regions: no affine shape adaptation. The outputs
    are padded to ``max_keypoints`` rows."""
    image = image.to(torch.float32)
    blurred = [_gaussian_blur(image, s) for s in hahog_sigmas(n_scales)]
    return hahog_from_pyramid(blurred, max_keypoints, n_scales, peak_threshold, edge_threshold)


def hahog_sigmas(n_scales: int = 5):
    """The blur sigmas of ``extract_hahog``: ``n_scales + 2`` levels."""
    return [1.2 * (1.6 ** i) for i in range(n_scales + 2)]


def hahog_from_pyramid(blurred, max_keypoints: int = 2048, n_scales: int = 5,
                       peak_threshold: float = 1e-5,
                       edge_threshold: float = 10.0) -> Features:
    """``extract_hahog`` from its blurred levels (``hahog_sigmas``)."""
    H, W = blurred[0].shape
    device = blurred[0].device
    sigmas = hahog_sigmas(n_scales)

    responses = []
    for i, b in enumerate(blurred):
        dxx = _shift2(b, 0, 1) + _shift2(b, 0, -1) - 2 * b
        dyy = _shift2(b, 1, 0) + _shift2(b, -1, 0) - 2 * b
        dxy = 0.25 * (_shift2(b, 1, 1) + _shift2(b, -1, -1)
                      - _shift2(b, 1, -1) - _shift2(b, -1, 1))
        det = dxx * dyy - dxy * dxy
        tr = dxx + dyy
        r = edge_threshold
        edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
        responses.append(torch.where(edge_ok, det * sigmas[i] ** 4, torch.zeros_like(det)))
    resp = torch.stack(responses)

    is_max, _ = _local_extrema(resp)
    cand = is_max & (resp > peak_threshold)
    cand &= _candidate_grid(resp.shape, sigmas, device)

    top_scores, valid, s_idx, yi, xi = _top_keypoints(resp, cand, max_keypoints)
    k = top_scores.shape[0]
    # subpixel: 1D quadratic per axis on the response
    gx_r = 0.5 * (_shift2(resp, 0, -1) - _shift2(resp, 0, 1))
    gy_r = 0.5 * (_shift2(resp, -1, 0) - _shift2(resp, 1, 0))
    hxx = (_shift2(resp, 0, 1) + _shift2(resp, 0, -1) - 2 * resp)[s_idx, yi, xi]
    hyy = (_shift2(resp, 1, 0) + _shift2(resp, -1, 0) - 2 * resp)[s_idx, yi, xi]
    tiny = torch.full_like(hxx, 1e-12)
    off_x = torch.clamp(gx_r[s_idx, yi, xi] / torch.where(torch.abs(hxx) > 1e-12, -hxx, tiny),
                        -0.5, 0.5)
    off_y = torch.clamp(gy_r[s_idx, yi, xi] / torch.where(torch.abs(hyy) > 1e-12, -hyy, tiny),
                        -0.5, 0.5)
    y = yi.to(torch.float32) + off_y
    x = xi.to(torch.float32) + off_x
    scale = torch.as_tensor(sigmas, dtype=torch.float32, device=device)[s_idx]

    grad_x, grad_y = _gradients(blurred)
    orientation, descriptor = _hog_machinery(grad_x, grad_y, H, W)
    thetas = orientation(s_idx, y, x, scale)
    descs = descriptor(s_idx, y, x, scale, thetas)
    pad = max_keypoints - k

    def padk(a):
        return F.pad(a, (0, 0) * (a.ndim - 1) + (0, pad))

    return Features(
        xys=padk(torch.stack([x, y], dim=-1)),
        scales=padk(scale),
        orientations=padk(thetas),
        descriptors=padk(torch.where(valid[:, None], descs, torch.zeros_like(descs))),
        scores=padk(top_scores),
        valid=padk(valid),
    )


def normalized_image_coordinates(xys: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """OpenSfM normalized coords: centred, divided by max(w, h)."""
    size = max(width, height)
    return torch.stack([(xys[..., 0] + 0.5 - width / 2.0) / size,
                        (xys[..., 1] + 0.5 - height / 2.0) / size], dim=-1)


def denormalized_image_coordinates(norm_xys: np.ndarray, width: int,
                                   height: int) -> np.ndarray:
    size = max(width, height)
    return np.stack([norm_xys[..., 0] * size - 0.5 + width / 2.0,
                     norm_xys[..., 1] * size - 0.5 + height / 2.0], axis=-1)


def to_grayscale(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img.astype(np.float32)
    w = np.array([0.299, 0.587, 0.114], np.float32)
    out = img.astype(np.float32) @ w
    if img.dtype == np.uint8:
        out = out / 255.0
    return out
