"""ORB features (FAST corners + rotated BRIEF): the port of ``splat_one_tpu/sfm/orb.py``.

- FAST-9 over the whole image at once: the 16 Bresenham-circle taps are
  16 rolled copies of the image; the brighter / darker states pack into
  one int32 plane a pixel, and "9 contiguous on the circle" is 8 ANDs of
  arithmetically shifted copies (torch's ``>>`` on int32 is arithmetic,
  as JAX's).
- Harris response (k = 0.04) from separable box sums of the gradient
  products ranks the candidates; 3x3 non-max suppression.
- Orientation by the intensity centroid in a radius-8 disc.
- rBRIEF: 256 seeded test pairs (numpy ``default_rng(7)``, the JAX
  package's array) in a 31x31 patch, rotated by the orientation and
  sampled bilinearly; bits emitted as +/-1/sqrt(256) floats, so the
  dot-product matcher is monotone in Hamming distance.
- Scale: a pyramid of factor 1.2 with a per-level budget; coordinates map
  back to level 0.

Everything runs on the image tensor's device in f32. Top-K follows
``jax.lax.top_k``'s order (``features.top_k``), so even the invalid
tail's rows are JAX's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from splat_one_tpu_torch.sfm.features import Features, top_k

# 16 Bresenham circle offsets (radius 3), OpenCV tap order.
_CIRCLE = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
        (-1, 3),
    ],
    np.int32,
)  # (dy, dx)

N_BITS = 256
_PATCH = 15  # half-size of the BRIEF patch (31x31)


def _brief_pairs(seed: int = 7) -> np.ndarray:
    """[N_BITS, 4] (y1, x1, y2, x2) test pairs, i.i.d. gaussian sigma =
    patch/5 clipped to the patch (the BRIEF paper's G-II layout)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, _PATCH / 5.0, size=(N_BITS, 4))
    return np.clip(pts, -_PATCH + 1, _PATCH - 1).astype(np.float32)


_PAIRS = _brief_pairs()


def _shift2(x, dy, dx):
    return torch.roll(torch.roll(x, dy, dims=0), dx, dims=1)


def _box_sum(x, r):
    """(2r+1)^2 box sum via two separable shifted-add passes."""
    for axis in (0, 1):
        acc = x
        for d in range(1, r + 1):
            acc = acc + torch.roll(x, d, dims=axis) + torch.roll(x, -d, dims=axis)
        x = acc
    return x


def _interior(H, W, b, device):
    yy = torch.arange(H, device=device)[:, None]
    xx = torch.arange(W, device=device)[None, :]
    return (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)


def _nms3(resp):
    """3x3 max over a "SAME" window padded with -inf."""
    return F.max_pool2d(resp[None, None], 3, stride=1, padding=1)[0, 0]


def _fast_score(image: torch.Tensor, thresh: float):
    """FAST-9 corner mask + Harris response for ranking."""
    H, W = image.shape
    taps = torch.stack([_shift2(image, -int(dy), -int(dx)) for dy, dx in _CIRCLE])
    brighter = taps > image[None] + thresh
    darker = taps < image[None] - thresh

    def arc9(bits):
        # any 9 circularly-contiguous set bits: one int32 plane, 8 ANDs
        m = torch.zeros((H, W), dtype=torch.int32, device=image.device)
        for k in range(16):
            m = m | (bits[k].to(torch.int32) << k)
        m = m | (m << 16)  # duplicate for circular runs
        acc = m
        for s in range(1, 9):
            acc = acc & (m >> s)
        return (acc & 0xFFFF) != 0

    corner = arc9(brighter) | arc9(darker)
    gx = 0.5 * (_shift2(image, 0, -1) - _shift2(image, 0, 1))
    gy = 0.5 * (_shift2(image, -1, 0) - _shift2(image, 1, 0))
    sxx = _box_sum(gx * gx, 2)
    syy = _box_sum(gy * gy, 2)
    sxy = _box_sum(gx * gy, 2)
    harris = sxx * syy - sxy * sxy - 0.04 * (sxx + syy) ** 2
    # exclude borders (circle radius + BRIEF patch + rotation margin)
    return corner & _interior(H, W, _PATCH + 7, image.device), harris


def _orientation(image: torch.Tensor, ys, xs):
    """Intensity-centroid orientation in a radius-8 disc at (ys, xs)."""
    r = 8
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    disc = (dy * dy + dx * dx) <= r * r
    dev = image.device
    py = ys[:, None] + torch.as_tensor(dy[disc], dtype=torch.int64, device=dev)[None, :]
    px = xs[:, None] + torch.as_tensor(dx[disc], dtype=torch.int64, device=dev)[None, :]
    vals = image[py, px]  # [K, n_disc]
    m10 = torch.sum(vals * torch.as_tensor(dx[disc], dtype=torch.float32, device=dev)[None], 1)
    m01 = torch.sum(vals * torch.as_tensor(dy[disc], dtype=torch.float32, device=dev)[None], 1)
    return torch.atan2(m01, m10)


def _brief_samples(image: torch.Tensor, ys, xs, theta):
    """The two bilinear samples (a, b) [K, N_BITS] of every rotated-BRIEF
    test at integer keypoints; bit = a < b."""
    pairs = torch.as_tensor(_PAIRS, device=image.device)  # [N, 4] (y1, x1, y2, x2)
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    xs_f, ys_f = xs[:, None], ys[:, None]

    def sample(py, px):
        # bilinear at offsets rotated by +theta
        fx = xs_f + px[None, :] * c - py[None, :] * s
        fy = ys_f + px[None, :] * s + py[None, :] * c
        y0 = torch.floor(fy)
        x0 = torch.floor(fx)
        wy = fy - y0
        wx = fx - x0
        y0i = y0.to(torch.int64)
        x0i = x0.to(torch.int64)
        v00 = image[y0i, x0i]
        v01 = image[y0i, x0i + 1]
        v10 = image[y0i + 1, x0i]
        v11 = image[y0i + 1, x0i + 1]
        return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
                + v10 * wy * (1 - wx) + v11 * wy * wx)

    return sample(pairs[:, 0], pairs[:, 1]), sample(pairs[:, 2], pairs[:, 3])


def _resize_half_steps(image: torch.Tensor, scale: float):
    """Bilinear resize by 1/scale (pixel-centre sampling)."""
    H, W = image.shape
    dev = image.device
    oh, ow = int(round(H / scale)), int(round(W / scale))
    sy = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * (H / oh) - 0.5
    sx = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * (W / ow) - 0.5
    y0 = torch.clamp(torch.floor(sy), 0, H - 2).to(torch.int64)
    x0 = torch.clamp(torch.floor(sx), 0, W - 2).to(torch.int64)
    fy = torch.clamp(sy - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(sx - x0, 0.0, 1.0)[None, :]
    g = image[y0][:, x0]
    gr = image[y0][:, x0 + 1]
    gd = image[y0 + 1][:, x0]
    gdr = image[y0 + 1][:, x0 + 1]
    return (g * (1 - fy) * (1 - fx) + gr * (1 - fy) * fx
            + gd * fy * (1 - fx) + gdr * fy * fx)


def _descriptors(image, ys, xs, theta, ok):
    a, b = _brief_samples(image, ys, xs, theta)
    desc = ((a < b).to(torch.float32) * 2.0 - 1.0) / np.sqrt(float(N_BITS))
    return torch.where(ok[:, None], desc, torch.zeros_like(desc))


def extract_orb(
    image: torch.Tensor,  # [H, W] grayscale in [0, 1]
    max_keypoints: int = 2048,
    fast_threshold: float = 0.06,
    n_levels: int = 4,
    scale_factor: float = 1.2,
) -> Features:
    """ORB features in the shared ``Features`` layout, on the image's
    device. Descriptors are +/-1/sqrt(256) floats (unit L2), so dot-product
    similarity equals 1 - 2*hamming/256."""
    image = image.to(torch.float32)
    dev = image.device
    per_level = -(-max_keypoints // n_levels)
    all_xy, all_scale, all_theta, all_desc, all_score = [], [], [], [], []
    img_l = image
    for lvl in range(n_levels):
        lscale = scale_factor ** lvl
        if lvl > 0:
            img_l = _resize_half_steps(image, lscale)
        corner, harris = _fast_score(img_l, fast_threshold)
        ninf = torch.full_like(harris, -torch.inf)
        resp = torch.where(corner, harris, ninf)
        flat = torch.where((resp >= _nms3(resp)) & corner, resp, ninf).reshape(-1)
        top, idx = top_k(flat, per_level)
        ok = torch.isfinite(top)
        Hl, Wl = img_l.shape
        ys = torch.clamp(idx // Wl, _PATCH + 7, Hl - _PATCH - 8)
        xs = torch.clamp(idx % Wl, _PATCH + 7, Wl - _PATCH - 8)
        theta = _orientation(img_l, ys, xs)
        all_xy.append(torch.stack([xs.to(torch.float32), ys.to(torch.float32)], -1) * lscale)
        all_scale.append(torch.full((per_level,), lscale, device=dev))
        all_theta.append(theta)
        all_desc.append(_descriptors(img_l, ys, xs, theta, ok))
        all_score.append(torch.where(ok, top, torch.zeros_like(top)))
    xys = torch.cat(all_xy)
    scores = torch.cat(all_score)
    # keep the global top max_keypoints by response
    sel_score, sel = top_k(torch.where(scores > 0, scores, torch.full_like(scores, -torch.inf)),
                           max_keypoints)
    finite = torch.isfinite(sel_score)
    return Features(
        xys=xys[sel],
        scales=torch.cat(all_scale)[sel],
        orientations=torch.cat(all_theta)[sel],
        descriptors=torch.cat(all_desc)[sel],
        scores=torch.where(finite, sel_score, torch.zeros_like(sel_score)),
        valid=finite & (sel_score > 0),
    )


def extract_harris(
    image: torch.Tensor,
    max_keypoints: int = 2048,
    corner_threshold: float = 1e-6,
) -> Features:
    """Harris corners ranked over the valid interior (no FAST test), with
    the rotated-BRIEF orientation and descriptor."""
    image = image.to(torch.float32)
    _, harris = _fast_score(image, 1e9)
    H, W = image.shape
    b = _PATCH + 7
    ninf = torch.full_like(harris, -torch.inf)
    resp = torch.where(_interior(H, W, b, image.device) & (harris > corner_threshold),
                       harris, ninf)
    flat = torch.where(resp >= _nms3(resp), resp, ninf).reshape(-1)
    top, idx = top_k(flat, max_keypoints)
    ok = torch.isfinite(top)
    ys = torch.clamp(idx // W, b, H - b - 1)
    xs = torch.clamp(idx % W, b, W - b - 1)
    theta = _orientation(image, ys, xs)
    return Features(
        xys=torch.stack([xs.to(torch.float32), ys.to(torch.float32)], -1),
        scales=torch.full((max_keypoints,), 1.0, device=image.device),
        orientations=theta,
        descriptors=_descriptors(image, ys, xs, theta, ok),
        scores=torch.where(ok, top, torch.zeros_like(top)),
        valid=ok & (top > 0),
    )
