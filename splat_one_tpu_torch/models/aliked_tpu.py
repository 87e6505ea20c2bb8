"""Learned keypoint detector / descriptor (ALIKED): the port of
``splat_one_tpu/models/aliked_tpu.py``.

Two tiers share the ``sfm.features.Features`` contract:

1. Checkpoint-faithful ALIKED (``aliked_encoder``, ``sddh_descriptors``,
   ``extract_aliked_ckpt``): ConvBlock / ResBlock encoder over 1, 1/2,
   1/8 and 1/32 resolutions with SELU gates and eval-mode BatchNorm,
   1x1-conv aggregation to ``dim`` channels (the coarse maps upsampled
   bilinearly with aligned corners, by the JAX package's gather formula),
   the sigmoid score head, DKD (3x3 NMS, top-K in ``jax.lax.top_k``'s
   order, soft-argmax refinement) and the SDDH deformable descriptor
   head (bilinear sampling with zero padding). Parameters carry the
   official state-dict names; K and M are read from the weights.
2. The compact trainable tier (``init_aliked``, ``aliked_forward``,
   ``extract_aliked``).

Parameters: a dict of tensors on one device with PyTorch's OIHW
convolutions. ``params_from_numpy`` takes the JAX package's dict (HWIO,
the layout ``scripts/convert_weights.py aliked`` writes) and
``params_to_numpy`` gives it back, so one ``.npz`` serves both packages.
Images and maps cross the API channels-last, as in JAX; inside,
convolutions run NCHW through ``features._f32_conv`` (cuDNN, TF32 off).
Random initialization draws from a ``torch.Generator`` seeded 0: JAX's
shapes and distributions, not its ``PRNGKey`` bits.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from splat_one_tpu_torch.sfm.features import Features, _f32_conv, top_k
from splat_one_tpu_torch.utils.device import resolve as resolve_device

# Official model configurations (c1..c4 block widths, aggregated dim,
# SDDH patch size K and sample count M).
ALIKED_CFGS = {
    "aliked-t16": dict(c1=8, c2=16, c3=32, c4=64, dim=64, K=3, M=16),
    "aliked-n16": dict(c1=16, c2=32, c3=64, c4=128, dim=128, K=3, M=16),
    "aliked-n16rot": dict(c1=16, c2=32, c3=64, c4=128, dim=128, K=3, M=16),
    "aliked-n32": dict(c1=16, c2=32, c3=64, c4=128, dim=128, K=3, M=32),
}

_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def params_from_numpy(d, device="cuda") -> Dict[str, torch.Tensor]:
    """The JAX package's parameter dict (numpy or array-likes; HWIO
    convolutions) as the port's tensors on ``device`` (OIHW)."""
    dev = resolve_device(device)
    out = {}
    for k, v in d.items():
        a = np.asarray(v, np.float32)
        if a.ndim == 4:  # HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.tensor(np.ascontiguousarray(a), device=dev)
    return out


def params_to_numpy(p) -> Dict[str, np.ndarray]:
    """The port's parameters as the JAX package's numpy dict (HWIO)."""
    out = {}
    for k, v in p.items():
        a = v.detach().cpu().numpy()
        out[k] = a.transpose(2, 3, 1, 0).copy() if a.ndim == 4 else a
    return out


def _selu(x):
    """SELU as ``jax.nn.selu`` writes it (``expm1`` on the negative side)."""
    return _SELU_SCALE * torch.where(x > 0, x, _SELU_ALPHA * torch.expm1(x))


# --------------------------------------------------------------------------
# checkpoint-faithful tier
# --------------------------------------------------------------------------
def _conv2d(x, w, b=None):
    """NCHW convolution, OIHW weights, stride 1, "SAME" (odd kernels)."""
    with _f32_conv():
        y = F.conv2d(x, w, padding=w.shape[-1] // 2)
    return y if b is None else y + b[:, None, None]


def _bn(p, name, x, eps=1e-5):
    """BatchNorm2d in eval mode; a checkpoint without norm parameters
    (Identity norm) skips."""
    if f"{name}.running_mean" not in p:
        return x
    mean = p[f"{name}.running_mean"]
    var = p[f"{name}.running_var"]
    w = p.get(f"{name}.weight", torch.ones_like(mean))
    b = p.get(f"{name}.bias", torch.zeros_like(mean))
    c = lambda t: t[:, None, None]
    return (x - c(mean)) * c(w * torch.rsqrt(var + eps)) + c(b)


def _conv_block(p, name, x):
    """conv3x3 -> BN -> SELU, twice."""
    x = _selu(_bn(p, f"{name}.bn1", _conv2d(x, p[f"{name}.conv1.weight"])))
    return _selu(_bn(p, f"{name}.bn2", _conv2d(x, p[f"{name}.conv2.weight"])))


def _res_block(p, name, x):
    """Basic residual block with a plain 1x1-conv shortcut."""
    idn = x
    if f"{name}.downsample.weight" in p:
        idn = _conv2d(x, p[f"{name}.downsample.weight"], p.get(f"{name}.downsample.bias"))
    out = _selu(_bn(p, f"{name}.bn1", _conv2d(x, p[f"{name}.conv1.weight"])))
    out = _bn(p, f"{name}.bn2", _conv2d(out, p[f"{name}.conv2.weight"]))
    return _selu(out + idn)


def _avg_pool(x, k):
    return F.avg_pool2d(x, k, stride=k)


def _upsample_bilinear(x, out_hw):
    """Bilinear resize of NCHW ``x``, align_corners=True (src = dst * (in -
    1) / (out - 1)), by the JAX package's gather formula."""
    _, _, H, W = x.shape
    oh, ow = out_hw
    dev = x.device

    def axis_idx(n_in, n_out):
        if n_out == 1 or n_in == 1:
            z = torch.zeros((n_out,), dtype=torch.float32, device=dev)
            return z, z, z
        src = torch.arange(n_out, dtype=torch.float32, device=dev) * ((n_in - 1) / (n_out - 1))
        i0 = torch.clamp(torch.floor(src), 0, n_in - 1)
        i1 = torch.clamp(i0 + 1, 0, n_in - 1)
        return i0, i1, src - i0

    y0, y1, fy = axis_idx(H, oh)
    x0, x1, fx = axis_idx(W, ow)
    y0i, y1i, x0i, x1i = (t.to(torch.int64) for t in (y0, y1, x0, x1))
    fx_ = fx[None, None, None, :]
    fy_ = fy[None, None, :, None]
    top = x[:, :, y0i][..., x0i] * (1 - fx_) + x[:, :, y0i][..., x1i] * fx_
    bot = x[:, :, y1i][..., x0i] * (1 - fx_) + x[:, :, y1i][..., x1i] * fx_
    return top * (1 - fy_) + bot * fy_


def aliked_encoder(params: Dict, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """image [B, H, W, 3] in [0, 1] -> (score_map [B, H, W], feature_map
    [B, H, W, dim] L2-normalized). H, W must be multiples of 32."""
    p = params
    x = image.permute(0, 3, 1, 2)
    x1 = _conv_block(p, "block1", x)
    x2 = _res_block(p, "block2", _avg_pool(x1, 2))
    x3 = _res_block(p, "block3", _avg_pool(x2, 4))
    x4 = _res_block(p, "block4", _avg_pool(x3, 4))
    agg = lambda i, z: _selu(_conv2d(z, p[f"conv{i}.weight"], p.get(f"conv{i}.bias")))
    hw = x.shape[2:]
    x1234 = torch.cat([agg(1, x1), _upsample_bilinear(agg(2, x2), hw),
                       _upsample_bilinear(agg(3, x3), hw), _upsample_bilinear(agg(4, x4), hw)],
                      dim=1)
    s = x1234
    for i in (0, 2, 4):
        s = _selu(_conv2d(s, p[f"score_head.{i}.weight"], p.get(f"score_head.{i}.bias")))
    s = _conv2d(s, p["score_head.6.weight"], p.get("score_head.6.bias"))
    score = torch.sigmoid(s)[:, 0]
    feat = x1234 / torch.clamp(torch.linalg.norm(x1234, dim=1, keepdim=True), min=1e-12)
    return score, feat.permute(0, 2, 3, 1)


def _bilinear_sample(feat: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """grid_sample(bilinear, align_corners=True, zeros padding) at pixel
    positions. feat [H, W, C]; pos [..., 2] (x, y) -> [..., C]."""
    H, W, _ = feat.shape
    x, y = pos[..., 0], pos[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    def tap(yi, xi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        v = feat[torch.clamp(yi, 0, H - 1).to(torch.int64), torch.clamp(xi, 0, W - 1).to(torch.int64)]
        return torch.where(inb[..., None], v, torch.zeros_like(v))

    return (tap(y0, x0) * ((1 - fx) * (1 - fy))[..., None]
            + tap(y0, x0 + 1) * (fx * (1 - fy))[..., None]
            + tap(y0 + 1, x0) * ((1 - fx) * fy)[..., None]
            + tap(y0 + 1, x0 + 1) * (fx * fy)[..., None])


def _as_in_out(w):
    """A 1x1 OIHW convolution weight as an [in, out] matrix."""
    return w.reshape(w.shape[0], w.shape[1]).t()


def sddh_descriptors(params: Dict, feat: torch.Tensor, kpts: torch.Tensor, K: int = 3,
                     M: int = 16) -> torch.Tensor:
    """SDDH deformable descriptor head at pixel keypoints. feat [H, W, dim]
    (the L2-normalized aggregate map); kpts [N, 2] (x, y) -> desc [N, dim]
    L2-normalized: the KxK patch at the truncated centre -> offset_conv
    (KxK valid conv -> SELU -> 1x1) -> M (dx, dy) offsets -> bilinear
    samples -> 1x1 sf_conv + SELU -> the [M, dim, dim] aggregation."""
    p = params
    H, W, C = feat.shape
    N = kpts.shape[0]
    r = K // 2
    cx = kpts[:, 0].to(torch.int64)
    cy = kpts[:, 1].to(torch.int64)
    fpad = F.pad(feat, (0, 0, r, r, r, r))
    offs = torch.arange(K, device=feat.device) - r
    py = cy[:, None, None] + offs[None, :, None] + r
    px = cx[:, None, None] + offs[None, None, :] + r
    patches = fpad[py, px]  # [N, K, K, C]
    with _f32_conv():
        o = F.conv2d(patches.permute(0, 3, 1, 2), p["desc_head.offset_conv.0.weight"])
    o = _selu(o.reshape(N, -1) + p["desc_head.offset_conv.0.bias"])
    o = o @ _as_in_out(p["desc_head.offset_conv.2.weight"]) + p["desc_head.offset_conv.2.bias"]
    pos = kpts[:, None, :].to(torch.float32) + o.reshape(N, M, 2)  # (dx, dy) per sample
    sampled = _bilinear_sample(feat, pos)  # [N, M, C]
    sampled = _selu(torch.einsum("nmc,cd->nmd", sampled, _as_in_out(p["desc_head.sf_conv.weight"])))
    desc = torch.einsum("nmc,mcd->nd", sampled, p["desc_head.agg_weights"])
    return desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-12)


def _dkd_keypoints(score: torch.Tensor, max_keypoints: int, score_threshold: float):
    """Parameter-free keypoint decode: 3x3 NMS, top-K, soft-argmax
    sub-pixel refinement in the 3x3 window."""
    H, W = score.shape
    mx = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    is_peak = (score >= mx) & (score > score_threshold)
    flat = torch.where(is_peak, score, torch.zeros_like(score)).reshape(-1)
    top, idx = top_k(flat, min(max_keypoints, flat.shape[0]))
    valid = top > 0
    yi = idx // W
    xi = idx % W
    offs = torch.tensor([-1, 0, 1], device=score.device)
    ny = torch.clamp(yi[:, None, None] + offs[None, :, None], 0, H - 1)
    nx = torch.clamp(xi[:, None, None] + offs[None, None, :], 0, W - 1)
    w = score[ny, nx]
    w = w / torch.clamp(torch.sum(w, dim=(1, 2), keepdim=True), min=1e-8)
    dy = torch.sum(w * offs[None, :, None], dim=(1, 2))
    dx = torch.sum(w * offs[None, None, :], dim=(1, 2))
    xy = torch.stack([xi.to(torch.float32) + dx, yi.to(torch.float32) + dy], -1)
    return xy, top, valid


def _features(xy, scores, valid, descs):
    k = xy.shape[0]
    return Features(xys=xy, scales=torch.full((k,), 2.0, device=xy.device),
                    orientations=torch.zeros((k,), device=xy.device),
                    descriptors=torch.where(valid[:, None], descs, torch.zeros_like(descs)),
                    scores=scores, valid=valid)


def extract_aliked_ckpt(
    params: Dict,
    image: torch.Tensor,  # [H, W] grayscale or [H, W, 3] RGB in [0, 1]
    max_keypoints: int = 2048,
    score_threshold: float = 0.2,
    K: int | None = None,
    M: int | None = None,
) -> Features:
    """Checkpoint-faithful extraction on the parameters' device: encoder
    (the image padded to a multiple of 32) -> DKD -> SDDH descriptors at
    the refined keypoints. K and M default to the checkpoint's shapes."""
    if K is None:
        K = params["desc_head.offset_conv.0.weight"].shape[-1]
    if M is None:
        M = params["desc_head.agg_weights"].shape[0]
    image = image.to(torch.float32)
    if image.ndim == 2:
        image = image[..., None].expand(image.shape + (3,))
    H, W = image.shape[:2]
    padded = F.pad(image, (0, 0, 0, (-W) % 32, 0, (-H) % 32))
    score, feat = aliked_encoder(params, padded[None])
    score, feat = score[0, :H, :W], feat[0, :H, :W]
    xy, scores, valid = _dkd_keypoints(score, max_keypoints, score_threshold)
    return _features(xy, scores, valid, sddh_descriptors(params, feat, xy, K=int(K), M=int(M)))


def init_aliked_ckpt(cfg: str = "aliked-n16", device="cuda") -> Dict:
    """Random parameters in the official state-dict schema (OIHW), drawn
    from a CPU generator seeded 0: the JAX package's shapes and
    distributions."""
    c = ALIKED_CFGS[cfg]
    c1, c2, c3, c4, dim, K, M = (c[k] for k in ("c1", "c2", "c3", "c4", "dim", "K", "M"))
    g = torch.Generator().manual_seed(0)
    p: Dict = {}
    rn = lambda *s: torch.randn(*s, generator=g)

    def conv(name, kk, cin, cout, bias=True):
        p[f"{name}.weight"] = rn(cout, cin, kk, kk) * math.sqrt(2.0 / (kk * kk * cin))
        if bias:
            p[f"{name}.bias"] = torch.zeros(cout)

    def bn(name, ch):
        p[f"{name}.weight"] = 1 + 0.1 * rn(ch)
        p[f"{name}.bias"] = 0.1 * rn(ch)
        p[f"{name}.running_mean"] = 0.1 * rn(ch)
        p[f"{name}.running_var"] = 1 + 0.1 * torch.abs(rn(ch))

    conv("block1.conv1", 3, 3, c1, bias=False)
    bn("block1.bn1", c1)
    conv("block1.conv2", 3, c1, c1, bias=False)
    bn("block1.bn2", c1)
    for name, cin, cout in (("block2", c1, c2), ("block3", c2, c3), ("block4", c3, c4)):
        conv(f"{name}.conv1", 3, cin, cout, bias=False)
        bn(f"{name}.bn1", cout)
        conv(f"{name}.conv2", 3, cout, cout, bias=False)
        bn(f"{name}.bn2", cout)
        conv(f"{name}.downsample", 1, cin, cout)
    for i, ch in enumerate((c1, c2, c3, c4), start=1):
        conv(f"conv{i}", 1, ch, dim // 4)
    conv("score_head.0", 1, dim, 8)
    conv("score_head.2", 3, 8, 4)
    conv("score_head.4", 3, 4, 4)
    conv("score_head.6", 3, 4, 1)
    conv("desc_head.offset_conv.0", K, dim, 2 * M)
    conv("desc_head.offset_conv.2", 1, 2 * M, 2 * M)
    conv("desc_head.sf_conv", 1, dim, dim, bias=False)
    p["desc_head.agg_weights"] = rn(M, dim, dim) * 0.1
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in p.items()}


# --------------------------------------------------------------------------
# trainable compact tier
# --------------------------------------------------------------------------
def _conv(p, name, x):
    return _conv2d(x, p[f"{name}_w"], p[f"{name}_b"])


def init_aliked(desc_dim: int = 128, device="cuda") -> Dict:
    """The compact tier's random parameters (OIHW), He-normal from a CPU
    generator seeded 0."""
    g = torch.Generator().manual_seed(0)
    p: Dict = {}
    for name, k, cin, cout in (("c1", 3, 1, 32), ("c2", 3, 32, 64), ("c3", 3, 64, 128),
                               ("c4", 3, 128, 128), ("score1", 3, 128, 64),
                               ("score2", 1, 64, 1), ("desc1", 3, 128, desc_dim),
                               ("desc2", 1, desc_dim, desc_dim)):
        p[f"{name}_w"] = torch.randn(cout, cin, k, k, generator=g) * math.sqrt(2.0 / (k * k * cin))
        p[f"{name}_b"] = torch.zeros(cout)
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in p.items()}


def aliked_forward(params: Dict, image: torch.Tensor):
    """image [B, H, W, 1] -> (score [B, H, W], desc [B, H, W, D])."""
    x = torch.relu(_conv(params, "c1", image.permute(0, 3, 1, 2)))
    x = torch.relu(_conv(params, "c2", x))
    x = torch.relu(_conv(params, "c3", x))
    x = torch.relu(_conv(params, "c4", x)) + x
    s = torch.relu(_conv(params, "score1", x))
    score = torch.sigmoid(_conv(params, "score2", s))[:, 0]
    desc = _conv(params, "desc2", torch.relu(_conv(params, "desc1", x)))
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True), min=1e-8)
    return score, desc.permute(0, 2, 3, 1)


def extract_aliked(
    params: Dict,
    image: torch.Tensor,  # [H, W] grayscale in [0, 1]
    max_keypoints: int = 2048,
    score_threshold: float = 0.2,
) -> Features:
    """The compact tier's Features: DKD keypoints, descriptors read at the
    truncated keypoint pixel."""
    image = image.to(torch.float32)
    H, W = image.shape
    score, desc = aliked_forward(params, image[None, ..., None])
    score, desc = score[0], desc[0]
    xy, top, valid = _dkd_keypoints(score, max_keypoints, score_threshold)
    yi = torch.clamp(xy[:, 1].to(torch.int64), 0, H - 1)
    xi = torch.clamp(xy[:, 0].to(torch.int64), 0, W - 1)
    return _features(xy, top, valid, desc[yi, xi])


def is_faithful(params: Dict) -> bool:
    """Whether ``params`` are in the official schema (the faithful tier)."""
    return "block1.conv1.weight" in params


def load_aliked(checkpoint: Optional[str] = None, desc_dim: int = 128, device="cuda"):
    """Converted ALIKED weights from the ``.npz`` the JAX loader reads: the
    official schema selects the faithful tier; any other npz overlays the
    compact tier's initialization; no file, the initialization alone."""
    if checkpoint and os.path.exists(checkpoint):
        with np.load(checkpoint) as z:
            loaded = params_from_numpy({k: z[k] for k in z.files}, device)
        if is_faithful(loaded):
            return loaded
        params = init_aliked(desc_dim, device=device)
        params.update(loaded)
        return params
    return init_aliked(desc_dim, device=device)
