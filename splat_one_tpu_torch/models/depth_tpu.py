"""Monocular depth (Depth-Anything-V2): the port of
``splat_one_tpu/models/depth_tpu.py``.

Two forwards behind ``DepthAnythingTPU.infer_image`` (the class keeps
the JAX package's name):

1. ``depth_forward_faithful``: DA-V2 as published, from a checkpoint
   converted by ``scripts/convert_weights.py depth`` (its ``.npz``
   layout: linear weights [in, out], the DPT head's tensors under their
   state-dict names in PyTorch's layouts, ``_encoder`` a 0-d string):
   the DINOv2 ViT with a cls token, fused qkv, LayerScale and exact GELU;
   the DPT head with its resize layers, scratch convolutions,
   residual-conv-unit fusion blocks and aligned-corner bilinear
   upsampling. Picked when the weights have ``depth_head.scratch.*``.
2. ``depth_forward``: the compact tier on ``transformer._block`` (tanh
   GELU), with a seeded init when there is no checkpoint; its output is
   then normalised to [0, 1], as JAX's.

Written as the JAX package writes it: layer norms by formula (eps 1e-6),
attention as matmul, softmax, matmul, ``_gelu_exact`` with ``erf``, the
aligned-corner resize as JAX's gather formula (the sample positions and
weights from ``jnp.linspace``'s float32 arithmetic, on the host), the
stride-s transposed convolutions as an einsum pixel expansion; the
convolutions run NCHW through ``features._f32_conv`` (cuDNN, TF32 off).
The host work of ``infer_image`` (PIL resizes on uint8 in and in "F"
mode out), ``infer_equirectangular`` (6 perspective crops) and
``infer_fisheye`` (the ERP resample and Newton inversion) is JAX's numpy;
the networks run on ``device``, CUDA unless ``device="cpu"``. The seeded
init draws from a ``torch.Generator``: JAX's shapes and distributions,
not its bits.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from splat_one_tpu_torch.models.transformer import (
    _block, _init_block, _init_linear, _init_ln, _linear,
)
from splat_one_tpu_torch.sfm.features import _f32_conv
from splat_one_tpu_torch.utils.device import resolve as resolve_device

CONFIGS = {  # the reference's encoder table
    "vits": dict(width=384, depth=12, heads=6, features=64),
    "vitb": dict(width=768, depth=12, heads=12, features=128),
    "vitl": dict(width=1024, depth=24, heads=16, features=256),
    "vitg": dict(width=1536, depth=40, heads=24, features=384),
}
PATCH = 14
IMG = 518  # 37 x 37 patches (DINOv2's convention)
_SQRT2 = float(np.sqrt(2.0).astype(np.float32))


def params_from_numpy(d, device="cuda") -> Dict:
    """The JAX package's depth dict (numpy; the converter's layout, which
    the port keeps) as tensors on ``device``; ``_encoder`` as a str."""
    dev = resolve_device(device)
    return {k: str(np.asarray(v)) if k == "_encoder"
            else torch.tensor(np.asarray(v, np.float32), device=dev) for k, v in d.items()}


def init_depth_model(gen: torch.Generator, encoder: str = "vits") -> Dict:
    """The compact tier's parameters (CPU), drawn from ``gen``."""
    cfg = CONFIGS[encoder]
    C, D, Fe = cfg["width"], cfg["depth"], cfg["features"]
    params: Dict = {"_encoder": encoder}
    _init_linear(gen, "patch", PATCH * PATCH * 3, C, params)
    n = IMG // PATCH
    params["pos"] = torch.randn(1, n * n, C, generator=gen) * 0.02
    for d in range(D):
        _init_block(gen, f"b{d}", C, params)
    _init_ln("ln_f", C, params)
    # DPT: the 4 tapped stages projected to F, fused coarse to fine
    for i in range(4):
        _init_linear(gen, f"tap{i}", C, Fe, params)
    for i in range(4):
        _init_linear(gen, f"fuse{i}", Fe, Fe, params)
    _init_linear(gen, "head_1", Fe, Fe // 2, params)
    _init_linear(gen, "head_2", Fe // 2, 1, params)
    return params


def _patchify(image):
    B, H, W, _ = image.shape
    return image.reshape(B, H // PATCH, PATCH, W // PATCH, PATCH, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(B, (H // PATCH) * (W // PATCH), PATCH * PATCH * 3)


def depth_forward(params: Dict, image: torch.Tensor) -> torch.Tensor:
    """The compact tier: image [B, IMG, IMG, 3] in [0, 1] -> relative
    inverse depth [B, 2S, 2S] (patch resolution, upsampled 2x)."""
    cfg = CONFIGS[params["_encoder"]]
    D = cfg["depth"]
    B, H, W, _ = image.shape
    x = _linear(params, "patch", _patchify(image)) + params["pos"]
    taps = []
    tap_at = {D // 4 - 1, D // 2 - 1, 3 * D // 4 - 1, D - 1}
    for d in range(D):
        x = _block(params, f"b{d}", x, cfg["heads"])
        if d in tap_at:
            taps.append(x)
    side = H // PATCH
    feats = [_linear(params, f"tap{i}", t).reshape(B, side, side, -1)
             for i, t in enumerate(taps)]
    # coarse-to-fine fusion (residual refinement, DPT-style)
    fused = feats[-1]
    for i in range(2, -1, -1):
        fused = torch.relu(_linear(params, f"fuse{i}", fused + feats[i]))
    up = fused.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    h = torch.relu(_linear(params, "head_1", up))
    return torch.relu(_linear(params, "head_2", h))[..., 0]


# ---------------------------------------------------------------------------
# the checkpoint-faithful forward (DA-V2: DINOv2 backbone + DPT head)
# ---------------------------------------------------------------------------
# DA-V2's intermediate_layer_idx (vits / vitb [2, 5, 8, 11], vitl [4, 11,
# 17, 23], vitg [9, 19, 29, 39]) is {D/4 - 1, D/2 - 1, 3D/4 - 1, D - 1}.


def _gelu_exact(x):
    return 0.5 * x * (1.0 + torch.erf(x / _SQRT2))


def _ln_sb(p, prefix, x, eps=1e-6):
    """Layer norm with the converter's ``{prefix}_scale`` / ``_bias`` names."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p[f"{prefix}_scale"] + p[f"{prefix}_bias"]


def _dino_block(p, prefix, x, n_heads):
    """DINOv2 ViT block: pre-LN, fused qkv, LayerScale, exact GELU."""
    B, N, C = x.shape
    h = _ln_sb(p, f"{prefix}_ln1", x)
    qkv = h @ p[f"{prefix}_qkv_w"] + p[f"{prefix}_qkv_b"]  # [B, N, 3C]
    q = qkv[..., :C].reshape(B, N, n_heads, -1)
    k = qkv[..., C:2 * C].reshape(B, N, n_heads, -1)
    v = qkv[..., 2 * C:].reshape(B, N, n_heads, -1)
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(C // n_heads)
    att = torch.softmax(att, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, N, C)
    o = o @ p[f"{prefix}_attn_out_w"] + p[f"{prefix}_attn_out_b"]
    if f"{prefix}_ls1" in p:
        o = o * p[f"{prefix}_ls1"]
    x = x + o
    h = _ln_sb(p, f"{prefix}_ln2", x)
    h = _gelu_exact(h @ p[f"{prefix}_mlp1_w"] + p[f"{prefix}_mlp1_b"])
    h = h @ p[f"{prefix}_mlp2_w"] + p[f"{prefix}_mlp2_b"]
    if f"{prefix}_ls2" in p:
        h = h * p[f"{prefix}_ls2"]
    return x + h


def _conv2d_t(x, w_oihw, b=None, stride=1, pad=None):
    """PyTorch's convolution semantics on NHWC ``x``: OIHW weight, explicit
    padding (k // 2 by default), the bias added after."""
    kh, kw = w_oihw.shape[2], w_oihw.shape[3]
    if pad is None:
        pad = (kh // 2, kw // 2)
    with _f32_conv():
        y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, stride=stride, padding=pad)
    y = y.permute(0, 2, 3, 1)
    return y + b if b is not None else y


def _conv_transpose_s(x, w, b, s):
    """ConvTranspose2d with kernel = stride = s (a pixel expansion):
    x [B, h, w, ci], PyTorch's weight [ci, co, s, s]."""
    y = torch.einsum("bhwc,cdij->bhiwjd", x, w)
    B, hh, _, ww, _, co = y.shape
    return y.reshape(B, hh * s, ww * s, co) + b


def _ac_taps(n_in, n_out):
    """Aligned-corner sample taps of one axis, as JAX forms them:
    ``jnp.linspace(0, n_in - 1, n_out)`` in float32 (``stop * i / div``,
    the last exact), floor clipped to [0, n_in - 1], the next index, the
    float32 fraction."""
    if n_out > 1:
        div = n_out - 1
        step = np.arange(div, dtype=np.float32) / np.float32(div)
        pos = np.append(np.float32(n_in - 1.0) * step, np.float32(n_in - 1.0))
    else:
        pos = np.zeros(1, np.float32)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), (pos - i0.astype(np.float32)).astype(np.float32)


def _resize_ac(x, out_h, out_w):
    """Bilinear resize of NHWC ``x`` with aligned corners (PyTorch's
    ``align_corners=True``), JAX's gather formula."""
    B, H, W, C = x.shape
    if H == out_h and W == out_w:
        return x
    dev = x.device
    y0, y1, fy = (torch.as_tensor(a, device=dev) for a in _ac_taps(H, out_h))
    x0, x1, fx = (torch.as_tensor(a, device=dev) for a in _ac_taps(W, out_w))
    fy, fx = fy[None, :, None, None], fx[None, None, :, None]
    r0, r1 = x.index_select(1, y0), x.index_select(1, y1)
    g00, g01 = r0.index_select(2, x0), r0.index_select(2, x1)
    g10, g11 = r1.index_select(2, x0), r1.index_select(2, x1)
    top = g00 * (1 - fx) + g01 * fx
    bot = g10 * (1 - fx) + g11 * fx
    return top * (1 - fy) + bot * fy


def _res_conv_unit(p, prefix, x):
    """DPT ResidualConvUnit: relu-conv-relu-conv + skip."""
    h = _conv2d_t(torch.relu(x), p[f"{prefix}.conv1.weight"], p[f"{prefix}.conv1.bias"])
    h = _conv2d_t(torch.relu(h), p[f"{prefix}.conv2.weight"], p[f"{prefix}.conv2.bias"])
    return x + h


def _fusion_block(p, prefix, x, res=None, out_hw=None):
    """DPT FeatureFusionBlock: (+ rcu1(res)) -> rcu2 -> upsample -> 1x1."""
    if res is not None:
        x = x + _res_conv_unit(p, f"{prefix}.resConfUnit1", res)
    x = _res_conv_unit(p, f"{prefix}.resConfUnit2", x)
    if out_hw is None:
        out_hw = (x.shape[1] * 2, x.shape[2] * 2)
    x = _resize_ac(x, out_hw[0], out_hw[1])
    return _conv2d_t(x, p[f"{prefix}.out_conv.weight"], p[f"{prefix}.out_conv.bias"],
                     pad=(0, 0))


def depth_forward_faithful(params: Dict, image: torch.Tensor) -> torch.Tensor:
    """DA-V2's forward: image [B, H, W, 3], ImageNet-normalized, H and W
    multiples of 14 -> relative inverse depth [B, H, W]."""
    cfg = CONFIGS[str(params["_encoder"])]
    C, D, n_heads = cfg["width"], cfg["depth"], cfg["heads"]
    B, H, W, _ = image.shape
    ph, pw = H // PATCH, W // PATCH
    x = _patchify(image) @ params["patch_w"] + params["patch_b"]
    pos = params["pos"]  # [1, n*n, C] (patch tokens)
    n = int(np.sqrt(pos.shape[1]))
    if (ph, pw) != (n, n):
        pos = _resize_ac(pos.reshape(1, n, n, C), ph, pw).reshape(1, ph * pw, C)
    x = x + pos
    cls_tok = params["cls_token"] + params.get("pos_cls", torch.zeros_like(params["cls_token"]))
    x = torch.cat([cls_tok.expand(B, 1, C), x], dim=1)
    taps = []
    tap_at = {D // 4 - 1, D // 2 - 1, 3 * D // 4 - 1, D - 1}
    for d in range(D):
        x = _dino_block(params, f"b{d}", x, n_heads)
        if d in tap_at:
            # get_intermediate_layers(norm=True): the final LN on every tap,
            # the cls token dropped
            taps.append(_ln_sb(params, "ln_f", x)[:, 1:])
    feats = [(t @ params[f"tap{i}_w"] + params[f"tap{i}_b"]).reshape(B, ph, pw, -1)
             for i, t in enumerate(taps)]
    # resize layers: 4x / 2x transposed conv, identity, stride-2 conv
    h = "depth_head."
    feats[0] = _conv_transpose_s(feats[0], params[h + "resize_layers.0.weight"],
                                 params[h + "resize_layers.0.bias"], 4)
    feats[1] = _conv_transpose_s(feats[1], params[h + "resize_layers.1.weight"],
                                 params[h + "resize_layers.1.bias"], 2)
    feats[3] = _conv2d_t(feats[3], params[h + "resize_layers.3.weight"],
                         params[h + "resize_layers.3.bias"], stride=2)
    rn = [_conv2d_t(feats[i], params[f"{h}scratch.layer{i + 1}_rn.weight"]) for i in range(4)]
    s = h + "scratch."
    p4 = _fusion_block(params, s + "refinenet4", rn[3], out_hw=rn[2].shape[1:3])
    p3 = _fusion_block(params, s + "refinenet3", p4, rn[2], out_hw=rn[1].shape[1:3])
    p2 = _fusion_block(params, s + "refinenet2", p3, rn[1], out_hw=rn[0].shape[1:3])
    p1 = _fusion_block(params, s + "refinenet1", p2, rn[0])
    out = _conv2d_t(p1, params[s + "output_conv1.weight"], params[s + "output_conv1.bias"])
    out = _resize_ac(out, ph * PATCH, pw * PATCH)
    out = torch.relu(_conv2d_t(out, params[s + "output_conv2.0.weight"],
                               params[s + "output_conv2.0.bias"]))
    out = _conv2d_t(out, params[s + "output_conv2.2.weight"], params[s + "output_conv2.2.bias"],
                    pad=(0, 0))
    return torch.relu(out)[..., 0]


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class DepthAnythingTPU:
    """The reference's ``DepthAnythingV2.infer_image`` surface, with its
    networks on ``device``."""

    def __init__(self, encoder: str = "vits", checkpoint: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        init = init_depth_model(torch.Generator().manual_seed(seed), encoder)
        self.params = {k: v.to(self.device) if isinstance(v, torch.Tensor) else v
                       for k, v in init.items()}
        self.has_weights = False
        if checkpoint and os.path.exists(checkpoint):
            with np.load(checkpoint) as z:
                self.params.update(params_from_numpy(
                    {k: z[k] for k in z.files if k != "_encoder"}, self.device))
            self.params["_encoder"] = encoder
            self.has_weights = True
        # a converted DA-V2 checkpoint takes the checkpoint-faithful forward
        self._faithful = self.has_weights and any(
            k.startswith("depth_head.scratch.") for k in self.params)
        self._fwd = depth_forward_faithful if self._faithful else depth_forward

    @torch.no_grad()
    def infer_image(self, bgr: np.ndarray) -> np.ndarray:
        """bgr uint8 [H, W, 3] -> depth float32 [H, W] (relative); without
        weights normalised to [0, 1] (meaningless, but the full network)."""
        from PIL import Image as PILImage

        H, W = bgr.shape[:2]
        rgb = bgr[..., ::-1].astype(np.float32) / 255.0
        im = PILImage.fromarray((rgb * 255).astype(np.uint8)).resize((IMG, IMG))
        arr = np.asarray(im).astype(np.float32) / 255.0
        if self._faithful:
            arr = (arr - IMAGENET_MEAN) / IMAGENET_STD  # DA-V2's preprocessing
        out = self._fwd(self.params, torch.as_tensor(arr[None], device=self.device))[0]
        out = np.asarray(PILImage.fromarray(out.cpu().numpy().astype(np.float32), mode="F")
                         .resize((W, H), PILImage.BILINEAR))
        if not self.has_weights:
            out = out - out.min()
            rng = out.max()
            return out / rng if rng > 0 else np.zeros((H, W), np.float32)
        return out

    def infer_equirectangular(self, bgr: np.ndarray, n_views: int = 4,
                              fov_deg: float = 100.0) -> np.ndarray:
        """Panorama depth: perspective crops around the azimuth and at the
        poles, inferred one by one and stitched with cosine feathering
        (every panorama pixel gathers from each crop it falls in)."""
        H, W = bgr.shape[:2]
        out = np.zeros((H, W), np.float32)
        wsum = np.zeros((H, W), np.float32)
        size = 384
        f = 0.5 * size / np.tan(np.radians(fov_deg / 2))
        K = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)
        uu, vv = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        lon_p = (uu / W - 0.5) * 2 * np.pi
        lat_p = (0.5 - vv / H) * np.pi
        dirs = np.stack([np.cos(lat_p) * np.sin(lon_p), -np.sin(lat_p),
                         np.cos(lat_p) * np.cos(lon_p)], -1)  # [H, W, 3]
        Rs = []
        for k in range(n_views):
            yaw = 2 * np.pi * k / n_views
            cy, sy = np.cos(yaw), np.sin(yaw)
            Rs.append(np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32))
        for sgn in (1.0, -1.0):  # the poles: no azimuthal crop covers them
            Rs.append(np.array([[1, 0, 0], [0, 0, -sgn], [0, sgn, 0]], np.float32))
        for R in Rs:
            # sample the perspective crop from the panorama
            u, v = np.meshgrid(np.arange(size) + 0.5, np.arange(size) + 0.5)
            d = np.stack([(u - K[0, 2]) / f, (v - K[1, 2]) / f, np.ones_like(u)], -1)
            d = d @ R.T
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            lon = np.arctan2(d[..., 0], d[..., 2])
            lat = np.arcsin(np.clip(-d[..., 1], -1, 1))
            px = (lon / (2 * np.pi) + 0.5) * W
            py = (0.5 - lat / np.pi) * H
            xi = np.clip(px.astype(int), 0, W - 1)
            yi = np.clip(py.astype(int), 0, H - 1)
            dep = self.infer_image(bgr[yi, xi])
            # crops agree in scale once each is divided by its median
            dep = dep / max(np.median(dep), 1e-6)
            # gather: project every panorama direction into this crop
            dc = dirs @ R
            zc = dc[..., 2]
            in_front = zc > 1e-6
            xc = np.where(in_front, dc[..., 0] / np.maximum(zc, 1e-6), 0.0)
            yc = np.where(in_front, dc[..., 1] / np.maximum(zc, 1e-6), 0.0)
            cu = xc * f + K[0, 2]
            cv = yc * f + K[1, 2]
            inside = in_front & (cu >= 0) & (cu < size - 1) & (cv >= 0) & (cv < size - 1)
            x0 = np.clip(cu.astype(int), 0, size - 2)
            y0 = np.clip(cv.astype(int), 0, size - 2)
            fx_ = np.clip(cu - x0, 0, 1)
            fy_ = np.clip(cv - y0, 0, 1)
            samp = (dep[y0, x0] * (1 - fx_) * (1 - fy_) + dep[y0, x0 + 1] * fx_ * (1 - fy_)
                    + dep[y0 + 1, x0] * (1 - fx_) * fy_ + dep[y0 + 1, x0 + 1] * fx_ * fy_)
            wgt = np.where(inside, np.cos((cu / size - 0.5) * np.pi)
                           * np.cos((cv / size - 0.5) * np.pi), 0.0)
            out += samp * wgt
            wsum += wgt
        return out / np.maximum(wsum, 1e-6)

    def infer_fisheye(self, bgr: np.ndarray, K: np.ndarray, dist: Optional[np.ndarray] = None,
                      fov_deg: float = 180.0, erp_size: int = 518) -> np.ndarray:
        """Camera-aware fisheye depth: resample the fisheye image (K, the
        f * theta_d model with the k1..k4 polynomial ``dist``) onto an
        equirectangular patch over its FOV, infer there, and resample back
        to the fisheye grid (Newton-inverting theta_d), so the output is
        aligned pixel for pixel with the input; outside the FOV 0."""
        H, W = bgr.shape[:2]
        fx, fy = float(K[0, 0]), float(K[1, 1])
        cx, cy = float(K[0, 2]), float(K[1, 2])
        k = np.zeros(4) if dist is None else np.asarray(dist, np.float64)
        half = np.radians(fov_deg) / 2

        # fisheye -> ERP patch (gather through the forward projection)
        lon = (np.arange(erp_size) + 0.5) / erp_size * 2 * half - half
        lat = half - (np.arange(erp_size) + 0.5) / erp_size * 2 * half
        lon, lat = np.meshgrid(lon, lat)
        d = np.stack([np.cos(lat) * np.sin(lon), -np.sin(lat), np.cos(lat) * np.cos(lon)], -1)
        rxy = np.linalg.norm(d[..., :2], axis=-1)
        theta = np.arctan2(rxy, d[..., 2])
        t2 = theta * theta
        theta_d = theta * (1 + k[0] * t2 + k[1] * t2**2 + k[2] * t2**3 + k[3] * t2**4)
        scale = theta_d / np.maximum(rxy, 1e-9)
        su = fx * d[..., 0] * scale + cx
        sv = fy * d[..., 1] * scale + cy
        xi = np.clip(su.astype(int), 0, W - 1)
        yi = np.clip(sv.astype(int), 0, H - 1)
        dep_erp = self.infer_image(bgr[yi, xi])

        # ERP depth -> fisheye grid (unproject + Newton-invert theta_d). The
        # target radius is clamped to theta_d(FOV / 2) and the iterate to
        # the FOV, so the corners of a full-frame fisheye (where the
        # polynomial is not monotone) stay finite; they are masked below.
        u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        mx = (u - cx) / fx
        my = (v - cy) / fy
        rd_raw = np.sqrt(mx * mx + my * my)
        th_max = half
        t2m = th_max * th_max
        rd_max = th_max * (1 + k[0] * t2m + k[1] * t2m**2 + k[2] * t2m**3 + k[3] * t2m**4)
        rd = np.minimum(rd_raw, rd_max)
        th = rd.copy()
        for _ in range(5):  # theta_d(theta) is monotone inside the FOV
            t2 = th * th
            f_ = th * (1 + k[0] * t2 + k[1] * t2**2 + k[2] * t2**3 + k[3] * t2**4) - rd
            fp = 1 + 3 * k[0] * t2 + 5 * k[1] * t2**2 + 7 * k[2] * t2**3 + 9 * k[3] * t2**4
            th = np.clip(th - f_ / np.maximum(fp, 1e-6), 0.0, th_max)
        s = np.sin(th) / np.maximum(rd, 1e-9)
        lon_f = np.arctan2(mx * s, np.cos(th))
        lat_f = np.arcsin(np.clip(-my * s, -1, 1))
        pu = (lon_f + half) / (2 * half) * erp_size - 0.5
        pv = (half - lat_f) / (2 * half) * erp_size - 0.5
        inside = (rd_raw <= rd_max * (1 + 1e-6)) & (pu >= 0) & (pv >= 0) & (
            pu <= erp_size - 1) & (pv <= erp_size - 1)
        x0 = np.clip(pu.astype(int), 0, erp_size - 2)
        y0 = np.clip(pv.astype(int), 0, erp_size - 2)
        fxw = np.clip(pu - x0, 0, 1)
        fyw = np.clip(pv - y0, 0, 1)
        out = (dep_erp[y0, x0] * (1 - fxw) * (1 - fyw) + dep_erp[y0, x0 + 1] * fxw * (1 - fyw)
               + dep_erp[y0 + 1, x0] * (1 - fxw) * fyw + dep_erp[y0 + 1, x0 + 1] * fxw * fyw)
        return np.where(inside, out, 0.0).astype(np.float32)


def save_depth_outputs(depth: np.ndarray, out_dir: str, name: str):
    """Write ``<name>_depth.npy`` and a turbo-like colourised PNG."""
    from PIL import Image as PILImage

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"{name}_depth.npy"), depth)
    d = depth - depth.min()
    d = d / max(d.max(), 1e-9)
    r = np.clip(1.5 - np.abs(2.5 * d - 1.8), 0, 1)
    g = np.clip(1.5 - np.abs(2.5 * d - 1.25), 0, 1)
    b = np.clip(1.5 - np.abs(2.5 * d - 0.6), 0, 1)
    rgb = (np.stack([r, g, b], -1) * 255).astype(np.uint8)
    PILImage.fromarray(rgb).save(os.path.join(out_dir, f"{name}_depth.png"))
