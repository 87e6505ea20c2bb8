"""SAM 2.1 (Hiera trunk, FPN neck, prompt encoder, two-way mask decoder)
and the compact promptable tier: the port of
``splat_one_tpu/models/sam2_hiera.py``.

The faithful tier keeps the original checkpoint key names. Its weights
are the ``.npz`` that ``scripts/convert_weights.py sam2`` writes (and
``random_checkpoint`` draws): convolutions HWIO, transposed convolutions
[2, 2, cout, cin], positional embeddings NHWC. ``params_from_numpy``
turns that dict into the port's tensors, the convolutions OIHW and the
transposed ones back to PyTorch's [cin, cout, 2, 2]. Tokens and maps run channels-last ([B, H, W, C]) as in
JAX; the convolutions run NCHW through ``features._f32_conv`` (cuDNN,
TF32 off), each bias added after its convolution as JAX adds it.

Written as the JAX package writes it, so the rounding stays comparable:
layer norms as mean, centred square mean and ``/ sqrt(var + 1e-6)``;
attention as matmul, softmax, matmul; the exact GELU as ``jax.nn.gelu``
forms it (``erfc``); the ``pos_embed`` resize through the numpy bicubic
matrix (PyTorch's A = -0.75 kernel, replicated borders); the 2x2 max
pools as reshapes. The compact tier's GELU is the tanh form
(``transformer._mlp`` and ``jax.nn.gelu``'s default).

The predictors keep JAX's host work (PIL resizes in and out) and run the
networks on their device: CUDA unless ``device="cpu"`` is passed. Without
a checkpoint the compact tier draws its weights from a ``torch.Generator``
seeded by ``seed``: JAX's shapes and distributions, not its bits.
``random_checkpoint`` is the same numpy draw as JAX's, so it gives JAX's
bits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from splat_one_tpu_torch.models.transformer import (
    _attention, _block, _init_block, _init_linear, _linear, _mlp,
)
from splat_one_tpu_torch.sfm.features import _f32_conv
from splat_one_tpu_torch.utils.device import resolve as resolve_device

Params = Dict[str, torch.Tensor]

# (embed_dim, num_heads, stages, global_att_blocks, window_spec)
CONFIGS = {
    "hiera_t": dict(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2),
                    global_att=(5, 7, 9), window_spec=(8, 4, 14, 7)),
    "hiera_s": dict(embed_dim=96, num_heads=1, stages=(1, 2, 11, 2),
                    global_att=(7, 10, 13), window_spec=(8, 4, 14, 7)),
    "hiera_b+": dict(embed_dim=112, num_heads=2, stages=(2, 3, 16, 3),
                     global_att=(12, 16, 20), window_spec=(8, 4, 14, 7)),
    "hiera_l": dict(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4),
                    global_att=(23, 33, 43), window_spec=(8, 4, 16, 8)),
}
IMG_SIZE = 1024  # SAM2 input resolution
D_MODEL = 256
_SQRT_HALF = float(np.sqrt(0.5).astype(np.float32))


def params_from_numpy(d, device="cuda") -> Params:
    """A converted SAM 2.1 dict (numpy; the JAX package's layout) as the
    port's tensors on ``device``: every 4-D weight but the positional
    embeddings transposed (3, 2, 0, 1), HWIO -> OIHW and [2, 2, cout, cin]
    -> [cin, cout, 2, 2]."""
    dev = resolve_device(device)
    out = {}
    for k, v in d.items():
        a = np.asarray(v, np.float32)
        if a.ndim == 4 and "pos_embed" not in k:
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.tensor(np.ascontiguousarray(a), device=dev)
    return out


def _lin(p, name, x):
    """Linear with the checkpoint's [out, in] weight."""
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


def _ln(p, name, x, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    xn = (x - mu) / torch.sqrt(var + eps)
    return xn * p[f"{name}.weight"] + p[f"{name}.bias"]


def _gelu(x):
    """``jax.nn.gelu(x, approximate=False)``: 0.5 x erfc(-x sqrt(1/2))."""
    return 0.5 * x * torch.special.erfc(-x * _SQRT_HALF)


def _conv(p, name, x, stride=1, padding="SAME"):
    """2-D convolution of NHWC ``x`` by the OIHW weight, then the bias;
    "SAME" is the stride-1 odd-kernel padding."""
    w = p[f"{name}.weight"]
    pad = (w.shape[-1] - 1) // 2 if padding == "SAME" else padding
    with _f32_conv():
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1) + p[f"{name}.bias"]


def _conv_transpose(p, name, x, stride=2):
    """ConvTranspose2d(k=2, s=2) of NHWC ``x`` by PyTorch's [cin, cout, 2, 2]
    weight, then the bias (what JAX's ``conv_transpose(transpose_kernel=
    True)`` computes from the converter's layout)."""
    with _f32_conv():
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), p[f"{name}.weight"], stride=stride)
    return y.permute(0, 2, 3, 1) + p[f"{name}.bias"]


# ------------------------------------------------------------------ Hiera


def _bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of PyTorch's bicubic interpolation (A = -0.75
    cubic convolution, half-pixel centres, border-replicated taps): the
    JAX package's numpy function."""
    A = -0.75
    scale = n_in / n_out
    W = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        f = math.floor(src)
        t = src - f
        w = (
            ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A,
            ((A + 2) * t - (A + 3)) * t * t + 1,
            ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1,
        )
        w = w + (1.0 - w[0] - w[1] - w[2],)
        for k in range(4):
            idx = min(max(f - 1 + k, 0), n_in - 1)
            W[o, idx] += w[k]
    return W


def _bicubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[1, H, W, C] -> [1, out_h, out_w, C], PyTorch-bicubic semantics."""
    _, H, W, _ = x.shape
    wh = torch.as_tensor(_bicubic_matrix(H, out_h), device=x.device)
    ww = torch.as_tensor(_bicubic_matrix(W, out_w), device=x.device)
    return torch.einsum("oh,bhwc,pw->bopc", wh, x, ww)


def _window_partition(x, ws):
    """[B, H, W, C] -> [B*nw, ws, ws, C] with bottom/right padding."""
    B, H, W, C = x.shape
    ph, pw = (-H) % ws, (-W) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C), (Hp, Wp)


def _window_unpartition(w, ws, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = w.shape[0] // (Hp // ws * (Wp // ws))
    x = w.reshape(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def _do_pool(x, stride=2):
    """Max over stride x stride blocks of dims 1, 2 ("VALID": a ragged
    edge is dropped); any trailing dims."""
    B, H, W = x.shape[:3]
    h, w = H // stride, W // stride
    x = x[:, :h * stride, :w * stride]
    x = x.reshape(B, h, stride, w, stride, *x.shape[3:])
    return x.amax(dim=(2, 4))


def _msa(p, name, x, n_heads, dim_out, q_stride=None):
    """MultiScaleAttention on [B, H, W, C] tokens; an optional 2x2 max pool
    of Q (the heads' [B, H, W, heads, d] before the reshape)."""
    B, H, W, _ = x.shape
    qkv = _lin(p, f"{name}.qkv", x).reshape(B, H * W, 3, n_heads, -1)
    q, k, v = qkv.unbind(2)  # [B, HW, h, d]
    if q_stride:
        q = _do_pool(q.reshape(B, H, W, n_heads, -1), q_stride)
        H, W = H // q_stride, W // q_stride
        q = q.reshape(B, H * W, n_heads, -1)
    scale = 1.0 / math.sqrt(q.shape[-1])
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    att = torch.softmax(att, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, H, W, dim_out)
    return _lin(p, f"{name}.proj", out)


def hiera_forward(p: Params, image: torch.Tensor, config: str) -> List[torch.Tensor]:
    """image [B, S, S, 3] (ImageNet-normalized) -> the 4 stage maps
    [B, S/4, S/4, C] .. [B, S/32, S/32, 8C]."""
    cfg = CONFIGS[config]
    stages = cfg["stages"]
    depth = sum(stages)
    stage_ends = [sum(stages[: i + 1]) - 1 for i in range(len(stages))]
    q_pool_blocks = [e + 1 for e in stage_ends[:-1]]
    t = "image_encoder.trunk"
    x = _conv(p, f"{t}.patch_embed.proj", image, stride=4, padding=3)
    B, H, W, C = x.shape
    # absolute positional embedding: resized global + tiled window
    pos = _bicubic_resize(p[f"{t}.pos_embed"], H, W)  # [1, 7, 7, C] -> [1, H, W, C]
    pw = p[f"{t}.pos_embed_window"]  # [1, 8, 8, C]
    reps = (1, H // pw.shape[1] + 1, W // pw.shape[2] + 1, 1)
    x = x + (pos + pw.repeat(*reps)[:, :H, :W])

    dim = cfg["embed_dim"]
    heads = cfg["num_heads"]
    cur_stage = 0
    outs = []
    for i in range(depth):
        dim_out = dim
        # the window of the stage before a transition: a q-pool block
        # partitions at the old stage's window and unpartitions at
        # window // q_stride
        ws = cfg["window_spec"][cur_stage]
        q_stride = None
        if i in q_pool_blocks:
            dim_out = dim * 2
            heads = heads * 2
            cur_stage += 1
            q_stride = 2
        if i in cfg["global_att"]:
            ws = 0
        b = f"{t}.blocks.{i}"
        xn = _ln(p, f"{b}.norm1", x)
        if dim_out != dim:
            shortcut = _do_pool(_lin(p, f"{b}.proj", xn), 2)
        else:
            shortcut = x
        H, W = xn.shape[1], xn.shape[2]
        if ws > 0:
            xw, pad_hw = _window_partition(xn, ws)
            aw = _msa(p, f"{b}.attn", xw, heads, dim_out, q_stride)
            s = q_stride or 1
            a = _window_unpartition(aw, ws // s, (pad_hw[0] // s, pad_hw[1] // s),
                                    (H // s, W // s))
        else:
            a = _msa(p, f"{b}.attn", xn, heads, dim_out, q_stride)
        x = shortcut + a
        x = x + _mlp_hiera(p, b, _ln(p, f"{b}.norm2", x))
        dim = dim_out
        if i in stage_ends:
            outs.append(x)
    return outs


def _mlp_hiera(p, b, x):
    return _lin(p, f"{b}.mlp.layers.1", _gelu(_lin(p, f"{b}.mlp.layers.0", x)))


def _up2(x):
    """Nearest 2x upsampling of dims 1, 2."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def neck_forward(p: Params, feats: List[torch.Tensor], top_down_levels=(2, 3)
                 ) -> List[torch.Tensor]:
    """FPN neck: a 1x1 conv of each stage to 256, top-down nearest 2x adds
    on ``top_down_levels``; ``convs.{j}`` takes ``feats[n - 1 - j]`` (the
    coarsest first). Returns [fine .. coarse], all 256-channel."""
    n = len(feats)
    outs = [None] * n
    prev = None
    for i in range(n - 1, -1, -1):
        lateral = _conv(p, f"image_encoder.neck.convs.{n - 1 - i}.conv", feats[i])
        if prev is not None and i in top_down_levels:
            lateral = lateral + _up2(prev)
        prev = lateral
        outs[i] = lateral
    return outs


# ---------------------------------------------------------- prompt encoder


def _pe_points(p, coords01):
    """Random-Fourier PE of [..., 2] coords in [0, 1] (SAM's convention)."""
    mat = p["sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    c = coords01 * 2 - 1
    proj = (2 * math.pi) * (c @ mat)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def encode_points(p, coords01, labels):
    """coords01 [B, N, 2], labels [B, N] (1 pos / 0 neg / -1 pad) ->
    sparse prompt embeddings [B, N, 256]."""
    pe = _pe_points(p, coords01)
    pos = p["sam_prompt_encoder.point_embeddings.1.weight"][0]
    neg = p["sam_prompt_encoder.point_embeddings.0.weight"][0]
    nap = p["sam_prompt_encoder.not_a_point_embed.weight"][0]
    lab = labels[..., None]
    return torch.where(lab == 1, pe + pos, torch.where(lab == 0, pe + neg, nap))


# ------------------------------------------------------------ mask decoder


def _attn_ds(p, name, q, k, v, n_heads=8):
    """Decoder attention, q / k / v projected to an inner width that may
    be below 256."""
    B, Nq, _ = q.shape
    qq = _lin(p, f"{name}.q_proj", q).reshape(B, Nq, n_heads, -1)
    kk = _lin(p, f"{name}.k_proj", k).reshape(B, k.shape[1], n_heads, -1)
    vv = _lin(p, f"{name}.v_proj", v).reshape(B, v.shape[1], n_heads, -1)
    scale = 1.0 / math.sqrt(qq.shape[-1])
    att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qq, kk) * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, vv).reshape(B, Nq, -1)
    return _lin(p, f"{name}.out_proj", out)


def _mlp3(p, name, x, n=3):
    for i in range(n):
        x = _lin(p, f"{name}.layers.{i}", x)
        if i < n - 1:
            x = torch.relu(x)
    return x


def decode_masks(p: Params, embed, high_res, coords01, labels):
    """SAM2's mask decoder: embed [B, 64, 64, 256] (+ no_mem), high_res
    (s0 [B, 256, 256, 32], s1 [B, 128, 128, 64]), coords01 [B, N, 2],
    labels [B, N] -> (mask logits [B, 4, 256, 256], iou [B, 4], object
    score [B])."""
    d = "sam_mask_decoder"
    B, S, _, C = embed.shape
    dev = embed.device
    sparse = encode_points(p, coords01, labels)
    src = embed + p["sam_prompt_encoder.no_mask_embed.weight"][0]  # dense: no mask
    # the image's positional encoding (the same PE layer on the S x S grid)
    g = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    pos_img = _pe_points(p, torch.stack([gx, gy], -1)).reshape(1, S * S, C)

    out_toks = torch.cat([p[f"{d}.obj_score_token.weight"], p[f"{d}.iou_token.weight"],
                          p[f"{d}.mask_tokens.weight"]], dim=0)
    n_out = out_toks.shape[0]  # 6
    tokens = torch.cat([out_toks[None].expand(B, n_out, C), sparse], dim=1)
    src = src.reshape(B, S * S, C)
    tok_pe = tokens  # the query PE is the prompt tokens themselves

    t = f"{d}.transformer"
    q = tokens
    for li in range(2):
        l = f"{t}.layers.{li}"
        # layer 0's self attention replaces (no residual, no PE); later
        # layers add the PE to q and k and keep a residual
        if li == 0:
            q = _attn_ds(p, f"{l}.self_attn", q, q, q)
        else:
            qp = q + tok_pe
            q = q + _attn_ds(p, f"{l}.self_attn", qp, qp, q)
        q = _ln(p, f"{l}.norm1", q)
        a = _attn_ds(p, f"{l}.cross_attn_token_to_image", q + tok_pe, src + pos_img, src)
        q = _ln(p, f"{l}.norm2", q + a)
        h = torch.relu(_lin(p, f"{l}.mlp.lin1", q))
        q = _ln(p, f"{l}.norm3", q + _lin(p, f"{l}.mlp.lin2", h))
        a = _attn_ds(p, f"{l}.cross_attn_image_to_token", src + pos_img, q + tok_pe, q)
        src = _ln(p, f"{l}.norm4", src + a)
    a = _attn_ds(p, f"{t}.final_attn_token_to_image", q + tok_pe, src + pos_img, src)
    q = _ln(p, f"{t}.norm_final_attn", q + a)

    obj_score = _mlp3(p, f"{d}.pred_obj_score_head", q[:, 0])[:, 0]
    iou = _mlp3(p, f"{d}.iou_prediction_head", q[:, 1])
    mask_out = q[:, 2:2 + 4]  # [B, 4, 256]

    img = src.reshape(B, S, S, C)
    s0, s1 = high_res
    up = _conv_transpose(p, f"{d}.output_upscaling.0", img) + s1  # [B, 2S, 2S, 64]
    up = _gelu(_ln(p, f"{d}.output_upscaling.1", up))
    up = _conv_transpose(p, f"{d}.output_upscaling.3", up) + s0  # [B, 4S, 4S, 32]
    up = _gelu(up)
    hyper = torch.stack([_mlp3(p, f"{d}.output_hypernetworks_mlps.{i}", mask_out[:, i])
                         for i in range(4)], dim=1)  # [B, 4, 32]
    logits = torch.einsum("bhwc,bmc->bmhw", up, hyper)
    return logits, iou, obj_score


# -------------------------------------------------------------- predictor


def image_encoder_forward(p: Params, image: torch.Tensor, config: str):
    """Trunk + neck (+ no_mem_embed): (embed [B, 64, 64, 256], (s0, s1))."""
    fpn = neck_forward(p, hiera_forward(p, image, config))
    # scalp 1: the coarsest level is dropped; the embedding is level 2
    s0 = _conv(p, "sam_mask_decoder.conv_s0", fpn[0])  # [B, 256, 256, 32]
    s1 = _conv(p, "sam_mask_decoder.conv_s1", fpn[1])  # [B, 128, 128, 64]
    embed = fpn[2]
    if "no_mem_embed" in p:
        embed = embed + p["no_mem_embed"].reshape(1, 1, 1, -1)
    return embed, (s0, s1)


_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _pil_masks(logits, sel, W, H):
    """PIL-resized ``logits[i] > 0`` of each selected mask, as bool."""
    from PIL import Image as PILImage

    return np.stack([np.asarray(PILImage.fromarray((logits[i] > 0).astype(np.uint8) * 255)
                                .resize((W, H))) > 127 for i in sel])


class SAM2Predictor:
    """``SAM2ImagePredictor``'s surface (``set_image`` / ``predict``) over
    the faithful network, on ``device``."""

    def __init__(self, checkpoint: str, config: str = "hiera_l", img_size: int = IMG_SIZE,
                 device="cuda"):
        self.device = resolve_device(device)
        with np.load(checkpoint) as z:
            self.params = params_from_numpy({k: z[k] for k in z.files}, self.device)
        self.config = config
        self.img_size = img_size
        self._emb = None
        self._shape = None

    @torch.no_grad()
    def set_image(self, image: np.ndarray):
        from PIL import Image as PILImage

        img = image.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        self._shape = img.shape[:2]
        im = PILImage.fromarray((img * 255).astype(np.uint8)).resize(
            (self.img_size, self.img_size))
        arr = (np.asarray(im).astype(np.float32) / 255.0 - _MEAN) / _STD
        self._emb = image_encoder_forward(
            self.params, torch.as_tensor(arr[None], device=self.device), self.config)

    @torch.no_grad()
    def predict(self, point_coords, point_labels, multimask_output=True):
        H, W = self._shape
        coords01 = np.asarray(point_coords, np.float32) / np.array([W, H], np.float32)
        embed, high_res = self._emb
        logits, iou, _ = decode_masks(
            self.params, embed, high_res, torch.as_tensor(coords01[None], device=self.device),
            torch.as_tensor(np.asarray(point_labels, np.float32)[None], device=self.device))
        logits = logits[0].cpu().numpy()  # [4, 256, 256]
        iou = iou[0].cpu().numpy()
        sel = np.arange(1, 4) if multimask_output else np.array([0])
        return _pil_masks(logits, sel, W, H), iou[sel], logits[sel]


# ----------------------------------------------------- structural manifest


def random_checkpoint(config: str = "hiera_s", seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights under the converted checkpoint's exact names, shapes
    and layouts (numpy, the ``.npz`` layout): the JAX package's numpy
    draw, so the same bits as its ``random_checkpoint``."""
    cfg = CONFIGS[config]
    rng = np.random.default_rng(seed)
    P: Dict[str, np.ndarray] = {}

    def lin(name, cin, cout):
        P[f"{name}.weight"] = rng.normal(
            scale=1.0 / math.sqrt(cin), size=(cout, cin)).astype(np.float32)
        P[f"{name}.bias"] = np.zeros(cout, np.float32)

    def lnp(name, c):
        P[f"{name}.weight"] = np.ones(c, np.float32)
        P[f"{name}.bias"] = np.zeros(c, np.float32)

    def conv(name, cin, cout, k):
        P[f"{name}.weight"] = rng.normal(scale=0.05, size=(k, k, cin, cout)).astype(np.float32)
        P[f"{name}.bias"] = np.zeros(cout, np.float32)

    t = "image_encoder.trunk"
    E = cfg["embed_dim"]
    conv(f"{t}.patch_embed.proj", 3, E, 7)
    P[f"{t}.pos_embed"] = rng.normal(scale=0.02, size=(1, 7, 7, E)).astype(np.float32)
    P[f"{t}.pos_embed_window"] = rng.normal(scale=0.02, size=(1, 8, 8, E)).astype(np.float32)
    stages = cfg["stages"]
    stage_ends = [sum(stages[: i + 1]) - 1 for i in range(len(stages))]
    q_pool_blocks = [e + 1 for e in stage_ends[:-1]]
    dim = E
    for i in range(sum(stages)):
        dim_out = dim * 2 if i in q_pool_blocks else dim
        b = f"{t}.blocks.{i}"
        lnp(f"{b}.norm1", dim)
        lin(f"{b}.attn.qkv", dim, 3 * dim_out)
        lin(f"{b}.attn.proj", dim_out, dim_out)
        if dim_out != dim:
            lin(f"{b}.proj", dim, dim_out)
        lnp(f"{b}.norm2", dim_out)
        lin(f"{b}.mlp.layers.0", dim_out, 4 * dim_out)
        lin(f"{b}.mlp.layers.1", 4 * dim_out, dim_out)
        dim = dim_out
    chans = [E * 2 ** s for s in range(len(stages))]
    for j, c in enumerate(reversed(chans)):
        conv(f"image_encoder.neck.convs.{j}.conv", c, D_MODEL, 1)
    pe = "sam_prompt_encoder"
    P[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"] = rng.normal(
        size=(2, D_MODEL // 2)).astype(np.float32)
    for i in range(4):
        P[f"{pe}.point_embeddings.{i}.weight"] = rng.normal(
            scale=0.02, size=(1, D_MODEL)).astype(np.float32)
    for k in ("not_a_point_embed", "no_mask_embed"):
        P[f"{pe}.{k}.weight"] = rng.normal(scale=0.02, size=(1, D_MODEL)).astype(np.float32)
    P["no_mem_embed"] = rng.normal(scale=0.02, size=(1, 1, D_MODEL)).astype(np.float32)
    d = "sam_mask_decoder"
    for tok, n in (("iou_token", 1), ("mask_tokens", 4), ("obj_score_token", 1)):
        P[f"{d}.{tok}.weight"] = rng.normal(scale=0.02, size=(n, D_MODEL)).astype(np.float32)
    tr = f"{d}.transformer"
    for li in range(2):
        l = f"{tr}.layers.{li}"
        for att, ds in (("self_attn", 1), ("cross_attn_token_to_image", 2),
                        ("cross_attn_image_to_token", 2)):
            inner = D_MODEL // ds
            lin(f"{l}.{att}.q_proj", D_MODEL, inner)
            lin(f"{l}.{att}.k_proj", D_MODEL, inner)
            lin(f"{l}.{att}.v_proj", D_MODEL, inner)
            lin(f"{l}.{att}.out_proj", inner, D_MODEL)
        for i in range(1, 5):
            lnp(f"{l}.norm{i}", D_MODEL)
        lin(f"{l}.mlp.lin1", D_MODEL, 2048)
        lin(f"{l}.mlp.lin2", 2048, D_MODEL)
    inner = D_MODEL // 2
    f = f"{tr}.final_attn_token_to_image"
    lin(f"{f}.q_proj", D_MODEL, inner)
    lin(f"{f}.k_proj", D_MODEL, inner)
    lin(f"{f}.v_proj", D_MODEL, inner)
    lin(f"{f}.out_proj", inner, D_MODEL)
    lnp(f"{tr}.norm_final_attn", D_MODEL)
    # the transposed convolutions in the converter's [2, 2, cout, cin]
    P[f"{d}.output_upscaling.0.weight"] = rng.normal(
        scale=0.05, size=(2, 2, D_MODEL // 4, D_MODEL)).astype(np.float32)
    P[f"{d}.output_upscaling.0.bias"] = np.zeros(D_MODEL // 4, np.float32)
    lnp(f"{d}.output_upscaling.1", D_MODEL // 4)
    P[f"{d}.output_upscaling.3.weight"] = rng.normal(
        scale=0.05, size=(2, 2, D_MODEL // 8, D_MODEL // 4)).astype(np.float32)
    P[f"{d}.output_upscaling.3.bias"] = np.zeros(D_MODEL // 8, np.float32)
    conv(f"{d}.conv_s0", D_MODEL, D_MODEL // 8, 1)
    conv(f"{d}.conv_s1", D_MODEL, D_MODEL // 4, 1)
    for i in range(4):
        m = f"{d}.output_hypernetworks_mlps.{i}"
        lin(f"{m}.layers.0", D_MODEL, D_MODEL)
        lin(f"{m}.layers.1", D_MODEL, D_MODEL)
        lin(f"{m}.layers.2", D_MODEL, D_MODEL // 8)
    for m, co in ((f"{d}.iou_prediction_head", 4), (f"{d}.pred_obj_score_head", 1)):
        lin(f"{m}.layers.0", D_MODEL, D_MODEL)
        lin(f"{m}.layers.1", D_MODEL, D_MODEL)
        lin(f"{m}.layers.2", D_MODEL, co)
    return P


# ===========================================================================
# The compact promptable tier (the legacy ``enc_*`` / ``dec_*`` checkpoints)
# ===========================================================================

STAGES = ((96, 2), (192, 2), (384, 4), (768, 2))  # (width, depth)
COMPACT_IMG_SIZE = 256
PATCH = 4


def init_encoder(gen: torch.Generator) -> Params:
    """The compact encoder's parameters (CPU), drawn from ``gen``."""
    params: Params = {}
    _init_linear(gen, "patch", PATCH * PATCH * 3, STAGES[0][0], params)
    n = COMPACT_IMG_SIZE // PATCH
    params["pos"] = torch.randn(1, n * n, STAGES[0][0], generator=gen) * 0.02
    for si, (c, depth) in enumerate(STAGES):
        for d in range(depth):
            _init_block(gen, f"s{si}b{d}", c, params)
        if si + 1 < len(STAGES):
            _init_linear(gen, f"merge{si}", c * 4, STAGES[si + 1][0], params)
    _init_linear(gen, "neck", STAGES[-1][0], 256, params)
    return params


def encode_image(params: Params, image: torch.Tensor) -> torch.Tensor:
    """image [B, 256, 256, 3] in [0, 1] -> embeddings [B, 8, 8, 256]."""
    B, H, W, _ = image.shape
    x = image.reshape(B, H // PATCH, PATCH, W // PATCH, PATCH, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(B, (H // PATCH) * (W // PATCH), PATCH * PATCH * 3)
    x = _linear(params, "patch", x) + params["pos"]
    side = H // PATCH
    for si, (c, depth) in enumerate(STAGES):
        for d in range(depth):
            x = _block(params, f"s{si}b{d}", x, n_heads=max(c // 64, 1))
        if si + 1 < len(STAGES):
            # patch merging: 2x2 concat + linear
            x = x.reshape(B, side // 2, 2, side // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(B, (side // 2) ** 2, 4 * c)
            x = _linear(params, f"merge{si}", x)
            side //= 2
    return _linear(params, "neck", x).reshape(B, side, side, 256)


def init_decoder(gen: torch.Generator) -> Params:
    """The compact decoder's parameters (CPU), drawn from ``gen``."""
    params: Params = {}
    params["pt_embed_pos"] = torch.randn(256, generator=gen) * 0.02
    params["pt_embed_neg"] = torch.randn(256, generator=gen) * 0.02
    params["mask_token"] = torch.randn(1, 256, generator=gen) * 0.02
    params["pe_freq"] = torch.randn(2, 128, generator=gen) * 6.0
    for d in range(2):
        _init_block(gen, f"dec_t2i{d}", 256, params)
        _init_block(gen, f"dec_i2t{d}", 256, params)
    _init_linear(gen, "out_mlp_1", 256, 256, params)
    _init_linear(gen, "out_mlp_2", 256, 32, params)
    _init_linear(gen, "up_1", 256, 64, params)
    _init_linear(gen, "up_2", 64, 32, params)
    _init_linear(gen, "iou_head", 256, 1, params)
    return params


def _pos_encode(params, coords01):
    """Random-Fourier positional encoding of [..., 2] coords in [0, 1]."""
    proj = (coords01 * 2 - 1) @ params["pe_freq"] * (2 * math.pi)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def compact_decode_masks(enc_params: Params, dec_params: Params, embeddings, point_coords,
                         point_labels):
    """Two-way transformer (tokens to image and back), the mask from the
    4x upscaled embeddings times the mask token's hypernetwork:
    embeddings [B, S, S, 256], point_coords [B, N, 2] in [0, 1],
    point_labels [B, N] -> (mask logits [B, 4S, 4S], iou [B])."""
    p = dec_params
    B, S, _, C = embeddings.shape
    img = embeddings.reshape(B, S * S, C)
    g = (torch.arange(S, dtype=torch.float32, device=img.device) + 0.5) / S
    grid = torch.stack(torch.meshgrid(g, g, indexing="xy"), -1).reshape(1, S * S, 2)
    img = img + _pos_encode(p, grid)
    pt = _pos_encode(p, point_coords) + torch.where(
        point_labels[..., None] > 0, p["pt_embed_pos"], p["pt_embed_neg"])
    tokens = torch.cat([p["mask_token"].expand(B, 1, C), pt], dim=1)
    for d in range(2):
        tokens = tokens + _attention(p, f"dec_t2i{d}_attn", tokens, img, 8)
        tokens = tokens + _mlp(p, f"dec_t2i{d}_mlp", tokens)
        img = img + _attention(p, f"dec_i2t{d}_attn", img, tokens, 8)
        img = img + _mlp(p, f"dec_i2t{d}_mlp", img)
    mask_tok = tokens[:, 0]
    hyper = _linear(p, "out_mlp_2", F.gelu(_linear(p, "out_mlp_1", mask_tok),
                                            approximate="tanh"))  # [B, 32]
    # 4x upscaling: 2x nearest + linear, twice
    x = _up2(img.reshape(B, S, S, C))
    x = F.gelu(_linear(p, "up_1", x), approximate="tanh")
    x = _linear(p, "up_2", _up2(x))  # [B, 4S, 4S, 32]
    logits = torch.einsum("bhwc,bc->bhw", x, hyper)
    iou = _linear(p, "iou_head", mask_tok)[..., 0]
    return logits, iou


def _tensors(d, dev) -> Params:
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev) for k, v in d.items()}


class HieraPredictor:
    """``SAM2ImagePredictor``'s surface over the compact network, on
    ``device``: a seeded init, overlaid by a checkpoint's ``enc_*`` /
    ``dec_*`` entries."""

    def __init__(self, checkpoint: Optional[str] = None, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        enc, dec = init_encoder(gen), init_decoder(gen)
        if checkpoint:
            with np.load(checkpoint) as z:
                loaded = {k: z[k] for k in z.files}
            enc = {k: loaded.get(f"enc_{k}", v) for k, v in enc.items()}
            dec = {k: loaded.get(f"dec_{k}", v) for k, v in dec.items()}
        self.enc_params = _tensors(enc, self.device)
        self.dec_params = _tensors(dec, self.device)
        self._emb = None
        self._shape = None

    @torch.no_grad()
    def set_image(self, image: np.ndarray):
        from PIL import Image as PILImage

        img = image.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        self._shape = img.shape[:2]
        im = PILImage.fromarray((img * 255).astype(np.uint8)).resize(
            (COMPACT_IMG_SIZE, COMPACT_IMG_SIZE))
        arr = np.asarray(im).astype(np.float32) / 255.0
        self._emb = encode_image(self.enc_params, torch.as_tensor(arr[None], device=self.device))

    @torch.no_grad()
    def predict(self, point_coords, point_labels, multimask_output=False):
        H, W = self._shape
        coords01 = np.asarray(point_coords, np.float32) / np.array([W, H], np.float32)
        logits, iou = compact_decode_masks(
            self.enc_params, self.dec_params, self._emb,
            torch.as_tensor(coords01[None], device=self.device),
            torch.as_tensor(np.asarray(point_labels, np.float32)[None], device=self.device))
        logits = logits.cpu().numpy()
        return _pil_masks(logits, [0], W, H), iou.cpu().numpy(), logits
