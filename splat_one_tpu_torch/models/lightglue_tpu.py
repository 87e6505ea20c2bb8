"""LightGlue attention matcher: the port of ``splat_one_tpu/models/lightglue_tpu.py``.

Two tiers, both written as matmul, softmax, matmul (no fused attention),
as the JAX package writes them, so the rounding stays comparable:

1. The trainable LightGlue-style tier (``init_lightglue``,
   ``lightglue_scores``, ``match_lightglue``): 4 layers of pre-normed
   self / cross attention with a 2-D rotary encoding of normalized
   keypoint positions, a concat-FFN update (GELU, tanh approximation),
   then a dual-softmax assignment weighted by a learned matchability.
2. The checkpoint-faithful forward of the official cvg/LightGlue
   (``lightglue_forward_ckpt``, ``filter_matches_ckpt``): the learnable
   Fourier rotary encoding, the self block's fused Wqkv unflattened as
   (heads, head_dim, 3), the bidirectional cross block, the concat-FFN
   with LayerNorm (eps 1e-5) and exact (erf) GELU, and the
   sigmoid-log-double-softmax assignment of the last layer.

Parameters are dicts of tensors in the JAX package's layout (linear
weights [in, out] in tier 1, the official [out, in] in tier 2):
``params_from_numpy`` / ``params_to_numpy`` carry them across, and
``load_lightglue`` reads the ``.npz`` that ``scripts/convert_weights.py
lightglue`` writes and the JAX loader reads. ``init_lightglue_ckpt``
draws the official schema at any width (the card's full-width run).
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

from splat_one_tpu_torch.models.transformer import _init_linear, _init_ln, _layernorm, _linear
from splat_one_tpu_torch.utils.device import resolve as resolve_device

DIM = 128
N_LAYERS = 4
N_HEADS = 4


def params_from_numpy(d, device="cuda") -> Dict[str, torch.Tensor]:
    """A parameter dict of numpy arrays (either tier) as f32 tensors on
    ``device``."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev) for k, v in d.items()}


def params_to_numpy(p) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in p.items()}


def init_lightglue(desc_dim: int = 128, device="cuda") -> Dict:
    """The trainable tier's random parameters (He-normal linears, unit
    layer norms) from a CPU generator seeded 0."""
    g = torch.Generator().manual_seed(0)
    params: Dict = {}
    _init_linear(g, "in_proj", desc_dim, DIM, params)
    for layer in range(N_LAYERS):
        for kind in ("self", "cross"):
            for name in ("q", "k", "v", "o"):
                _init_linear(g, f"l{layer}_{kind}_{name}", DIM, DIM, params)
        _init_linear(g, f"l{layer}_ffn1", DIM * 2, DIM * 2, params)
        _init_linear(g, f"l{layer}_ffn2", DIM * 2, DIM, params)
        _init_ln(f"l{layer}_ln_s", DIM, params)
        _init_ln(f"l{layer}_ln_c", DIM, params)
        _init_ln(f"l{layer}_ln_f", DIM * 2, params)
    _init_linear(g, "final", DIM, DIM, params)
    _init_linear(g, "matchability", DIM, 1, params)
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in params.items()}


def _rotary(x: torch.Tensor, xy01: torch.Tensor) -> torch.Tensor:
    """Rotary encoding by normalized keypoint coordinates, x and y on
    separate frequency halves."""
    d4 = x.shape[-1] // 4
    dh = d4 // 2
    freqs = torch.exp(torch.linspace(0.0, 5.0, dh, device=x.device))
    ang = torch.cat([xy01[..., 0:1] * freqs[None, None], xy01[..., 1:2] * freqs[None, None]], -1)
    ang = F.pad(ang, (0, d4 - 2 * dh))
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2, rest = x[..., :d4], x[..., d4:2 * d4], x[..., 2 * d4:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c, rest], -1)


def _mha(p, prefix, q_in, kv_in, q_xy, kv_xy, mask_kv):
    B, Nq, C = q_in.shape
    Nk = kv_in.shape[1]
    q = _rotary(_linear(p, f"{prefix}_q", q_in), q_xy).reshape(B, Nq, N_HEADS, -1)
    k = _rotary(_linear(p, f"{prefix}_k", kv_in), kv_xy).reshape(B, Nk, N_HEADS, -1)
    v = _linear(p, f"{prefix}_v", kv_in).reshape(B, Nk, N_HEADS, -1)
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    att = torch.where(mask_kv[:, None, None, :], att, torch.full_like(att, -1e9))
    att = torch.softmax(att, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, Nq, C)
    return _linear(p, f"{prefix}_o", out)


def _layer(p, i, xa, xb, xy_a, xy_b, va, vb):
    """Pre-normed self attention within each image, then cross between
    them, each followed by the concat-FFN update."""
    def upd(x, msg):
        h = _layernorm(p, f"l{i}_ln_f", torch.cat([x, msg], -1))
        return x + _linear(p, f"l{i}_ffn2",
                           F.gelu(_linear(p, f"l{i}_ffn1", h), approximate="tanh"))

    s_in = lambda x: _layernorm(p, f"l{i}_ln_s", x)
    c_in = lambda x: _layernorm(p, f"l{i}_ln_c", x)
    xa = upd(xa, _mha(p, f"l{i}_self", s_in(xa), s_in(xa), xy_a, xy_a, va))
    xb = upd(xb, _mha(p, f"l{i}_self", s_in(xb), s_in(xb), xy_b, xy_b, vb))
    xa = upd(xa, _mha(p, f"l{i}_cross", c_in(xa), c_in(xb), xy_a, xy_b, vb))
    xb = upd(xb, _mha(p, f"l{i}_cross", c_in(xb), c_in(xa), xy_b, xy_a, va))
    return xa, xb


def lightglue_scores(params: Dict, desc_a, desc_b, xy_a, xy_b, valid_a, valid_b):
    """desc [K, D], xy [K, 2] normalized to [0, 1], valid [K] (tensors on
    the parameters' device) -> (scores [Ka, Kb], matchability_a [Ka],
    matchability_b [Kb])."""
    xa = _linear(params, "in_proj", desc_a)[None]
    xb = _linear(params, "in_proj", desc_b)[None]
    va, vb = valid_a[None], valid_b[None]
    pa, pb = xy_a[None], xy_b[None]
    for i in range(N_LAYERS):
        xa, xb = _layer(params, i, xa, xb, pa, pb, va, vb)
    fa = _linear(params, "final", xa)[0]
    fb = _linear(params, "final", xb)[0]
    fa = fa / torch.clamp(torch.linalg.norm(fa, dim=-1, keepdim=True), min=1e-8)
    fb = fb / torch.clamp(torch.linalg.norm(fb, dim=-1, keepdim=True), min=1e-8)
    sim = fa @ fb.T * 10.0
    ma = torch.sigmoid(_linear(params, "matchability", xa)[0, :, 0])
    mb = torch.sigmoid(_linear(params, "matchability", xb)[0, :, 0])
    return sim, ma, mb


def match_lightglue(params: Dict, desc_a, desc_b, xy_a, xy_b, size_a: Tuple[int, int],
                    size_b: Tuple[int, int], valid_a, valid_b, min_score: float = 0.2):
    """``matching.match_descriptors``' contract on the parameters' device:
    numpy (idx_b [Ka], ok [Ka]) by the dual-softmax assignment weighted by
    matchability, mutual, above ``min_score``. xy in pixels, size (W, H)."""
    dev = params["in_proj_w"].device
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    na = np.asarray(xy_a, np.float32) / np.asarray(size_a, np.float32)
    nb = np.asarray(xy_b, np.float32) / np.asarray(size_b, np.float32)
    va, vb = t(valid_a, torch.bool), t(valid_b, torch.bool)
    sim, ma, mb = lightglue_scores(params, t(desc_a), t(desc_b), t(na), t(nb), va, vb)
    sim = torch.where(va[:, None] & vb[None, :], sim, torch.full_like(sim, -1e9))
    p = torch.softmax(sim, dim=1) * torch.softmax(sim, dim=0) * ma[:, None] * mb[None, :]
    idx_b = torch.argmax(p, dim=1)
    best = torch.amax(p, dim=1)
    mutual = torch.argmax(p, dim=0)[idx_b] == torch.arange(p.shape[0], device=dev)
    ok = (best > min_score) & mutual & va
    return idx_b.cpu().numpy(), ok.cpu().numpy()


# ---------------------------------------------------------------------------
# checkpoint-faithful forward (official cvg/LightGlue numerics)
# ---------------------------------------------------------------------------
def _lg_lin(sd, name, x):
    y = x @ sd[f"{name}.weight"].T
    b = sd.get(f"{name}.bias")
    return y + b if b is not None else y


def _lg_ln(sd, name, x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * sd[f"{name}.weight"] + sd[f"{name}.bias"]


def _lg_gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / float(np.float32(np.sqrt(2.0)))))


def _rotate_half(x):
    x = x.reshape(x.shape[:-1] + (-1, 2))
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([-x2, x1], -1).reshape(x.shape[:-2] + (-1,))


def _lg_rotary_emb(sd, kpts):
    """LearnableFourierPositionalEncoding: (cos, sin) [B, 1, N, head_dim],
    frequencies repeat-interleaved by 2."""
    proj = kpts @ sd["posenc.Wr.weight"].T  # [B, N, head_dim // 2]
    return (torch.repeat_interleave(torch.cos(proj), 2, dim=-1)[:, None],
            torch.repeat_interleave(torch.sin(proj), 2, dim=-1)[:, None])


def _lg_ffn(sd, p, x, msg):
    h = _lg_lin(sd, f"{p}.ffn.0", torch.cat([x, msg], -1))
    h = _lg_gelu(_lg_ln(sd, f"{p}.ffn.1", h))
    return x + _lg_lin(sd, f"{p}.ffn.3", h)


def _lg_self_block(sd, p, x, emb, n_heads):
    B, N, d = x.shape
    hd = d // n_heads
    # the official unflatten(-1, (heads, head_dim, 3)): unit h*hd*3 + i*3 + j
    qkv = _lg_lin(sd, f"{p}.Wqkv", x).reshape(B, N, n_heads, hd, 3).permute(0, 2, 1, 3, 4)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]  # [B, h, N, hd]
    c, s = emb
    q = q * c + _rotate_half(q) * s
    k = k * c + _rotate_half(k) * s
    att = torch.softmax((q @ k.transpose(-1, -2)) / float(np.sqrt(hd)), dim=-1)
    ctx = att @ v  # [B, h, N, hd]
    msg = _lg_lin(sd, f"{p}.out_proj", ctx.permute(0, 2, 1, 3).reshape(B, N, d))
    return _lg_ffn(sd, p, x, msg)


def _lg_cross_block(sd, p, x0, x1, n_heads):
    B, _, d = x0.shape
    hd = d // n_heads
    split = lambda t: t.reshape(B, -1, n_heads, hd).permute(0, 2, 1, 3)
    s_half = (hd ** -0.5) ** 0.5
    qk0 = split(_lg_lin(sd, f"{p}.to_qk", x0)) * s_half
    qk1 = split(_lg_lin(sd, f"{p}.to_qk", x1)) * s_half
    v0 = split(_lg_lin(sd, f"{p}.to_v", x0))
    v1 = split(_lg_lin(sd, f"{p}.to_v", x1))
    sim = qk0 @ qk1.transpose(-1, -2)  # [B, h, N0, N1]
    m0 = torch.softmax(sim, dim=-1) @ v1
    m1 = torch.softmax(sim.transpose(-1, -2), dim=-1) @ v0
    out = lambda x, m: _lg_ffn(sd, p, x, _lg_lin(
        sd, f"{p}.to_out", m.permute(0, 2, 1, 3).reshape(B, -1, d)))
    return out(x0, m0), out(x1, m1)


def _lg_assignment(sd, p, desc0, desc1):
    """MatchAssignment + sigmoid_log_double_softmax -> [B, m+1, n+1]."""
    m0 = _lg_lin(sd, f"{p}.final_proj", desc0)
    m1 = _lg_lin(sd, f"{p}.final_proj", desc1)
    d = m0.shape[-1]
    m0 = m0 / d ** 0.25
    m1 = m1 / d ** 0.25
    sim = torch.einsum("bmd,bnd->bmn", m0, m1)
    z0 = _lg_lin(sd, f"{p}.matchability", desc0)  # [B, m, 1]
    z1 = _lg_lin(sd, f"{p}.matchability", desc1)  # [B, n, 1]
    cert = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(1, 2)
    s0 = torch.log_softmax(sim, dim=2)
    s1 = torch.log_softmax(sim, dim=1)
    B, m, n = sim.shape
    scores = sim.new_zeros((B, m + 1, n + 1))
    scores[:, :m, :n] = s0 + s1 + cert
    scores[:, :m, n] = F.logsigmoid(-z0)[..., 0]
    scores[:, m, :n] = F.logsigmoid(-z1)[..., 0]
    return scores


def lightglue_forward_ckpt(sd: Dict, kpts0, kpts1, desc0, desc1, size0, size1,
                           n_heads: int = 4) -> torch.Tensor:
    """The official LightGlue forward from a converted checkpoint, on the
    parameters' device and in their dtype: kpts [m, 2] pixel coordinates,
    desc [m, D], size (W, H) -> the last layer's log-assignment matrix
    [m+1, n+1]."""
    w = sd["input_proj.weight"]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=w.dtype, device=w.device)

    def norm_kpts(k, size):
        size = t(size)
        return (k - size / 2.0) / (torch.max(size) / 2.0)

    k0 = norm_kpts(t(kpts0), size0)[None]
    k1 = norm_kpts(t(kpts1), size1)[None]
    x0 = _lg_lin(sd, "input_proj", t(desc0)[None])
    x1 = _lg_lin(sd, "input_proj", t(desc1)[None])
    emb0 = _lg_rotary_emb(sd, k0)
    emb1 = _lg_rotary_emb(sd, k1)
    i = 0
    while f"transformers.{i}.self_attn.Wqkv.weight" in sd:
        p = f"transformers.{i}"
        x0 = _lg_self_block(sd, f"{p}.self_attn", x0, emb0, n_heads)
        x1 = _lg_self_block(sd, f"{p}.self_attn", x1, emb1, n_heads)
        x0, x1 = _lg_cross_block(sd, f"{p}.cross_attn", x0, x1, n_heads)
        i += 1
    return _lg_assignment(sd, f"log_assignment.{i - 1}", x0, x1)[0]


def filter_matches_ckpt(scores: torch.Tensor, threshold: float = 0.1):
    """The official filter_matches on a log-assignment matrix [m+1, n+1]:
    mutual argmax over the non-dustbin block, exp(max) > threshold.
    Returns numpy (m0 [m], ok [m])."""
    inner = scores[:-1, :-1]
    m0 = torch.argmax(inner, dim=1)
    m1 = torch.argmax(inner, dim=0)
    mutual = m1[m0] == torch.arange(inner.shape[0], device=inner.device)
    ok = mutual & (torch.exp(torch.amax(inner, dim=1)) > threshold)
    return m0.cpu().numpy(), ok.cpu().numpy()


def is_faithful(params: Dict) -> bool:
    """Whether ``params`` hold an official checkpoint (the faithful tier)."""
    return "input_proj.weight" in params


def init_lightglue_ckpt(input_dim: int = 128, descriptor_dim: int = 256, n_layers: int = 9,
                        n_heads: int = 4, device="cuda") -> Dict:
    """Random parameters in the official cvg/LightGlue schema (the layout
    ``scripts/convert_weights.py lightglue`` writes): linears normal with
    std 1/sqrt(fan_in), biases 0.1 of that, layer norms near the identity,
    ``posenc.Wr`` [head_dim // 2, 2]. Defaults: the ALIKED configuration
    (input 128, 256 wide, 9 layers, 4 heads)."""
    g = torch.Generator().manual_seed(0)
    d, hd = descriptor_dim, descriptor_dim // n_heads
    sd: Dict = {}

    def lin(name, cin, cout, bias=True):
        sd[f"{name}.weight"] = torch.randn(cout, cin, generator=g) / math.sqrt(cin)
        if bias:
            sd[f"{name}.bias"] = 0.1 * torch.randn(cout, generator=g) / math.sqrt(cin)

    lin("input_proj", input_dim, d)
    sd["posenc.Wr.weight"] = torch.randn(hd // 2, 2, generator=g)
    for i in range(n_layers):
        p = f"transformers.{i}"
        lin(f"{p}.self_attn.Wqkv", d, 3 * d)
        lin(f"{p}.self_attn.out_proj", d, d)
        lin(f"{p}.cross_attn.to_qk", d, d)
        lin(f"{p}.cross_attn.to_v", d, d)
        lin(f"{p}.cross_attn.to_out", d, d)
        for blk in ("self_attn", "cross_attn"):
            lin(f"{p}.{blk}.ffn.0", 2 * d, 2 * d)
            sd[f"{p}.{blk}.ffn.1.weight"] = 1 + 0.1 * torch.randn(2 * d, generator=g)
            sd[f"{p}.{blk}.ffn.1.bias"] = 0.1 * torch.randn(2 * d, generator=g)
            lin(f"{p}.{blk}.ffn.3", 2 * d, d)
        lin(f"log_assignment.{i}.matchability", d, 1)
        lin(f"log_assignment.{i}.final_proj", d, d)
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in sd.items()}


def load_lightglue(checkpoint: Optional[str] = None, desc_dim: int = 128, device="cuda"):
    """The trainable tier's initialization, overlaid with a converted
    ``.npz`` where ``checkpoint`` names one (an official checkpoint makes
    ``is_faithful`` true)."""
    params = init_lightglue(desc_dim, device=device)
    if checkpoint and os.path.exists(checkpoint):
        with np.load(checkpoint) as z:
            params.update(params_from_numpy({k: z[k] for k in z.files}, device))
    return params
