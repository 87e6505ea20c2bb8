"""Shared transformer primitives: the port of ``splat_one_tpu/models/transformer.py``.

Linear / layer norm / multi-head attention / MLP / pre-norm block over
flat dicts of tensors (``{prefix}_w`` [in, out], ``{prefix}_b``, layer
norm ``{prefix}_g`` / ``{prefix}_b``), and their initializers. Written as
the JAX package writes them, so the rounding stays comparable: the layer
norm as mean, centred square mean and ``/ sqrt(var + eps)``; attention as
matmul, softmax, matmul; the MLP's GELU the tanh approximation (JAX's
``jax.nn.gelu`` default).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _linear(p, prefix, x):
    return x @ p[f"{prefix}_w"] + p[f"{prefix}_b"]


def _layernorm(p, prefix, x, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p[f"{prefix}_g"] + p[f"{prefix}_b"]


def _attention(p, prefix, q_in, kv_in, n_heads):
    B, Nq, C = q_in.shape
    Nk = kv_in.shape[1]
    q = _linear(p, f"{prefix}_q", q_in).reshape(B, Nq, n_heads, -1)
    k = _linear(p, f"{prefix}_k", kv_in).reshape(B, Nk, n_heads, -1)
    v = _linear(p, f"{prefix}_v", kv_in).reshape(B, Nk, n_heads, -1)
    scale = 1.0 / math.sqrt(q.shape[-1])
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    att = torch.softmax(att, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, Nq, C)
    return _linear(p, f"{prefix}_o", out)


def _mlp(p, prefix, x):
    h = F.gelu(_linear(p, f"{prefix}_1", x), approximate="tanh")
    return _linear(p, f"{prefix}_2", h)


def _block(p, prefix, x, n_heads):
    h = _layernorm(p, f"{prefix}_ln1", x)
    x = x + _attention(p, f"{prefix}_attn", h, h, n_heads)
    return x + _mlp(p, f"{prefix}_mlp", _layernorm(p, f"{prefix}_ln2", x))


def _init_linear(gen, prefix, cin, cout, params):
    """He-normal weights [cin, cout] drawn from the CPU generator ``gen``,
    zero bias (JAX's shapes and distribution; not its bits)."""
    params[f"{prefix}_w"] = torch.randn(cin, cout, generator=gen) * math.sqrt(2.0 / cin)
    params[f"{prefix}_b"] = torch.zeros(cout)


def _init_ln(prefix, c, params):
    params[f"{prefix}_g"] = torch.ones(c)
    params[f"{prefix}_b"] = torch.zeros(c)


def _init_block(gen, prefix, c, params, mlp_ratio=4):
    for name in ("q", "k", "v", "o"):
        _init_linear(gen, f"{prefix}_attn_{name}", c, c, params)
    _init_linear(gen, f"{prefix}_mlp_1", c, c * mlp_ratio, params)
    _init_linear(gen, f"{prefix}_mlp_2", c * mlp_ratio, c, params)
    _init_ln(f"{prefix}_ln1", c, params)
    _init_ln(f"{prefix}_ln2", c, params)
