"""Per-image appearance model: counterpart of
``splat_one_tpu/train/appearance.py``.

A per-image embedding, the per-gaussian features and the SH basis of the
view direction go through a small MLP that predicts colour logits per
(camera, gaussian); the per-gaussian ``colors`` are added and the sigmoid
taken (``appearance_rgb``): the Trainer's colours under
``Config.app_opt``, and what ``app.viewer.Renderer`` serves of such a
model. This is gsplat's ``AppearanceOptModule`` (``examples/utils.py``,
``simple_trainer.py --app_opt``).

Layer counting. gsplat's ``mlp_depth`` counts hidden layers: one
``Linear(in, width)``, ``mlp_depth - 1`` times ``Linear(width, width)``,
then ``Linear(width, 3)``, a ReLU after each but the last; at its default
``mlp_depth=2`` that is three linear layers. ``init_appearance_params``,
like the JAX package's, counts linear layers (``[in] + [width] *
(mlp_depth - 1) + [3]``): at ``mlp_depth=2`` it builds two, one hidden
layer. ``appearance_color`` evaluates whatever ``w0, w1, ...`` it is
given, so it evaluates both heads.

Serving. ``appearance_rgb_from_centres`` takes the means and camera
centres in place of the directions: ``app.viewer.Renderer``'s path. On
CUDA tensors it launches one kernel (``ops.appearance.appearance_fwd``,
``csrc/appearance_fwd.cu``), which serves one camera, heads of hidden
width 64 with two or three linear layers (both counts above), features
of a width divisible by 4 and inputs ``E + F + (d + 1)**2`` of at most
128 for SH degree d from 0 to 4, with no autograd; anything else raises
``ValueError`` there. CPU tensors run the plain composition over every
head. ``appearance_rgb``, ``appearance_color`` and the Trainer's path are
the plain ones.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from splat_one_tpu_torch.core.sh import eval_sh_bases, num_sh_bases
from splat_one_tpu_torch.ops import appearance as app_ops

Params = Dict[str, torch.Tensor]


def init_appearance_params(generator: torch.Generator, n_images: int,
                           feature_dim: int = 32, embed_dim: int = 16,
                           sh_degree: int = 3, mlp_width: int = 64,
                           mlp_depth: int = 2) -> Params:
    """Zero embeddings, He-normal weights drawn from ``generator`` (on its
    device), zero biases."""
    dev = generator.device
    in_dim = embed_dim + feature_dim + num_sh_bases(sh_degree)
    params: Params = {"embeds": torch.zeros((n_images, embed_dim), device=dev)}
    dims = [in_dim] + [mlp_width] * (mlp_depth - 1) + [3]
    for i, (di, do) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = torch.randn((di, do), generator=generator,
                                      device=dev) * math.sqrt(2.0 / di)
        params[f"b{i}"] = torch.zeros((do,), device=dev)
    return params


def appearance_color(params: Params, features: torch.Tensor,  # [N, F]
                     image_ids: torch.Tensor,  # [C] int
                     dirs: torch.Tensor,  # [C, N, 3], unnormalized
                     sh_degree: int = 3) -> torch.Tensor:
    """Colour logits ``[C, N, 3]`` (the caller adds colours and applies the
    sigmoid)."""
    C, N = image_ids.shape[0], features.shape[0]
    d = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
    basis = eval_sh_bases(sh_degree, d)  # [C, N, B]
    emb = params["embeds"][image_ids]  # [C, E]
    h = torch.cat([emb[:, None, :].expand(C, N, emb.shape[-1]),
                   features[None].expand(C, N, features.shape[-1]), basis], dim=-1)
    i = 0
    while f"w{i}" in params:
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if f"w{i + 1}" in params:
            h = torch.relu(h)
        i += 1
    return h


def appearance_rgb(params: Params, features: torch.Tensor,  # [N, F]
                   colors: torch.Tensor,  # [N, 3] logits
                   image_ids: torch.Tensor,  # [C] int
                   dirs: torch.Tensor,  # [C, N, 3], unnormalized
                   sh_degree: int = 3) -> torch.Tensor:
    """The rendered colour ``[C, N, 3]``: ``sigmoid(colors + head)``."""
    return torch.sigmoid(appearance_color(params, features, image_ids, dirs, sh_degree)
                         + colors)


def appearance_rgb_from_centres(params: Params, features: torch.Tensor,  # [N, F]
                                colors: torch.Tensor,  # [N, 3] logits
                                image_ids: torch.Tensor,  # [C] int
                                means: torch.Tensor,  # [N, 3]
                                centres: torch.Tensor,  # [C, 3]
                                sh_degree: int = 3) -> torch.Tensor:
    """The rendered colour ``[C, N, 3]`` seen from the camera centres:
    ``appearance_rgb`` on the directions ``means[None] - centres[:, None]``.
    CPU tensors run that plain composition; CUDA tensors launch the
    kernel (``appearance_fwd``), whose checks raise on what it does not
    serve."""
    if means.device.type != "cuda":
        return appearance_rgb(params, features, colors, image_ids,
                              means[None] - centres[:, None], sh_degree)
    return app_ops.appearance_fwd(params, features, colors, image_ids, means, centres,
                                  sh_degree)
