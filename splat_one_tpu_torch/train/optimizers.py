"""Per-parameter Adam for splat training: counterpart of
``splat_one_tpu/train/optimizers.py``.

A hand-rolled Adam over a dict of tensors keeps the moments plain per-slot
buffers, so densification's surgery (zeroing moments of re-allocated
slots) is a masked update. Learning rates: means 1.6e-4 * scene_scale
(decayed to 1% over max_steps), scales 5e-3, quats 1e-3, opacities 5e-2,
sh0 2.5e-3, shN 2.5e-3 / 20, all scaled by sqrt(batch size); betas and eps
adjusted for the batch. Updates return new tensors (no in-place writes),
as the JAX functions do.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    m: Params
    v: Params
    count: torch.Tensor  # [] int32


def base_lrs(scene_scale: float = 1.0) -> Dict[str, float]:
    return {
        "means": 1.6e-4 * scene_scale,
        "scales": 5e-3,
        "quats": 1e-3,
        "opacities": 5e-2,
        "sh0": 2.5e-3,
        "shN": 2.5e-3 / 20.0,
    }


def adam_hparams(world_batch: int = 1):
    """LR, eps and beta scaling with the world batch size."""
    bs = world_batch
    return dict(
        lr_scale=math.sqrt(bs),
        eps=1e-15 / math.sqrt(bs),
        b1=1.0 - bs * (1.0 - 0.9),
        b2=1.0 - bs * (1.0 - 0.999),
    )


def means_lr_decay(step: int, max_steps: int) -> torch.Tensor:
    """0.01 ** (step / max_steps), computed in f32 as the JAX package does
    (f32 step over f32 max_steps, f32 power)."""
    frac = torch.tensor(step, dtype=torch.float32) / torch.tensor(
        max_steps, dtype=torch.float32)
    return torch.pow(torch.tensor(0.01, dtype=torch.float32), frac)


def adam_init(params: Params) -> AdamState:
    zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
    dev = next(iter(params.values())).device
    return AdamState(m=zeros(), v=zeros(),
                     count=torch.zeros((), dtype=torch.int32, device=dev))


def adam_update(
    grads: Params,
    state: AdamState,
    params: Params,
    lrs: Dict[str, torch.Tensor],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
    visible_mask: Optional[torch.Tensor] = None,  # [CAP] SelectiveAdam
):
    """One Adam step -> ``(params, state)``. With ``visible_mask``, values
    and moments change only for visible slots (gsplat SelectiveAdam)."""
    count = state.count + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    new_p, new_m, new_v = {}, {}, {}
    for name in params:
        g = grads[name]
        m = state.m[name] * b1 + g * (1.0 - b1)
        v = state.v[name] * b2 + g * g * (1.0 - b2)
        p_new = params[name] - lrs[name] * (m / c1) / (torch.sqrt(v / c2) + eps)
        if visible_mask is not None:
            vis = visible_mask.reshape((-1,) + (1,) * (g.ndim - 1))
            m = torch.where(vis, m, state.m[name])
            v = torch.where(vis, v, state.v[name])
            p_new = torch.where(vis, p_new, params[name])
        new_p[name], new_m[name], new_v[name] = p_new, m, v
    return new_p, AdamState(m=new_m, v=new_v, count=count)


def surgery_zero_moments(state: AdamState, touched: torch.Tensor) -> AdamState:
    """Zero the Adam moments of re-allocated slots."""

    def z(x):
        mask = touched.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(mask, torch.zeros_like(x), x)

    return AdamState(m={k: z(x) for k, x in state.m.items()},
                     v={k: z(x) for k, x in state.v.items()}, count=state.count)
