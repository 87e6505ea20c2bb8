"""Densification over fixed-capacity buffers: counterpart of
``splat_one_tpu/train/strategy.py`` (gsplat's ``DefaultStrategy``).

Every transform is a masked update of capacity-``CAP`` buffers with an
``alive`` mask, so the step's shapes never change:
  - *duplicate*: the child copies its parent into a free slot,
  - *split*: the parent slot takes child 1 in place, child 2 goes to a free
    slot; both sample their positions from the parent gaussian and shrink
    its scales by 1.6,
  - *prune*: clears the alive bit,
  - free slots are matched to children in index order (a cumsum rank and
    a stable argsort of the free mask),
  - the Adam moments of touched slots are zeroed.

Gradient statistics come from the rasterizer's ``means2d_dummy`` /
``absgrad_dummy`` gradients, scaled to NDC-style units (grad * size / 2)
as gsplat does. The normal draws of a split are arguments
(``default_refine(noise, ...)``); the Trainer draws them from its
``torch.Generator``. The MCMC strategy's config is here because
``train.config`` names it; its ``mcmc_refine`` and ``mcmc_noise`` are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from splat_one_tpu_torch.core.transforms import quat_to_rotmat
from splat_one_tpu_torch.train.optimizers import AdamState, surgery_zero_moments
from splat_one_tpu_torch.utils.device import resolve as resolve_device

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DefaultStrategyCfg:
    """gsplat DefaultStrategy knobs."""

    prune_opa: float = 0.005
    grow_grad2d: float = 0.0002
    grow_scale3d: float = 0.01
    prune_scale3d: float = 0.1
    refine_start_iter: int = 500
    refine_stop_iter: int = 15_000
    reset_every: int = 3000
    refine_every: int = 100
    absgrad: bool = False
    revised_opacity: bool = False


@dataclasses.dataclass(frozen=True)
class MCMCStrategyCfg:
    """gsplat MCMCStrategy knobs (the strategy itself is not ported yet)."""

    cap_max: int = 1_000_000
    noise_lr: float = 5e5
    refine_start_iter: int = 500
    refine_stop_iter: int = 25_000
    refine_every: int = 100
    min_opacity: float = 0.005


class StrategyState(NamedTuple):
    grad2d: torch.Tensor  # [CAP] accumulated ||d(loss)/d(means2d)|| (NDC units)
    count: torch.Tensor  # [CAP] number of steps the gaussian was visible


def strategy_init(capacity: int, device="cuda") -> StrategyState:
    """Zeroed statistics for ``capacity`` slots, on CUDA unless
    ``device="cpu"`` (raises where CUDA is not available)."""
    dev = resolve_device(device)
    return StrategyState(
        grad2d=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        count=torch.zeros((capacity,), dtype=torch.float32, device=dev),
    )


def strategy_update(state: StrategyState, means2d_grad: torch.Tensor,
                    radii: torch.Tensor, width: int, height: int) -> StrategyState:
    """Accumulate one step's statistics: ``means2d_grad`` [C, N, 2] (the
    gradient of the means2d or absgrad hook), ``radii`` [C, N]."""
    scale = torch.tensor([width / 2.0, height / 2.0], dtype=torch.float32,
                         device=means2d_grad.device)
    norm = torch.linalg.norm(means2d_grad * scale, dim=-1)  # [C, N]
    visible = radii > 0
    grad2d = state.grad2d + torch.sum(torch.where(visible, norm, torch.zeros_like(norm)), 0)
    count = state.count + torch.sum(visible.float(), 0)
    return StrategyState(grad2d=grad2d, count=count)


def _free_slot_targets(free: torch.Tensor, need: torch.Tensor):
    """Match each needing slot (in index order) to a free slot.

    Returns ``(targets [CAP] int64 into the padded CAP + 1 rows, granted
    [CAP] bool)``; children that find no free slot get the sacrificial
    row CAP."""
    cap = free.shape[0]
    n_free = torch.sum(free.to(torch.int64))
    free_pos = torch.argsort((~free).to(torch.uint8), stable=True)  # free first
    child_rank = torch.cumsum(need.to(torch.int64), 0) - 1
    granted = need & (child_rank < n_free)
    targets = torch.where(granted, free_pos[torch.clamp(child_rank, 0, cap - 1)],
                          torch.full_like(free_pos, cap))
    return targets, granted


def _scatter_rows(params: Params, targets: torch.Tensor, child: Params) -> Params:
    """Write the child rows to their target slots (targets == CAP: dropped)."""
    keep = targets < next(iter(params.values())).shape[0]
    out = {}
    for k, x in params.items():
        x = x.clone()
        x[targets[keep]] = child[k][keep]
        out[k] = x
    return out


def _sample_from_gaussian(noise: torch.Tensor, params: Params,
                          shrink: float = 1.6) -> Params:
    """Children of every slot: means sampled from the parent gaussian with
    the standard normal ``noise`` [CAP, 3], scales shrunk by ``shrink``."""
    R = quat_to_rotmat(params["quats"])  # [CAP, 3, 3]
    local = noise * torch.exp(params["scales"])
    child = dict(params)
    child["means"] = params["means"] + torch.einsum("nij,nj->ni", R, local)
    child["scales"] = params["scales"] - torch.log(torch.tensor(shrink))
    return child


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (x.ndim - 1))


def default_refine(
    noise: Tuple[torch.Tensor, torch.Tensor],
    params: Params,
    opt_state: AdamState,
    alive: torch.Tensor,
    state: StrategyState,
    step: int,
    cfg: DefaultStrategyCfg,
    scene_scale: float,
) -> Tuple[Params, AdamState, torch.Tensor, StrategyState, Dict[str, torch.Tensor]]:
    """Grow (duplicate / split) and prune in fixed capacity.

    ``noise = (n1, n2)``: standard normal [CAP, 3] draws for the split's
    free-slot child (n1) and its in-place child (n2)."""
    cap = alive.shape[0]
    grads = state.grad2d / torch.clamp(state.count, min=1.0)
    max_scale = torch.exp(params["scales"]).amax(dim=-1)
    opa = torch.sigmoid(params["opacities"])

    is_grad_high = (grads > cfg.grow_grad2d) & alive
    is_small = max_scale <= cfg.grow_scale3d * scene_scale
    is_dupli = is_grad_high & is_small
    is_split = is_grad_high & ~is_small

    # prune first: it frees slots for the growth
    is_prune = (opa < cfg.prune_opa) & alive
    if step > cfg.reset_every:
        is_prune |= (max_scale > cfg.prune_scale3d * scene_scale) & alive
    alive = alive & ~is_prune
    is_dupli &= ~is_prune
    is_split &= ~is_prune

    need = is_dupli | is_split
    targets, granted = _free_slot_targets(~alive, need)

    child2 = _sample_from_gaussian(noise[0], params)
    child = {k: torch.where(_rows(is_dupli, params[k]), params[k], child2[k])
             for k in params}
    if cfg.revised_opacity:
        new_opa = 1.0 - torch.sqrt(torch.clamp(1.0 - opa, 1e-7, 1.0))
        rev = torch.log(new_opa / (1.0 - new_opa))
        child["opacities"] = torch.where(is_split, rev, child["opacities"])

    params = _scatter_rows(params, targets, child)
    # split parents are re-sampled in place (child 1)
    child1 = _sample_from_gaussian(noise[1], params)
    split_here = is_split & granted
    params = {k: torch.where(_rows(split_here, v), child1[k], v)
              for k, v in params.items()}

    new_slots = torch.zeros((cap,), dtype=torch.bool, device=alive.device)
    new_slots[targets[granted]] = True
    alive = alive | new_slots
    opt_state = surgery_zero_moments(opt_state, split_here | new_slots | is_prune)

    info = {
        "n_dupli": torch.sum(is_dupli.to(torch.int32)),
        "n_split": torch.sum(is_split.to(torch.int32)),
        "n_prune": torch.sum(is_prune.to(torch.int32)),
        "n_granted": torch.sum(granted.to(torch.int32)),
    }
    return params, opt_state, alive, strategy_init(cap, alive.device), info


def reset_opacity(params: Params, opt_state: AdamState, alive: torch.Tensor,
                  prune_opa: float = 0.005) -> Tuple[Params, AdamState]:
    """Clamp alive opacities to at most 2 * prune_opa and zero their Adam
    moments (gsplat DefaultStrategy reset_every)."""
    limit = torch.log(torch.tensor(2 * prune_opa / (1 - 2 * prune_opa),
                                   dtype=torch.float32))
    o = params["opacities"]
    params = dict(params)
    params["opacities"] = torch.where(alive, torch.minimum(o, limit.to(o.device)), o)
    m, v = dict(opt_state.m), dict(opt_state.v)
    m["opacities"] = torch.zeros_like(opt_state.m["opacities"])
    v["opacities"] = torch.zeros_like(opt_state.v["opacities"])
    return params, AdamState(m=m, v=v, count=opt_state.count)
