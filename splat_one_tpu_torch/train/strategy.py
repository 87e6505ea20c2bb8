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
``torch.Generator``.

The MCMC strategy (3DGS as MCMC): ``mcmc_refine`` relocates dead
(low-opacity) gaussians onto live ones and grows the population 5 %
toward ``cap_max``, ``mcmc_noise`` adds covariance-shaped noise to the
means of near-dead gaussians every step. Their draws are arguments too:
``mcmc_draw_targets`` samples the relocation and growth targets in
proportion to opacity with ``torch.multinomial`` (O(cap) memory; the JAX
package's ``jax.random.categorical`` over ``cap`` logits builds a
``[cap, cap]`` array), and the Trainer passes the normal draws of the
noise.
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
    """gsplat MCMCStrategy knobs."""

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


# ---------------------------------------------------------------------------
# MCMC strategy (3DGS as MCMC: stochastic relocation + noise injection)
# ---------------------------------------------------------------------------

MAX_CATEGORIES = 1 << 24  # torch.multinomial's limit on the categories


def _mcmc_masks(params: Params, alive: torch.Tensor, cfg: MCMCStrategyCfg):
    opa = torch.sigmoid(params["opacities"])
    dead = alive & (opa < cfg.min_opacity)
    return opa, dead, alive & ~dead


def mcmc_draw_targets(params: Params, alive: torch.Tensor, cfg: MCMCStrategyCfg,
                      generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two vectors of ``cap`` slot indices, each drawn with replacement in
    proportion to ``max(opacity, 1e-8)`` over the live gaussians: the
    distribution of ``categorical(log p)`` in the JAX package. With no
    live gaussian every draw is slot 0, as the arg-max of all -inf logits
    is there."""
    cap = alive.shape[0]
    if cap > MAX_CATEGORIES:
        raise ValueError(f"MCMC targets: capacity {cap} is above torch.multinomial's "
                         f"{MAX_CATEGORIES} categories")
    opa, _, live = _mcmc_masks(params, alive, cfg)
    p = torch.where(live, torch.clamp(opa, min=1e-8), torch.zeros_like(opa))
    p[0] += (p.sum() == 0).to(p.dtype)
    return tuple(torch.multinomial(p, cap, replacement=True, generator=generator)
                 for _ in range(2))


def _relocation_opacity_scale(opa, scales, n_split):
    """Splitting a gaussian into n keeps its rendered mass:
    o' = 1 - (1 - o)^(1/n); scales shrink by the matching factor."""
    n = torch.clamp(n_split.to(torch.float32), min=1.0)
    new_opa = 1.0 - torch.pow(1.0 - opa, 1.0 / n)
    ratio = new_opa * torch.sqrt(n) / torch.clamp(opa, min=1e-7)
    new_scales = scales - 0.5 * torch.log(torch.clamp(ratio, min=1e-7))[..., None]
    return new_opa, new_scales


def _logit(p):
    p = torch.clamp(p, 1e-7, 1 - 1e-7)
    return torch.log(p / (1 - p))


def mcmc_refine(tgt: torch.Tensor, tgt2: torch.Tensor, params: Params,
                opt_state: AdamState, alive: torch.Tensor, cfg: MCMCStrategyCfg
                ) -> Tuple[Params, AdamState, torch.Tensor, Dict[str, torch.Tensor]]:
    """Relocate dead gaussians to the targets ``tgt`` [cap], then grow the
    population 5 % toward ``cap_max`` into free slots copied from the
    targets ``tgt2`` [cap] (``mcmc_draw_targets``). Each source gives up
    mass to its copies (the relocation opacity and scale); the Adam
    moments of every touched slot are zeroed."""
    cap = alive.shape[0]
    opa, dead, live = _mcmc_masks(params, alive, cfg)
    picks = torch.zeros((cap,), dtype=torch.int32, device=alive.device).index_add_(
        0, tgt, dead.to(torch.int32))
    new_opa_t, new_scales_t = _relocation_opacity_scale(opa, params["scales"], picks + 1)
    new_opa_logit = _logit(new_opa_t)
    params = {k: (v if k in ("scales", "opacities")
                  else torch.where(_rows(dead, v), v[tgt], v)) for k, v in params.items()}
    params["scales"] = torch.where(dead[:, None], new_scales_t[tgt], params["scales"])
    params["opacities"] = torch.where(dead, new_opa_logit[tgt], params["opacities"])
    split = (picks > 0) & live
    params["opacities"] = torch.where(split, new_opa_logit, params["opacities"])
    params["scales"] = torch.where(split[:, None], new_scales_t, params["scales"])

    # growth into free slots, 5 % of the alive count, up to cap_max
    n_live = torch.sum(alive.to(torch.int32))
    budget = torch.minimum((n_live.to(torch.float32) * 0.05).to(torch.int32),
                           torch.clamp(min(cfg.cap_max, cap) - n_live, min=0))
    free = ~alive
    rank = torch.cumsum(free.to(torch.int32), 0) - 1
    grow = free & (rank < budget)
    picks2 = torch.zeros_like(picks).index_add_(0, tgt2, grow.to(torch.int32))
    opa2_t, scales2_t = _relocation_opacity_scale(
        torch.sigmoid(params["opacities"]), params["scales"], picks2 + 1)
    opa2_logit = _logit(opa2_t)
    params = {k: (v if k in ("scales", "opacities")
                  else torch.where(_rows(grow, v), v[tgt2], v)) for k, v in params.items()}
    params["opacities"] = torch.where(grow, opa2_logit[tgt2], params["opacities"])
    params["scales"] = torch.where(grow[:, None], scales2_t[tgt2], params["scales"])
    sampled = (picks2 > 0) & live
    params["opacities"] = torch.where(sampled, opa2_logit, params["opacities"])
    params["scales"] = torch.where(sampled[:, None], scales2_t, params["scales"])

    opt_state = surgery_zero_moments(opt_state, dead | grow)
    info = {"n_relocated": torch.sum(dead.to(torch.int32)),
            "n_grown": torch.sum(grow.to(torch.int32))}
    return params, opt_state, alive | grow, info


def mcmc_noise(eps: torch.Tensor, params: Params, alive: torch.Tensor,
               lr_means: torch.Tensor, noise_lr: float = 5e5) -> Params:
    """SGLD-style noise on the means: ``eps`` [cap, 3] standard normal
    draws, scaled by lr_means * noise_lr and an opacity gate that is ~1
    only below opacity 0.005, then shaped by the covariance
    R diag(S^2) R^T (gsplat MCMC ``_add_noise_to_splats``)."""
    opa = torch.sigmoid(params["opacities"])
    gate = torch.sigmoid(100.0 * ((1.0 - opa) - 0.995))
    R = quat_to_rotmat(params["quats"])
    e = eps * (gate * lr_means * noise_lr)[:, None]
    tmp = torch.einsum("nji,nj->ni", R, e) * torch.exp(2.0 * params["scales"])
    noise_w = torch.einsum("nij,nj->ni", R, tmp)
    out = dict(params)
    out["means"] = torch.where(alive[:, None], params["means"] + noise_w, params["means"])
    return out
