"""Collectives of the multi-GPU path, with the gradients the JAX package's
transposes give.

In JAX the exchange is written once and autodiff transposes it: an
``all_gather`` into a ``psum_scatter``, a ``ppermute`` ring into the
reverse ring. Here each exchange is a ``torch.autograd.Function`` over a
``torch.distributed`` process group:
  - ``gather_gauss``: the gauss ranks' projected fields concatenated on
    the gaussian axis in global order, by one ``all_gather`` (JAX's
    ``ppermute`` ring, kept for the TPU's links, is not ported: no
    multi-GPU run has shown a ring of point-to-point hops beating NCCL's
    own); backward sums every rank's cotangent of a rank's slice back
    onto that rank (a reduce-scatter), so each shard's field gradients
    reach their owner;
  - ``gather_slabs``: every rank's supertile slab of the image, gathered;
    backward returns this rank's own slab of the cotangent, with no sum:
    every rank of the gauss group computes the same loss on the whole
    image, so a sum would give ``n``-fold gradients;
  - ``replicated``: the identity, whose backward sums the cotangent over
    the group (the gradient of a replicated input whose uses are split
    over the ranks).
``psum``, ``pmean``, ``pmax`` and ``all_gather`` reduce or gather plain
tensors (no gradient); gloo has no average, so ``pmean`` is a sum and a
division.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from splat_one_tpu_torch.ops.projection import Projected


def psum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return psum(x, group) / dist.get_world_size(group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenation of every rank's ``x`` on axis 0, in rank order (no
    gradient)."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


class _GatherAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), op=dist.ReduceOp.SUM,
                                   group=ctx.group)
        return out, None


class _GatherSlabs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, cs_global):
        ctx.group = group
        ctx.cs_local = x.shape[0]
        return all_gather(x, group)[:cs_global]

    @staticmethod
    def backward(ctx, g):
        lo = dist.get_rank(ctx.group) * ctx.cs_local
        own = g[lo:lo + ctx.cs_local]
        if own.shape[0] < ctx.cs_local:  # a slab of phantom supertiles
            own = torch.cat([own, own.new_zeros((ctx.cs_local - own.shape[0],)
                                                + tuple(own.shape[1:]))])
        return own.contiguous(), None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


def gather_slabs(out: torch.Tensor, group, cs_global: int) -> torch.Tensor:
    """Every gauss rank's slab output ``[cs_local, ...]``, concatenated in
    rank order and cut to the ``cs_global`` real cells (the last slabs'
    phantom cells go). Backward: this rank's own slab of the cotangent."""
    return _GatherSlabs.apply(out, group, cs_global)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose gradient is summed over ``group``."""
    return _Replicated.apply(x, group)


def gather_gauss(proj: Projected, group) -> Projected:
    """The gauss ranks' projections ``[C, n_local, ...]`` concatenated on the
    gaussian axis in rank order -> ``[C, n * n_local, ...]``, by one
    ``all_gather``. The fields travel as one f32 tensor; ``radii`` and
    ``valid`` carry no gradient."""
    widths = [2, 3, 1, 1, proj.colors.shape[-1], 1, 1]
    fields = torch.cat([proj.means2d, proj.conics, proj.depths[..., None],
                        proj.radii.detach().float()[..., None], proj.colors,
                        proj.opacities[..., None], proj.valid.float()[..., None]], dim=-1)
    x = fields.transpose(0, 1)  # the gaussian axis first: [n_local, C, F]
    parts = _GatherAll.apply(x, group).transpose(0, 1).split(widths, dim=-1)
    means2d, conics, depths, radii, colors, opacities, valid = parts
    return Projected(means2d, conics, depths[..., 0], radii[..., 0].detach(), colors,
                     opacities[..., 0], valid[..., 0] > 0.5)
