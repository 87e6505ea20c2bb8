"""Gaussian-sharded x supertile-sharded multi-GPU rasterization.

Counterpart of ``splat_one_tpu/parallel/ring_sharded.py``: the two
shardings composed over the ranks of one process group. Every rank
projects only its own 1/n of the gaussians (projection and SH are the
memory-heavy stage), the projected fields (a few floats a gaussian,
much smaller than the SH-laden parameters) are all-gathered in global
order (``comm.gather_gauss``; JAX passes them round a ``ppermute`` ring),
and every rank builds and composites only its supertile slab of the
image (``render.rasterization.composite_slab``); the slabs are
all-gathered. Backward, the gather's reduce-scatter sends the slab's
field gradients to the shard that owns them: parameter gradients stay
sharded end to end.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from splat_one_tpu_torch.ops.projection import project_gaussians
from splat_one_tpu_torch.ops.stream_isect import StreamCaps
from splat_one_tpu_torch.parallel import comm
from splat_one_tpu_torch.parallel.tile_sharded import slab_caps, slabs_to_image
from splat_one_tpu_torch.render.rasterization import composite_slab, slab_cfg


def rasterization_ring_sharded(
    means: torch.Tensor,  # [N / n, 3]: this rank's shard
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    sh_coeffs: torch.Tensor,
    viewmats: torch.Tensor,  # [C, 4, 4], the same on every rank
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    group,
    *,
    sh_degree: int = 3,
    tile_size: int = 16,
    camera_model: str = "pinhole",
    caps: Optional[StreamCaps] = None,  # per-slab caps
    alive: Optional[torch.Tensor] = None,  # [N / n] bool, this rank's shard
):
    """Render C cameras with the gaussians and the supertiles split over the
    ranks of ``group`` -> (rgb, alpha, expected depth) images, the same on
    every rank; gradients land on each rank's own shard."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    C, N = viewmats.shape[0], means.shape[0] * n
    if caps is None:
        caps = slab_caps(N, C, width, height, tile_size, n, 12.0 / n)
    proj = project_gaussians(means, quats, scales, opacities, viewmats, Ks, width, height,
                             sh_coeffs=sh_coeffs, sh_degree=sh_degree,
                             camera_model=camera_model, alive=alive)
    proj_cat = comm.gather_gauss(proj, group)
    out, _ = composite_slab(proj_cat, i, n, width, height, tile_size, caps, camera_model)
    _, _, cs_global = slab_cfg(caps, width, height, tile_size, C, N, n)
    slabs = comm.gather_slabs(out, group, cs_global)
    return slabs_to_image(slabs, C, N, width, height, caps, n, tile_size, camera_model)
