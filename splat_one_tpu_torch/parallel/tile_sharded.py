"""Supertile-sharded multi-GPU rasterization: each rank composites one slab.

Counterpart of ``splat_one_tpu/parallel/tile_sharded.py``. Within a
camera, the (camera, supertile) grid is split into ``n`` slabs of
``ceil(C * SW * SH / n)`` cells over the ranks of a process group: every
rank projects all gaussians (replicated), builds the intersection stream
of its own slab only (the slab build enumerates exactly the in-slab
intersections, so its caps are a per-slab budget) and runs the stream
kernels on it with the slab's offset; the slabs are all-gathered into
the image. The whole per-camera pipeline after projection (the build,
packing, the forward and backward kernels, the reduction) is split over
the ranks. Gradients: each rank's backward covers its own slab, and the
replicated inputs' gradients are summed over the group, as the JAX
shard_map's transpose sums them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from splat_one_tpu_torch.ops import stream_raster
from splat_one_tpu_torch.ops.projection import project_gaussians
from splat_one_tpu_torch.ops.stream_isect import StreamCaps, supertile_grid
from splat_one_tpu_torch.parallel import comm
from splat_one_tpu_torch.render.rasterization import composite_slab, slab_cfg


def slab_caps(N: int, C: int, width: int, height: int, tile_size: int, n: int,
              avg_supertiles_per_gaussian: float) -> StreamCaps:
    """Per-slab caps: the global budget over ``n`` slabs with 4x slack for
    the slabs' unequal loads (JAX ``tile_sharded.py:76-83``)."""
    _, _, sw, sh = supertile_grid(width, height, tile_size)
    return StreamCaps.choose(N, C, -(-C * sw * sh // n),
                             avg_supertiles_per_gaussian=avg_supertiles_per_gaussian)


def slabs_to_image(slabs: torch.Tensor, C: int, N: int, width: int, height: int,
                   caps: StreamCaps, n: int, tile_size: int = 16,
                   camera_model: str = "pinhole"):
    """The gathered slabs ``[n * cs_local, ...]`` (or only their first
    ``cs_global`` cells) -> (rgb [C,H,W,3], alpha [C,H,W,1], expected
    depth [C,H,W,1])."""
    cfg, _, cs_global = slab_cfg(caps, width, height, tile_size, C, N, n, camera_model)
    rgb, alpha, depth = stream_raster.stream_to_image(
        dataclasses.replace(cfg, cs_local=0), slabs[:cs_global])
    return rgb, alpha, depth / torch.clamp(alpha, min=1e-10)


def rasterization_tile_sharded(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    sh_coeffs: torch.Tensor,
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    group,
    *,
    sh_degree: int = 3,
    tile_size: int = 16,
    camera_model: str = "pinhole",
    caps: Optional[StreamCaps] = None,  # per-slab caps
):
    """Render with the (camera, supertile) grid split over the ranks of
    ``group`` (every rank passes the same inputs) -> (rgb [C,H,W,3],
    alpha [C,H,W,1], expected depth [C,H,W,1]), the same on every rank.
    Differentiable: the inputs' gradients are whole on every rank."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    C, N = viewmats.shape[0], means.shape[0]
    if caps is None:
        caps = slab_caps(N, C, width, height, tile_size, n, max(12.0 / n, 0.75))
    ins = [comm.replicated(x, group) if x.requires_grad else x
           for x in (means, quats, scales, opacities, sh_coeffs, viewmats, Ks)]
    proj = project_gaussians(*ins[:4], ins[5], ins[6], width, height, sh_coeffs=ins[4],
                             sh_degree=sh_degree, camera_model=camera_model)
    out, _ = composite_slab(proj, i, n, width, height, tile_size, caps, camera_model)
    _, _, cs_global = slab_cfg(caps, width, height, tile_size, C, N, n)
    slabs = comm.gather_slabs(out, group, cs_global)
    return slabs_to_image(slabs, C, N, width, height, caps, n, tile_size, camera_model)
