"""Public rasterization API: the port's ``rasterization()``.

Counterpart of ``splat_one_tpu/render/rasterization.py`` with the stream
backend: differentiable EWA projection (ops.projection, autograd) ->
supertile-stream intersection build on the detached projection
(ops.stream_isect) -> the compositing ``autograd.Function``
(ops.stream_raster: forward and backward kernels, per-gaussian
reduction) -> image assembly. Gradients reach means, quats, scales,
opacities and colours, and the ``means2d_dummy`` / ``absgrad_dummy``
hooks that densification reads.
"""

from __future__ import annotations

from typing import Optional

import torch

from splat_one_tpu_torch.ops import stream_isect as si_mod
from splat_one_tpu_torch.ops import stream_raster
from splat_one_tpu_torch.ops.projection import Projected, project_gaussians
from splat_one_tpu_torch.ops.stream_isect import StreamCaps
from splat_one_tpu_torch.ops.stream_raster import StreamCfg


def rasterization(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3]
    opacities: torch.Tensor,  # [N]
    colors: torch.Tensor,  # [N, K, 3] SH coeffs if sh_degree is not None else [N, 3] / [C, N, 3]
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    *,
    sh_degree: Optional[int] = None,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    radius_clip: float = 0.0,
    tile_size: int = 16,
    camera_model: str = "pinhole",
    render_mode: str = "RGB",
    rasterize_mode: str = "classic",
    backgrounds: Optional[torch.Tensor] = None,  # [C, 3]
    caps: Optional[StreamCaps] = None,
    alive: Optional[torch.Tensor] = None,  # [N] bool
    means2d_dummy: Optional[torch.Tensor] = None,  # [C, N, 2] grad hook
    absgrad_dummy: Optional[torch.Tensor] = None,  # [C, N, 2] absgrad hook
    impl: Optional[str] = None,
    proj_transform=None,
    st_shard=None,
):
    """Render gaussians into C cameras. Differentiable.

    Returns ``(render_colors [C,H,W,3|4|1], render_alphas [C,H,W,1],
    info)``; ``info`` holds ``radii``, ``radii_local`` (the same: there is
    no ``proj_transform`` yet), ``depths``, ``valid``, ``n_isect``,
    ``overflow``, ``width``, ``height`` and ``n_cameras``.

    ``means2d_dummy`` (zeros) is added to the projected means, so its
    gradient is d(loss)/d(means2d): the counterpart of gsplat's retained
    ``means2d.grad``. ``absgrad_dummy``'s gradient is the per-gaussian sum
    of |d(loss)/d(means2d)| over pixels."""
    if render_mode not in ("RGB", "RGB+ED", "RGB+D", "ED", "D"):
        raise ValueError(f"bad render_mode {render_mode!r}")
    if rasterize_mode not in ("classic", "antialiased"):
        raise ValueError(f"bad rasterize_mode {rasterize_mode!r}")
    if impl not in (None, "stream") or (
            caps is not None and not isinstance(caps, StreamCaps)):
        raise NotImplementedError(
            "impl='tiled' is not ported yet: it comes with the gen-1 "
            "cross-check rasterizer slice (ops/intersect.py, ops/tile_raster.py)")
    if st_shard is not None:
        raise NotImplementedError("st_shard (multi-GPU supertile slabs) is "
                                  "not ported yet: it comes with the "
                                  "multi-GPU slice")
    if proj_transform is not None:
        raise NotImplementedError("proj_transform (multi-GPU gather of "
                                  "projections) is not ported yet: it comes "
                                  "with the multi-GPU slice")

    N = means.shape[0]
    C = viewmats.shape[0]
    sh = colors if sh_degree is not None else None
    flat_colors = colors if sh_degree is None else None
    proj = project_gaussians(
        means, quats, scales, opacities, viewmats, Ks, width, height,
        sh_coeffs=sh, sh_degree=(sh_degree or 0), colors=flat_colors,
        camera_model=camera_model, near_plane=near_plane, far_plane=far_plane,
        radius_clip=radius_clip,
        antialiased=(rasterize_mode == "antialiased"), alive=alive,
    )
    if means2d_dummy is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_dummy)
    # the layout is integer bookkeeping: built from a detached projection
    proj_sg = Projected(*(x.detach() for x in proj))
    if caps is None:
        _, _, sgw, sgh = si_mod.supertile_grid(width, height, tile_size)
        caps = StreamCaps.choose(N, C, C * sgw * sgh)
    cfg = StreamCfg.from_caps(caps, width, height, tile_size, C, N,
                              wrap_x=(camera_model == "spherical"),
                              absgrad=(absgrad_dummy is not None))
    isect = si_mod.build_stream_intersections(
        proj_sg, width, height, tile_size, caps, camera_model=camera_model)
    out = stream_raster.composite_stream(
        cfg, proj.means2d, proj.conics, proj.colors, proj.opacities,
        proj.depths, proj_sg.radii, isect, abs_dummy=absgrad_dummy)
    rgb, alpha, depth = stream_raster.stream_to_image(cfg, out)

    if backgrounds is not None:
        rgb = rgb + (1.0 - alpha) * backgrounds[:, None, None, :]
    if "ED" in render_mode:
        # expected depth (gsplat ED): accumulated depth / alpha
        depth = depth / torch.clamp(alpha, min=1e-10)
    if render_mode == "RGB":
        render = rgb
    elif render_mode in ("RGB+ED", "RGB+D"):
        render = torch.cat([rgb, depth], dim=-1)
    else:
        render = depth

    info = {
        "radii": proj_sg.radii,
        "radii_local": proj_sg.radii,
        "depths": proj.depths,
        "valid": proj.valid,
        "n_isect": isect.n_isect,
        "overflow": isect.overflow,
        "width": width,
        "height": height,
        "n_cameras": C,
    }
    return render, alpha, info
