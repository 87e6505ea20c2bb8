"""Public rasterization API (forward): the port's ``rasterization()``.

Counterpart of ``splat_one_tpu/render/rasterization.py`` with the stream
backend: EWA projection (ops.projection) -> supertile-stream intersection
build (ops.stream_isect) -> forward compositing kernel
(ops.stream_raster) -> image assembly. Renders only: gradients come with
the backward kernels of a later slice, so a call whose inputs require
grad raises rather than return wrong gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

from splat_one_tpu_torch.ops import stream_isect as si_mod
from splat_one_tpu_torch.ops import stream_raster
from splat_one_tpu_torch.ops.projection import project_gaussians
from splat_one_tpu_torch.ops.stream_isect import StreamCaps
from splat_one_tpu_torch.ops.stream_raster import StreamCfg

_LATER = ("is not ported yet: it comes with the training slice "
          "(backward kernels and autograd.Function)")


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
    means2d_dummy=None,
    absgrad_dummy=None,
    impl: Optional[str] = None,
    proj_transform=None,
    st_shard=None,
):
    """Render gaussians into C cameras (forward only).

    Returns ``(render_colors [C,H,W,3|4|1], render_alphas [C,H,W,1],
    info)``; ``info`` holds ``radii``, ``depths``, ``valid``, ``n_isect``,
    ``overflow``, ``width``, ``height`` and ``n_cameras``."""
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
    for name, val in (("proj_transform", proj_transform),
                      ("means2d_dummy", means2d_dummy),
                      ("absgrad_dummy", absgrad_dummy)):
        if val is not None:
            raise NotImplementedError(f"{name} {_LATER}")
    inputs = (means, quats, scales, opacities, colors, viewmats, Ks, backgrounds)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in inputs):
        raise NotImplementedError(f"rendering with gradients {_LATER}")

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
    if caps is None:
        _, _, sgw, sgh = si_mod.supertile_grid(width, height, tile_size)
        caps = StreamCaps.choose(N, C, C * sgw * sgh)
    cfg = StreamCfg.from_caps(caps, width, height, tile_size, C, N,
                              wrap_x=(camera_model == "spherical"))
    isect = si_mod.build_stream_intersections(
        proj, width, height, tile_size, caps, camera_model=camera_model)
    out = stream_raster.composite_stream(
        cfg, proj.means2d, proj.conics, proj.colors, proj.opacities,
        proj.depths, proj.radii, isect)
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
        "radii": proj.radii,
        "depths": proj.depths,
        "valid": proj.valid,
        "n_isect": isect.n_isect,
        "overflow": isect.overflow,
        "width": width,
        "height": height,
        "n_cameras": C,
    }
    return render, alpha, info
