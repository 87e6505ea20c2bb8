"""Public rasterization API: the port's ``rasterization()``.

Counterpart of ``splat_one_tpu/render/rasterization.py``: differentiable
EWA projection (ops.projection, autograd) -> intersection build on the
detached projection -> the compositing ``autograd.Function`` (forward and
backward kernels, per-gaussian reduction) -> image assembly. Two
backends, as in the JAX package:
  - ``impl="stream"`` (default): the supertile stream (ops.stream_isect,
    ops.stream_raster);
  - ``impl="tiled"``: the gen-1 per-tile lists (ops.intersect,
    ops.tile_raster), the cross-check of the stream path.
``impl=None`` takes "tiled" for ``IsectCaps`` and "stream" otherwise.
Gradients reach means, quats, scales, opacities and colours, and the
``means2d_dummy`` / ``absgrad_dummy`` hooks that densification reads.

The multi-GPU hooks, as in the JAX package: ``proj_transform`` maps the
projection (of this rank's gaussian shard) to the gathered one
(``parallel.comm.gather_gauss``), and ``st_shard=(gauss group, n)``
splits the (camera, supertile) grid into ``n`` slabs: this rank builds
and composites only its own (``composite_slab``), and the slabs are
gathered into the image (``parallel.comm.gather_slabs``).

Each stage runs inside a span of ``utils.profiling`` (recorded only while
a torch profiler runs): ``render`` around the whole call,
``render.project``, ``render.build`` (counts ``exp_cap`` and
``n_isect``), ``render.composite`` and ``render.assemble``.

``rasterization_2dgs`` renders 2D gaussian surfels (``ops.surfels``:
2DGS's ray-splat intersection, gsplat's ``rasterization_2dgs``) forward
only, through the same spans, build and stream layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.distributed as dist

from splat_one_tpu_torch.ops import intersect as isect_mod
from splat_one_tpu_torch.ops import stream_isect as si_mod
from splat_one_tpu_torch.ops import stream_raster, surfels, tile_raster
from splat_one_tpu_torch.ops.intersect import IsectCaps
from splat_one_tpu_torch.ops.projection import Projected, project_gaussians
from splat_one_tpu_torch.ops.stream_isect import StreamCaps
from splat_one_tpu_torch.ops.stream_raster import StreamCfg
from splat_one_tpu_torch.ops.tile_raster import RasterCfg
from splat_one_tpu_torch.parallel import comm
from splat_one_tpu_torch.utils.profiling import count, span


def slab_cfg(caps: StreamCaps, width: int, height: int, tile_size: int, C: int, N: int,
             n: int, camera_model: str = "pinhole", absgrad: bool = False):
    """(cfg of one of ``n`` supertile slabs, its ``cs_local``, the grid's
    ``cs_global``): ``cs_local = ceil(cs_global / n)``, so the last slabs
    may end in phantom cells past the grid, which stay empty."""
    _, _, sgw, sgh = si_mod.supertile_grid(width, height, tile_size, caps.ss)
    cs_global = C * sgw * sgh
    cs_local = -(-cs_global // n)
    cfg = StreamCfg(width=width, height=height, tile_size=tile_size, num_cameras=C,
                    num_gaussians=N, chunk=caps.chunk, exp_cap=caps.exp_cap,
                    n_supertiles=sgw * sgh, wrap_x=camera_model == "spherical",
                    absgrad=absgrad, ss=caps.ss, cs_local=cs_local)
    return cfg, cs_local, cs_global


def composite_slab(proj: Projected, i: int, n: int, width: int, height: int,
                   tile_size: int, caps: StreamCaps, camera_model: str = "pinhole",
                   absgrad_dummy: Optional[torch.Tensor] = None):
    """One rank's share of a supertile-sharded render: slab ``i`` of ``n``
    of the (camera, supertile) grid, from the gathered projection ``proj``
    (every gaussian) -> ``(out [cs_local, NT, OUT_CH, P], isect)``.
    Differentiable in ``proj`` as ``composite_stream``; ``caps`` are
    per-slab. No collective: the per-rank body of
    ``parallel.tile_sharded`` and ``parallel.ring_sharded``."""
    C, N = proj.depths.shape
    cfg, cs_local, _ = slab_cfg(caps, width, height, tile_size, C, N, n, camera_model,
                                absgrad=absgrad_dummy is not None)
    st_lo = i * cs_local
    proj_sg = Projected(*(x.detach() for x in proj))
    with span("render.build"):
        isect = si_mod.build_stream_intersections(
            proj_sg, width, height, tile_size, caps, camera_model=camera_model,
            st_lo=st_lo, n_st_local=cs_local)
        _count_isect(caps, isect)
    with span("render.composite"):
        out = stream_raster.composite_stream(
            cfg, proj.means2d, proj.conics, proj.colors, proj.opacities, proj.depths,
            proj_sg.radii, isect, abs_dummy=absgrad_dummy, tile_offset=st_lo)
    return out, isect


def _assemble(images, backgrounds, render_mode: str):
    """(rgb, alpha, accumulated depth) images -> ``(render, alpha)``: the
    background blended in and the channels ``render_mode`` asks for."""
    rgb, alpha, depth = images
    if backgrounds is not None:
        rgb = rgb + (1.0 - alpha) * backgrounds[:, None, None, :]
    if "ED" in render_mode:
        # expected depth (gsplat ED): accumulated depth / alpha
        depth = depth / torch.clamp(alpha, min=1e-10)
    if render_mode == "RGB":
        return rgb, alpha
    if render_mode in ("RGB+ED", "RGB+D"):
        return torch.cat([rgb, depth], dim=-1), alpha
    return depth, alpha


def _count_isect(caps, isect):
    """The build's counts: the keys it sorts and the intersections among them."""
    count("exp_cap", caps.exp_cap)
    count("n_isect", isect.n_isect)


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
    caps: Optional[Union[IsectCaps, StreamCaps]] = None,
    alive: Optional[torch.Tensor] = None,  # [N] bool
    means2d_dummy: Optional[torch.Tensor] = None,  # [C, N, 2] grad hook
    absgrad_dummy: Optional[torch.Tensor] = None,  # [C, N, 2] absgrad hook
    impl: Optional[str] = None,  # "stream" | "tiled"; inferred from caps
    proj_transform=None,  # Projected -> Projected, after the projection
    st_shard=None,  # (gauss process group, n slabs): stream impl only
):
    """Render gaussians into C cameras. Differentiable.

    Returns ``(render_colors [C,H,W,3|4|1], render_alphas [C,H,W,1],
    info)``; ``info`` holds ``radii``, ``radii_local`` (before
    ``proj_transform``), ``depths``, ``valid``, ``n_isect``,
    ``overflow``, ``width``, ``height`` and ``n_cameras``.

    ``means2d_dummy`` (zeros) is added to the projected means, so its
    gradient is d(loss)/d(means2d): the counterpart of gsplat's retained
    ``means2d.grad``. ``absgrad_dummy``'s gradient is the per-gaussian sum
    of |d(loss)/d(means2d)| over pixels (of this rank's slab, under
    ``st_shard``; it is shaped like the transformed projection).

    ``proj_transform`` (multi-GPU): applied to the projection of this
    rank's gaussians after ``means2d_dummy`` is added, so that dummy's
    gradient stays shard-shaped; ``parallel.comm.gather_gauss`` gathers
    the gauss ranks' projections and sends the field gradients back.
    ``st_shard=(group, n)``: this rank (``dist.get_rank(group)``) builds
    and composites slab ``i`` of ``n`` (``composite_slab``; ``caps`` are
    per-slab), the slabs are gathered by ``comm.gather_slabs``;
    ``n_isect`` is the largest slab's and ``overflow`` any slab's."""
    if render_mode not in ("RGB", "RGB+ED", "RGB+D", "ED", "D"):
        raise ValueError(f"bad render_mode {render_mode!r}")
    if rasterize_mode not in ("classic", "antialiased"):
        raise ValueError(f"bad rasterize_mode {rasterize_mode!r}")
    if impl is None:
        impl = "tiled" if isinstance(caps, IsectCaps) else "stream"
    if impl not in ("stream", "tiled"):
        raise ValueError(f"bad impl {impl!r}")
    if st_shard is not None and impl != "stream":
        raise ValueError("st_shard needs impl='stream'")

    with span("render"):
        N = means.shape[0]
        C = viewmats.shape[0]
        sh = colors if sh_degree is not None else None
        flat_colors = colors if sh_degree is None else None
        with span("render.project"):
            proj = project_gaussians(
                means, quats, scales, opacities, viewmats, Ks, width, height,
                sh_coeffs=sh, sh_degree=(sh_degree or 0), colors=flat_colors,
                camera_model=camera_model, near_plane=near_plane, far_plane=far_plane,
                radius_clip=radius_clip,
                antialiased=(rasterize_mode == "antialiased"), alive=alive,
            )
        if means2d_dummy is not None:
            proj = proj._replace(means2d=proj.means2d + means2d_dummy)
        radii_local = proj.radii.detach()
        if proj_transform is not None:
            proj = proj_transform(proj)
            N = proj.means2d.shape[1]  # the gathered gaussian count
        # the layout is integer bookkeeping: built from a detached projection
        proj_sg = Projected(*(x.detach() for x in proj))
        wrap = camera_model == "spherical"
        if impl == "stream":
            if not isinstance(caps, StreamCaps):
                _, _, sgw, sgh = si_mod.supertile_grid(width, height, tile_size)
                caps = StreamCaps.choose(N, C, C * sgw * sgh)
            if st_shard is not None:
                group, n = st_shard
                out, isect = composite_slab(proj, dist.get_rank(group), n, width, height,
                                            tile_size, caps, camera_model, absgrad_dummy)
                cfg, _, cs_global = slab_cfg(caps, width, height, tile_size, C, N, n,
                                             camera_model)
                out = comm.gather_slabs(out, group, cs_global)
                cfg = dataclasses.replace(cfg, cs_local=0)
            else:
                cfg = StreamCfg.from_caps(caps, width, height, tile_size, C, N, wrap_x=wrap,
                                          absgrad=(absgrad_dummy is not None))
                with span("render.build"):
                    isect = si_mod.build_stream_intersections(
                        proj_sg, width, height, tile_size, caps, camera_model=camera_model)
                    _count_isect(caps, isect)
                with span("render.composite"):
                    out = stream_raster.composite_stream(
                        cfg, proj.means2d, proj.conics, proj.colors, proj.opacities,
                        proj.depths, proj_sg.radii, isect, abs_dummy=absgrad_dummy)
            to_image = stream_raster.stream_to_image
        else:
            if not isinstance(caps, IsectCaps):
                tw = -(-width // tile_size)
                th = -(-height // tile_size)
                caps = IsectCaps.choose(N, C, tw * th)
            cfg = RasterCfg(width=width, height=height, tile_size=tile_size,
                            num_cameras=C, num_gaussians=N, chunk=caps.chunk,
                            align_cap=caps.align_cap, wrap_x=wrap)
            with span("render.build"):
                isect = isect_mod.build_intersections(
                    proj_sg, width, height, tile_size, caps, camera_model=camera_model)
                _count_isect(caps, isect)
            with span("render.composite"):
                out = tile_raster.composite_tiles(
                    cfg, proj.means2d, proj.conics, proj.colors, proj.opacities,
                    proj.depths, isect, abs_dummy=absgrad_dummy)
            to_image = tile_raster.tiles_to_image

        with span("render.assemble"):
            render, alpha = _assemble(to_image(cfg, out), backgrounds, render_mode)

        n_isect, overflow = isect.n_isect, isect.overflow
        if st_shard is not None:
            # growth follows the fullest slab; overflow anywhere is everyone's
            n_isect = comm.pmax(n_isect, st_shard[0])
            overflow = comm.psum(overflow.int(), st_shard[0]) > 0
        info = {
            "radii": proj_sg.radii,
            "radii_local": radii_local,
            "depths": proj.depths,
            "valid": proj.valid,
            "n_isect": n_isect,
            "overflow": overflow,
            "width": width,
            "height": height,
            "n_cameras": C,
        }
        return render, alpha, info


def rasterization_2dgs(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 2 or 3]: the first two are the surfel's
    opacities: torch.Tensor,  # [N]
    colors: torch.Tensor,  # [N, K, 3] SH coefficients
    viewmats: torch.Tensor,  # [C, 4, 4]
    Ks: torch.Tensor,  # [C, 3, 3]
    width: int,
    height: int,
    *,
    sh_degree: int = 3,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    camera_model: str = "pinhole",
    render_mode: str = "RGB",
):
    """Render 2D gaussian surfels into C pinhole cameras, forward only:
    ``ops.surfels``' projection (counts ``n_visible``, the surfels with a
    screen footprint, in ``render.project``), the stream build over the
    surfels' boxes (16 px tiles, ``StreamCaps.choose``), the surfel pack
    and forward, and ``rasterization``'s image assembly. ``render_mode``
    as ``rasterization``'s; its depth is gsplat's ``RGB+ED`` for 2DGS: each
    surfel's centre depth, accumulated (not the per-pixel intersection
    depth of the 2DGS paper's rasterizer).

    Returns ``(render_colors, render_alphas, info)`` as ``rasterization``
    does; ``info`` holds ``means2d``, ``boxes``, ``depths``, ``valid``,
    ``n_isect``, ``overflow``, ``width``, ``height`` and ``n_cameras``.
    CUDA inputs that autograd records through raise ``ValueError``: the
    kernels have no backward. On the CPU the plain versions run."""
    if render_mode not in ("RGB", "RGB+ED", "RGB+D", "ED", "D"):
        raise ValueError(f"bad render_mode {render_mode!r}")
    if camera_model != "pinhole":
        raise ValueError(f"2DGS is served through pinhole cameras, got {camera_model!r}")

    with span("render"):
        N = means.shape[0]
        C = viewmats.shape[0]
        with span("render.project"):
            proj = surfels.project_surfels(means, quats, scales, opacities, viewmats, Ks, width,
                                           height, colors, sh_degree, near_plane, far_plane)
            valid = proj.valid
            count("n_visible", lambda: valid.sum())
        _, _, sgw, sgh = si_mod.supertile_grid(width, height, 16)
        caps = StreamCaps.choose(N, C, C * sgw * sgh)
        cfg = StreamCfg.from_caps(caps, width, height, 16, C, N)
        with span("render.build"):
            isect = si_mod.build_stream_intersections(proj, width, height, 16, caps)
            _count_isect(caps, isect)
        with span("render.composite"):
            with span("build.pack"):
                packed = surfels.pack_surfel_fields(proj, isect, caps)
            out = surfels.surfel_fwd(cfg, isect.st_starts, packed)
        with span("render.assemble"):
            render, alpha = _assemble(stream_raster.stream_to_image(cfg, out), None,
                                      render_mode)
        info = {
            "means2d": proj.means2d,
            "boxes": proj.boxes,
            "depths": proj.depths,
            "valid": proj.valid,
            "n_isect": isect.n_isect,
            "overflow": isect.overflow,
            "width": width,
            "height": height,
            "n_cameras": C,
        }
        return render, alpha, info
