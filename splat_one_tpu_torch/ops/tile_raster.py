"""Gen-1 per-tile compositing: forward, backward and their autograd.Function.

Counterpart of ``splat_one_tpu/ops/tile_raster.py`` (``impl="tiled"``).
One program per (camera, 16 px tile) walks the tile's G-aligned slot
range (``ops.intersect``) in chunks of G = 128 and composites front to
back with a running transmittance. The tile stops at the first chunk
start where all its 256 pixels have T < ``RasterCfg.term_thresh``
(default ``TERM_THRESH``; ``<= 0`` never stops); the number of
chunks it processed goes to channel ``CH_NCHUNKS`` of the output
[CT, OUT_CH, 256]: rgb, alpha = 1 - T, accumulated depth, n_chunks and
two zero channels. Tile membership comes from the builder, so the kernels
have no per-slot gate; padding slots are zero rows (opacity 0).

The backward replays each tile's first n_chunks chunks in forward order
with per-pixel prefix accumulators and writes one gradient row per slot
(``intersect.GROW_*``, [align_cap, NF]); ``intersect.gather_reduction``
sums them per gaussian. ``composite_tiles`` wraps both in a
``torch.autograd.Function``.

``tile_fwd`` and ``tile_bwd`` launch the hand-written CUDA kernels
(``csrc/tile_fwd.cu``, ``csrc/tile_bwd.cu``) on CUDA tensors and run
``tile_fwd_plain`` / ``tile_bwd_plain``, their plain PyTorch versions, on
CPU tensors. The JAX kernels' log-space transmittance and triangular
matmuls are MXU forms of the same sums; the port takes them serially.

Tile slabs: with ``RasterCfg.ct_local`` the grid spans ``ct_local`` tiles
of a layout built with ``intersect.build_intersections(tile_lo=...)``,
and every function here takes ``tile_offset`` (a host int, that
``tile_lo``): a tile's own index addresses its slots and output, its
pixels come from the global id ``t + tile_offset``.
"""

from __future__ import annotations

import dataclasses

import torch

from splat_one_tpu_torch.ops import intersect as isect_mod
from splat_one_tpu_torch.ops.intersect import NF, IsectData
from splat_one_tpu_torch.ops.reference import ALPHA_MAX, ALPHA_MIN
from splat_one_tpu_torch.ops.stream_raster import TERM_THRESH, _inv_width, warp_sum
from splat_one_tpu_torch.utils import cuda_build
from splat_one_tpu_torch.utils.profiling import span

OUT_CH = 8  # r, g, b, alpha, depth, n_chunks, pad, pad
CH_NCHUNKS = 5
# Tiles composited per step of the plain versions (bounds their memory).
_PLAIN_BATCH = 4096
_WARP = 32


@dataclasses.dataclass(frozen=True)
class RasterCfg:
    """Tile-compositor configuration."""

    width: int
    height: int
    tile_size: int
    num_cameras: int
    num_gaussians: int
    chunk: int  # G
    align_cap: int
    wrap_x: bool = False  # spherical azimuth seam
    term_thresh: float = TERM_THRESH  # <= 0: no tile stops early
    ct_local: int = 0  # tiles of one slab; 0: the whole grid

    @property
    def tw(self):
        return -(-self.width // self.tile_size)

    @property
    def th(self):
        return -(-self.height // self.tile_size)

    @property
    def ct(self):
        return self.ct_local or self.num_cameras * self.tw * self.th

    @property
    def npix(self):
        return self.tile_size * self.tile_size


def _tile_pixels(cfg: RasterCfg, t: torch.Tensor):
    """Pixel centres (px, py) [S, P] (f32) of flat (camera, tile) ids ``t``."""
    ts = cfg.tile_size
    rem = t % (cfg.tw * cfg.th)
    ty = torch.div(rem, cfg.tw, rounding_mode="floor")
    tx = rem % cfg.tw
    local = torch.arange(cfg.npix, device=t.device)
    px = (tx[:, None] * ts + local % ts).float() + 0.5
    py = (ty[:, None] * ts + torch.div(local, ts, rounding_mode="floor")).float() + 0.5
    return px, py


def _slot_alpha(cfg: RasterCfg, c, px, py, inv_w):
    """Per-pixel quantities of one slot for every selected tile: ``c`` is
    the slot's row [S, NF, 1], px / py [S, P]."""
    dx = c[:, isect_mod.ROW_X] - px
    if cfg.wrap_x:
        dx = dx - cfg.width * torch.round(dx * inv_w)
    dy = c[:, isect_mod.ROW_Y] - py
    ca, cb, cc = c[:, isect_mod.ROW_CA], c[:, isect_mod.ROW_CB], c[:, isect_mod.ROW_CC]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    expneg = torch.exp(-sigma)
    alpha_raw = c[:, isect_mod.ROW_OPAC] * expneg
    killed = (sigma < 0.0) | (alpha_raw < ALPHA_MIN)
    alpha = torch.where(killed, torch.zeros_like(alpha_raw),
                        torch.clamp(alpha_raw, max=ALPHA_MAX))
    return dx, dy, ca, cb, cc, expneg, alpha_raw, killed, alpha


def tile_fwd_plain(cfg: RasterCfg, starts: torch.Tensor,
                   packed: torch.Tensor, tile_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: the same chunking,
    kill rules and termination as ``csrc/tile_fwd.cu`` and the same
    per-slot arithmetic in the same order (a serial loop over the G slots
    of a chunk), vectorised over tiles and pixels."""
    G, P, CT = cfg.chunk, cfg.npix, cfg.ct
    dev = packed.device
    s = starts.long()
    s0 = s[:-1]
    nchunks = torch.div(s[1:] - s0, G, rounding_mode="floor")
    T = torch.ones((CT, P), dtype=torch.float32, device=dev)
    acc = torch.zeros((CT, 4, P), dtype=torch.float32, device=dev)
    nch = torch.zeros((CT,), dtype=torch.int64, device=dev)
    px_all, py_all = _tile_pixels(cfg, torch.arange(CT, device=dev) + tile_offset)
    inv_w = _inv_width(cfg)
    slots = torch.arange(G, device=dev)
    for k in range(int(nchunks.max()) if CT else 0):
        # a tile that stopped keeps T below the threshold: it never resumes
        alive = (T.amax(-1) >= cfg.term_thresh) | (cfg.term_thresh <= 0.0)
        active = torch.nonzero((k < nchunks) & alive)[:, 0]
        if active.numel() == 0:
            break
        for sel in torch.split(active, _PLAIN_BATCH):
            chunk = packed[s0[sel, None] + k * G + slots]  # [S, G, NF]
            Ts, accs = T[sel], acc[sel]
            px, py = px_all[sel], py_all[sel]
            tin = torch.ones_like(Ts)
            for g in range(G):
                alpha = _slot_alpha(cfg, chunk[:, g, :, None], px, py, inv_w)[-1]
                w = alpha * tin * Ts
                accs = accs + w[:, None, :] * chunk[:, g, isect_mod.ROW_R:isect_mod.ROW_R + 4, None]
                tin = tin * (1.0 - alpha)
            T[sel] = Ts * tin
            acc[sel] = accs
            nch[sel] = k + 1
    out = torch.zeros((CT, OUT_CH, P), dtype=torch.float32, device=dev)
    out[:, 0:3] = acc[:, 0:3]
    out[:, 3] = 1.0 - T
    out[:, 4] = acc[:, 3]
    out[:, CH_NCHUNKS] = nch[:, None].float()
    return out


def _check_kernel_inputs(name, cfg: RasterCfg, starts, packed, *planes, tile_offset=0):
    """Raise unless the tensors are what the CUDA kernels take; returns
    them contiguous."""
    if packed.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {packed.device}")
    if not 0 <= tile_offset < 2**31 - cfg.ct:
        raise ValueError(f"{name}: tile_offset {tile_offset} outside the int32 grid")
    if (cfg.chunk, cfg.tile_size) != (128, 16):
        raise ValueError(f"{name} kernel is built for chunk=128, tile_size=16; "
                         f"got {(cfg.chunk, cfg.tile_size)}")
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[1] != NF:
        raise ValueError(f"packed must be f32 [rows, {NF}], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if packed.shape[0] < cfg.align_cap:
        raise ValueError(f"packed has {packed.shape[0]} rows < align_cap {cfg.align_cap}")
    if starts.dtype != torch.int32 or starts.shape != (cfg.ct + 1,) \
            or starts.device != packed.device:
        raise ValueError(f"tile starts must be int32 [{cfg.ct + 1}] on {packed.device}, "
                         f"got {starts.dtype} {tuple(starts.shape)} on {starts.device}")
    shape = (cfg.ct, OUT_CH, cfg.npix)
    for t in planes:
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != packed.device:
            raise ValueError(f"{name}: per-tile planes must be f32 {shape} on "
                             f"{packed.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return [t.contiguous() for t in (starts, packed, *planes)]


def tile_fwd(cfg: RasterCfg, starts: torch.Tensor, packed: torch.Tensor,
             tile_offset: int = 0) -> torch.Tensor:
    """Forward compositing -> [CT, OUT_CH, P] f32.

    ``starts`` [CT+1] int32 G-aligned slot ranges, ``packed``
    [align_cap, NF] f32 slot-major field table, ``tile_offset`` the global
    id of the first tile (a slab's). CPU tensors take the plain version;
    CUDA tensors launch the kernel (built from ``csrc/tile_fwd.cu`` at
    first use) or raise."""
    if packed.device.type == "cpu":
        return tile_fwd_plain(cfg, starts, packed, tile_offset)
    starts, packed = _check_kernel_inputs("tile_fwd", cfg, starts, packed,
                                          tile_offset=tile_offset)
    out = torch.empty((cfg.ct, OUT_CH, cfg.npix), dtype=torch.float32,
                      device=packed.device)
    lib = cuda_build.library("tile_fwd")
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tile_fwd(starts.data_ptr(), packed.data_ptr(), out.data_ptr(),
                          cfg.ct, cfg.tw, cfg.tw * cfg.th, int(tile_offset),
                          int(cfg.wrap_x), float(cfg.width), _inv_width(cfg),
                          float(cfg.term_thresh), stream)
    cuda_build.check(lib, rc, "tile_fwd")
    cuda_build.launch_counts["tile_fwd"] += 1
    return out


def tile_bwd_plain(cfg: RasterCfg, starts: torch.Tensor, packed: torch.Tensor,
                   fwd_out: torch.Tensor, gout: torch.Tensor,
                   tile_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: the same chunk replay
    (each tile up to its forward n_chunks), kill and clamp rules as
    ``csrc/tile_bwd.cu`` and the same arithmetic in the same order; each
    slot's sum over the 256 pixels of its tile is taken as the kernel
    takes it (``warp_sum`` over the 32 lanes of each warp, then the 8
    warps added in order)."""
    G, P, CT = cfg.chunk, cfg.npix, cfg.ct
    dev = packed.device
    nr = isect_mod.N_GROWS
    nw = P // _WARP
    pgrad = torch.zeros((cfg.align_cap, NF), dtype=torch.float32, device=dev)
    if CT == 0:
        return pgrad
    s = starts.long()
    s0 = s[:-1]
    nchunks = torch.minimum(torch.div(s[1:] - s0, G, rounding_mode="floor"),
                            fwd_out[:, CH_NCHUNKS, 0].long())
    g4 = gout[:, [0, 1, 2, 4]]  # [CT, 4, P] rgb and depth cotangents
    o4 = fwd_out[:, [0, 1, 2, 4]]
    godot = g4[:, 0] * o4[:, 0]
    for c in range(1, 4):
        godot = godot + g4[:, c] * o4[:, c]
    gat = gout[:, 3] * (1.0 - fwd_out[:, 3])  # gA * T_final
    T = torch.ones((CT, P), dtype=torch.float32, device=dev)
    gP = torch.zeros((CT, P), dtype=torch.float32, device=dev)
    px_all, py_all = _tile_pixels(cfg, torch.arange(CT, device=dev) + tile_offset)
    inv_w = _inv_width(cfg)
    slots = torch.arange(G, device=dev)
    for k in range(int(nchunks.max())):
        active = torch.nonzero(k < nchunks)[:, 0]
        for sel in torch.split(active, _PLAIN_BATCH):
            S = sel.shape[0]
            rows = s0[sel, None] + k * G + slots  # [S, G]
            chunk = packed[rows]
            Ts, g4s, gats = T[sel], g4[sel], gat[sel]
            dconst = godot[sel] - gP[sel]
            px, py = px_all[sel], py_all[sel]
            tin = torch.ones_like(Ts)
            pre = torch.zeros_like(Ts)
            part = chunk.new_zeros((S, G, nw, nr))  # per-warp slot sums
            for g in range(G):
                c = chunk[:, g, :, None]
                dx, dy, ca, cb, cc, expneg, alpha_raw, killed, alpha = _slot_alpha(
                    cfg, c, px, py, inv_w)
                one_m = 1.0 - alpha
                T_i = tin * Ts
                w = alpha * T_i
                cg = c[:, isect_mod.ROW_R] * g4s[:, 0]
                cg = cg + c[:, isect_mod.ROW_G] * g4s[:, 1]
                cg = cg + c[:, isect_mod.ROW_B] * g4s[:, 2]
                cg = cg + c[:, isect_mod.ROW_DEPTH] * g4s[:, 3]
                pre = pre + w * cg
                dalpha = T_i * cg - (dconst - pre) / one_m + gats / one_m
                live = ~(killed | (alpha_raw > ALPHA_MAX))
                zero = torch.zeros_like(dalpha)
                dsigma = torch.where(live, -dalpha * alpha, zero)
                dopac = torch.where(live, dalpha * expneg, zero)
                ddx = dsigma * (ca * dx + cb * dy)
                ddy = dsigma * (cc * dy + cb * dx)
                vals = [ddx, ddy, dsigma * 0.5 * dx * dx, dsigma * dx * dy,
                        dsigma * 0.5 * dy * dy, dopac] + [
                            w * g4s[:, i] for i in range(4)] + [
                            torch.abs(ddx), torch.abs(ddy)]
                # pixel p is lane p % 32 of warp p // 32
                v = torch.stack(vals, dim=-1).reshape(S, nw, _WARP, nr)
                part[:, g] = warp_sum(v)
                tin = tin * one_m
            acc = part[:, :, 0]
            for wi in range(1, nw):
                acc = acc + part[:, :, wi]
            pgrad[rows, :nr] = acc
            T[sel] = Ts * tin
            gP[sel] = gP[sel] + pre
    return pgrad


def tile_bwd(cfg: RasterCfg, starts: torch.Tensor, packed: torch.Tensor,
             fwd_out: torch.Tensor, gout: torch.Tensor, tile_offset: int = 0) -> torch.Tensor:
    """Backward compositing -> per-slot gradient rows [align_cap, NF] f32
    (``GROW_*`` columns; rows of chunks no tile replayed are 0).

    ``fwd_out`` is the forward's output (its n_chunks channel sets how far
    each tile replays), ``gout`` the cotangent of it, ``tile_offset`` as for
    ``tile_fwd``. CPU tensors take the plain version; CUDA tensors launch
    the kernel (built from ``csrc/tile_bwd.cu`` at first use) or raise."""
    if packed.device.type == "cpu":
        return tile_bwd_plain(cfg, starts, packed, fwd_out, gout, tile_offset)
    starts, packed, fwd_out, gout = _check_kernel_inputs(
        "tile_bwd", cfg, starts, packed, fwd_out, gout, tile_offset=tile_offset)
    # the kernel writes every row, the rows of chunks no tile replays as 0
    pgrad = torch.empty((cfg.align_cap, NF), dtype=torch.float32, device=packed.device)
    _launch_tile_bwd(cfg, starts, packed, fwd_out, gout, pgrad, tile_offset)
    return pgrad


def _launch_tile_bwd(cfg: RasterCfg, starts, packed, fwd_out, gout, pgrad, tile_offset=0):
    """One launch of the backward kernel on checked, contiguous CUDA
    tensors into ``pgrad`` [align_cap, NF] (every row written), counted in
    ``cuda_build.launch_counts``; raises if the launch is refused."""
    lib = cuda_build.library("tile_bwd")
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tile_bwd(starts.data_ptr(), packed.data_ptr(), fwd_out.data_ptr(),
                          gout.data_ptr(), pgrad.data_ptr(), cfg.ct, cfg.align_cap,
                          cfg.tw, cfg.tw * cfg.th, int(tile_offset), int(cfg.wrap_x),
                          float(cfg.width), _inv_width(cfg), stream)
    cuda_build.check(lib, rc, "tile_bwd")
    cuda_build.launch_counts["tile_bwd"] += 1


class _TileComposite(torch.autograd.Function):
    """Forward: ``pack_fields`` + ``tile_fwd``. Backward: ``tile_bwd`` +
    ``gather_reduction``. The layout is integer data and gets no gradient,
    as in the JAX custom VJP."""

    @staticmethod
    def forward(ctx, cfg, isect, tile_offset, means2d, conics, colors, opacities,
                depths, abs_dummy):
        with span("build.pack"):
            packed = isect_mod.pack_fields(means2d, conics, colors, opacities,
                                           depths, isect)
        out = tile_fwd(cfg, isect.tile_starts, packed, tile_offset)
        ctx.cfg = cfg
        ctx.tile_offset = tile_offset
        ctx.with_abs = abs_dummy is not None
        ctx.save_for_backward(packed, out, *isect)
        return out

    @staticmethod
    def backward(ctx, gout):
        packed, out, *isect_arrays = ctx.saved_tensors
        isect = IsectData(*isect_arrays)
        cfg = ctx.cfg
        C, N = cfg.num_cameras, cfg.num_gaussians
        pgrads = tile_bwd(cfg, isect.tile_starts, packed, out, gout, ctx.tile_offset)
        seg = isect_mod.gather_reduction(pgrads, isect, C * N)  # [N_GROWS, C*N]

        def cols(*c):
            return seg[list(c)].T.reshape(C, N, len(c))

        dabs = (cols(isect_mod.GROW_ABSDX, isect_mod.GROW_ABSDY)
                if ctx.with_abs else None)
        return (None, None, None,
                cols(isect_mod.GROW_DX, isect_mod.GROW_DY),
                cols(isect_mod.GROW_DCA, isect_mod.GROW_DCB, isect_mod.GROW_DCC),
                cols(isect_mod.GROW_DR, isect_mod.GROW_DG, isect_mod.GROW_DB),
                seg[isect_mod.GROW_DOPAC].reshape(C, N),
                seg[isect_mod.GROW_DDEPTH].reshape(C, N),
                dabs)


def composite_tiles(
    cfg: RasterCfg,
    means2d: torch.Tensor,  # [C, N, 2]
    conics: torch.Tensor,  # [C, N, 3]
    colors: torch.Tensor,  # [C, N, 3]
    opacities: torch.Tensor,  # [C, N]
    depths: torch.Tensor,  # [C, N]
    isect: IsectData,
    abs_dummy: torch.Tensor | None = None,  # [C, N, 2] absgrad hook
    tile_offset: int = 0,  # global id of the slab's first tile
) -> torch.Tensor:
    """Differentiable per-tile compositing -> [CT, OUT_CH, P].

    Gradients flow to means2d, conics, colors, opacities and depths; the
    gradient of ``abs_dummy`` is the per-gaussian sum of |d means2d| over
    pixels. With ``cfg.ct_local`` the isect is a slab's
    (``build_intersections(tile_lo=...)``) and ``tile_offset`` its
    ``tile_lo``."""
    return _TileComposite.apply(cfg, isect, int(tile_offset), means2d, conics, colors,
                                opacities, depths, abs_dummy)


def tiles_to_image(cfg: RasterCfg, tile_out: torch.Tensor):
    """[CT, OUT_CH, P] -> (rgb [C,H,W,3], alpha [C,H,W,1], depth [C,H,W,1])."""
    C, ts, th, tw = cfg.num_cameras, cfg.tile_size, cfg.th, cfg.tw
    x = tile_out.reshape(C, th, tw, OUT_CH, ts, ts)
    x = x.permute(0, 3, 1, 4, 2, 5).reshape(C, OUT_CH, th * ts, tw * ts)
    x = x[:, :, : cfg.height, : cfg.width]
    rgb = x[:, 0:3].permute(0, 2, 3, 1)
    alpha = x[:, 3:4].permute(0, 2, 3, 1)
    depth = x[:, 4:5].permute(0, 2, 3, 1)
    return rgb, alpha, depth
