"""Supertile-stream compositing: forward, backward and their autograd.Function.

Counterpart of ``splat_one_tpu/ops/stream_raster.py``. One
program per (camera, 32x32 px supertile) streams the supertile's
depth-sorted slots in chunks of G = 128 from the G-aligned base
``floor(start / G) * G``, gates each slot per 16 px tile by its
precomputed ellipse extents (``COL_EXT_RX/RY``), and composites front to
back with a running transmittance. A tile stops at chunk granularity once
all its 256 pixels have T < ``StreamCfg.term_thresh`` (default
``TERM_THRESH``; ``<= 0`` never stops); the number of chunks it
processed is recorded for the backward. Output is [CS, 4, 8, 256]: rgb,
alpha = 1 - T, accumulated depth, n_chunks and two zero channels.

The backward replays the same chunks in forward order, each tile up to
its n_chunks, with per-pixel prefix accumulators, and writes one gradient
row per slot (``GCOL_*`` columns of ``ops.stream_isect``) at G-aligned
per-supertile offsets; ``stream_isect.reduce_stream_grads`` reduces them
per gaussian. ``composite_stream`` wraps forward and backward in a
``torch.autograd.Function``.

``stream_fwd`` and ``stream_bwd`` launch the hand-written CUDA kernels
(``csrc/stream_fwd.cu``, ``csrc/stream_bwd.cu``) on CUDA tensors and run
``stream_fwd_plain`` / ``stream_bwd_plain``, their plain PyTorch
versions, on CPU tensors.

Supertile slabs (multi-GPU): with ``StreamCfg.cs_local`` the grid spans
one slab of ``cs_local`` (camera, supertile) cells, and every function
here takes the slab's first global cell as ``tile_offset`` (a host int);
a cell's own index still addresses its slot range, its output and its
gradient rows, while its pixels come from the global id
``t + tile_offset``. ``stream_to_image`` takes the full grid's cfg.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from splat_one_tpu_torch.ops import stream_isect as si
from splat_one_tpu_torch.ops.reference import ALPHA_MAX, ALPHA_MIN
from splat_one_tpu_torch.ops.stream_isect import NF, SS, StreamCaps, StreamIsect
from splat_one_tpu_torch.utils import cuda_build

OUT_CH = 8  # r, g, b, alpha, depth, n_chunks, pad, pad
CH_NCHUNKS = 5
# The default early-stop threshold: a tile stops at the first chunk start
# where all its pixels have T below it.
TERM_THRESH = 1e-5
# Supertiles composited per step of the plain version (bounds its memory).
_PLAIN_BATCH = 512


@dataclasses.dataclass(frozen=True)
class StreamCfg:
    """Stream-compositor configuration."""

    width: int
    height: int
    tile_size: int
    num_cameras: int
    num_gaussians: int
    chunk: int
    exp_cap: int
    n_supertiles: int  # per camera (sw * sh)
    wrap_x: bool = False
    term_thresh: float = TERM_THRESH  # <= 0: no tile stops early
    absgrad: bool = False  # reduce the ABSDX/ABSDY gradient columns
    ss: int = SS  # tiles per supertile side
    # cells of one supertile slab (multi-GPU); 0: the whole grid
    cs_local: int = 0

    @property
    def nt(self):
        return self.ss * self.ss

    @property
    def tw(self):
        return -(-self.width // self.tile_size)

    @property
    def th(self):
        return -(-self.height // self.tile_size)

    @property
    def sw(self):
        return -(-self.tw // self.ss)

    @property
    def sh(self):
        return -(-self.th // self.ss)

    @property
    def cs(self):
        return self.cs_local or self.num_cameras * self.sw * self.sh

    @property
    def npix(self):
        return self.tile_size * self.tile_size

    @property
    def packed_rows(self):
        return self.exp_cap + self.chunk

    @property
    def pad_cap(self):
        """Rows of the backward's gradient buffer (``StreamCaps.pad_cap``)."""
        raw = self.exp_cap + 2 * self.cs * self.chunk
        return -(-raw // 1024) * 1024

    @staticmethod
    def from_caps(caps: StreamCaps, width, height, tile_size, num_cameras,
                  num_gaussians, wrap_x=False, term_thresh=TERM_THRESH, absgrad=False):
        return StreamCfg(
            width=width, height=height, tile_size=tile_size,
            num_cameras=num_cameras, num_gaussians=num_gaussians,
            chunk=caps.chunk, exp_cap=caps.exp_cap,
            n_supertiles=caps.n_supertiles // num_cameras,
            wrap_x=wrap_x, term_thresh=term_thresh, absgrad=absgrad, ss=caps.ss,
        )

    @property
    def caps(self) -> StreamCaps:
        return StreamCaps(exp_cap=self.exp_cap,
                          n_supertiles=self.num_cameras * self.n_supertiles,
                          chunk=self.chunk, ss=self.ss)


def _inv_width(cfg: StreamCfg) -> float:
    """1/width rounded to f32 once, as the JAX kernel's weak-typed constant."""
    return float(np.float32(1.0 / cfg.width))


def _tile_geometry(cfg: StreamCfg, cs_idx: torch.Tensor):
    """Pixel centres [S, NT, P] and tile coords [S, NT] (f32) of supertiles
    ``cs_idx``; the camera is implicit (``cs_idx % (sw * sh)``)."""
    ts, ss = cfg.tile_size, cfg.ss
    dev = cs_idx.device
    st = cs_idx % (cfg.sw * cfg.sh)
    sy = torch.div(st, cfg.sw, rounding_mode="floor")
    sx = st % cfg.sw
    j = torch.arange(cfg.nt, device=dev)
    ty = sy[:, None] * ss + torch.div(j, ss, rounding_mode="floor")
    tx = sx[:, None] * ss + j % ss
    local = torch.arange(cfg.npix, device=dev)
    px = (tx[..., None] * ts + local % ts).float() + 0.5
    py = (ty[..., None] * ts + torch.div(local, ts, rounding_mode="floor")).float() + 0.5
    return px, py, tx.float(), ty.float()


def _chunk_gate(cfg: StreamCfg, chunk, tx, ty, rowmask):
    """Per-(tile, slot) membership [S, NT, G]: the slot belongs to the
    supertile's range (``rowmask`` [S, G]) and its opacity-aware ellipse
    bbox (``COL_EXT_RX/RY``) covers the tile (``tx``/``ty`` [S, NT])."""
    ts = float(cfg.tile_size)
    x = chunk[:, None, :, si.COL_X]
    y = chunk[:, None, :, si.COL_Y]
    rx = chunk[:, None, :, si.COL_EXT_RX]
    ry = chunk[:, None, :, si.COL_EXT_RY]
    txf, tyf = tx[..., None], ty[..., None]
    in_y = (tyf >= torch.floor((y - ry) / ts)) & (tyf < torch.ceil((y + ry) / ts))
    if cfg.wrap_x:
        tw = float(cfg.tw)
        tx0 = torch.floor((x - rx) / ts)
        span = torch.clamp(torch.ceil((x + rx) / ts) - tx0, max=tw)
        in_x = torch.remainder(txf - tx0, tw) < span
    else:
        in_x = (txf >= torch.floor((x - rx) / ts)) & (txf < torch.ceil((x + rx) / ts))
    return rowmask[:, None, :] & in_x & in_y


def stream_fwd_plain(cfg: StreamCfg, st_starts: torch.Tensor,
                     packed: torch.Tensor, tile_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the forward compositing kernel.

    Same chunking, gating, kill rules, termination and n_chunks bookkeeping
    as ``csrc/stream_fwd.cu``, and the same per-slot arithmetic in the same
    order (a serial loop over the G slots of a chunk), vectorised over
    supertiles, tiles and pixels."""
    G, NT, P = cfg.chunk, cfg.nt, cfg.npix
    CS = cfg.cs
    dev = packed.device
    starts = st_starts.long()
    s0, s1 = starts[:-1], starts[1:]
    base0 = torch.div(s0, G, rounding_mode="floor") * G
    nchunks = -torch.div(-(s1 - base0), G, rounding_mode="floor")
    T = torch.ones((CS, NT, P), dtype=torch.float32, device=dev)
    acc = torch.zeros((CS, NT, 4, P), dtype=torch.float32, device=dev)
    nch = torch.zeros((CS, NT), dtype=torch.int64, device=dev)
    px_all, py_all, tx_all, ty_all = _tile_geometry(
        cfg, torch.arange(CS, device=dev) + tile_offset)
    inv_w = _inv_width(cfg)
    slots = torch.arange(G, device=dev)
    kmax = int(nchunks.max()) if CS else 0
    for k in range(kmax):
        alive = (T.amax(-1) >= cfg.term_thresh) | (cfg.term_thresh <= 0.0)
        active = torch.nonzero((k < nchunks) & alive.any(-1))[:, 0]
        if active.numel() == 0:
            break  # T only falls and nchunks only shrinks: nothing resumes
        for sel in torch.split(active, _PLAIN_BATCH):
            rows = base0[sel, None] + k * G + slots
            chunk = packed[rows]  # [S, G, NF]
            rowmask = (rows >= s0[sel, None]) & (rows < s1[sel, None])
            gate = _chunk_gate(cfg, chunk, tx_all[sel], ty_all[sel], rowmask)
            proc = alive[sel] & gate.any(-1)  # [S, NT]
            Ts, accs = T[sel], acc[sel].clone()
            px, py = px_all[sel], py_all[sel]
            tin = torch.ones_like(Ts)
            for g in range(G):
                c = chunk[:, g, :, None, None]  # [S, NF, 1, 1]
                dx = c[:, si.COL_X] - px
                if cfg.wrap_x:
                    dx = dx - cfg.width * torch.round(dx * inv_w)
                dy = c[:, si.COL_Y] - py
                sigma = (0.5 * (c[:, si.COL_CA] * dx * dx + c[:, si.COL_CC] * dy * dy)
                         + c[:, si.COL_CB] * dx * dy)
                alpha_raw = c[:, si.COL_OPAC] * torch.exp(-sigma)
                killed = ((sigma < 0.0) | (alpha_raw < ALPHA_MIN)
                          | ~gate[:, :, g, None])
                alpha = torch.where(killed, torch.zeros_like(alpha_raw),
                                    torch.clamp(alpha_raw, max=ALPHA_MAX))
                w = alpha * tin * Ts
                accs = accs + w[:, :, None, :] * chunk[:, g, None, si.COL_R:si.COL_R + 4, None]
                tin = tin * (1.0 - alpha)
            T[sel] = torch.where(proc[..., None], Ts * tin, Ts)
            acc[sel] = torch.where(proc[..., None, None], accs, acc[sel])
            nch[sel] = torch.where(proc, torch.full_like(nch[sel], k + 1), nch[sel])
    out = torch.zeros((CS, NT, OUT_CH, P), dtype=torch.float32, device=dev)
    out[:, :, 0:3] = acc[:, :, 0:3]
    out[:, :, 3] = 1.0 - T
    out[:, :, 4] = acc[:, :, 3]
    out[:, :, CH_NCHUNKS] = nch[..., None].float()
    return out


def _check_kernel_inputs(name, cfg: StreamCfg, st_starts, packed, *starts_al,
                         tile_offset=0):
    """Raise unless the tensors are what the CUDA kernels take; returns
    them contiguous."""
    if packed.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {packed.device}")
    if not 0 <= tile_offset < 2**31 - cfg.cs:
        raise ValueError(f"{name}: tile_offset {tile_offset} outside the int32 grid")
    if (cfg.chunk, cfg.tile_size, cfg.ss) != (128, 16, 2):
        raise ValueError(
            f"{name} kernel is built for chunk=128, tile_size=16, ss=2; "
            f"got {(cfg.chunk, cfg.tile_size, cfg.ss)}")
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[1] != NF:
        raise ValueError(f"packed must be f32 [rows, {NF}], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if packed.shape[0] < cfg.packed_rows:
        raise ValueError(f"packed has {packed.shape[0]} rows < {cfg.packed_rows}")
    for t in (st_starts, *starts_al):
        if t.dtype != torch.int32 or t.shape != (cfg.cs + 1,):
            raise ValueError(f"slot starts must be int32 [{cfg.cs + 1}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != packed.device:
            raise ValueError("slot starts and packed must be on one device")
    return [t.contiguous() for t in (st_starts, packed, *starts_al)]


def stream_fwd(cfg: StreamCfg, st_starts: torch.Tensor,
               packed: torch.Tensor, tile_offset: int = 0) -> torch.Tensor:
    """Forward compositing -> [CS, NT, OUT_CH, P] f32.

    ``st_starts`` [CS+1] int32 slot ranges, ``packed`` [exp_cap + G, NF]
    f32 slot-major field table, ``tile_offset`` the global id of the
    first cell (a slab's). CPU tensors take the plain version; CUDA
    tensors launch the kernel (built from ``csrc/stream_fwd.cu`` at first
    use) or raise."""
    if packed.device.type == "cpu":
        return stream_fwd_plain(cfg, st_starts, packed, tile_offset)
    st_starts, packed = _check_kernel_inputs("stream_fwd", cfg, st_starts, packed,
                                             tile_offset=tile_offset)
    out = torch.empty((cfg.cs, cfg.nt, OUT_CH, cfg.npix), dtype=torch.float32,
                      device=packed.device)
    lib = cuda_build.library("stream_fwd")
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stream_fwd(
            st_starts.data_ptr(), packed.data_ptr(), out.data_ptr(),
            cfg.cs, cfg.sw, cfg.sh, cfg.tw, int(tile_offset), int(cfg.wrap_x),
            float(cfg.width), _inv_width(cfg), float(cfg.term_thresh), stream)
    cuda_build.check(lib, rc, "stream_fwd")
    cuda_build.launch_counts["stream_fwd"] += 1
    return out


_CH4 = [0, 1, 2, 4]  # rgb and depth channels of fwd_out / gout
_WARP = 32


def warp_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the lane axis (-2, 32 lanes of a warp) in the backward
    kernels' order: lane l + 16 onto lane l first, then + 8, 4, 2, 1 (the
    pairings of a full xor butterfly; the kernels take it as a
    reduce-scatter, ``csrc/bwd_common.cuh``). [..., 32, nr] -> [..., nr]."""
    half = v.shape[-2] // 2
    while half:
        v = v[..., :half, :] + v[..., half:2 * half, :]
        half //= 2
    return v[..., 0, :]


def stream_bwd_plain(cfg: StreamCfg, st_starts: torch.Tensor,
                     st_starts_al: torch.Tensor, packed: torch.Tensor,
                     fwd_out: torch.Tensor, gout: torch.Tensor,
                     tile_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the backward compositing kernel.

    Same chunk replay (each tile up to its forward n_chunks), gating, kill
    and clamp rules as ``csrc/stream_bwd.cu``, and the same arithmetic in
    the same order: a serial loop over the G slots of a chunk, vectorised
    over supertiles, tiles and pixels; each slot's sum over the 1,024
    pixels of its supertile taken as the kernel takes it (``warp_sum`` over
    the 32 lanes of each warp, then the 32 warps added in order)."""
    G, NT, P, CS = cfg.chunk, cfg.nt, cfg.npix, cfg.cs
    dev = packed.device
    nr = si.N_GCOLS if cfg.absgrad else si.GCOL_ABSDX
    pgrad = torch.zeros((cfg.pad_cap, NF), dtype=torch.float32, device=dev)
    if CS == 0:
        return pgrad
    starts = st_starts.long()
    s0, s1 = starts[:-1], starts[1:]
    base0 = torch.div(s0, G, rounding_mode="floor") * G
    a0 = st_starts_al[:-1].long()
    nch = fwd_out[:, :, CH_NCHUNKS, 0].long()  # [CS, NT]
    nchunks = torch.minimum(-torch.div(-(s1 - base0), G, rounding_mode="floor"),
                            nch.amax(-1))
    g4 = gout[:, :, _CH4]  # [CS, NT, 4, P]
    o4 = fwd_out[:, :, _CH4]
    godot = g4[:, :, 0] * o4[:, :, 0]
    for c in range(1, 4):
        godot = godot + g4[:, :, c] * o4[:, :, c]
    gat = gout[:, :, 3] * (1.0 - fwd_out[:, :, 3])  # gA * T_final
    T = torch.ones((CS, NT, P), dtype=torch.float32, device=dev)
    gP = torch.zeros((CS, NT, P), dtype=torch.float32, device=dev)
    px_all, py_all, tx_all, ty_all = _tile_geometry(
        cfg, torch.arange(CS, device=dev) + tile_offset)
    inv_w = _inv_width(cfg)
    slots = torch.arange(G, device=dev)
    for k in range(int(nchunks.max())):
        active = torch.nonzero(k < nchunks)[:, 0]
        for sel in torch.split(active, _PLAIN_BATCH):
            S = sel.shape[0]
            rows = base0[sel, None] + k * G + slots
            chunk = packed[rows]  # [S, G, NF]
            rowmask = (rows >= s0[sel, None]) & (rows < s1[sel, None])
            gate = (_chunk_gate(cfg, chunk, tx_all[sel], ty_all[sel], rowmask)
                    & (k < nch[sel])[..., None])
            Ts, g4s = T[sel], g4[sel]
            dconst = godot[sel] - gP[sel]
            gats = gat[sel]
            px, py = px_all[sel], py_all[sel]
            tin = torch.ones_like(Ts)
            pre = torch.zeros_like(Ts)
            part = chunk.new_zeros((S, G, _WARP, nr))  # per-warp slot sums
            for g in range(G):
                c = chunk[:, g, :, None, None]  # [S, NF, 1, 1]
                dx = c[:, si.COL_X] - px
                if cfg.wrap_x:
                    dx = dx - cfg.width * torch.round(dx * inv_w)
                dy = c[:, si.COL_Y] - py
                ca, cb, cc = c[:, si.COL_CA], c[:, si.COL_CB], c[:, si.COL_CC]
                sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
                expneg = torch.exp(-sigma)
                alpha_raw = c[:, si.COL_OPAC] * expneg
                killed = ((sigma < 0.0) | (alpha_raw < ALPHA_MIN)
                          | ~gate[:, :, g, None])
                alpha = torch.where(killed, torch.zeros_like(alpha_raw),
                                    torch.clamp(alpha_raw, max=ALPHA_MAX))
                one_m = 1.0 - alpha
                T_i = tin * Ts
                w = alpha * T_i
                cg = c[:, si.COL_R] * g4s[:, :, 0]
                cg = cg + c[:, si.COL_G] * g4s[:, :, 1]
                cg = cg + c[:, si.COL_B] * g4s[:, :, 2]
                cg = cg + c[:, si.COL_DEPTH] * g4s[:, :, 3]
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
                            w * g4s[:, :, i] for i in range(4)]
                if cfg.absgrad:
                    vals += [torch.abs(ddx), torch.abs(ddy)]
                # thread j * P + p is lane (j * P + p) % 32 of warp // 32
                v = torch.stack(vals, dim=-1).reshape(S, NT * P // _WARP, _WARP, nr)
                part[:, g] = warp_sum(v)
                tin = tin * one_m
            acc = part[:, :, 0]
            for wi in range(1, NT * P // _WARP):
                acc = acc + part[:, :, wi]
            out_rows = a0[sel, None] + k * G + slots  # [S, G]
            pgrad[out_rows, :nr] = acc
            pgrad[out_rows, si.GCOL_KEY] = torch.where(
                rowmask, chunk[:, :, si.COL_GID] + 1.0,
                torch.zeros_like(chunk[:, :, si.COL_GID]))
            T[sel] = Ts * tin
            gP[sel] = gP[sel] + pre
    return pgrad


def stream_bwd(cfg: StreamCfg, st_starts: torch.Tensor,
               st_starts_al: torch.Tensor, packed: torch.Tensor,
               fwd_out: torch.Tensor, gout: torch.Tensor,
               tile_offset: int = 0) -> torch.Tensor:
    """Backward compositing -> per-slot gradient rows [pad_cap, NF] f32
    (``GCOL_*`` columns; the key column holds gid + 1 on each supertile's
    own slots and rows never reached stay 0).

    ``fwd_out`` is the forward's output (its n_chunks channel sets how
    far each tile replays), ``gout`` the cotangent of it, ``tile_offset``
    as for ``stream_fwd``. CPU tensors take the plain version; CUDA
    tensors launch the kernel (built from ``csrc/stream_bwd.cu`` at first
    use) or raise."""
    if packed.device.type == "cpu":
        return stream_bwd_plain(cfg, st_starts, st_starts_al, packed, fwd_out, gout,
                                tile_offset)
    st_starts, packed, st_starts_al = _check_kernel_inputs(
        "stream_bwd", cfg, st_starts, packed, st_starts_al, tile_offset=tile_offset)
    shape = (cfg.cs, cfg.nt, OUT_CH, cfg.npix)
    for name, t in (("fwd_out", fwd_out), ("gout", gout)):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != packed.device:
            raise ValueError(f"{name} must be f32 {shape} on {packed.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    fwd_out = fwd_out.contiguous()
    gout = gout.contiguous()
    # rows of chunks no tile reaches must read 0 (the reduce skips key 0)
    pgrad = torch.zeros((cfg.pad_cap, NF), dtype=torch.float32, device=packed.device)
    lib = cuda_build.library("stream_bwd")
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stream_bwd(
            st_starts.data_ptr(), st_starts_al.data_ptr(), packed.data_ptr(),
            fwd_out.data_ptr(), gout.data_ptr(), pgrad.data_ptr(),
            cfg.cs, cfg.sw, cfg.sh, cfg.tw, int(tile_offset), int(cfg.wrap_x),
            float(cfg.width), _inv_width(cfg), int(cfg.absgrad), stream)
    cuda_build.check(lib, rc, "stream_bwd")
    cuda_build.launch_counts["stream_bwd"] += 1
    return pgrad


class _StreamComposite(torch.autograd.Function):
    """Forward: field table + ``stream_fwd``. Backward: ``stream_bwd`` +
    ``reduce_stream_grads``. The field table is built inside ``forward``
    (no autograd graph), so the radii and the membership extents
    (``COL_EXT_RX/RY``) get no gradient, as in the JAX custom VJP."""

    @staticmethod
    def forward(ctx, cfg, isect, tile_offset, means2d, conics, colors, opacities,
                depths, radii, abs_dummy):
        if cfg.absgrad != (abs_dummy is not None):
            raise ValueError("cfg.absgrad must be set exactly when abs_dummy is passed")
        fields = si.build_field_columns(means2d, conics, opacities, colors,
                                        depths, radii)
        packed = si.pack_stream(fields, isect, cfg.caps)
        out = stream_fwd(cfg, isect.st_starts, packed, tile_offset)
        ctx.cfg = cfg
        ctx.tile_offset = tile_offset
        ctx.save_for_backward(packed, isect.st_starts, isect.st_starts_al, out)
        return out

    @staticmethod
    def backward(ctx, gout):
        packed, st_starts, st_starts_al, out = ctx.saved_tensors
        cfg = ctx.cfg
        C, N = cfg.num_cameras, cfg.num_gaussians
        pgrads = stream_bwd(cfg, st_starts, st_starts_al, packed, out, gout,
                            ctx.tile_offset)
        n_payload = si.N_GCOLS if cfg.absgrad else si.GCOL_ABSDX
        seg = si.reduce_stream_grads(pgrads, C * N, n_payload)

        def cols(*c):
            return seg[list(c)].T.reshape(C, N, len(c))

        dabs = cols(si.GCOL_ABSDX, si.GCOL_ABSDY) if cfg.absgrad else None
        return (None, None, None,
                cols(si.GCOL_DX, si.GCOL_DY),
                cols(si.GCOL_DCA, si.GCOL_DCB, si.GCOL_DCC),
                cols(si.GCOL_DR, si.GCOL_DG, si.GCOL_DB),
                seg[si.GCOL_DOPAC].reshape(C, N),
                seg[si.GCOL_DDEPTH].reshape(C, N),
                None, dabs)


def composite_stream(
    cfg: StreamCfg,
    means2d: torch.Tensor,  # [C, N, 2]
    conics: torch.Tensor,  # [C, N, 3]
    colors: torch.Tensor,  # [C, N, 3]
    opacities: torch.Tensor,  # [C, N]
    depths: torch.Tensor,  # [C, N]
    radii: torch.Tensor,  # [C, N] (tile-bbox metadata, no gradient)
    isect: StreamIsect,
    abs_dummy: torch.Tensor | None = None,  # [C, N, 2] absgrad hook
    tile_offset: int = 0,  # global id of the slab's first cell
) -> torch.Tensor:
    """Differentiable supertile compositing -> [CS, NT, OUT_CH, P].

    Gradients flow to means2d, conics, colors, opacities and depths; the
    cotangent of ``abs_dummy`` is the per-gaussian sum of |d means2d| over
    pixels; pass it exactly when ``cfg.absgrad``. With ``cfg.cs_local``
    the isect is a slab's (``build_stream_intersections(st_lo=...)``) and
    ``tile_offset`` its ``st_lo``."""
    return _StreamComposite.apply(cfg, isect, int(tile_offset), means2d, conics, colors,
                                  opacities, depths, radii.detach(), abs_dummy)


def stream_to_image(cfg: StreamCfg, out: torch.Tensor):
    """[CS, NT, OUT_CH, P] -> (rgb [C,H,W,3], alpha, depth [C,H,W,1])."""
    C, ts, ss = cfg.num_cameras, cfg.tile_size, cfg.ss
    sh, sw = cfg.sh, cfg.sw
    x = out.reshape(C, sh, sw, ss, ss, OUT_CH, ts, ts)
    x = x.permute(0, 5, 1, 3, 6, 2, 4, 7).reshape(C, OUT_CH, sh * ss * ts, sw * ss * ts)
    x = x[:, :, : cfg.height, : cfg.width]
    rgb = x[:, 0:3].permute(0, 2, 3, 1)
    alpha = x[:, 3:4].permute(0, 2, 3, 1)
    depth = x[:, 4:5].permute(0, 2, 3, 1)
    return rgb, alpha, depth
