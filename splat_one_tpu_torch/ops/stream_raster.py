"""Supertile-stream compositing, forward half.

Counterpart of ``splat_one_tpu/ops/stream_raster.py`` (forward). One
program per (camera, 32x32 px supertile) streams the supertile's
depth-sorted slots in chunks of G = 128 from the G-aligned base
``floor(start / G) * G``, gates each slot per 16 px tile by its
precomputed ellipse extents (``COL_EXT_RX/RY``), and composites front to
back with a running transmittance. A tile stops at chunk granularity once
all its 256 pixels have T < ``TERM_THRESH``; the number of chunks it
processed is recorded for the backward. Output is [CS, 4, 8, 256]: rgb,
alpha = 1 - T, accumulated depth, n_chunks and two zero channels.

``stream_fwd`` launches the hand-written CUDA kernel
(``csrc/stream_fwd.cu``) on CUDA tensors and runs ``stream_fwd_plain``,
its plain PyTorch version, on CPU tensors.
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
# A tile stops at the first chunk start where all its pixels have T below this.
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
    ss: int = SS  # tiles per supertile side

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
        return self.num_cameras * self.sw * self.sh

    @property
    def npix(self):
        return self.tile_size * self.tile_size

    @property
    def packed_rows(self):
        return self.exp_cap + self.chunk

    @staticmethod
    def from_caps(caps: StreamCaps, width, height, tile_size, num_cameras,
                  num_gaussians, wrap_x=False):
        return StreamCfg(
            width=width, height=height, tile_size=tile_size,
            num_cameras=num_cameras, num_gaussians=num_gaussians,
            chunk=caps.chunk, exp_cap=caps.exp_cap,
            n_supertiles=caps.n_supertiles // num_cameras,
            wrap_x=wrap_x, ss=caps.ss,
        )


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
                     packed: torch.Tensor) -> torch.Tensor:
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
        cfg, torch.arange(CS, device=dev))
    inv_w = _inv_width(cfg)
    slots = torch.arange(G, device=dev)
    kmax = int(nchunks.max()) if CS else 0
    for k in range(kmax):
        alive = T.amax(-1) >= TERM_THRESH
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


def stream_fwd(cfg: StreamCfg, st_starts: torch.Tensor,
               packed: torch.Tensor) -> torch.Tensor:
    """Forward compositing -> [CS, NT, OUT_CH, P] f32.

    ``st_starts`` [CS+1] int32 slot ranges, ``packed`` [exp_cap + G, NF]
    f32 slot-major field table. CPU tensors take the plain version; CUDA
    tensors launch the kernel (built from ``csrc/stream_fwd.cu`` at first
    use) or raise."""
    if packed.device.type == "cpu":
        return stream_fwd_plain(cfg, st_starts, packed)
    if packed.device.type != "cuda":
        raise ValueError(f"stream_fwd: unsupported device {packed.device}")
    if (cfg.chunk, cfg.tile_size, cfg.ss) != (128, 16, 2):
        raise ValueError(
            "stream_fwd kernel is built for chunk=128, tile_size=16, ss=2; "
            f"got {(cfg.chunk, cfg.tile_size, cfg.ss)}")
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[1] != NF:
        raise ValueError(f"packed must be f32 [rows, {NF}], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if packed.shape[0] < cfg.packed_rows:
        raise ValueError(f"packed has {packed.shape[0]} rows < {cfg.packed_rows}")
    if st_starts.dtype != torch.int32 or st_starts.shape != (cfg.cs + 1,):
        raise ValueError(f"st_starts must be int32 [{cfg.cs + 1}], got "
                         f"{st_starts.dtype} {tuple(st_starts.shape)}")
    if st_starts.device != packed.device:
        raise ValueError("st_starts and packed must be on one device")
    packed = packed.contiguous()
    st_starts = st_starts.contiguous()
    out = torch.empty((cfg.cs, cfg.nt, OUT_CH, cfg.npix), dtype=torch.float32,
                      device=packed.device)
    lib = cuda_build.library("stream_fwd")
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stream_fwd(
            st_starts.data_ptr(), packed.data_ptr(), out.data_ptr(),
            cfg.cs, cfg.sw, cfg.sh, cfg.tw, int(cfg.wrap_x),
            float(cfg.width), _inv_width(cfg), stream)
    cuda_build.check(lib, rc, "stream_fwd")
    cuda_build.launch_counts["stream_fwd"] += 1
    return out


def composite_stream(
    cfg: StreamCfg,
    means2d: torch.Tensor,  # [C, N, 2]
    conics: torch.Tensor,  # [C, N, 3]
    colors: torch.Tensor,  # [C, N, 3]
    opacities: torch.Tensor,  # [C, N]
    depths: torch.Tensor,  # [C, N]
    radii: torch.Tensor,  # [C, N]
    isect: StreamIsect,
) -> torch.Tensor:
    """Supertile compositing (forward) -> [CS, NT, OUT_CH, P]."""
    caps = StreamCaps(exp_cap=cfg.exp_cap,
                      n_supertiles=cfg.num_cameras * cfg.n_supertiles,
                      chunk=cfg.chunk, ss=cfg.ss)
    fields = si.build_field_columns(means2d, conics, opacities, colors,
                                    depths, radii)
    packed = si.pack_stream(fields, isect, caps)
    return stream_fwd(cfg, isect.st_starts, packed)


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
