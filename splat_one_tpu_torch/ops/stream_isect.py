"""Supertile-stream intersection builder and the backward's row reduction.

Counterpart of ``splat_one_tpu/ops/stream_isect.py``. Gaussians are binned
into 32x32 px supertiles (2x2 tiles of 16 px); the compositing kernels
stream each supertile's depth-sorted slot range once and gate every
slot per 16 px tile. Pipeline:
  1. per-(camera, gaussian) supertile bbox spans -> counts -> offsets,
  2. expansion to slots and each slot's (supertile id, depth) sort key
     (ops.seg_broadcast: the default path, or the kernel under
     ``SPLAT_SEG_BROADCAST``),
  3. one stable sort by (supertile, depth), ties in expansion order,
  4. searchsorted for per-supertile slot ranges.
Spherical cameras wrap in azimuth: unwrapped spans, ``mod sw`` at
expansion. Slots are indexed with integers, so the JAX package's f32-id
limit (C*N < 2^24) does not apply to the forward; the f32 ``COL_GID``
column keeps that limit for the backward, whose per-slot gradient rows
(``GCOL_*``) ``reduce_stream_grads`` orders by that key and reduces per
gaussian in place (``ops.seg_reduce``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from splat_one_tpu_torch.ops import seg_reduce
from splat_one_tpu_torch.ops.projection import Projected, conic_ellipse_radii
from splat_one_tpu_torch.ops.seg_broadcast import (SLAB, SlotGrid, expand_slots,
                                                   required_slab)

# Supertile = SS x SS tiles of `tile_size` pixels.
SS = 2

# Column layout of the packed [rows, NF] field table (one 64-byte row per slot).
COL_X = 0
COL_Y = 1
COL_CA = 2
COL_CB = 3
COL_CC = 4
COL_OPAC = 5
COL_R = 6
COL_G = 7
COL_B = 8
COL_DEPTH = 9
COL_RADIUS = 10  # 3-sigma screen radius (metadata; membership is COL_EXT_*)
COL_GID = 11  # flat [C*N) gaussian id as f32 (the backward's reduce key)
# Per-axis opacity-aware membership-ellipse extents (conic_ellipse_radii),
# computed once per gaussian so the kernel's per-tile gate is compares.
COL_EXT_RX = 12
COL_EXT_RY = 13
NF = 16  # padded power-of-two width

# Column layout of the backward's [pad_cap, NF] per-slot gradient rows.
GCOL_DX = 0
GCOL_DY = 1
GCOL_DCA = 2
GCOL_DCB = 3
GCOL_DCC = 4
GCOL_DOPAC = 5
GCOL_DR = 6
GCOL_DG = 7
GCOL_DB = 8
GCOL_DDEPTH = 9
GCOL_ABSDX = 10  # |d means2d| sums (absgrad), reduced only when asked for
GCOL_ABSDY = 11
GCOL_KEY = 12  # gid + 1 (f32) on the supertile's own slots, 0 elsewhere
N_GCOLS = 12  # payload columns


@dataclasses.dataclass(frozen=True)
class StreamCaps:
    """Slot capacities of the stream layout. Slots beyond ``exp_cap`` are
    dropped and flagged by ``overflow``."""

    exp_cap: int  # max total (gaussian, supertile) intersections
    n_supertiles: int  # C * SH * SW
    chunk: int = 128  # kernel chunk G
    ss: int = SS  # tiles per supertile side
    # parent-window width of the seg_broadcast kernel path (its per-chunk
    # search work scales with it); sized from a warm-up build by
    # ``observed_sb_slab``, as exp_cap by ``choose_observed``
    sb_slab: int = SLAB

    @property
    def pad_cap(self) -> int:
        """Rows of the backward's aligned per-slot gradient buffer: each
        supertile's rows start at a G-aligned base, up to 2G-1 rows more
        than its count, rounded to 1024."""
        raw = self.exp_cap + 2 * self.n_supertiles * self.chunk
        return -(-raw // 1024) * 1024

    @property
    def packed_rows(self) -> int:
        """Rows of the packed field table (+G over-read pad for the last
        partial chunk of the last supertile)."""
        return self.exp_cap + self.chunk

    @staticmethod
    def choose(num_gaussians: int, num_cameras: int, n_supertiles: int,
               chunk: int = 128, avg_supertiles_per_gaussian: float = 3.0,
               ss: int = SS):
        exp_cap = int(num_cameras * num_gaussians * avg_supertiles_per_gaussian)
        exp_cap = max(exp_cap, 1024)
        exp_cap = -(-exp_cap // chunk) * chunk
        return StreamCaps(exp_cap=exp_cap, n_supertiles=n_supertiles,
                          chunk=chunk, ss=ss)

    @staticmethod
    def choose_observed(n_isect: int, n_supertiles: int, chunk: int = 128,
                        slack: float = 1.08, ss: int = SS, sb_slab: int = SLAB):
        """Caps sized from a measured intersection count (a warm-up build
        with generous caps, or the previous render's ``info["n_isect"]``)
        and, optionally, a measured ``observed_sb_slab``."""
        exp_cap = max(int(n_isect * slack), 1024)
        exp_cap = -(-exp_cap // chunk) * chunk
        return StreamCaps(exp_cap=exp_cap, n_supertiles=n_supertiles,
                          chunk=chunk, ss=ss, sb_slab=sb_slab)


class StreamIsect(NamedTuple):
    """Sorted supertile-stream layout.

    ``sorted_g[p]``: flat ``[C * N]`` gaussian index of stream slot p
    (sentinel ``C * N`` for dropped/padding slots). ``st_starts``: slot
    range per (camera, supertile), length ``C*NS + 1``. ``st_starts_al``:
    G-aligned start of each supertile's rows in the backward's gradient
    buffer."""

    sorted_g: torch.Tensor  # [exp_cap] int32
    st_starts: torch.Tensor  # [C*NS + 1] int32
    st_starts_al: torch.Tensor  # [C*NS + 1] int32
    n_isect: torch.Tensor  # [] int64
    n_slots: torch.Tensor  # [] int64 (== clamped n_isect)
    overflow: torch.Tensor  # [] bool


def supertile_grid(width: int, height: int, tile_size: int, ss: int = SS):
    tw = -(-width // tile_size)
    th = -(-height // tile_size)
    sw = -(-tw // ss)
    sh = -(-th // ss)
    return tw, th, sw, sh


def build_field_columns(means2d, conics, opacities, colors, depths,
                        radii) -> torch.Tensor:
    """[M0, NF] packed field table from [C, N, ...] tensors: the one
    definition of the COL_* layout the kernel indexes."""
    C, N = opacities.shape
    M0 = C * N
    con = conics.reshape(M0, 3)
    ext_rx, ext_ry = conic_ellipse_radii(
        con[:, 0], con[:, 1], con[:, 2], opacities.reshape(M0))
    cols = torch.cat(
        [
            means2d.reshape(M0, 2),
            con,
            opacities.reshape(M0, 1),
            colors.reshape(M0, 3),
            depths.reshape(M0, 1),
            radii.reshape(M0, 1),
            torch.arange(M0, dtype=torch.float32, device=con.device).reshape(M0, 1),
            ext_rx.reshape(M0, 1),
            ext_ry.reshape(M0, 1),
        ],
        dim=1,
    )
    return torch.nn.functional.pad(cols, (0, NF - cols.shape[1]))


def build_fields(proj: Projected) -> torch.Tensor:
    """[M0, NF] packed per-(camera, gaussian) field table."""
    return build_field_columns(
        proj.means2d, proj.conics, proj.opacities, proj.colors,
        proj.depths, proj.radii,
    )


def pack_stream(fields: torch.Tensor, isect: StreamIsect,
                caps: StreamCaps) -> torch.Tensor:
    """[packed_rows, NF] slot-major stream table: one row gather by
    ``sorted_g`` (sentinel rows -> zeros), then G zero rows so a chunk that
    starts inside the last supertile never reads past the end."""
    fp = torch.cat([fields, fields.new_zeros((1, NF))], dim=0)
    packed = fp[torch.clamp(isect.sorted_g.long(), max=fields.shape[0])]
    return torch.cat([packed, packed.new_zeros((caps.chunk, NF))], dim=0)


def parent_spans(proj: Projected, width: int, height: int, tile_size: int,
                 ss: int, camera_model: str = "pinhole"):
    """Per-(camera, gaussian) supertile bbox spans in [C, N] order:
    ``(sx0, span_x, sy0, span_y)`` (int64, flat [C*N]). Membership is the
    opacity-aware ellipse extent (``conic_ellipse_radii``)."""
    C, N = proj.depths.shape
    M0 = C * N
    _, _, sw, sh = supertile_grid(width, height, tile_size, ss)
    sps = tile_size * ss
    u = proj.means2d[..., 0].reshape(M0)
    v = proj.means2d[..., 1].reshape(M0)
    con = proj.conics.reshape(M0, 3)
    rx, ry = conic_ellipse_radii(
        con[:, 0], con[:, 1], con[:, 2], proj.opacities.reshape(M0))
    valid = proj.valid.reshape(M0)
    sy0 = torch.clamp(torch.floor((v - ry) / sps), 0, sh).long()
    sy1 = torch.clamp(torch.ceil((v + ry) / sps), 0, sh).long()
    span_y = torch.clamp(sy1 - sy0, min=0)
    if camera_model == "spherical":
        sx0 = torch.floor((u - rx) / sps).long()
        sx1 = torch.ceil((u + rx) / sps).long()
        span_x = torch.clamp(sx1 - sx0, max=sw)
        sx0 = torch.remainder(sx0, sw)
    else:
        sx0 = torch.clamp(torch.floor((u - rx) / sps), 0, sw).long()
        sx1 = torch.clamp(torch.ceil((u + rx) / sps), 0, sw).long()
        span_x = torch.clamp(sx1 - sx0, min=0)
    span_x = torch.where(valid, span_x, torch.zeros_like(span_x))
    span_y = torch.where(valid, span_y, torch.zeros_like(span_y))
    return sx0, span_x, sy0, span_y


def observed_sb_slab(proj: Projected, width: int, height: int, tile_size: int,
                     caps: StreamCaps, camera_model: str = "pinhole") -> int:
    """The seg_broadcast window width this projection needs
    (``seg_broadcast.required_slab``), for
    ``StreamCaps.choose_observed(sb_slab=...)``."""
    sx0, span_x, sy0, span_y = parent_spans(proj, width, height, tile_size,
                                            caps.ss, camera_model)
    counts = span_x * span_y
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    return required_slab(offsets, counts, caps.exp_cap)


def build_stream_intersections(
    proj: Projected,
    width: int,
    height: int,
    tile_size: int,
    caps: StreamCaps,
    camera_model: str = "pinhole",
) -> StreamIsect:
    """Build the sorted supertile stream from projected gaussians."""
    C, N = proj.depths.shape
    M0 = C * N
    dev = proj.depths.device
    _, _, sw, sh = supertile_grid(width, height, tile_size, caps.ss)
    NS = sw * sh
    CS = C * NS
    G = caps.chunk
    EXP = caps.exp_cap

    sx0, span_x, sy0, span_y = parent_spans(
        proj, width, height, tile_size, caps.ss, camera_model)
    counts = span_x * span_y
    span_p = torch.clamp(span_x, min=1)
    kA = torch.zeros_like(counts)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    n_isect = offsets[-1] + counts[-1]
    overflow = n_isect > EXP

    # each slot's (supertile id | f32 bits of the depth) key: live depths are
    # positive, so their bit patterns order like their values; slots past
    # the total carry id CS and sort last
    key, g_of_s = expand_slots(
        sx0, sy0, span_p, kA, offsets, proj.depths.reshape(M0), counts, EXP,
        SlotGrid(n=N, sw=sw, ns=NS, cs=CS, wrap=camera_model == "spherical"),
        slab=caps.sb_slab)
    # one stable sort on that exact int64 key: ties keep expansion order, as
    # the JAX package's stable two-key sort does
    sorted_key, order = torch.sort(key, stable=True)
    sorted_st = sorted_key >> 32
    sorted_g = g_of_s[order]

    st_starts = torch.searchsorted(
        sorted_st, torch.arange(CS + 1, dtype=torch.int64, device=dev),
        right=False)
    st_counts = st_starts[1:] - st_starts[:-1]
    lead = st_starts[:-1] % G
    counts_al = -torch.div(-(lead + st_counts), G, rounding_mode="floor") * G
    st_starts_al = torch.cat([counts_al.new_zeros(1), torch.cumsum(counts_al, 0)])

    n_slots = torch.clamp(n_isect, max=EXP)
    sorted_ok = torch.arange(EXP, dtype=torch.int64, device=dev) < n_slots
    return StreamIsect(
        sorted_g=torch.where(sorted_ok, sorted_g, torch.full_like(sorted_g, M0)).int(),
        st_starts=st_starts.int(),
        st_starts_al=st_starts_al.int(),
        n_isect=n_isect,
        n_slots=n_slots,
        overflow=overflow,
    )


def sort_grad_rows(pgrads: torch.Tensor, num_flat: int):
    """The plain composition the reduction replaces: one stable sort of
    ``pgrads`` [pad_cap, NF] by its key column (``GCOL_KEY``, gid + 1;
    unwritten rows hold 0 and sort to the front) and a gather of every row
    -> ``(rows, bounds)``, the sorted rows and the start of each gaussian's
    run, [num_flat + 1] int32. Within a run the rows keep their stream
    order. ``reduce_stream_grads`` reads the same runs in place."""
    _check_key_range(num_flat)
    order, bounds = seg_reduce.stable_key_order(pgrads[:, GCOL_KEY].to(torch.int32),
                                                num_flat)
    return pgrads[order], bounds


def _check_key_range(num_flat: int):
    if num_flat + 1 >= 1 << 24:
        raise ValueError(f"{num_flat} (camera, gaussian) pairs: the f32 gid key "
                         "is exact only below 2^24")


def reduce_stream_grads(pgrads: torch.Tensor, num_flat: int,
                        n_payload: int = N_GCOLS) -> torch.Tensor:
    """Per-slot -> per-gaussian gradient reduction of the backward's rows
    ``pgrads`` [pad_cap, NF] where they lie: ``seg_reduce.keyed_perm``
    orders the keyed rows (key > 0) by gaussian and, within a gaussian, in
    stream order, and ``seg_reduce.segment_reduce_rows`` sums each
    gaussian's rows in that order, over the leading ``n_payload`` columns
    (10 skips ABSDX/ABSDY when absgrad is off). Output ``[n_payload,
    num_flat]`` in flat [C*N] order, GCOL row order, bit-identical to
    ``sort_grad_rows`` + the same sums over the sorted copy. On CUDA
    tensors nothing is read back by the host. The JAX package's bf16x2
    packing of the rows (a TPU sort-payload trick) is not part of the
    port."""
    _check_key_range(num_flat)
    perm, bounds = seg_reduce.keyed_perm(pgrads, num_flat)
    return seg_reduce.segment_reduce_rows(pgrads, perm, bounds, n_payload)
