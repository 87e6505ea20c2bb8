"""Gen-1 tile-intersection builder: gaussians -> sorted, G-aligned per-tile lists.

Counterpart of ``splat_one_tpu/ops/intersect.py`` (the layout behind
``impl="tiled"``). Pipeline:
  1. per-camera stable depth argsort (so every per-tile subsequence taken
     in sorted order is depth-ordered),
  2. per-gaussian tile-bbox spans from the opacity-aware ellipse extents
     -> counts -> exclusive offsets,
  3. expansion to ``exp_cap`` slots (marker ``index_add_`` + cumsum) and
     each slot's (camera, tile) id,
  4. one stable sort by tile id, carrying the depth rank,
  5. per-tile ranges (searchsorted) padded to multiples of the chunk G,
     so the compositing kernels walk whole chunks of one tile,
  6. the by-gaussian permutation and run bounds of the backward's
     per-gaussian reduction (``gather_reduction``).
Spherical cameras wrap in azimuth: unwrapped spans, tile x ``mod TW``.

The integer outputs equal the JAX package's bit for bit. The gradient
reduction sums each gaussian's slot rows exactly with the segmented
reduce (``ops.seg_reduce``, reading the rows in place through
``rank_perm``) instead of the JAX package's row gather, cumsum and
boundary difference. The tile-sharded path (``tile_lo`` /
``n_tiles_local``) belongs to the multi-GPU slice and raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from splat_one_tpu_torch.ops import seg_reduce
from splat_one_tpu_torch.ops.projection import Projected, conic_ellipse_radii


@dataclasses.dataclass(frozen=True)
class IsectCaps:
    """Slot capacities of the per-tile layout; intersections beyond
    ``exp_cap`` (or aligned slots beyond ``align_cap``) are dropped and
    flagged by ``overflow``."""

    exp_cap: int  # max total (gaussian, tile) intersections
    align_cap: int  # max total after G-alignment padding (>= exp_cap)
    chunk: int = 128  # compositing chunk G

    @staticmethod
    def choose(num_gaussians: int, num_cameras: int, num_tiles: int,
               chunk: int = 128, avg_tiles_per_gaussian: float = 8.0):
        exp_cap = int(num_cameras * num_gaussians * avg_tiles_per_gaussian)
        exp_cap = max(exp_cap, 1024)
        exp_cap = -(-exp_cap // chunk) * chunk
        align_cap = exp_cap + num_cameras * num_tiles * chunk
        return IsectCaps(exp_cap=exp_cap, align_cap=align_cap, chunk=chunk)


class IsectData(NamedTuple):
    """Sorted, aligned per-tile layout.

    ``slot_rank[p]``: depth rank (index into the camera-major per-camera
    depth order, ``[C * N]``) of the gaussian in aligned slot p; padding
    and dropped slots hold ``C * N``. ``rank_src[r]``: flat ``[C * N]``
    index of depth rank r. ``tile_starts`` [CT + 1]: G-aligned slot range
    of each (camera, tile). ``rank_perm`` sorts slots by ``slot_rank``;
    ``rank_bounds[r]`` is the start of rank r's run in that order."""

    slot_rank: torch.Tensor  # [align_cap] int32
    rank_src: torch.Tensor  # [C * N] int32
    tile_starts: torch.Tensor  # [CT + 1] int32
    rank_perm: torch.Tensor  # [align_cap] int32
    rank_bounds: torch.Tensor  # [C * N + 1] int32
    n_isect: torch.Tensor  # [] int64 raw intersection count
    n_slots: torch.Tensor  # [] int64 aligned slots in use
    overflow: torch.Tensor  # [] bool


def _index_of_slot(markers_at: torch.Tensor, capacity: int) -> torch.Tensor:
    """For each slot s in [0, capacity), the index of the segment holding
    it (``searchsorted(markers_at, s, 'right') - 1``), from the sorted
    segment starts: a marker ``index_add_`` at every start but the first,
    then a cumsum."""
    starts = markers_at[1:]
    buckets = torch.zeros((capacity,), dtype=torch.int64, device=starts.device)
    buckets.index_add_(0, torch.clamp(starts, 0, capacity - 1),
                       (starts < capacity).long())
    return torch.cumsum(buckets, dim=0)


def tile_spans(uv, rx, ry, valid, width: int, height: int, tile_size: int,
               spherical_wrap: bool):
    """Per-gaussian tile bbox ``(tx0, ty0, span_x, span_y)`` (int64) from
    the per-axis ellipse extents ``rx``, ``ry``. With ``spherical_wrap``
    tx0 is taken ``mod TW`` and the span is unwrapped."""
    TW = -(-width // tile_size)
    TH = -(-height // tile_size)
    u, v = uv[:, 0], uv[:, 1]
    ty0 = torch.clamp(torch.floor((v - ry) / tile_size), 0, TH).long()
    ty1 = torch.clamp(torch.ceil((v + ry) / tile_size), 0, TH).long()
    span_y = torch.clamp(ty1 - ty0, min=0)
    if spherical_wrap:
        tx0 = torch.floor((u - rx) / tile_size).long()
        tx1 = torch.ceil((u + rx) / tile_size).long()
        span_x = torch.clamp(tx1 - tx0, max=TW)
        tx0 = torch.remainder(tx0, TW)
    else:
        tx0 = torch.clamp(torch.floor((u - rx) / tile_size), 0, TW).long()
        tx1 = torch.clamp(torch.ceil((u + rx) / tile_size), 0, TW).long()
        span_x = torch.clamp(tx1 - tx0, min=0)
    zero = torch.zeros_like(span_x)
    return (tx0, ty0, torch.where(valid, span_x, zero),
            torch.where(valid, span_y, zero))


def build_intersections(proj: Projected, width: int, height: int,
                        tile_size: int, caps: IsectCaps,
                        camera_model: str = "pinhole", tile_lo=None,
                        n_tiles_local: int = 0) -> IsectData:
    """Build the sorted, G-aligned per-tile layout from projected
    gaussians (a detached projection: the layout is integer data)."""
    if tile_lo is not None or n_tiles_local:
        raise NotImplementedError(
            "tile_lo / n_tiles_local (tile-sharded multi-GPU rasterization) is "
            "not ported yet: it comes with the multi-GPU slice")
    C, N = proj.depths.shape
    dev = proj.depths.device
    TW = -(-width // tile_size)
    TH = -(-height // tile_size)
    T = TH * TW
    CT = C * T
    M0 = C * N
    G = caps.chunk
    EXP = caps.exp_cap
    AL = caps.align_cap

    # 1. per-camera depth order, invalid gaussians last
    key = torch.where(proj.valid, proj.depths,
                      torch.full_like(proj.depths, float("inf")))
    order = torch.argsort(key, dim=1, stable=True)
    cam_offset = (torch.arange(C, device=dev) * N)[:, None]
    rank_src = (order + cam_offset).reshape(M0)

    # 2. tile spans in depth-rank order
    con = proj.conics.reshape(M0, 3)
    rx, ry = conic_ellipse_radii(con[:, 0], con[:, 1], con[:, 2],
                                 proj.opacities.reshape(M0))
    uv = proj.means2d.reshape(M0, 2)[rank_src]
    tx0, ty0, span_x, span_y = tile_spans(
        uv, rx[rank_src], ry[rank_src], proj.valid.reshape(M0)[rank_src],
        width, height, tile_size, spherical_wrap=(camera_model == "spherical"))
    counts = span_x * span_y
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    n_isect = offsets[-1] + counts[-1]
    overflow = n_isect > EXP

    # 3. expansion: slot s -> depth rank g(s) -> its (camera, tile)
    g_of_s = _index_of_slot(offsets, EXP)
    slot_ids = torch.arange(EXP, device=dev)
    slot_ok = slot_ids < torch.clamp(n_isect, max=EXP)
    local = slot_ids - offsets[g_of_s]
    sx = torch.clamp(span_x, min=1)[g_of_s]
    tile_x = tx0[g_of_s] + torch.remainder(local, sx)
    if camera_model == "spherical":
        tile_x = torch.remainder(tile_x, TW)
    tile_y = ty0[g_of_s] + torch.div(local, sx, rounding_mode="floor")
    cam = torch.div(g_of_s, N, rounding_mode="floor")
    tile_id = cam * T + tile_y * TW + tile_x
    tile_id = torch.where(slot_ok, tile_id, torch.full_like(tile_id, CT))

    # 4. stable sort by tile: depth order is kept within each tile
    sorted_tiles, perm = torch.sort(tile_id, stable=True)
    sorted_g = g_of_s[perm]

    # 5. per-tile ranges, each padded to whole chunks
    raw_starts = torch.searchsorted(
        sorted_tiles, torch.arange(CT + 1, device=dev), right=False)
    tile_counts = raw_starts[1:] - raw_starts[:-1]
    counts_al = -torch.div(-tile_counts, G, rounding_mode="floor") * G
    starts_al = torch.cat([counts_al.new_zeros(1), torch.cumsum(counts_al, 0)])
    overflow = overflow | (starts_al[-1] > AL)
    # the kernels read whole chunks of [starts_al[t], starts_al[t+1]): clamp
    # to the last whole chunk of align_cap (truncation is flagged above)
    starts_al = torch.clamp(starts_al, max=(AL // G) * G)
    n_slots = starts_al[-1]

    # every per-slot quantity is piecewise constant over the aligned ranges:
    # slot p takes the last tile whose (clamped) aligned start is <= p. The
    # JAX package forward-fills each quantity with a max-scatter + cummax;
    # one searchsorted gives the same tile (a 1-D cummax is a single-block
    # scan on CUDA)
    p_ids = torch.arange(AL, device=dev)
    tile_of_p = torch.searchsorted(torch.clamp(starts_al[:-1], max=AL - 1), p_ids,
                                   right=True) - 1
    src_raw = raw_starts[tile_of_p] + (p_ids - starts_al[tile_of_p])
    p_ok = (src_raw < raw_starts[tile_of_p + 1]) & (p_ids < n_slots)
    src = torch.clamp(src_raw, 0, EXP - 1)
    slot_rank = torch.where(p_ok, sorted_g[src], torch.full_like(src, M0))

    # 6. the backward's by-gaussian order: rank r's run length is its
    # number of kept expansion slots, so the run bounds are a prefix sum
    rank_perm = torch.sort(slot_rank, stable=True).indices
    fcum = torch.cat([slot_ok.new_zeros(1, dtype=torch.int64),
                      torch.cumsum(slot_ok.long(), 0)])
    pos = torch.cat([offsets, (offsets[-1] + counts[-1]).reshape(1)])
    rank_bounds = fcum[torch.clamp(pos, 0, EXP)]

    return IsectData(
        slot_rank=slot_rank.int(),
        rank_src=rank_src.int(),
        tile_starts=starts_al.int(),
        rank_perm=rank_perm.int(),
        rank_bounds=rank_bounds.int(),
        n_isect=n_isect,
        n_slots=n_slots,
        overflow=overflow,
    )


# Column layout of the packed [align_cap, NF] slot table (one 64-byte row
# per slot) that the compositing kernels read.
ROW_X = 0
ROW_Y = 1
ROW_CA = 2
ROW_CB = 3
ROW_CC = 4
ROW_OPAC = 5
ROW_R = 6
ROW_G = 7
ROW_B = 8
ROW_DEPTH = 9
NF = 16  # padded power-of-two width

# Column layout of the backward's [align_cap, NF] per-slot gradient rows.
GROW_DX = 0
GROW_DY = 1
GROW_DCA = 2
GROW_DCB = 3
GROW_DCC = 4
GROW_DOPAC = 5
GROW_DR = 6
GROW_DG = 7
GROW_DB = 8
GROW_DDEPTH = 9
GROW_ABSDX = 10
GROW_ABSDY = 11
N_GROWS = 12  # gradient columns (the rest of a row is zero)


def pack_fields(means2d, conics, colors, opacities, depths,
                isect: IsectData) -> torch.Tensor:
    """[align_cap, NF] slot-major field table (``ROW_*`` columns): a
    [M0, NF] field matrix, one row gather into depth-rank order, one into
    slot order (sentinel slots -> zero rows)."""
    C, N = opacities.shape
    M0 = C * N
    fields = torch.cat([
        means2d.reshape(M0, 2),
        conics.reshape(M0, 3),
        opacities.reshape(M0, 1),
        colors.reshape(M0, 3),
        depths.reshape(M0, 1),
    ], dim=1)
    fields = torch.nn.functional.pad(fields, (0, NF - fields.shape[1]))
    fields_rank = torch.cat([fields[isect.rank_src.long()], fields.new_zeros((1, NF))])
    return fields_rank[isect.slot_rank.long()]


def gather_reduction(pgrads: torch.Tensor, isect: IsectData,
                     num_flat: int) -> torch.Tensor:
    """Per-slot gradient rows [align_cap, NF] -> per-gaussian sums
    [N_GROWS, num_flat] in flat [C*N] order (``GROW_*`` row order).

    The segmented reduce (``ops.seg_reduce``: a kernel on CUDA, exact and
    deterministic) reads each depth rank's rows where the backward wrote
    them, through the layout's own int32 index: rank r's run
    ``rank_perm[rank_bounds[r] .. rank_bounds[r + 1])``, summed front to
    back, lands at the flat index ``rank_src[r]``. No row is copied and no
    index is widened: the same bits as gathering the rows by ``rank_perm``,
    reducing the sorted copy and scattering through ``rank_src``."""
    return seg_reduce.segment_reduce_rows(pgrads, isect.rank_perm, isect.rank_bounds,
                                          N_GROWS, out_index=isect.rank_src)
