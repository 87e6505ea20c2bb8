"""Slot -> parent expansion of the supertile-stream builder.

Counterpart of ``splat_one_tpu/ops/seg_broadcast.py``. ``expand_slots``
gives every slot of the stream build its sort key, ``(supertile id << 32)
| f32 bits of the owning parent's depth`` (id ``C * NS`` at and past the
total), and its owning parent, by one of two paths:
- the default path: a marker ``index_add_`` at run starts, a cumsum to
  the owning parent of every slot, one gather per metadata column
  (``default_expansion``), then the decode of each slot's supertile
  (``slot_keys``);
- the kernel path (``expand_parent_meta``): the parents' runs are
  contiguous and ascending, so the owners of each chunk of ``CH`` slots
  lie in one window of ``slab`` parents from an ``ALIGN``-aligned base
  (``coverage_windows``); each slot finds its parent by a search over the
  window's offsets, reads the parent's columns and decodes its key in
  one pass. CUDA tensors launch ``csrc/seg_broadcast.cu``; CPU tensors
  run ``expand_parent_meta_plain`` (``window_expansion_plain``, then
  ``slot_keys``).

``expand_slots`` picks the path as the JAX package does, from
``force_path`` or ``SPLAT_SEG_BROADCAST`` (``xla``, the default, is the
default path; ``kernel``; ``cond``: the kernel when every window covers
its chunk, else the default path, counted in
``cuda_build.launch_counts["seg_broadcast_fallback"]``). On live slots
(below the total) both paths give the same bits; the stream layout built
from them is the same under every path. The JAX kernel's bf16 byte and
split columns (``build_vals``), which only make its one-hot MXU product
exact, are not part of the port.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from splat_one_tpu_torch.utils import cuda_build

CH = 1024  # slots per chunk (one block of the kernel)
B = 2048  # guaranteed parent window past the slab base (default slab)
SLAB = 3072  # default parents searched per chunk
ALIGN = 128  # window-base alignment
_PAD_OFFSET = (1 << 31) - 1  # offsets past the last parent: above every slot
_PLAIN_CHUNKS = 256  # chunks searched per step of the plain version
_MAX_SLAB = 232_448 // 4 - 1  # the window's offsets fill at most 227 KB of shared memory


class SlotGrid(NamedTuple):
    """What turns a slot's parent row into its supertile id: gaussians per
    camera, supertiles per row and per camera, the id of slots at and past
    the total (``C * ns``), and the azimuth wrap of spherical cameras."""

    n: int
    sw: int
    ns: int
    cs: int
    wrap: bool


def _as_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def coverage_windows(offsets: torch.Tensor, counts: torch.Tensor, exp_cap: int,
                     slab: int = SLAB):
    """Per-chunk parent-window bases and coverage flags.

    Returns ``(okv [nb] bool, pbases [nb] int32, offs_pad int32)``:
    ``offs_pad`` is the inclusive offset table (the parents' starts, then
    the total) padded past every window's end. A chunk is covered when its
    window ``[base, base + slab)`` reaches past every parent whose run
    meets the chunk's slots below the total: slots at or after the total
    carry no live parent and never constrain the window."""
    MP = offsets.shape[0]
    dev = offsets.device
    nb = -(-exp_cap // CH)
    total = (offsets[-1] + counts[-1]).long()
    offs_incl = torch.cat([offsets.long(), total.reshape(1)])
    pad = (-MP) % ALIGN + slab + ALIGN + 1024
    offs_pad = torch.cat([offs_incl, offs_incl.new_full((pad,), _PAD_OFFSET)])
    chunk_starts = torch.arange(nb, device=dev, dtype=torch.int64) * CH
    pb = torch.clamp(torch.searchsorted(offs_incl, chunk_starts, right=True) - 1, min=0)
    pbases = torch.div(pb, ALIGN, rounding_mode="floor") * ALIGN
    slab_end = torch.clamp(pbases + slab, max=MP)
    need = torch.clamp(chunk_starts + CH, max=total)
    okv = offs_pad[slab_end] >= need
    return okv, pbases.int(), offs_pad.int()


def required_slab(offsets, counts, exp_cap: int, margin: int = 256) -> int:
    """The observed window width: the max over slot chunks of the
    ``ALIGN``-aligned parent window a chunk needs, plus ``margin``, rounded
    up to ``ALIGN``. Measured once on a warm-up problem and passed as
    ``slab`` (``StreamCaps.sb_slab``); drift past it trips the ``cond``
    guard to the default path."""
    offsets = _as_numpy(offsets)
    counts = _as_numpy(counts)
    total = int(offsets[-1]) + int(counts[-1])
    nb = -(-exp_cap // CH)
    offs_incl = np.concatenate([offsets, [total]]).astype(np.int64)
    starts = np.arange(nb, dtype=np.int64) * CH
    pb = np.maximum(np.searchsorted(offs_incl, starts, side="right") - 1, 0)
    need = np.minimum(starts + CH, total)
    pe = np.searchsorted(offs_incl, need, side="left")
    width = int(np.max(pe - (pb // ALIGN) * ALIGN)) + margin
    return max(-(-width // ALIGN) * ALIGN, ALIGN)


def default_expansion(sx0, sy0, span, ka, offsets, depth, exp_cap):
    """The default path's per-slot parent metadata for ``exp_cap`` slots ->
    ``(sx0_s, sy0_s, span_s, ka_s, off_s, depth_s, g_of_s)``, int64 but
    ``depth_s`` (f32); ``span_s`` at least 1. Slots at or after the total
    take the last parent."""
    dev = offsets.device
    starts = offsets[1:].long()
    buckets = torch.zeros((exp_cap,), dtype=torch.int64, device=dev)
    buckets.index_add_(0, torch.clamp(starts, 0, exp_cap - 1),
                       (starts < exp_cap).long())
    g_of_s = torch.cumsum(buckets, dim=0)
    return (sx0[g_of_s], sy0[g_of_s], torch.clamp(span[g_of_s], min=1),
            ka[g_of_s], offsets[g_of_s], depth[g_of_s], g_of_s)


def slot_keys(meta, n_live, grid: SlotGrid):
    """Each slot's sort key and owner from its parent metadata ``meta``
    (the seven columns of ``default_expansion``) -> ``(key, g_of_s)``: the
    slot's place in its parent's run, ``local = s - off + ka``, is the
    supertile ``(sx0 + local mod span, sy0 + local div span)`` (x taken mod
    ``sw`` with ``wrap``) of camera ``g div n``; ``key = (id << 32) | f32
    bits of depth``, id ``grid.cs`` for slots at or past ``n_live``."""
    sx0_s, sy0_s, span_s, ka_s, off_s, depth_s, g_of_s = meta
    slot_ids = torch.arange(g_of_s.shape[0], dtype=torch.int64, device=g_of_s.device)
    local = slot_ids - off_s + ka_s
    st_x = sx0_s + torch.remainder(local, span_s)
    if grid.wrap:
        st_x = torch.remainder(st_x, grid.sw)
    st_y = sy0_s + torch.div(local, span_s, rounding_mode="floor")
    cam = torch.div(g_of_s, grid.n, rounding_mode="floor")
    st_id = cam * grid.ns + st_y * grid.sw + st_x
    st_id = torch.where(slot_ids < n_live, st_id, torch.full_like(st_id, grid.cs))
    dbits = depth_s.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return (st_id << 32) | dbits, g_of_s


def window_expansion_plain(sx0, sy0, span, ka, depth, offs_pad, pbases,
                           slab: int = SLAB):
    """The kernel path's parent search, in blocks of chunks: for each slot
    of the chunks of ``pbases``, the seven columns of ``default_expansion``
    ([nb * CH] each; ``g_of_s`` int64). A slot the window does not cover,
    or one past the total, gets the zero row (span 1, parent 0), as the
    TPU kernel's one-hot product gives it."""
    dev = offs_pad.device
    nb = pbases.shape[0]
    MP = sx0.shape[0]
    cols = torch.stack([sx0.long(), sy0.long(), torch.clamp(span.long(), min=1), ka.long(),
                        offs_pad[:MP].long(),
                        depth.float().contiguous().view(torch.int32).long()], dim=1)
    out = torch.zeros((7, nb * CH), dtype=torch.int64, device=dev)
    out[2] = 1
    win = torch.arange(slab + 1, device=dev)
    lane = torch.arange(CH, device=dev)
    for k0 in range(0, nb, _PLAIN_CHUNKS):
        base = pbases[k0:k0 + _PLAIN_CHUNKS].long()
        offs = offs_pad.long()[base[:, None] + win]  # [K, slab + 1]
        s = (torch.arange(k0, k0 + base.shape[0], device=dev)[:, None] * CH + lane)
        i = torch.searchsorted(offs[:, :slab].contiguous(), s, right=True) - 1
        nxt = torch.gather(offs, 1, torch.clamp(i + 1, max=slab))
        p = base[:, None] + i
        # entry MP of the offsets is the total: past it there is no parent
        covered = (i >= 0) & (p < MP) & (s < nxt)
        vals = torch.cat([cols[torch.clamp(p, 0, MP - 1)].permute(2, 0, 1), p[None]])
        dst = out[:, k0 * CH:(k0 + base.shape[0]) * CH].view(7, -1, CH)
        dst.copy_(torch.where(covered, vals, dst))
    meta = [out[c] for c in range(7)]
    meta[5] = out[5].int().view(torch.float32)
    return tuple(meta)


def expand_parent_meta_plain(sx0, sy0, span, ka, depth, offs_pad, pbases, exp_cap: int,
                             grid: SlotGrid, slab: int = SLAB):
    """Plain PyTorch version of the kernel: ``window_expansion_plain``,
    then ``slot_keys`` -> ``(key int64, g_of_s int32)`` [nb * CH]."""
    meta = window_expansion_plain(sx0, sy0, span, ka, depth, offs_pad, pbases, slab)
    n_live = torch.clamp(offs_pad[sx0.shape[0]].long(), max=exp_cap)
    key, g = slot_keys(meta, n_live, grid)
    return key, g.int()


def expand_parent_meta(sx0, sy0, span, ka, depth, offs_pad, pbases, exp_cap: int,
                       grid: SlotGrid, slab: int = SLAB):
    """Each slot's sort key and owning parent -> ``(key int64, g_of_s
    int32)`` [nb * CH] for the chunks of ``pbases``, from the parents'
    columns (``sx0``, ``sy0``, ``span``, ``ka`` int64, ``depth`` f32, [MP])
    and the windows of ``coverage_windows``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (built from
    ``csrc/seg_broadcast.cu`` at first use) or raise."""
    if offs_pad.device.type == "cpu":
        return expand_parent_meta_plain(sx0, sy0, span, ka, depth, offs_pad, pbases,
                                        exp_cap, grid, slab)
    dev = offs_pad.device
    if dev.type != "cuda":
        raise ValueError(f"expand_parent_meta: unsupported device {dev}")
    nb = pbases.shape[0]
    MP = sx0.shape[0]
    if not 1 <= slab <= _MAX_SLAB:
        raise ValueError(f"slab {slab} outside [1, {_MAX_SLAB}]")
    for name, t, dtype in (("sx0", sx0, torch.int64), ("sy0", sy0, torch.int64),
                           ("span", span, torch.int64), ("ka", ka, torch.int64),
                           ("depth", depth, torch.float32), ("offs_pad", offs_pad, torch.int32),
                           ("pbases", pbases, torch.int32)):
        if t.dtype != dtype or t.dim() != 1 or t.device != dev:
            raise ValueError(f"{name} must be {dtype} 1-D on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if any(t.shape[0] != MP for t in (sy0, span, ka, depth)):
        raise ValueError("sx0, sy0, span, ka and depth must have one entry per parent")
    if offs_pad.shape[0] < MP + slab + 1:
        raise ValueError("offs_pad is shorter than the last window")
    if not 0 <= exp_cap <= nb * CH or nb * CH >= 1 << 31:
        raise ValueError(f"exp_cap {exp_cap} outside the {nb} chunks of {CH} slots")
    args = [t.contiguous() for t in (pbases, offs_pad, sx0, sy0, span, ka, depth)]
    key = torch.empty(nb * CH, dtype=torch.int64, device=dev)
    g = torch.empty(nb * CH, dtype=torch.int32, device=dev)
    lib = cuda_build.library("seg_broadcast")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.seg_broadcast(*(t.data_ptr() for t in args), key.data_ptr(), g.data_ptr(),
                               nb, MP, slab, exp_cap, grid.n, grid.sw, grid.ns, grid.cs,
                               int(grid.wrap), stream)
    cuda_build.check(lib, rc, "seg_broadcast")
    cuda_build.launch_counts["seg_broadcast"] += 1
    return key, g


def expand_slots(sx0, sy0, span, ka, offsets, depth, counts, exp_cap: int,
                 grid: SlotGrid, force_path=None, slab: int = SLAB):
    """Each of ``exp_cap`` slots' sort key and owning parent -> ``(key,
    g_of_s)``: ``key`` int64 as ``slot_keys`` makes it, ``g_of_s`` int64
    (default path) or int32 (kernel path).

    ``offsets`` [MP] are the exclusive starts of the parents' slot runs,
    ``counts`` their lengths; ``span`` is taken at least 1. Live slots
    (below the total) get the same bits from both paths; slots past it get
    id ``grid.cs`` and otherwise differ (the default path gives them the
    last parent, the kernel the zero row). ``force_path``: None (read
    ``SPLAT_SEG_BROADCAST``, default ``"xla"``), ``"xla"``, ``"kernel"``
    or ``"cond"``."""
    if force_path is None:
        force_path = os.environ.get("SPLAT_SEG_BROADCAST", "xla")
    if force_path not in ("xla", "kernel", "cond"):
        raise ValueError(f"SPLAT_SEG_BROADCAST / force_path must be xla, kernel or "
                         f"cond, got {force_path!r}")

    def default():
        n_live = torch.clamp(offsets[-1] + counts[-1], max=exp_cap)
        return slot_keys(default_expansion(sx0, sy0, span, ka, offsets, depth, exp_cap),
                         n_live, grid)

    if force_path == "xla":
        return default()
    okv, pbases, offs_pad = coverage_windows(offsets, counts, exp_cap, slab)
    # the guard reads one flag on the host: a sync on this opt-in path only
    if force_path == "cond" and not bool(okv.all()):
        cuda_build.launch_counts["seg_broadcast_fallback"] += 1
        return default()
    key, g = expand_parent_meta(sx0, sy0, span, ka, depth, offs_pad, pbases, exp_cap,
                                grid, slab)
    return key[:exp_cap], g[:exp_cap]
