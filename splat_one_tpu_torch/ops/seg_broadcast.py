"""Slot -> parent expansion of the supertile-stream builder.

Counterpart of ``splat_one_tpu/ops/seg_broadcast.py``. Two paths give
every slot its owning parent and that parent's metadata:
- the default path: a marker ``index_add_`` at run starts, a cumsum to
  the owning parent of every slot, one gather per column;
- the kernel path (``expand_parent_meta``): the parents' runs are
  contiguous and ascending, so the owners of each chunk of ``CH`` slots
  lie in one window of ``slab`` parents from an ``ALIGN``-aligned base
  (``coverage_windows``); each slot finds its parent by a search over the
  window's offsets and copies its row. CUDA tensors launch
  ``csrc/seg_broadcast.cu``; CPU tensors run ``expand_parent_meta_plain``.

``expand_meta_streamed`` picks the path as the JAX package does, from
``force_path`` or ``SPLAT_SEG_BROADCAST`` (``xla``, the default, is the
default path; ``kernel``; ``cond``: the kernel when every window covers
its chunk, else the default path, counted in
``cuda_build.launch_counts["seg_broadcast_fallback"]``). On live slots
(below the total) both paths give the same bits. The JAX kernel's bf16
byte and split columns (``build_vals``), which only make its one-hot MXU
product exact, are not part of the port.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from splat_one_tpu_torch.utils import cuda_build

CH = 1024  # slots per chunk (one block of the kernel)
B = 2048  # guaranteed parent window past the slab base (default slab)
SLAB = 3072  # default parents searched per chunk
ALIGN = 128  # window-base alignment
N_OUT = 7  # sx0, sy0, span, ka, offset, depth (f32 bits), parent
_PAD_OFFSET = (1 << 31) - 1  # offsets past the last parent: above every slot
_PLAIN_CHUNKS = 256  # chunks searched per step of the plain version
_MAX_SLAB = 232_448 // 4 - 1  # the window's offsets fill at most 227 KB of shared memory


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


def parent_table(sx0, sy0, span, ka, offsets, depth) -> torch.Tensor:
    """[MP, 8] int32 parent rows: sx0, sy0, span, ka, offset, the f32 bits
    of depth, and two zero columns (32-byte rows)."""
    ints = [x.int() for x in (sx0, sy0, span, ka, offsets)]
    zero = torch.zeros_like(ints[0])
    return torch.stack(ints + [depth.float().contiguous().view(torch.int32), zero, zero],
                       dim=1)


def expand_parent_meta_plain(table: torch.Tensor, offs_pad: torch.Tensor,
                             pbases: torch.Tensor, slab: int = SLAB) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same window search and
    zero rows, in blocks of chunks. Returns [N_OUT, nb * CH] int32."""
    dev = table.device
    nb = pbases.shape[0]
    MP = table.shape[0]
    out = torch.zeros((N_OUT, nb * CH), dtype=torch.int32, device=dev)
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
        rows = table[torch.clamp(p, 0, MP - 1)]  # [K, CH, 8]
        vals = torch.stack([rows[..., 0], rows[..., 1],
                            torch.clamp(rows[..., 2], min=1), rows[..., 3],
                            rows[..., 4], rows[..., 5], p.int()], dim=0)
        dst = out[:, k0 * CH:(k0 + base.shape[0]) * CH].view(N_OUT, -1, CH)
        dst.copy_(torch.where(covered, vals, dst))
    return out


def expand_parent_meta(table: torch.Tensor, offs_pad: torch.Tensor,
                       pbases: torch.Tensor, slab: int = SLAB) -> torch.Tensor:
    """Per-slot parent metadata [N_OUT, nb * CH] int32 (row 5 holds the
    f32 bits of depth) for the chunks of ``pbases``. CPU tensors take the
    plain version; CUDA tensors launch the kernel (built from
    ``csrc/seg_broadcast.cu`` at first use) or raise."""
    if table.device.type == "cpu":
        return expand_parent_meta_plain(table, offs_pad, pbases, slab)
    if table.device.type != "cuda":
        raise ValueError(f"expand_parent_meta: unsupported device {table.device}")
    nb = pbases.shape[0]
    if not 1 <= slab <= _MAX_SLAB:
        raise ValueError(f"slab {slab} outside [1, {_MAX_SLAB}]")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != 8:
        raise ValueError(f"table must be int32 [MP, 8], got {table.dtype} "
                         f"{tuple(table.shape)}")
    for name, t in (("offs_pad", offs_pad), ("pbases", pbases)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.device != table.device:
            raise ValueError(f"{name} must be int32 1-D on {table.device}")
    if offs_pad.shape[0] < table.shape[0] + slab + 1:
        raise ValueError("offs_pad is shorter than the last window")
    table = table.contiguous()
    offs_pad = offs_pad.contiguous()
    pbases = pbases.contiguous()
    out = torch.empty((N_OUT, nb * CH), dtype=torch.int32, device=table.device)
    lib = cuda_build.library("seg_broadcast")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.seg_broadcast(pbases.data_ptr(), offs_pad.data_ptr(),
                               table.data_ptr(), out.data_ptr(), nb, table.shape[0],
                               slab, stream)
    cuda_build.check(lib, rc, "seg_broadcast")
    cuda_build.launch_counts["seg_broadcast"] += 1
    return out


def _default_path(sx0, sy0, span, ka, offsets, depth, exp_cap):
    dev = offsets.device
    starts = offsets[1:].long()
    buckets = torch.zeros((exp_cap,), dtype=torch.int64, device=dev)
    buckets.index_add_(0, torch.clamp(starts, 0, exp_cap - 1),
                       (starts < exp_cap).long())
    g_of_s = torch.cumsum(buckets, dim=0)
    return (sx0[g_of_s], sy0[g_of_s], torch.clamp(span[g_of_s], min=1),
            ka[g_of_s], offsets[g_of_s], depth[g_of_s], g_of_s)


def _kernel_path(sx0, sy0, span, ka, offsets, depth, exp_cap, pbases,
                 offs_pad, slab):
    table = parent_table(sx0, sy0, span, ka, offsets, depth)
    m = expand_parent_meta(table, offs_pad, pbases, slab)[:, :exp_cap]
    return (m[0].long(), m[1].long(), m[2].long(), m[3].long(), m[4].long(),
            m[5].view(torch.float32), m[6].long())


def expand_meta_streamed(sx0, sy0, span, ka, offsets, depth, counts, exp_cap,
                         force_path=None, slab=SLAB):
    """Per-slot parent metadata for ``exp_cap`` slots ->
    ``(sx0_s, sy0_s, span_s, ka_s, off_s, depth_s, g_of_s)``, int64 but
    ``depth_s`` (f32).

    ``offsets`` [MP] are the exclusive starts of the parents' slot runs,
    ``counts`` their lengths. ``span_s`` is at least 1 so the caller's
    modulo decode is always defined. Slots at or after the total differ
    between the paths (the default path gives them the last parent, the
    kernel the zero row) and are masked by the caller. ``force_path``:
    None (read ``SPLAT_SEG_BROADCAST``, default ``"xla"``), ``"xla"``,
    ``"kernel"`` or ``"cond"``."""
    if force_path is None:
        force_path = os.environ.get("SPLAT_SEG_BROADCAST", "xla")
    if force_path not in ("xla", "kernel", "cond"):
        raise ValueError(f"SPLAT_SEG_BROADCAST / force_path must be xla, kernel or "
                         f"cond, got {force_path!r}")
    if force_path == "xla":
        return _default_path(sx0, sy0, span, ka, offsets, depth, exp_cap)
    okv, pbases, offs_pad = coverage_windows(offsets, counts, exp_cap, slab)
    # the guard reads one flag on the host: a sync on this opt-in path only
    if force_path == "cond" and not bool(okv.all()):
        cuda_build.launch_counts["seg_broadcast_fallback"] += 1
        return _default_path(sx0, sy0, span, ka, offsets, depth, exp_cap)
    return _kernel_path(sx0, sy0, span, ka, offsets, depth, exp_cap, pbases,
                        offs_pad, slab)
