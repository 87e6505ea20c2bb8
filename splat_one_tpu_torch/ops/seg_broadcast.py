"""Slot -> parent expansion of the supertile-stream builder.

Counterpart of the default path of
``splat_one_tpu/ops/seg_broadcast.py::expand_meta_streamed``: a marker
``index_add_`` at run starts, a cumsum to the owning parent of every slot,
and one row gather of the parents' metadata. The JAX package's Pallas
one-hot-matmul kernel for the same job runs only on request there
(``SPLAT_SEG_BROADCAST=cond``) and is not part of this port yet.
"""

from __future__ import annotations

import torch


def expand_meta_streamed(sx0, sy0, span, ka, offsets, depth, exp_cap):
    """Per-slot parent metadata for ``exp_cap`` slots.

    ``offsets`` [MP] are the exclusive starts of the parents' slot runs.
    Returns ``(sx0_s, sy0_s, span_s, ka_s, off_s, depth_s, g_of_s)``;
    ``span_s`` is clamped >= 1 so the caller's modulo decode is always
    defined. Slots at or after the total are owned by the last parent and
    are masked by the caller."""
    dev = offsets.device
    starts = offsets[1:].long()
    buckets = torch.zeros((exp_cap,), dtype=torch.int64, device=dev)
    buckets.index_add_(0, torch.clamp(starts, 0, exp_cap - 1),
                       (starts < exp_cap).long())
    g_of_s = torch.cumsum(buckets, dim=0)
    return (sx0[g_of_s], sy0[g_of_s], torch.clamp(span[g_of_s], min=1),
            ka[g_of_s], offsets[g_of_s], depth[g_of_s], g_of_s)
