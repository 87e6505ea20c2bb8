"""Segmented reduce-by-key: key-sorted per-slot gradient rows -> per-gaussian.

Counterpart of ``splat_one_tpu/ops/seg_reduce.py``. The backward writes
one gradient row per (gaussian, supertile) slot; after a stable sort of
the rows by their key (gaussian id + 1), each gaussian's rows form one
contiguous run ``[bounds[m], bounds[m + 1])``. The reduction sums every
run, in sorted order, into ``out[:, m]``.

The TPU version reduces blocks of 2048 gaussians with a one-hot matmul on
the MXU because scatter-adds are slow there; that trick is not carried
over. ``segment_reduce_rows`` launches the CUDA kernel
(``csrc/seg_reduce.cu``: one thread per gaussian, a serial sum over its
run, no atomics) on CUDA tensors and runs ``segment_reduce_plain``, which
sums in the same order, on CPU tensors. Gradients are therefore
deterministic run to run.
"""

from __future__ import annotations

import torch

from splat_one_tpu_torch.utils import cuda_build

NF = 16  # row width of the gradient buffer (stream_isect.NF)
# payload widths the kernel is built for: stream_isect.GCOL_ABSDX (no
# absgrad) and stream_isect.N_GCOLS
PAYLOADS = (10, 12)


def segment_reduce_plain(rows: torch.Tensor, bounds: torch.Tensor,
                         n_payload: int) -> torch.Tensor:
    """Plain PyTorch version: ``out[c, m] = sum of rows[b, c]`` over the
    run ``b in [bounds[m], bounds[m + 1])``, added front to back from 0."""
    b = bounds.long()
    start, length = b[:-1], b[1:] - b[:-1]
    m0 = start.shape[0]
    acc = rows.new_zeros((m0, n_payload))
    idx = torch.nonzero(length > 0)[:, 0]
    r = 0
    while idx.numel():
        acc[idx] = acc[idx] + rows[start[idx] + r, :n_payload]
        r += 1
        idx = idx[length[idx] > r]
    return acc.T.contiguous()


def segment_reduce_rows(rows: torch.Tensor, bounds: torch.Tensor,
                        n_payload: int) -> torch.Tensor:
    """Per-gaussian sums ``[n_payload, M0]`` of key-sorted ``rows`` [cap,
    NF] f32 (payload in columns ``0 .. n_payload - 1``), with
    ``bounds`` [M0 + 1] int32 run starts. CPU tensors take the plain
    version; CUDA tensors launch the kernel (built from
    ``csrc/seg_reduce.cu`` at first use) or raise."""
    if rows.device.type == "cpu":
        return segment_reduce_plain(rows, bounds, n_payload)
    if rows.device.type != "cuda":
        raise ValueError(f"segment_reduce_rows: unsupported device {rows.device}")
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != NF:
        raise ValueError(f"rows must be f32 [cap, {NF}], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if bounds.dtype != torch.int32 or bounds.dim() != 1 or bounds.device != rows.device:
        raise ValueError("bounds must be int32 [M0 + 1] on the rows' device")
    if n_payload not in PAYLOADS:
        raise ValueError(f"n_payload must be one of {PAYLOADS}, got {n_payload}")
    rows = rows.contiguous()
    bounds = bounds.contiguous()
    m0 = bounds.shape[0] - 1
    out = torch.empty((n_payload, m0), dtype=torch.float32, device=rows.device)
    lib = cuda_build.library("seg_reduce")
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.seg_reduce(rows.data_ptr(), bounds.data_ptr(), out.data_ptr(),
                            m0, n_payload, stream)
    cuda_build.check(lib, rc, "seg_reduce")
    cuda_build.launch_counts["seg_reduce"] += 1
    return out
