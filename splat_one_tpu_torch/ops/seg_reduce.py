"""Per-gaussian sums of the backward's gradient rows, read where they lie.

Counterpart of ``splat_one_tpu/ops/seg_reduce.py`` and of the sort and
gather in front of it. The backward writes one gradient row per slot;
gaussian m owns the rows ``perm[bounds[m]], ..., perm[bounds[m + 1] - 1]``
of an int32 index ``perm``. ``segment_reduce_rows`` sums every run, front
to back from 0 in the order of ``perm``, into ``out[:, m]`` (or
``out[:, out_index[m]]``). The stream path builds ``perm`` and ``bounds``
with ``keyed_perm``: its keyed rows (key = gaussian id + 1 > 0) in key
order and, within a key, in stream order, as a stable sort of the keys
gives them. The tiled path has both in its layout (``rank_perm``,
``rank_bounds``, with ``rank_src`` as the output index).

The TPU version sorts the rows into a new array and reduces blocks of
2048 gaussians with a one-hot matmul on the MXU, because scatters are slow
there; neither is carried over. On CUDA tensors the wrappers launch
``csrc/seg_reduce.cu`` (two lanes a gaussian, one per 32-byte sector of
its rows, four rows in flight, whole sectors written where the output
lands at random, no atomics) and ``csrc/keyed_perm.cu`` (a
counting sort whose runs are put in row order by rank, no read back to
the host); on CPU tensors they run the plain versions below, which give
the same bits. Gradients are therefore deterministic run to run.
"""

from __future__ import annotations

import torch

from splat_one_tpu_torch.utils import cuda_build

NF = 16  # row width of the gradient buffer (stream_isect.NF)
KEY_COL = 12  # the rows' key column (stream_isect.GCOL_KEY)
# payload widths the kernel is built for: stream_isect.GCOL_ABSDX (no
# absgrad) and stream_isect.N_GCOLS
PAYLOADS = (10, 12)
_SCAN_BLOCK = 4096  # keys a block of the kernel's scan covers (csrc/keyed_perm.cu)


def _check_rows(name, rows):
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != NF:
        raise ValueError(f"{name}: rows must be f32 [cap, {NF}], got "
                         f"{rows.dtype} {tuple(rows.shape)}")


def _check_index(name, t, device):
    if t.dtype != torch.int32 or t.dim() != 1 or t.device != device:
        raise ValueError(f"{name} must be int32 1-D on the rows' device {device}")


def stable_key_order(keys: torch.Tensor, num_flat: int):
    """One stable sort of the int32 ``keys`` -> ``(order, bounds)``:
    ``order`` the sorting permutation (int64), ``bounds`` [num_flat + 1]
    int32 the start in it of the keys 1 .. num_flat + 1 (key 0 sorts to the
    front)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    queries = torch.arange(1, num_flat + 2, dtype=torch.int32, device=keys.device)
    return order, torch.searchsorted(sorted_keys, queries, out_int32=True)


def keyed_perm_plain(rows: torch.Tensor, num_flat: int):
    """Plain PyTorch version of ``keyed_perm``: the stable sort of the key
    column with its key-0 head dropped -> ``(perm, bounds)``, both int32."""
    order, bounds = stable_key_order(rows[:, KEY_COL].to(torch.int32), num_flat)
    head = int(bounds[0])
    return order[head:].int(), bounds - head


def keyed_perm(rows: torch.Tensor, num_flat: int):
    """The keyed rows (key in column ``KEY_COL``, in ``[1, num_flat]``) of
    ``rows`` [cap, NF] f32 in stable key order -> ``(perm, bounds)``:
    ``bounds`` [num_flat + 1] int32, ``bounds[m]`` the keyed rows with key
    at most m; ``perm`` int32, its first ``bounds[num_flat]`` entries the
    rows' indices, by key and then by index (on CUDA tensors ``perm`` has
    ``cap`` entries, the rest unspecified: the count stays on the card).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (built from ``csrc/keyed_perm.cu`` at first use) or raise."""
    if rows.device.type == "cpu":
        return keyed_perm_plain(rows, num_flat)
    if rows.device.type != "cuda":
        raise ValueError(f"keyed_perm: unsupported device {rows.device}")
    _check_rows("keyed_perm", rows)
    if not 1 <= num_flat <= _SCAN_BLOCK ** 2:
        raise ValueError(f"keyed_perm: num_flat {num_flat} outside [1, {_SCAN_BLOCK ** 2}]")
    rows = rows.contiguous()
    cap = rows.shape[0]
    dev = rows.device
    cnt_n = torch.zeros(num_flat + 1, dtype=torch.int32, device=dev)
    tot = torch.empty(-(-num_flat // _SCAN_BLOCK), dtype=torch.int32, device=dev)
    scratch = torch.empty((3, cap), dtype=torch.int32, device=dev)  # list (2 rows), perm_u
    perm = torch.empty(cap, dtype=torch.int32, device=dev)
    bounds = torch.empty(num_flat + 1, dtype=torch.int32, device=dev)
    lib = cuda_build.library("keyed_perm")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.keyed_perm(rows.data_ptr(), cap, num_flat, cnt_n.data_ptr(),
                            tot.data_ptr(), scratch[0].data_ptr(), scratch[2].data_ptr(),
                            perm.data_ptr(), bounds.data_ptr(), stream)
    cuda_build.check(lib, rc, "keyed_perm")
    cuda_build.launch_counts["keyed_perm"] += 1
    return perm, bounds


def segment_reduce_plain(rows: torch.Tensor, perm: torch.Tensor, bounds: torch.Tensor,
                         n_payload: int, out_index: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Plain PyTorch version: ``out[c, j] = sum of rows[perm[b], c]`` over
    the run ``b in [bounds[m], bounds[m + 1])``, added front to back from
    0, with ``j = out_index[m]`` (``m`` without an index)."""
    b = bounds.long()
    start, length = b[:-1], b[1:] - b[:-1]
    m0 = start.shape[0]
    p = perm.long()
    acc = rows.new_zeros((m0, n_payload))
    idx = torch.nonzero(length > 0)[:, 0]
    r = 0
    while idx.numel():
        acc[idx] = acc[idx] + rows[p[start[idx] + r], :n_payload]
        r += 1
        idx = idx[length[idx] > r]
    if out_index is None:
        return acc.T.contiguous()
    out = acc.new_empty((n_payload, m0))
    out[:, out_index.long()] = acc.T
    return out


def segment_reduce_rows(rows: torch.Tensor, perm: torch.Tensor, bounds: torch.Tensor,
                        n_payload: int, out_index: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Per-gaussian sums ``[n_payload, M0]`` of ``rows`` [cap, NF] f32
    (payload in columns ``0 .. n_payload - 1``) over the runs of ``perm``
    (int32) delimited by ``bounds`` [M0 + 1] int32, written at
    ``out_index`` [M0] int32 (a permutation of ``0 .. M0 - 1``) when given.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (built from ``csrc/seg_reduce.cu`` at first use) or raise. With an
    output index the kernel writes whole 64-byte rows of a row-major
    [M0, NF] buffer, and the result is its [n_payload, M0] transposed
    view."""
    if rows.device.type == "cpu":
        return segment_reduce_plain(rows, perm, bounds, n_payload, out_index)
    if rows.device.type != "cuda":
        raise ValueError(f"segment_reduce_rows: unsupported device {rows.device}")
    _check_rows("segment_reduce_rows", rows)
    for name, t in (("perm", perm), ("bounds", bounds)) + (
            (("out_index", out_index),) if out_index is not None else ()):
        _check_index(name, t, rows.device)
    if n_payload not in PAYLOADS:
        raise ValueError(f"n_payload must be one of {PAYLOADS}, got {n_payload}")
    m0 = bounds.shape[0] - 1
    if out_index is not None and out_index.shape[0] != m0:
        raise ValueError(f"out_index must have {m0} entries, got {out_index.shape[0]}")
    rows, perm, bounds = rows.contiguous(), perm.contiguous(), bounds.contiguous()
    idx = out_index.contiguous() if out_index is not None else None
    shape = (m0, NF) if idx is not None else (n_payload, m0)
    out = torch.empty(shape, dtype=torch.float32, device=rows.device)
    lib = cuda_build.library("seg_reduce")
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.seg_reduce(rows.data_ptr(), perm.data_ptr(), bounds.data_ptr(),
                            idx.data_ptr() if idx is not None else None, out.data_ptr(),
                            m0, n_payload, stream)
    cuda_build.check(lib, rc, "seg_reduce")
    cuda_build.launch_counts["seg_reduce"] += 1
    return out[:, :n_payload].T if idx is not None else out
