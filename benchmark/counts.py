"""Peaks of the card and the work the benchmark counts, the same whatever
implements it.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit; the same
constants as the repo's bring-up script): 67 TFLOP/s in float32 outside the
tensor cores (the step has no tensor-core work), 3.35 TB/s of HBM3.

Operations are float32 arithmetic, ``exp`` and ``sqrt`` counted as one.
A (pixel, gaussian) pair is one the model needs (``reference.render``'s
``needed``): 26 operations in the forward (the offset, the quadratic
form, the exponential, the clamps and kill tests, the weight, three
colours and the depth accumulated, the transmittance update), as the
repo's bring-up script derives them from the compositing kernel's
per-pair arithmetic. The work of each live gaussian is its model's
(``models/<model>.py``: ``OPS_PER_GAUSSIAN``, ``BYTES_PER_GAUSSIAN``).
"""

from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

OPS_PAIR_FWD = 26

# Per pixel of a served frame: expected depth, clamp and the uint8 scale.
OPS_ASSEMBLE_PER_PIXEL = 8

FIELDS = 10  # per gaussian on screen: uv 2, conic 3, opacity 1, colour 3, depth 1
PIXEL_OUT = 5  # rgb 3, alpha 1, depth 1


def view_ops(n_alive: int, pixels: int, pairs: int, ops_per_gaussian: int) -> float:
    return n_alive * ops_per_gaussian + pairs * OPS_PAIR_FWD + pixels * OPS_ASSEMBLE_PER_PIXEL


def project_bound_s(n_alive: int, visible: int, ops_per_gaussian: int,
                    bytes_per_gaussian: int) -> float:
    """Least time of the projection: its operations, or reading each live
    gaussian's parameters once and writing each on-screen gaussian's
    fields once."""
    ops = n_alive * ops_per_gaussian / F32_FLOPS
    nbytes = n_alive * bytes_per_gaussian + 4 * visible * FIELDS
    return max(ops, nbytes / HBM_BYTES_PER_S)


def fwd_bound_s(pairs: int, visible: int, pixels: int) -> float:
    """Least time of the forward compositing: its operations, or reading
    each on-screen gaussian's fields once and writing each pixel once."""
    ops = pairs * OPS_PAIR_FWD / F32_FLOPS
    nbytes = 4 * (visible * FIELDS + pixels * PIXEL_OUT)
    return max(ops, nbytes / HBM_BYTES_PER_S)
