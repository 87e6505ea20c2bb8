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
per-pair arithmetic.
"""

from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

OPS_PAIR_FWD = 26

# Per live gaussian, one view: the rotation from the quaternion (normalise
# 12, matrix 28), the 3D covariance (scale 9, M M^T 45), the camera-frame
# mean (18), the Jacobian (12), T = J R (30), T Sigma T^T (48), the conic,
# determinant and radius (22), the membership extents and culling (24),
# the view direction (14), the 16 SH basis values (35) and the colour
# (96 + 6).
OPS_PROJECT_FWD = 12 + 28 + 9 + 45 + 18 + 12 + 30 + 48 + 22 + 24 + 14 + 35 + 102
# Per pixel of a served frame: expected depth, clamp and the uint8 scale.
OPS_ASSEMBLE_PER_PIXEL = 8

FIELDS = 10  # per gaussian on screen: uv 2, conic 3, opacity 1, colour 3, depth 1
PIXEL_OUT = 5  # rgb 3, alpha 1, depth 1


def view_ops(n_alive: int, pixels: int, pairs: int) -> float:
    return n_alive * OPS_PROJECT_FWD + pairs * OPS_PAIR_FWD + pixels * OPS_ASSEMBLE_PER_PIXEL


def fwd_bound_s(pairs: int, visible: int, pixels: int) -> float:
    """Least time of the forward compositing: its operations, or reading
    each on-screen gaussian's fields once and writing each pixel once."""
    ops = pairs * OPS_PAIR_FWD / F32_FLOPS
    nbytes = 4 * (visible * FIELDS + pixels * PIXEL_OUT)
    return max(ops, nbytes / HBM_BYTES_PER_S)
