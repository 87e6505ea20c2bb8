"""The work a 2DGS view needs, the same whatever implements it: the
surfel model's counts (``models/surfels.py``: ``OPS_PER_GAUSSIAN``,
``BYTES_PER_GAUSSIAN``, ``OPS_PER_PAIR``, ``FIELDS``) over
``benchmark.counts``' peaks; ``benchmark.counts`` holds the 3D gaussians'
(26 operations a pair, 10 fields)."""

from __future__ import annotations

from benchmark import counts as C


def view_ops(n_alive: int, pixels: int, pairs: int, model) -> float:
    """A view's operations: the projection of every live surfel, the
    needed pairs' alpha and compositing, the frame's assembly."""
    return (n_alive * model.OPS_PER_GAUSSIAN + pairs * model.OPS_PER_PAIR
            + pixels * C.OPS_ASSEMBLE_PER_PIXEL)


def project_bound_s(n_alive: int, visible: int, model) -> float:
    """Least time of the surfel projection: its operations, or reading
    each live surfel's parameters once and writing each on-screen surfel's
    fields once."""
    ops = n_alive * model.OPS_PER_GAUSSIAN / C.F32_FLOPS
    nbytes = n_alive * model.BYTES_PER_GAUSSIAN + 4 * visible * model.FIELDS
    return max(ops, nbytes / C.HBM_BYTES_PER_S)


def fwd_bound_s(pairs: int, visible: int, pixels: int, model) -> float:
    """Least time of the surfel forward: its operations, or reading each
    on-screen surfel's fields once and writing each pixel once."""
    ops = pairs * model.OPS_PER_PAIR / C.F32_FLOPS
    nbytes = 4 * (visible * model.FIELDS + pixels * C.PIXEL_OUT)
    return max(ops, nbytes / C.HBM_BYTES_PER_S)
