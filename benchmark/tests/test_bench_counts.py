"""The work the benchmark counts, on cases worked out by hand."""

import math

import numpy as np
import pytest
import torch

from benchmark import counts as C
from benchmark.models import gaussians as G
from benchmark.reference import render as R

W, H = 32, 32


def _one(opacity, scale, z=2.0, n=1, spread=0.0):
    """``n`` isotropic gaussians on the optical axis at depths z, z + 1, ..."""
    means = torch.zeros(n, 3)
    means[:, 2] = z + torch.arange(n, dtype=torch.float32) * spread
    logit = math.log(opacity / (1 - opacity))
    return dict(means=means, quats=torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
                scales=torch.full((n, 3), math.log(scale)),
                opacities=torch.full((n,), logit), sh0=torch.zeros(n, 1, 3),
                shN=torch.zeros(n, 15, 3))


def _camera(f=20.0):
    c2w = np.eye(4, dtype=np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return c2w, K


def _render(raw, c2w, K):
    rows = G.reference_rows(raw, torch.ones(raw["means"].shape[0], dtype=torch.bool))
    return R.render(rows, c2w, K, W, H, R.camera("pinhole"), G.color)


def test_needed_pairs_of_one_gaussian_are_the_pixels_it_reaches():
    """One gaussian: every pixel inside its tiles where alpha >= 1/255."""
    raw = _one(0.6, 0.15)
    c2w, K = _camera()
    r = _render(raw, c2w, K)
    # by hand: screen sigma^2 = (f s / z)^2 + 0.3, centred on the image
    s2 = (20.0 * 0.15 / 2.0) ** 2 + 0.3
    ys, xs = np.mgrid[0:H, 0:W] + 0.5
    alpha = 0.6 * np.exp(-0.5 * ((xs - W / 2) ** 2 + (ys - H / 2) ** 2) / s2)
    ext = min(3.0, math.sqrt(2 * math.log(0.6 * 255))) + 1e-3
    lo, hi = math.floor((W / 2 - ext * math.sqrt(s2)) / 16), math.ceil((W / 2 + ext * math.sqrt(s2)) / 16)
    tiles = (np.floor(xs / 16) >= lo) & (np.floor(xs / 16) < hi) & \
        (np.floor(ys / 16) >= lo) & (np.floor(ys / 16) < hi)
    assert r.needed == int(((alpha >= 1 / 255) & tiles).sum())
    assert r.visible == 1 and r.n_isect == 1  # one 32 px supertile


def test_needed_pairs_stop_where_transmittance_falls_below_1e_5():
    """Four wide, opaque layers: alpha clamps to 0.999 near the centre, so
    transmittance there is 1, 1e-3, 1e-6: two layers are needed."""
    raw = _one(0.99999, 4.0, z=2.0, n=4, spread=0.5)
    c2w, K = _camera(f=20.0)
    r = _render(raw, c2w, K)
    assert int(r.needed_px[H // 2, W // 2]) == 2
    assert float(r.alpha[H // 2, W // 2]) > 1 - 1e-8


def test_bounds_by_operations_and_by_bytes():
    assert C.fwd_bound_s(int(C.F32_FLOPS), 0, 0) == pytest.approx(26.0)
    # no pairs: reading 10 fields of each of 1e6 gaussians and writing 5
    # values of 1e6 pixels, at 3.35 TB/s
    assert C.fwd_bound_s(0, 10 ** 6, 10 ** 6) == pytest.approx(60e6 / 3.35e12)


def test_request_operations():
    assert G.OPS_PER_GAUSSIAN == 399
    assert C.view_ops(3, 100, 10, G.OPS_PER_GAUSSIAN) == 3 * 399 + 10 * 26 + 100 * 8


def test_projection_bound_by_bytes_and_by_operations():
    # SH 3: 236 bytes read per live gaussian, 10 fields written per visible one
    assert G.BYTES_PER_GAUSSIAN == 236
    assert C.project_bound_s(10 ** 6, 4 * 10 ** 5, G.OPS_PER_GAUSSIAN, G.BYTES_PER_GAUSSIAN) \
        == pytest.approx((236e6 + 16e6) / 3.35e12)
    # a model with far more operations than bytes is bound by its operations
    assert C.project_bound_s(10 ** 6, 0, 10 ** 5, 4) == pytest.approx(1e11 / 67e12)
