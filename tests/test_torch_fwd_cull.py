"""The forward kernels' per-warp cull (csrc/fwd_common.cuh ``misses_block``)
modelled in numpy f32 and held against brute force.

A warp of the forward kernels leaves out of its walk the slots that
provably composite none of its pixels: those whose conic's smallest
eigenvalue bounds sigma, over the warp's 16 x 2 PPT pixel block, above
ln(2 opa / ALPHA_MIN). Leaving out a slot that some pixel composites would
change the kernels' bits, so the cull must never fire on such a slot. This
test evaluates the bound as the kernel writes it (same f32 operations and
margins) on many random slots and blocks, pinhole and spherical (the
modular x distance), and checks every culled slot against every pixel of
its block with the kernels' own sigma and kill rule. It also checks that
the cull is not vacuous. The card's expf and __logf differ from numpy's by
a few ulp, inside the margins the bound keeps.
"""

import numpy as np
import pytest

f32 = np.float32
ALPHA_MIN = f32(1.0 / 255.0)
TS = 16


def misses_block(row, bx, by, hx, hy, wrap, width):
    """``fwd::misses_block`` in f32, vectorised over slots."""
    x, y, a, b, c, opa = (row[:, i] for i in range(6))
    dcx = x - bx
    if wrap:
        dcx = dcx - f32(width) * np.rint(dcx * f32(1.0 / width))
    dx = np.maximum(np.abs(dcx) - hx - f32(0.01), f32(0))
    dy = np.maximum(np.abs(y - by) - hy - f32(0.01), f32(0))
    mid = f32(0.5) * (a + c)
    rad = np.sqrt(f32(0.25) * (a - c) * (a - c) + b * b)
    lo = f32(0.5) * (mid - rad) - f32(1e-5) * (mid + rad)
    bound = f32(0.99) * lo * (dx * dx + dy * dy)
    with np.errstate(divide="ignore", invalid="ignore"):
        thresh = np.log(f32(2.0) / ALPHA_MIN * opa).astype(f32) + f32(0.05)
    return (lo > 0) & (bound > thresh)


def composites(row, px, py, wrap, width):
    """Whether each slot composites each pixel, as the kernels compute it:
    [slots, pixels] bool."""
    x, y, a, b, c, opa = (row[:, i, None] for i in range(6))
    dx = x - px[None]
    if wrap:
        dx = dx - f32(width) * np.rint(dx * f32(1.0 / width))
    dy = y - py[None]
    sigma = f32(0.5) * (a * dx * dx + c * dy * dy) + b * dx * dy
    with np.errstate(over="ignore", invalid="ignore"):  # indefinite conics
        alpha = opa * np.exp(-sigma)
    return ~((sigma < 0) | (alpha < ALPHA_MIN))


def _slots(rng, n, cx, cy, spread):
    """Random slot rows around (cx, cy): covariances over four orders of
    magnitude and condition numbers up to 1e4, some conics not positive
    definite, opacities down to 0."""
    ang = rng.uniform(0, np.pi, n)
    s1 = 10 ** rng.uniform(-1, 1.5, n)
    s2 = s1 * 10 ** rng.uniform(-2, 0, n)
    cos, sin = np.cos(ang), np.sin(ang)
    cov_a = cos ** 2 * s1 ** 2 + sin ** 2 * s2 ** 2
    cov_c = sin ** 2 * s1 ** 2 + cos ** 2 * s2 ** 2
    cov_b = cos * sin * (s1 ** 2 - s2 ** 2)
    det = cov_a * cov_c - cov_b ** 2
    conic = np.stack([cov_c / det, -cov_b / det, cov_a / det], 1)
    bad = rng.uniform(size=n) < 0.05
    conic[bad, 1] = -2.0 * np.sqrt(conic[bad, 0] * conic[bad, 2])  # indefinite
    opa = rng.uniform(0, 1, n)
    opa[rng.uniform(size=n) < 0.05] = 0.0
    x = cx + rng.normal(scale=spread, size=n)
    y = cy + rng.normal(scale=spread, size=n)
    return np.stack([x, y, conic[:, 0], conic[:, 1], conic[:, 2], opa], 1).astype(f32)


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("ppt", [1, 2])
def test_cull_never_drops_a_live_slot(wrap, ppt):
    rng = np.random.default_rng(11 + 2 * ppt + int(wrap))
    width = 128 if wrap else 1280
    culled_total = dead_total = 0
    for _ in range(40):
        # a warp's block: 16 columns x 2 * ppt rows of one tile
        x0 = f32(TS * rng.integers(0, width // TS))
        y0 = f32(rng.integers(0, 40) * 2 * ppt)
        rows = 2 * ppt
        px = np.tile(np.arange(TS, dtype=f32) + x0 + f32(0.5), rows)
        py = np.repeat(np.arange(rows, dtype=f32) + y0 + f32(0.5), TS)
        bx, by = x0 + f32(0.5 * TS), y0 + f32(0.5 * rows)
        hx, hy = f32(0.5 * (TS - 1)), f32(0.5 * (rows - 1))
        cx = x0 + (f32(2.0) if wrap and rng.uniform() < 0.5 else f32(8.0))  # near the seam
        row = _slots(rng, 600, cx, by, 25.0)
        if wrap:  # centres on the far side of the seam too
            row[:, 0] = np.mod(row[:, 0], f32(width))
        cull = misses_block(row, bx, by, hx, hy, wrap, width)
        live = composites(row, px, py, wrap, width).any(1)
        assert not (cull & live).any(), row[cull & live]
        culled_total += int(cull.sum())
        dead_total += int((~live).sum())
    # the cull is not vacuous: it leaves out most of the dead slots
    assert culled_total > 0.5 * dead_total
