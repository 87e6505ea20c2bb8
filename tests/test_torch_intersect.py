"""Port parity: the gen-1 per-tile intersection builder against the JAX package.

Both builders get the same projected gaussians (the JAX projection, as
numpy), so the layout is held bit for bit: ``slot_rank``, ``rank_src``,
``tile_starts``, ``rank_perm``, ``rank_bounds``, ``n_isect``, ``n_slots``
and ``overflow`` exactly equal on pinhole, spherical (azimuth wrap) and
edge-partial (40x24) scenes and on a case forced to overflow (the
``tile_starts`` clamp included). ``pack_fields`` rows are equal.
``gather_reduction`` sums exactly with the segmented reduce where the JAX
package takes a cumsum and boundary differences: within 1e-6 of each
column's max on the backward's own gradient rows.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splat_one_tpu.ops import intersect as jis
from splat_one_tpu.ops import tile_raster as jtr
from splat_one_tpu_torch.ops import intersect as tis

from test_torch_stream_isect import _projections
from test_torch_stream_raster import CASES

_jbuild = jax.jit(jis.build_intersections, static_argnums=(1, 2, 3, 4),
                  static_argnames=("camera_model",))


def _caps(case, pj, w, h):
    C, N = pj.depths.shape
    n_tiles = (-(-w // 16)) * (-(-h // 16))
    if case == "overflow":
        return (jis.IsectCaps(exp_cap=512, align_cap=512 + 128 * 2),
                tis.IsectCaps(exp_cap=512, align_cap=512 + 128 * 2))
    return jis.IsectCaps.choose(N, C, n_tiles), tis.IsectCaps.choose(N, C, n_tiles)


@pytest.mark.parametrize("case", sorted(CASES) + ["overflow"])
def test_tile_layout_exact(case):
    kw, model = CASES.get(case, CASES["pinhole"])
    pj, pt, w, h = _projections(kw, model)
    caps_j, caps_t = _caps(case, pj, w, h)
    assert (caps_t.exp_cap, caps_t.align_cap, caps_t.chunk) == (
        caps_j.exp_cap, caps_j.align_cap, caps_j.chunk)
    ij = _jbuild(pj, w, h, 16, caps_j, camera_model=model)
    it = tis.build_intersections(pt, w, h, 16, caps_t, camera_model=model)
    for f in ij._fields:
        np.testing.assert_array_equal(getattr(it, f).numpy(), np.asarray(getattr(ij, f)),
                                      err_msg=f)
    assert bool(it.overflow) == (case == "overflow")
    assert int(it.n_isect) > 0
    starts = it.tile_starts.numpy()
    assert (starts % 128 == 0).all() and starts[-1] <= caps_t.align_cap

    # the field table, on the same projection
    args = [pj.means2d, pj.conics, pj.colors, pj.opacities, pj.depths]
    packed_j = np.asarray(jis.pack_fields(*args, ij)).T
    packed_t = tis.pack_fields(*(torch.as_tensor(np.array(a)) for a in args), it)
    np.testing.assert_array_equal(packed_t.numpy(), packed_j)


def test_choose_and_spans():
    for args in ((1000, 1, 3600), (1_048_576, 1, 3600), (17, 3, 12)):
        j = jis.IsectCaps.choose(*args)
        t = tis.IsectCaps.choose(*args)
        assert (t.exp_cap, t.align_cap, t.chunk) == (j.exp_cap, j.align_cap, j.chunk)
    # IsectCaps.choose at 1M / 1280x720: the caps the chip run uses
    t = tis.IsectCaps.choose(1_000_000, 1, 80 * 45)
    assert (t.exp_cap, t.align_cap) == (8_000_000, 8_460_800)
    rng = np.random.default_rng(4)
    uv = rng.uniform(-40, 120, (300, 2)).astype(np.float32)
    rx, ry = (rng.uniform(0, 30, 300).astype(np.float32) for _ in range(2))
    valid = rng.uniform(size=300) < 0.8
    for wrap in (False, True):
        got = tis.tile_spans(*(torch.as_tensor(x) for x in (uv, rx, ry, valid)),
                             100, 60, 16, wrap)
        want = jis.tile_spans(*(jnp.asarray(x) for x in (uv, rx, ry, valid)),
                              100, 60, 16, wrap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", ["pinhole", "spherical"])
def test_gather_reduction(case):
    """On the JAX backward's gradient rows for this layout (interpret
    mode), against JAX's cumsum + boundary-difference reduction."""
    kw, model = CASES[case]
    pj, pt, w, h = _projections(kw, model)
    caps_j, caps_t = _caps(case, pj, w, h)
    C, N = pj.depths.shape
    ij = _jbuild(pj, w, h, 16, caps_j, camera_model=model)
    it = tis.build_intersections(pt, w, h, 16, caps_t, camera_model=model)
    cfg = jtr.RasterCfg(width=w, height=h, tile_size=16, num_cameras=C,
                        num_gaussians=N, chunk=128, align_cap=caps_j.align_cap,
                        wrap_x=(model == "spherical"))
    packed = jis.pack_fields(pj.means2d, pj.conics, pj.colors, pj.opacities,
                             pj.depths, ij)
    out = jtr._fwd_call(cfg, ij.tile_starts, packed)
    gout = np.random.default_rng(6).normal(size=out.shape).astype(np.float32)
    pg = jtr._bwd_call(cfg, ij.tile_starts, packed, out, jnp.asarray(gout))
    rows = np.array(pg).T[:, :tis.N_GROWS]
    got = tis.gather_reduction(torch.as_tensor(np.array(pg).T.copy()), it, C * N).numpy()
    assert got.shape == (tis.N_GROWS, C * N)
    # exact sums in float64, straight from the slot -> gaussian map
    slot_rank = it.slot_rank.numpy()
    live = slot_rank < C * N
    exact = np.zeros((C * N, tis.N_GROWS))
    np.add.at(exact, it.rank_src.numpy()[slot_rank[live]], rows[live].astype(np.float64))
    scale = np.abs(exact).max(0)
    assert (scale > 0).all()
    assert (np.abs(got.T - exact).max(0) <= 1e-6 * scale).all()
    # JAX's cumsum + boundary difference carries the running sum's rounding:
    # ~1e-6 of each column's max on the signed columns, ~3e-5 on the
    # |d means2d| columns (all positive, so the running sum only grows);
    # held to the 5e-4 gradient bar
    want = np.asarray(jis.gather_reduction(pg, ij, C * N))[:, :tis.N_GROWS]
    assert (np.abs(got.T - want).max(0) <= 5e-4 * scale).all()


def test_tile_sharding_is_refused():
    """A tile slab needs both its start and its size (one alone is
    refused); a slab's layout holds the whole build's tiles of its range
    (the slab path against JAX's: tests/test_torch_slab.py)."""
    _, pt, w, h = _projections(*CASES["pinhole"])
    caps = tis.IsectCaps.choose(600, 2, 12)
    with pytest.raises(ValueError):
        tis.build_intersections(pt, w, h, 16, caps, tile_lo=3)
    with pytest.raises(ValueError):
        tis.build_intersections(pt, w, h, 16, caps, n_tiles_local=12)
    full = tis.build_intersections(pt, w, h, 16, caps)
    slab = tis.build_intersections(pt, w, h, 16, caps, tile_lo=5, n_tiles_local=12)
    fs, ss = full.tile_starts.long(), slab.tile_starts.long()
    for t in range(12):
        assert torch.equal(slab.slot_rank[ss[t]:ss[t + 1]],
                           full.slot_rank[fs[5 + t]:fs[6 + t]]), t
