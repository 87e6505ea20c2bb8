"""Port parity: the supertile-stream builder against the JAX package.

Both builders get the same projected gaussians (the JAX projection, as
numpy), so the layout is held bit for bit: ``sorted_g``, ``st_starts``,
``st_starts_al``, ``n_isect``, ``n_slots`` and ``overflow`` exactly equal
on pinhole, spherical and edge-partial scenes and on a case forced to
overflow. ``pack_stream`` rows are equal; ``build_fields`` within 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splat_one_tpu.ops import projection as jp
from splat_one_tpu.ops import seg_broadcast as jsb
from splat_one_tpu.ops import stream_isect as jsi
from splat_one_tpu_torch.ops import projection as tp
from splat_one_tpu_torch.ops import seg_broadcast as tsb
from splat_one_tpu_torch.ops import stream_isect as tsi

from test_torch_stream_raster import CASES, _scene


_jbuild = jax.jit(jsi.build_stream_intersections, static_argnums=(1, 2, 3, 4),
                  static_argnames=("camera_model",))


def _projections(kw, model):
    means, quats, scales, opac, colors, viewmats, Ks, w, h = _scene(**kw)
    pj = jax.jit(jp.project_gaussians, static_argnums=(6, 7),
                 static_argnames=("camera_model",))(
        *map(jnp.asarray, (means, quats, scales, opac, viewmats, Ks)), w, h,
        colors=jnp.asarray(colors), camera_model=model)
    pt = tp.Projected(*(torch.as_tensor(np.array(x)) for x in pj))
    return pj, pt, w, h


def _assert_layout_equal(it, ij):
    for f in ij._fields:
        a, b = getattr(it, f).numpy(), np.asarray(getattr(ij, f))
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES) + ["overflow"])
def test_stream_layout_exact(case):
    kw, model = CASES.get(case, CASES["pinhole"])
    pj, pt, w, h = _projections(kw, model)
    C, N = pj.depths.shape
    _, _, sw, sh = jsi.supertile_grid(w, h, 16)
    if case == "overflow":
        caps_j = jsi.StreamCaps(exp_cap=512, n_supertiles=C * sw * sh)
        caps_t = tsi.StreamCaps(exp_cap=512, n_supertiles=C * sw * sh)
    else:
        caps_j = jsi.StreamCaps.choose(N, C, C * sw * sh)
        caps_t = tsi.StreamCaps.choose(N, C, C * sw * sh)
    assert (caps_t.exp_cap, caps_t.pad_cap, caps_t.packed_rows) == (
        caps_j.exp_cap, caps_j.pad_cap, caps_j.packed_rows)
    ij = _jbuild(pj, w, h, 16, caps_j, camera_model=model)
    it = tsi.build_stream_intersections(pt, w, h, 16, caps_t, camera_model=model)
    _assert_layout_equal(it, ij)
    assert bool(it.overflow) == (case == "overflow")
    assert int(it.n_isect) > 0

    fj = jsi.build_fields(pj)
    ft = tsi.build_fields(pt)
    err = np.abs(ft.numpy() - np.asarray(fj)).max()
    assert err <= 1e-6 * np.abs(np.asarray(fj)).max()
    # the row gather itself, on identical fields
    packed_t = tsi.pack_stream(torch.as_tensor(np.array(fj)), it, caps_t)
    np.testing.assert_array_equal(packed_t.numpy(),
                                  np.asarray(jsi.pack_stream(fj, ij, caps_j)))
    spans_t = tsi.parent_spans(pt, w, h, 16, 2, model)
    spans_j = jsi.parent_spans(pj, w, h, 16, 2, model)
    for a, b in zip(spans_t, spans_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_choose_observed():
    for n in (0, 5000, 123457):
        t = tsi.StreamCaps.choose_observed(n, 40)
        j = jsi.StreamCaps.choose_observed(n, 40)
        assert (t.exp_cap, t.pad_cap, t.packed_rows) == (j.exp_cap, j.pad_cap, j.packed_rows)
    assert tsi.supertile_grid(1280, 720, 16) == jsi.supertile_grid(1280, 720, 16)


def test_expand_meta_matches_xla_path():
    """The marker index_add_ + cumsum + gather expansion, on ragged runs
    with zero-count parents and slots beyond the total."""
    rng = np.random.default_rng(0)
    mp, exp_cap = 700, 4096
    counts = rng.integers(1, 9, size=mp).astype(np.int32)
    counts[rng.uniform(size=mp) < 0.3] = 0
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    sx0 = rng.integers(0, 40, mp).astype(np.int32)
    sy0 = rng.integers(0, 23, mp).astype(np.int32)
    span = rng.integers(1, 6, mp).astype(np.int32)
    ka = rng.integers(0, 1000, mp).astype(np.int32)
    depth = (rng.normal(size=mp) * 37.3 + 5).astype(np.float32)
    out_j = jsb.expand_meta_streamed(
        *map(jnp.asarray, (sx0, sy0, span, ka, offsets, depth, counts)),
        exp_cap, force_path="xla")
    out_t = tsb.default_expansion(
        *(torch.as_tensor(x).long() for x in (sx0, sy0, span, ka, offsets)),
        torch.as_tensor(depth), exp_cap)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
