"""Port parity: ``sfm/surf.py`` against the JAX package, on the CPU.

- ``_integral``: within 2e-7 of the integral's largest value of JAX's
  (the port sums in float64 and rounds once; JAX's f32 scan rounds as it
  goes); ``_box`` and ``_hessian_response`` exact from a shared integral
  image.
- ``surf_from_integral`` fed JAX's integral image, against
  ``extract_surf`` on the textured sphere at 128x128 (hessian threshold
  500, OpenCV's scale) with and without ``upright`` and with a budget
  whose per-layer top-K cuts: the same valid keypoints, ``xys`` exact,
  scales exact, orientations within 1e-4 rad, descriptors within 1e-4
  abs, scores within 1e-5 rel.
- ``extract_surf`` from the image: the valid sets equal except keypoints
  within 1e-6 rel of the threshold or of the K-th score (listed). The
  integral image's sums reach ~2e6 here (~1e8 at 1024x768, where the f32
  spacing is 8), so a small lobe's box sum carries the table's rounding:
  the tight bars are held from the shared integral image.
- Mirrors of ``tests/test_surf.py`` on the port: the box sums against a
  direct sum, shift repeatability, the threshold and ``upright``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_one_tpu.data.synthetic import ring_cameras
from splat_one_tpu.sfm import surf as JS
from splat_one_tpu_torch.sfm import surf as TS
from splat_one_tpu_torch.sfm.matching import match_descriptors
from test_akaze import _texture
from test_app_pipeline import textured_sphere_images
from test_torch_sfm_features import _match


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: thousands of tiny ops otherwise spin-wait to a
    crawl when several test workers each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RES, THR = 128, 500.0
CASES = [(False, 512), (True, 512), (False, 48)]  # (upright, max_keypoints)


@pytest.fixture(scope="module")
def sphere():
    c2ws, Ks = ring_cameras(4, 2.0, -0.3, 60.0, RES, RES)
    return textured_sphere_images(c2ws[:1], Ks[:1], RES, RES)[0].astype(np.float32)


@pytest.fixture(scope="module")
def jax_side(sphere):
    ii = np.array(jax.jit(lambda im: JS._integral(im * 255.0))(jnp.asarray(sphere)))
    feats = {c: [np.asarray(x) for x in JS.extract_surf(
        jnp.asarray(sphere), max_keypoints=c[1], hessian_threshold=THR, upright=c[0])]
        for c in CASES}
    return ii, feats


def _as_feats(fa):
    return type("F", (), dict(zip(("xys", "scales", "orientations", "descriptors", "scores",
                                   "valid"), fa)))


def test_integral_box_and_response(sphere, jax_side):
    ii_j = jax_side[0]
    ii_t = TS._integral(torch.as_tensor(sphere) * 255.0).numpy()
    assert ii_t.shape == ii_j.shape == (RES + 1, RES + 1)
    assert np.abs(ii_t - ii_j).max() <= 2e-7 * ii_j.max()
    ii = torch.as_tensor(ii_j)
    for box in ((-3, 4, -2, 5), (0, 9, -9, 0), (-20, 1, 3, 30)):
        a = np.asarray(JS._box(jnp.asarray(ii_j), RES, RES, *box))
        np.testing.assert_array_equal(TS._box(ii, RES, RES, *box).numpy(), a)
    for L in (3, 5, 9, 17):
        a = np.asarray(JS._hessian_response(jnp.asarray(ii_j), RES, RES, L))
        np.testing.assert_array_equal(TS._hessian_response(ii, RES, RES, L).numpy(), a)


@pytest.mark.parametrize("upright,k", CASES)
def test_from_jax_integral(sphere, jax_side, upright, k):
    fa = jax_side[1][(upright, k)]
    ft = TS.surf_from_integral(torch.as_tensor(sphere), torch.as_tensor(jax_side[0]),
                               max_keypoints=k, hessian_threshold=THR, upright=upright)
    fb = [x.numpy() for x in ft]
    assert fb[3].shape == fa[3].shape == (k, 64)
    pairs, only_a, only_b = _match(_as_feats(fa), ft)
    assert not only_a and not only_b and len(pairs) == fa[5].sum() >= (30 if k > 100 else 10)
    ia = np.array([i for i, _ in pairs])
    ib = np.array([j for _, j in pairs])
    np.testing.assert_array_equal(fb[0][ib], fa[0][ia])
    np.testing.assert_array_equal(fb[1][ib], fa[1][ia])
    d = fa[2][ia] - fb[2][ib]
    assert np.abs((d + math.pi) % (2 * math.pi) - math.pi).max() <= 1e-4
    assert np.abs(fa[3][ia] - fb[3][ib]).max() <= 1e-4
    assert np.abs(fa[4][ia] - fb[4][ib]).max() <= 1e-5 * fa[4].max()
    assert not fb[3][~fb[5]].any()
    if upright:
        assert not fb[2].any()


@pytest.mark.parametrize("upright,k", CASES)
def test_from_image(sphere, jax_side, upright, k):
    fa = jax_side[1][(upright, k)]
    ft = TS.extract_surf(torch.as_tensor(sphere), max_keypoints=k, hessian_threshold=THR,
                         upright=upright)
    fb = [x.numpy() for x in ft]
    pairs, only_a, only_b = _match(_as_feats(fa), ft)
    levels = [THR, float(fa[4][k - 1])]
    near = lambda s, idx: all(min(abs(float(s[i]) - lv) for lv in levels) <= 1e-6 * float(s[i])
                              for i in idx)
    assert near(fa[4], only_a) and near(fb[4], only_b), (only_a, only_b, levels)
    assert len(pairs) >= fa[5].sum() - 2
    ia, ib = [i for i, _ in pairs], [j for _, j in pairs]
    np.testing.assert_array_equal(fa[0][ia], fb[0][ib])
    np.testing.assert_array_equal(fa[1][ia], fb[1][ib])


# ---- mirrors of tests/test_surf.py on the port ---------------------------
def test_box_matches_direct_sum():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(40, 50)).astype(np.float32)
    ii = TS._integral(torch.as_tensor(img))
    got = TS._box(ii, 40, 50, -3, 4, -2, 5).numpy()
    pad = np.pad(img.astype(np.float64), ((3, 4), (2, 5)))
    want = np.array([[pad[y:y + 7, x:x + 7].sum() for x in range(50)] for y in range(40)])
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_shift_threshold_and_upright():
    base = _texture(0, 240)
    f1 = TS.extract_surf(torch.as_tensor(base[20:216, 20:216].copy()), max_keypoints=512)
    f2 = TS.extract_surf(torch.as_tensor(base[24:220, 16:212].copy()), max_keypoints=512)
    assert int(f1.valid.sum()) > 60
    idx, ok = match_descriptors(f1.descriptors, f2.descriptors, f1.valid, f2.valid)
    ok = ok.numpy()
    assert ok.sum() > 40
    shift = f2.xys.numpy()[idx.numpy()[ok]] - f1.xys.numpy()[ok]
    med = np.median(shift, 0)
    np.testing.assert_allclose(med, [4.0, -4.0], atol=1.0)
    img = torch.as_tensor(base[:160, :160].copy())
    n = lambda **kw: int(TS.extract_surf(img, max_keypoints=512, **kw).valid.sum())
    assert n(hessian_threshold=20000.0) < n()
    assert not TS.extract_surf(img, upright=True).orientations.numpy().any()
    small = TS.extract_surf(torch.as_tensor(base[:30, :30].copy()), max_keypoints=512)
    assert small.xys.shape == (512, 2) and not small.valid.numpy().any()
