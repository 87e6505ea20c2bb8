"""Port parity: ``sfm/akaze.py`` against the JAX package, on the CPU.

- ``_fed_taus`` exact (host float64, the same code); ``_kcontrast``
  within 1e-6 rel (the quantile selected by a sort, interpolated as
  ``jnp.nanquantile``); ``_scharr`` at steps 1-3, ``_diffusion_step``
  and ``_downsample2`` within 1e-6 abs.
- ``akaze_evolution`` against the same loop over JAX's helpers (jitted):
  every level within 1e-5 abs, anisotropic and isotropic.
- ``akaze_from_evolution`` fed JAX's levels, against ``extract_akaze``
  on the textured sphere at 128x128 for MSURF, MLDB (``descriptor_size``
  256, ``descriptor_channels`` 2), MLDB_UPRIGHT (every bit, 3 channels)
  and isotropic MSURF_UPRIGHT, with a budget that keeps every candidate
  and (MSURF) one whose per-level top-K cuts them: the same valid keypoints,
  ``xys`` within 1e-4 px, scales exact, orientations within 1e-4 rad,
  descriptors within 1e-4 abs (the M-LDB bits equal).
- ``extract_akaze`` from the image: the valid sets equal except
  keypoints within 1e-6 of the threshold or of the K-th score (listed),
  the common ones' ``xys`` within 0.05 px and scales exact.
- Mirrors of ``tests/test_akaze.py`` on the port: shift repeatability,
  rotation invariance, the options honoured.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_one_tpu.data.synthetic import ring_cameras
from splat_one_tpu.sfm import akaze as JA
from splat_one_tpu_torch.sfm import akaze as TA
from splat_one_tpu_torch.sfm.matching import match_descriptors
from test_akaze import _texture
from test_app_pipeline import textured_sphere_images
from test_torch_sfm_features import _match, _near


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: thousands of tiny ops otherwise spin-wait to a
    crawl when several test workers each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RES = 128
CONFIGS = {
    "msurf": dict(descriptor="MSURF"),
    "mldb": dict(descriptor="MLDB", descriptor_size=256, descriptor_channels=2),
    "mldb_upright": dict(descriptor="MLDB_UPRIGHT", descriptor_channels=3),
    "isotropic": dict(descriptor="MSURF_UPRIGHT", isotropic=True),
}
BUDGETS = (512, 48)
# (config, budget) pairs compared with JAX: the cutting budget on MSURF only
CASES = [(c, 512) for c in sorted(CONFIGS)] + [("msurf", 48)]


@pytest.fixture(scope="module")
def sphere():
    c2ws, Ks = ring_cameras(4, 2.0, -0.3, 60.0, RES, RES)
    return textured_sphere_images(c2ws[:1], Ks[:1], RES, RES)[0].astype(np.float32)


def _jax_evolution(image, omax=4, nsub=4, pct=0.7, isotropic=False):
    """``extract_akaze``'s scale-space loop over the JAX package's helpers."""
    kc = JA._kcontrast(image, pct)
    L = JA._gaussian_blur(image, JA._SIGMA0)
    octaves, t_local = [], 0.5 * JA._SIGMA0 ** 2
    for o in range(omax):
        if min(L.shape) < 40:
            break
        levels = []
        for j in range(nsub):
            s_loc = JA._SIGMA0 * 2.0 ** (o + j / nsub) / float(2 ** o)
            t_target = 0.5 * s_loc * s_loc
            taus = JA._fed_taus(t_target - t_local)
            if len(taus):
                if isotropic:
                    g = jnp.ones_like(L)
                else:
                    Ls = JA._gaussian_blur(L, 1.0)
                    gx, gy = JA._scharr(Ls, 1, 1), JA._scharr(Ls, 0, 1)
                    g = 1.0 / (1.0 + (gx * gx + gy * gy) / (kc * kc))
                for tau in taus:
                    L = JA._diffusion_step(L, g, float(tau))
            t_local = t_target
            levels.append(L)
        octaves.append(levels)
        if o + 1 < omax:
            L = JA._downsample2(L)
            t_local = t_local / 4.0
    return octaves


@pytest.fixture(scope="module")
def jax_side(sphere):
    """JAX's levels (both diffusions) and features (every case), once."""
    lv = {iso: [[np.asarray(x) for x in o] for o in jax.jit(
        lambda im, iso=iso: _jax_evolution(im, isotropic=iso))(jnp.asarray(sphere))]
        for iso in (False, True)}
    feats = {(c, k): [np.asarray(x) for x in JA.extract_akaze(
        jnp.asarray(sphere), max_keypoints=k, **kw)]
        for c, k in CASES for kw in [CONFIGS[c]]}
    return lv, feats


def _levels(octaves_np, nsub=4):
    return [[(torch.tensor(L), JA._SIGMA0 * 2.0 ** (o + j / nsub) / float(2 ** o))
             for j, L in enumerate(lv)] for o, lv in enumerate(octaves_np)]


def _as_feats(fa):
    return type("F", (), dict(zip(("xys", "scales", "orientations", "descriptors", "scores",
                                   "valid"), fa)))


def test_helpers_match_jax(sphere):
    for T in (0.0, 0.3, 1.7, 12.5):
        np.testing.assert_array_equal(TA._fed_taus(T), JA._fed_taus(T))
    img = torch.as_tensor(sphere)
    for pct in (0.7, 0.3):
        kj = float(JA._kcontrast(jnp.asarray(sphere), pct))
        assert abs(float(TA._kcontrast(img, pct)) - kj) <= 1e-6 * kj
    for axis in (0, 1):
        for step in (1, 2, 3):
            a = np.asarray(JA._scharr(jnp.asarray(sphere), axis, step))
            assert np.abs(TA._scharr(img, axis, step).numpy() - a).max() <= 1e-6
    g = np.random.default_rng(0).uniform(0.2, 1.0, sphere.shape).astype(np.float32)
    a = np.asarray(JA._diffusion_step(jnp.asarray(sphere), jnp.asarray(g), 0.21))
    assert np.abs(TA._diffusion_step(img, torch.as_tensor(g), 0.21).numpy() - a).max() <= 1e-6
    a = np.asarray(JA._downsample2(jnp.asarray(sphere[:, :-1])))
    assert np.abs(TA._downsample2(img[:, :-1]).numpy() - a).max() <= 1e-6


@pytest.mark.parametrize("isotropic", [False, True])
def test_evolution_matches_jax(sphere, jax_side, isotropic):
    want = jax_side[0][isotropic]
    got = TA.akaze_evolution(torch.as_tensor(sphere), isotropic=isotropic)
    assert [len(o) for o in got] == [len(o) for o in want] == [4, 4]
    for o, (go, wo) in enumerate(zip(got, want)):
        for j, ((L, s), W) in enumerate(zip(go, wo)):
            assert s == JA._SIGMA0 * 2.0 ** (o + j / 4) / float(2 ** o)
            assert np.abs(L.numpy() - W).max() <= 1e-5, (o, j)


def _check_close(fa, fb, pairs, tol):
    ia = np.array([i for i, _ in pairs])
    ib = np.array([j for _, j in pairs])
    assert np.abs(fa[0][ia] - fb[0][ib]).max() <= tol
    np.testing.assert_array_equal(fa[1][ia], fb[1][ib])
    d = fa[2][ia] - fb[2][ib]
    assert np.abs((d + math.pi) % (2 * math.pi) - math.pi).max() <= 1e-4
    assert np.abs(fa[3][ia] - fb[3][ib]).max() <= 1e-4


@pytest.mark.parametrize("config,k", CASES)
def test_from_jax_evolution(jax_side, config, k):
    kw = dict(CONFIGS[config])
    iso = kw.pop("isotropic", False)
    fa = jax_side[1][(config, k)]
    ft = TA.akaze_from_evolution(_levels(jax_side[0][iso]), max_keypoints=k, **kw)
    fb = [x.numpy() for x in ft]
    assert fb[3].shape == fa[3].shape and fb[0].shape == (k, 2)
    pairs, only_a, only_b = _match(_as_feats(fa), ft)
    assert not only_a and not only_b and len(pairs) == fa[5].sum() >= (10 if k > 100 else 5), (only_a, only_b)
    _check_close(fa, fb, pairs, 1e-4)
    assert not fb[3][~fb[5]].any()


@pytest.mark.parametrize("config,k", CASES)
def test_from_image(sphere, jax_side, config, k):
    kw = dict(CONFIGS[config])
    fa = jax_side[1][(config, k)]
    ft = TA.extract_akaze(torch.as_tensor(sphere), max_keypoints=k, **kw)
    fb = [x.numpy() for x in ft]
    pairs, only_a, only_b = _match(_as_feats(fa), ft)
    # a keypoint in one set only: at the threshold or the K-th score
    levels = [0.001, float(fa[4][k - 1])]
    assert _near(fa[4], only_a, levels) and _near(fb[4], only_b, levels), (only_a, only_b)
    assert len(pairs) >= fa[5].sum() - 2
    ia, ib = [i for i, _ in pairs], [j for _, j in pairs]
    assert np.abs(fa[0][ia] - fb[0][ib]).max() < 0.05
    np.testing.assert_array_equal(fa[1][ia], fb[1][ib])


# ---- mirrors of tests/test_akaze.py on the port --------------------------
def test_shift_repeatability_and_rotation():
    base = _texture(0, 240)
    f1 = TA.extract_akaze(torch.as_tensor(base[20:216, 20:216].copy()), max_keypoints=512)
    f2 = TA.extract_akaze(torch.as_tensor(base[24:220, 16:212].copy()), max_keypoints=512)
    assert int(f1.valid.sum()) > 60
    idx, ok = match_descriptors(f1.descriptors, f2.descriptors, f1.valid, f2.valid)
    ok = ok.numpy()
    assert ok.sum() > 40
    shift = f2.xys.numpy()[idx.numpy()[ok]] - f1.xys.numpy()[ok]
    med = np.median(shift, 0)
    np.testing.assert_allclose(med, [4.0, -4.0], atol=1.0)
    assert (np.abs(shift - med) < 1.5).all(1).mean() > 0.9
    img1 = base[20:216, 20:216].copy()
    f3 = TA.extract_akaze(torch.as_tensor(np.rot90(img1).copy()), max_keypoints=512)
    idx3, ok3 = match_descriptors(f1.descriptors, f3.descriptors, f1.valid, f3.valid)
    ok3 = ok3.numpy()
    assert ok3.sum() > 30
    xyA, xyB = f1.xys.numpy()[ok3], f3.xys.numpy()[idx3.numpy()[ok3]]
    pred = np.stack([xyA[:, 1], img1.shape[1] - 1 - xyA[:, 0]], -1)
    assert (np.linalg.norm(xyB - pred, axis=-1) < 3.0).mean() > 0.7


def test_options_honoured(sphere):
    img = torch.as_tensor(sphere)
    n = lambda **kw: int(TA.extract_akaze(img, max_keypoints=512, **kw).valid.sum())
    assert n(dthreshold=0.01) < n()
    f = TA.extract_akaze(img, max_keypoints=256, descriptor="MLDB", descriptor_size=100,
                         descriptor_channels=1)
    assert f.descriptors.shape == (256, 100)
    assert TA.extract_akaze(img, max_keypoints=256, descriptor="MLDB").descriptors.shape == (256, 486)
    assert not TA.extract_akaze(img, descriptor="MSURF_UPRIGHT").orientations.numpy().any()
    small = TA.extract_akaze(torch.as_tensor(sphere[:50, :50].copy()), max_keypoints=512, omax=2)
    assert small.xys.shape == (512, 2)
    with pytest.raises(ValueError):
        TA.extract_akaze(img, descriptor="BRISK")
