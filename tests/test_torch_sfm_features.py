"""Port parity: ``sfm/features.py`` and ``core/cameras.py``'s ``unproject``
and ``projection_jacobian`` against the JAX package, on the CPU.

- ``unproject`` (all four models) and ``projection_jacobian`` (all four,
  and the distorted fisheye through ``jacfwd``): 1e-6 of each output's
  largest magnitude.
- The Gaussian blur (every level of both pyramids): within 1e-6 abs of
  JAX's, the two f32 convolutions summing in different orders.
- ``sift_from_pyramid`` / ``hahog_from_pyramid`` fed JAX's own blurred
  levels, against ``extract_features`` / ``extract_hahog`` on the
  textured-sphere image at 96x96: the same valid keypoints (matched at
  the same scale within half a pixel), ``xys`` within 1e-4 px, ``scales``
  exact, ``orientations`` within 1e-4 rad modulo 2 pi, descriptors within
  1e-4 abs; with a top-K that cuts the candidates, a keypoint in one set
  only must score within 1e-6 of the K-th score.
- ``extract_features`` / ``extract_hahog`` from the image: the valid
  keypoint sets are equal except keypoints within 1e-6 of the detection
  threshold or of the K-th score (listed and checked). The blur's
  rounding alone moves the subpixel refinement by up to ~3e-3 px there,
  which is why the tight bars are held from JAX's pyramid.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_one_tpu.core import cameras as jcam
from splat_one_tpu.data.synthetic import ring_cameras
from splat_one_tpu.sfm import features as JF
from splat_one_tpu_torch.core import cameras as tcam
from splat_one_tpu_torch.sfm import features as TF
from test_app_pipeline import textured_sphere_images


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the SfM runs thousands of tiny ops, which
    spin-wait themselves to a crawl when several test workers each run a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = ("pinhole", "ortho", "fisheye", "spherical")
DETECTORS = {
    "sift": (JF.extract_features, TF.extract_features, TF.sift_from_pyramid, TF.sift_sigmas(),
             "contrast_threshold", 0.01),
    "hahog": (JF.extract_hahog, TF.extract_hahog, TF.hahog_from_pyramid, TF.hahog_sigmas(),
              "peak_threshold", 1e-5),
}


@pytest.fixture(scope="module")
def sphere():
    c2ws, Ks = ring_cameras(4, 2.0, -0.3, 60.0, 96, 96)
    return textured_sphere_images(c2ws[:1], Ks[:1], 96, 96)[0]


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(a)).max(), 1e-12))


@pytest.mark.parametrize("model", MODELS)
def test_unproject_and_jacobian(model):
    rng = np.random.default_rng(0)
    W, H = 64, 48
    uv = rng.uniform([0, 0], [W, H], (50, 2)).astype(np.float32)
    K = np.array([[40.0, 0, 31.0], [0, 42.0, 25.0], [0, 0, 1]], np.float32)
    a = jcam.unproject(jnp.asarray(uv), jnp.asarray(K), W, H, model)
    b = tcam.unproject(torch.as_tensor(uv), torch.as_tensor(K), W, H, model)
    assert _rel(a, b.numpy()) <= 1e-6
    p = rng.normal(size=(50, 3)).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2]) + 0.5
    dists = [None, np.array([0.1, -0.02, 0.003, 0.0], np.float32)] if model == "fisheye" else [None]
    for dist in dists:
        ja = jcam.projection_jacobian(jnp.asarray(p), jnp.asarray(K), W, H, model,
                                      None if dist is None else jnp.asarray(dist))
        tb = tcam.projection_jacobian(torch.as_tensor(p), torch.as_tensor(K), W, H, model,
                                      None if dist is None else torch.as_tensor(dist))
        assert tb.shape == (50, 2, 3)
        assert _rel(ja, tb.numpy()) <= 1e-6, (model, dist)


def test_blur_matches_jax(sphere):
    for s in sorted(set(TF.sift_sigmas() + TF.hahog_sigmas())):
        a = np.asarray(JF._gaussian_blur(jnp.asarray(sphere), s))
        b = TF._gaussian_blur(torch.as_tensor(sphere), s).numpy()
        assert np.abs(a - b).max() <= 1e-6, s
    # the blur's scope switches TF32 off for the call and restores the flag
    before = torch.backends.cudnn.allow_tf32
    with TF._f32_conv():
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.allow_tf32 == before


def _match(fa, fb):
    """Pairs (i, j) of valid keypoints at the same scale within half a
    pixel (keypoints of one level are >= 1 px apart); the unmatched of
    each side."""
    va, vb = np.flatnonzero(np.asarray(fa.valid)), np.flatnonzero(fb.valid.numpy())
    xa, xb = np.asarray(fa.xys), fb.xys.numpy()
    sa, sb = np.asarray(fa.scales), fb.scales.numpy()
    pairs, used = [], set()
    for i in va:
        same = vb[(sb[vb] == sa[i]) & (np.abs(xb[vb] - xa[i]).max(-1) < 0.5)]
        if len(same):
            pairs.append((i, int(same[0])))
            used.add(int(same[0]))
    only_a = sorted(set(va) - {i for i, _ in pairs})
    only_b = sorted(set(vb.tolist()) - used)
    return pairs, only_a, only_b


def _near(scores, idx, levels):
    return all(min(abs(float(scores[i]) - lv) for lv in levels) <= 1e-6 for i in idx)


def _check_close(fa, fb, pairs):
    ia = np.array([i for i, _ in pairs])
    ib = np.array([j for _, j in pairs])
    assert np.abs(np.asarray(fa.xys)[ia] - fb.xys.numpy()[ib]).max() <= 1e-4
    assert np.array_equal(np.asarray(fa.scales)[ia], fb.scales.numpy()[ib])
    d = np.asarray(fa.orientations)[ia] - fb.orientations.numpy()[ib]
    assert np.abs((d + math.pi) % (2 * math.pi) - math.pi).max() <= 1e-4
    assert np.abs(np.asarray(fa.descriptors)[ia] - fb.descriptors.numpy()[ib]).max() <= 1e-4


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_detector_from_jax_pyramid(sphere, name):
    jf, _, from_pyr, sigmas, thr_name, thr = DETECTORS[name]
    pyr = jax.jit(lambda im: [JF._gaussian_blur(im, s) for s in sigmas])(jnp.asarray(sphere))
    levels = [torch.as_tensor(np.array(p)) for p in pyr]
    for k in (256, 12):
        fa = jf(jnp.asarray(sphere), max_keypoints=k, **{thr_name: thr})
        fb = from_pyr(levels, max_keypoints=k, **{thr_name: thr})
        assert fb.xys.shape == tuple(fa.xys.shape) and fb.descriptors.shape == (k, 128)
        pairs, only_a, only_b = _match(fa, fb)
        assert len(pairs) >= (10 if k == 256 else k - 2), (name, k, len(pairs))
        kth = float(np.asarray(fa.scores)[k - 1])
        assert _near(np.asarray(fa.scores), only_a, [kth]), (only_a, kth)
        assert _near(fb.scores.numpy(), only_b, [kth]), (only_b, kth)
        _check_close(fa, fb, pairs)


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_detector_from_image(sphere, name):
    jf, tf, _, _, thr_name, thr = DETECTORS[name]
    for k in (256, 12):
        fa = jf(jnp.asarray(sphere), max_keypoints=k, **{thr_name: thr})
        fb = tf(torch.as_tensor(sphere), max_keypoints=k, **{thr_name: thr})
        pairs, only_a, only_b = _match(fa, fb)
        levels = [thr, float(np.asarray(fa.scores)[k - 1])]
        assert _near(np.asarray(fa.scores), only_a, levels), (only_a, levels)
        assert _near(fb.scores.numpy(), only_b, levels), (only_b, levels)
        assert len(pairs) >= (10 if k == 256 else k - 2)
        ia, ib = [i for i, _ in pairs], [j for _, j in pairs]
        assert np.array_equal(np.asarray(fa.scales)[ia], fb.scales.numpy()[ib])
        assert np.abs(np.asarray(fa.xys)[ia] - fb.xys.numpy()[ib]).max() < 0.05
        assert not fb.descriptors.numpy()[~fb.valid.numpy()].any()


def test_coordinates_and_grayscale():
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 100, (20, 2)).astype(np.float32)
    a = np.asarray(JF.normalized_image_coordinates(jnp.asarray(xy), 100, 60))
    b = TF.normalized_image_coordinates(torch.as_tensor(xy), 100, 60).numpy()
    assert np.abs(a - b).max() <= 1e-7
    np.testing.assert_allclose(TF.denormalized_image_coordinates(b, 100, 60), xy, atol=1e-4)
    np.testing.assert_array_equal(TF.denormalized_image_coordinates(b, 100, 60),
                                  JF.denormalized_image_coordinates(b, 100, 60))
    for img in (rng.integers(0, 255, (8, 9, 3)).astype(np.uint8),
                rng.uniform(size=(8, 9, 3)).astype(np.float32), rng.uniform(size=(8, 9))):
        np.testing.assert_array_equal(TF.to_grayscale(img), JF.to_grayscale(img))
