"""Port parity: ``sfm/orb.py`` (ORB and the Harris tier) against the JAX
package, on the CPU.

- ``_brief_pairs``: the same array as JAX's (numpy ``default_rng(7)``).
- ``_fast_score``: the FAST-9 corner mask equal, the Harris response
  within 1e-6 of its largest magnitude.
- ``extract_orb`` / ``extract_harris`` on the textured sphere at 128x128,
  with a top-K that keeps every candidate and one that cuts them: the
  valid keypoint sets equal, except keypoints whose score is within 1e-6
  rel of the K-th score (listed and checked); over the common ones
  ``xys`` and ``scales`` exact, orientations within 1e-5 rad, scores
  within 1e-6 rel, and every BRIEF bit equal except where the port's two
  samples are within 1e-6 of each other (a comparison rounding decides).
  The invalid rows are compared too: both follow ``jax.lax.top_k``'s
  order.
- Mirrors of ``tests/test_orb_features.py`` on the port: FAST fires on
  square corners, descriptors match across a shift and a 90-degree
  rotation, descriptors are unit-norm +/-1/16, levels map to level 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_one_tpu.data.synthetic import ring_cameras
from splat_one_tpu.sfm import orb as JO
from splat_one_tpu_torch.sfm import orb as TO
from splat_one_tpu_torch.sfm.matching import match_descriptors
from test_app_pipeline import textured_sphere_images
from test_orb_features import _smooth_texture, _square_corners
from test_torch_sfm_features import _match


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: thousands of tiny ops otherwise spin-wait to a
    crawl when several test workers each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RES = 128
CASES = [("orb", 512), ("orb", 48), ("harris", 512), ("harris", 40)]


@pytest.fixture(scope="module")
def sphere():
    c2ws, Ks = ring_cameras(4, 2.0, -0.3, 60.0, RES, RES)
    return textured_sphere_images(c2ws[:1], Ks[:1], RES, RES)[0].astype(np.float32)


@pytest.fixture(scope="module")
def jax_out(sphere):
    """JAX's features for every case, computed once."""
    fns = {"orb": JO.extract_orb, "harris": JO.extract_harris}
    return {(n, k): [np.asarray(x) for x in fns[n](jnp.asarray(sphere), max_keypoints=k)]
            for n, k in CASES}


def _port(name, img, k):
    fn = TO.extract_orb if name == "orb" else TO.extract_harris
    return fn(torch.as_tensor(img), max_keypoints=k)


def test_brief_pairs_and_fast_score(sphere):
    np.testing.assert_array_equal(TO._PAIRS, JO._PAIRS)
    for thresh in (0.06, 0.02):
        cj, hj = (np.asarray(x) for x in JO._fast_score(jnp.asarray(sphere), thresh))
        ct, ht = (x.numpy() for x in TO._fast_score(torch.as_tensor(sphere), thresh))
        np.testing.assert_array_equal(ct, cj)
        assert cj.sum() > 50
        assert np.abs(ht - hj).max() <= 1e-6 * np.abs(hj).max()


@pytest.mark.parametrize("name,k", CASES)
def test_extract_matches_jax(sphere, jax_out, name, k):
    fa = jax_out[(name, k)]
    ft = _port(name, sphere, k)
    fb = [x.numpy() for x in ft]
    va, vb = fa[5], fb[5]
    assert fb[0].shape == fa[0].shape and fb[3].shape == (k, TO.N_BITS)
    kth = float(fa[4][k - 1])
    ja = type("F", (), dict(zip(("xys", "scales", "orientations", "descriptors", "scores",
                                 "valid"), fa)))
    pairs, only_a, only_b = _match(ja, ft)
    near = lambda s, idx: all(abs(float(s[i]) - kth) <= 1e-6 * abs(kth) for i in idx)
    assert near(fa[4], only_a) and near(fb[4], only_b), (only_a, only_b, kth)
    assert len(pairs) >= max(va.sum() - 2, 10)
    ia = np.array([i for i, _ in pairs])
    ib = np.array([j for _, j in pairs])
    np.testing.assert_array_equal(fb[0][ib], fa[0][ia])
    np.testing.assert_array_equal(fb[1][ib], fa[1][ia])
    assert np.abs(fb[2][ib] - fa[2][ia]).max() <= 1e-5
    assert np.abs(fb[4][ib] - fa[4][ia]).max() <= 1e-6 * np.abs(fa[4]).max()
    # BRIEF: a differing bit must be a near-tie of the port's two samples
    diff = fb[3][ib] != fa[3][ia]
    if diff.any():
        lvl = 0 if name == "harris" else np.round(np.log(fb[1][ib]) / np.log(1.2)).astype(int)
        img = torch.as_tensor(sphere)
        for r, c in zip(*np.nonzero(diff)):
            lv = lvl if name == "harris" else int(lvl[r])
            im_l = img if lv == 0 else TO._resize_half_steps(img, 1.2 ** lv)
            x, y = (torch.as_tensor([round(v / 1.2 ** lv)]) for v in fb[0][ib[r]])
            a, b = TO._brief_samples(im_l, y, x, torch.as_tensor(fb[2][ib[r]:ib[r] + 1]))
            assert abs(float(a[0, c] - b[0, c])) <= 1e-6, (r, c)
    # the invalid tail: JAX's rows (top_k order), zero descriptors
    if va.sum() == vb.sum() and not only_a:
        np.testing.assert_array_equal(fb[0], fa[0])
    assert not fb[3][~vb].any()


# ---- mirrors of tests/test_orb_features.py on the port -------------------
def test_fast_fires_on_square_corners():
    img, corners = _square_corners()
    f = TO.extract_orb(torch.as_tensor(img), max_keypoints=256, n_levels=1)
    xy = f.xys.numpy()[f.valid.numpy()]
    assert len(xy) >= 0.5 * len(corners)
    gt = np.array(corners, np.float32)[:, ::-1]
    d = np.linalg.norm(xy[:, None] - gt[None], axis=-1).min(1)
    assert np.median(d) <= 2.0


@pytest.mark.parametrize("name", ["orb", "harris"])
def test_shift_and_rotation_matching(name):
    base = _smooth_texture(0)
    fn = TO.extract_orb if name == "orb" else TO.extract_harris
    f1 = fn(torch.as_tensor(base[10:170, 10:170].copy()), max_keypoints=512)
    f2 = fn(torch.as_tensor(base[14:174, 6:166].copy()), max_keypoints=512)
    idx, ok = match_descriptors(f1.descriptors, f2.descriptors, f1.valid, f2.valid)
    ok = ok.numpy()
    assert ok.sum() > 40
    shift = f2.xys.numpy()[idx.numpy()[ok]] - f1.xys.numpy()[ok]
    med = np.median(shift, 0)
    np.testing.assert_allclose(med, [4.0, -4.0], atol=1.0)
    assert (np.abs(shift - med) < 1.5).all(1).mean() > 0.8
    img1 = base[10:170, 10:170].copy()
    f3 = fn(torch.as_tensor(np.rot90(img1).copy()), max_keypoints=512)
    idx3, ok3 = match_descriptors(f1.descriptors, f3.descriptors, f1.valid, f3.valid)
    ok3 = ok3.numpy()
    assert ok3.sum() > 20
    xyA, xyB = f1.xys.numpy()[ok3], f3.xys.numpy()[idx3.numpy()[ok3]]
    pred = np.stack([xyA[:, 1], img1.shape[1] - 1 - xyA[:, 0]], -1)
    assert (np.linalg.norm(xyB - pred, axis=-1) < 2.5).mean() > 0.6


def test_descriptors_and_levels(sphere):
    f = TO.extract_orb(torch.as_tensor(sphere), max_keypoints=512)
    d = f.descriptors.numpy()[f.valid.numpy()]
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-6)
    assert set(np.unique(np.abs(d))) == {np.float32(1 / 16)}
    scales = np.unique(f.scales.numpy()[f.valid.numpy()])
    assert len(scales) >= 2 and set(np.round(np.log(scales) / np.log(1.2))) <= {0, 1, 2, 3}
    xy = f.xys.numpy()[f.valid.numpy()]
    assert (xy >= 0).all() and (xy < RES).all()
