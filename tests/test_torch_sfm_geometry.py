"""Port parity: ``sfm/geometry.py`` against the JAX package, on the CPU.

- 8-point E up to sign: 1e-4 of its largest entry.
- 5-point candidates from JAX's nullspace basis (``essential_5pt_from_basis``
  fed the basis JAX computes; a basis of a 4-D space is not unique, so the
  packages' own SVDs may pick different ones): 1e-4 up to sign for every
  start that solved its sample (147 of the 160 here).
- ``ransac_essential`` (8-point, 1024 hypotheses; 5-point, 64) and
  ``ransac_pnp`` fed JAX's draws: the same inlier masks, on JAX's own test
  scenes (200 correspondences, 30 % outliers; 60 noisy resection points).
- ``triangulate``, ``decompose_essential``, ``pnp_dlt``,
  ``rvec_from_rotmat`` (at 0, a generic angle and near pi): 1e-5 of each
  output's largest magnitude.
- A batch of problems through ``ransac_essential`` equals each alone.
- Mirrors of every test of JAX's ``tests/test_sfm_geometry.py``
  (``TestTwoView``, ``TestFivePoint``, the planar scene) on the port,
  fed the draws of the JAX test's own key (the noiseless planar scene
  passes for some keys only, in either package); the BA tests of that file
  (``TestBundleAdjust``, ``TestBAPriors``) are mirrored in
  ``test_torch_sfm_ba.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_one_tpu.sfm import geometry as JG
from splat_one_tpu_torch.sfm import ba as TB
from splat_one_tpu_torch.sfm import geometry as geo
import test_sfm_geometry as jtests
from test_sfm_geometry import synth_two_view


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the SfM runs thousands of tiny ops, which
    spin-wait themselves to a crawl when several test workers each run a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.array(a))


def draws(n_hyp, n_sample, seed=0):
    """The draws JAX's RANSAC takes from ``PRNGKey(seed)``."""
    u = jax.random.randint(jax.random.PRNGKey(seed), (n_hyp, n_sample), 0, 1 << 30)
    return torch.as_tensor(np.asarray(u))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-12))


def _rel_sign(a, b):
    return min(_rel(a, b), _rel(a, -np.asarray(b)))


def test_8pt_up_to_sign():
    b1, b2, *_ = synth_two_view(100, noise=1e-3)
    for s in range(0, 80, 8):
        Ej = JG._essential_8pt(b1[s:s + 8], b2[s:s + 8])
        Et = geo._essential_8pt(T(b1[s:s + 8]), T(b2[s:s + 8]))
        assert _rel_sign(Ej, Et.numpy()) <= 1e-4, s


def test_5pt_candidates_from_jax_basis():
    b1, b2, *_ = synth_two_view(60, noise=1e-4)
    n_solved = 0
    for s in range(0, 50, 5):
        A = jnp.einsum("ni,nj->nij", b2[s:s + 5], b1[s:s + 5]).reshape(-1, 9)
        basis = np.asarray(jnp.linalg.svd(A, full_matrices=True)[2][5:9])
        Cj = np.asarray(JG._essential_5pt_candidates(b1[s:s + 5], b2[s:s + 5]))
        Ct = geo.essential_5pt_from_basis(T(basis)).numpy()
        assert Ct.shape == (16, 3, 3)
        s1, s2 = np.asarray(b1[s:s + 5]), np.asarray(b2[s:s + 5])
        for k in range(16):
            # a start that solved its sample (every epipolar residual
            # < 1e-5) is a fixed point: held at 1e-4. A start still moving
            # after the 20 steps is an iterate in flight that amplifies f32
            # rounding (up to ~2e-2 measured); it is held to be essential.
            if np.abs(np.einsum("ni,ij,nj->n", s2, Cj[k], s1)).max() < 1e-5:
                n_solved += 1
                assert _rel_sign(Cj[k], Ct[k]) <= 1e-4, (s, k)
            sv = np.linalg.svd(Ct[k], compute_uv=False)
            assert abs(sv[0] - sv[1]) <= 1e-5 * sv[0] and sv[2] <= 1e-5 * sv[0]
    assert n_solved >= 140, n_solved


def test_ransac_essential_with_jax_draws():
    b1, b2, *_ = synth_two_view(200, noise=1e-3, outliers=0.3)
    valid = np.ones(200, bool)
    valid[190:] = False  # a padded suffix
    for solver, n_hyp, seed in (("8pt", 1024, 1), ("5pt", 64, 0), ("5pt", 64, 2)):
        key = jax.random.PRNGKey(seed)
        n_s = 5 if solver == "5pt" else 8
        u = np.asarray(jax.random.randint(key, (n_hyp, n_s), 0, 1 << 30))
        rj = JG.ransac_essential(key, b1, b2, jnp.asarray(valid), threshold=0.008,
                                 n_hyp=n_hyp, solver=solver)
        rt = geo.ransac_essential(T(u), T(b1), T(b2), T(valid), threshold=0.008, solver=solver)
        assert np.array_equal(np.asarray(rj.inliers), rt.inliers.numpy()), solver
        assert int(rj.n_inliers) == int(rt.n_inliers) > 100


def test_ransac_pnp_with_jax_draws():
    rng = np.random.default_rng(3)
    X = rng.uniform(-1, 1, (60, 3))
    X[:, 2] += 4
    R = TB._rodrigues(torch.tensor([0.2, -0.1, 0.3])).double().numpy()
    p = X @ R.T + np.array([0.5, -0.2, 0.1])
    b = p / np.linalg.norm(p, axis=-1, keepdims=True)
    b = b + rng.normal(0, 1e-3, b.shape)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    b[:10] = rng.normal(size=(10, 3))  # outliers
    b[:10] /= np.linalg.norm(b[:10], axis=-1, keepdims=True)
    X, b = X.astype(np.float32), b.astype(np.float32)
    valid = np.arange(64) < 60
    Xp = np.concatenate([X, np.zeros((4, 3), np.float32)])
    bp = np.concatenate([b, np.tile([[0, 0, 1.0]], (4, 1)).astype(np.float32)])
    for seed, thr in ((0, 0.01), (5, 0.003)):
        key = jax.random.PRNGKey(seed)
        u = np.asarray(jax.random.randint(key, (128, 6), 0, 1 << 30))
        Rj, tj, inl_j, n_j = JG.ransac_pnp(key, jnp.asarray(Xp), jnp.asarray(bp),
                                           jnp.asarray(valid), threshold=thr)
        Rt, tt, inl_t, n_t = geo.ransac_pnp(T(u), T(Xp), T(bp), T(valid), threshold=thr)
        assert np.array_equal(np.asarray(inl_j), inl_t.numpy())
        assert int(n_j) == int(n_t) >= 45
        assert _rel(Rj, Rt.numpy()) <= 1e-5 and _rel(tj, tt.numpy()) <= 1e-4


def test_triangulate_decompose_pnp_rvec():
    b1, b2, R, t, X = synth_two_view(100, noise=1e-4)
    rj = JG.ransac_essential(jax.random.PRNGKey(0), b1, b2, jnp.ones(100, bool))
    E = np.asarray(rj.E)
    Rj, tj, nj = JG.decompose_essential(rj.E, b1, b2, rj.inliers)
    Rt, tt, nt = geo.decompose_essential(T(E), T(b1), T(b2), T(np.asarray(rj.inliers)))
    assert int(nj) == int(nt) and _rel(Rj, Rt.numpy()) <= 1e-5 and _rel(tj, tt.numpy()) <= 1e-5
    Xj = JG.triangulate(jnp.eye(3), jnp.zeros(3), Rj, tj, b1, b2)
    Xt = geo.triangulate(torch.eye(3), torch.zeros(3), T(np.asarray(Rj)), T(np.asarray(tj)),
                         T(b1), T(b2))
    assert _rel(Xj, Xt.numpy()) <= 1e-5
    bb = np.asarray(b2)[:40]
    valid = np.ones(40, bool)
    valid[35:] = False
    Rj, tj = JG.pnp_dlt(jnp.asarray(X[:40], jnp.float32), jnp.asarray(bb), jnp.asarray(valid))
    Rt, tt = geo.pnp_dlt(T(X[:40].astype(np.float32)), T(bb), T(valid))
    assert _rel(Rj, Rt.numpy()) <= 1e-5 and _rel(tj, tt.numpy()) <= 1e-5
    for rv in ([0.0, 0.0, 0.0], [0.3, -0.2, 0.5], [np.pi - 1e-3, 0.01, 0.0], [0.0, 3.1, 0.2]):
        Rm = TB._rodrigues(torch.tensor(rv, dtype=torch.float32)).numpy()
        a = np.asarray(JG.rvec_from_rotmat(jnp.asarray(Rm)))
        b = geo.rvec_from_rotmat(T(Rm)).numpy()
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(a).max(), 1.0), rv


def test_batched_ransac_equals_single():
    b1, b2, *_ = synth_two_view(100, noise=1e-3, outliers=0.2)
    b1, b2 = np.asarray(b1), np.asarray(b2)
    perm = np.random.default_rng(0).permutation(100)
    B1, B2 = np.stack([b1, b1[perm]]), np.stack([b2, b2[perm]])
    V = np.ones((2, 100), bool)
    V[1, 80:] = False
    U = torch.stack([draws(256, 8, 0), draws(256, 8, 1)])
    rb = geo.ransac_essential(U, T(B1), T(B2), T(V), threshold=0.008, solver="8pt")
    for k in range(2):
        rs = geo.ransac_essential(U[k], T(B1[k]), T(B2[k]), T(V[k]), threshold=0.008,
                                  solver="8pt")
        assert torch.equal(rb.inliers[k], rs.inliers) and int(rb.n_inliers[k]) == int(rs.n_inliers)


# ---- mirrors of tests/test_sfm_geometry.py on the port -------------------
def test_essential_exact():
    b1, b2, R, t, X = synth_two_view(100)
    res = geo.ransac_essential(draws(256, 5), T(b1), T(b2), torch.ones(100, dtype=torch.bool))
    assert int(res.n_inliers) >= 95
    errs = geo._epipolar_angle_error(res.E, T(b1), T(b2)).numpy()
    assert np.median(errs) < 1e-4


def test_ransac_with_outliers():
    b1, b2, R, t, X = synth_two_view(200, noise=1e-3, outliers=0.3)
    res = geo.ransac_essential(draws(256, 5, 1), T(b1), T(b2), torch.ones(200, dtype=torch.bool),
                               threshold=0.008)
    inl = res.inliers.numpy()
    assert inl[:60].sum() < 10
    assert inl[60:].sum() > 110


def test_decompose_recovers_pose():
    b1, b2, R, t, X = synth_two_view(100)
    res = geo.ransac_essential(draws(256, 5), T(b1), T(b2), torch.ones(100, dtype=torch.bool))
    R_est, t_est, n_good = geo.decompose_essential(res.E, T(b1), T(b2), res.inliers)
    assert int(n_good) > 90
    np.testing.assert_allclose(R_est.numpy(), R, atol=2e-3)
    t_dir = t_est.numpy() / np.linalg.norm(t_est.numpy())
    np.testing.assert_allclose(t_dir, t / np.linalg.norm(t), atol=2e-3)


def test_triangulation():
    b1, b2, R, t, X = synth_two_view(50)
    Xr = geo.triangulate(torch.eye(3), torch.zeros(3), T(R.astype(np.float32)),
                         T(t.astype(np.float32)), T(b1), T(b2))
    np.testing.assert_allclose(Xr.numpy(), X, atol=1e-3)


def test_pnp():
    rng = np.random.default_rng(3)
    X = rng.uniform(-1, 1, (60, 3))
    X[:, 2] += 4
    R = TB._rodrigues(torch.tensor([0.2, -0.1, 0.3])).double().numpy()
    t = np.array([0.5, -0.2, 0.1])
    p = X @ R.T + t
    b = p / np.linalg.norm(p, axis=-1, keepdims=True)
    R_est, t_est, inl, n = geo.ransac_pnp(draws(128, 6), T(X.astype(np.float32)),
                                          T(b.astype(np.float32)), torch.ones(60, dtype=torch.bool))
    assert int(n) >= 55
    np.testing.assert_allclose(R_est.numpy(), R, atol=1e-3)
    np.testing.assert_allclose(t_est.numpy(), t, atol=5e-3)


def _pose_err(E, b1, b2, R_gt, t_gt):
    R, t, _ = geo.decompose_essential(E, T(b1), T(b2), torch.ones(len(b1), dtype=torch.bool))
    R, t = R.double().numpy(), t.double().numpy()
    ang = np.degrees(np.arccos(np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1)))
    terr = np.degrees(np.arccos(np.clip(abs((t / np.linalg.norm(t)) @ (t_gt / np.linalg.norm(t_gt))),
                                        -1, 1)))
    return ang, terr


def test_planar_scene(rng):
    b1, b2, R_gt, t_gt = jtests.TestFivePoint()._two_view(rng, planar=True)
    res = geo.ransac_essential(draws(64, 5), T(b1), T(b2), torch.ones(len(b1), dtype=torch.bool),
                               solver="5pt")
    ang, terr = _pose_err(res.E, b1, b2, R_gt, t_gt)
    assert ang < 2.0 and terr < 3.0, (ang, terr)


def test_general_scene_with_noise(rng):
    b1, b2, R_gt, t_gt = jtests.TestFivePoint()._two_view(rng, planar=False, noise=1e-4)
    res = geo.ransac_essential(draws(64, 5), T(b1), T(b2), torch.ones(len(b1), dtype=torch.bool),
                               solver="5pt")
    assert int(res.n_inliers) > 50
    ang, terr = _pose_err(res.E, b1, b2, R_gt, t_gt)
    assert ang < 1.0 and terr < 2.0, (ang, terr)
