"""Port parity: ``sfm/reconstruct.py`` against the JAX package, on the CPU.

- ``align_reconstruction_to_gps`` and ``align_reconstruction_orientation``
  (horizontal, vertical, no_roll) on the same reconstruction: poses,
  points and the info within 1e-6; ``triangulate_nview``, ``_rvec_from_R``
  and the host rotation ``_R_of`` within 1e-6 of JAX's.
- ``ReconstructConfig``: JAX's fields and defaults.
- ``incremental_reconstruct`` on JAX's ``synth_multiview`` scene, in the
  port alone (its RANSAC draws come from a torch generator, so the
  packages agree in outcome, not draw for draw), held to JAX's bars
  (``tests/test_sfm_pipeline.py::test_incremental_reconstruction``):
  every view registered, more than 200 points, similarity-aligned camera
  centres within 0.05 of the spread; and with ``bundle_use_gps`` the
  centres land in the GPS frame (JAX's ``TestGPSBundle`` bar).
- Mirrors of JAX's ``TestAttemptSelection`` and ``TestOrientationAlignment``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_one_tpu.sfm import reconstruct as JRC
from splat_one_tpu.sfm.ba import _rodrigues as j_rodrigues
from splat_one_tpu.sfm.rigs import _R_to_rvec, _rvec_to_R
from splat_one_tpu_torch.sfm import matching as M
from splat_one_tpu_torch.sfm import reconstruct as RC
from splat_one_tpu_torch.sfm import tracks as T
from test_sfm_pipeline import synth_multiview


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the SfM runs thousands of tiny ops, which
    spin-wait themselves to a crawl when several test workers each run a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEV = "cpu"


def _rec_pair(seed=0, n_cams=6, n_pts=30):
    rng = np.random.default_rng(seed)
    poses = {i: np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 1, 3)]).astype(np.float32)
             for i in range(n_cams)}
    pts = {t: rng.normal(size=3).astype(np.float32) for t in range(n_pts)}
    return (RC.Reconstruction(dict(poses), dict(pts), {"steps": []}),
            JRC.Reconstruction(dict(poses), dict(pts), {"steps": []}))


def _close(a, b, tol=1e-6):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), atol=tol, rtol=0)


def test_alignments_match_jax():
    rt, rj = _rec_pair()
    rng = np.random.default_rng(1)
    gps = {i: (rng.normal(size=3) * 20 + [100, 50, 7]) for i in range(5)}
    at, it = RC.align_reconstruction_to_gps(rt, gps)
    aj, ij = JRC.align_reconstruction_to_gps(rj, gps)
    _close(at.poses, aj.poses, 1e-5)
    _close(at.points, aj.points, 1e-4)  # 20 m scale: 1e-6 relative
    assert it["aligned"] and abs(it["scale"] - ij["scale"]) <= 1e-6 * ij["scale"]
    assert abs(it["rmse_m"] - ij["rmse_m"]) <= 1e-6 * max(ij["rmse_m"], 1.0)
    for prior in ("horizontal", "vertical", "no_roll"):
        at, it = RC.align_reconstruction_orientation(rt, prior)
        aj, ij = JRC.align_reconstruction_orientation(rj, prior)
        _close(at.poses, aj.poses)
        _close(at.points, aj.points)
        assert it == ij
    few = {0: gps[0], 1: gps[1]}
    assert RC.align_reconstruction_to_gps(rt, few)[1] == JRC.align_reconstruction_to_gps(rj, few)[1]


def test_host_helpers_match_jax():
    rng = np.random.default_rng(2)
    for r in (np.zeros(3), rng.normal(size=3), np.array([np.pi - 1e-9, 0, 0])):
        np.testing.assert_allclose(RC._R_of(r), _rvec_to_R(r), atol=1e-12)
        R = _rvec_to_R(r)
        np.testing.assert_allclose(RC._rvec_from_R(R), JRC._rvec_from_R(R), atol=1e-6)
    Rs = [_rvec_to_R(rng.normal(0, 0.2, 3)) for _ in range(4)]
    ts = [rng.normal(size=3) for _ in range(4)]
    X = rng.normal(size=3) + [0, 0, 5]
    bs = []
    for R, t in zip(Rs, ts):
        p = R @ X + t
        bs.append(p / np.linalg.norm(p))
    bs[3] = np.array([0.95, 0.1, np.sqrt(1 - 0.95 ** 2 - 0.01)])  # the other tangent branch
    Xt, at = RC.triangulate_nview(Rs, ts, bs)
    Xj, aj = JRC.triangulate_nview(Rs, ts, bs)
    np.testing.assert_allclose(Xt, Xj, atol=1e-6)
    assert abs(at - aj) <= 1e-6


def test_config_matches_jax():
    assert dataclasses.asdict(RC.ReconstructConfig()) == dataclasses.asdict(JRC.ReconstructConfig())


def _scene_tracks(n_cams=8, n_pts=300):
    poses_gt, X, bearings, descs, valids = synth_multiview(n_cams, n_pts)
    matches = M.match_pairs_brute_force(descs, valids, M.pairs_to_match(n_cams, device=DEV),
                                        device=DEV)
    draws = M.verify_draws(len(matches), 0, DEV)
    filtered, counts = {}, {}
    for n, ((i, j), m) in enumerate(sorted(matches.items())):
        fm = M.robust_filter_matches(m, bearings[i], bearings[j], draws=draws[n], device=DEV)
        filtered[(i, j)] = fm
        counts[(i, j)] = len(fm)
    tracks, _ = T.build_tracks(filtered, [n_pts] * n_cams, 2)
    return poses_gt, bearings, tracks, counts


def _center(p):
    return -RC._R_of(np.asarray(p[:3], np.float64)).T @ p[3:]


def test_incremental_reconstruction():
    poses_gt, bearings, tracks, counts = _scene_tracks()
    rec = RC.incremental_reconstruct(bearings, tracks, counts,
                                     RC.ReconstructConfig(bundle_interval=3), device=DEV)
    assert len(rec.poses) == 8, rec.report
    assert len(rec.points) > 200, rec.report
    c_gt = np.stack([_center(poses_gt[c]) for c in range(8)])
    c_est = np.stack([_center(rec.poses[c]) for c in range(8)])
    mu_g, mu_e = c_gt.mean(0), c_est.mean(0)
    U, s, Vt = np.linalg.svd((c_gt - mu_g).T @ (c_est - mu_e))
    D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    R_al = U @ D @ Vt
    scale = np.trace(np.diag(s) @ D) / ((c_est - mu_e) ** 2).sum()
    aligned = scale * (c_est - mu_e) @ R_al.T + mu_g
    err = np.linalg.norm(aligned - c_gt, axis=-1).max()
    spread = np.linalg.norm(c_gt - mu_g, axis=-1).mean()
    assert err < 0.05 * spread, (err, spread, rec.report)


def test_bundle_use_gps_lands_in_gps_frame():
    poses_gt, bearings, tracks, counts = _scene_tracks()
    rng = np.random.default_rng(3)
    gps = {c: 4.0 * _center(poses_gt[c]) + np.array([100.0, 50.0, 7.0]) + rng.normal(0, 0.02, 3)
           for c in range(8)}
    rec = RC.incremental_reconstruct(
        bearings, tracks, counts,
        RC.ReconstructConfig(bundle_interval=3, bundle_use_gps=True, gps_sd_m=0.05),
        gps_positions=gps, device=DEV)
    assert len(rec.poses) == 8, rec.report
    errs = [np.linalg.norm(_center(rec.poses[c]) - gps[c]) for c in range(8)]
    assert max(errs) < 0.25, (errs, rec.report)


# ---- mirrors of TestAttemptSelection / TestOrientationAlignment ----------
def _mk_rec(n_cams, centers, points):
    poses = {i: np.concatenate([np.zeros(3), -np.asarray(c, np.float32)]).astype(np.float32)
             for i, c in enumerate(centers[:n_cams])}
    return RC.Reconstruction(poses, {i: np.asarray(p, np.float32) for i, p in enumerate(points)},
                             {"steps": []})


def _ring():
    return [(np.cos(a), np.sin(a), 0.0) for a in np.linspace(0, 2 * np.pi, 6, endpoint=False)]


def test_selection_prefers_retention(monkeypatch):
    rng = np.random.default_rng(0)
    pts_all = rng.uniform(-1, 1, (40, 3)) + [0, 0, 5]
    tracks = [{img: 0 for img in range(6)} for _ in range(40)]
    bearings = [np.tile([[0, 0, 1.0]], (1, 1)).astype(np.float32) for _ in range(6)]
    recs = [_mk_rec(6, _ring(), pts_all[:24]), _mk_rec(6, _ring(), pts_all[:38]),
            _mk_rec(6, _ring(), pts_all[:20])]
    calls = {"n": 0}

    def fake_attempt(bearings, tracks, pair_inliers, cfg, seed, snapshot, gps_positions,
                     init_skip=0, device="cuda"):
        calls["n"] += 1
        return recs[min(init_skip, len(recs) - 1)]

    monkeypatch.setattr(RC, "_reconstruct_attempt", fake_attempt)
    monkeypatch.setattr(RC, "_median_residual", lambda rec, b, t: 1e-5)
    rec = RC.incremental_reconstruct(bearings, tracks, {}, RC.ReconstructConfig(init_retries=3),
                                     device=DEV)
    assert calls["n"] >= 2
    assert len(rec.points) == 38
    assert rec.report["obs_retention"] == pytest.approx(38 * 6 / 240)


def test_selection_rejects_pure_rotation_collapse(monkeypatch):
    rng = np.random.default_rng(1)
    collapsed = [(1e-4 * rng.normal(), 1e-4 * rng.normal(), 0.0) for _ in range(6)]
    far_pts = rng.normal(size=(40, 3)) * 5 + [0, 0, 100]
    near_pts = rng.uniform(-1, 1, (40, 3)) + [0, 0, 5]
    tracks = [{img: 0 for img in range(6)} for _ in range(40)]
    bearings = [np.tile([[0, 0, 1.0]], (1, 1)).astype(np.float32) for _ in range(6)]
    recs = [_mk_rec(6, collapsed, far_pts), _mk_rec(6, _ring(), near_pts)]

    def fake_attempt(bearings, tracks, pair_inliers, cfg, seed, snapshot, gps_positions,
                     init_skip=0, device="cuda"):
        return recs[min(init_skip, len(recs) - 1)]

    monkeypatch.setattr(RC, "_reconstruct_attempt", fake_attempt)
    monkeypatch.setattr(RC, "_median_residual", lambda rec, b, t: 1e-5)
    rec = RC.incremental_reconstruct(bearings, tracks, {}, RC.ReconstructConfig(init_retries=2),
                                     device=DEV)
    assert not rec.report["degenerate"]
    C = np.stack([_center(p) for p in rec.poses.values()])
    assert np.linalg.norm(C - C.mean(0), axis=1).mean() > 0.5


def test_horizontal_prior_levels_the_world():
    rng = np.random.default_rng(0)
    tilt = _rvec_to_R(np.array([np.deg2rad(25), 0, 0]))
    poses, pts = {}, {}
    for i in range(6):
        R_w2c = _rvec_to_R(np.array([0, 0.3 * i, 0])) @ tilt.T
        c = tilt @ np.array([np.sin(0.3 * i), 0, np.cos(0.3 * i)])
        poses[i] = np.concatenate([_R_to_rvec(R_w2c), -R_w2c @ c]).astype(np.float32)
    for t in range(40):
        pts[t] = (tilt @ rng.uniform(-1, 1, 3)).astype(np.float32)
    rec = RC.Reconstruction(poses, pts, {})
    rec2, info = RC.align_reconstruction_orientation(rec, "horizontal")
    assert info["aligned"]
    g = np.stack([RC._R_of(p[:3])[1] for p in rec2.poses.values()]).mean(0)
    assert np.allclose(g / np.linalg.norm(g), [0, 0, -1], atol=1e-5)

    def centers(r):
        return np.stack([_center(p) for p in r.poses.values()])

    d1 = np.linalg.norm(centers(rec)[0] - centers(rec)[3])
    d2 = np.linalg.norm(centers(rec2)[0] - centers(rec2)[3])
    assert abs(d1 - d2) < 1e-5
    assert np.allclose(np.asarray(j_rodrigues(jnp.asarray(rec2.poses[0][:3]))),
                       RC._R_of(rec2.poses[0][:3]), atol=1e-6)
