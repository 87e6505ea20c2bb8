"""Port parity: ``sfm/rigs.py`` against the JAX package, on the CPU.

- The host numpy functions (``_rvec_to_R``, ``_R_to_rvec``, ``compose``,
  ``invert``, ``average_poses``, ``calibrate_rigs``, ``fit_instances``,
  ``enforce_rigs``) bit-equal to JAX's on random poses and on
  ``tests/test_rigs.py``'s stereo-rig scene (noisy poses, an incomplete
  instance, a subset size that cuts).
- ``rig_constrained_adjust`` on that scene (8 instances x 2 cameras, 60
  points, 2 rounds of 8 LM x 20 CG), calibrating the relatives and with
  them given: the final cost within 1e-4 rel of JAX's and the cameras
  and points within 1e-4 of the scene's extent after the 1-D scale fit
  of ``tests/test_torch_sfm_ba.py`` (the scale about the fixed camera is
  a free gauge that rounding moves); the calibrated relative's rotation
  within 1e-4 and its translation within 1e-4 of the extent after the
  same scale.
- ``sfm/reconstruct.py``'s host rotation is the one ``rigs`` holds.
- Mirrors of ``tests/test_rigs.py``'s constrained-BA checks on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_one_tpu.sfm import ba as JB
from splat_one_tpu.sfm import rigs as JR
from splat_one_tpu_torch.sfm import ba as TB
from splat_one_tpu_torch.sfm import reconstruct as RC
from splat_one_tpu_torch.sfm import rigs as TR
from test_rigs import _make_rig_scene, _rand_pose
from test_torch_sfm_ba import _compare, _port_problem


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: thousands of tiny ops otherwise spin-wait to a
    crawl when several test workers each run a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy(poses, sd, seed):
    rng = np.random.default_rng(seed)
    return {s: JR.compose(np.concatenate([rng.normal(0, sd, 3), rng.normal(0, sd, 3)]), p)
            for s, p in poses.items()}


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_host_functions_bit_equal():
    rng = np.random.default_rng(0)
    for _ in range(30):
        a, b = _rand_pose(rng, rot_scale=1.5), _rand_pose(rng, rot_scale=1.5)
        np.testing.assert_array_equal(TR._rvec_to_R(a[:3]), JR._rvec_to_R(a[:3]))
        R = JR._rvec_to_R(a[:3])
        np.testing.assert_array_equal(TR._R_to_rvec(R), JR._R_to_rvec(R))
        np.testing.assert_array_equal(TR.compose(a, b), JR.compose(a, b))
        np.testing.assert_array_equal(TR.invert(a), JR.invert(a))
    for th in (0.0, 1e-8, np.pi - 1e-7):
        r = np.array([0.6, -0.48, 0.64]) / np.linalg.norm([0.6, -0.48, 0.64]) * th
        np.testing.assert_array_equal(TR._R_to_rvec(JR._rvec_to_R(r)),
                                      JR._R_to_rvec(JR._rvec_to_R(r)))
        np.testing.assert_array_equal(RC._R_of(r), JR._rvec_to_R(r))
    assert RC._R_of is TR._rvec_to_R
    poses = [_rand_pose(rng, 0.05) for _ in range(12)]
    np.testing.assert_array_equal(TR.average_poses(poses), JR.average_poses(poses))

    _, _, _, _, assign, rel, gt = _make_rig_scene()
    noisy = _noisy(gt, 0.005, 2)
    _same(TR.calibrate_rigs(noisy, assign), JR.calibrate_rigs(noisy, assign))
    partial = dict(noisy)
    del partial["s0_R"]
    for kw in (dict(subset_size=3, completeness=1.0), dict(subset_size=15)):
        _same(TR.calibrate_rigs(partial, assign, **kw), JR.calibrate_rigs(partial, assign, **kw))
    cal = {"camL": np.zeros(6), "camR": rel}
    _same(TR.fit_instances(partial, cal, assign), JR.fit_instances(partial, cal, assign))
    _same(TR.enforce_rigs(partial, cal, assign), JR.enforce_rigs(partial, cal, assign))
    assert TR.calibrate_rigs(noisy, {}) == {}


@pytest.fixture(scope="module")
def scene():
    cams_gt, X, problem, shot_ids, assign, rel, _ = _make_rig_scene(noise=1e-3)
    rng = np.random.default_rng(4)
    cams0 = cams_gt + rng.normal(0, 0.01, cams_gt.shape).astype(np.float32)
    cams0[0] = cams_gt[0]
    X0 = (X + rng.normal(0, 0.03, X.shape)).astype(np.float32)
    return cams_gt, X, problem, shot_ids, assign, rel, cams0, X0


@pytest.mark.parametrize("given", [False, True])
def test_rig_constrained_adjust_matches_jax(scene, given):
    cams_gt, X, problem, shot_ids, assign, rel, cams0, X0 = scene
    rig = {"camL": np.zeros(6), "camR": rel} if given else None
    kw = dict(max_iterations=8, cg_iterations=20)
    cj, xj, calj, ij = JR.rig_constrained_adjust(problem, cams0, X0, shot_ids, assign,
                                                 rig_cameras=rig, cfg=JB.BAConfig(**kw), rounds=2)
    ct, xt, calt, it = TR.rig_constrained_adjust(_port_problem(problem), cams0, X0, shot_ids,
                                                 assign, rig_cameras=rig,
                                                 cfg=TB.BAConfig(**kw), rounds=2)
    assert isinstance(ct, np.ndarray) and ct.shape == cams0.shape and xt.shape == X0.shape
    assert set(calt) == set(calj) == {"camL", "camR"}
    # _compare's scale fit, on the final bundle's inputs: the enforced poses
    _compare((cj, xj, ij), (torch.as_tensor(ct), torch.as_tensor(xt), it), X, scale_gauge=True)
    assert np.abs(calt["camR"][:3] - calj["camR"][:3]).max() <= 1e-4
    ext = float((X.max(0) - X.min(0)).max())
    s = np.linalg.norm(calj["camR"][3:]) / np.linalg.norm(calt["camR"][3:])
    assert np.abs(s * calt["camR"][3:] - calj["camR"][3:]).max() <= 1e-4 * ext
    # mirrors of tests/test_rigs.py::TestRigConstrainedBA on the port
    assert np.allclose(calt["camR"][:3], rel[:3], atol=0.02)
    assert np.allclose(calt["camR"][3:], rel[3:], atol=0.03)
    poses = {sid: ct[i] for i, sid in enumerate(shot_ids)}
    for i in range(8):
        got = TR.compose(poses[f"s{i}_R"], TR.invert(poses[f"s{i}_L"]))
        assert np.allclose(got, calt["camR"], atol=1e-8)
    assert float(it["final_cost"]) < 5e-3
    assert float(it["final_cost"]) <= float(it["initial_cost"])
