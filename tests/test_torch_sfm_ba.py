"""Port parity: ``sfm/ba.py`` against the JAX package, on the CPU.

- ``build_problem`` and ``_segsum_sorted``: JAX's layout exactly, sums
  within 1e-6 of the running sums; the closed-form 3x3 and 6x6 block
  inverses within 1e-4 of a float64 inverse.
- ``_res_jac`` (closed-form Jacobians) against JAX's ``jacfwd`` of the
  same residual: 1e-6 abs, at zero rotation, generic and large angles,
  bearings on both tangent-frame branches; ``_rodrigues`` and
  ``camera_center`` within 1e-6.
- ``bundle_adjust`` on JAX's 6-camera, 200-point noisy problem
  (``tests/test_sfm_geometry.py::TestBundleAdjust.make_problem``): plain
  (soft-L1; the quadratic loss on costs alone), with ``fixed_cams``, with point priors and with
  camera-centre priors: final cost within 1e-4 rel, cameras and points
  within 1e-4 of the scene's extent (the largest side of the points'
  bounding box). Plain, the scale about the fixed camera is a free gauge
  that rounding moves, so the plain runs' centres and points are
  compared after a 1-D scale fit (``_compare``).
- Mirrors of JAX's ``TestBundleAdjust`` and ``TestBAPriors`` on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_one_tpu.sfm import ba as JB
from splat_one_tpu_torch.sfm import ba as TB
import test_sfm_geometry as jtests
from test_sfm_geometry import rigs_R


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the SfM runs thousands of tiny ops, which
    spin-wait themselves to a crawl when several test workers each run a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_problem(problem):
    """The port's problem from the same edges as a JAX BAProblem."""
    cam = np.asarray(problem.cam_idx)
    C = len(np.asarray(problem.cam_bounds)) - 1
    P = len(np.asarray(problem.pt_bounds)) - 1
    return TB.build_problem(cam, np.asarray(problem.pt_idx), np.asarray(problem.bearings), C, P,
                            valid=np.asarray(problem.valid), device="cpu")


def _extent(X):
    return float((X.max(0) - X.min(0)).max())


def test_build_problem_and_segsum():
    rng = np.random.default_rng(0)
    E, C, P = 300, 7, 40
    ci, pi = rng.integers(0, C, E), rng.integers(0, P, E)
    b = rng.normal(size=(E, 3)).astype(np.float32)
    valid = rng.uniform(size=E) > 0.1
    pj = JB.build_problem(ci, pi, b, C, P, valid=valid)
    pt = TB.build_problem(ci, pi, b, C, P, valid=valid, device="cpu")
    for a, t in zip(pj, pt):
        assert np.array_equal(np.asarray(a), t.numpy())
    vals = rng.normal(size=(E, 5)).astype(np.float32)
    for bounds in ("cam_bounds", "pt_bounds"):
        sj = np.asarray(JB._segsum_sorted(jnp.asarray(vals), getattr(pj, bounds)))
        st = TB._segsum_sorted(torch.as_tensor(vals), getattr(pt, bounds)).numpy()
        # differences of f32 running sums: 1e-6 of the running sum's size
        assert np.abs(sj - st).max() <= 1e-6 * np.abs(np.cumsum(vals, 0)).max()


def test_res_jac_matches_jacfwd():
    rng = np.random.default_rng(1)
    E = 64
    cams = rng.normal(0, 0.4, (E, 6)).astype(np.float32)
    cams[0, :3] = 0.0  # zero rotation
    cams[1, :3] = [2.9, 0.3, -0.4]  # near pi
    pts = (rng.uniform(-1, 1, (E, 3)) + [0, 0, 4]).astype(np.float32)
    bs = rng.normal(size=(E, 3))
    bs[:8, 2] = 5.0  # the other tangent-frame branch (|b_z| >= 0.9)
    bs = (bs / np.linalg.norm(bs, axis=1, keepdims=True)).astype(np.float32)
    rj, Jcj, Jpj = (np.asarray(x) for x in JB._res_jac(jnp.asarray(cams), jnp.asarray(pts),
                                                      jnp.asarray(bs)))
    rt, Jct, Jpt = (x.numpy() for x in TB._res_jac(torch.as_tensor(cams), torch.as_tensor(pts),
                                                  torch.as_tensor(bs)))
    assert np.abs(rj - rt).max() <= 1e-6
    assert np.abs(Jcj - Jct).max() <= 1e-6
    assert np.abs(Jpj - Jpt).max() <= 1e-6
    Rj = np.asarray(JB._rodrigues(jnp.asarray(cams[:, :3])))
    assert np.abs(Rj - TB._rodrigues(torch.as_tensor(cams[:, :3])).numpy()).max() <= 1e-6
    cj = np.asarray(jax.vmap(JB.camera_center)(jnp.asarray(cams)))
    assert np.abs(cj - TB.camera_center(torch.as_tensor(cams)).numpy()).max() <= 1e-6
    # the centre prior's Jacobian against jacfwd of JAX's camera_center
    Jj = np.asarray(jax.vmap(jax.jacfwd(JB.camera_center))(jnp.asarray(cams)))
    _, Jt = TB._center_jac(torch.as_tensor(cams))
    assert np.abs(Jj - Jt.numpy()).max() <= 1e-5 * max(1.0, np.abs(Jj).max())


@pytest.mark.parametrize("n", [3, 6])
def test_closed_form_block_inverses(n):
    """The LM loop's point (3x3) and camera (6x6) block inverses against
    torch.linalg.inv on damped normal blocks J^T J + lambda I."""
    rng = np.random.default_rng(n)
    J = torch.as_tensor(rng.normal(size=(500, 2 * n, n)).astype(np.float32))
    M = J.transpose(-1, -2) @ J + 1e-3 * torch.eye(n)
    got = TB._inv3(M) if n == 3 else TB._inv6(M)
    want = torch.linalg.inv(M.double()).float()
    assert ((got - want).abs().amax((-1, -2)) / want.abs().amax((-1, -2))).max() <= 1e-4


def _start(seed=1, cam_sd=0.02, pt_sd=0.05, noise=1e-3):
    cams_gt, X, problem = jtests.TestBundleAdjust().make_problem(noise=noise)
    rng = np.random.default_rng(seed)
    cams0 = cams_gt + rng.normal(0, cam_sd, cams_gt.shape).astype(np.float32)
    cams0[0] = cams_gt[0]
    X0 = X + rng.normal(0, pt_sd, X.shape).astype(np.float32)
    return cams_gt, X, problem, cams0, X0


def _centers(cams):
    return np.stack([-rigs_R(c[:3]).T @ c[3:] for c in np.asarray(cams, np.float64)])


def _compare(out_j, out_t, X, scale_gauge=False):
    """Costs within 1e-4 rel; cameras and points within 1e-4 of the
    scene's extent. With ``scale_gauge`` (bearing residuals, one camera
    fixed, no prior) the solution's scale about the fixed camera is free
    and f32 rounding moves it: the port's centres and points are then
    compared after the 1-D scale fit about camera 0's centre, rotations
    as they are."""
    cj, xj, ij = out_j
    ct, xt, it = out_t
    fj, ft = float(ij["final_cost"]), float(it["final_cost"])
    assert abs(fj - ft) <= 1e-4 * fj, (fj, ft)
    i0 = float(ij["initial_cost"])
    assert abs(i0 - float(it["initial_cost"])) <= 1e-5 * i0
    ext = _extent(X)
    cj, xj, ct, xt = np.asarray(cj), np.asarray(xj), ct.numpy(), xt.numpy()
    if scale_gauge:
        Cj, Ct = _centers(cj), _centers(ct)
        c0 = Cj[0]
        A = np.concatenate([Ct - c0, xt - c0]).ravel()
        B = np.concatenate([Cj - c0, xj - c0]).ravel()
        s_fit = A @ B / (A @ A)
        assert abs(s_fit - 1.0) <= 1e-2, s_fit
        assert np.abs(c0 + s_fit * (Ct - c0) - Cj).max() <= 1e-4 * ext
        assert np.abs(c0 + s_fit * (xt - c0) - xj).max() <= 1e-4 * ext
        assert np.abs(cj[:, :3] - ct[:, :3]).max() <= 1e-4
        return
    assert np.abs(cj - ct).max() <= 1e-4 * ext
    assert np.abs(xj - xt).max() <= 1e-4 * ext


@pytest.mark.parametrize("loss", ["soft_l1", "linear"])
def test_bundle_adjust_plain(loss):
    cams_gt, X, problem, cams0, X0 = _start()
    kw = dict(max_iterations=15, cg_iterations=25, loss=loss)
    out_j = JB.bundle_adjust(jnp.asarray(cams0), jnp.asarray(X0), problem, JB.BAConfig(**kw))
    out_t = TB.bundle_adjust(torch.as_tensor(cams0), torch.as_tensor(X0), _port_problem(problem),
                             TB.BAConfig(**kw))
    if loss == "soft_l1":
        _compare(out_j, out_t, X, scale_gauge=True)
    else:
        # the quadratic loss converges into a flat valley within the 15
        # iterations; from there each LM accept is decided by cost changes
        # at f32 rounding level, which walk the two packages' solutions
        # apart along it (~6e-4 of the extent measured) at equal cost
        fj, ft = float(out_j[2]["final_cost"]), float(out_t[2]["final_cost"])
        assert abs(fj - ft) <= 1e-4 * fj, (fj, ft)


@pytest.mark.parametrize("prior", ["fixed_cams", "point_priors", "cam_pos_priors"])
def test_bundle_adjust_options(prior):
    cams_gt, X, problem, cams0, X0, off = jtests.TestBAPriors()._offset_problem()
    kw = dict(max_iterations=15, cg_iterations=25, fix_first_camera=False)
    if prior == "fixed_cams":
        fixed = np.zeros(6, bool)
        fixed[[0, 3]] = True
        jkw, tkw = dict(fixed_cams=jnp.asarray(fixed)), dict(fixed_cams=torch.as_tensor(fixed))
    elif prior == "point_priors":
        w = np.zeros(len(X), np.float32)
        w[:5] = 1e4
        jkw = dict(point_priors=(jnp.asarray(X), jnp.asarray(w)))
        tkw = dict(point_priors=(torch.as_tensor(X), torch.as_tensor(w)))
    else:
        cen = np.stack([-rigs_R(c[:3]).T @ c[3:] for c in cams_gt]).astype(np.float32)
        w = np.full(len(cams_gt), 1e3, np.float32)
        jkw = dict(cam_pos_priors=(jnp.asarray(cen), jnp.asarray(w)))
        tkw = dict(cam_pos_priors=(torch.as_tensor(cen), torch.as_tensor(w)))
    out_j = JB.bundle_adjust(jnp.asarray(cams0), jnp.asarray(X0), problem, JB.BAConfig(**kw),
                             **jkw)
    out_t = TB.bundle_adjust(torch.as_tensor(cams0), torch.as_tensor(X0), _port_problem(problem),
                             TB.BAConfig(**kw), **tkw)
    _compare(out_j, out_t, X)
    if prior == "fixed_cams":
        assert np.array_equal(out_t[0].numpy()[[0, 3]], cams0[[0, 3]])


# ---- mirrors of TestBundleAdjust / TestBAPriors on the port --------------
def test_ba_reduces_cost_and_recovers():
    cams_gt, X, problem, cams0, X0 = _start()
    cams_opt, X_opt, info = TB.bundle_adjust(
        torch.as_tensor(cams0), torch.as_tensor(X0), _port_problem(problem),
        TB.BAConfig(max_iterations=15, cg_iterations=25))
    assert float(info["final_cost"]) < float(info["initial_cost"]) * 0.02
    err0 = np.abs(cams0 - cams_gt).max()
    err1 = np.abs(cams_opt.numpy() - cams_gt).max()
    assert err1 < err0 * 0.5, (err0, err1)


def test_ba_robust_loss_with_outliers():
    cams_gt, X, problem = jtests.TestBundleAdjust().make_problem(noise=5e-4)
    b = np.array(problem.bearings)
    rng = np.random.default_rng(2)
    n_out = int(0.05 * len(b))
    idx = rng.choice(len(b), n_out, replace=False)
    d = rng.normal(size=(n_out, 3))
    b[idx] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    problem = problem._replace(bearings=jnp.asarray(b))
    cams0 = cams_gt + rng.normal(0, 0.01, cams_gt.shape).astype(np.float32)
    cams0[0] = cams_gt[0]
    X0 = X + rng.normal(0, 0.03, X.shape).astype(np.float32)
    pt = _port_problem(problem)
    cams_opt, _, _ = TB.bundle_adjust(torch.as_tensor(cams0), torch.as_tensor(X0), pt,
                                      TB.BAConfig(max_iterations=15, loss="soft_l1",
                                                  loss_scale=0.002))
    err1 = np.abs(cams_opt.numpy()[1:] - cams_gt[1:]).max()
    assert err1 < 0.02, err1
    cams_lin, _, _ = TB.bundle_adjust(torch.as_tensor(cams0), torch.as_tensor(X0), pt,
                                      TB.BAConfig(max_iterations=15, loss="linear"))
    assert err1 < np.abs(cams_lin.numpy()[1:] - cams_gt[1:]).max()


def test_gcp_point_priors_pin_absolute_frame():
    cams_gt, X, problem, cams0, X0, off = jtests.TestBAPriors()._offset_problem()
    cfg = TB.BAConfig(max_iterations=15, cg_iterations=25, fix_first_camera=False)
    pt = _port_problem(problem)
    _, X_free, _ = TB.bundle_adjust(torch.as_tensor(cams0), torch.as_tensor(X0), pt, cfg)
    assert np.abs(X_free.numpy() - X).mean() > 0.1
    w = np.zeros(len(X), np.float32)
    w[:5] = 1e4
    cams_p, X_p, _ = TB.bundle_adjust(torch.as_tensor(cams0), torch.as_tensor(X0), pt, cfg,
                                      point_priors=(torch.as_tensor(X), torch.as_tensor(w)))
    assert np.abs(X_p.numpy() - X).mean() < 0.01
    assert np.abs(cams_p.numpy() - cams_gt).max() < 0.02


def test_gps_camera_priors_pin_absolute_frame():
    cams_gt, X, problem, cams0, X0, off = jtests.TestBAPriors()._offset_problem()
    cfg = TB.BAConfig(max_iterations=15, cg_iterations=25, fix_first_camera=False)
    centers_gt = np.stack([-rigs_R(c[:3]).T @ c[3:] for c in cams_gt]).astype(np.float32)
    cams_p, X_p, _ = TB.bundle_adjust(
        torch.as_tensor(cams0), torch.as_tensor(X0), _port_problem(problem), cfg,
        cam_pos_priors=(torch.as_tensor(centers_gt), torch.full((6,), 1e3)))
    centers = np.stack([-rigs_R(c[:3]).T @ c[3:] for c in cams_p.numpy()])
    assert np.abs(centers - centers_gt).mean() < 0.01
    assert np.abs(X_p.numpy() - X).mean() < 0.02
