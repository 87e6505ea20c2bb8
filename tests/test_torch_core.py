"""Port parity: splat_one_tpu_torch.core against splat_one_tpu.core.

Inputs come from seeded numpy and go through both packages on the CPU.
Tolerance: 1e-6 relative to the largest magnitude of the JAX output (f32
math in both; only library implementations of sqrt/atan2/asin and the
order of small sums differ).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splat_one_tpu.core import cameras as jcam
from splat_one_tpu.core import gaussians as jg
from splat_one_tpu.core import sh as jsh
from splat_one_tpu.core import transforms as jtf
from splat_one_tpu.data import synthetic as jsyn
from splat_one_tpu_torch.core import cameras as tcam
from splat_one_tpu_torch.core import gaussians as tg
from splat_one_tpu_torch.core import sh as tsh
from splat_one_tpu_torch.core import transforms as ttf
from splat_one_tpu_torch.data import synthetic as tsyn

REL = 1e-6


def _close(t, j, rel=REL):
    a = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    b = np.asarray(j)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a.astype(np.float64) - b).max() if a.size else 0.0
    assert err <= rel * (np.abs(b).max() + 1e-30), f"rel err {err / (np.abs(b).max() + 1e-30):.3e}"


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_transforms():
    rng = np.random.default_rng(0)
    q = _f32(rng, 7, 4)
    q2 = _f32(rng, 7, 4)
    d6 = _f32(rng, 7, 6)
    t = _f32(rng, 7, 3)
    T, J = torch.as_tensor, jnp.asarray
    _close(ttf.normalize(T(q)), jtf.normalize(J(q)))
    R = ttf.quat_to_rotmat(T(q))
    _close(R, jtf.quat_to_rotmat(J(q)))
    Rn = R.numpy()
    _close(ttf.rotmat_to_quat(T(Rn)), jtf.rotmat_to_quat(J(Rn)))
    _close(ttf.quat_multiply(T(q), T(q2)), jtf.quat_multiply(J(q), J(q2)))
    R6 = ttf.rotation_6d_to_matrix(T(d6))
    _close(R6, jtf.rotation_6d_to_matrix(J(d6)))
    _close(ttf.matrix_to_rotation_6d(R6), jtf.matrix_to_rotation_6d(J(R6.numpy())))
    Rc, tc = ttf.se3_compose(T(Rn), T(t), T(Rn[::-1].copy()), T(t[::-1].copy()))
    Rj, tj = jtf.se3_compose(J(Rn), J(t), J(Rn[::-1].copy()), J(t[::-1].copy()))
    _close(Rc, Rj)
    _close(tc, tj)
    V = ttf.make_viewmat(T(Rn), T(t))
    _close(V, jtf.make_viewmat(J(Rn), J(t)))
    _close(ttf.invert_se3(V), jtf.invert_se3(J(V.numpy())))


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh(degree):
    rng = np.random.default_rng(degree)
    dirs = _f32(rng, 50, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    coeffs = _f32(rng, 50, 25, 3, scale=0.3)
    _close(tsh.eval_sh_bases(degree, torch.as_tensor(dirs)),
           jsh.eval_sh_bases(degree, jnp.asarray(dirs)))
    _close(tsh.eval_sh(degree, torch.as_tensor(coeffs), torch.as_tensor(dirs)),
           jsh.eval_sh(degree, jnp.asarray(coeffs), jnp.asarray(dirs)))
    assert tsh.num_sh_bases(degree) == jsh.num_sh_bases(degree)


def test_sh_rgb_roundtrip():
    rgb = np.random.default_rng(3).uniform(size=(20, 3)).astype(np.float32)
    sh0 = tsh.rgb_to_sh(torch.as_tensor(rgb))
    _close(sh0, jsh.rgb_to_sh(jnp.asarray(rgb)))
    _close(tsh.sh_to_rgb(sh0), jsh.sh_to_rgb(jnp.asarray(sh0.numpy())))
    with pytest.raises(ValueError):
        tsh.eval_sh_bases(5, torch.zeros(1, 3))


@pytest.mark.parametrize("model", ["pinhole", "ortho", "fisheye", "spherical"])
def test_project(model):
    rng = np.random.default_rng(7)
    p = _f32(rng, 40, 3)
    p[:, 2] = np.abs(p[:, 2]) + 0.5
    K = np.float32([[60.0, 0, 32], [0, 55.0, 24], [0, 0, 1]])
    out_t = tcam.project(torch.as_tensor(p), torch.as_tensor(K), 64, 48, model)
    _close(out_t, jcam.project(jnp.asarray(p), jnp.asarray(K), 64, 48, model))
    if model == "fisheye":
        dist = np.float32([0.05, -0.01, 0.002, 0.0])
        _close(tcam.project(torch.as_tensor(p), torch.as_tensor(K), 64, 48, model,
                            dist=torch.as_tensor(dist)),
               jcam.project(jnp.asarray(p), jnp.asarray(K), 64, 48, model,
                            dist=jnp.asarray(dist)))
    uv = out_t.numpy()
    np.testing.assert_array_equal(
        tcam.in_image(torch.as_tensor(uv), 64, 48, margin=2.0).numpy(),
        np.asarray(jcam.in_image(jnp.asarray(uv), 64, 48, margin=2.0)))
    _close(tcam.visible_depth(torch.as_tensor(p), model),
           jcam.visible_depth(jnp.asarray(p), model))
    with pytest.raises(ValueError):
        tcam.project(torch.as_tensor(p), torch.as_tensor(K), 64, 48, "cylinder")


@pytest.mark.parametrize("init", ["points", "random"])
def test_gaussian_init_and_activation(init):
    rng = np.random.default_rng(11)
    if init == "points":
        pts = _f32(rng, 64, 3)
        rgbs = rng.uniform(size=(64, 3))
        pt, at = tg.init_splats_from_points(pts, rgbs, 80, sh_degree=2, seed=4,
                                            device="cpu")
        pj, aj = jg.init_splats_from_points(pts, rgbs, 80, sh_degree=2, seed=4)
    else:
        pt, at = tg.init_splats_random(80, 50, 2.0, sh_degree=3, seed=5, device="cpu")
        pj, aj = jg.init_splats_random(80, 50, 2.0, sh_degree=3, seed=5)
    assert sorted(pt) == sorted(pj)
    for k in pj:
        _close(pt[k], pj[k])
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    for x, y in zip(tg.activated(pt, at), jg.activated(pj, aj)):
        _close(x, y)
    pts = _f32(rng, 300, 3)
    np.testing.assert_allclose(tg._knn_mean_dist(pts), jg._knn_mean_dist(pts), rtol=1e-6)


@pytest.mark.parametrize("surface", [False, True])
def test_synthetic_rig_and_gaussians(surface):
    """data/synthetic is numpy in both packages: equal bit for bit."""
    eye, target = np.float64([1.5, -0.4, 2.0]), np.float64([0.1, 0.2, -0.3])
    np.testing.assert_array_equal(tsyn.look_at(eye, target), jsyn.look_at(eye, target))
    for a, b in zip(tsyn.ring_cameras(7, 3.0, -0.5, 60.0, 96, 64),
                    jsyn.ring_cameras(7, 3.0, -0.5, 60.0, 96, 64)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsyn.make_gt_gaussians(200, seed=2, extent=1.3, surface=surface),
                    jsyn.make_gt_gaussians(200, seed=2, extent=1.3, surface=surface)):
        np.testing.assert_array_equal(a, b)
