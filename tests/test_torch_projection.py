"""Port parity: splat_one_tpu_torch.ops.projection against the JAX package.

Every ``Projected`` field for the four camera models, classic and
antialiased, with an ``alive`` mask: ``valid`` exactly equal, floats within
1e-5 relative (f32 in both; atan2/asin/sqrt implementations differ by an
ulp or so). The membership helpers are held at 1e-6.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splat_one_tpu.ops import projection as jp
from splat_one_tpu_torch.ops import projection as tp


def _close(t, j, rel):
    a, b = t.numpy(), np.asarray(j)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a.astype(np.float64) - b).max() if a.size else 0.0
    assert err <= rel * (np.abs(b).max() + 1e-30), f"rel err {err / np.abs(b).max():.3e}"


def _scene(model, n=300, seed=0, c=2):
    """tests/test_rasterizer.py::make_scene, with a second camera."""
    rng = np.random.default_rng(seed)
    if model == "spherical":
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        means = (d * rng.uniform(2.0, 4.0, (n, 1))).astype(np.float32)
        w, h = 128, 64
    else:
        means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        means[:, 2] += 4
        w, h = 64, 64
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = (np.exp(rng.uniform(-3.5, -2.0, (n, 3))) * 3).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, n).astype(np.float32)
    sh = (rng.normal(size=(n, 9, 3)) * 0.3).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    viewmats[1:, 0, 3] = 0.4
    viewmats[1:, 1, 3] = -0.2
    Ks = np.tile(np.float32([[60.0, 0, 32], [0, 58.0, 32], [0, 0, 1]]), (c, 1, 1))
    alive = rng.uniform(size=n) > 0.1
    return means, quats, scales, opac, sh, viewmats, Ks, alive, w, h


def _both(model, antialiased, **kw):
    means, quats, scales, opac, sh, viewmats, Ks, alive, w, h = _scene(model)
    args = (means, quats, scales, opac, viewmats, Ks)
    if "colors" in kw:
        extra_t = dict(colors=torch.as_tensor(kw["colors"]))
        extra_j = dict(colors=jnp.asarray(kw["colors"]))
    else:
        extra_t = dict(sh_coeffs=torch.as_tensor(sh), sh_degree=2)
        extra_j = dict(sh_coeffs=jnp.asarray(sh), sh_degree=2)
    common = dict(camera_model=model, antialiased=antialiased, radius_clip=0.5,
                  near_plane=0.05)
    pt = tp.project_gaussians(*map(torch.as_tensor, args), w, h,
                              alive=torch.as_tensor(alive), **extra_t, **common)
    pj = jp.project_gaussians(*map(jnp.asarray, args), w, h,
                              alive=jnp.asarray(alive), **extra_j, **common)
    return pt, pj


@pytest.mark.parametrize("antialiased", [False, True])
@pytest.mark.parametrize("model", ["pinhole", "ortho", "fisheye", "spherical"])
def test_project_gaussians(model, antialiased):
    pt, pj = _both(model, antialiased)
    np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(pj.valid))
    assert pt.valid.any() and not pt.valid.all()
    for f in ("means2d", "conics", "depths", "radii", "colors", "opacities"):
        _close(getattr(pt, f), getattr(pj, f), 1e-5)


@pytest.mark.parametrize("per_camera", [False, True])
def test_project_gaussians_flat_colors(per_camera):
    rng = np.random.default_rng(3)
    shape = (2, 300, 3) if per_camera else (300, 3)
    colors = rng.uniform(size=shape).astype(np.float32)
    pt, pj = _both("pinhole", False, colors=colors)
    np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(pj.valid))
    _close(pt.colors, pj.colors, 0.0)
    _close(pt.conics, pj.conics, 1e-5)


def test_membership_helpers():
    rng = np.random.default_rng(5)
    op = np.r_[np.geomspace(1e-6, 1.0, 64), 1.0 / 255.0, 0.3527].astype(np.float32)
    _close(tp.opacity_extent(torch.as_tensor(op)),
           jp.opacity_extent(jnp.asarray(op)), 1e-6)
    a = rng.uniform(0.01, 0.5, 66).astype(np.float32)
    c = rng.uniform(0.01, 0.5, 66).astype(np.float32)
    b = (rng.uniform(-0.9, 0.9, 66) * np.sqrt(a * c)).astype(np.float32)
    for o in (None, op):
        rt = tp.conic_ellipse_radii(*map(torch.as_tensor, (a, b, c)),
                                    None if o is None else torch.as_tensor(o))
        rj = jp.conic_ellipse_radii(*map(jnp.asarray, (a, b, c)),
                                    None if o is None else jnp.asarray(o))
        for x, y in zip(rt, rj):
            _close(x, y, 1e-6)
