"""Port parity: rasterization() (forward) against the JAX stream path.

Renders within 1e-5 relative of JAX ``impl="stream"`` (the bar the JAX
package holds between its own rasterizer paths), with backgrounds: all
five render modes on the pinhole, spherical, fisheye, ortho and
low-opacity scenes (each JAX render compiles its interpret-mode Pallas
kernel, a few seconds apiece).
Fisheye renders are held at 2e-5: the closed-form fisheye Jacobian
subtracts nearly equal terms (a_f - b_f), which turns the last-ulp
difference between XLA's and PyTorch's atan2 into ~6e-7 relative on the
conics (measured 1.04e-5 on the render). ``info``: ``valid``, ``n_isect``
and ``overflow`` exactly; ``radii`` and ``depths`` within 1e-4 of the
jitted JAX render's: XLA's fusion under jit rounds the projection
differently from JAX run eagerly (6.4e-5 relative on ortho radii, whose
formula cancels). test_torch_projection.py holds every projected field
to 1e-5 against eager JAX.
Against the port's own dense oracle: 1e-4 absolute, the bar of
tests/test_rasterizer.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splat_one_tpu.render.rasterization import rasterization as jras
from splat_one_tpu_torch.ops.projection import project_gaussians
from splat_one_tpu_torch.ops.reference import composite_reference
from splat_one_tpu_torch.render.rasterization import rasterization as tras

from test_torch_stream_raster import _scene

MODES = ["RGB", "RGB+ED", "RGB+D", "ED", "D"]


def _sh_scene(n, seed, model):
    """tests/test_rasterizer.py::make_scene (SH degree 1, 64x64)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    means[:, 2] += 4
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = (np.exp(rng.uniform(-3.5, -2.0, (n, 3))) * 3).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, n).astype(np.float32)
    sh = (rng.normal(size=(n, 4, 3)) * 0.3).astype(np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None]
    Ks = np.float32([[[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]]])
    return (means, quats, scales, opac, sh, viewmats, Ks, 64, 64), dict(
        sh_degree=1, camera_model=model)


def _stream_scene(model="pinhole", low_opacity=False, **kw):
    if low_opacity:
        kw = dict(n=500, c=1, seed=11)
    args = list(_scene(spherical=(model == "spherical"), **kw))
    if low_opacity:
        # tests/test_stream_raster.py::test_stream_low_opacity_parity
        rng = np.random.default_rng(12)
        args[3] = rng.uniform(0.002, 0.08, args[3].shape).astype(np.float32)
    return tuple(args), dict(camera_model=model)


SCENES = {
    "pinhole": lambda: _stream_scene(),
    "spherical": lambda: _stream_scene("spherical"),
    "fisheye": lambda: _sh_scene(250, 9, "fisheye"),
    "ortho": lambda: _sh_scene(300, 2, "ortho"),
    "low-opacity": lambda: _stream_scene(low_opacity=True),
}
PAIRS = [(s, m) for s in SCENES for m in MODES]


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-8)


@pytest.mark.parametrize("scene,mode", PAIRS)
def test_rasterization_matches_jax_stream(scene, mode):
    args, kw = SCENES[scene]()
    arrays, (w, h) = args[:7], args[7:]
    C = arrays[5].shape[0]
    bg = np.random.default_rng(21).uniform(size=(C, 3)).astype(np.float32)

    def jax_fn(*a):
        render, alpha, info = jras(*a, w, h, render_mode=mode, impl="stream",
                                   backgrounds=jnp.asarray(bg), **kw)
        return render, alpha, {k: info[k] for k in
                               ("radii", "depths", "valid", "n_isect", "overflow")}

    rj, aj, ij = jax.jit(jax_fn)(*map(jnp.asarray, arrays))
    rt, at, it = tras(*map(torch.as_tensor, arrays), w, h, render_mode=mode,
                      backgrounds=torch.as_tensor(bg), **kw)
    tol = 2e-5 if kw["camera_model"] == "fisheye" else 1e-5
    assert rt.shape == rj.shape and at.shape == aj.shape
    assert _rel(rt.numpy(), np.asarray(rj)) < tol
    assert _rel(at.numpy(), np.asarray(aj)) < tol
    np.testing.assert_array_equal(it["valid"].numpy(), np.asarray(ij["valid"]))
    assert int(it["n_isect"]) == int(ij["n_isect"]) > 0
    assert bool(it["overflow"]) == bool(ij["overflow"]) is False
    for k in ("radii", "depths"):
        assert _rel(it[k].numpy(), np.asarray(ij[k])) < 1e-4
    assert (it["width"], it["height"], it["n_cameras"]) == (w, h, C)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_rasterization_matches_oracle(scene):
    args, kw = SCENES[scene]()
    t = [torch.as_tensor(x) for x in args[:7]]
    w, h = args[7:]
    render, alpha, info = tras(*t, w, h, render_mode="RGB+D", **kw)
    colors = dict(sh_coeffs=t[4], sh_degree=kw["sh_degree"]) if "sh_degree" in kw \
        else dict(colors=t[4])
    proj = project_gaussians(*t[:4], t[5], t[6], w, h,
                             camera_model=kw["camera_model"], **colors)
    rgb_o, a_o, d_o = composite_reference(
        proj, w, h, wrap_x=(kw["camera_model"] == "spherical"))
    assert alpha.max() > 0.1
    np.testing.assert_allclose(render[..., :3], rgb_o, atol=1e-4)
    np.testing.assert_allclose(alpha, a_o, atol=1e-4)
    np.testing.assert_allclose(render[..., 3:], d_o, atol=1e-4)


def test_rasterization_refuses_what_is_not_ported():
    args, kw = SCENES["pinhole"]()
    t = [torch.as_tensor(x) for x in args[:7]]
    w, h = args[7:]
    for bad in (dict(impl="tiled"), dict(st_shard=("gauss", 2)),
                dict(proj_transform=lambda p: p)):
        with pytest.raises(NotImplementedError):
            tras(*t, w, h, **bad)
    # inputs that require grad render (gradients: test_torch_grads.py)
    means = t[0].clone().requires_grad_(True)
    render, _, _ = tras(means, *t[1:], w, h)
    assert render.requires_grad
    with torch.no_grad():
        plain, _, _ = tras(means, *t[1:], w, h)
    assert plain.shape == (2, h, w, 3) and torch.equal(plain, render.detach())
    with pytest.raises(ValueError):
        tras(*t, w, h, render_mode="RGB+X")
