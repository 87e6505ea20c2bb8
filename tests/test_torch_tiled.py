"""Port parity: rasterization(impl="tiled") end to end.

- Against JAX ``impl="tiled"`` (its Pallas kernels in interpret mode):
  all five render modes on the pinhole, spherical, fisheye, ortho and
  low-opacity scenes, with backgrounds, within 1e-5 relative (fisheye
  2e-5, see test_torch_rasterization.py); ``valid``, ``n_isect`` and
  ``overflow`` exactly; ``impl`` inferred from ``IsectCaps``.
- The port's own stream path against its tiled path, at the bars the JAX
  package holds between them (tests/test_stream_raster.py): loss and
  renders within 1e-5 relative, every input gradient within 5e-4 of its
  max; the low-opacity scene at 1e-5 absolute and 1e-4 relative.
- Against the port's dense oracle: renders within 1e-4 absolute (expected
  depth 5e-4), gradients within 5e-4 of each gradient's max
  (tests/test_rasterizer.py), and absgrad bounds |d means2d|.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splat_one_tpu.ops.intersect import IsectCaps as JIsectCaps
from splat_one_tpu.render.rasterization import rasterization as jras
from splat_one_tpu_torch.ops.intersect import IsectCaps
from splat_one_tpu_torch.ops.projection import project_gaussians
from splat_one_tpu_torch.ops.reference import composite_reference
from splat_one_tpu_torch.render.rasterization import rasterization as tras

from test_torch_rasterization import MODES, SCENES, _rel, _sh_scene
from test_torch_stream_raster import _scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many small ops, which
    gain nothing from threads, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _n_tiles(w, h):
    return (-(-w // 16)) * (-(-h // 16))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_tiled_matches_jax_tiled(scene):
    args, kw = SCENES[scene]()
    arrays, (w, h) = args[:7], args[7:]
    C, N = arrays[5].shape[0], arrays[0].shape[0]
    bg = np.random.default_rng(21).uniform(size=(C, 3)).astype(np.float32)
    # room for the ortho scene's large footprints (8 tiles per gaussian,
    # the default, overflow there in both packages alike)
    caps_j = JIsectCaps.choose(N, C, _n_tiles(w, h), avg_tiles_per_gaussian=24.0)
    caps = IsectCaps.choose(N, C, _n_tiles(w, h), avg_tiles_per_gaussian=24.0)

    @jax.jit
    def jax_fn(*a):  # every mode in one compile of the interpret-mode kernel
        outs = {}
        for mode in MODES:
            render, alpha, info = jras(*a, w, h, render_mode=mode, caps=caps_j,
                                       backgrounds=jnp.asarray(bg), **kw)
            outs[mode] = (render, alpha)
        return outs, {k: info[k] for k in ("valid", "n_isect", "overflow")}

    outs_j, ij = jax_fn(*map(jnp.asarray, arrays))
    tol = 2e-5 if kw["camera_model"] == "fisheye" else 1e-5
    for mode in MODES:
        rt, at, it = tras(*map(torch.as_tensor, arrays), w, h, render_mode=mode,
                          backgrounds=torch.as_tensor(bg), caps=caps, **kw)
        rj, aj = outs_j[mode]
        assert rt.shape == rj.shape and at.shape == aj.shape
        assert _rel(rt.numpy(), np.asarray(rj)) < tol, mode
        assert _rel(at.numpy(), np.asarray(aj)) < tol, mode
    np.testing.assert_array_equal(it["valid"].numpy(), np.asarray(ij["valid"]))
    assert int(it["n_isect"]) == int(ij["n_isect"]) > 0
    assert bool(it["overflow"]) == bool(ij["overflow"]) is False


def _loss(impl, inputs, viewmats, Ks, w, h, model, mode="RGB+ED"):
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    render, alpha, info = tras(*ts, torch.as_tensor(viewmats), torch.as_tensor(Ks), w, h,
                               render_mode=mode, camera_model=model, impl=impl)
    wts = torch.linspace(0.5, 1.5, render.numel()).reshape(render.shape)
    loss = torch.sum(render * wts) + (0.3 * torch.sum(alpha) if mode == "RGB+ED" else 0.0)
    loss.backward()
    assert not bool(info["overflow"])
    return float(loss.detach()), render.detach().numpy(), alpha.detach().numpy(), [
        t.grad.numpy() for t in ts]


STREAM_CASES = {
    "pinhole": dict(model="pinhole"),
    "spherical": dict(model="spherical"),
    "edge-partial": dict(model="pinhole", n=200, c=1, w=40, h=24),
    "low-opacity": dict(model="pinhole", n=500, c=1, seed=11, low_opacity=True),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_port_stream_matches_port_tiled(case):
    kw = dict(STREAM_CASES[case])
    model = kw.pop("model")
    low = kw.pop("low_opacity", False)
    means, quats, scales, opac, colors, viewmats, Ks, w, h = _scene(
        spherical=(model == "spherical"), **kw)
    if low:  # tests/test_stream_raster.py::test_stream_low_opacity_parity
        opac = np.random.default_rng(12).uniform(0.002, 0.08, opac.shape).astype(np.float32)
    inputs = [means, quats, scales, opac, colors]
    mode = "RGB" if low else "RGB+ED"
    l_t, r_t, a_t, g_t = _loss("tiled", inputs, viewmats, Ks, w, h, model, mode)
    l_s, r_s, a_s, g_s = _loss("stream", inputs, viewmats, Ks, w, h, model, mode)
    if low:
        assert np.abs(r_s - r_t).max() < 1e-5
        gtol = 1e-4
    else:
        assert abs(l_s - l_t) <= 1e-5 * abs(l_t)
        assert _rel(r_s, r_t) < 1e-5 and _rel(a_s, a_t) < 1e-5
        gtol = 5e-4
    for name, x, y in zip(("means", "quats", "scales", "opac", "colors"), g_s, g_t):
        assert np.abs(y).max() > 0, name
        assert _rel(x, y) < gtol, f"grad {name}: {_rel(x, y):.3e}"


@pytest.mark.parametrize("scene", ["pinhole", "spherical", "ortho"])
def test_tiled_matches_oracle(scene):
    args, kw = SCENES[scene]()
    t = [torch.as_tensor(x) for x in args[:7]]
    w, h = args[7:]
    C, N = t[5].shape[0], t[0].shape[0]
    caps = IsectCaps.choose(N, C, _n_tiles(w, h), avg_tiles_per_gaussian=24.0)
    render, alpha, info = tras(*t, w, h, render_mode="RGB+D", caps=caps, **kw)
    colors = dict(sh_coeffs=t[4], sh_degree=kw["sh_degree"]) if "sh_degree" in kw \
        else dict(colors=t[4])
    proj = project_gaussians(*t[:4], t[5], t[6], w, h,
                             camera_model=kw["camera_model"], **colors)
    rgb_o, a_o, d_o = composite_reference(
        proj, w, h, wrap_x=(kw["camera_model"] == "spherical"))
    assert alpha.max() > 0.1 and not bool(info["overflow"])
    np.testing.assert_allclose(render[..., :3], rgb_o, atol=1e-4)
    np.testing.assert_allclose(alpha, a_o, atol=1e-4)
    np.testing.assert_allclose(render[..., 3:], d_o, atol=1e-4)


def test_tiled_grads_match_oracle():
    """tests/test_rasterizer.py::TestGradParity (150 gaussians, seed 7,
    64x64, SH degree 1, random weights on rgb, alpha and expected depth)."""
    (means, quats, scales, opac, sh, viewmats, Ks, w, h), _ = _sh_scene(150, 7, "pinhole")
    rng = np.random.default_rng(0)
    wr, wa, wd = (torch.as_tensor(rng.normal(size=(1, h, w, c)).astype(np.float32))
                  for c in (3, 1, 1))
    vm, K = torch.as_tensor(viewmats), torch.as_tensor(Ks)
    grads = []
    for path in ("tiled", "oracle"):
        leaves = [torch.tensor(x, requires_grad=True) for x in (means, quats, scales, opac, sh)]
        if path == "tiled":
            render, alpha, _ = tras(*leaves, vm, K, w, h, sh_degree=1, render_mode="RGB+ED",
                                    caps=IsectCaps.choose(150, 1, 16))
            rgb, d_exp = render[..., :3], render[..., 3:]
        else:
            proj = project_gaussians(*leaves[:4], vm, K, w, h, sh_coeffs=leaves[4],
                                     sh_degree=1)
            rgb, alpha, d = composite_reference(proj, w, h)
            d_exp = d / torch.clamp(alpha, min=1e-10)
        loss = (rgb * wr).sum() + (alpha * wa).sum() + (d_exp * wd).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    for name, gt, go in zip(("means", "quats", "scales", "opac", "sh"), *grads):
        assert _rel(gt.numpy(), go.numpy()) < 5e-4, name

    # absgrad sums |per-pixel d means2d| >= |their sum|
    dummy = torch.zeros((1, 150, 2), requires_grad=True)
    absd = torch.zeros((1, 150, 2), requires_grad=True)
    render, _, _ = tras(*map(torch.as_tensor, (means, quats, scales, opac, sh)), vm, K, w, h,
                        sh_degree=1, impl="tiled", means2d_dummy=dummy, absgrad_dummy=absd)
    gm, ga = torch.autograd.grad((render * wr).sum(), [dummy, absd])
    assert torch.isfinite(ga).all() and ga.max() > 0
    assert (ga + 1e-6 >= gm.abs()).all()
