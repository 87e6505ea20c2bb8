"""Port parity: end-to-end gradients of rasterization() against JAX.

The loss of ``tests/test_stream_raster.py::_run`` (a weighted sum of the
RGB+ED render plus 0.3 * alpha) is differentiated with respect to means,
quats, scales, opacities and colours through the port (projection
autograd -> compositing autograd.Function: backward kernel's plain
version, key sort, segmented reduce) and through the JAX stream path
(custom VJP, Pallas kernels in interpret mode). Every gradient is held
within 5e-4 relative of its max, the bar the JAX package holds between
its own rasterizer paths (``tests/test_stream_raster.py:73``), on the
pinhole, spherical, edge-partial (40x24) and low-opacity scenes. The
pinhole case also passes ``means2d_dummy`` and ``absgrad_dummy`` and
holds their gradients (the densification statistics) to the same bar.
The empty scene gives a zero loss and finite, zero gradients.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splat_one_tpu.render.rasterization import rasterization as jras
from splat_one_tpu_torch.render.rasterization import rasterization as tras

from test_torch_stream_raster import _scene

NAMES = ("means", "quats", "scales", "opacities", "colors", "means2d_dummy",
         "absgrad_dummy")
CASES = {
    "pinhole": dict(model="pinhole", dummies=True),
    "spherical": dict(model="spherical"),
    "edge-partial": dict(model="pinhole", n=200, c=1, w=40, h=24),
    "low-opacity": dict(model="pinhole", n=500, c=1, seed=11, low_opacity=True),
}

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many small ops, which
    gain nothing from threads, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax_stream(case):
    kw = dict(CASES[case])
    model = kw.pop("model")
    dummies = kw.pop("dummies", False)
    low = kw.pop("low_opacity", False)
    means, quats, scales, opac, colors, viewmats, Ks, w, h = _scene(
        spherical=(model == "spherical"), **kw)
    if low:  # tests/test_stream_raster.py::test_stream_low_opacity_parity
        opac = np.random.default_rng(12).uniform(0.002, 0.08, opac.shape).astype(np.float32)
    C, N = viewmats.shape[0], means.shape[0]
    inputs = [means, quats, scales, opac, colors]
    if dummies:
        inputs += [np.zeros((C, N, 2), np.float32)] * 2

    def jloss(*a):
        extra = dict(means2d_dummy=a[5], absgrad_dummy=a[6]) if dummies else {}
        render, alpha, _ = jras(*a[:5], jnp.asarray(viewmats), jnp.asarray(Ks), w, h,
                                render_mode="RGB+ED", camera_model=model,
                                impl="stream", **extra)
        wts = jnp.linspace(0.5, 1.5, render.size).reshape(render.shape)
        return jnp.sum(render * wts) + 0.3 * jnp.sum(alpha)

    lj, gj = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(len(inputs)))))(
        *map(jnp.asarray, inputs))

    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    extra = dict(means2d_dummy=ts[5], absgrad_dummy=ts[6]) if dummies else {}
    render, alpha, info = tras(*ts[:5], torch.as_tensor(viewmats), torch.as_tensor(Ks),
                               w, h, render_mode="RGB+ED", camera_model=model, **extra)
    wts = torch.linspace(0.5, 1.5, render.numel()).reshape(render.shape)
    loss = torch.sum(render * wts) + 0.3 * torch.sum(alpha)
    loss.backward()
    assert abs(float(loss.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    for name, t, g in zip(NAMES, ts, gj):
        g = np.asarray(g)
        assert np.abs(g).max() > 0, name
        assert _rel(t.grad.numpy(), g) < 5e-4, f"grad {name}: {_rel(t.grad.numpy(), g):.3e}"
    assert torch.equal(info["radii_local"], info["radii"])


def test_empty_scene_grads():
    """tests/test_stream_raster.py::test_stream_empty_scene: every gaussian
    behind the camera -> zero loss, finite zero gradients."""
    means = torch.full((8, 3), 100.0, requires_grad=True)
    colors = torch.full((8, 3), 0.5, requires_grad=True)
    dummy = torch.zeros((1, 8, 2), requires_grad=True)
    render, alpha, info = tras(
        means, torch.tensor([[1.0, 0, 0, 0]]).repeat(8, 1), torch.full((8, 3), 0.01),
        torch.full((8,), 0.9), colors, torch.eye(4)[None],
        torch.tensor([[[60.0, 0, 16], [0, 60.0, 12], [0, 0, 1.0]]]), 32, 24,
        means2d_dummy=dummy, absgrad_dummy=torch.zeros((1, 8, 2)))
    loss = render.sum() + alpha.sum()
    loss.backward()
    assert float(loss.detach()) == 0.0 and int(info["n_isect"]) == 0
    for g in (means.grad, colors.grad, dummy.grad):
        assert torch.isfinite(g).all() and not g.any()
