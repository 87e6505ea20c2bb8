"""Port parity: forward compositing (stream_raster) against the JAX kernel.

The JAX Pallas forward kernel runs in interpret mode on the CPU, as the
JAX package's own tests run it. Both sides get the same stream layout and
packed field table (the JAX package's, as numpy), so the comparison is the
compositing function alone: rgb, alpha and depth within 1e-5 relative
(the JAX kernel forms in-chunk transmittance with a doubling product, the
port serially), n_chunks exactly equal. The CUDA kernel is held against
the plain version by the ``gpu`` test, which needs a card.
"""

import numpy as np
import pytest
import torch

from splat_one_tpu_torch.ops import projection as tp
from splat_one_tpu_torch.ops import stream_isect as tsi
from splat_one_tpu_torch.ops import stream_raster as tsr
from splat_one_tpu_torch.utils import cuda_build


def _scene(n=600, c=2, seed=0, w=64, h=48, spherical=False):
    """tests/test_stream_raster.py::_scene, as numpy."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=1.2, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = np.exp(rng.normal(loc=-2.8, scale=0.5, size=(n, 3))).astype(np.float32)
    opac = (1.0 / (1.0 + np.exp(-rng.normal(size=(n,))))).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    viewmats[:, 2, 3] = 6.0
    if c > 1:
        viewmats[1:, 0, 3] = 0.3
    Ks = np.zeros((c, 3, 3), np.float32)
    Ks[:, 0, 0] = Ks[:, 1, 1] = (w / (2 * np.pi)) if spherical else 60.0
    Ks[:, 0, 2] = w / 2
    Ks[:, 1, 2] = h / 2
    Ks[:, 2, 2] = 1.0
    return means, quats, scales, opac, colors, viewmats, Ks, w, h


CASES = {
    "pinhole": (dict(), "pinhole"),
    "spherical": (dict(spherical=True), "spherical"),
    "edge-partial": (dict(n=200, c=1, w=40, h=24), "pinhole"),
}


def _inputs(kw, model):
    """JAX stream layout + packed table for a scene, and the configs. (JAX
    is imported here, not at module level, so that the ``gpu`` test runs
    where JAX is not installed.)"""
    import jax
    import jax.numpy as jnp
    from splat_one_tpu.ops import projection as jp
    from splat_one_tpu.ops import stream_isect as jsi
    from splat_one_tpu.ops import stream_raster as jsr
    from test_torch_stream_isect import _jbuild

    means, quats, scales, opac, colors, viewmats, Ks, w, h = _scene(**kw)
    pj = jax.jit(jp.project_gaussians, static_argnums=(6, 7),
                 static_argnames=("camera_model",))(
        *map(jnp.asarray, (means, quats, scales, opac, viewmats, Ks)), w, h,
        colors=jnp.asarray(colors), camera_model=model)
    C, N = pj.depths.shape
    _, _, sw, sh = jsi.supertile_grid(w, h, 16)
    caps_j = jsi.StreamCaps.choose(N, C, C * sw * sh)
    caps_t = tsi.StreamCaps.choose(N, C, C * sw * sh)
    ij = _jbuild(pj, w, h, 16, caps_j, camera_model=model)
    packed = jsi.pack_stream(jsi.build_fields(pj), ij, caps_j)
    wrap = model == "spherical"
    cfg_j = jsr.StreamCfg.from_caps(caps_j, w, h, 16, C, N, wrap_x=wrap)
    cfg_t = tsr.StreamCfg.from_caps(caps_t, w, h, 16, C, N, wrap_x=wrap)
    return cfg_j, cfg_t, ij, packed, jsr


def _port_inputs(kw, model, device):
    """The port's own stream layout + packed table for a scene."""
    means, quats, scales, opac, colors, viewmats, Ks, w, h = _scene(**kw)
    t = lambda x: torch.as_tensor(x, device=device)
    proj = tp.project_gaussians(*map(t, (means, quats, scales, opac, viewmats, Ks)),
                                w, h, colors=t(colors), camera_model=model)
    C, N = proj.depths.shape
    _, _, sw, sh = tsi.supertile_grid(w, h, 16)
    caps = tsi.StreamCaps.choose(N, C, C * sw * sh)
    isect = tsi.build_stream_intersections(proj, w, h, 16, caps, camera_model=model)
    cfg = tsr.StreamCfg.from_caps(caps, w, h, 16, C, N, wrap_x=(model == "spherical"))
    return cfg, isect, tsi.pack_stream(tsi.build_fields(proj), isect, caps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_jax_kernel(case):
    cfg_j, cfg_t, ij, packed, jsr = _inputs(*CASES[case])
    st = ij.st_starts
    out_j = np.asarray(jsr._fwd_call(cfg_j, st, packed.T))
    before = dict(cuda_build.launch_counts)
    out_t = tsr.stream_fwd(cfg_t, torch.as_tensor(np.array(st)),
                           torch.as_tensor(np.array(packed))).numpy()
    assert dict(cuda_build.launch_counts) == before  # CPU: plain version
    assert out_t.shape == out_j.shape == (cfg_t.cs, 4, tsr.OUT_CH, 256)
    for ch, name in ((slice(0, 3), "rgb"), (slice(3, 4), "alpha"), (slice(4, 5), "depth")):
        a, b = out_t[:, :, ch], out_j[:, :, ch]
        rel = np.abs(a - b).max() / (np.abs(b).max() + 1e-8)
        assert rel < 1e-5, f"{name}: rel {rel:.3e}"
    np.testing.assert_array_equal(out_t[:, :, tsr.CH_NCHUNKS], out_j[:, :, tsr.CH_NCHUNKS])
    assert out_t[:, :, tsr.CH_NCHUNKS].max() >= 1
    np.testing.assert_array_equal(out_t[:, :, 6:], 0.0)
    # image assembly is shared layout code
    for x, y in zip(tsr.stream_to_image(cfg_t, torch.as_tensor(out_t)),
                    jsr.stream_to_image(cfg_j, out_t)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_plain_forward_early_termination():
    """An opaque stack: every tile stops after its first chunk, so
    n_chunks is 1 while the supertiles hold several chunks of slots."""
    n = 600
    cfg = tsr.StreamCfg(width=32, height=32, tile_size=16, num_cameras=1,
                        num_gaussians=n, chunk=128, exp_cap=n, n_supertiles=1)
    packed = torch.zeros((n + 128, tsi.NF))
    packed[:n, tsi.COL_X] = 16.0
    packed[:n, tsi.COL_Y] = 16.0
    packed[:n, tsi.COL_CA] = 1e-4
    packed[:n, tsi.COL_CC] = 1e-4
    packed[:n, tsi.COL_OPAC] = 0.99
    packed[:n, tsi.COL_R] = 1.0
    packed[:n, tsi.COL_DEPTH] = torch.arange(n) + 1.0
    packed[:n, tsi.COL_EXT_RX] = 300.0
    packed[:n, tsi.COL_EXT_RY] = 300.0
    out = tsr.stream_fwd(cfg, torch.tensor([0, n], dtype=torch.int32), packed)
    assert (out[:, :, tsr.CH_NCHUNKS] == 1).all()
    assert torch.allclose(out[:, :, 3], torch.ones(1), atol=1e-5)


def test_stream_fwd_rejects_other_devices():
    cfg = tsr.StreamCfg(width=32, height=32, tile_size=16, num_cameras=1,
                        num_gaussians=1, chunk=128, exp_cap=128, n_supertiles=1)
    with pytest.raises(ValueError):
        tsr.stream_fwd(cfg, torch.zeros(2, dtype=torch.int32, device="meta"),
                       torch.zeros((256, tsi.NF), device="meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(case):
    """Run on the card with ``python -m pytest
    tests/test_torch_stream_raster.py -m gpu --noconftest`` (the suite's
    conftest imports JAX)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, isect, packed = _port_inputs(*CASES[case], "cuda")
    st = isect.st_starts
    n0 = cuda_build.launch_counts["stream_fwd"]
    out_k = tsr.stream_fwd(cfg, st, packed)
    assert cuda_build.launch_counts["stream_fwd"] == n0 + 1
    out_p = tsr.stream_fwd_plain(cfg, st, packed)
    torch.cuda.synchronize()
    assert torch.allclose(out_k, out_p, rtol=0, atol=1e-5)
    assert torch.equal(out_k[:, :, tsr.CH_NCHUNKS], out_p[:, :, tsr.CH_NCHUNKS])
