"""Port parity: forward compositing (stream_raster) against the JAX kernel.

The JAX Pallas forward kernel runs in interpret mode on the CPU, as the
JAX package's own tests run it. Both sides get the same stream layout and
packed field table (the JAX package's, as numpy), so the comparison is the
compositing function alone: rgb, alpha and depth within 1e-5 relative
(the JAX kernel forms in-chunk transmittance with a doubling product, the
port serially), n_chunks exactly equal. The scenes: the small pinhole,
spherical and edge-partial ones and a crowded spherical view whose longest
supertile holds 36 chunks. The CUDA kernel is held against the plain
version bit for bit by the ``gpu`` test, which needs a card.
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import bench_scene, crowded_spherical_scene, deep_stack_scene
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


def _as_tuple(sc):
    """A scene dict of chip_smoke.py as ``_scene``'s tuple."""
    return tuple(sc[k] for k in ("means", "quats", "scales", "opac", "colors", "viewmats",
                                 "Ks", "w", "h"))


def _deep_stack_scene():
    """chip_smoke.py::deep_stack_scene, as ``_scene``'s tuple."""
    return _as_tuple(deep_stack_scene())


def _crowded_scene():
    """chip_smoke.py::crowded_spherical_scene, as ``_scene``'s tuple."""
    return _as_tuple(crowded_spherical_scene())


def _bench_spherical_scene():
    """chip_smoke.py's bench scene at 100k gaussians, 640x320, for the
    spherical camera of its phase 4 (colours from the SH DC term), as
    ``_scene``'s tuple."""
    sc = bench_scene(100_000, 640, 320, 500.0, -5.5, -4.0, seed=1)
    return _as_tuple(dict(sc, colors=np.clip(sc["sh"][:, 0] + 0.5, 0.0, 1.0)))


CASES = {
    "pinhole": (dict(), "pinhole"),
    "spherical": (dict(spherical=True), "spherical"),
    "edge-partial": (dict(n=200, c=1, w=40, h=24), "pinhole"),
}
# the gpu tests of the kernels: (a function making the scene, camera model)
# for each of CASES, the deep-stack scene, the crowded spherical scene and
# a spherical view of the bench scene
GPU_CASES = {k: (functools.partial(_scene, **kw), m) for k, (kw, m) in CASES.items()}
GPU_CASES["deep-stack"] = (_deep_stack_scene, "pinhole")
GPU_CASES["crowded-spherical"] = (_crowded_scene, "spherical")
GPU_CASES["bench-spherical"] = (_bench_spherical_scene, "spherical")
# the forward's parity against the JAX kernel: CASES and the crowded scene
FWD_CASES = {k: GPU_CASES[k] for k in (*CASES, "crowded-spherical")}


def _inputs(kw, model):
    """JAX stream layout + packed table for ``_scene(**kw)``, and the
    configs."""
    return _jax_inputs(_scene(**kw), model)


def _jax_inputs(scene, model):
    """JAX stream layout + packed table for a scene (``_scene``'s tuple),
    and the configs. (JAX is imported here, not at module level, so that
    the ``gpu`` tests run where JAX is not installed.)"""
    import jax
    import jax.numpy as jnp
    from splat_one_tpu.ops import projection as jp
    from splat_one_tpu.ops import stream_isect as jsi
    from splat_one_tpu.ops import stream_raster as jsr
    from test_torch_stream_isect import _jbuild

    means, quats, scales, opac, colors, viewmats, Ks, w, h = scene
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


def _port_inputs(scene, model, device):
    """The port's own stream layout + packed table for a scene (``_scene``'s
    tuple)."""
    means, quats, scales, opac, colors, viewmats, Ks, w, h = scene
    t = lambda x: torch.as_tensor(x, device=device)
    proj = tp.project_gaussians(*map(t, (means, quats, scales, opac, viewmats, Ks)),
                                w, h, colors=t(colors), camera_model=model)
    C, N = proj.depths.shape
    _, _, sw, sh = tsi.supertile_grid(w, h, 16)
    caps = tsi.StreamCaps.choose(N, C, C * sw * sh)
    isect = tsi.build_stream_intersections(proj, w, h, 16, caps, camera_model=model)
    cfg = tsr.StreamCfg.from_caps(caps, w, h, 16, C, N, wrap_x=(model == "spherical"))
    return cfg, isect, tsi.pack_stream(tsi.build_fields(proj), isect, caps)


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_plain_forward_matches_jax_kernel(case):
    scene, model = FWD_CASES[case]
    cfg_j, cfg_t, ij, packed, jsr = _jax_inputs(scene(), model)
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


TERMS = (0.0, 1e-5, 1e-3)


def test_plain_forward_term_thresh_matches_jax():
    """``StreamCfg.term_thresh`` at 0, 1e-5 and 1e-3 on the deep-stack
    scene (supertile 2's tiles stop after 2 of its 6 chunks at 1e-5):
    the plain version against the JAX kernel with the same threshold,
    rgb, alpha and depth within 1e-5 rel, n_chunks exact. A larger
    threshold stops tiles sooner; at 0 no tile stops early."""
    import dataclasses

    cfg_j, cfg_t, ij, packed, jsr = _jax_inputs(_deep_stack_scene(), "pinhole")
    st_t = torch.as_tensor(np.array(ij.st_starts))
    pk_t = torch.as_tensor(np.array(packed))
    nch = {}
    for term in TERMS:
        cj = dataclasses.replace(cfg_j, term_thresh=term)
        ct = dataclasses.replace(cfg_t, term_thresh=term)
        out_j = np.asarray(jsr._fwd_call(cj, ij.st_starts, packed.T))
        out_t = tsr.stream_fwd(ct, st_t, pk_t).numpy()
        for ch in (slice(0, 3), slice(3, 4), slice(4, 5)):
            rel = np.abs(out_t[:, :, ch] - out_j[:, :, ch]).max() / (
                np.abs(out_j[:, :, ch]).max() + 1e-8)
            assert rel < 1e-5, (term, ch, rel)
        np.testing.assert_array_equal(out_t[:, :, tsr.CH_NCHUNKS], out_j[:, :, tsr.CH_NCHUNKS])
        nch[term] = out_t[:, :, tsr.CH_NCHUNKS, 0]
    assert tsr.StreamCfg.from_caps(tsi.StreamCaps.choose(8, 1, 1), 32, 32, 16, 1, 8
                                   ).term_thresh == tsr.TERM_THRESH == 1e-5
    assert (nch[0.0] >= nch[1e-5]).all() and (nch[1e-5] >= nch[1e-3]).all()
    assert (nch[0.0] > nch[1e-5]).any() and (nch[1e-5] > nch[1e-3]).any()
    # supertile 0's tiles end where their gated slots end at every threshold;
    # supertile 2's saturate after 2 chunks (one after 1 at 1e-3), and at 0
    # walk all 6
    for term in TERMS:
        assert nch[term][0].tolist() == [12.0, 1.0, 7.0, 0.0]
    assert nch[0.0][2].tolist() == [6.0] * 4
    assert nch[1e-5][2].tolist() == [2.0] * 4
    assert nch[1e-3][2].tolist() == [2.0, 1.0, 2.0, 2.0]


def test_deep_stack_scene_layout():
    """The deep-stack scene has what the backward kernels' gpu tests need:
    a supertile of 12 chunks whose tiles stop after 12, 1, 7 and 0 of them,
    a supertile that saturates before its last chunk, and a tile of 9
    chunks on the tiled path."""
    from splat_one_tpu_torch.ops import intersect as tis
    from splat_one_tpu_torch.ops import tile_raster as ttr

    scene = _deep_stack_scene()
    cfg, isect, packed = _port_inputs(scene, "pinhole", "cpu")
    assert not bool(isect.overflow)
    starts = isect.st_starts.long()
    chunks = (starts[1:] - (starts[:-1] // 128) * 128 + 127) // 128
    out = tsr.stream_fwd(cfg, isect.st_starts, packed)
    nch = out[:, :, tsr.CH_NCHUNKS, 0]
    assert chunks.tolist() == [12, 3, 6]
    assert nch[0].tolist() == [12.0, 1.0, 7.0, 0.0]
    assert nch[2].max() < chunks[2]
    means, quats, scales, opac, colors, viewmats, Ks, w, h = scene
    t = torch.as_tensor
    proj = tp.project_gaussians(*map(t, (means, quats, scales, opac, viewmats, Ks)),
                                w, h, colors=t(colors))
    caps = tis.IsectCaps.choose(proj.depths.shape[1], 1, 12)
    it = tis.build_intersections(proj, w, h, 16, caps)
    cfg_t = ttr.RasterCfg(width=w, height=h, tile_size=16, num_cameras=1,
                          num_gaussians=proj.depths.shape[1], chunk=128,
                          align_cap=caps.align_cap)
    pk = tis.pack_fields(proj.means2d, proj.conics, proj.colors, proj.opacities,
                         proj.depths, it)
    out_t = ttr.tile_fwd(cfg_t, it.tile_starts, pk)
    assert out_t[:, ttr.CH_NCHUNKS, 0].max() == 9


def test_crowded_spherical_scene_layout():
    """The crowded spherical scene has what the forward kernels' gpu tests
    need: a supertile of at least 30 chunks whose slots straddle the
    azimuth seam and whose tiles stop at different chunks, one never; on
    the tiled path a tile that stops early and one that never does."""
    from splat_one_tpu_torch.ops import intersect as tis
    from splat_one_tpu_torch.ops import tile_raster as ttr

    scene = _crowded_scene()
    w = scene[7]
    cfg, isect, packed = _port_inputs(scene, "spherical", "cpu")
    assert not bool(isect.overflow) and cfg.wrap_x
    starts = isect.st_starts.long()
    chunks = (starts[1:] - (starts[:-1] // 128) * 128 + 127) // 128
    assert int(chunks.argmax()) == 0 and int(chunks[0]) == 36
    # supertile 0 (u < 32 px) holds slots centred across the seam
    x = packed[int(starts[0]):int(starts[1]), tsi.COL_X]
    assert bool((x > w - 16).any()) and bool((x < 16).any())
    out = tsr.stream_fwd(cfg, isect.st_starts, packed)
    assert out[0, :, tsr.CH_NCHUNKS, 0].tolist() == [1.0, 36.0, 16.0, 28.0]
    T = 1.0 - out[0, :, 3]
    assert bool((T[1] >= tsr.TERM_THRESH).any())  # tile 1 never terminates
    for j in (0, 2, 3):
        assert bool((T[j] < tsr.TERM_THRESH).all())
    means, quats, scales, opac, colors, viewmats, Ks, w, h = scene
    t = torch.as_tensor
    proj = tp.project_gaussians(*map(t, (means, quats, scales, opac, viewmats, Ks)),
                                w, h, colors=t(colors), camera_model="spherical")
    caps = tis.IsectCaps.choose(proj.depths.shape[1], 1, 32)
    it = tis.build_intersections(proj, w, h, 16, caps, camera_model="spherical")
    assert not bool(it.overflow)
    cfg_t = ttr.RasterCfg(width=w, height=h, tile_size=16, num_cameras=1,
                          num_gaussians=proj.depths.shape[1], chunk=128,
                          align_cap=caps.align_cap, wrap_x=True)
    pk = tis.pack_fields(proj.means2d, proj.conics, proj.colors, proj.opacities,
                         proj.depths, it)
    out_t = ttr.tile_fwd(cfg_t, it.tile_starts, pk)
    ts = it.tile_starts.long()
    assert ((ts[1:3] - ts[0:2]) // 128).tolist() == [19, 27]
    assert out_t[0:2, ttr.CH_NCHUNKS, 0].tolist() == [1.0, 27.0]


def test_stream_fwd_rejects_other_devices():
    cfg = tsr.StreamCfg(width=32, height=32, tile_size=16, num_cameras=1,
                        num_gaussians=1, chunk=128, exp_cap=128, n_supertiles=1)
    with pytest.raises(ValueError):
        tsr.stream_fwd(cfg, torch.zeros(2, dtype=torch.int32, device="meta"),
                       torch.zeros((256, tsi.NF), device="meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_cuda_kernel_matches_plain(case):
    """The kernel gives the plain version's bits, each launch counted once,
    two launches equal. Run on the card with ``python -m pytest
    tests/test_torch_stream_raster.py -m gpu --noconftest`` (the suite's
    conftest imports JAX)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene, model = GPU_CASES[case]
    cfg, isect, packed = _port_inputs(scene(), model, "cuda")
    st = isect.st_starts
    n0 = cuda_build.launch_counts["stream_fwd"]
    out_k = tsr.stream_fwd(cfg, st, packed)
    assert cuda_build.launch_counts["stream_fwd"] == n0 + 1
    assert torch.equal(out_k, tsr.stream_fwd(cfg, st, packed))
    assert cuda_build.launch_counts["stream_fwd"] == n0 + 2
    out_p = tsr.stream_fwd_plain(cfg, st, packed)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    assert out_k[:, :, tsr.CH_NCHUNKS].max() >= 1
