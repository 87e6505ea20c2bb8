"""Port parity: gen-1 per-tile compositing (tile_raster) against the JAX kernels.

The JAX Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them. Both sides get the same per-tile layout and
packed field table (the JAX package's, as numpy), so each comparison is
the compositing function alone, on the small pinhole, spherical and
edge-partial scenes and the crowded spherical one:
- forward: rgb, alpha and depth within 1e-5 relative (the JAX kernel
  forms the in-chunk transmittance in log space with a triangular matmul,
  the port serially), n_chunks exactly equal;
- backward: every gradient column within 5e-4 of that column's max (the
  rasterizer paths' gradient bar; the suffix term ``godot - gP - prefix``
  cancels);
- ``composite_tiles`` (pack, forward, backward, per-gaussian reduction)
  against JAX's custom VJP: the gradients of means2d, conics, colours,
  opacities, depths and the absgrad hook within 5e-4 relative.
The CUDA kernels are held against the plain versions by the ``gpu``
tests, which need a card (run them with ``python -m pytest
tests/test_torch_tile_raster.py -m gpu --noconftest``).
"""

import numpy as np
import pytest
import torch

from splat_one_tpu_torch.ops import intersect as tis
from splat_one_tpu_torch.ops import projection as tp
from splat_one_tpu_torch.ops import tile_raster as ttr
from splat_one_tpu_torch.utils import cuda_build

from test_torch_stream_raster import CASES, FWD_CASES, GPU_CASES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many small ops, which
    gain nothing from threads, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(scene, model):
    """JAX per-tile layout, packed table ([NF, AL]) and projection for a
    scene (``_scene``'s tuple), and both configs. (JAX is imported here, not
    at module level, so that the ``gpu`` tests run where JAX is not
    installed.)"""
    import jax
    import jax.numpy as jnp
    from splat_one_tpu.ops import intersect as jis
    from splat_one_tpu.ops import projection as jp
    from splat_one_tpu.ops import tile_raster as jtr

    means, quats, scales, opac, colors, viewmats, Ks, w, h = scene
    pj = jax.jit(jp.project_gaussians, static_argnums=(6, 7),
                 static_argnames=("camera_model",))(
        *map(jnp.asarray, (means, quats, scales, opac, viewmats, Ks)), w, h,
        colors=jnp.asarray(colors), camera_model=model)
    C, N = pj.depths.shape
    caps = jis.IsectCaps.choose(N, C, (-(-w // 16)) * (-(-h // 16)))
    ij = jax.jit(jis.build_intersections, static_argnums=(1, 2, 3, 4),
                 static_argnames=("camera_model",))(pj, w, h, 16, caps,
                                                    camera_model=model)
    packed = jis.pack_fields(pj.means2d, pj.conics, pj.colors, pj.opacities,
                             pj.depths, ij)
    kw_cfg = dict(width=w, height=h, tile_size=16, num_cameras=C, num_gaussians=N,
                  chunk=128, align_cap=caps.align_cap, wrap_x=(model == "spherical"))
    return jtr.RasterCfg(**kw_cfg), ttr.RasterCfg(**kw_cfg), ij, packed, pj, jtr


def _port_inputs(scene, model, device):
    """The port's own per-tile layout + packed table for a scene (``_scene``'s
    tuple)."""
    means, quats, scales, opac, colors, viewmats, Ks, w, h = scene
    t = lambda x: torch.as_tensor(x, device=device)
    proj = tp.project_gaussians(*map(t, (means, quats, scales, opac, viewmats, Ks)),
                                w, h, colors=t(colors), camera_model=model)
    C, N = proj.depths.shape
    caps = tis.IsectCaps.choose(N, C, (-(-w // 16)) * (-(-h // 16)))
    isect = tis.build_intersections(proj, w, h, 16, caps, camera_model=model)
    cfg = ttr.RasterCfg(width=w, height=h, tile_size=16, num_cameras=C, num_gaussians=N,
                        chunk=128, align_cap=caps.align_cap,
                        wrap_x=(model == "spherical"))
    packed = tis.pack_fields(proj.means2d, proj.conics, proj.colors, proj.opacities,
                             proj.depths, isect)
    return cfg, isect, packed


def _gout(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(cfg.ct, ttr.OUT_CH, cfg.npix)).astype(np.float32)


def _col_rel(a, b):
    return np.abs(a - b).max(0) / (np.abs(b).max(0) + 1e-30)


def _forward_matches(case):
    """The plain forward against the JAX kernel on ``FWD_CASES[case]`` ->
    what the backward comparison needs."""
    scene, model = FWD_CASES[case]
    cfg_j, cfg_t, ij, packed, _, jtr = _inputs(scene(), model)
    out_j = jtr._fwd_call(cfg_j, ij.tile_starts, packed)
    starts = torch.as_tensor(np.array(ij.tile_starts))
    packed_t = torch.as_tensor(np.array(packed).T.copy())
    before = dict(cuda_build.launch_counts)
    out_t = ttr.tile_fwd(cfg_t, starts, packed_t)
    assert dict(cuda_build.launch_counts) == before  # CPU: plain version
    assert out_t.shape == (cfg_t.ct, ttr.OUT_CH, 256) == out_j.shape
    o_t, o_j = out_t.numpy(), np.asarray(out_j)
    for ch, name in ((slice(0, 3), "rgb"), (slice(3, 4), "alpha"), (slice(4, 5), "depth")):
        rel = np.abs(o_t[:, ch] - o_j[:, ch]).max() / (np.abs(o_j[:, ch]).max() + 1e-8)
        assert rel < 1e-5, f"{name}: rel {rel:.3e}"
    np.testing.assert_array_equal(o_t[:, ttr.CH_NCHUNKS], o_j[:, ttr.CH_NCHUNKS])
    assert o_t[:, ttr.CH_NCHUNKS].max() >= 1
    np.testing.assert_array_equal(o_t[:, 6:], 0.0)
    for x, y in zip(ttr.tiles_to_image(cfg_t, out_t), jtr.tiles_to_image(cfg_j, o_t)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    return cfg_j, cfg_t, ij, packed, starts, packed_t, out_j, o_j, jtr


def test_plain_forward_term_thresh_matches_jax():
    """``RasterCfg.term_thresh`` at 0, 1e-5 and 1e-3 on the crowded
    spherical scene (a tile of 19 chunks stops after 1 at 1e-5): the
    plain version against the JAX kernel with the same threshold, rgb,
    alpha and depth within 1e-5 rel, n_chunks exact; at 0 every tile
    walks all its chunks."""
    import dataclasses

    from test_torch_stream_raster import TERMS, _crowded_scene

    cfg_j, cfg_t, ij, packed, _, jtr = _inputs(_crowded_scene(), "spherical")
    starts = torch.as_tensor(np.array(ij.tile_starts))
    packed_t = torch.as_tensor(np.array(packed).T.copy())
    nch = {}
    for term in TERMS:
        out_j = np.asarray(jtr._fwd_call(dataclasses.replace(cfg_j, term_thresh=term),
                                         ij.tile_starts, packed))
        out_t = ttr.tile_fwd(dataclasses.replace(cfg_t, term_thresh=term), starts,
                             packed_t).numpy()
        for ch in (slice(0, 3), slice(3, 4), slice(4, 5)):
            rel = np.abs(out_t[:, ch] - out_j[:, ch]).max() / (np.abs(out_j[:, ch]).max() + 1e-8)
            assert rel < 1e-5, (term, ch, rel)
        np.testing.assert_array_equal(out_t[:, ttr.CH_NCHUNKS], out_j[:, ttr.CH_NCHUNKS])
        nch[term] = out_t[:, ttr.CH_NCHUNKS, 0]
    assert cfg_t.term_thresh == 1e-5
    s = starts.long()
    np.testing.assert_array_equal(nch[0.0], ((s[1:] - s[:-1]) // 128).numpy())
    assert (nch[0.0] >= nch[1e-5]).all() and (nch[1e-5] >= nch[1e-3]).all()
    assert (nch[0.0] > nch[1e-5]).any() and (nch[1e-5] > nch[1e-3]).any()
    assert nch[1e-5][0] == 1 and nch[0.0][0] == 19


def _backward_matches(fwd, same_rows=True):
    """The plain backward against the JAX kernel on the forward output of
    ``_forward_matches`` and one cotangent: every gradient column within
    5e-4 of its max and, where ``same_rows``, the same rows written."""
    import jax.numpy as jnp

    cfg_j, cfg_t, ij, packed, starts, packed_t, out_j, o_j, jtr = fwd
    before = dict(cuda_build.launch_counts)

    # the backward on the same forward output and cotangent
    gout = _gout(cfg_t, 3)
    pg_j = np.asarray(jtr._bwd_call(cfg_j, ij.tile_starts, packed, out_j,
                                    jnp.asarray(gout))).T
    pg_t = ttr.tile_bwd(cfg_t, starts, packed_t, torch.as_tensor(o_j.copy()),
                        torch.as_tensor(gout)).numpy()
    assert dict(cuda_build.launch_counts) == before  # CPU: plain version
    assert pg_t.shape == pg_j.shape == (cfg_t.align_cap, tis.NF)
    written = np.abs(pg_j[:, :tis.N_GROWS]).max(1) > 0
    assert written.sum() > 100
    if same_rows:
        np.testing.assert_array_equal(np.abs(pg_t[:, :tis.N_GROWS]).max(1) > 0, written)
    assert (_col_rel(pg_t, pg_j)[:tis.N_GROWS] < 5e-4).all()
    np.testing.assert_array_equal(pg_t[:, tis.N_GROWS:], 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_tiles_match_jax_kernels(case):
    _backward_matches(_forward_matches(case))


def test_plain_forward_matches_jax_kernel_crowded():
    """The crowded spherical scene (a 36-chunk supertile across the azimuth
    seam, 27 chunks replayed by its longest tile), forward and backward.
    The backward is held to the column bar but not to the same written
    rows: a few rows of saturated pixels (T near 1e-44) get gradients
    below 2e-7 on one side and exact zeros on the other (ROADMAP Queue 3)."""
    _backward_matches(_forward_matches("crowded-spherical"), same_rows=False)


def test_plain_forward_early_termination():
    """An opaque stack in one tile: the tile stops after its first chunk,
    and the backward replays only that chunk."""
    n = 640
    cfg = ttr.RasterCfg(width=16, height=16, tile_size=16, num_cameras=1,
                        num_gaussians=n, chunk=128, align_cap=n)
    packed = torch.zeros((n, tis.NF))
    packed[:, tis.ROW_X] = 8.0
    packed[:, tis.ROW_Y] = 8.0
    packed[:, tis.ROW_CA] = 1e-4
    packed[:, tis.ROW_CC] = 1e-4
    packed[:, tis.ROW_OPAC] = 0.99
    packed[:, tis.ROW_R] = 1.0
    packed[:, tis.ROW_DEPTH] = torch.arange(n) + 1.0
    starts = torch.tensor([0, n], dtype=torch.int32)
    out = ttr.tile_fwd(cfg, starts, packed)
    assert (out[:, ttr.CH_NCHUNKS] == 1).all()
    assert torch.allclose(out[:, 3], torch.ones(1), atol=1e-5)
    pg = ttr.tile_bwd(cfg, starts, packed, out, torch.ones_like(out))
    assert (pg[:128, tis.GROW_DR] > 0).any() and not pg[128:].any()


def test_composite_tiles_grads_match_jax():
    import jax
    import jax.numpy as jnp

    scene, model = FWD_CASES["pinhole"]
    cfg_j, cfg_t, ij, _, pj, jtr = _inputs(scene(), model)
    C, N = pj.depths.shape
    names = ("means2d", "conics", "colors", "opacities", "depths")
    fields = [np.array(getattr(pj, k)) for k in names] + [np.zeros((C, N, 2), np.float32)]
    wts = np.random.default_rng(8).normal(size=(cfg_t.ct, ttr.OUT_CH, 256)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jtr.composite_tiles(cfg_j, *a[:5], ij, abs_dummy=a[5]) * wts)

    gj = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, fields))
    it = tis.IsectData(*(torch.as_tensor(np.array(x)) for x in ij))
    ts = [torch.tensor(x, requires_grad=True) for x in fields]
    out = ttr.composite_tiles(cfg_t, *ts[:5], it, abs_dummy=ts[5])
    (out * torch.as_tensor(wts)).sum().backward()
    for name, t, g in zip(names + ("abs_dummy",), ts, gj):
        g = np.asarray(g)
        rel = np.abs(t.grad.numpy() - g).max() / np.abs(g).max()
        assert rel < 5e-4, f"grad {name}: {rel:.3e}"
    # without the absgrad hook the same gradients, none for the hook
    ts2 = [torch.tensor(x, requires_grad=True) for x in fields[:5]]
    (ttr.composite_tiles(cfg_t, *ts2, it) * torch.as_tensor(wts)).sum().backward()
    for a, b in zip(ts, ts2):
        assert torch.equal(a.grad, b.grad)
    # the whole grid is the slab at offset 0 (nonzero offsets:
    # tests/test_torch_slab.py)
    assert torch.equal(ttr.composite_tiles(cfg_t, *ts2, it, tile_offset=0),
                       ttr.composite_tiles(cfg_t, *ts2, it))


def test_tile_kernels_reject_other_devices():
    cfg = ttr.RasterCfg(width=16, height=16, tile_size=16, num_cameras=1,
                        num_gaussians=1, chunk=128, align_cap=128)
    starts = torch.zeros(2, dtype=torch.int32, device="meta")
    packed = torch.zeros((128, tis.NF), device="meta")
    with pytest.raises(ValueError):
        ttr.tile_fwd(cfg, starts, packed)
    plane = torch.zeros((1, ttr.OUT_CH, 256), device="meta")
    with pytest.raises(ValueError):
        ttr.tile_bwd(cfg, starts, packed, plane, plane)


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_cuda_tile_kernels_match_plain(case):
    _gpu()
    scene, model = GPU_CASES[case]
    cfg, isect, packed = _port_inputs(scene(), model, "cuda")
    st = isect.tile_starts
    n0 = dict(cuda_build.launch_counts)
    out_k = ttr.tile_fwd(cfg, st, packed)
    assert cuda_build.launch_counts["tile_fwd"] == n0.get("tile_fwd", 0) + 1
    # the forward gives the plain version's bits, and a second launch its own
    assert torch.equal(out_k, ttr.tile_fwd(cfg, st, packed))
    out_p = ttr.tile_fwd_plain(cfg, st, packed)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    gout = torch.as_tensor(_gout(cfg, 5), device="cuda")
    pg_k = ttr.tile_bwd(cfg, st, packed, out_k, gout)
    assert cuda_build.launch_counts["tile_bwd"] == n0.get("tile_bwd", 0) + 1
    # a second launch on the same inputs gives the same bits
    assert torch.equal(pg_k, ttr.tile_bwd(cfg, st, packed, out_k, gout))
    pg_p = ttr.tile_bwd_plain(cfg, st, packed, out_k, gout)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["tile_fwd"] == n0.get("tile_fwd", 0) + 2
    err = (pg_k - pg_p).abs().max(0).values
    assert torch.equal(pg_k, pg_p), err
    # launched into NaNs, the kernel leaves none: it writes every row
    nan = torch.full_like(pg_p, float("nan"))
    ttr._launch_tile_bwd(cfg, st, packed, out_k, gout, nan)
    assert torch.equal(nan, pg_p)
