"""Port parity: the slab halves of the builders and compositors (multi-GPU).

A rank of the supertile-sharded path builds and composites one slab of
the (camera, supertile) grid. Held against the JAX package, single
process, on the small scenes of ``test_torch_stream_raster.py`` (2
cameras, 8 supertiles, cut into 3 slabs of 3 cells, so the last slab
ends in a phantom cell and the middle one crosses the camera boundary):
- the per-slab counts against brute force, as
  ``tests/test_slab_counts.py`` (pinhole, spherical: the segmented
  parents);
- ``build_stream_intersections(st_lo, n_st_local)`` against JAX's: the
  whole layout equal, with JAX's builder on its default expansion and on
  its seg_broadcast kernel path;
- ``composite_stream`` with ``tile_offset``: forward within 1e-5 rel and
  the gradients within 5e-4 of each one's max of JAX's (its kernels in
  interpret mode), n_chunks equal;
- ``build_intersections(tile_lo)`` against JAX's: the layout equal;
- ``composite_tiles(tile_offset)``: forward and gradients against JAX's
  whole-grid composite cut to the slab (JAX's tiled kernels reach a slab
  only through that argument, with its whole-grid cfg);
- the seg_broadcast plain version with ``st_lo`` and segmented parents
  against JAX's kernel path's parent columns, decoded as JAX's builder
  decodes them.
The ``gpu`` tests hold every kernel at a nonzero offset against its plain
version on the card. JAX is imported inside the functions that use it,
so the ``gpu`` tests run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from splat_one_tpu_torch.ops import intersect as tis
from splat_one_tpu_torch.ops import projection as tp
from splat_one_tpu_torch.ops import seg_broadcast as tsb
from splat_one_tpu_torch.ops import stream_isect as tsi
from splat_one_tpu_torch.ops import stream_raster as tsr
from splat_one_tpu_torch.ops import tile_raster as ttr
from splat_one_tpu_torch.utils import cuda_build

from test_torch_stream_raster import CASES, _scene

N_SLABS = 3
TILE_LO, N_TILES = 5, 13  # a tile slab across the camera boundary (12 tiles a camera)


def _jax_projection(kw, model):
    import jax
    import jax.numpy as jnp
    from splat_one_tpu.ops import projection as jp

    means, quats, scales, opac, colors, viewmats, Ks, w, h = _scene(**kw)
    pj = jax.jit(jp.project_gaussians, static_argnums=(6, 7),
                 static_argnames=("camera_model",))(
        *map(jnp.asarray, (means, quats, scales, opac, viewmats, Ks)), w, h,
        colors=jnp.asarray(colors), camera_model=model)
    pt = tp.Projected(*(torch.as_tensor(np.array(x)) for x in pj))
    return pj, pt, w, h


def _slab(C, w, h, n=N_SLABS):
    _, _, sw, sh = tsi.supertile_grid(w, h, 16)
    cs_local = -(-C * sw * sh // n)
    return sw * sh, cs_local


def _jax_slab_layout(pj, w, h, model, st_lo, cs_local):
    import jax
    import jax.numpy as jnp
    from splat_one_tpu.ops import stream_isect as jsi

    C, N = pj.depths.shape
    caps = jsi.StreamCaps.choose(N, C, cs_local, avg_supertiles_per_gaussian=8.0)
    build = jax.jit(jsi.build_stream_intersections, static_argnums=(1, 2, 3, 4),
                    static_argnames=("camera_model", "n_st_local"))
    return caps, build(pj, w, h, 16, caps, camera_model=model, st_lo=jnp.int32(st_lo),
                       n_st_local=cs_local)


# -------------------------------------------------- counts vs brute force
def _proj_from_boxes(ctrs, rads, depths, valid):
    """tests/test_slab_counts.py::_proj_from_boxes: an isotropic conic
    (3 / r)^2 at opacity 1 gives ellipse extents r."""
    C, N = depths.shape
    a = (3.0 / np.maximum(rads, 1e-6)) ** 2
    conics = np.stack([a, np.zeros_like(a), a], axis=-1).astype(np.float32)
    t = torch.as_tensor
    return tp.Projected(t(ctrs), t(conics), t(depths), t(rads),
                        t(np.zeros((C, N, 3), np.float32)), t(np.ones((C, N), np.float32)),
                        t(valid))


def _brute_cells(u, v, rad, sw, sh, sps, spherical):
    sy0 = int(np.clip(np.floor((v - rad) / sps), 0, sh))
    sy1 = int(np.clip(np.ceil((v + rad) / sps), 0, sh))
    if spherical:
        sx0u = int(np.floor((u - rad) / sps))
        span = min(int(np.ceil((u + rad) / sps)) - sx0u, sw)
        xs = [(sx0u % sw + lx) % sw for lx in range(max(span, 0))]
    else:
        xs = list(range(int(np.clip(np.floor((u - rad) / sps), 0, sw)),
                        int(np.clip(np.ceil((u + rad) / sps), 0, sw))))
    return [(sy, sx) for sy in range(sy0, sy1) for sx in xs]


@pytest.mark.parametrize("spherical", [False, True])
def test_slab_enumeration_matches_bruteforce(spherical):
    """Each supertile of a random slab holds exactly the gaussians whose
    bbox covers it, in depth order (tests/test_slab_counts.py)."""
    rng = np.random.default_rng(0 if spherical else 1)
    W, H, ts = 160, 96, 16
    _, _, sw, sh = tsi.supertile_grid(W, H, ts)
    C, N, NS = 2, 40, sw * sh
    model = "spherical" if spherical else "pinhole"
    for trial in range(12):
        ctrs = rng.uniform(-30, max(W, H) + 30, (C, N, 2)).astype(np.float32)
        rads = rng.uniform(0, 60, (C, N)).astype(np.float32)
        depths = rng.uniform(1, 9, (C, N)).astype(np.float32)
        valid = rng.uniform(size=(C, N)) > 0.1
        proj = _proj_from_boxes(ctrs, rads, depths, valid)
        rx, _ = tp.conic_ellipse_radii(proj.conics[..., 0], proj.conics[..., 1],
                                       proj.conics[..., 2], proj.opacities)
        rads = rx.numpy()
        cs_local = int(rng.integers(1, C * NS + 1))
        st_lo = int(rng.integers(0, C * NS - cs_local + 1))
        caps = tsi.StreamCaps.choose(N, C, cs_local, avg_supertiles_per_gaussian=60.0)
        isect = tsi.build_stream_intersections(proj, W, H, ts, caps, camera_model=model,
                                               st_lo=st_lo, n_st_local=cs_local)
        expect = {s: [] for s in range(cs_local)}
        for c in range(C):
            for g in np.argsort(depths[c], kind="stable"):
                if not valid[c, g]:
                    continue
                for sy, sx in _brute_cells(*ctrs[c, g], rads[c, g], sw, sh, ts * tsi.SS,
                                           spherical):
                    flat = c * NS + sy * sw + sx
                    if st_lo <= flat < st_lo + cs_local:
                        expect[flat - st_lo].append(c * N + g)
        starts = isect.st_starts.numpy()
        sorted_g = isect.sorted_g.numpy()
        assert not bool(isect.overflow)
        assert int(isect.n_slots) == int(isect.n_isect) == sum(map(len, expect.values()))
        for s in range(cs_local):
            got = list(sorted_g[starts[s]:starts[s + 1]])
            assert sorted(got) == sorted(expect[s]), (trial, s)
            got_depths = [depths[g // N, g % N] for g in got]
            assert got_depths == sorted(got_depths), (trial, s)


# ------------------------------------------------------ the stream slabs
@pytest.mark.parametrize("path", ["xla", "kernel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_layout_matches_jax(case, path, monkeypatch):
    """Every slab's layout equals JAX's field for field, and the slabs'
    intersections add up to the whole build's. ``path`` sets the JAX
    builder's own ``SPLAT_SEG_BROADCAST``; the port has one expansion."""
    monkeypatch.setenv("SPLAT_SEG_BROADCAST", path)
    kw, model = CASES[case]
    pj, pt, w, h = _jax_projection(kw, model)
    C, N = pj.depths.shape
    _, cs_local = _slab(C, w, h)
    total = 0
    for i in range(N_SLABS):
        caps_j, ij = _jax_slab_layout(pj, w, h, model, i * cs_local, cs_local)
        caps_t = tsi.StreamCaps.choose(N, C, cs_local, avg_supertiles_per_gaussian=8.0)
        assert (caps_t.exp_cap, caps_t.pad_cap) == (caps_j.exp_cap, caps_j.pad_cap)
        it = tsi.build_stream_intersections(pt, w, h, 16, caps_t, camera_model=model,
                                            st_lo=i * cs_local, n_st_local=cs_local)
        for f in ij._fields:
            np.testing.assert_array_equal(getattr(it, f).numpy(), np.asarray(getattr(ij, f)),
                                          err_msg=f"slab {i}: {f}")
        total += int(it.n_isect)
    caps = tsi.StreamCaps.choose(N, C, C * _slab(C, w, h)[0])
    assert total == int(tsi.build_stream_intersections(pt, w, h, 16, caps,
                                                       camera_model=model).n_isect)


@pytest.mark.parametrize("case", ["pinhole", "spherical"])
def test_composite_stream_offset_matches_jax(case):
    """The middle slab through ``composite_stream(tile_offset=st_lo)``,
    forward and gradients, against JAX's with the same offset."""
    import jax
    import jax.numpy as jnp
    from splat_one_tpu.ops import stream_raster as jsr

    kw, model = CASES[case]
    pj, pt, w, h = _jax_projection(kw, model)
    C, N = pj.depths.shape
    ns, cs_local = _slab(C, w, h)
    st_lo = cs_local
    caps_j, ij = _jax_slab_layout(pj, w, h, model, st_lo, cs_local)
    cfg_j = jsr.StreamCfg(width=w, height=h, tile_size=16, num_cameras=C, num_gaussians=N,
                          chunk=caps_j.chunk, exp_cap=caps_j.exp_cap, n_supertiles=ns,
                          wrap_x=model == "spherical", cs_local=cs_local)
    cfg_t = tsr.StreamCfg(width=w, height=h, tile_size=16, num_cameras=C, num_gaussians=N,
                          chunk=caps_j.chunk, exp_cap=caps_j.exp_cap, n_supertiles=ns,
                          wrap_x=model == "spherical", cs_local=cs_local)
    names = ("means2d", "conics", "colors", "opacities", "depths")
    fields = [np.array(getattr(pj, k)) for k in names]
    wts = np.random.default_rng(3).normal(size=(cs_local, 4, tsr.OUT_CH, 256)).astype(
        np.float32)
    wts[:, :, 5:] = 0.0  # n_chunks and padding carry no gradient

    def jloss(*a):
        out = jsr.composite_stream(cfg_j, *a, pj.radii, ij, tile_offset=jnp.int32([st_lo]))
        return jnp.sum(out * wts), out

    (_, out_j), gj = jax.value_and_grad(jloss, argnums=tuple(range(5)), has_aux=True)(
        *map(jnp.asarray, fields))
    it = tsi.StreamIsect(*(torch.as_tensor(np.array(x)) for x in ij))
    ts = [torch.tensor(x, requires_grad=True) for x in fields]
    out_t = tsr.composite_stream(cfg_t, *ts, pt.radii, it, tile_offset=st_lo)
    (out_t * torch.as_tensor(wts)).sum().backward()
    out_t, out_j = out_t.detach().numpy(), np.asarray(out_j)
    assert out_t.shape == (cs_local, 4, tsr.OUT_CH, 256)
    for ch in (slice(0, 3), slice(3, 4), slice(4, 5)):
        rel = np.abs(out_t[:, :, ch] - out_j[:, :, ch]).max() / np.abs(out_j[:, :, ch]).max()
        assert rel < 1e-5, rel
    np.testing.assert_array_equal(out_t[:, :, tsr.CH_NCHUNKS], out_j[:, :, tsr.CH_NCHUNKS])
    assert out_t[:, :, 3].max() > 0.1
    for name, t, g in zip(names, ts, gj):
        g = np.asarray(g)
        rel = np.abs(t.grad.numpy() - g).max() / np.abs(g).max()
        assert rel < 5e-4, f"grad {name}: {rel:.3e}"
    # the offset is what places the slab: at 0 the same slots composite
    # other pixels
    out0 = tsr.composite_stream(cfg_t, *ts, pt.radii, it, tile_offset=0).detach().numpy()
    assert not np.array_equal(out0[:, :, :5], out_t[:, :, :5])


# -------------------------------------------------------- the tile slabs
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_slab_layout_matches_jax(case):
    import jax
    import jax.numpy as jnp
    from splat_one_tpu.ops import intersect as jis

    kw, model = CASES[case]
    pj, pt, w, h = _jax_projection(kw, model)
    C, N = pj.depths.shape
    lo, nl = (TILE_LO, N_TILES) if C * 12 >= TILE_LO + N_TILES else (1, 2)
    caps_j = jis.IsectCaps.choose(N, C, nl)
    caps_t = tis.IsectCaps.choose(N, C, nl)
    build = jax.jit(jis.build_intersections, static_argnums=(1, 2, 3, 4),
                    static_argnames=("camera_model", "n_tiles_local"))
    ij = build(pj, w, h, 16, caps_j, camera_model=model, tile_lo=jnp.int32(lo),
               n_tiles_local=nl)
    it = tis.build_intersections(pt, w, h, 16, caps_t, camera_model=model, tile_lo=lo,
                                 n_tiles_local=nl)
    for f in ij._fields:
        np.testing.assert_array_equal(getattr(it, f).numpy(), np.asarray(getattr(ij, f)),
                                      err_msg=f)
    assert int(it.n_slots) > 0


@pytest.mark.parametrize("case", ["pinhole", "spherical"])
def test_composite_tiles_offset_matches_jax(case):
    """A tile slab through ``composite_tiles(tile_offset=tile_lo)`` against
    JAX's whole-grid composite cut to the slab: forward within 1e-5 rel,
    gradients of a loss on the slab within 5e-4 of each one's max."""
    import jax
    import jax.numpy as jnp
    from splat_one_tpu.ops import intersect as jis
    from splat_one_tpu.ops import tile_raster as jtr

    kw, model = CASES[case]
    pj, pt, w, h = _jax_projection(kw, model)
    C, N = pj.depths.shape
    wrap = model == "spherical"
    caps = jis.IsectCaps.choose(N, C, 12)
    ij = jis.build_intersections(pj, w, h, 16, caps, camera_model=model)
    cfg_j = jtr.RasterCfg(width=w, height=h, tile_size=16, num_cameras=C, num_gaussians=N,
                          chunk=caps.chunk, align_cap=caps.align_cap, wrap_x=wrap)
    names = ("means2d", "conics", "colors", "opacities", "depths")
    fields = [np.array(getattr(pj, k)) for k in names]
    wts = np.zeros((cfg_j.ct, ttr.OUT_CH, 256), np.float32)
    wts[TILE_LO:TILE_LO + N_TILES, :5] = np.random.default_rng(4).normal(
        size=(N_TILES, 5, 256))

    def jloss(*a):
        out = jtr.composite_tiles(cfg_j, *a, ij)
        return jnp.sum(out * wts), out

    (_, out_j), gj = jax.value_and_grad(jloss, argnums=tuple(range(5)), has_aux=True)(
        *map(jnp.asarray, fields))
    caps_t = tis.IsectCaps.choose(N, C, N_TILES)
    it = tis.build_intersections(pt, w, h, 16, caps_t, camera_model=model, tile_lo=TILE_LO,
                                 n_tiles_local=N_TILES)
    cfg_t = ttr.RasterCfg(width=w, height=h, tile_size=16, num_cameras=C, num_gaussians=N,
                          chunk=caps_t.chunk, align_cap=caps_t.align_cap, wrap_x=wrap,
                          ct_local=N_TILES)
    ts = [torch.tensor(x, requires_grad=True) for x in fields]
    out_t = ttr.composite_tiles(cfg_t, *ts, it, tile_offset=TILE_LO)
    (out_t * torch.as_tensor(wts[TILE_LO:TILE_LO + N_TILES])).sum().backward()
    out_t = out_t.detach().numpy()
    out_j = np.asarray(out_j)[TILE_LO:TILE_LO + N_TILES]
    for ch in (slice(0, 3), slice(3, 4), slice(4, 5)):
        rel = np.abs(out_t[:, ch] - out_j[:, ch]).max() / np.abs(out_j[:, ch]).max()
        assert rel < 1e-5, rel
    np.testing.assert_array_equal(out_t[:, ttr.CH_NCHUNKS], out_j[:, ttr.CH_NCHUNKS])
    for name, t, g in zip(names, ts, gj):
        g = np.asarray(g)
        rel = np.abs(t.grad.numpy() - g).max() / np.abs(g).max()
        assert rel < 5e-4, f"grad {name}: {rel:.3e}"


# ------------------------------------------------- seg_broadcast's slab key
def _segmented_problem(rng, n_pairs, sw, n):
    """Random spherical (camera, gaussian) pairs cut into two unwrapped
    segments each, as the slab build cuts them: parents 2q, 2q + 1."""
    sx0 = rng.integers(0, sw, n_pairs)
    span_x = rng.integers(0, sw + 1, n_pairs)
    sy0 = rng.integers(0, 6, n_pairs)
    span_y = rng.integers(0, 4, n_pairs)
    span_a = np.minimum(span_x, sw - sx0)
    px = np.stack([sx0, np.zeros_like(sx0)], 1).reshape(-1)
    pspan = np.stack([span_a, span_x - span_a], 1).reshape(-1)
    counts = (pspan * np.repeat(span_y, 2)).astype(np.int64)
    ka = np.where(counts > 0, rng.integers(0, 3, 2 * n_pairs), 0)
    counts = np.maximum(counts - ka, 0)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    depth = np.repeat(rng.uniform(1, 9, n_pairs).astype(np.float32), 2)
    return (px, np.repeat(sy0, 2), np.maximum(pspan, 1), ka, offsets, depth, counts)


def test_seg_broadcast_slab_key_matches_jax():
    """The plain version's slab keys and owners (``st_lo``, segmented
    parents) against JAX's kernel path's parent columns decoded as JAX's
    slab build decodes them (``stream_isect.py:430-450``)."""
    import jax.numpy as jnp
    from splat_one_tpu.ops import seg_broadcast as jsb

    rng = np.random.default_rng(5)
    sw, n, n_cam = 7, 150, 2
    ns = sw * 6
    px, py, span, ka, offsets, depth, counts = _segmented_problem(rng, n * n_cam, sw, n)
    total = int(offsets[-1] + counts[-1])
    exp_cap = -(-(total + 300) // 128) * 128
    st_lo, cs = 17, 40
    meta = jsb.expand_meta_streamed(*map(jnp.asarray, (
        px.astype(np.int32), py.astype(np.int32), span.astype(np.int32),
        ka.astype(np.int32), offsets.astype(np.int32), depth, counts.astype(np.int32))),
        exp_cap)
    sx0_s, sy0_s, span_s, ka_s, off_s, _, g_s = (np.asarray(m).astype(np.int64)
                                                 for m in meta)
    slot = np.arange(exp_cap)
    local = slot - off_s + ka_s
    st = ((g_s // 2) // n) * ns + (sy0_s + local // span_s) * sw + sx0_s + local % span_s
    st = st - st_lo
    ok = (slot < min(total, exp_cap)) & (st >= 0) & (st < cs)
    want_st = np.where(ok, st, cs)
    grid = tsb.SlotGrid(n=n, sw=sw, ns=ns, cs=cs, wrap=True, st_lo=st_lo, segmented=True)
    t = lambda x: torch.as_tensor(np.asarray(x, np.int64))
    offs_t = t(offsets)
    okv, pbases, offs_pad = tsb.coverage_windows(offs_t, t(counts), exp_cap)
    assert bool(okv.all())
    key, g = tsb.expand_parent_meta_plain(t(px), t(py), t(span), t(ka),
                                          torch.as_tensor(depth), offs_pad, pbases, exp_cap,
                                          grid)
    key, g = key[:exp_cap].numpy(), g[:exp_cap].numpy()
    np.testing.assert_array_equal(key >> 32, want_st)
    live = slot < min(total, exp_cap)
    np.testing.assert_array_equal(g[live], (g_s // 2)[live])
    np.testing.assert_array_equal((key & 0xFFFFFFFF)[live],
                                  depth.view(np.int32)[g_s[live]].astype(np.int64) & 0xFFFFFFFF)
    assert ok.sum() > 0 and (~ok & live).sum() > 0  # slots in and out of the slab
    # the default path's decode of the same parents gives the live slots alike
    key_d, g_d = tsb.expand_slots(t(px), t(py), t(span), t(ka), offs_t,
                                  torch.as_tensor(depth), t(counts), exp_cap, grid)
    np.testing.assert_array_equal(key_d.numpy()[live], key[live])
    np.testing.assert_array_equal(g_d.numpy()[live], g[live])


# ------------------------------------------------------------ on the card
def _port_slab_inputs(case, device, st_lo_slab=1):
    kw, model = CASES[case]
    means, quats, scales, opac, colors, viewmats, Ks, w, h = _scene(**kw)
    t = lambda x: torch.as_tensor(x, device=device)
    proj = tp.project_gaussians(*map(t, (means, quats, scales, opac, viewmats, Ks)), w, h,
                                colors=t(colors), camera_model=model)
    C, N = proj.depths.shape
    ns, cs_local = _slab(C, w, h)
    st_lo = st_lo_slab * cs_local
    caps = tsi.StreamCaps.choose(N, C, cs_local, avg_supertiles_per_gaussian=8.0)
    isect = tsi.build_stream_intersections(proj, w, h, 16, caps, camera_model=model,
                                           st_lo=st_lo, n_st_local=cs_local)
    cfg = tsr.StreamCfg(width=w, height=h, tile_size=16, num_cameras=C, num_gaussians=N,
                        chunk=caps.chunk, exp_cap=caps.exp_cap, n_supertiles=ns,
                        wrap_x=model == "spherical", cs_local=cs_local)
    return proj, cfg, isect, tsi.pack_stream(tsi.build_fields(proj), isect, caps), st_lo


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["pinhole", "spherical"])
def test_cuda_offset_kernels_match_plain(case):
    """At a nonzero slab offset: stream_fwd, keyed_perm and seg_reduce give
    their plain versions' bits, stream_bwd its plain version's key column
    and its gradient columns within 1e-5 of each column's max (at least
    1), tile_fwd / tile_bwd likewise at a tile offset, and the
    seg_broadcast kernel the plain version's keys and owners. Run on the
    card with ``python -m pytest tests/test_torch_slab.py -m gpu
    --noconftest``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splat_one_tpu_torch.ops import seg_reduce as tsg
    from test_torch_seg_broadcast import _assert_windowed_layout

    proj, cfg, isect, packed, st_lo = _port_slab_inputs(case, "cuda")
    assert st_lo > 0
    out = tsr.stream_fwd(cfg, isect.st_starts, packed, st_lo)
    assert torch.equal(out, tsr.stream_fwd_plain(cfg, isect.st_starts, packed, st_lo))
    assert out[:, :, 3].max() > 0.1
    gout = torch.as_tensor(np.random.default_rng(0).normal(size=tuple(out.shape)).astype(
        np.float32), device="cuda")
    pg = tsr.stream_bwd(cfg, isect.st_starts, isect.st_starts_al, packed, out, gout, st_lo)
    pg_p = tsr.stream_bwd_plain(cfg, isect.st_starts, isect.st_starts_al, packed, out, gout,
                                st_lo)
    assert torch.equal(pg[:, tsi.GCOL_KEY:], pg_p[:, tsi.GCOL_KEY:])
    err = (pg - pg_p)[:, :tsi.GCOL_KEY].abs().amax(0)
    assert bool((err <= 1e-5 * torch.clamp(pg_p[:, :tsi.GCOL_KEY].abs().amax(0), min=1)).all())
    m0 = cfg.num_cameras * cfg.num_gaussians
    perm, bounds = tsg.keyed_perm(pg, m0)
    perm_p, bounds_p = tsg.keyed_perm_plain(pg, m0)
    assert torch.equal(bounds, bounds_p) and torch.equal(perm[:perm_p.shape[0]], perm_p)
    assert torch.equal(tsg.segment_reduce_rows(pg, perm, bounds, tsi.GCOL_ABSDX),
                       tsg.segment_reduce_plain(pg, perm_p, bounds_p, tsi.GCOL_ABSDX))
    # the slab's keys through the seg_broadcast kernel, sorted: the build's layout
    n0 = cuda_build.launch_counts["seg_broadcast"]
    C, N = proj.depths.shape
    *prob, grid = tsi.slot_parents(proj, cfg.width, cfg.height, 16, tsi.SS,
                                   CASES[case][1], st_lo, cfg.cs_local)
    _assert_windowed_layout(prob, grid, cfg.exp_cap, tsb.SLAB, cfg.chunk, C * N, isect)
    assert cuda_build.launch_counts["seg_broadcast"] == n0 + 1
    # the tiled kernels at a tile offset
    it = tis.build_intersections(proj, cfg.width, cfg.height, 16,
                                 tis.IsectCaps.choose(N, C, N_TILES),
                                 camera_model=CASES[case][1], tile_lo=TILE_LO,
                                 n_tiles_local=N_TILES)
    cfg_t = ttr.RasterCfg(width=cfg.width, height=cfg.height, tile_size=16, num_cameras=C,
                          num_gaussians=N, chunk=128,
                          align_cap=tis.IsectCaps.choose(N, C, N_TILES).align_cap,
                          wrap_x=cfg.wrap_x, ct_local=N_TILES)
    pk = tis.pack_fields(proj.means2d, proj.conics, proj.colors, proj.opacities,
                         proj.depths, it)
    out_t = ttr.tile_fwd(cfg_t, it.tile_starts, pk, TILE_LO)
    assert torch.equal(out_t, ttr.tile_fwd_plain(cfg_t, it.tile_starts, pk, TILE_LO))
    gt = torch.as_tensor(np.random.default_rng(1).normal(size=tuple(out_t.shape)).astype(
        np.float32), device="cuda")
    pg_t = ttr.tile_bwd(cfg_t, it.tile_starts, pk, out_t, gt, TILE_LO)
    pg_tp = ttr.tile_bwd_plain(cfg_t, it.tile_starts, pk, out_t, gt, TILE_LO)
    err = (pg_t - pg_tp).abs().amax(0)
    assert bool((err <= 1e-5 * torch.clamp(pg_tp.abs().amax(0), min=1)).all())
