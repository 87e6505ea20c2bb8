"""Port parity: the segmented broadcast (slot -> parent -> sort key).

Mirrors tests/test_seg_broadcast.py. On ragged random runs with
zero-count parents and slots past the total:
- ``coverage_windows`` gives JAX's coverage flags and window bases, and
  ``required_slab`` JAX's observed width;
- the kernel path's parent search (``window_expansion_plain``, the plain
  version's first stage) gives, on every slot, the seven metadata columns
  of the JAX kernel path (interpret mode), whose uncovered and
  past-the-total slots get the zero row with span 1 and parent 0, and on
  live slots those of the default path and of a numpy reference, at the
  default and at a tight slab, for adversarial depths too;
- the kernel path's output, each slot's sort key and owning parent
  (``expand_slots``; its plain version on the CPU), is bit-equal to the
  decode (``slot_keys``) of those columns: of JAX's kernel path on every
  slot, of the default path and the reference on live slots;
- ``cond`` takes the kernel where every window covers its chunk and falls
  back to the default path (counted) where a zero-count run outgrows the
  window;
- the stream builder gives the same layout under every path.
The CUDA kernel is held against the plain version bit for bit by the
``gpu`` tests (ragged runs and the small scenes' stream builds).
"""

import dataclasses

import numpy as np
import pytest
import torch

from splat_one_tpu_torch.ops import seg_broadcast as tsb
from splat_one_tpu_torch.ops import stream_isect as tsi
from splat_one_tpu_torch.utils import cuda_build

from test_torch_stream_raster import CASES, GPU_CASES

NAMES = ["sx0", "sy0", "span", "ka", "off", "depth", "parent"]
# the random problems' supertile grid: 1,000 parents a camera, 41 supertiles
# a row (so that spans wrap), the past-the-total id far above the rest
GRID = tsb.SlotGrid(n=1000, sw=41, ns=41 * 23, cs=1 << 20, wrap=False)


def _random_problem(rng, mp, zero_frac=0.3, max_count=9):
    """tests/test_seg_broadcast.py::_random_problem."""
    counts = rng.integers(1, max_count, size=mp).astype(np.int32)
    counts[rng.uniform(size=mp) < zero_frac] = 0
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    sx0 = rng.integers(0, 40, mp).astype(np.int32)
    sy0 = rng.integers(0, 23, mp).astype(np.int32)
    span = np.maximum(rng.integers(1, 6, mp), 1).astype(np.int32)
    ka = rng.integers(0, 1000, mp).astype(np.int32)
    depth = rng.normal(size=mp).astype(np.float32) * 37.3 + 5
    return sx0, sy0, span, ka, offsets, depth, counts


def _reference(sx0, sy0, span, ka, offsets, depth, counts, exp_cap):
    buckets = np.zeros(exp_cap, np.int64)
    for off in offsets[1:]:
        if off < exp_cap:
            buckets[off] += 1
    g = np.cumsum(buckets)
    return (sx0[g], sy0[g], span[g], ka[g], offsets[g], depth[g], g)


def _torch(prob, device="cpu"):
    return [torch.as_tensor(a, device=device).long() if a.dtype != np.float32
            else torch.as_tensor(a, device=device) for a in prob]


def _assert_live_equal(got, want, n_isect):
    for g, w, name in zip(got, want, NAMES):
        g = g.cpu().numpy()[:n_isect] if torch.is_tensor(g) else np.asarray(g)[:n_isect]
        np.testing.assert_array_equal(g, np.asarray(w)[:n_isect], err_msg=name)


def _keys_of(meta, n_isect, exp_cap, grid=GRID):
    """``slot_keys`` of seven metadata columns (numpy, JAX or torch) over
    the first ``exp_cap`` slots."""
    cols = [torch.as_tensor(np.array(c.cpu() if torch.is_tensor(c) else c)[:exp_cap])
            for c in meta]
    cols = [c if c.dtype == torch.float32 else c.long() for c in cols]
    return tsb.slot_keys(cols, min(n_isect, exp_cap), grid)


def _assert_keys_equal(got, want, n):
    for g, w, name in zip(got, want, ("key", "parent")):
        np.testing.assert_array_equal(g.cpu().numpy()[:n], w.numpy()[:n], err_msg=name)


def _window_meta(tp, exp_cap, slab=tsb.SLAB):
    _, pbases, offs_pad = tsb.coverage_windows(tp[4], tp[6], exp_cap, slab)
    return tsb.window_expansion_plain(*tp[:4], tp[5], offs_pad, pbases, slab)


@pytest.mark.parametrize("zero_frac", [0.0, 0.35])
def test_kernel_path_matches_reference(zero_frac):
    import jax.numpy as jnp
    from splat_one_tpu.ops import seg_broadcast as jsb

    rng = np.random.default_rng(3)
    prob = _random_problem(rng, 3000, zero_frac=zero_frac)
    n_isect = int(prob[4][-1] + prob[6][-1])
    exp_cap = -(-int(n_isect * 1.1) // 128) * 128
    tp = _torch(prob)
    okv, pbases, _ = tsb.coverage_windows(tp[4], tp[6], exp_cap)
    okv_j, pbases_j, _ = jsb.coverage_windows(jnp.asarray(prob[4]), jnp.asarray(prob[6]),
                                              exp_cap)
    np.testing.assert_array_equal(okv.numpy(), np.asarray(okv_j))
    np.testing.assert_array_equal(pbases.numpy(), np.asarray(pbases_j))
    assert bool(okv.all())
    ref = _reference(*prob, exp_cap)
    # the parent search: every slot as the JAX kernel path, live slots as
    # the reference and the default path
    meta = _window_meta(tp, exp_cap)
    want = jsb.expand_meta_streamed(*map(jnp.asarray, prob), exp_cap, "kernel")
    _assert_live_equal(meta, want, exp_cap)
    _assert_live_equal(meta, ref, n_isect)
    _assert_live_equal(meta, tsb.default_expansion(*tp[:6], exp_cap), n_isect)
    assert (meta[2][n_isect:] == 1).all() and not meta[6][n_isect:].any()
    # the keys and owners
    before = dict(cuda_build.launch_counts)
    got = tsb.expand_slots(*tp, exp_cap, GRID, "kernel")
    assert dict(cuda_build.launch_counts) == before  # CPU: plain version
    _assert_keys_equal(got, _keys_of(want, n_isect, exp_cap), exp_cap)
    _assert_keys_equal(got, _keys_of(ref, n_isect, exp_cap), n_isect)
    _assert_keys_equal(got, tsb.expand_slots(*tp, exp_cap, GRID, "xla"), n_isect)
    _assert_keys_equal(tsb.expand_slots(*tp, exp_cap, GRID, "cond"),
                       _keys_of(ref, n_isect, exp_cap), n_isect)
    assert ((got[0][n_isect:] >> 32) == GRID.cs).all() and not got[1][n_isect:].any()


def test_tail_chunks_count_as_covered():
    rng = np.random.default_rng(11)
    prob = _random_problem(rng, 2000, zero_frac=0.2)
    n_isect = int(prob[4][-1] + prob[6][-1])
    exp_cap = -(-int(n_isect * 3.0) // 1024) * 1024  # a long tail
    tp = _torch(prob)
    assert bool(tsb.coverage_windows(tp[4], tp[6], exp_cap)[0].all())
    fb = cuda_build.launch_counts["seg_broadcast_fallback"]
    _assert_keys_equal(tsb.expand_slots(*tp, exp_cap, GRID, "cond"),
                       _keys_of(_reference(*prob, exp_cap), n_isect, exp_cap), n_isect)
    assert cuda_build.launch_counts["seg_broadcast_fallback"] == fb


def test_overflow_falls_back():
    """A zero-count run longer than the window trips the guard: ``cond``
    takes (and counts) the default path, exact; the forced kernel path
    leaves the uncovered slots as zero rows, as in JAX."""
    import jax.numpy as jnp
    from splat_one_tpu.ops import seg_broadcast as jsb

    rng = np.random.default_rng(4)
    sx0, sy0, span, ka, offsets, depth, counts = _random_problem(
        rng, 8000, zero_frac=0.0, max_count=4)
    counts[1000:1000 + tsb.B + 512] = 0
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    prob = (sx0, sy0, span, ka, offsets, depth, counts)
    n_isect = int(offsets[-1] + counts[-1])
    exp_cap = -(-int(n_isect * 1.1) // 128) * 128
    tp = _torch(prob)
    okv, pbases, _ = tsb.coverage_windows(tp[4], tp[6], exp_cap)
    okv_j, pbases_j, _ = jsb.coverage_windows(jnp.asarray(offsets), jnp.asarray(counts),
                                              exp_cap)
    np.testing.assert_array_equal(okv.numpy(), np.asarray(okv_j))
    np.testing.assert_array_equal(pbases.numpy(), np.asarray(pbases_j))
    assert not bool(okv.all())
    fb = cuda_build.launch_counts["seg_broadcast_fallback"]
    _assert_keys_equal(tsb.expand_slots(*tp, exp_cap, GRID, "cond"),
                       _keys_of(_reference(*prob, exp_cap), n_isect, exp_cap), n_isect)
    assert cuda_build.launch_counts["seg_broadcast_fallback"] == fb + 1
    want = jsb.expand_meta_streamed(*map(jnp.asarray, prob), exp_cap, "kernel")
    _assert_live_equal(_window_meta(tp, exp_cap), want, exp_cap)
    _assert_keys_equal(tsb.expand_slots(*tp, exp_cap, GRID, "kernel"),
                       _keys_of(want, n_isect, exp_cap), exp_cap)


def test_tight_slab_and_depth_bits():
    """``required_slab`` as JAX measures it; the kernel path exact at that
    narrow window, on full-mantissa depths over a wide exponent range,
    with the azimuth wrap."""
    rng = np.random.default_rng(9)
    prob = list(_random_problem(rng, 2500, zero_frac=0.15, max_count=6))
    prob[5] = (rng.normal(size=2500).astype(np.float32)
               * np.exp2(rng.integers(-20, 20, 2500)).astype(np.float32))
    n_isect = int(prob[4][-1] + prob[6][-1])
    exp_cap = -(-int(n_isect + 2048) // 1024) * 1024
    from splat_one_tpu.ops import seg_broadcast as jsb

    slab = tsb.required_slab(prob[4], prob[6], exp_cap)
    assert slab == jsb.required_slab(prob[4], prob[6], exp_cap) < tsb.SLAB
    tp = _torch(prob)
    assert tsb.required_slab(tp[4], tp[6], exp_cap) == slab
    assert bool(tsb.coverage_windows(tp[4], tp[6], exp_cap, slab)[0].all())
    ref = _reference(*prob, exp_cap)
    meta = _window_meta(tp, exp_cap, slab)
    _assert_live_equal(meta, ref, n_isect)
    assert meta[5].dtype == torch.float32
    grid = GRID._replace(wrap=True)
    got = tsb.expand_slots(*tp, exp_cap, grid, "kernel", slab)
    _assert_keys_equal(got, _keys_of(ref, n_isect, exp_cap, grid), n_isect)
    bits = prob[5].view(np.uint32)[np.asarray(ref[6])[:n_isect]]
    np.testing.assert_array_equal(got[0].numpy()[:n_isect] & 0xFFFFFFFF, bits)


@pytest.mark.parametrize("path", ["kernel", "cond"])
def test_stream_layout_under_every_path(path, monkeypatch):
    """The stream builder, with ``SPLAT_SEG_BROADCAST`` set and with the
    observed window (``observed_sb_slab``), gives the default layout."""
    from splat_one_tpu_torch.ops import projection as tp
    from test_torch_stream_raster import _port_inputs, _scene

    kw, model = CASES["spherical"]
    scene = _scene(**kw)
    cfg, isect, _ = _port_inputs(scene, model, "cpu")
    means, quats, scales, opac, colors, viewmats, Ks, w, h = scene
    proj = tp.project_gaussians(*map(torch.as_tensor, (means, quats, scales, opac,
                                                       viewmats, Ks)),
                                w, h, colors=torch.as_tensor(colors), camera_model=model)
    caps = cfg.caps
    slab = tsi.observed_sb_slab(proj, w, h, 16, caps, model)
    assert slab % tsb.ALIGN == 0 and slab < tsb.SLAB
    monkeypatch.setenv("SPLAT_SEG_BROADCAST", path)
    for c in (caps, dataclasses.replace(caps, sb_slab=slab)):
        got = tsi.build_stream_intersections(proj, w, h, 16, c, camera_model=model)
        for f in isect._fields:
            assert torch.equal(getattr(got, f), getattr(isect, f)), f
    monkeypatch.setenv("SPLAT_SEG_BROADCAST", "onehot")
    with pytest.raises(ValueError):
        tsi.build_stream_intersections(proj, w, h, 16, caps, camera_model=model)


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _check_kernel(tp, exp_cap, grid, slab=tsb.SLAB):
    """The kernel against its plain version on every slot, one launch."""
    _, pbases, offs_pad = tsb.coverage_windows(tp[4], tp[6], exp_cap, slab)
    args = (*tp[:4], tp[5], offs_pad, pbases, exp_cap, grid, slab)
    n0 = cuda_build.launch_counts["seg_broadcast"]
    got = tsb.expand_parent_meta(*args)
    assert cuda_build.launch_counts["seg_broadcast"] == n0 + 1
    want = tsb.expand_parent_meta_plain(*args)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("zero_frac", [0.0, 0.35])
def test_cuda_kernel_matches_plain(zero_frac):
    """Run on the card with ``python -m pytest tests/test_torch_seg_broadcast.py
    -m gpu --noconftest``."""
    _gpu()
    rng = np.random.default_rng(3)
    prob = _random_problem(rng, 3000, zero_frac=zero_frac)
    n_isect = int(prob[4][-1] + prob[6][-1])
    exp_cap = -(-int(n_isect * 1.1) // 128) * 128
    tp = _torch(prob, "cuda")
    for grid in (GRID, GRID._replace(wrap=True)):
        _check_kernel(tp, exp_cap, grid)
    _assert_keys_equal(tsb.expand_slots(*tp, exp_cap, GRID, "kernel"),
                       _keys_of(_reference(*prob, exp_cap), n_isect, exp_cap), n_isect)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_cuda_kernel_on_scenes(case, monkeypatch):
    """On each small scene's stream build: the kernel's bits equal the plain
    version's, and the layout built through it the default one."""
    _gpu()
    from test_torch_stream_raster import _port_inputs

    scene, model = GPU_CASES[case]
    monkeypatch.delenv("SPLAT_SEG_BROADCAST", raising=False)
    cfg, isect, _ = _port_inputs(scene(), model, "cuda")
    means, quats, scales, opac, colors, viewmats, Ks, w, h = scene()
    from splat_one_tpu_torch.ops import projection as tp

    t = lambda x: torch.as_tensor(x, device="cuda")
    proj = tp.project_gaussians(*map(t, (means, quats, scales, opac, viewmats, Ks)), w, h,
                                colors=t(colors), camera_model=model)
    C, N = proj.depths.shape
    sx0, span_x, sy0, span_y = tsi.parent_spans(proj, w, h, 16, tsi.SS, model)
    counts = span_x * span_y
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    prob = (sx0, sy0, torch.clamp(span_x, min=1), torch.zeros_like(counts), offsets,
            proj.depths.reshape(-1), counts)
    grid = tsb.SlotGrid(n=N, sw=cfg.sw, ns=cfg.sw * cfg.sh, cs=cfg.cs,
                        wrap=model == "spherical")
    _check_kernel(prob, cfg.caps.exp_cap, grid)
    monkeypatch.setenv("SPLAT_SEG_BROADCAST", "kernel")
    got = tsi.build_stream_intersections(proj, w, h, 16, cfg.caps, camera_model=model)
    for f in isect._fields:
        assert torch.equal(getattr(got, f), getattr(isect, f)), f
