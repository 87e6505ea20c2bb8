"""Port parity: the segmented broadcast (slot -> parent expansion).

Mirrors tests/test_seg_broadcast.py. On ragged random runs with
zero-count parents and slots past the total:
- ``coverage_windows`` gives JAX's coverage flags and window bases, and
  ``required_slab`` JAX's observed width;
- the kernel path (its plain version on the CPU) is bit-identical to the
  default path and to a numpy reference on live slots, at the default and
  at a tight slab, for adversarial depths too; on every slot it equals the
  JAX kernel path (interpret mode), whose uncovered and past-the-total
  slots get the zero row with span 1 and parent 0;
- ``cond`` takes the kernel where every window covers its chunk and falls
  back to the default path (counted) where a zero-count run outgrows the
  window;
- the stream builder gives the same layout under every path.
The CUDA kernel is held against the plain version by the ``gpu`` test.
"""

import dataclasses

import numpy as np
import pytest
import torch

from splat_one_tpu_torch.ops import seg_broadcast as tsb
from splat_one_tpu_torch.ops import stream_isect as tsi
from splat_one_tpu_torch.utils import cuda_build

from test_torch_stream_raster import CASES

NAMES = ["sx0", "sy0", "span", "ka", "off", "depth", "parent"]


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
    before = dict(cuda_build.launch_counts)
    got = tsb.expand_meta_streamed(*tp, exp_cap, "kernel")
    assert dict(cuda_build.launch_counts) == before  # CPU: plain version
    ref = _reference(*prob, exp_cap)
    _assert_live_equal(got, ref, n_isect)
    _assert_live_equal(got, tsb.expand_meta_streamed(*tp, exp_cap, "xla"), n_isect)
    _assert_live_equal(tsb.expand_meta_streamed(*tp, exp_cap, "cond"), ref, n_isect)
    # every slot, the dead tail included, as the JAX kernel path gives it
    want = jsb.expand_meta_streamed(*map(jnp.asarray, prob), exp_cap, "kernel")
    _assert_live_equal(got, want, exp_cap)
    assert (got[2][n_isect:] == 1).all() and not got[6][n_isect:].any()


def test_tail_chunks_count_as_covered():
    rng = np.random.default_rng(11)
    prob = _random_problem(rng, 2000, zero_frac=0.2)
    n_isect = int(prob[4][-1] + prob[6][-1])
    exp_cap = -(-int(n_isect * 3.0) // 1024) * 1024  # a long tail
    tp = _torch(prob)
    assert bool(tsb.coverage_windows(tp[4], tp[6], exp_cap)[0].all())
    fb = cuda_build.launch_counts["seg_broadcast_fallback"]
    _assert_live_equal(tsb.expand_meta_streamed(*tp, exp_cap, "cond"),
                       _reference(*prob, exp_cap), n_isect)
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
    _assert_live_equal(tsb.expand_meta_streamed(*tp, exp_cap, "cond"),
                       _reference(*prob, exp_cap), n_isect)
    assert cuda_build.launch_counts["seg_broadcast_fallback"] == fb + 1
    forced = tsb.expand_meta_streamed(*tp, exp_cap, "kernel")
    want = jsb.expand_meta_streamed(*map(jnp.asarray, prob), exp_cap, "kernel")
    _assert_live_equal(forced, want, exp_cap)


def test_tight_slab_and_depth_bits():
    """``required_slab`` as JAX measures it; the kernel path exact at that
    narrow window, on full-mantissa depths over a wide exponent range."""
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
    got = tsb.expand_meta_streamed(*tp, exp_cap, "kernel", slab)
    _assert_live_equal(got, _reference(*prob, exp_cap), n_isect)
    assert got[5].dtype == torch.float32


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


@pytest.mark.gpu
@pytest.mark.parametrize("zero_frac", [0.0, 0.35])
def test_cuda_kernel_matches_plain(zero_frac):
    """Run on the card with ``python -m pytest tests/test_torch_seg_broadcast.py
    -m gpu --noconftest``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    prob = _random_problem(rng, 3000, zero_frac=zero_frac)
    n_isect = int(prob[4][-1] + prob[6][-1])
    exp_cap = -(-int(n_isect * 1.1) // 128) * 128
    tp = _torch(prob, "cuda")
    okv, pbases, offs_pad = tsb.coverage_windows(tp[4], tp[6], exp_cap)
    table = tsb.parent_table(*tp[:6])
    n0 = cuda_build.launch_counts["seg_broadcast"]
    got = tsb.expand_parent_meta(table, offs_pad, pbases)
    assert cuda_build.launch_counts["seg_broadcast"] == n0 + 1
    want = tsb.expand_parent_meta_plain(table, offs_pad, pbases)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _assert_live_equal(tsb.expand_meta_streamed(*tp, exp_cap, "kernel"),
                       _reference(*prob, exp_cap), n_isect)
