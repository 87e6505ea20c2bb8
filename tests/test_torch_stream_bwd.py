"""Port parity: the backward compositing and the per-gaussian reduction.

- ``stream_bwd_plain`` against the JAX Pallas backward kernel
  (``_bwd_call``, interpret mode on the CPU) on the same packed table,
  forward output and cotangent: every payload column within 1e-4 of that
  column's max |value| (the JAX kernel forms in-chunk prefixes with
  doubling networks, the port serially, and the suffix term
  ``godot - gP - prefix`` cancels), the key column exactly equal.
- ``segment_reduce_plain`` (on the key-sorted rows, and on the rows in
  place through ``keyed_perm``) and ``reduce_stream_grads`` against the
  JAX ``segment_reduce_rows`` / ``reduce_stream_grads``: within 2^-15
  relative of each column's max, because the JAX CPU path splits f32 into
  two bf16 parts (``NSPLIT = 2``, ``seg_reduce.py:48``).
- The CUDA kernels against their plain versions (``gpu`` marker, run on
  the card with ``--noconftest``): every row equal (the kernels add in
  the plain versions' order and divide as IEEE division rounds), also
  when launched into a buffer of NaNs, so that the kernel writes every
  row itself.
"""

import dataclasses

import numpy as np
import pytest
import torch

from splat_one_tpu_torch.ops import seg_reduce as tsr_reduce
from splat_one_tpu_torch.ops import stream_isect as tsi
from splat_one_tpu_torch.ops import stream_raster as tsr
from splat_one_tpu_torch.utils import cuda_build

from test_torch_stream_raster import CASES, GPU_CASES, _inputs, _port_inputs

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many small ops, which
    gain nothing from threads, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _gout(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(cfg.cs, cfg.nt, tsr.OUT_CH, cfg.npix)).astype(np.float32)


def _col_rel(a, b):
    """Max abs difference of each column over that column's max |b|."""
    return np.abs(a - b).max(0) / (np.abs(b).max(0) + 1e-30)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_kernel(case):
    import jax.numpy as jnp
    from splat_one_tpu.ops import stream_isect as jsi
    from splat_one_tpu.ops import stream_raster as jsr

    cfg_j, cfg_t, ij, packed, _ = _inputs(*CASES[case])
    out_j = jsr._fwd_call(cfg_j, ij.st_starts, packed.T)
    gout = _gout(cfg_t, 5)
    pg_j = np.asarray(jsr._bwd_call(cfg_j, ij.st_starts, ij.st_starts_al, packed.T,
                                    out_j, jnp.asarray(gout))).T
    args = [torch.as_tensor(np.array(x)) for x in (
        ij.st_starts, ij.st_starts_al, packed, out_j, gout)]
    before = dict(cuda_build.launch_counts)
    pg_t = tsr.stream_bwd(dataclasses.replace(cfg_t, absgrad=True), *args).numpy()
    assert dict(cuda_build.launch_counts) == before  # CPU: plain version
    assert pg_t.shape == pg_j.shape == (cfg_t.pad_cap, tsi.NF)
    np.testing.assert_array_equal(pg_t[:, tsi.GCOL_KEY], pg_j[:, jsi.GCOL_KEY])
    assert (pg_t[:, tsi.GCOL_KEY] > 0).sum() > 100
    rel = _col_rel(pg_t[:, :tsi.N_GCOLS], pg_j[:, :jsi.N_GCOLS])
    assert rel.max() < 1e-4, rel
    np.testing.assert_array_equal(pg_t[:, tsi.GCOL_KEY + 1:], 0.0)
    # without absgrad the two |d means2d| columns are not reduced
    pg_n = tsr.stream_bwd(cfg_t, *args).numpy()
    np.testing.assert_array_equal(pg_n[:, :tsi.GCOL_ABSDX], pg_t[:, :tsi.GCOL_ABSDX])
    np.testing.assert_array_equal(pg_n[:, tsi.GCOL_ABSDX:tsi.GCOL_KEY], 0.0)
    np.testing.assert_array_equal(pg_n[:, tsi.GCOL_KEY], pg_t[:, tsi.GCOL_KEY])


def _key_rows(seed, cap=3072, m0=900, n_pay=12):
    """Gradient rows with ragged runs: dead rows (key 0), gaussians with no
    row, a few long runs; in stream order (unsorted by key)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((cap, tsi.NF), np.float32)
    rows[:, :n_pay] = rng.normal(size=(cap, n_pay)) * rng.uniform(0.1, 10, (1, n_pay))
    keys = rng.integers(1, m0 + 1, cap).astype(np.float32)
    keys[rng.uniform(size=cap) < 0.2] = 0.0
    keys[:64] = 7.0  # one gaussian with a long run
    rows[:, tsi.GCOL_KEY] = keys
    rows[keys == 0, :n_pay] = 0.0
    return rows


@pytest.mark.parametrize("n_payload", [tsi.GCOL_ABSDX, tsi.N_GCOLS])
def test_reduce_matches_jax(n_payload):
    import jax.numpy as jnp
    from splat_one_tpu.ops import seg_reduce as jsr_reduce
    from splat_one_tpu.ops import stream_isect as jsi

    m0 = 900
    rows = _key_rows(3, m0=m0)
    want = np.asarray(jsi.reduce_stream_grads(jnp.asarray(rows.T), m0, n_payload))
    got = tsi.reduce_stream_grads(torch.as_tensor(rows), m0, n_payload).numpy()
    assert got.shape == want.shape == (n_payload, m0)
    assert (_col_rel(got.T, want.T) < 2.0 ** -15).all()

    # the reduction alone, on the same sorted rows and per-gaussian bounds
    srt, bounds = tsi.sort_grad_rows(torch.as_tensor(rows), m0)
    keys = srt[:, tsi.GCOL_KEY].numpy()
    assert (np.diff(keys) >= 0).all()
    np.testing.assert_array_equal(bounds.numpy(), np.searchsorted(keys, np.arange(1, m0 + 2)))
    blk = np.searchsorted(keys, np.arange(0, m0 + jsr_reduce.R, jsr_reduce.R) + 1.0)
    parts = [jnp.asarray(srt[:, c].numpy()) for c in range(n_payload)]
    want2 = np.asarray(jsr_reduce.segment_reduce_rows(
        parts + [jnp.asarray(keys)], jnp.asarray(blk.astype(np.int32)), m0))[:, :m0]
    ident = torch.arange(srt.shape[0], dtype=torch.int32)
    got2 = tsr_reduce.segment_reduce_plain(srt, ident, bounds, n_payload).numpy()
    assert (_col_rel(got2.T, want2.T) < 2.0 ** -15).all()
    # the same sums read in place, through the stable order of the keyed rows
    perm, kbounds = tsr_reduce.keyed_perm(torch.as_tensor(rows), m0)
    np.testing.assert_array_equal(kbounds.numpy(), bounds.numpy() - bounds.numpy()[0])
    in_place = tsr_reduce.segment_reduce_plain(torch.as_tensor(rows), perm, kbounds,
                                               n_payload).numpy()
    np.testing.assert_array_equal(in_place, got2)
    # runs are summed front to back in stream order
    m = 7
    run = srt[bounds[m - 1]:bounds[m], :n_payload]
    acc = torch.zeros(n_payload)
    for r in run:
        acc = acc + r
    np.testing.assert_array_equal(got2[:, m - 1], acc.numpy())


def test_seg_reduce_rejects_other_devices():
    idx = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tsr_reduce.segment_reduce_rows(torch.zeros((8, tsi.NF), device="meta"), idx, idx,
                                       tsi.N_GCOLS)


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("absgrad", [False, True])
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_cuda_backward_matches_plain(case, absgrad):
    """Run on the card with ``python -m pytest tests/test_torch_stream_bwd.py
    -m gpu --noconftest``."""
    _gpu()
    scene, model = GPU_CASES[case]
    cfg, isect, packed = _port_inputs(scene(), model, "cuda")
    cfg = dataclasses.replace(cfg, absgrad=absgrad)
    st = isect.st_starts
    out = tsr.stream_fwd(cfg, st, packed)
    gout = torch.as_tensor(_gout(cfg, 5), device="cuda")
    n0 = cuda_build.launch_counts["stream_bwd"]
    pg_k = tsr.stream_bwd(cfg, st, isect.st_starts_al, packed, out, gout)
    assert cuda_build.launch_counts["stream_bwd"] == n0 + 1
    # a second launch on the same inputs gives the same bits
    assert torch.equal(pg_k, tsr.stream_bwd(cfg, st, isect.st_starts_al, packed, out, gout))
    pg_p = tsr.stream_bwd_plain(cfg, st, isect.st_starts_al, packed, out, gout)
    torch.cuda.synchronize()
    assert torch.equal(pg_k[:, tsi.GCOL_KEY:], pg_p[:, tsi.GCOL_KEY:])
    err = (pg_k - pg_p).abs().max(0).values
    assert torch.equal(pg_k, pg_p), err
    # launched into NaNs, the kernel leaves none: it writes every row
    nan = torch.full_like(pg_p, float("nan"))
    tsr._launch_stream_bwd(cfg, st, isect.st_starts_al, packed, out, gout, nan)
    assert torch.equal(nan, pg_p)


@pytest.mark.gpu
@pytest.mark.parametrize("n_payload", [tsi.GCOL_ABSDX, tsi.N_GCOLS])
def test_cuda_reduce_matches_plain(n_payload):
    _gpu()
    m0 = 900
    rows = torch.as_tensor(_key_rows(3, m0=m0), device="cuda")
    srt, bounds = tsi.sort_grad_rows(rows, m0)
    n0 = cuda_build.launch_counts["seg_reduce"]
    ident = torch.arange(srt.shape[0], dtype=torch.int32, device="cuda")
    got = tsr_reduce.segment_reduce_rows(srt, ident, bounds, n_payload)
    assert cuda_build.launch_counts["seg_reduce"] == n0 + 1
    want = tsr_reduce.segment_reduce_plain(srt, ident, bounds, n_payload)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # read in place, the same bits as over the sorted copy
    assert torch.equal(tsi.reduce_stream_grads(rows, m0, n_payload), got)
