"""Port parity: the per-gaussian reduction read in place (``ops.seg_reduce``).

On the CPU (the plain versions):
- ``keyed_perm`` is the stable sort of the key column with its key-0 head
  dropped (against numpy's stable argsort);
- the stream path, ``reduce_stream_grads`` (``keyed_perm`` and the indexed
  reduce), is bit-equal (``torch.equal``) to the composition it replaces,
  ``sort_grad_rows`` (a stable sort and a gather of every row) and the
  same sums over the sorted copy: on ragged rows, a gaussian whose run
  covers hundreds of supertiles, no keyed row at all, and the plain
  backward's rows of two-camera scenes, with and without absgrad;
- the tiled path, ``gather_reduction``, is bit-equal to gathering the rows
  by ``rank_perm``, reducing the copy and scattering through ``rank_src``,
  on the tiled builder's layouts of the small scenes (two cameras on the
  pinhole and spherical ones);
- the stream path matches the JAX package's ``reduce_stream_grads``
  within 2^-15 relative of each column's max (its CPU reduce splits f32
  into two bf16 parts, ``seg_reduce.py:48``), as
  ``tests/test_torch_stream_bwd.py`` holds it.
On the card (``gpu``, run with ``python -m pytest
tests/test_torch_seg_reduce.py -m gpu --noconftest``): both kernels give
their plain versions' bits on the small scenes' backward rows (the
deep-stack and crowded spherical scenes among them) and on ragged rows, and
neither reduction synchronises with the host
(``torch.cuda.set_sync_debug_mode("error")``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from splat_one_tpu_torch.ops import intersect as tis
from splat_one_tpu_torch.ops import seg_reduce as tsr_reduce
from splat_one_tpu_torch.ops import stream_isect as tsi
from splat_one_tpu_torch.ops import stream_raster as tsr
from splat_one_tpu_torch.ops import tile_raster as ttr
from splat_one_tpu_torch.utils import cuda_build

from test_torch_stream_bwd import _gout, _key_rows
from test_torch_stream_raster import CASES, GPU_CASES, _port_inputs, _scene
from test_torch_tile_raster import _gout as _tile_gout
from test_torch_tile_raster import _port_inputs as _tile_port_inputs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _long_run_rows(seed=5, cap=4096, m0=600):
    """Ragged rows and one gaussian (id 41) with 700 rows spread over the
    whole stream, as a gaussian that covers hundreds of supertiles."""
    rows = _key_rows(seed, cap=cap, m0=m0)
    rng = np.random.default_rng(seed)
    at = np.sort(rng.choice(cap, 700, replace=False))
    rows[at, tsi.GCOL_KEY] = 42.0
    rows[at, :tsi.N_GCOLS] = rng.normal(size=(700, tsi.N_GCOLS)).astype(np.float32)
    return rows, m0


def _stream_backward_rows(case, absgrad=True):
    """The plain stream backward's rows of a small scene -> (rows, C * N)."""
    kw, model = CASES[case]
    cfg, isect, packed = _port_inputs(_scene(**kw), model, "cpu")
    cfg = dataclasses.replace(cfg, absgrad=absgrad)
    out = tsr.stream_fwd(cfg, isect.st_starts, packed)
    gout = torch.as_tensor(_gout(cfg, 7))
    pg = tsr.stream_bwd(cfg, isect.st_starts, isect.st_starts_al, packed, out, gout)
    return pg.numpy(), cfg.num_cameras * cfg.num_gaussians


ROW_CASES = {
    "ragged": lambda: (_key_rows(3, m0=900), 900),
    "long run": _long_run_rows,
    "no keyed row": lambda: (np.zeros((2048, tsi.NF), np.float32), 300),
    "pinhole 2 cameras": lambda: _stream_backward_rows("pinhole"),
    "spherical 2 cameras": lambda: _stream_backward_rows("spherical"),
}


def _sorted_copy_reduce(rows, m0, n_payload):
    """The composition the stream reduction replaces: sort_grad_rows, then
    the runs of the sorted copy summed front to back."""
    srt, bounds = tsi.sort_grad_rows(rows, m0)
    ident = torch.arange(srt.shape[0], dtype=torch.int32)
    return tsr_reduce.segment_reduce_plain(srt, ident, bounds, n_payload)


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_keyed_perm_is_the_stable_key_order(case):
    assert (tsr_reduce.KEY_COL, tsr_reduce.NF) == (tsi.GCOL_KEY, tsi.NF)
    rows, m0 = ROW_CASES[case]()
    keys = rows[:, tsi.GCOL_KEY].astype(np.int32)
    order = np.argsort(keys, kind="stable")
    head = int((keys == 0).sum())
    perm, bounds = tsr_reduce.keyed_perm(torch.as_tensor(rows), m0)
    assert perm.dtype == bounds.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), order[head:])
    want = np.searchsorted(keys[order], np.arange(1, m0 + 2)) - head
    np.testing.assert_array_equal(bounds.numpy(), want)
    assert int(bounds[-1]) == (keys > 0).sum()


@pytest.mark.parametrize("n_payload", [tsi.GCOL_ABSDX, tsi.N_GCOLS])
@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_stream_reduction_equals_sorted_copy(case, n_payload):
    rows, m0 = ROW_CASES[case]()
    rows = torch.as_tensor(rows)
    before = dict(cuda_build.launch_counts)
    got = tsi.reduce_stream_grads(rows, m0, n_payload)
    assert dict(cuda_build.launch_counts) == before  # CPU: plain versions
    assert got.shape == (n_payload, m0)
    assert torch.equal(got, _sorted_copy_reduce(rows, m0, n_payload))


@pytest.mark.parametrize("case", ["long run", "no keyed row", "pinhole 2 cameras"])
def test_stream_reduction_matches_jax(case):
    import jax.numpy as jnp
    from splat_one_tpu.ops import stream_isect as jsi

    rows, m0 = ROW_CASES[case]()
    want = np.asarray(jsi.reduce_stream_grads(jnp.asarray(rows.T), m0, tsi.N_GCOLS))
    got = tsi.reduce_stream_grads(torch.as_tensor(rows), m0, tsi.N_GCOLS).numpy()
    scale = np.abs(want).max(1, keepdims=True)
    assert (np.abs(got - want) <= 2.0 ** -15 * scale).all()
    if case == "no keyed row":
        assert not got.any()


def _tiled_rows(isect, align_cap, seed):
    """Random gradient rows on the slots a tiled replay can write (zero on
    padding slots)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((align_cap, tis.NF), np.float32)
    live = isect.slot_rank.numpy() < isect.rank_src.shape[0]
    rows[live, :tis.N_GROWS] = rng.normal(size=(int(live.sum()), tis.N_GROWS))
    return torch.as_tensor(rows)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_reduction_equals_gather_copy(case):
    kw, model = CASES[case]
    cfg, isect, _ = _tile_port_inputs(_scene(**kw), model, "cpu")
    m0 = cfg.num_cameras * cfg.num_gaussians
    rows = _tiled_rows(isect, cfg.align_cap, 8)
    got = tis.gather_reduction(rows, isect, m0)
    copy = rows[isect.rank_perm.long()]
    ident = torch.arange(copy.shape[0], dtype=torch.int32)
    per_rank = tsr_reduce.segment_reduce_plain(copy, ident, isect.rank_bounds, tis.N_GROWS)
    want = per_rank.new_empty((tis.N_GROWS, m0))
    want[:, isect.rank_src.long()] = per_rank
    assert torch.equal(got, want)
    assert int(isect.rank_bounds[-1]) > 0


def test_reduce_rejects_bad_inputs():
    rows = torch.zeros((8, tsi.NF), device="meta")
    idx = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tsr_reduce.keyed_perm(rows, 2)
    with pytest.raises(ValueError):
        tsr_reduce.segment_reduce_rows(rows, idx, idx, tsi.N_GCOLS, out_index=idx)


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check_stream_kernels(rows, m0, n_payload):
    """Both stream kernels against their plain versions, each launch
    counted once."""
    n0 = dict(cuda_build.launch_counts)
    perm, bounds = tsr_reduce.keyed_perm(rows, m0)
    got = tsr_reduce.segment_reduce_rows(rows, perm, bounds, n_payload)
    for k in ("keyed_perm", "seg_reduce"):
        assert cuda_build.launch_counts[k] == n0.get(k, 0) + 1, k
    perm_p, bounds_p = tsr_reduce.keyed_perm_plain(rows, m0)
    torch.cuda.synchronize()
    assert torch.equal(bounds, bounds_p)
    assert torch.equal(perm[:perm_p.shape[0]], perm_p)
    assert torch.equal(got, tsr_reduce.segment_reduce_plain(rows, perm_p, bounds_p,
                                                            n_payload))
    assert torch.equal(got, tsi.reduce_stream_grads(rows, m0, n_payload))


@pytest.mark.gpu
@pytest.mark.parametrize("absgrad", [False, True])
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_cuda_stream_reduction_matches_plain(case, absgrad):
    """On the CUDA backward's rows of each small scene."""
    _gpu()
    scene, model = GPU_CASES[case]
    cfg, isect, packed = _port_inputs(scene(), model, "cuda")
    cfg = dataclasses.replace(cfg, absgrad=absgrad)
    out = tsr.stream_fwd(cfg, isect.st_starts, packed)
    gout = torch.as_tensor(_gout(cfg, 5), device="cuda")
    pg = tsr.stream_bwd(cfg, isect.st_starts, isect.st_starts_al, packed, out, gout)
    _check_stream_kernels(pg, cfg.num_cameras * cfg.num_gaussians,
                          tsi.N_GCOLS if absgrad else tsi.GCOL_ABSDX)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged", "long run", "no keyed row"])
def test_cuda_stream_reduction_ragged(case):
    _gpu()
    rows, m0 = ROW_CASES[case]()
    _check_stream_kernels(torch.as_tensor(rows, device="cuda"), m0, tsi.N_GCOLS)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_cuda_tiled_reduction_matches_plain(case):
    """On the CUDA tiled backward's rows of each small scene."""
    _gpu()
    scene, model = GPU_CASES[case]
    cfg, isect, packed = _tile_port_inputs(scene(), model, "cuda")
    out = ttr.tile_fwd(cfg, isect.tile_starts, packed)
    gout = torch.as_tensor(_tile_gout(cfg, 5), device="cuda")
    pg = ttr.tile_bwd(cfg, isect.tile_starts, packed, out, gout)
    m0 = cfg.num_cameras * cfg.num_gaussians
    n0 = cuda_build.launch_counts["seg_reduce"]
    got = tis.gather_reduction(pg, isect, m0)
    assert cuda_build.launch_counts["seg_reduce"] == n0 + 1
    want = tsr_reduce.segment_reduce_plain(pg, isect.rank_perm, isect.rank_bounds,
                                           tis.N_GROWS, out_index=isect.rank_src)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_reduction_adds_no_sync():
    """Both reductions run under ``set_sync_debug_mode("error")``: no
    ``.item()``, mask indexing, ``nonzero`` or copy to the host."""
    _gpu()
    rows, m0 = _long_run_rows()
    rows = torch.as_tensor(rows, device="cuda")
    scene, model = GPU_CASES["pinhole"]
    cfg, isect, packed = _tile_port_inputs(scene(), model, "cuda")
    pg = _tiled_rows(isect.__class__(*(t.cpu() for t in isect)), cfg.align_cap, 3).cuda()
    m0_t = cfg.num_cameras * cfg.num_gaussians
    want = (tsi.reduce_stream_grads(rows, m0), tis.gather_reduction(pg, isect, m0_t))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = (tsi.reduce_stream_grads(rows, m0), tis.gather_reduction(pg, isect, m0_t))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
