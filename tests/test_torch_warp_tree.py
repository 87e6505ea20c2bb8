"""The backward kernels' per-slot sums and quotients, modelled on the CPU.

The plain versions (``stream_bwd_plain``, ``tile_bwd_plain``) sum each of
10 or 12 values over a warp of 32 pixels with the halving tree
``stream_raster.warp_sum``: pixel l + 16 onto pixel l, then + 8, 4, 2, 1.
The CUDA kernels (``csrc/bwd_common.cuh::half_warp_sum``) give each
thread two of those pixels, l and l + 16 (l < 16), so the first level is
the thread's own add; the other four are a reduce-scatter over the 16
threads: at each of the xor offsets 8, 4, 2, 1 a thread keeps half of the
values it holds (the half that bit ``off`` of its lane picks), sends the
other half to lane ^ off and adds the partner's copy, after which thread
l holds the sum of value l. The model below repeats the kernels' steps in
numpy float32, including the first shuffle step without selects where
value i + 8 does not exist, and must give the plain tree's bits exactly,
on seeded values from 1e-6 to 1e6 of both signs.

The kernels divide by 1 - alpha without the IEEE division's slow-path
branch (``bwd_common.cuh::recip`` / ``div_rn``): 1/b to double precision,
the product a * (1/b) in double, one rounding to f32. That rounding must
give the f32 quotient ``a / b`` bit for bit; it is checked here for every b
the kernels see (1 - alpha, alpha 0 or in [1/255, 0.999]), numerators from
subnormal to near overflow, quotients placed near rounding midpoints, and
reciprocals up to 2 double ulps off (the kernels' Newton steps leave less).
"""

import numpy as np
import pytest
import torch

from splat_one_tpu_torch.ops.stream_raster import warp_sum

LANES = np.arange(16)  # the threads of one half of a hardware warp


def _shfl_xor(x, off):
    """__shfl_xor_sync within a half warp: each thread reads lane ^ off's
    register ([B, 16])."""
    return x[:, LANES ^ off]


def _half_warp_sum(v):
    """half_warp_sum<NR> on the 32 pixels v [B, 32, NR] f32 of one plain
    warp -> what each of the 16 threads returns [B, 16]."""
    nr = v.shape[-1]
    s = v[:, :16] + v[:, 16:]  # thread l holds pixels l and l + 16
    up = (LANES & 8) != 0
    held = []
    for i in range(nr - 8):  # both halves hold values: keep, send by bit 3
        keep = np.where(up, s[:, :, i + 8], s[:, :, i])
        send = np.where(up, s[:, :, i], s[:, :, i + 8])
        held.append(keep + _shfl_xor(send, 8))
    for i in range(nr - 8, 8):  # value i + 8 does not exist
        held.append(s[:, :, i] + _shfl_xor(s[:, :, i], 8))
    for off in (4, 2, 1):
        n = len(held) // 2
        up = (LANES & off) != 0
        held = [np.where(up, held[i + n], held[i])
                + _shfl_xor(np.where(up, held[i], held[i + n]), off) for i in range(n)]
    return held[0]


def _values(nr, seed, batch=4096):
    """[batch, 32, nr] f32, magnitudes log-uniform over 1e-6..1e6, mixed signs."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-6.0, 6.0, size=(batch, 32, nr))
    sign = rng.choice([-1.0, 1.0], size=(batch, 32, nr))
    return (sign * mag).astype(np.float32)


@pytest.mark.parametrize("nr", [10, 12])
def test_reduce_scatter_matches_plain_tree(nr):
    v = _values(nr, seed=nr)
    want = warp_sum(torch.as_tensor(v)).numpy()  # [B, nr]
    got = _half_warp_sum(v)
    assert got.dtype == want.dtype == np.float32
    # the kernels' value-index-to-lane map: thread l (of each half warp)
    # holds and stores value l, for l < NR
    assert np.array_equal(got[:, :nr], want)
    # not a vacuous comparison: another order of the same sums differs
    assert not np.array_equal(v.sum(axis=1, dtype=np.float32), want)


@pytest.mark.parametrize("tile_threads, tiles", [(128, 4), (128, 1)])
def test_thread_pixel_map(tile_threads, tiles):
    """The kernels' thread -> pixel map (stream_bwd: 512 threads over 4
    tiles; tile_bwd: 128 over 1): thread tid of tile j holds pixels p0 and
    p0 + 16 of the plain tree's warp vw, lanes l and l + 16 of it, and
    every pixel of the block once."""
    seen = []
    for tid in range(tile_threads * tiles):
        lane = tid & 31
        j = tid // tile_threads
        vw = 2 * (tid >> 5) + (lane >> 4)
        p0 = (vw % 8) * 32 + (lane & 15)
        assert vw // 8 == j  # a hardware warp lies inside one tile
        for p in (p0, p0 + 16):
            # plain: thread j * 256 + p is lane (j * 256 + p) % 32 of warp // 32
            assert (j * 256 + p) // 32 == vw
            seen.append(j * 256 + p)
    assert sorted(seen) == list(range(256 * tiles))


@pytest.mark.parametrize("ulps", [-2, -1, 0, 1, 2])
def test_division_by_double_reciprocal(ulps):
    rng = np.random.default_rng(20 + ulps)
    n = 1_000_000
    alpha = rng.uniform(1.0 / 255.0, 0.999, n).astype(np.float32)
    alpha[:1000] = 0.0  # killed pixels: b = 1
    b = np.float32(1.0) - alpha
    a = (rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-45.0, 38.0, n)).astype(np.float32)
    a[1000:2000] = 0.0
    # numerators whose quotient lies near an f32 rounding midpoint
    m = (rng.integers(2**23, 2**24, 200_000) * 2 + 1) * 2.0 ** rng.integers(-60, 40, 200_000)
    a[2000:202_000] = (b[2000:202_000].astype(np.float64) * m / 2**24).astype(np.float32)
    inv = 1.0 / b.astype(np.float64)
    for _ in range(abs(ulps)):
        inv = np.nextafter(inv, np.inf if ulps > 0 else 0.0)
    with np.errstate(over="ignore"):
        got = (a.astype(np.float64) * inv).astype(np.float32)
        want = a / b
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
