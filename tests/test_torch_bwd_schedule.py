"""The backward kernels' zero fill, modelled on the CPU in numpy.

Both backward kernels write every row of their output themselves (the
wrappers allocate it with ``torch.empty``): a block (``stream_bwd``: 512
threads a supertile; ``tile_bwd``: 128 a tile) writes its replayed
chunks' rows, zeroes the rest of its range, and all blocks share the rows
outside every range in a grid-stride loop. Over random layouts (empty
supertiles with a lead, ranges clamped at the capacity, slack up to
pad_cap / align_cap), those writes must partition the output's float4s
exactly.
"""

import numpy as np
import pytest

G = 128  # slots per chunk


def _count_fill(n_rows, ranges, replayed, threads):
    """float4 writes of a kernel over an output of ``n_rows`` rows: the
    block of each range [lo, hi) replays ``replayed`` chunks of G rows from
    lo and zeroes the rest (its ``threads`` threads from lo + tid, stride
    threads); all the blocks zero [0, ranges[0][0]) and [ranges[-1][1],
    n_rows) in a grid-stride loop. -> writes per float4."""
    hits = np.zeros(4 * n_rows, np.int64)
    for (lo_r, hi_r), nch in zip(ranges, replayed):
        rows = lo_r + np.arange(nch * G)
        np.add.at(hits, (4 * rows[:, None] + np.arange(4)).ravel(), 1)
        lo, hi = 4 * (lo_r + nch * G), 4 * hi_r
        np.add.at(hits, np.concatenate([np.arange(lo + t, hi, threads)
                                        for t in range(threads)]), 1)
    head = 4 * ranges[0][0]
    tail0 = 4 * min(ranges[-1][1], n_rows)
    n_out = head + 4 * n_rows - tail0
    grid = len(ranges)
    gt = np.arange(grid * threads)
    idx = np.concatenate([np.arange(g0, n_out, grid * threads) for g0 in gt[:n_out]])
    np.add.at(hits, np.where(idx < head, idx, tail0 + (idx - head)), 1)
    return hits


@pytest.mark.parametrize("seed", range(4))
def test_stream_rows_partition_pad_cap(seed):
    rng = np.random.default_rng(seed)
    cs = int(rng.integers(1, 9))
    counts = rng.integers(0, 700, cs) * (rng.random(cs) < 0.8)  # some empty
    st_starts = np.concatenate([[0], np.cumsum(counts)])
    # stream_isect.build_stream_intersections: each supertile's rows start
    # G-aligned and hold its chunks from floor(s0 / G) * G
    lead = st_starts[:-1] % G
    counts_al = -(-(lead + counts) // G) * G
    st_al = np.concatenate([[0], np.cumsum(counts_al)])
    exp_cap = int(st_starts[-1] + rng.integers(0, 3000))
    pad_cap = -(-(exp_cap + 2 * cs * G) // 1024) * 1024  # StreamCfg.pad_cap
    # the forward's per-tile chunk counts; the block replays up to the largest
    base0 = (st_starts[:-1] // G) * G
    n_ch = -(-(st_starts[1:] - base0) // G)
    nch_tiles = rng.integers(0, n_ch[:, None] + 2, (cs, 4))
    nchunks = np.minimum(n_ch, nch_tiles.max(1))
    ranges = list(zip(st_al[:-1], st_al[1:]))
    hits = _count_fill(pad_cap, ranges, nchunks, 512)
    assert (hits == 1).all(), np.flatnonzero(hits != 1)[:8]


@pytest.mark.parametrize("seed", range(4))
def test_tiled_rows_partition_align_cap(seed):
    rng = np.random.default_rng(100 + seed)
    ct = int(rng.integers(1, 17))
    counts = rng.integers(0, 400, ct) * (rng.random(ct) < 0.7)
    exp_cap = int(counts.sum() + rng.integers(0, 500))
    align_cap = exp_cap + ct * G  # IsectCaps.choose
    counts_al = -(-counts // G) * G
    # intersect.build_intersections: ranges clamped to the last whole chunk
    starts = np.minimum(np.concatenate([[0], np.cumsum(counts_al)]), (align_cap // G) * G)
    if seed == 0:  # a layout past the capacity: the last ranges are cut
        starts = np.minimum(starts, starts[ct // 2])
    n_ch = (starts[1:] - starts[:-1]) // G
    nchunks = np.minimum(n_ch, rng.integers(0, n_ch + 2))
    ranges = list(zip(starts[:-1], starts[1:]))
    hits = _count_fill(align_cap, ranges, nchunks, 128)
    assert (hits == 1).all(), np.flatnonzero(hits != 1)[:8]
