"""Port parity: ``sfm/matching.py`` and ``sfm/tracks.py`` against the JAX
package, on the CPU, on JAX's synthetic multiview scene
(``tests/test_sfm_pipeline.py::synth_multiview``).

- ``match_descriptors``: ``idx2`` and ``ok`` exactly JAX's;
  ``match_pairs_batched`` (ragged K, batches of 3 and 16) gives JAX's dict
  exactly, and equals the port's ``match_pairs_brute_force``.
- ``pairs_to_match`` by order, GPS (images without a fix left out) and
  VLAD: exactly JAX's list; ``vlad_signatures`` within 1e-5 abs.
- ``robust_filter_matches`` and ``robust_filter_matches_batched`` fed
  JAX's per-pair draws: exactly JAX's kept matches on the clean pairs;
  on the two pairs with 30 % planted outliers, RANSAC's outcome in both
  packages (see ``_check_kept`` for why the kept sets may differ there).
- ``build_tracks``: exactly JAX's tracks.
- Mirrors of JAX's ``test_matching_and_tracks``,
  ``test_batched_matching_equals_sequential``,
  ``test_batched_verification_filters_outliers`` and ``TestVladPairs``
  on the port alone (draws from a seeded torch generator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_one_tpu.sfm import matching as JM
from splat_one_tpu.sfm import tracks as JT
from splat_one_tpu_torch.sfm import matching as M
from splat_one_tpu_torch.sfm import tracks as T
from test_sfm_pipeline import synth_multiview


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the SfM runs thousands of tiny ops, which
    spin-wait themselves to a crawl when several test workers each run a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEV = "cpu"


def _jax_verify_draws(key, n_items):
    """The draws JAX's batched verification takes for pair n of the
    pair-sorted items: ``randint(keys[n], (1024, 8), 0, 2^30)``."""
    keys = jax.random.split(key, n_items + 1)[1:]
    return np.stack([np.asarray(jax.random.randint(k, (1024, 8), 0, 1 << 30)) for k in keys])


def _planted(n_pts=150, n_bad=45, seed=7):
    """synth_multiview's 4 views matched, with 30 % gross outliers planted
    in pairs (0, 1) and (1, 3)."""
    poses, X, bearings, descs, valids = synth_multiview(4, n_pts)
    raw = JM.match_pairs_batched(descs, valids, JM.pairs_to_match(4))
    rng = np.random.default_rng(seed)
    for pair in ((0, 1), (1, 3)):
        bad = np.stack([rng.permutation(n_pts)[:n_bad], rng.permutation(n_pts)[:n_bad]], -1)
        raw[pair] = np.concatenate([raw[pair], bad])
    return raw, bearings


def test_match_descriptors_exact():
    _, _, _, descs, valids = synth_multiview(3, 200, seed=1)
    valids[1][::7] = False
    for i, j in ((0, 1), (1, 2), (0, 2)):
        idx_j, ok_j = JM.match_descriptors(jnp.asarray(descs[i]), jnp.asarray(descs[j]),
                                           jnp.asarray(valids[i]), jnp.asarray(valids[j]),
                                           ratio=0.8)
        idx_t, ok_t = M.match_descriptors(*(torch.as_tensor(x) for x in (
            descs[i], descs[j], valids[i], valids[j])), ratio=0.8)
        ok_j = np.asarray(ok_j)
        assert np.array_equal(ok_j, ok_t.numpy())
        assert np.array_equal(np.asarray(idx_j)[ok_j], idx_t.numpy()[ok_j])
        assert ok_j.sum() > 100


def test_batched_matching_equals_jax_and_sequential():
    _, _, _, descs, valids = synth_multiview(5, 120)
    descs[2], valids[2] = descs[2][:90], valids[2][:90]  # ragged K
    pairs = M.pairs_to_match(5, device=DEV)
    ref = JM.match_pairs_brute_force(descs, valids, pairs)
    seq = M.match_pairs_brute_force(descs, valids, pairs, device=DEV)
    for bp in (3, 16):  # a non-divisor and a batch larger than the set
        bat = M.match_pairs_batched(descs, valids, pairs, batch_pairs=bp, device=DEV)
        assert set(bat) == set(ref) == set(seq)
        for p in ref:
            assert np.array_equal(bat[p], ref[p]) and np.array_equal(seq[p], ref[p]), p


def test_pairs_to_match_exact():
    rng = np.random.default_rng(0)
    _, _, _, descs, valids = synth_multiview(9, 80, seed=2)
    for v in valids:
        v[rng.uniform(size=len(v)) < 0.2] = False
    gps = rng.normal(size=(9, 3)) * 10
    gps[4] = np.inf  # no fix
    cases = [dict(), dict(order_neighbors=2), dict(gps_positions=gps, gps_neighbors=3),
             dict(descriptors=descs, desc_valids=valids, vlad_neighbors=3),
             dict(order_neighbors=1, gps_positions=gps, gps_neighbors=2, descriptors=descs,
                  desc_valids=valids, vlad_neighbors=2, max_pairs=11)]
    for kw in cases:
        assert M.pairs_to_match(9, **kw, device=DEV) == JM.pairs_to_match(9, **kw), kw


def test_vlad_signatures():
    _, _, _, descs, valids = synth_multiview(6, 120, seed=3)
    valids[2][:50] = False
    a = JM.vlad_signatures(descs, valids=valids)
    b = M.vlad_signatures(descs, valids=valids, device=DEV)
    assert a.shape == b.shape == (6, 16 * 128 + 16)
    assert np.abs(a - b).max() <= 1e-5


PLANTED = ((0, 1), (1, 3))


def _check_kept(got, ref, pair):
    """Exactly JAX's kept matches on a clean pair. On a pair with planted
    outliers the two packages' f32 RANSAC can settle on different models
    of equal or near-equal consensus (a sample that repeats a row has a
    >= 2-D nullspace that LAPACK builds resolve differently, and the
    inlier refits' eigenvectors differ at ~1e-4), so there each keeps
    >= 80 % of the pair's 150 true matches and at most 10 outliers (the
    JAX package keeps 132 on pair (1, 3) with its key 0 draws)."""
    if pair not in PLANTED:
        assert np.array_equal(got, ref), pair
        return
    for out in (got, ref):
        true = int((out[:, 0] == out[:, 1]).sum())
        assert true >= 120 and len(out) - true <= 10, (pair, len(out), true)


def test_robust_filter_matches_with_jax_draws():
    raw, bearings = _planted()
    key = jax.random.PRNGKey(3)
    for (i, j), m in sorted(raw.items()):
        key, k1 = jax.random.split(key)
        ref = JM.robust_filter_matches(k1, m, bearings[i], bearings[j], threshold=0.008)
        u = np.asarray(jax.random.randint(k1, (1024, 8), 0, 1 << 30))
        got = M.robust_filter_matches(m, bearings[i], bearings[j], threshold=0.008, draws=u,
                                      device=DEV)
        _check_kept(got, ref, (i, j))


def test_robust_filter_batched_with_jax_draws():
    raw, bearings = _planted()
    raw[(2, 3)] = raw[(2, 3)][:10]  # below min_matches: dropped
    key = jax.random.PRNGKey(0)
    ref = JM.robust_filter_matches_batched(key, raw, bearings, threshold=0.008)
    got = M.robust_filter_matches_batched(raw, bearings, threshold=0.008,
                                          draws=_jax_verify_draws(key, len(raw)), device=DEV)
    assert set(got) == set(ref)
    for p in ref:
        _check_kept(got[p], ref[p], p)
    assert len(got[(2, 3)]) == 0 and len(got[(0, 1)]) > 100


def test_build_tracks_exact():
    _, _, _, descs, valids = synth_multiview(5, 100, seed=4)
    raw = JM.match_pairs_batched(descs, valids, JM.pairs_to_match(5))
    raw[(0, 2)] = np.concatenate([raw[(0, 2)], [[3, 7], [5, 5]]])  # a conflicting chain
    for min_len in (2, 3):
        tj, oj = JT.build_tracks(raw, [100] * 5, min_len)
        tt, ot = T.build_tracks(raw, [100] * 5, min_len)
        assert tt == tj and ot == oj


# ---- mirrors of the JAX package's tests, on the port alone ---------------
def test_matching_and_tracks():
    poses, X, bearings, descs, valids = synth_multiview(4, 100)
    matches = M.match_pairs_brute_force(descs, valids, M.pairs_to_match(4, device=DEV),
                                        device=DEV)
    for (i, j), m in matches.items():
        assert (m[:, 0] == m[:, 1]).mean() > 0.9
    tracks, track_of = T.build_tracks(matches, [100] * 4, min_track_length=2)
    assert len(tracks) > 80
    assert len([t for t in tracks if len(t) == 4]) > 50


def test_batched_verification_filters_outliers():
    poses, X, bearings, descs, valids = synth_multiview(4, 150)
    raw = M.match_pairs_batched(descs, valids, M.pairs_to_match(4, device=DEV), device=DEV)
    rng = np.random.default_rng(7)
    m = raw[(0, 1)]
    bad = np.stack([rng.permutation(150)[:25], rng.permutation(150)[:25]], axis=-1)
    raw[(0, 1)] = np.concatenate([m, bad])
    filt = M.robust_filter_matches_batched(raw, bearings, threshold=0.008, device=DEV)
    fm = filt[(0, 1)]
    assert len(fm) >= 0.8 * len(m)
    assert (fm[:, 0] == fm[:, 1]).mean() > 0.95
    # tiny pairs are rejected outright (min_matches rule)
    filt2 = M.robust_filter_matches_batched({(0, 1): raw[(0, 1)][:5]}, bearings, device=DEV)
    assert len(filt2[(0, 1)]) == 0


def test_vlad_selects_similar_images(rng):
    D, K = 32, 64
    protos = rng.normal(size=(2, 4, D))
    descs = []
    for i in range(8):
        base = protos[i // 4][rng.integers(0, 4, K)]
        d = base + rng.normal(0, 0.1, (K, D))
        descs.append((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    pairs = M.pairs_to_match(8, descriptors=descs, vlad_neighbors=2, device=DEV)
    same = sum(1 for i, j in pairs if i // 4 == j // 4)
    assert same / len(pairs) > 0.7, pairs


def test_matching_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.match_pairs_batched([np.zeros((4, 8), np.float32)] * 2, [np.ones(4, bool)] * 2,
                              [(0, 1)])
