"""Feature matching: pair selection, batched descriptor matching and two-view
verification. The port of ``splat_one_tpu/sfm/matching.py``.

Brute-force matching is one descriptor product per pair ([K, K] cosine
similarities of 128-D rootSIFT descriptors) with the Lowe ratio and
mutual-nearest tests, batched over pairs. Pair selection (exhaustive, by
sequence order, GPS distance or VLAD appearance) runs on the host; the
VLAD vocabulary's k-means and the signatures run on the device.

The verification's RANSAC draws are arguments: ``u [n_hyp, 8]``
integers in [0, 2^30) per pair, taken by default from a
``torch.Generator`` on the device (``verify_draws``).
"""

from __future__ import annotations

from itertools import combinations
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from splat_one_tpu_torch.sfm import geometry as geo
from splat_one_tpu_torch.utils.device import resolve as resolve_device

N_HYP_VERIFY = 1024  # hypotheses of the pair verification's RANSAC
VERIFY_SOLVER = "8pt"  # the filter's solver (init pairs in reconstruct stay 5-point)


def vlad_signatures(
    descriptors: Sequence[np.ndarray],  # per image [K, D] L2-normalized
    n_words: int = 16,
    iters: int = 8,
    seed: int = 0,
    valids: Optional[Sequence[np.ndarray]] = None,  # per image [K] bool
    device="cuda",
) -> np.ndarray:
    """Per-image VLAD signature over a k-means vocabulary trained on the
    scene's own descriptors (invalid rows left out): one product assigns
    descriptors to words; residuals are aggregated, power- and
    L2-normalized, and concatenated with the word-usage histogram.
    The subsample and the initial words are numpy ``default_rng(seed)``
    draws. Returns [M, n_words * D + n_words]."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if valids is None:
        valids = [np.ones(len(d), bool) for d in descriptors]
    alld = np.concatenate(
        [d[np.asarray(v, bool)] for d, v in zip(descriptors, valids) if len(d)], axis=0)
    if len(alld) == 0:
        return np.zeros((len(descriptors), 0), np.float32)
    # texture-poor scenes: never ask for more words than descriptors
    n_words = max(1, min(n_words, len(alld)))
    sub = alld[rng.choice(len(alld), min(len(alld), 20_000), replace=False)]
    centers_np = sub[rng.choice(len(sub), n_words, replace=False)].copy()
    sub = torch.as_tensor(sub, dtype=torch.float32, device=dev)
    centers = torch.as_tensor(centers_np, dtype=torch.float32, device=dev)

    for _ in range(iters):
        # cosine assignment (descriptors are unit length)
        a = torch.argmax(sub @ centers.T, dim=1)
        oh = torch.nn.functional.one_hot(a, n_words).to(torch.float32)
        sums = oh.T @ sub
        cnt = oh.sum(dim=0)[:, None]
        new = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1), centers)
        centers = new / torch.clamp(torch.linalg.norm(new, dim=1, keepdim=True), min=1e-9)

    D = alld.shape[1]
    out = np.zeros((len(descriptors), n_words * D + n_words), np.float32)
    for i, (d, v) in enumerate(zip(descriptors, valids)):
        if not (len(d) and np.any(v)):
            continue
        d = torch.as_tensor(d, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(np.asarray(v, np.float32), device=dev)
        a = torch.argmax(d @ centers.T, dim=1)
        oh = torch.nn.functional.one_hot(a, n_words).to(torch.float32) * mask[:, None]
        resid = oh.T @ d - oh.sum(0)[:, None] * centers
        sv = resid.reshape(-1)
        sv = torch.sign(sv) * torch.sqrt(torch.abs(sv))  # power normalization
        sv = sv / torch.clamp(torch.linalg.norm(sv), min=1e-9)
        # BoW component: the word-usage histogram
        h = torch.sqrt(oh.sum(0) / torch.clamp(oh.sum(), min=1))
        h = h / torch.clamp(torch.linalg.norm(h), min=1e-9)
        out[i] = (torch.cat([sv, h]) / np.sqrt(2.0).astype(np.float32)).cpu().numpy()
    return out


def pairs_to_match(
    n_images: int,
    *,
    order_neighbors: int = 0,
    gps_positions: Optional[np.ndarray] = None,
    gps_neighbors: int = 0,
    descriptors: Optional[Sequence[np.ndarray]] = None,
    desc_valids: Optional[Sequence[np.ndarray]] = None,
    vlad_neighbors: int = 0,
    max_pairs: Optional[int] = None,
    device="cuda",
) -> List[Tuple[int, int]]:
    """Candidate pairs: exhaustive by default, else the union of
    sequence-order neighbours, GPS nearest neighbours (images without a
    fix left out) and VLAD appearance nearest neighbours; ``max_pairs``
    keeps an evenly spaced subsample. ``device`` runs the VLAD k-means."""
    pairs = set()
    if order_neighbors <= 0 and gps_neighbors <= 0 and vlad_neighbors <= 0:
        pairs = set(combinations(range(n_images), 2))
    if order_neighbors > 0:
        for i in range(n_images):
            for j in range(i + 1, min(i + 1 + order_neighbors, n_images)):
                pairs.add((i, j))
    if gps_neighbors > 0 and gps_positions is not None:
        d = np.linalg.norm(gps_positions[:, None] - gps_positions[None], axis=-1)
        for i in range(n_images):
            if not np.isfinite(gps_positions[i]).all():
                continue  # no fix: excluded from the GPS criterion
            taken = 0
            for j in np.argsort(d[i]):
                j = int(j)
                if j == i or not np.isfinite(d[i, j]):
                    continue
                pairs.add((min(i, j), max(i, j)))
                taken += 1
                if taken >= gps_neighbors:
                    break
    if vlad_neighbors > 0 and descriptors is not None:
        sig = vlad_signatures(descriptors, valids=desc_valids, device=device)
        sim = sig @ sig.T
        for i in range(n_images):
            taken = 0
            for j in np.argsort(-sim[i]):
                j = int(j)
                if j == i:  # zero/tied signatures need not rank self first
                    continue
                pairs.add((min(i, j), max(i, j)))
                taken += 1
                if taken >= vlad_neighbors:
                    break
    out = sorted(pairs)
    if max_pairs is not None and len(out) > max_pairs:
        # evenly spaced: a head-truncation would drop every pair of the
        # high-index images
        keep = np.linspace(0, len(out) - 1, max_pairs).astype(int)
        out = [out[k] for k in keep]
    return out


def match_descriptors(d1, d2, valid1, valid2, ratio: float = 0.8):
    """Mutual-nearest + Lowe-ratio matching of ``d1`` [..., K, D] against
    ``d2`` [..., K2, D] (leading dims batch pairs). Returns (idx2 [..., K],
    ok [..., K]): each feature's match in image 2 and whether it holds."""
    sim = d1 @ d2.transpose(-1, -2)  # cosine similarity
    neg = -1e9
    sim = torch.where(valid1[..., :, None] & valid2[..., None, :], sim,
                      torch.full_like(sim, neg))
    # distances: for rootSIFT descriptors, d^2 = 2 - 2 sim
    best2 = torch.argmax(sim, dim=-1)
    s_sorted = torch.topk(sim, 2, dim=-1).values
    d_first = torch.sqrt(torch.clamp(2.0 - 2.0 * s_sorted[..., 0], min=0.0))
    d_second = torch.sqrt(torch.clamp(2.0 - 2.0 * s_sorted[..., 1], min=1e-12))
    pass_ratio = d_first < ratio * d_second
    # mutual check
    best1_of2 = torch.argmax(sim, dim=-2)
    mutual = torch.gather(best1_of2, -1, best2) == torch.arange(d1.shape[-2], device=d1.device)
    ok = pass_ratio & mutual & valid1 & (s_sorted[..., 0] > neg / 2)
    return best2, ok


def match_pairs_brute_force(
    descriptors: Sequence[np.ndarray],  # per image [K, D]
    valids: Sequence[np.ndarray],
    pairs: Sequence[Tuple[int, int]],
    ratio: float = 0.8,
    progress_callback=None,
    device="cuda",
):
    """Match a list of image pairs one at a time; returns {pair: [M, 2]
    feature-index arrays}. ``progress_callback(i, total)`` after each."""
    dev = resolve_device(device)
    out = {}
    for n, (i, j) in enumerate(pairs):
        t = [torch.as_tensor(np.asarray(x), device=dev)
             for x in (descriptors[i], descriptors[j], valids[i], valids[j])]
        idx2, ok = match_descriptors(*t, ratio=ratio)
        ok = ok.cpu().numpy()
        idx2 = idx2.cpu().numpy()
        m1 = np.nonzero(ok)[0]
        out[(i, j)] = np.stack([m1, idx2[m1]], axis=-1)
        if progress_callback is not None:
            progress_callback(n + 1, len(pairs))
    return out


def match_pairs_batched(
    descriptors: Sequence[np.ndarray],  # per image [K, D]
    valids: Sequence[np.ndarray],
    pairs: Sequence[Tuple[int, int]],
    ratio: float = 0.8,
    batch_pairs: int = 16,
    progress_callback=None,
    device="cuda",
):
    """Brute-force matching of ``batch_pairs`` pairs per batched product:
    every image's descriptors padded to one [M, K, D] tensor on the device,
    the pairs gathered from it. Same results as ``match_pairs_brute_force``."""
    if not len(pairs):
        return {}
    dev = resolve_device(device)
    M_img = len(descriptors)
    K = max(d.shape[0] for d in descriptors)
    D = max((d.shape[1] for d in descriptors if d.ndim == 2), default=128)
    desc_all = np.zeros((M_img, K, D), np.float32)
    val_all = np.zeros((M_img, K), bool)
    for i, (d, v) in enumerate(zip(descriptors, valids)):
        if len(d):
            desc_all[i, : d.shape[0], : d.shape[1]] = d
            val_all[i, : len(v)] = v
    desc_all = torch.as_tensor(desc_all, device=dev)
    val_all = torch.as_tensor(val_all, device=dev)

    out = {}
    P = max(1, int(batch_pairs))
    for s in range(0, len(pairs), P):
        chunk = list(pairs[s: s + P])
        i_idx = torch.as_tensor([p[0] for p in chunk], device=dev)
        j_idx = torch.as_tensor([p[1] for p in chunk], device=dev)
        idx2_b, ok_b = match_descriptors(desc_all[i_idx], desc_all[j_idx],
                                         val_all[i_idx], val_all[j_idx], ratio=ratio)
        idx2_b = idx2_b.cpu().numpy()
        ok_b = ok_b.cpu().numpy()
        for n, (i, j) in enumerate(chunk):
            m1 = np.nonzero(ok_b[n])[0]
            out[(i, j)] = np.stack([m1, idx2_b[n][m1]], axis=-1)
        if progress_callback is not None:
            progress_callback(min(s + P, len(pairs)), len(pairs))
    return out


def verify_draws(n_items: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """Per-pair RANSAC draws of the verification: [n_items, 1024, 8]
    integers in [0, 2^30) from a generator on ``device``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 1 << 30, (n_items, N_HYP_VERIFY, 8), generator=g, device=dev)


def robust_filter_matches_batched(
    matches: dict,  # {(i, j): [M, 2]}
    bearings: Sequence[np.ndarray],  # per image [K, 3]
    threshold: float = 0.008,
    min_matches: int = 16,
    min_inliers: int = 20,
    target_err_elems: int = 1 << 26,
    seed: int = 0,
    draws=None,  # [n_pairs, n_hyp, 8] ints in pair-sorted order
    device="cuda",
):
    """Batched two-view verification: 8-point RANSAC with 1024 hypotheses
    per pair, pairs with fewer than ``min_inliers`` in its consensus
    dropped. Pairs are bucketed by their power-of-two padded match count
    and a bucket's pairs verified together; ``target_err_elems`` caps
    the batch's [P, n_hyp * 10, cap] residual size (the JAX package's
    sizing, kept so the batches are the same). Pair ``n`` of the sorted
    pairs takes ``draws[n]``; by default ``verify_draws(len(matches), seed)``."""
    dev = resolve_device(device)
    items = sorted(matches.items())
    if draws is None:
        draws = verify_draws(len(items), seed, dev)
    draws = torch.as_tensor(draws, device=dev)
    out = {}
    buckets = {}
    for n, ((i, j), m) in enumerate(items):
        if len(m) < min_matches:
            out[(i, j)] = m[:0]
            continue
        cap = max(64, 1 << (len(m) - 1).bit_length())
        buckets.setdefault(cap, []).append((n, (i, j), m))

    for cap, entries in sorted(buckets.items()):
        P = max(1, min(64, target_err_elems // (N_HYP_VERIFY * 10 * cap)))
        for s in range(0, len(entries), P):
            chunk = entries[s: s + P]
            b1 = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (len(chunk), cap, 1))
            b2 = b1.copy()
            valid = np.zeros((len(chunk), cap), bool)
            for n, (_, (i, j), m) in enumerate(chunk):
                b1[n, : len(m)] = bearings[i][m[:, 0]]
                b2[n, : len(m)] = bearings[j][m[:, 1]]
                valid[n, : len(m)] = True
            u = draws[torch.as_tensor([e[0] for e in chunk], device=dev)]
            res = geo.ransac_essential(
                u, torch.as_tensor(b1, device=dev), torch.as_tensor(b2, device=dev),
                torch.as_tensor(valid, device=dev), threshold=float(threshold),
                solver=VERIFY_SOLVER)
            n_inl = res.n_inliers.cpu().numpy()
            inl = res.inliers.cpu().numpy()
            for n, (_, pair, m) in enumerate(chunk):
                if int(n_inl[n]) < min_inliers:
                    out[pair] = m[:0]
                else:
                    out[pair] = m[inl[n][: len(m)]]
    return out


def robust_filter_matches(
    matches: np.ndarray,  # [M, 2]
    bearings1: np.ndarray,  # [K, 3]
    bearings2: np.ndarray,
    threshold: float = 0.008,
    min_matches: int = 16,
    min_inliers: int = 20,
    seed: int = 0,
    draws=None,  # [n_hyp, 8] ints
    device="cuda",
):
    """Two-view verification of one pair's putative matches (8-point
    RANSAC, 1024 hypotheses, padded to a power-of-two bucket); the whole
    pair is rejected below ``min_inliers``. Returns the kept matches."""
    dev = resolve_device(device)
    if len(matches) < min_matches:
        return matches[:0]
    M = len(matches)
    cap = max(64, 1 << (M - 1).bit_length())
    b1 = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (cap, 1))
    b2 = b1.copy()
    b1[:M] = bearings1[matches[:, 0]]
    b2[:M] = bearings2[matches[:, 1]]
    valid = np.arange(cap) < M
    if draws is None:
        draws = verify_draws(1, seed, dev)[0]
    res = geo.ransac_essential(
        torch.as_tensor(draws, device=dev), torch.as_tensor(b1, device=dev),
        torch.as_tensor(b2, device=dev), torch.as_tensor(valid, device=dev),
        threshold=threshold, solver=VERIFY_SOLVER)
    if int(res.n_inliers) < min_inliers:
        return matches[:0]
    return matches[res.inliers.cpu().numpy()[:M]]
