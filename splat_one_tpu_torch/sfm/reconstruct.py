"""Incremental Structure-from-Motion: the port of
``splat_one_tpu/sfm/reconstruct.py``.

A host-side control loop (graph bookkeeping in numpy) around the device
pieces: two-view 5-point RANSAC init, batched PnP resection, linear
triangulation and the LM/Schur bundle adjuster (sfm.ba). BA problems and
RANSAC inputs are padded to power-of-two buckets as in the JAX package:
the padding decides the shapes the draws are taken over.

The RANSAC draws of one attempt come from one ``torch.Generator`` on the
device seeded with the attempt's seed, in the order the JAX package
splits its key: the packages agree in outcome, not draw for draw.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from splat_one_tpu_torch.sfm import ba as ba_mod
from splat_one_tpu_torch.sfm import geometry as geo
from splat_one_tpu_torch.utils.device import resolve as resolve_device


def _R_of(r: np.ndarray) -> np.ndarray:
    """Angle-axis -> rotation matrix (host, float64)."""
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _cross(a, b) -> np.ndarray:
    """np.cross of two 3-vectors, the same arithmetic without its
    per-call overhead (the host loop takes ~10^5 of them)."""
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]])


def _draws(gen: torch.Generator, n_hyp: int, n_sample: int) -> torch.Tensor:
    """One RANSAC call's draws [n_hyp, n_sample] in [0, 2^30)."""
    return torch.randint(0, 1 << 30, (n_hyp, n_sample), generator=gen, device=gen.device)


@dataclasses.dataclass
class ReconstructConfig:
    init_min_inliers: int = 50
    resection_min_inliers: int = 15
    ransac_threshold: float = 0.006
    triangulation_min_angle_deg: float = 1.0
    bundle_interval: int = 5  # global BA every N registrations
    bundle_max_iterations: int = 12  # config.yaml:115 analog
    final_bundle_max_iterations: int = 40  # the closing polish rounds run
    # LM to (near-)convergence — the interval bundles only need to keep
    # the incremental build healthy
    outlier_threshold: float = 0.01  # angular reprojection
    min_parallax_deg: float = 2.0  # init-pair parallax requirement
    # windowed local BA after each resection (config.yaml:117-124
    # local_bundle_radius): the new camera + its most covisible registered
    # neighbours move; boundary cameras observing the same points stay
    # fixed but constrain
    local_bundle_enabled: bool = True
    local_bundle_radius: int = 8  # movable covisible neighbours
    local_bundle_max_iterations: int = 6
    # GPS inside BA (config.yaml:132 bundle_use_gps): before each global
    # bundle the model is similarity-aligned to the GPS frame, then camera
    # centers get soft priors with weight 1/gps_sd_m^2 (the Ceres
    # position-prior analog). Requires gps_positions at reconstruct time.
    bundle_use_gps: bool = False
    gps_sd_m: float = 5.0
    # graduated non-convexity for the final polish: anneal the robust scale
    # 8x -> 1x with relaxed retriangulation acceptance at each stage (GNC).
    # A/B on the 12-view ring scene (scripts/sfm_ring_repro.py): default
    # pipeline median center error 0.117*spread; anneal 0.193*spread —
    # the relaxed re-admission pulls in marginal tracks that outweigh the
    # convexification, so this stays OFF by default; kept as an escape
    # hatch for scenes that do land in a warped robust-loss minimum.
    final_anneal: bool = False
    anneal_schedule: Tuple[float, ...] = (8.0, 4.0, 2.0, 1.0)
    # PnP resection keeps a looser inlier gate than track filtering:
    # resection must succeed from the not-yet-converged early geometry,
    # while the tight track threshold protects the bundle minimum
    resection_threshold_mult: float = 2.0
    # retry the whole incremental build from the next-best init pair when
    # registration stalls (<90% of images with observations) — outcomes
    # are chaotic in the init pair on marginal geometry (measured r2/r3);
    # keep the attempt registering the most cameras (ties: most points)
    init_retries: int = 3
    # early-stop bar on observation retention: an attempt that had to
    # prune >12% of track observations to satisfy its bundles is treated
    # as suspect (likely a warped minimum) and further init pairs are
    # tried; the best attempt by (geometry, cameras, retained obs,
    # residual) still wins if every attempt is suspect
    min_obs_retention: float = 0.88


@dataclasses.dataclass
class Reconstruction:
    """Result container (the framework's ``reconstruction.json`` analog)."""

    poses: Dict[int, np.ndarray]  # image -> [6] (rvec, t) world->cam
    points: Dict[int, np.ndarray]  # track id -> xyz
    report: Dict


def _rvec_from_R(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> angle-axis (host)."""
    tr = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(tr)
    if theta < 1e-8:
        return np.zeros(3)
    v = np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )
    if np.linalg.norm(v) < 1e-10:  # theta ~ pi
        # extract axis from R + I
        M = (R + np.eye(3)) / 2
        axis = np.sqrt(np.maximum(np.diag(M), 0))
        axis = axis / (np.linalg.norm(axis) + 1e-12)
        return axis * theta
    return v / np.linalg.norm(v) * theta


def triangulate_nview(
    Rs: np.ndarray, ts: np.ndarray, bs: np.ndarray
) -> Tuple[np.ndarray, float]:
    """Multi-view DLT triangulation of one track (host, tiny). Returns
    (point, max pairwise ray angle in deg)."""
    A_rows, c_rows = [], []
    for R, t, b in zip(Rs, ts, bs):
        e = (
            np.array([0.0, 0, 1.0])
            if abs(b[2]) < 0.9
            else np.array([1.0, 0, 0])
        )
        u = _cross(b, e)
        u /= np.linalg.norm(u) + 1e-12
        v = _cross(b, u)
        A_rows += [u @ R, v @ R]
        c_rows += [-u @ t, -v @ t]
    A = np.stack(A_rows)
    c = np.asarray(c_rows)
    X, *_ = np.linalg.lstsq(A, c, rcond=None)
    # parallax: max angle between viewing rays (world frame)
    dirs = []
    for R, t in zip(Rs, ts):
        center = -R.T @ t
        d = X - center
        dirs.append(d / (np.linalg.norm(d) + 1e-12))
    max_ang = 0.0
    for i in range(len(dirs)):
        for j in range(i + 1, len(dirs)):
            ang = np.degrees(
                np.arccos(np.clip(dirs[i] @ dirs[j], -1, 1))
            )
            max_ang = max(max_ang, ang)
    return X, max_ang


def _pad_pow2(X: np.ndarray, bb: np.ndarray, device, min_cap: int = 32):
    """Pad (points, bearings) to a power-of-two bucket with a validity
    mask, on ``device``: the bucket is the range the RANSAC draws index."""
    n = len(X)
    cap = max(min_cap, 1 << max(n - 1, 1).bit_length())
    Xp = np.zeros((cap, 3), np.float32)
    Xp[:n] = X
    bp = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (cap, 1))
    bp[:n] = bb
    valid = np.arange(cap) < n
    return (torch.as_tensor(Xp, device=device), torch.as_tensor(bp, device=device),
            torch.as_tensor(valid, device=device), n)


def _reproj_ok(pose: np.ndarray, X: np.ndarray, b: np.ndarray, thr: float):
    R = _R_of(pose[:3])
    p = R @ X + pose[3:]
    n = np.linalg.norm(p)
    if n < 1e-9:
        return False
    p = p / n
    return (np.linalg.norm(_cross(p, b)) < thr) and (p @ b > 0)


def incremental_reconstruct(
    bearings: List[np.ndarray],  # per image [K, 3] unit bearings
    tracks: List[Dict[int, int]],  # track -> {image: feature}
    pair_inliers: Dict[Tuple[int, int], int],  # match counts per pair
    cfg: ReconstructConfig = ReconstructConfig(),
    seed: int = 0,
    snapshot=None,  # callable(poses, points) after each registration —
    # feeds the live reconstruction viewer (reference
    # app/point_cloud_visualizer.py:195-224 live view)
    gps_positions: Dict[int, np.ndarray] = None,  # image -> [3]
    # topocentric meters; used when cfg.bundle_use_gps
    device="cuda",
) -> Reconstruction:
    """Retry wrapper: the incremental build is chaotic in the init pair
    on marginal geometry (measured r2/r3) — attempt from successive viable
    init pairs, score each attempt by (cameras registered, then LOWER
    median reprojection residual — a warped self-consistent minimum still
    carries ~2x the residual of the true one on the r3 spiral A/Bs), and
    stop early only when an attempt is both complete AND tight."""
    n_with_obs = sum(
        1 for img in range(len(bearings))
        if any(img in tr for tr in tracks)
    )
    tot_obs = sum(len(tr) for tr in tracks)
    best = None
    best_key = None
    attempts = 0
    for k in range(max(cfg.init_retries, 1)):
        rec = _reconstruct_attempt(
            bearings, tracks, pair_inliers, cfg, seed + k, snapshot,
            gps_positions, init_skip=k, device=device,
        )
        attempts = k + 1
        med_res = _median_residual(rec, bearings, tracks)
        rec.report["median_residual"] = med_res
        degen = _degenerate_geometry(rec)
        rec.report["degenerate"] = degen
        # observation retention: the consensus-size criterion. A warped
        # self-consistent minimum survives its bundles by PRUNING the
        # observations it cannot fit (measured on the 12-ring scene, r5:
        # true minimum retains 95.8% of track observations at med_res
        # 2.1e-4; the bent one only 80.1% at 7.9e-4 — and the bent one
        # passed every older gate: complete, non-degenerate, residual
        # under the early-stop bar). More retained observations at the
        # same outlier threshold = higher inlier consensus = the better
        # model, exactly as in RANSAC scoring.
        n_obs = sum(
            sum(1 for img in tracks[t] if img in rec.poses)
            for t in rec.points
        )
        retention = n_obs / max(tot_obs, 1)
        rec.report["obs_retention"] = retention
        # a collapsed (pure-rotation-like) solution is SELF-CONSISTENT —
        # every camera at one center, points pushed toward infinity,
        # residuals small (r4 200-image spiral: center spread 0.5% of
        # scene depth, 200/200 "registered") — so completeness + residual
        # alone cannot reject it; the geometry test must outrank both,
        # then consensus size, then residual
        key_k = (not degen, len(rec.poses), n_obs, -med_res)
        if best is None or key_k > best_key:
            best, best_key = rec, key_k
        if (not degen
                and len(rec.poses) >= 0.9 * max(n_with_obs, 1)
                and med_res <= 0.2 * cfg.outlier_threshold
                and retention >= cfg.min_obs_retention):
            break
    best.report["init_attempts"] = attempts
    return best


def _degenerate_geometry(rec: Reconstruction,
                         spread_frac: float = 0.02) -> bool:
    """Pure-rotation collapse test: mean camera-center spread below
    ``spread_frac`` of the median point depth means the 'multi-view'
    solution is effectively a single-center panorama (small-baseline
    captures can fall into this BA minimum; the r4 200-image spiral
    measured spread/depth ~ 0.005 collapsed vs ~ 0.5 healthy)."""
    if len(rec.poses) < 3 or not rec.points:
        return False
    C = np.stack(
        [-_R_of(p[:3]).T @ p[3:] for p in rec.poses.values()]
    )
    spread = float(np.linalg.norm(C - C.mean(0), axis=1).mean())
    P = np.stack(list(rec.points.values()))
    depth = float(np.median(np.linalg.norm(P - C.mean(0), axis=1)))
    return spread < spread_frac * max(depth, 1e-12)


def _median_residual(rec: Reconstruction, bearings, tracks) -> float:
    """Median angular reprojection residual over all observations of the
    reconstruction (host; the attempt-quality signal)."""
    rs = []
    for tid, X in rec.points.items():
        for img, feat in tracks[tid].items():
            pose = rec.poses.get(img)
            if pose is None:
                continue
            R = _R_of(pose[:3])
            pc = R @ X + pose[3:]
            n = np.linalg.norm(pc)
            if n < 1e-9:
                continue
            rs.append(np.linalg.norm(_cross(pc / n,
                                              bearings[img][feat])))
    return float(np.median(rs)) if rs else float("inf")


def _reconstruct_attempt(
    bearings: List[np.ndarray],
    tracks: List[Dict[int, int]],
    pair_inliers: Dict[Tuple[int, int], int],
    cfg: ReconstructConfig,
    seed: int,
    snapshot,
    gps_positions,
    init_skip: int = 0,
    device="cuda",
) -> Reconstruction:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_images = len(bearings)
    obs_of_image: List[List[Tuple[int, int]]] = [
        [] for _ in range(n_images)
    ]  # image -> [(track, feature)]
    for tid, tr in enumerate(tracks):
        for img, feat in tr.items():
            obs_of_image[img].append((tid, feat))

    report = {"steps": []}

    # ---- init pair: most inliers among candidates, checked for parallax
    def common_tracks(i, j):
        out = []
        for tid, tr in enumerate(tracks):
            if i in tr and j in tr:
                out.append((tid, tr[i], tr[j]))
        return out

    # score ALL leading candidates and open with the best, not the first
    # viable one: the whole incremental build is chaotic in the init pair
    # (measured r2/r3), so the opening two-view geometry gets a large
    # hypothesis budget and a real score. The candidate pool mixes the
    # top pairs by inlier count with the top WIDE-BASELINE pairs (low
    # neighbor-set Jaccard in the match graph — loop closures / revisit
    # pairs): sequential captures put all the match mass on tiny-baseline
    # neighbor pairs, and an init there can cascade into the
    # pure-rotation collapse the r4 200-image spiral exposed (all camera
    # centers within 0.5% of the scene depth). Retry attempts alternate
    # narrow / wide so attempt 0 keeps the r3 ring behavior exactly.
    neighbors: Dict[int, set] = {}
    for (i, j) in pair_inliers:
        neighbors.setdefault(i, set()).add(j)
        neighbors.setdefault(j, set()).add(i)

    def jaccard(i, j):
        a, b = neighbors.get(i, set()), neighbors.get(j, set())
        inter = len(a & b)
        union = len(a | b) or 1
        return inter / union

    by_inl = sorted(pair_inliers.items(), key=lambda kv: -kv[1])
    narrow_cands = [ij for ij, _ in by_inl[:10]]
    wide_cands = [
        ij for ij, _ in by_inl
        if ij not in narrow_cands[:10] and jaccard(*ij) <= 0.4
    ][:10]
    viable_narrow = []
    viable_wide = []
    for (i, j) in narrow_cands + wide_cands:
        n_inl = pair_inliers[(i, j)]
        com = common_tracks(i, j)
        if len(com) < cfg.init_min_inliers:
            continue
        b1 = np.stack([bearings[i][f1] for _, f1, _ in com])
        b2 = np.stack([bearings[j][f2] for _, _, f2 in com])
        b1p, b2p, vmask, _ = _pad_pow2(b1, b2, dev)
        res = geo.ransac_essential(
            _draws(gen, 1024, 5), b1p, b2p, vmask,
            threshold=cfg.ransac_threshold,
        )
        if int(res.n_inliers) < cfg.init_min_inliers:
            continue
        R, t, n_good = geo.decompose_essential(
            res.E, b1p, b2p, res.inliers
        )
        # parallax check on triangulated inliers
        X = geo.triangulate(
            torch.eye(3, device=dev), torch.zeros(3, device=dev), R, t,
            torch.as_tensor(b1, device=dev), torch.as_tensor(b2, device=dev),
        ).cpu().numpy()
        R, t = R.cpu().numpy(), t.cpu().numpy()
        inl = res.inliers.cpu().numpy()[:len(com)]
        rays1 = X[inl]
        rays2 = X[inl] - (-(R.T @ t))
        cosang = np.sum(rays1 * rays2, -1) / (
            np.linalg.norm(rays1, axis=-1)
            * np.linalg.norm(rays2, axis=-1)
            + 1e-12
        )
        med_ang = np.degrees(np.arccos(np.clip(np.median(cosang), -1, 1)))
        if med_ang < cfg.min_parallax_deg:
            continue
        # rank by RANSAC inlier count (parallax is a gate, not a weight:
        # weighting by angle picked far low-overlap pairs on the ring
        # scene and regressed it 10x)
        entry = (float(res.n_inliers), (i, j, com, R, t, inl, X))
        if (i, j) in narrow_cands:
            viable_narrow.append(entry)
        else:
            viable_wide.append(entry)
    viable_narrow.sort(key=lambda e: -e[0])
    viable_wide.sort(key=lambda e: -e[0])
    # attempt sequence: best-narrow, best-wide, 2nd-narrow, 2nd-wide, ...
    seq = []
    for a, b in zip(viable_narrow, viable_wide):
        seq += [a, b]
    longer = (viable_narrow if len(viable_narrow) > len(viable_wide)
              else viable_wide)
    seq += longer[min(len(viable_narrow), len(viable_wide)):]
    if init_skip >= len(seq):
        return Reconstruction({}, {}, {"error": "no valid init pair"})

    i0, j0, com, R, t, inl, X = seq[init_skip][1]
    poses: Dict[int, np.ndarray] = {
        i0: np.zeros(6, np.float32),
        j0: np.concatenate([_rvec_from_R(R), t]).astype(np.float32),
    }
    points: Dict[int, np.ndarray] = {}
    for k_c, (tid, f1, f2) in enumerate(com):
        if inl[k_c] and X[k_c] @ bearings[i0][f1] > 0:
            points[tid] = X[k_c].astype(np.float32)
    report["steps"].append(
        {"init_pair": (i0, j0), "init_points": len(points)}
    )

    def run_bundle(local_img=None, max_iters=None, loss_scale_mult=1.0,
                   filter_outliers=True):
        """Global BA, or (with ``local_img``) windowed local BA: the new
        camera + its ``local_bundle_radius`` most covisible registered
        neighbours move; other cameras observing the window's points are
        included FIXED as boundary constraints."""
        nonlocal poses, points
        use_gps = (
            local_img is None and cfg.bundle_use_gps and gps_positions
            and sum(im in gps_positions for im in poses) >= 3
        )
        if use_gps:
            # align the model into the GPS frame first (OpenSfM aligns per
            # bundle under align_method auto), so the soft center priors
            # refine rather than fight the reconstruction
            rec_tmp, _ = align_reconstruction_to_gps(
                Reconstruction(dict(poses), dict(points), {}),
                gps_positions,
            )
            poses = rec_tmp.poses
            points = rec_tmp.points
        if local_img is None:
            img_list = sorted(poses)
            pt_list = sorted(points)
            fixed = None
        else:
            covis: Dict[int, int] = {}
            local_tids = [
                tid for tid, _ in obs_of_image[local_img] if tid in points
            ]
            for tid in local_tids:
                for im in tracks[tid]:
                    if im in poses and im != local_img:
                        covis[im] = covis.get(im, 0) + 1
            movable = {local_img} | set(
                sorted(covis, key=covis.get, reverse=True)
                [: cfg.local_bundle_radius]
            )
            pt_set = set()
            for im in movable:
                for tid, _ in obs_of_image[im]:
                    if tid in points:
                        pt_set.add(tid)
            pt_list = sorted(pt_set)
            img_set = set()
            for tid in pt_list:
                for im in tracks[tid]:
                    if im in poses:
                        img_set.add(im)
            img_list = sorted(img_set)
            fixed = np.array(
                [im not in movable for im in img_list], bool
            )
        img_of = {im: a for a, im in enumerate(img_list)}
        pt_of = {p: a for a, p in enumerate(pt_list)}
        ci, pi, bs = [], [], []
        for tid in pt_list:
            for img, feat in tracks[tid].items():
                if img in img_of:
                    ci.append(img_of[img])
                    pi.append(pt_of[tid])
                    bs.append(bearings[img][feat])
        if not ci:
            return
        # the JAX package's buckets, so both solve problems of one layout:
        # padded edges are invalid (weight 0)
        E = len(ci)
        Epad = 1 << (E - 1).bit_length()
        pad = Epad - E
        ci = np.asarray(ci + [0] * pad, np.int32)
        pi = np.asarray(pi + [0] * pad, np.int32)
        bs = np.concatenate(
            [np.stack(bs), np.tile([[0, 0, 1.0]], (pad, 1))]
        ).astype(np.float32)
        valid = np.arange(Epad) < E
        # padded cams are frozen no-edge identities; padded points have
        # no edges
        C_real, P_real = len(img_list), len(pt_list)
        Cpad = -(-C_real // 8) * 8
        Ppad = 1 << max(P_real - 1, 1).bit_length()
        problem = ba_mod.build_problem(ci, pi, bs, Cpad, Ppad, valid=valid, device=dev)
        cams = np.zeros((Cpad, 6), np.float32)
        cams[:C_real] = np.stack([poses[im] for im in img_list])
        pts = np.zeros((Ppad, 3), np.float32)
        pts[:P_real] = np.stack([points[p] for p in pt_list])
        cams = torch.as_tensor(cams, device=dev)
        pts = torch.as_tensor(pts, device=dev)
        if fixed is not None:
            fixed = np.concatenate(
                [fixed, np.ones(Cpad - C_real, bool)])
        elif Cpad != C_real:
            fixed = np.concatenate(
                [np.zeros(C_real, bool), np.ones(Cpad - C_real, bool)])
        is_local = local_img is not None
        cam_pos_priors = None
        if use_gps:
            w_gps = 1.0 / max(cfg.gps_sd_m, 1e-3) ** 2
            gpos = np.zeros((Cpad, 3), np.float32)
            gw = np.zeros((Cpad,), np.float32)
            for a, im in enumerate(img_list):
                if im in gps_positions:
                    gpos[a] = np.asarray(gps_positions[im], np.float32)
                    gw[a] = w_gps
            cam_pos_priors = (torch.as_tensor(gpos, device=dev),
                              torch.as_tensor(gw, device=dev))
        cams, pts, info = ba_mod.bundle_adjust(
            cams, pts, problem,
            ba_mod.BAConfig(
                max_iterations=(
                    max_iters if max_iters is not None
                    else cfg.local_bundle_max_iterations
                    if is_local else cfg.bundle_max_iterations
                ),
                loss_scale=ba_mod.BAConfig.loss_scale * loss_scale_mult,
                # gauge: global BA pins the first camera (unless GPS priors
                # fix the frame); a local window is anchored by its fixed
                # boundary cameras (or falls back to pinning)
                fix_first_camera=(
                    not use_gps
                    and (not is_local or fixed is None
                         or not fixed[:C_real].any())
                ),
            ),
            fixed_cams=None if fixed is None else torch.as_tensor(fixed, device=dev),
            cam_pos_priors=cam_pos_priors,
        )
        cams = cams.cpu().numpy()
        pts = pts.cpu().numpy()
        for a, im in enumerate(img_list):
            poses[im] = cams[a]
        for a, p in enumerate(pt_list):
            points[p] = pts[a]
        if is_local:
            report["steps"].append(
                {"local_bundle": local_img, "window": len(img_list),
                 "cost": float(info["final_cost"])}
            )
            return
        # outlier filtering (config.yaml bundle_outlier_* analog)
        removed = 0
        if not filter_outliers:
            report["steps"].append(
                {"bundle": len(img_list), "removed": 0,
                 "cost": float(info["final_cost"]),
                 "loss_scale_mult": loss_scale_mult}
            )
            return
        for tid in list(points.keys()):
            oks = [
                _reproj_ok(
                    poses[img], points[tid], bearings[img][feat],
                    cfg.outlier_threshold,
                )
                for img, feat in tracks[tid].items()
                if img in poses
            ]
            if sum(oks) < 2:
                del points[tid]
                removed += 1
        report["steps"].append(
            {"bundle": len(img_list), "removed": removed,
             "cost": float(info["final_cost"])}
        )

    run_bundle()

    # ---- incremental registration loop
    since_bundle = 0
    deferred = {}  # img -> strike count (tight post-bundle validation)
    deferred_until = {}  # img -> n_poses before it may try again
    while True:
        # next image: most triangulated observations
        cand_scores = {}
        for img in range(n_images):
            if img in poses:
                continue
            if deferred_until.get(img, 0) > len(poses):
                continue
            n_seen = sum(
                1 for tid, _ in obs_of_image[img] if tid in points
            )
            if n_seen >= cfg.resection_min_inliers:
                cand_scores[img] = n_seen
        if not cand_scores:
            break
        img = max(cand_scores, key=cand_scores.get)
        obs = [
            (tid, feat)
            for tid, feat in obs_of_image[img]
            if tid in points
        ]
        X = np.stack([points[tid] for tid, _ in obs])
        bb = np.stack([bearings[img][feat] for _, feat in obs])
        # tight-first resection: the tight gate protects the bundle
        # minimum; the loose gate (resection_threshold_mult) is only a
        # fallback so marginal images can still register, and THOSE are
        # tight-validated after their local bundle (below)
        Xp, bp, vmask, _ = _pad_pow2(X, bb, dev)
        R_est, t_est, inliers, n_inl = geo.ransac_pnp(
            _draws(gen, 128, 6), Xp, bp, vmask,
            threshold=cfg.outlier_threshold,
        )
        used_loose = False
        if int(n_inl) < cfg.resection_min_inliers:
            thr_res = cfg.outlier_threshold * cfg.resection_threshold_mult
            R_est, t_est, inliers, n_inl = geo.ransac_pnp(
                _draws(gen, 128, 6), Xp, bp, vmask, threshold=thr_res,
            )
            used_loose = True
        if int(n_inl) < cfg.resection_min_inliers:
            # cannot register this one reliably; drop it from candidates
            obs_of_image[img] = []
            continue
        poses[img] = np.concatenate(
            [_rvec_from_R(R_est.cpu().numpy()), t_est.cpu().numpy()]
        ).astype(np.float32)
        report["steps"].append(
            {"resection": img, "inliers": int(n_inl), "of": len(obs),
             "loose": used_loose}
        )

        # triangulate new tracks now observable from >= 2 registered views
        n_new = 0
        new_tids = []
        for tid, feat in obs_of_image[img]:
            if tid in points:
                continue
            regs = [
                (im, f) for im, f in tracks[tid].items() if im in poses
            ]
            if len(regs) < 2:
                continue
            Rs = [
                _R_of(poses[im][:3])
                for im, _ in regs
            ]
            ts = [poses[im][3:] for im, _ in regs]
            bs = [bearings[im][f] for im, f in regs]
            Xp, ang = triangulate_nview(Rs, ts, bs)
            if ang < cfg.triangulation_min_angle_deg:
                continue
            if all(
                _reproj_ok(poses[im], Xp, bearings[im][f],
                           cfg.outlier_threshold * 2)
                for im, f in regs
            ):
                points[tid] = Xp.astype(np.float32)
                new_tids.append(tid)
                n_new += 1
        if cfg.local_bundle_enabled:
            run_bundle(local_img=img)
        # TIGHT post-bundle validation of loose-gate registrations: a
        # pose that still fails the tight threshold after its local
        # bundle would warp everything downstream (measured r3: one such
        # early pose moved the spiral median error 0.034 -> 0.27 of
        # spread). Undo it, roll back its new points, and defer the
        # image — it usually registers cleanly later, against a more
        # mature model.
        ok_tight = len(obs) if not used_loose else sum(
            _reproj_ok(poses[img], points[tid], bearings[img][feat],
                       cfg.outlier_threshold)
            for tid, feat in obs_of_image[img] if tid in points
        )
        if ok_tight < cfg.resection_min_inliers:
            del poses[img]
            for tid in new_tids:
                points.pop(tid, None)
            deferred[img] = deferred.get(img, 0) + 1
            # wait for the model to grow before retrying; three strikes out
            deferred_until[img] = len(poses) + 3
            if deferred[img] >= 3:
                obs_of_image[img] = []
            report["steps"].append(
                {"deferred": img, "tight_inliers": int(ok_tight)}
            )
            continue
        since_bundle += 1
        if since_bundle >= cfg.bundle_interval:
            run_bundle()
            since_bundle = 0
        if snapshot is not None:
            snapshot(dict(poses), dict(points))

    # final polish: retriangulate every track from the converged poses
    # (recovers tracks dropped as outliers mid-way), then a stronger BA.
    # (COLMAP/OpenSfM-style retriangulation pass.)
    def retriangulate(angle_mult=1.0):
        # angle_mult relaxes the reprojection acceptance in step with the
        # annealed robust scale, re-admitting ring-closure tracks that look
        # like outliers while the solution is still warped
        n_re = 0
        for tid, tr in enumerate(tracks):
            regs = [(im, f) for im, f in tr.items() if im in poses]
            if len(regs) < 2:
                continue
            Rs = [
                _R_of(poses[im][:3])
                for im, _ in regs
            ]
            ts = [poses[im][3:] for im, _ in regs]
            bs = [bearings[im][f] for im, f in regs]
            Xp, ang = triangulate_nview(Rs, ts, bs)
            if ang < cfg.triangulation_min_angle_deg:
                continue
            ok = sum(
                _reproj_ok(poses[im], Xp, bearings[im][f],
                           cfg.outlier_threshold * angle_mult)
                for im, f in regs
            )
            if ok >= 2:
                if tid not in points:
                    n_re += 1
                points[tid] = Xp.astype(np.float32)
            elif tid in points:
                del points[tid]
        return n_re

    if cfg.final_anneal and len(cfg.anneal_schedule) > 0:
        # graduated non-convexity: relax the robust scale, re-admit all
        # geometrically consistent tracks, and tighten stage by stage.
        # Outliers are only filtered at the final stage so closure
        # constraints survive the warped intermediate states; a schedule
        # that does not end at 1.0 gets an explicit final 1.0 stage.
        schedule = list(cfg.anneal_schedule)
        if schedule[-1] != 1.0:
            schedule.append(1.0)
        for si_, mult in enumerate(schedule):
            n_re = retriangulate(angle_mult=mult)
            run_bundle(
                max_iters=cfg.final_bundle_max_iterations,
                loss_scale_mult=mult,
                filter_outliers=(si_ == len(schedule) - 1),
            )
            report["steps"].append(
                {"retriangulated": n_re, "anneal_mult": mult}
            )
        n_re = retriangulate()
        run_bundle(max_iters=cfg.final_bundle_max_iterations)
        report["steps"].append({"retriangulated": n_re})
    else:
        for _ in range(2):
            n_re = retriangulate()
            run_bundle(max_iters=cfg.final_bundle_max_iterations)
            report["steps"].append({"retriangulated": n_re})

    # final re-resection polish: cameras registered early (or from a thin
    # inlier set) can be stuck in a poor basin BA cannot leave; re-estimate
    # every pose by PnP against the CONVERGED points and keep whichever of
    # (current, re-estimated) reprojects more observations, then bundle
    n_relocal = 0
    for img in sorted(poses):
        obs = [(tid, feat) for tid, feat in obs_of_image[img]
               if tid in points]
        if len(obs) < cfg.resection_min_inliers:
            continue
        X = np.stack([points[tid] for tid, _ in obs])
        bb = np.stack([bearings[img][feat] for _, feat in obs])
        thr_res = cfg.outlier_threshold * cfg.resection_threshold_mult
        Xp, bp, vmask, _ = _pad_pow2(X, bb, dev)
        R_est, t_est, inliers, n_inl = geo.ransac_pnp(
            _draws(gen, 128, 6), Xp, bp, vmask, threshold=thr_res,
        )
        cand = np.concatenate(
            [_rvec_from_R(R_est.cpu().numpy()), t_est.cpu().numpy()]
        ).astype(np.float32)
        cur_ok = sum(
            _reproj_ok(poses[img], x, b, thr_res)
            for x, b in zip(X, bb)
        )
        if int(n_inl) > cur_ok:
            poses[img] = cand
            n_relocal += 1
    if n_relocal:
        n_re = retriangulate()
        run_bundle(max_iters=cfg.final_bundle_max_iterations)
        report["steps"].append(
            {"relocalized": n_relocal, "retriangulated": n_re}
        )

    report["n_images"] = len(poses)
    report["n_points"] = len(points)
    return Reconstruction(poses, points, report)


def align_reconstruction_to_gps(
    rec: Reconstruction,
    gps_positions: Dict[int, np.ndarray],  # image -> [3] topocentric m
) -> Tuple[Reconstruction, Dict]:
    """Similarity-align the reconstruction to GPS camera positions
    (reference align_method/GPS alignment, config/config.yaml:129-134):
    Umeyama fit of s R c_i + t to the GPS targets over images with both a
    pose and a GPS fix, applied to all poses and points."""
    common = [im for im in rec.poses if im in gps_positions]
    if len(common) < 3:
        return rec, {"aligned": False, "n_gps": len(common)}
    centers = []
    for im in common:
        pose = rec.poses[im]
        R = _R_of(pose[:3])
        centers.append(-R.T @ pose[3:])
    A = np.stack(centers)  # source (reconstruction frame)
    B = np.stack([np.asarray(gps_positions[im], np.float64)
                  for im in common])
    mu_a, mu_b = A.mean(0), B.mean(0)
    Ac, Bc = A - mu_a, B - mu_b
    cov = Bc.T @ Ac / len(common)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R_sim = U @ S @ Vt
    var_a = (Ac ** 2).sum() / len(common)
    s = float(np.trace(np.diag(D) @ S) / max(var_a, 1e-12))
    t_sim = mu_b - s * R_sim @ mu_a
    # apply: world' = s R_sim world + t_sim; cam pose (Rc, tc) maps
    # world->cam, so Rc' = Rc R_sim^T, tc' = tc - Rc' (t_sim) / ... solve:
    # x_cam = Rc x + tc = Rc ((world' - t_sim)/s R_sim^{-T}) ...
    poses_out = {}
    for im, pose in rec.poses.items():
        Rc = _R_of(pose[:3])
        c = -Rc.T @ pose[3:]
        c_new = s * R_sim @ c + t_sim
        Rc_new = Rc @ R_sim.T
        t_new = -Rc_new @ c_new
        poses_out[im] = np.concatenate(
            [_rvec_from_R(Rc_new), t_new]
        ).astype(np.float32)
    points_out = {
        tid: (s * R_sim @ X + t_sim).astype(np.float32)
        for tid, X in rec.points.items()
    }
    resid = float(np.sqrt(np.mean(
        np.sum((s * (A @ R_sim.T) + t_sim - B) ** 2, axis=1)
    )))
    info = {"aligned": True, "scale": s, "rmse_m": resid,
            "n_gps": len(common)}
    rec_out = Reconstruction(poses_out, points_out,
                             {**rec.report, "gps_alignment": info})
    return rec_out, info


def align_reconstruction_orientation(
    rec: Reconstruction,
    prior: str = "horizontal",
) -> Tuple[Reconstruction, Dict]:
    """GPS-free orientation alignment (reference ``align_method:
    orientation_prior`` + ``align_orientation_prior``, config.yaml:130-131).

    ``horizontal``: most capture rigs are held roughly level, so the mean
    camera DOWN direction (+y row of the world->cam rotations) estimates
    world gravity; rotate the world so it maps to -Z-up convention (+Z up,
    gravity = -Z). ``vertical``: cameras point straight down (aerial);
    the mean VIEW direction (+z row) is gravity. ``no_roll``: only remove
    the average roll about each camera's view axis. The result keeps scale
    and centroid — it is a pure world rotation."""
    if not rec.poses:
        return rec, {"aligned": False}
    downs = []
    for pose in rec.poses.values():
        R = _R_of(pose[:3])
        if prior == "vertical":
            downs.append(R[2])  # viewing axis in world coords
        else:
            downs.append(R[1])  # camera down in world coords
    g = np.mean(downs, axis=0)
    ng = np.linalg.norm(g)
    if ng < 1e-8:
        return rec, {"aligned": False}
    g = g / ng
    target = np.array([0.0, 0.0, -1.0])  # gravity points to -Z (Z up)
    if prior == "no_roll":
        # roll removal only: rotate ABOUT the mean viewing axis so the
        # component of "down" perpendicular to it becomes as vertical as
        # possible (the comment's semantics — not a full gravity align)
        views = [
            _R_of(p[:3])[2] for p in rec.poses.values()
        ]
        v_axis = np.mean(views, axis=0)
        nv = np.linalg.norm(v_axis)
        if nv < 1e-8:
            return rec, {"aligned": False}
        v_axis = v_axis / nv
        g_perp = g - (g @ v_axis) * v_axis
        t_perp = target - (target @ v_axis) * v_axis
        if np.linalg.norm(g_perp) < 1e-8 or np.linalg.norm(t_perp) < 1e-8:
            return rec, {"aligned": False}
        g = g_perp / np.linalg.norm(g_perp)
        target = t_perp / np.linalg.norm(t_perp)
    v = _cross(g, target)
    c = float(np.dot(g, target))
    s = np.linalg.norm(v)
    if s < 1e-12:
        if c > 0:
            R_w = np.eye(3)
        else:
            # exactly antiparallel: a 180-deg ROTATION about any axis
            # perpendicular to g (-I would be a reflection, det = -1)
            perp = _cross(g, [1.0, 0.0, 0.0])
            if np.linalg.norm(perp) < 1e-6:
                perp = _cross(g, [0.0, 1.0, 0.0])
            perp = perp / np.linalg.norm(perp)
            R_w = 2.0 * np.outer(perp, perp) - np.eye(3)
    else:
        K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                      [-v[1], v[0], 0]]) / s
        R_w = np.eye(3) + s * K + (1 - c) * (K @ K)
    # recenter-preserving world rotation about the point centroid
    pivot = (np.mean(list(rec.points.values()), axis=0)
             if rec.points else np.zeros(3))
    poses_out = {}
    for im, pose in rec.poses.items():
        Rc = _R_of(pose[:3])
        cpos = -Rc.T @ pose[3:]
        c_new = R_w @ (cpos - pivot) + pivot
        Rc_new = Rc @ R_w.T
        poses_out[im] = np.concatenate(
            [_rvec_from_R(Rc_new), -Rc_new @ c_new]
        ).astype(np.float32)
    points_out = {
        tid: (R_w @ (X - pivot) + pivot).astype(np.float32)
        for tid, X in rec.points.items()
    }
    info = {"aligned": True, "prior": prior,
            "rotation_deg": float(np.degrees(np.arccos(np.clip(c, -1, 1))))}
    return Reconstruction(poses_out, points_out,
                          {**rec.report, "orientation_alignment": info}), \
        info
