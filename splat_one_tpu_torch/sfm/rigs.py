"""Camera rigs (calibration, enforcement, rig-constrained bundle
adjustment): the port of ``splat_one_tpu/sfm/rigs.py``.

Shots captured by a multi-camera body share a per-frame rig instance
pose; each rig camera has one relative pose in the instance frame:

    shot = relative(rig_camera) o instance      (world->camera [rvec, t])

Rigs are handled by block-coordinate alternation: free bundle adjustment
over the shots (``sfm.ba.bundle_adjust``, on the problem's device), then
the relatives calibrated by chordal rotation averaging, then every shot
reset to ``relative o instance``. The SO(3) maps and the fitting are
host numpy in float64, copied from the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------- SO(3) ops


def _rvec_to_R(r: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _R_to_rvec(R: np.ndarray) -> np.ndarray:
    """Log map via quaternion extraction (Shepperd's method) — stable at
    both theta ~ 0 and theta ~ pi, unlike the trace/sin formula."""
    t = np.trace(R)
    cand = np.array([t, R[0, 0], R[1, 1], R[2, 2]])
    i = int(np.argmax(cand))
    if i == 0:
        s = np.sqrt(max(1.0 + t, 1e-12)) * 2
        q = np.array([s / 4, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        a = i - 1  # dominant diagonal axis
        b, c = (a + 1) % 3, (a + 2) % 3
        s = np.sqrt(max(1.0 + R[a, a] - R[b, b] - R[c, c], 1e-12)) * 2
        q = np.zeros(4)
        q[0] = (R[c, b] - R[b, c]) / s
        q[1 + a] = s / 4
        q[1 + b] = (R[b, a] + R[a, b]) / s
        q[1 + c] = (R[c, a] + R[a, c]) / s
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    w, v = q[0], q[1:]
    nv = np.linalg.norm(v)
    if nv < 1e-12:
        return np.zeros(3)
    th = 2 * np.arctan2(nv, w)
    return v / nv * th


def compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pose composition ``a o b`` (apply b, then a) on [rvec, t] 6-vecs:
    R = Ra Rb, t = Ra tb + ta."""
    Ra, Rb = _rvec_to_R(a[:3]), _rvec_to_R(b[:3])
    R = Ra @ Rb
    t = Ra @ b[3:] + a[3:]
    return np.concatenate([_R_to_rvec(R), t])


def invert(a: np.ndarray) -> np.ndarray:
    R = _rvec_to_R(a[:3])
    return np.concatenate([_R_to_rvec(R.T), -R.T @ a[3:]])


def average_poses(poses: Sequence[np.ndarray]) -> np.ndarray:
    """Chordal-mean rotation (SVD projection of the averaged matrix onto
    SO(3)) + mean translation — the standard closed-form rotation average,
    adequate for the small angular spreads of rig calibration."""
    Rs = np.stack([_rvec_to_R(p[:3]) for p in poses])
    M = Rs.mean(axis=0)
    U, _, Vt = np.linalg.svd(M)
    R = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    t = np.stack([p[3:] for p in poses]).mean(axis=0)
    return np.concatenate([_R_to_rvec(R), t])


# ------------------------------------------------------------- rig fitting

# assignments: {instance_id: [(shot_id, rig_camera_id), ...]}
Assignments = Dict[str, List[Tuple[str, str]]]


def calibrate_rigs(
    poses: Dict[str, np.ndarray],
    assignments: Assignments,
    subset_size: int = 15,
    completeness: float = 0.85,
) -> Dict[str, np.ndarray]:
    """Estimate shared rig-camera relative poses from reconstructed shots.

    The instance frame is anchored to the first rig camera id (sorted), so
    its relative is the identity — OpenSfM's convention. Per instance where
    both the anchor and another rig camera are reconstructed, the implied
    relative is ``shot_k o shot_anchor^-1`` (world frame cancels); relatives
    are rotation-averaged over up to ``subset_size`` instances
    (config.yaml:138 ``rig_calibration_subset_size``). Instances missing
    more than ``1 - completeness`` of their shots are skipped
    (:139 ``rig_calibration_completeness``)."""
    rig_cam_ids = sorted({rc for shots in assignments.values()
                          for _, rc in shots})
    if not rig_cam_ids:
        return {}
    anchor = rig_cam_ids[0]
    samples: Dict[str, List[np.ndarray]] = {rc: [] for rc in rig_cam_ids}
    used = 0
    for inst in sorted(assignments):
        shots = assignments[inst]
        have = [(s, rc) for s, rc in shots if s in poses]
        if len(have) < max(2, int(np.ceil(completeness * len(shots)))):
            continue
        by_rc = dict((rc, s) for s, rc in have)
        if anchor not in by_rc:
            continue
        if used >= subset_size:
            break
        used += 1
        inv_anchor = invert(poses[by_rc[anchor]])
        for rc, s in by_rc.items():
            samples[rc].append(compose(poses[s], inv_anchor))
    out = {anchor: np.zeros(6)}
    for rc in rig_cam_ids[1:]:
        if samples[rc]:
            out[rc] = average_poses(samples[rc])
    return out


def fit_instances(
    poses: Dict[str, np.ndarray],
    rig_cameras: Dict[str, np.ndarray],
    assignments: Assignments,
) -> Dict[str, np.ndarray]:
    """Per-instance pose = rotation-average of ``relative^-1 o shot`` over
    the instance's reconstructed shots."""
    out = {}
    for inst, shots in assignments.items():
        implied = [
            compose(invert(rig_cameras[rc]), poses[s])
            for s, rc in shots
            if s in poses and rc in rig_cameras
        ]
        if implied:
            out[inst] = average_poses(implied)
    return out


def enforce_rigs(
    poses: Dict[str, np.ndarray],
    rig_cameras: Dict[str, np.ndarray],
    assignments: Assignments,
) -> Dict[str, np.ndarray]:
    """Project shot poses onto the rig manifold: every assigned shot is
    reset to ``relative o instance`` with the robustly fitted instance."""
    instances = fit_instances(poses, rig_cameras, assignments)
    out = dict(poses)
    for inst, shots in assignments.items():
        if inst not in instances:
            continue
        for s, rc in shots:
            if s in poses and rc in rig_cameras:
                out[s] = compose(rig_cameras[rc], instances[inst])
    return out


def rig_constrained_adjust(
    problem,  # sfm.ba.BAProblem, built on the device the adjustment runs on
    cams: np.ndarray,  # [C, 6] in shot order
    points: np.ndarray,  # [P, 3]
    shot_ids: Sequence[str],  # index -> shot id
    assignments: Assignments,
    rig_cameras: Dict[str, np.ndarray] | None = None,
    cfg=None,
    rounds: int = 3,
):
    """Alternating rig-constrained bundle adjustment on the device of
    ``problem``. Each round: free LM/Schur BA -> (re)calibrate relatives if
    not provided -> enforce the rig manifold. Returns (cams, points,
    rig_cameras, info) with numpy cameras and points."""
    import torch

    from splat_one_tpu_torch.sfm import ba as ba_mod

    cfg = cfg or ba_mod.BAConfig()
    dev = problem.bearings.device
    calibrated = rig_cameras
    info = {}
    for _ in range(rounds):
        cams_t, pts_t, info = ba_mod.bundle_adjust(
            torch.as_tensor(np.asarray(cams, np.float32), device=dev),
            torch.as_tensor(np.asarray(points, np.float32), device=dev), problem, cfg)
        cams = cams_t.cpu().numpy()
        points = pts_t.cpu().numpy()
        poses = {sid: cams[i] for i, sid in enumerate(shot_ids)}
        if rig_cameras is None:
            calibrated = calibrate_rigs(poses, assignments)
        poses = enforce_rigs(poses, calibrated, assignments)
        cams = np.stack([poses[sid] for sid in shot_ids])
    return cams, points, calibrated, info
