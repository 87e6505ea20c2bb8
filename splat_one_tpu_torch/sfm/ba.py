"""Levenberg-Marquardt bundle adjustment: the port of ``splat_one_tpu/sfm/ba.py``.

  - residuals are bearing reprojection errors in each observation's
    tangent plane (camera-model agnostic: pinhole, fisheye and spherical
    shots all reduce to unit bearings);
  - per-edge Jacobians are closed forms of the same residual
    (``_res_jac``: the derivative of the angle-axis rotation as written in
    ``_rodrigues``, epsilon included);
  - the reduced camera system is solved by iterative Schur: block-Jacobi
    preconditioned CG whose matvec is two edge products and two segment
    sums (running sums over the camera- or point-sorted edges and their
    differences at the segment bounds, in f32, as the JAX package sums);
  - soft-L1 IRLS reweighting, LM damping with accept/reject.

``bundle_adjust`` runs a fixed number of LM iterations and of CG
iterations with accept/reject by ``torch.where``: nothing in the loop
reads a value back to the host, so one call queues its whole solve on the
device. The point and camera blocks are inverted in closed form
(``_inv3``, ``_inv6``): batched LU of thousands of 3x3 blocks
(``torch.linalg.inv_ex``) waited on the host several times an iteration
on the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BAConfig:
    max_iterations: int = 20  # LM outer iterations
    cg_iterations: int = 20
    loss: str = "soft_l1"  # or "linear"
    loss_scale: float = 0.006  # radians
    init_lambda: float = 1e-3
    fix_first_camera: bool = True


class BAProblem(NamedTuple):
    """A BA problem on the device. Edges are sorted by cam_idx."""

    cam_idx: torch.Tensor  # [E] int64, sorted ascending
    pt_idx: torch.Tensor  # [E] int64
    bearings: torch.Tensor  # [E, 3] unit observation bearings
    valid: torch.Tensor  # [E] bool
    cam_bounds: torch.Tensor  # [C+1] edge ranges per camera
    pt_perm: torch.Tensor  # [E] permutation sorting edges by point
    pt_sorted: torch.Tensor  # [E] pt_idx[pt_perm]
    pt_bounds: torch.Tensor  # [P+1] ranges in point-sorted order


def build_problem(cam_idx: np.ndarray, pt_idx: np.ndarray, bearings: np.ndarray,
                  n_cams: int, n_points: int, valid: np.ndarray = None,
                  device="cuda") -> BAProblem:
    """Host side: sort the edges by camera, precompute the point-sorted
    permutation and both segment bounds, move them to ``device``."""
    order = np.argsort(cam_idx, kind="stable")
    cam_idx = np.asarray(cam_idx, np.int64)[order]
    pt_idx = np.asarray(pt_idx, np.int64)[order]
    bearings = np.asarray(bearings, np.float32)[order]
    valid = np.ones(len(cam_idx), bool) if valid is None else np.asarray(valid, bool)[order]
    cam_bounds = np.searchsorted(cam_idx, np.arange(n_cams + 1))
    pt_perm = np.argsort(pt_idx, kind="stable")
    pt_sorted = pt_idx[pt_perm]
    pt_bounds = np.searchsorted(pt_sorted, np.arange(n_points + 1))
    return BAProblem(*(torch.as_tensor(x, device=device) for x in (
        cam_idx, pt_idx, bearings, valid, cam_bounds, pt_perm, pt_sorted, pt_bounds)))


def _segsum_sorted(vals: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Segment sums of pre-sorted rows via an f32 running sum and its
    differences at the bounds: vals [E, D] -> [S, D]. The running sums run
    along the last dim of the transposed rows: CUDA scans a contiguous
    innermost dim in parallel, an outer one serially down each column."""
    cs = torch.cumsum(vals.to(torch.float32).T.contiguous(), dim=1)
    cs = torch.cat([torch.zeros((vals.shape[1], 1), dtype=cs.dtype, device=cs.device), cs], 1)
    return (cs[:, bounds[1:]] - cs[:, bounds[:-1]]).T.contiguous()


def _skew(k: torch.Tensor) -> torch.Tensor:
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    z = torch.zeros_like(kx)
    return torch.stack([torch.stack([z, -kz, ky], -1),
                        torch.stack([kz, z, -kx], -1),
                        torch.stack([-ky, kx, z], -1)], -2)


def _rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Angle-axis [..., 3] -> rotation matrix [..., 3, 3], safe at zero."""
    theta2 = torch.sum(rvec * rvec, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-24)
    K = _skew(rvec / theta)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + s * K + (1 - c) * (K @ K)


def _rot_jac(rvec: torch.Tensor, X: torch.Tensor):
    """(R, R X, d(R X)/d rvec [..., 3, 3]) for ``_rodrigues``' formula
    R = I + sin(a) K + (1 - cos a) K^2, a = sqrt(|w|^2 + 1e-24), k = w / a."""
    a = torch.sqrt(torch.sum(rvec * rvec, dim=-1, keepdim=True) + 1e-24)
    k = rvec / a
    K = _skew(k)
    s = torch.sin(a)[..., None]
    c = torch.cos(a)[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = eye + s * K + (1 - c) * (K @ K)
    cx = torch.linalg.cross(k, X)
    dx = torch.linalg.cross(k, cx)
    q = X + s[..., 0] * cx + (1 - c[..., 0]) * dx
    Xs = _skew(X)
    dk = (eye - k[..., :, None] * k[..., None, :]) / a[..., None]  # dk/dw
    inner = -s * Xs + (1 - c) * (-(K @ Xs) - _skew(cx))
    J = (c * cx[..., :, None] * k[..., None, :] + s * dx[..., :, None] * k[..., None, :]
         + inner @ dk)
    return R, q, J


def _helper_axis(bearing: torch.Tensor) -> torch.Tensor:
    """The axis each bearing [..., 3] is crossed with: z where |b_z| < 0.9,
    else x (built on the device: a constant tensor from a Python list is a
    blocking host-to-device copy)."""
    near = torch.abs(bearing[..., 2:3]) < 0.9
    return torch.cat([~near, torch.zeros_like(near), near], -1).to(bearing.dtype)


def _tangent_frame(bearing: torch.Tensor):
    """Orthonormal (u, v) perpendicular to each bearing [..., 3]."""
    u = torch.linalg.cross(bearing, _helper_axis(bearing))
    u = u / torch.sqrt(torch.sum(u * u, dim=-1, keepdim=True) + 1e-24)
    v = torch.linalg.cross(bearing, u)
    return u, v


def _residual(cam: torch.Tensor, point: torch.Tensor, bearing: torch.Tensor):
    """2-D tangent-plane bearing residual [..., 2]; cam = [rvec(3), t(3)]."""
    R = _rodrigues(cam[..., :3])
    p = (R @ point[..., None])[..., 0] + cam[..., 3:]
    p = p / torch.sqrt(torch.sum(p * p, dim=-1, keepdim=True) + 1e-24)
    u, v = _tangent_frame(bearing)
    return torch.stack([torch.sum(u * p, -1), torch.sum(v * p, -1)], -1)


def _res_jac(cams: torch.Tensor, points: torch.Tensor, bearings: torch.Tensor):
    """Per edge: the residual [E, 2] and its Jacobians with respect to the
    camera [E, 2, 6] and the point [E, 2, 3], in closed form."""
    R, _, Jw = _rot_jac(cams[..., :3], points)
    p = (R @ points[..., None])[..., 0] + cams[..., 3:]
    n = torch.sqrt(torch.sum(p * p, dim=-1, keepdim=True) + 1e-24)
    ph = p / n
    u, v = _tangent_frame(bearings)
    Ruv = torch.stack([u, v], -2)  # [E, 2, 3]
    r = torch.sum(Ruv * ph[..., None, :], -1)
    drdp = (Ruv - r[..., :, None] * ph[..., None, :]) / n[..., None]
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (3, 3))
    Jc = drdp @ torch.cat([Jw, eye], -1)
    Jp = drdp @ R
    return r, Jc, Jp


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 3, 3] matrices as adjugate / determinant: the
    cofactor rows r1 x r2, r2 x r0, r0 x r1 are the inverse's columns."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = torch.linalg.cross(r1, r2)
    c1 = torch.linalg.cross(r2, r0)
    c2 = torch.linalg.cross(r0, r1)
    det = torch.sum(r0 * c0, -1)
    return torch.stack([c0, c1, c2], -1) / det[..., None, None]


def _inv6(M: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 6, 6] matrices by 3x3 blocks [[A, B], [C, D]] and
    the Schur complement S = D - C A^-1 B (A and S invertible: here
    damped normal blocks)."""
    A, B = M[..., :3, :3], M[..., :3, 3:]
    C, D = M[..., 3:, :3], M[..., 3:, 3:]
    Ai = _inv3(A)
    AiB = Ai @ B
    CAi = C @ Ai
    Si = _inv3(D - C @ AiB)
    top = torch.cat([Ai + AiB @ Si @ CAi, -AiB @ Si], -1)
    return torch.cat([top, torch.cat([-Si @ CAi, Si], -1)], -2)


def _robust_weights(r: torch.Tensor, cfg: BAConfig) -> torch.Tensor:
    """IRLS sqrt-weights of the robust kernel (soft-L1)."""
    if cfg.loss == "linear":
        return torch.ones(r.shape[0], dtype=r.dtype, device=r.device)
    s2 = torch.sum(r * r, dim=-1) / (cfg.loss_scale ** 2)
    return (1.0 + s2) ** -0.25  # sqrt of rho'(s) for soft-L1


def _cost(r, w, valid):
    per = torch.sum((r * w[:, None]) ** 2, -1)
    return torch.sum(torch.where(valid, per, torch.zeros_like(per)))


def camera_center(cam: torch.Tensor) -> torch.Tensor:
    """World-space centre [..., 3] of (rvec, t) world->camera poses [..., 6]."""
    R = _rodrigues(cam[..., :3])
    return -(R.transpose(-1, -2) @ cam[..., 3:, None])[..., 0]


def _center_jac(cams: torch.Tensor):
    """(centres [C, 3], d centre / d cam [C, 3, 6]): centre = -R^T t and
    R^T = R(-w), so d centre / dw = d(R(-w) t)/d(-w)."""
    Rt, q, Jw = _rot_jac(-cams[..., :3], cams[..., 3:])
    return -q, torch.cat([Jw, -Rt], -1)


def bundle_adjust(
    cams: torch.Tensor,  # [C, 6] (rvec, t) world->camera
    points: torch.Tensor,  # [P, 3]
    problem: BAProblem,
    cfg: BAConfig = BAConfig(),
    fixed_cams: torch.Tensor = None,  # [C] bool: frozen cameras (their
    # observations still constrain points: the local bundle's boundary)
    point_priors=None,  # ([P, 3] positions, [P] weights; 0 = no prior):
    # ground-control-point pulls on selected track points
    cam_pos_priors=None,  # ([C, 3] centres, [C] weights; 0 = no prior):
    # GPS camera-centre priors, weights ~ 1/sd^2
):
    """Run LM; returns (cams, points, info) with info's costs and lambda
    as 0-d tensors on the device."""
    dev = cams.device
    C, P, E = cams.shape[0], points.shape[0], problem.cam_idx.shape[0]
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    fix_mask = torch.ones((C, 1), device=dev)
    if cfg.fix_first_camera:
        fix_mask[0] = 0.0
    if fixed_cams is not None:
        fix_mask = fix_mask * (1.0 - fixed_cams.to(torch.float32)[:, None])
    pp_pos, pp_w = (None, None) if point_priors is None else point_priors
    cp_pos, cp_w = (None, None) if cam_pos_priors is None else cam_pos_priors
    ones_e = torch.ones(E, device=dev)

    def prior_cost(cams, points):
        c = torch.zeros((), device=dev)
        if point_priors is not None:
            c = c + torch.sum(pp_w[:, None] * (points - pp_pos) ** 2)
        if cam_pos_priors is not None:
            c = c + torch.sum(cp_w[:, None] * (camera_center(cams) - cp_pos) ** 2)
        return c

    def linearize(cams, points):
        r, Jc, Jp = _res_jac(cams[problem.cam_idx], points[problem.pt_idx], problem.bearings)
        w = _robust_weights(r, cfg) * problem.valid
        return r * w[:, None], Jc * w[:, None, None], Jp * w[:, None, None]

    def residuals(cams, points):
        r = _residual(cams[problem.cam_idx], points[problem.pt_idx], problem.bearings)
        return r * (_robust_weights(r, cfg) * problem.valid)[:, None]

    def seg_cam(x):  # [E, D] edge rows (cam-sorted already) -> [C, D]
        return _segsum_sorted(x, problem.cam_bounds)

    def seg_pt(x):  # [E, D] -> [P, D] via the point permutation
        return _segsum_sorted(x[problem.pt_perm], problem.pt_bounds)

    def lm_step(cams, points, lam, cost):
        r, Jc, Jp = linearize(cams, points)
        U = seg_cam(torch.einsum("eri,erj->eij", Jc, Jc).reshape(E, 36)).reshape(C, 6, 6)
        V = seg_pt(torch.einsum("eri,erj->eij", Jp, Jp).reshape(E, 9)).reshape(P, 3, 3)
        gc = seg_cam(torch.einsum("eri,er->ei", Jc, r))
        gp = seg_pt(torch.einsum("eri,er->ei", Jp, r))
        if point_priors is not None:
            # GCP pulls: residual sqrt(w)(p - g) with J = sqrt(w) I
            V = V + pp_w[:, None, None] * eye3
            gp = gp + pp_w[:, None] * (points - pp_pos)
        if cam_pos_priors is not None:
            # GPS centre priors: residual sqrt(w)(centre(cam) - gps)
            centers, Jcen = _center_jac(cams)
            sw = torch.sqrt(cp_w)
            rc = sw[:, None] * (centers - cp_pos)
            Jcp = sw[:, None, None] * Jcen
            U = U + torch.einsum("cri,crj->cij", Jcp, Jcp)
            gc = gc + torch.einsum("cri,cr->ci", Jcp, rc)
        U = U + lam * eye6
        V = V + lam * eye3
        V_inv = _inv3(V)
        U_inv = _inv6(U)  # block-Jacobi preconditioner
        W_e = torch.einsum("eri,erj->eij", Jc, Jp)  # [E, 6, 3]

        def S_matvec(x):  # x [C, 6]
            wx = torch.einsum("eij,ei->ej", W_e, x[problem.cam_idx])
            y = torch.einsum("pij,pj->pi", V_inv, seg_pt(wx))
            wy = torch.einsum("eij,ej->ei", W_e, y[problem.pt_idx])
            return (torch.einsum("cij,cj->ci", U, x) - seg_cam(wy)) * fix_mask

        # rhs: b = -gc + W V^-1 gp
        y0 = torch.einsum("pij,pj->pi", V_inv, gp)
        b = (-gc + seg_cam(torch.einsum("eij,ej->ei", W_e, y0[problem.pt_idx]))) * fix_mask

        def precond(x):
            return torch.einsum("cij,cj->ci", U_inv, x) * fix_mask

        # preconditioned CG on the Schur system, a fixed iteration count
        x = torch.zeros_like(b)
        rr = b
        p = precond(b)
        rz = torch.sum(b * p)
        for _ in range(cfg.cg_iterations):
            Ap = S_matvec(p)
            denom = torch.sum(p * Ap)
            alpha = rz / torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
            p = z + beta * p
            rz = rz_new
        dx_c = x
        # back-substitute points: dx_p = -V^-1 (gp + W^T dx_c)
        wdx = torch.einsum("eij,ei->ej", W_e, dx_c[problem.cam_idx])
        dx_p = -torch.einsum("pij,pj->pi", V_inv, gp + seg_pt(wdx))

        cams_new = cams + dx_c * fix_mask
        points_new = points + dx_p
        cost_new = (_cost(residuals(cams_new, points_new), ones_e, problem.valid)
                    + prior_cost(cams_new, points_new))
        accept = cost_new < cost
        cams = torch.where(accept, cams_new, cams)
        points = torch.where(accept, points_new, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        cost = torch.where(accept, cost_new, cost)
        return cams, points, lam, cost

    cost0 = _cost(residuals(cams, points), ones_e, problem.valid) + prior_cost(cams, points)
    lam = torch.full((), cfg.init_lambda, device=dev)
    cost = cost0
    for _ in range(cfg.max_iterations):
        cams, points, lam, cost = lm_step(cams, points, lam, cost)
    return cams, points, {"initial_cost": cost0, "final_cost": cost, "lambda": lam}
