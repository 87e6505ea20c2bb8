"""Two-view geometry: essential matrix, RANSAC, pose recovery, triangulation,
resection. The port of ``splat_one_tpu/sfm/geometry.py``.

Solvers work on bearing vectors (camera-model agnostic: pinhole, fisheye
and spherical alike), and RANSAC evaluates all hypotheses at once: one
batched solve and one [hyp, n] angular-error tensor, no data-dependent
loop. ``ransac_essential`` also batches over pairs (a leading dim).

The RANSAC functions take their draws as an argument: ``u [..., n_hyp,
n_sample]`` integers in [0, 2^30); sample ``s`` of hypothesis ``h`` is
row ``u % n_valid`` of the valid prefix (every caller pads with a suffix
mask). The 5-point solver is split into its nullspace basis
(``five_point_basis``: any orthonormal basis of a 4-D space, which
LAPACK and cuSOLVER choose differently) and the Gauss-Newton search from
a given basis (``essential_5pt_from_basis``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from splat_one_tpu_torch.sfm import ba as ba_mod


def _project_essential(E: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix [..., 3, 3]: singular values (s, s, 0)."""
    u, s, vt = torch.linalg.svd(E)
    m = (s[..., 0] + s[..., 1]) / 2.0
    s_fix = torch.stack([m, m, torch.zeros_like(m)], -1)
    return (u * s_fix[..., None, :]) @ vt


def _epipolar_rows(b1, b2):
    """Rows kron(b2, b1) [..., n, 9] so that b2^T E b1 = row . vec(E)."""
    return (b2[..., :, None] * b1[..., None, :]).reshape(b1.shape[:-1] + (9,))


def _essential_8pt(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Essential matrix from >= 8 bearing correspondences [..., n, 3] by
    the linear 8-point algorithm + rank-2 projection: [..., 3, 3]."""
    A = _epipolar_rows(b1, b2)
    vt = torch.linalg.svd(A, full_matrices=True).Vh
    return _project_essential(vt[..., -1, :].reshape(b1.shape[:-2] + (3, 3)))


def five_point_basis(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The 4-D nullspace [..., 4, 9] of 5 correspondences' epipolar rows."""
    vt = torch.linalg.svd(_epipolar_rows(b1, b2), full_matrices=True).Vh
    return vt[..., 5:9, :]


def _demazure_coeffs(B: torch.Tensor) -> torch.Tensor:
    """The Demazure constraints of E(a) = sum_p a_p B_p as cubic forms in
    ``a``: C [..., 4, 4, 4, 10] with r_c(a) = sum_pqr C_pqrc a_p a_q a_r,
    r = (2 E E^T E - tr(E E^T) E as 9 values, det E). ``B`` [..., 4, 3, 3]."""
    T = torch.einsum("...pjl,...qml,...rmk->...pqrjk", B, B, B)  # B_p B_q^T B_r
    G = torch.einsum("...pjk,...qjk->...pq", B, B)  # tr(B_p B_q^T)
    M = 2.0 * T - G[..., :, :, None, None, None] * B[..., None, None, :, :, :]
    eps = torch.zeros(3, 3, 3, dtype=B.dtype, device=B.device)
    for i, j, k in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        eps[i, j, k], eps[i, k, j] = 1.0, -1.0
    det = torch.einsum("ijk,...pi,...qj,...rk->...pqr", eps, B[..., 0, :], B[..., 1, :],
                       B[..., 2, :])
    return torch.cat([M.reshape(M.shape[:-2] + (9,)), det[..., None]], -1)


def _sphere_tangent(a: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis [..., 4, 3] of the tangent space of S^3 at unit
    ``a`` [..., 4]: columns 2-4 of the Householder reflection that maps
    ``a`` onto the first axis (the GN step does not depend on which
    orthonormal basis of the complement it is given)."""
    sgn = torch.where(a[..., 0] >= 0, 1.0, -1.0)
    v = a.clone()
    v[..., 0] = v[..., 0] + sgn
    eye = torch.eye(4, dtype=a.dtype, device=a.device)
    H = eye - 2.0 * v[..., :, None] * v[..., None, :] / torch.sum(v * v, -1)[..., None, None]
    return H[..., :, 1:]


def essential_5pt_from_basis(basis: torch.Tensor, n_starts: int = 16) -> torch.Tensor:
    """Candidates [..., n_starts, 3, 3] of the 5-point problem with the
    nullspace ``basis`` [..., 4, 9]: multistart Riemannian Gauss-Newton
    (20 steps) on the Demazure constraints over the unit 3-sphere of
    coefficients from fixed quasi-uniform starts; every start is
    projected onto the essential manifold. The constraints and their
    Jacobian are evaluated from their cubic coefficients
    (``_demazure_coeffs``): two batched products per step."""
    lead = basis.shape[:-2]
    B = basis.reshape(lead + (4, 3, 3))
    C = _demazure_coeffs(B)  # [..., 4, 4, 4, 10]
    C64 = C.reshape(lead + (64, 10))
    # dr/da_s = sum_xy (C_sxy + C_xsy + C_xys) a_x a_y, as [..., 16 (xy), 40 (s, c)]
    D = C + C.movedim(-3, -4) + C.movedim(-2, -4)
    D16 = D.movedim(-4, -2).reshape(lead + (16, 40))
    i = torch.arange(n_starts, dtype=basis.dtype, device=basis.device)[:, None]
    freq = torch.tensor([[1.0, 2.1, 3.3, 4.7]], dtype=basis.dtype, device=basis.device)
    seeds = torch.sin((i + 1.0) * freq * 1.6180339)
    a = seeds / torch.linalg.norm(seeds, dim=-1, keepdim=True)
    a = a.expand(lead + (n_starts, 4))
    eye3 = torch.eye(3, dtype=basis.dtype, device=basis.device)
    for _ in range(20):
        aa = (a[..., :, None] * a[..., None, :]).reshape(lead + (n_starts, 16))
        aaa = (aa[..., :, None] * a[..., None, :]).reshape(lead + (n_starts, 64))
        r = aaa @ C64  # [..., S, 10]
        J = (aa @ D16).reshape(lead + (n_starts, 4, 10)).transpose(-1, -2)
        T = _sphere_tangent(a)
        Jt = J @ T  # [..., S, 10, 3]
        JtT = Jt.transpose(-1, -2)
        step = torch.linalg.solve_ex(JtT @ Jt + 1e-10 * eye3, JtT @ r[..., None])[0]
        a = a - (T @ step)[..., 0]
        a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=1e-12)
    return _project_essential(torch.einsum("...si,...ijk->...sjk", a, B))


def _essential_5pt_candidates(b1: torch.Tensor, b2: torch.Tensor, n_starts: int = 16):
    """Minimal 5-point solver: [..., n_starts, 3, 3] candidates (RANSAC
    scores them all, as it would score Nister's <= 10 roots)."""
    return essential_5pt_from_basis(five_point_basis(b1, b2), n_starts)


def _epipolar_angle_error(E: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor):
    """Sine of the angle between b2 and the epipolar plane of b1
    (symmetric, OpenSfM-style): E [..., H, 3, 3] (H hypotheses, or none),
    b [..., n, 3] -> [..., H, n]. Each side's normals for all hypotheses
    come from one product of the bearings with the stacked rows of E, and
    stay in that [..., n, H, 3] layout until the last step."""
    if E.ndim == b1.ndim:  # one E per problem
        return _epipolar_angle_error(E[..., None, :, :], b1, b2)[..., 0, :]
    H = E.shape[-3]
    rows = E.reshape(E.shape[:-3] + (H * 3, 3))
    cols = E.transpose(-1, -2).reshape(E.shape[:-3] + (H * 3, 3))
    # epipolar plane normals in cam2 (E b1) and in cam1 (E^T b2)
    Eb1 = (b1 @ rows.transpose(-1, -2)).unflatten(-1, (H, 3))
    Etb2 = (b2 @ cols.transpose(-1, -2)).unflatten(-1, (H, 3))
    num = torch.abs(torch.sum(b2[..., :, None, :] * Eb1, dim=-1))
    d1 = num / torch.clamp(torch.linalg.norm(Eb1, dim=-1), min=1e-12)
    d2 = num / torch.clamp(torch.linalg.norm(Etb2, dim=-1), min=1e-12)
    return torch.maximum(d1, d2).transpose(-1, -2)


class RansacResult(NamedTuple):
    E: torch.Tensor  # [..., 3, 3]
    inliers: torch.Tensor  # [..., n] bool
    n_inliers: torch.Tensor  # [...]


def _sample(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [B, H, S] of ``x`` [B, n, 3] -> [B, H, S, 3]."""
    bi = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[bi, idx]


def ransac_essential(
    u: torch.Tensor,  # [..., n_hyp, n_sample] draws in [0, 2^30)
    b1: torch.Tensor,  # [..., n, 3] unit bearings in camera 1
    b2: torch.Tensor,  # [..., n, 3]
    valid: torch.Tensor,  # [..., n] bool (a suffix padding mask)
    threshold: float = 0.004,  # sine-angle threshold
    solver: str = "5pt",  # "5pt" (minimal, planar-safe) | "8pt" (linear)
) -> RansacResult:
    """RANSAC over all hypotheses at once (5 or 8 samples each, per
    ``u``'s last dim), then three refits on the inliers (weighted 8-point
    through the 9x9 normal matrix), each kept when it holds at least as
    many inliers. A leading dim of the inputs batches independent
    problems."""
    single = b1.ndim == 2
    if single:
        u, b1, b2, valid = u[None], b1[None], b2[None], valid[None]
    n_valid = torch.clamp(valid.to(torch.int64).sum(-1), min=1)
    idx = u.to(torch.int64) % n_valid[:, None, None]
    s1, s2 = _sample(b1, idx), _sample(b2, idx)
    if solver == "5pt":
        Es = _essential_5pt_candidates(s1, s2)
        Es = Es.reshape(Es.shape[0], -1, 3, 3)
    else:
        Es = _essential_8pt(s1, s2)  # [B, hyp, 3, 3]
    errs = _epipolar_angle_error(Es, b1, b2)  # [B, hyp, n]
    inl = (errs < threshold) & valid[:, None, :]
    scores = inl.sum(-1)
    best = torch.argmax(scores, dim=-1)
    bi = torch.arange(b1.shape[0], device=b1.device)
    E_out, inl_out, best_score = Es[bi, best], inl[bi, best], scores[bi, best]
    rows = _epipolar_rows(b1, b2)
    for _ in range(3):
        A = rows * inl_out.to(b1.dtype)[..., None]
        # null vector via the 9x9 normal matrix (smallest eigenvalue first)
        evecs = torch.linalg.eigh(A.transpose(-1, -2) @ A).eigenvectors
        E_ref = _project_essential(evecs[..., :, 0].reshape(-1, 3, 3))
        inl_ref = (_epipolar_angle_error(E_ref, b1, b2) < threshold) & valid
        n_ref = inl_ref.sum(-1)
        better = n_ref >= best_score
        E_out = torch.where(better[:, None, None], E_ref, E_out)
        inl_out = torch.where(better[:, None], inl_ref, inl_out)
        best_score = torch.maximum(best_score, n_ref)
    res = RansacResult(E_out, inl_out, inl_out.sum(-1))
    return RansacResult(*(x[0] for x in res)) if single else res


def _tangent_basis(b):
    """Orthonormal (u, v) spanning the plane perpendicular to bearing b."""
    u = torch.linalg.cross(b, ba_mod._helper_axis(b))
    u = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-12)
    return u, torch.linalg.cross(b, u)


def triangulate(R1, t1, R2, t2, b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Linear (DLT-style) triangulation from bearings; (R, t) are
    world->camera. Returns world points [n, 3]: each bearing contributes
    two rows constraining the point to its ray."""

    def rows(R, t, b):
        u, v = _tangent_basis(b)
        # u . (R X + t) = 0 and v . (R X + t) = 0
        A1 = u @ R
        c1 = -torch.sum(u * t, dim=-1)
        A2 = v @ R
        c2 = -torch.sum(v * t, dim=-1)
        return torch.stack([A1, A2], -2), torch.stack([c1, c2], -1)

    A1, c1 = rows(R1, t1, b1)
    A2, c2 = rows(R2, t2, b2)
    A = torch.cat([A1, A2], dim=-2)  # [n, 4, 3]
    c = torch.cat([c1, c2], dim=-1)  # [n, 4]
    AtA = torch.einsum("nij,nik->njk", A, A)
    Atc = torch.einsum("nij,ni->nj", A, c)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(AtA + 1e-9 * eye, Atc[..., None])[0][..., 0]


def decompose_essential(E: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor,
                        valid: torch.Tensor):
    """E -> (R, t) world(cam1)->cam2 by the cheirality count over the four
    candidate decompositions. Returns (R [3,3], t [3], n_good)."""
    u, _, vt = torch.linalg.svd(E)
    # enforce proper rotations
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype, device=E.device)
    R_cands = torch.stack([u @ W @ vt, u @ W.T @ vt])
    t_cands = torch.stack([u[:, 2], -u[:, 2]])
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    zero = torch.zeros(3, dtype=E.dtype, device=E.device)

    def count_front(R, t):
        X = triangulate(eye, zero, R, t, b1, b2)
        d1 = torch.sum(X * b1, dim=-1)  # depth along ray 1
        d2 = torch.sum((X @ R.T + t) * b2, dim=-1)
        return torch.sum((d1 > 0) & (d2 > 0) & valid)

    counts = torch.stack([count_front(R_cands[i], t_cands[j])
                          for i in range(2) for j in range(2)])
    k = torch.argmax(counts)
    return R_cands[k // 2], t_cands[k % 2], counts[k]


def _procrustes(A, B, w):
    """Weighted rigid alignment: R, t with B ~ R A + t (rows are points);
    batched over leading dims."""
    ws = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-12)
    muA = torch.sum(A * ws[..., None], dim=-2)
    muB = torch.sum(B * ws[..., None], dim=-2)
    H = (A - muA[..., None, :]).transpose(-1, -2) @ ((B - muB[..., None, :]) * ws[..., None])
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    d = torch.linalg.det(V @ U.transpose(-1, -2))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = V @ D @ U.transpose(-1, -2)
    return R, muB - (R @ muA[..., None])[..., 0]


def rvec_from_rotmat(Rm: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> angle-axis [..., 3], branchless and
    stable at theta ~ pi: Shepperd's quaternion extraction (all four
    candidates, the best-conditioned picked by argmax)."""
    t = Rm[..., 0, 0] + Rm[..., 1, 1] + Rm[..., 2, 2]
    d0, d1, d2 = Rm[..., 0, 0], Rm[..., 1, 1], Rm[..., 2, 2]
    r = lambda i, j: Rm[..., i, j]  # noqa: E731
    cw = torch.stack([1 + t, r(2, 1) - r(1, 2), r(0, 2) - r(2, 0), r(1, 0) - r(0, 1)], -1)
    cx = torch.stack([r(2, 1) - r(1, 2), 1 + d0 - d1 - d2, r(1, 0) + r(0, 1),
                      r(0, 2) + r(2, 0)], -1)
    cy = torch.stack([r(0, 2) - r(2, 0), r(1, 0) + r(0, 1), 1 - d0 + d1 - d2,
                      r(2, 1) + r(1, 2)], -1)
    cz = torch.stack([r(1, 0) - r(0, 1), r(0, 2) + r(2, 0), r(2, 1) + r(1, 2),
                      1 - d0 - d1 + d2], -1)
    cands = torch.stack([cw, cx, cy, cz], -2)  # [..., 4, 4]
    mags = torch.stack([1 + t, 1 + d0 - d1 - d2, 1 - d0 + d1 - d2, 1 - d0 - d1 + d2], -1)
    q = torch.gather(cands, -2, torch.argmax(mags, -1)[..., None, None].expand(
        mags.shape[:-1] + (1, 4)))[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    nv = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(nv, q[..., :1])
    axis = q[..., 1:] / torch.clamp(nv, min=1e-12)
    return torch.where(nv < 1e-12, torch.zeros_like(axis), axis * theta)


def pnp_dlt(points: torch.Tensor,  # [..., n, 3] world points
            bearings: torch.Tensor,  # [..., n, 3] unit bearings
            valid: torch.Tensor,  # [..., n]
            gn_iters: int = 5):
    """Calibrated resection via EPnP (control-point kernel + Procrustes)
    with Gauss-Newton refinement on the tangent-plane residuals; works
    from >= 6 correspondences and batches over leading dims. Returns
    (R [..., 3, 3], t [..., 3])."""
    dt, dev = points.dtype, points.device
    w = valid.to(dt)
    ws = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-12)
    n = points.shape[-2]

    # world control points: centroid + principal axes
    mu = torch.sum(points * ws[..., None], dim=-2)
    cen = points - mu[..., None, :]
    cov = (cen * ws[..., None]).transpose(-1, -2) @ cen
    evals, evecs = torch.linalg.eigh(cov)
    sc = torch.sqrt(torch.clamp(evals, min=1e-12))
    C = torch.cat([mu[..., None, :],
                   mu[..., None, :] + evecs.transpose(-1, -2) * sc[..., :, None]], -2)  # [..., 4, 3]
    # barycentric coordinates: [C^T; 1] alpha = [X; 1]
    T = torch.cat([C.transpose(-1, -2), torch.ones(C.shape[:-2] + (1, 4), dtype=dt, device=dev)],
                  -2)
    Xh = torch.cat([points, torch.ones(points.shape[:-1] + (1,), dtype=dt, device=dev)], -1)
    alpha = torch.linalg.solve_ex(T, Xh.transpose(-1, -2))[0].transpose(-1, -2)  # [..., n, 4]

    u, v = _tangent_basis(bearings)
    lead = points.shape[:-2]
    Mu = (alpha[..., :, :, None] * u[..., :, None, :]).reshape(lead + (n, 12))
    Mv = (alpha[..., :, :, None] * v[..., :, None, :]).reshape(lead + (n, 12))
    M = torch.cat([Mu * w[..., None], Mv * w[..., None]], dim=-2)
    vt = torch.linalg.svd(M, full_matrices=M.shape[-2] < 12).Vh
    ck = vt[..., -1, :].reshape(lead + (4, 3))  # camera-frame control points (up to scale)

    # scale from control-point pairwise distances (least squares)
    dC = C[..., :, None, :] - C[..., None, :, :]
    dk = ck[..., :, None, :] - ck[..., None, :, :]
    num = torch.sum(torch.linalg.norm(dC, dim=-1) * torch.linalg.norm(dk, dim=-1), (-1, -2))
    den = torch.sum(dk * dk, (-1, -2, -3))
    c_cam = ck * (num / torch.clamp(den, min=1e-12))[..., None, None]
    # sign: majority of points in front of the camera
    x_cam = alpha @ c_cam
    front = torch.sum(x_cam * bearings, -1)
    sgn = torch.sign(torch.sum(torch.where(valid, front, torch.zeros_like(front)), -1))
    sgn = torch.where(sgn == 0, 1.0, sgn)
    c_cam = c_cam * sgn[..., None, None]

    R, t = _procrustes(C, c_cam, torch.ones(C.shape[:-1], dtype=dt, device=dev))

    # Gauss-Newton refinement on (rvec, t)
    cam = torch.cat([rvec_from_rotmat(R), t], -1)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    for _ in range(gn_iters):
        r, Jc, _ = ba_mod._res_jac(cam[..., None, :].expand(lead + (n, 6)), points, bearings)
        r = r * w[..., None]
        Jc = Jc * w[..., None, None]
        g = torch.einsum("...nri,...nr->...i", Jc, r)
        H = torch.einsum("...nri,...nrj->...ij", Jc, Jc) + 1e-8 * eye6
        cam = cam - torch.linalg.solve_ex(H, g[..., None])[0][..., 0]
    return ba_mod._rodrigues(cam[..., :3]), cam[..., 3:]


def ransac_pnp(
    u: torch.Tensor,  # [n_hyp, 6] draws in [0, 2^30)
    points: torch.Tensor,  # [n, 3]
    bearings: torch.Tensor,  # [n, 3]
    valid: torch.Tensor,  # [n] bool (a suffix padding mask)
    threshold: float = 0.01,  # angular (sine) reprojection threshold
):
    """RANSAC resection: one EPnP hypothesis from each 6-point sample,
    then a refit on the best one's inliers. Returns (R, t, inliers,
    n_inliers)."""
    n_valid = torch.clamp(valid.to(torch.int64).sum(), min=1)
    idx = u.to(torch.int64) % n_valid
    Rs, ts = pnp_dlt(points[idx], bearings[idx],
                     torch.ones(idx.shape, dtype=torch.bool, device=points.device))

    def err(R, t):
        p = points @ R.transpose(-1, -2) + t[..., None, :]
        p = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1e-12)
        e = torch.linalg.norm(torch.linalg.cross(p, bearings.expand_as(p)), dim=-1)
        # cheirality: a point behind its bearing is never an inlier
        return torch.where(torch.sum(p * bearings, dim=-1) > 0, e, 2.0)

    inl = (err(Rs, ts) < threshold) & valid
    scores = inl.sum(-1)
    best = torch.argmax(scores)
    # refit on inliers
    R_ref, t_ref = pnp_dlt(points, bearings, inl[best])
    inl_ref = (err(R_ref, t_ref) < threshold) & valid
    better = inl_ref.sum() >= scores[best]
    R = torch.where(better, R_ref, Rs[best])
    t = torch.where(better, t_ref, ts[best])
    inliers = torch.where(better, inl_ref, inl[best])
    return R, t, inliers, inliers.sum()
