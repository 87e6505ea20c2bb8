"""AKAZE features (FED nonlinear diffusion + Hessian detector): the port of
``splat_one_tpu/sfm/akaze.py``.

- Nonlinear scale space by Fast Explicit Diffusion: each evolution level
  advances diffusion time by a cycle of explicit steps of sizes
  tau_j = tau_max / (2 cos^2(pi (2j+1) / (4n+2))) (``_fed_taus``, host
  float64; each step takes its tau as a Python float). A step is the
  conservative divergence-of-flux stencil with per-edge conductivity
  averaging and zero-flux borders (rolls and masks).
- Conductivity: Perona-Malik g2 = 1 / (1 + |grad L_s|^2 / k^2), contrast k
  the ``kcontrast_percentile`` quantile (linear interpolation, as
  ``jnp.nanquantile``) of the nonzero gradient magnitudes of the sigma-1
  image, selected by one sort on the device (no element limit, no host
  read); isotropic: g = 1.
- Octaves halve the resolution; sublevels evolve in octave-local time.
- Detector: determinant of the Hessian from dilated Scharr stencils of
  step round(sigma_local) (``F.conv2d`` with ``dilation``), 3x3 spatial
  and adjacent-sublevel NMS, per-axis quadratic subpixel refinement,
  fixed budgets, global top-K in ``jax.lax.top_k``'s order.
- Descriptors: M-SURF 64-D, or M-LDB bits (2x2 / 3x3 / 4x4 grids,
  ``descriptor_channels`` of intensity / dx / dy, ``descriptor_size``
  bits kept by numpy's ``default_rng(13)``) as +/-1/sqrt(nbits) floats;
  ``_UPRIGHT`` skips the orientation (the SURF-style sliding pi/3 sector).

Split at the scale space: ``akaze_evolution`` builds the levels and
``akaze_from_evolution`` detects and describes, so a test can feed
another implementation's levels. Every convolution runs through
``features._f32_conv`` (cuDNN with TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from splat_one_tpu_torch.sfm.features import Features, _f32_conv, _gaussian_blur, top_k

_TAU_MAX = 0.25  # explicit 2D diffusion stability limit
_SIGMA0 = 1.6  # base scale of evolution level 0


def _fed_taus(T: float) -> np.ndarray:
    """FED cycle step sizes covering total time T (host, float64)."""
    if T <= 0:
        return np.zeros((0,), np.float64)
    n = 1
    while _TAU_MAX * (n * n + n) / 3.0 < T:
        n += 1
    j = np.arange(n)
    taus = _TAU_MAX / (2.0 * np.cos(np.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
    return taus * (T / taus.sum())


def _diffusion_step(L: torch.Tensor, g: torch.Tensor, tau: float) -> torch.Tensor:
    """One explicit step L += tau * div(g grad L), zero-flux borders."""

    def flux(axis, sign):
        Ls = torch.roll(L, -sign, dims=axis)
        gs = torch.roll(g, -sign, dims=axis)
        f = 0.5 * (g + gs) * (Ls - L)
        # zero flux across the border the roll wrapped
        n = L.shape[axis]
        idx = torch.arange(n, device=L.device)
        idx = idx[:, None] if axis == 0 else idx[None, :]
        ok = (idx < n - 1) if sign == 1 else (idx > 0)
        return torch.where(ok, f, torch.zeros_like(f))

    return L + tau * (flux(0, 1) + flux(0, -1) + flux(1, 1) + flux(1, -1))


def _scharr(L: torch.Tensor, axis: int, step: int) -> torch.Tensor:
    """Dilated Scharr derivative along ``axis`` with spacing ``step``: a
    central difference over spacing d approximates d * dL/dx, the
    scale-normalized derivative when d = round(sigma)."""
    smooth = torch.tensor([3.0, 10.0, 3.0], device=L.device) / 16.0
    diff = torch.tensor([-1.0, 0.0, 1.0], device=L.device) / 2.0
    kx, ky = (diff, smooth) if axis == 1 else (smooth, diff)
    with _f32_conv():
        h = F.conv2d(L[None, None], kx.reshape(1, 1, 1, 3), padding=(0, step),
                     dilation=(1, step))
        v = F.conv2d(h, ky.reshape(1, 1, 3, 1), padding=(step, 0), dilation=(step, 1))
    return v[0, 0]


def _kcontrast(image: torch.Tensor, percentile: float) -> torch.Tensor:
    """Contrast factor: the ``percentile`` quantile of the nonzero gradient
    magnitudes of the sigma=1 smoothed image (0.03 where there are none)."""
    Ls = _gaussian_blur(image, 1.0)
    gx = _scharr(Ls, 1, 1)
    gy = _scharr(Ls, 0, 1)
    mag = torch.sqrt(gx * gx + gy * gy).reshape(-1)
    ok = mag > 1e-8
    v = torch.sort(torch.where(ok, mag, torch.full_like(mag, torch.inf))).values
    n = ok.sum()
    pos = torch.tensor(percentile, dtype=torch.float32, device=mag.device) * (n - 1).float()
    lo = torch.clamp(torch.floor(pos), min=0)
    hi = torch.minimum(lo + 1, torch.clamp((n - 1).float(), min=0))
    w = pos - lo
    k = v[lo.long()] * (1 - w) + v[hi.long()] * w
    return torch.where((n > 0) & torch.isfinite(k) & (k > 1e-8), k, torch.full_like(k, 0.03))


def _downsample2(L: torch.Tensor) -> torch.Tensor:
    H, W = L.shape
    H2, W2 = H // 2, W // 2
    return L[: 2 * H2, : 2 * W2].reshape(H2, 2, W2, 2).mean(dim=(1, 3))


def _bilinear(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    fy = torch.clamp(fy, 0.0, H - 1.001)
    fx = torch.clamp(fx, 0.0, W - 1.001)
    y0 = torch.floor(fy).to(torch.int64)
    x0 = torch.floor(fx).to(torch.int64)
    wy = fy - y0
    wx = fx - x0
    return (img[y0, x0] * (1 - wy) * (1 - wx)
            + img[y0, x0 + 1] * (1 - wy) * wx
            + img[y0 + 1, x0] * wy * (1 - wx)
            + img[y0 + 1, x0 + 1] * wy * wx)


# --- orientation (SURF-style dominant direction) ---

_ORI_R = 6
_oy, _ox = np.mgrid[-_ORI_R:_ORI_R + 1, -_ORI_R:_ORI_R + 1]
_ORI_SEL = (_oy * _oy + _ox * _ox) <= _ORI_R * _ORI_R
_ORI_DY = _oy[_ORI_SEL].astype(np.float32)
_ORI_DX = _ox[_ORI_SEL].astype(np.float32)
_ORI_W = np.exp(-(_ORI_DX**2 + _ORI_DY**2) / (2 * 2.5**2)).astype(np.float32)
_N_SECT = 42  # 2pi/42 bins; pi/3 window = 7 bins


def _orientation(Lx, Ly, ys, xs, s):
    """Dominant orientation from gradient samples in a radius-6s disc."""
    dev = Lx.device
    t = lambda a: torch.as_tensor(a, device=dev)
    py = ys[:, None] + t(_ORI_DY)[None, :] * s[:, None]
    px = xs[:, None] + t(_ORI_DX)[None, :] * s[:, None]
    dx = _bilinear(Lx, py, px) * t(_ORI_W)[None, :]
    dy = _bilinear(Ly, py, px) * t(_ORI_W)[None, :]
    ang = torch.atan2(dy, dx)  # [K, P] in (-pi, pi]
    b = torch.floor((ang + np.pi) / (2 * np.pi) * _N_SECT).to(torch.int64)
    b = torch.clamp(b, 0, _N_SECT - 1)
    oh = F.one_hot(b, _N_SECT).to(torch.float32)  # [K, P, S]
    sx = torch.einsum("kp,kps->ks", dx, oh)
    sy = torch.einsum("kp,kps->ks", dy, oh)
    # sliding pi/3 sector = circular window-sum of 7 bins
    idx = (torch.arange(_N_SECT, device=dev)[:, None]
           + torch.arange(7, device=dev)[None, :]) % _N_SECT  # [S, 7]
    wx = torch.sum(sx[:, idx], dim=2)  # [K, S]
    wy = torch.sum(sy[:, idx], dim=2)
    best = torch.argmax(wx * wx + wy * wy, dim=1)
    k = torch.arange(ys.shape[0], device=dev)
    return torch.atan2(wy[k, best], wx[k, best])


# --- M-SURF descriptor ---

def _msurf_offsets():
    """[16, 81, 2] (dy, dx) sample offsets (sigma units) + weights."""
    offs = []
    wsub = []
    for i in range(4):
        for j in range(4):
            cy, cx = 5 * i - 7.5, 5 * j - 7.5
            sy, sx = np.mgrid[0:9, 0:9]
            oy = (5 * i - 12 + sy).astype(np.float32)
            ox = (5 * j - 12 + sx).astype(np.float32)
            w = np.exp(-((oy - cy) ** 2 + (ox - cx) ** 2) / (2 * 2.5**2))
            offs.append(np.stack([oy.ravel(), ox.ravel()], -1))
            wsub.append(w.ravel())
    gi, gj = np.mgrid[0:4, 0:4]
    wreg = np.exp(-((gi - 1.5) ** 2 + (gj - 1.5) ** 2) / (2 * 1.5**2))
    return (np.stack(offs).astype(np.float32),
            np.stack(wsub).astype(np.float32),
            wreg.ravel().astype(np.float32))


_MS_OFF, _MS_WSUB, _MS_WREG = _msurf_offsets()


def _rotated_samples(ys, xs, s, theta, oy, ox):
    """Sample positions (py, px) [K, C, S] of offsets (oy, ox) [C, S]
    (sigma units) rotated into each keypoint's frame."""
    c = torch.cos(theta)[:, None, None]
    sn = torch.sin(theta)[:, None, None]
    ry = ox[None] * sn + oy[None] * c
    rx = ox[None] * c - oy[None] * sn
    return (ys[:, None, None] + ry * s[:, None, None],
            xs[:, None, None] + rx * s[:, None, None], c, sn)


def _msurf_desc(Lx, Ly, ys, xs, s, theta):
    """[K, 64] M-SURF descriptor at scale s (level pixels)."""
    dev = Lx.device
    py, px, c, sn = _rotated_samples(ys, xs, s, theta, torch.as_tensor(_MS_OFF[..., 0], device=dev),
                                     torch.as_tensor(_MS_OFF[..., 1], device=dev))
    dx = _bilinear(Lx, py, px)  # [K, 16, 81]
    dy = _bilinear(Ly, py, px)
    # rotate gradients into the keypoint frame
    gx = c * dx + sn * dy
    gy = -sn * dx + c * dy
    w = torch.as_tensor(_MS_WSUB, device=dev)[None]  # [1, 16, 81]
    parts = torch.stack([
        torch.sum(gx * w, 2), torch.sum(gy * w, 2),
        torch.sum(torch.abs(gx) * w, 2), torch.sum(torch.abs(gy) * w, 2),
    ], -1)  # [K, 16, 4]
    desc = (parts * torch.as_tensor(_MS_WREG, device=dev)[None, :, None]).reshape(
        ys.shape[0], 64)
    return desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-9)


# --- M-LDB descriptor ---

def _mldb_layout():
    """Cell sample offsets for 2x2 / 3x3 / 4x4 grids over a 24-unit patch
    (4x4 samples per cell) + all pairwise comparison index pairs."""
    cells = []  # [n_cells, 16, 2]
    pairs = []  # (a, b) into the flat cell list
    base = 0
    for g in (2, 3, 4):
        cs = 24.0 / g
        for i in range(g):
            for j in range(g):
                sy, sx = np.mgrid[0:4, 0:4]
                oy = -12 + cs * i + (sy + 0.5) * cs / 4
                ox = -12 + cs * j + (sx + 0.5) * cs / 4
                cells.append(np.stack([oy.ravel(), ox.ravel()], -1))
        n = g * g
        for a in range(n):
            for b in range(a + 1, n):
                pairs.append((base + a, base + b))
        base += n
    return (np.stack(cells).astype(np.float32),
            np.asarray(pairs, np.int64))


_LDB_CELLS, _LDB_PAIRS = _mldb_layout()


def _mldb_keep(n_bits: int, descriptor_size: int) -> np.ndarray:
    """The ``descriptor_size`` of ``n_bits`` M-LDB bits kept (sorted)."""
    rng = np.random.default_rng(13)
    return np.sort(rng.choice(n_bits, descriptor_size, replace=False))


def _mldb_desc(L, Lx, Ly, ys, xs, s, theta, channels: int, descriptor_size: int):
    """[K, nbits] M-LDB bits as +/-1/sqrt(nbits) floats."""
    dev = L.device
    py, px, c, sn = _rotated_samples(ys, xs, s, theta,
                                     torch.as_tensor(_LDB_CELLS[..., 0], device=dev),
                                     torch.as_tensor(_LDB_CELLS[..., 1], device=dev))
    means = [torch.mean(_bilinear(L, py, px), 2)]  # [K, C]
    if channels >= 2:
        dx = _bilinear(Lx, py, px)
        dy = _bilinear(Ly, py, px)
        means.append(torch.mean(c * dx + sn * dy, 2))
    if channels >= 3:
        means.append(torch.mean(-sn * dx + c * dy, 2))
    a = torch.as_tensor(_LDB_PAIRS[:, 0], device=dev)
    b = torch.as_tensor(_LDB_PAIRS[:, 1], device=dev)
    bits = torch.cat([(m[:, a] > m[:, b]) for m in means], 1)  # [K, 162*ch]
    nb = bits.shape[1]
    if descriptor_size and descriptor_size < nb:
        bits = bits[:, torch.as_tensor(_mldb_keep(nb, descriptor_size), device=dev)]
        nb = descriptor_size
    return (bits.to(torch.float32) * 2.0 - 1.0) / np.sqrt(float(nb))


def _parse_descriptor(descriptor: str):
    kind = descriptor.upper()
    upright = kind.endswith("_UPRIGHT")
    kind = kind.replace("_UPRIGHT", "")
    if kind not in ("MSURF", "MLDB"):
        raise ValueError(f"akaze_descriptor={descriptor}: MSURF/MLDB(_UPRIGHT)")
    return kind, upright


def akaze_evolution(
    image: torch.Tensor,  # [H, W] grayscale float in [0, 1]
    omax: int = 4,
    nsub: int = 4,
    kcontrast_percentile: float = 0.7,
    isotropic: bool = False,
):
    """The nonlinear scale space of ``extract_akaze``: per octave (octaves
    stop where the level is under 40 px), its ``nsub`` levels as
    ``(L, sigma_local)``."""
    image = image.to(torch.float32)
    kc = None if isotropic else _kcontrast(image, kcontrast_percentile)
    L = _gaussian_blur(image, _SIGMA0)  # evolution level 0
    octaves = []
    t_local = 0.5 * _SIGMA0**2
    for o in range(omax):
        if min(L.shape) < 40:
            break
        levels = []
        for j in range(nsub):
            s_loc = _SIGMA0 * 2.0 ** (o + j / nsub) / float(2**o)
            t_target = 0.5 * s_loc * s_loc
            taus = _fed_taus(t_target - t_local)
            if len(taus):
                if isotropic:
                    g = torch.ones_like(L)
                else:
                    Ls = _gaussian_blur(L, 1.0)
                    gx = _scharr(Ls, 1, 1)
                    gy = _scharr(Ls, 0, 1)
                    g = 1.0 / (1.0 + (gx * gx + gy * gy) / (kc * kc))
                for tau in taus:
                    L = _diffusion_step(L, g, float(tau))
            t_local = t_target
            levels.append((L, s_loc))
        octaves.append(levels)
        if o + 1 < omax:
            L = _downsample2(L)
            t_local = t_local / 4.0  # sigma halves in octave-local units
    return octaves


def akaze_from_evolution(
    octaves,
    max_keypoints: int = 2048,
    omax: int = 4,
    dthreshold: float = 0.001,
    descriptor: str = "MSURF",
    descriptor_size: int = 0,
    descriptor_channels: int = 3,
) -> Features:
    """Detection and description of ``extract_akaze`` over the levels
    ``akaze_evolution`` builds."""
    desc_kind, upright = _parse_descriptor(descriptor)
    dev = octaves[0][0][0].device
    per_oct = -(-max_keypoints // omax)
    all_xy, all_scale, all_theta, all_desc, all_score = [], [], [], [], []
    for o, levels in enumerate(octaves):
        ratio = float(2**o)
        Hl, Wl = levels[0][0].shape
        dets, lxs, lys = [], [], []
        for Li, s_loc in levels:
            d = max(1, int(round(s_loc)))
            Lx = _scharr(Li, 1, d)
            Ly = _scharr(Li, 0, d)
            Lxx = _scharr(Lx, 1, d)
            Lyy = _scharr(Ly, 0, d)
            Lxy = _scharr(Lx, 0, d)
            dets.append(Lxx * Lyy - Lxy * Lxy)
            lxs.append(Lx)
            lys.append(Ly)
        per_lvl = -(-per_oct // len(levels))
        yy = torch.arange(Hl, device=dev)[:, None]
        xx = torch.arange(Wl, device=dev)[None, :]
        for j, (Li, s_loc) in enumerate(levels):
            resp = dets[j]
            mx = F.max_pool2d(resp[None, None], 3, stride=1, padding=1)[0, 0]
            peak = (resp >= mx) & (resp > dthreshold)
            # scale NMS at the same position against the adjacent sublevels
            if j > 0:
                peak &= resp >= dets[j - 1]
            if j + 1 < len(levels):
                peak &= resp >= dets[j + 1]
            b = int(np.ceil(12 * s_loc)) + 3
            peak &= (yy >= b) & (yy < Hl - b) & (xx >= b) & (xx < Wl - b)
            flat = torch.where(peak, resp, torch.full_like(resp, -torch.inf)).reshape(-1)
            top, idx = top_k(flat, per_lvl)
            ok = torch.isfinite(top) & (top > 0)
            ys = torch.clamp(idx // Wl, 1, Hl - 2)
            xs = torch.clamp(idx % Wl, 1, Wl - 2)
            # quadratic subpixel refinement (1D per axis)
            r_c, r_l, r_r = resp[ys, xs], resp[ys, xs - 1], resp[ys, xs + 1]
            r_u, r_d = resp[ys - 1, xs], resp[ys + 1, xs]
            den_x = r_l - 2 * r_c + r_r
            den_y = r_u - 2 * r_c + r_d
            tiny = torch.full_like(den_x, 1e-12)
            dx_sub = torch.clamp(0.5 * (r_l - r_r) / torch.where(
                torch.abs(den_x) > 1e-12, den_x, tiny), -0.5, 0.5)
            dy_sub = torch.clamp(0.5 * (r_u - r_d) / torch.where(
                torch.abs(den_y) > 1e-12, den_y, tiny), -0.5, 0.5)
            fx = xs.to(torch.float32) + dx_sub
            fy = ys.to(torch.float32) + dy_sub
            s_arr = torch.full((per_lvl,), s_loc, dtype=torch.float32, device=dev)
            if upright:
                theta = torch.zeros((per_lvl,), device=dev)
            else:
                theta = _orientation(lxs[j], lys[j], fy, fx, s_arr)
            if desc_kind == "MSURF":
                desc = _msurf_desc(lxs[j], lys[j], fy, fx, s_arr, theta)
            else:
                desc = _mldb_desc(Li, lxs[j], lys[j], fy, fx, s_arr, theta,
                                  descriptor_channels, descriptor_size)
            all_xy.append(torch.stack([fx, fy], -1) * ratio)
            all_scale.append(s_arr * ratio)
            all_theta.append(theta)
            all_desc.append(torch.where(ok[:, None], desc, torch.zeros_like(desc)))
            all_score.append(torch.where(ok, top, torch.zeros_like(top)))
    return _select(all_xy, all_scale, all_theta, all_desc, all_score, max_keypoints)


def _select(all_xy, all_scale, all_theta, all_desc, all_score, max_keypoints) -> Features:
    """The global top ``max_keypoints`` of the levels' candidates by score,
    padded to ``max_keypoints`` rows (a small image can stop early)."""
    scores = torch.cat(all_score)
    k = min(max_keypoints, scores.shape[0])
    sel_score, sel = top_k(torch.where(scores > 0, scores, torch.full_like(scores, -torch.inf)), k)
    ok = torch.isfinite(sel_score) & (sel_score > 0)
    pad = max_keypoints - k

    def padk(x):
        return F.pad(x, (0, 0) * (x.ndim - 1) + (0, pad))

    return Features(
        xys=padk(torch.cat(all_xy)[sel]),
        scales=padk(torch.cat(all_scale)[sel]),
        orientations=padk(torch.cat(all_theta)[sel]),
        descriptors=padk(torch.cat(all_desc)[sel]),
        scores=padk(torch.where(ok, sel_score, torch.zeros_like(sel_score))),
        valid=padk(ok),
    )


def extract_akaze(
    image: torch.Tensor,  # [H, W] grayscale float in [0, 1]
    max_keypoints: int = 2048,
    omax: int = 4,  # akaze_omax
    nsub: int = 4,  # sublevels per octave
    dthreshold: float = 0.001,  # akaze_dthreshold
    kcontrast_percentile: float = 0.7,  # akaze_kcontrast_percentile
    descriptor: str = "MSURF",  # akaze_descriptor
    descriptor_size: int = 0,  # akaze_descriptor_size (MLDB only)
    descriptor_channels: int = 3,  # akaze_descriptor_channels (MLDB)
    isotropic: bool = False,  # akaze_use_isotropic_diffusion
) -> Features:
    """AKAZE features in the shared ``Features`` layout, on the image's
    device."""
    _parse_descriptor(descriptor)
    if min(image.shape) < 40:
        raise ValueError(f"extract_akaze: image {tuple(image.shape)} is under 40 px, the "
                         "smallest octave")
    octaves = akaze_evolution(image, omax, nsub, kcontrast_percentile, isotropic)
    return akaze_from_evolution(octaves, max_keypoints, omax, dthreshold, descriptor,
                                descriptor_size, descriptor_channels)
