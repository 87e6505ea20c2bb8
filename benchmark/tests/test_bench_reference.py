"""The reference against a brute-force dense render at tiny sizes (every
pixel against every gaussian, float64, one pixel at a time), and its
stopping rule against the measured package's own render on the CPU."""

import math

import numpy as np
import pytest
import torch

from benchmark import scene as S
from benchmark.models import gaussians as G
from benchmark.reference import render as R

W, H = 40, 28


def _scene(n, seed, opacity_logit=(-1.0, 1.0), spread=0.5):
    g = torch.Generator().manual_seed(seed)
    return dict(means=torch.randn(n, 3, generator=g) * spread,
                quats=torch.randn(n, 4, generator=g),
                scales=torch.randn(n, 3, generator=g) * 0.4 - 2.6,
                opacities=torch.randn(n, generator=g) * opacity_logit[1] + opacity_logit[0],
                sh0=torch.randn(n, 1, 3, generator=g) * 0.5,
                shN=torch.randn(n, 15, 3, generator=g) * 0.1)


def _camera(model):
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    if model == "pinhole":
        return S.look_at(np.array([0.2, -0.3, -2.5]), np.zeros(3)), K
    return S.yaw_pose(np.array([0.05, 0.0, -0.1]), 0.3), K


def _dense(proj, model, dtype=torch.float64):
    """Every pixel against every kept gaussian, depth order, membership by
    the tiles the ellipse's box covers, no early stop."""
    keep = torch.nonzero(proj.valid)[:, 0]
    order = keep[torch.argsort(proj.depth.detach()[keep], stable=True)]
    uv, con = proj.uv[order].to(dtype), proj.conic[order].to(dtype)
    op, col = proj.opac[order].to(dtype), proj.color[order].to(dtype)
    rx, ry = R.ellipse_extents(proj.conic[order].detach().float(),
                               proj.opac[order].detach().float())
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    px, py = xs.reshape(-1).to(dtype) + 0.5, ys.reshape(-1).to(dtype) + 0.5
    tx, ty = (xs.reshape(-1) // R.TILE).float(), (ys.reshape(-1) // R.TILE).float()
    u, v = uv[:, 0].detach().float(), uv[:, 1].detach().float()
    in_y = (ty[:, None] >= torch.floor((v - ry) / R.TILE)) & (ty[:, None] < torch.ceil((v + ry) / R.TILE))
    if model == "spherical":
        tw = float(-(-W // R.TILE))
        tx0 = torch.floor((u - rx) / R.TILE)
        span = torch.clamp(torch.ceil((u + rx) / R.TILE) - tx0, max=tw)
        in_x = torch.remainder(tx[:, None] - tx0, tw) < span
    else:
        in_x = (tx[:, None] >= torch.floor((u - rx) / R.TILE)) & (tx[:, None] < torch.ceil((u + rx) / R.TILE))
    dx = uv[None, :, 0] - px[:, None]
    if model == "spherical":
        dx = dx - W * torch.round(dx / W)
    dy = uv[None, :, 1] - py[:, None]
    sig = 0.5 * (con[None, :, 0] * dx * dx + con[None, :, 2] * dy * dy) + con[None, :, 1] * dx * dy
    a_raw = op[None] * torch.exp(-sig)
    alpha = torch.where((sig < 0) | (a_raw < R.ALPHA_MIN) | ~(in_x & in_y),
                        torch.zeros_like(a_raw), torch.clamp(a_raw, max=R.ALPHA_MAX))
    t = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1 - alpha[:, :-1]], 1), 1)
    w = alpha * t
    rgb = (w @ col).reshape(H, W, 3)
    t_end = torch.prod(1 - alpha, 1).reshape(H, W, 1)
    return rgb, 1 - t_end


@pytest.mark.parametrize("model", ["pinhole", "spherical"])
def test_render_matches_a_pixel_by_pixel_loop(model):
    raw = _scene(250, 1)
    act = G.reference_rows(raw, torch.ones(250, dtype=torch.bool))
    c2w, K = _camera(model)
    cam = R.camera(model)
    ref = R.render(act, c2w, K, W, H, cam, G.color, elems=1 << 14)
    proj = R.project(act, c2w, K, W, H, cam, G.color)
    assert int(proj.valid.sum()) > 50
    # one pixel at a time, sequentially, in float64 (no tile stops here)
    rgb_d, alpha_d = _dense(proj, model)
    assert float(torch.min(1 - alpha_d)) > 1e-4
    keep = torch.nonzero(proj.valid)[:, 0]
    order = keep[torch.argsort(proj.depth[keep], stable=True)].tolist()
    for (yy, xx) in [(3, 5), (14, 20), (27, 39), (10, 33)]:
        T, acc = 1.0, np.zeros(3)
        for i in order:
            dx = float(proj.uv[i, 0]) - (xx + 0.5)
            if model == "spherical":
                dx -= W * round(dx / W)
            dy = float(proj.uv[i, 1]) - (yy + 0.5)
            ca, cb, cc = (float(c) for c in proj.conic[i])
            s = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
            rx, ry = (float(e) for e in R.ellipse_extents(proj.conic[i:i + 1], proj.opac[i:i + 1]))
            u, v = float(proj.uv[i, 0]), float(proj.uv[i, 1])
            tx, ty = xx // 16, yy // 16
            inside_y = math.floor((v - ry) / 16) <= ty < math.ceil((v + ry) / 16)
            if model == "spherical":
                tx0 = math.floor((u - rx) / 16)
                tw = -(-W // 16)
                inside_x = (tx - tx0) % tw < min(math.ceil((u + rx) / 16) - tx0, tw)
            else:
                inside_x = math.floor((u - rx) / 16) <= tx < math.ceil((u + rx) / 16)
            ar = float(proj.opac[i]) * math.exp(-s)
            if s >= 0 and ar >= R.ALPHA_MIN and inside_x and inside_y:
                a = min(ar, R.ALPHA_MAX)
                acc += a * T * proj.color[i].double().numpy()
                T *= 1 - a
        np.testing.assert_allclose(ref.rgb[yy, xx].double().numpy(), acc, atol=2e-5)
        np.testing.assert_allclose(float(ref.alpha[yy, xx]), 1 - T, atol=2e-5)
    assert float((ref.rgb.double() - rgb_d).abs().max()) < 2e-5
    assert float((ref.alpha.double() - alpha_d).abs().max()) < 2e-5


@pytest.mark.parametrize("model", ["pinhole", "spherical"])
def test_tiles_stop_as_the_measured_renderer_stops(model):
    """An opaque, deep scene in which tiles stop early: the reference and
    the port's own CPU render agree (the port is not part of the
    reference; this only ties the two readings of the same rules)."""
    from splat_one_tpu_torch.app.viewer import Renderer

    raw = _scene(3000, 4, opacity_logit=(4.0, 1.0), spread=0.6)
    raw["scales"] = raw["scales"] + 0.8
    c2w, K = _camera(model)
    act = G.reference_rows(raw, torch.ones(3000, dtype=torch.bool))
    ref = R.render(act, c2w, K, W, H, R.camera(model), G.color, elems=1 << 16)
    rd = Renderer(raw, torch.ones(3000, dtype=torch.bool), W, H, 3, model, device="cpu")
    rgb, ed, alpha, info = rd.render(c2w, K, model)
    assert float(ref.alpha.min()) > 1 - 1e-4  # saturated: tiles stopped
    assert ref.n_isect == int(info["n_isect"])
    assert float((rgb - ref.rgb).abs().max()) < 1e-4
    assert float((alpha - ref.alpha).abs().max()) < 1e-5
