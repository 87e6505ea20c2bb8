"""GPU smoke run of the PyTorch/CUDA port (splat_one_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every kernel in splat_one_tpu_torch/csrc (nvcc,
     sm_90a, one process per source, all at once), timed, with ptxas
     register and shared-memory use;
  3. kernels vs plain versions on the card: small pinhole, spherical,
     edge-partial and empty scenes and a 100k-gaussian 640x480 scene,
     for the forward, backward and segmented-reduce kernels; the kernel
     path's renders and end-to-end gradients against the dense oracle on
     a small scene;
  4. serving at full width: the 1M-gaussian, SH degree 3, 1280x720
     scene of bench.py (seed 0) through params_from_numpy ->
     make_render_fn, three pinhole and one spherical request; launch
     counts, output checks, per-request and per-layer times, peak memory;
     the forward kernel against its plain version at these inputs;
  5. training at full width: (a) bench.py's fwd+bwd step on the same
     scene (loss sum(render) + sum(alpha), gradients into all five
     inputs): step time, Mpix/s, per-layer times, device trace, peak
     memory, launch counts, both new kernels against their plain versions
     at these inputs; (b) the port's Trainer, 1M random-init gaussians at
     1280x720, SH degree 3, GT rendered by the port from 200k gaussians
     seen by 8 ring cameras, with a densification refine in its 6 steps,
     and its checkpoint served back through the viewer's loader;
  6. the kernels line (JSON), then the card line, then the result line.
"""

import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

KERNEL_TOL = 1e-5  # kernel vs plain: max abs err <= tol * max(1, max|plain|)
ORACLE_ATOL = 1e-4  # renders vs the dense oracle
GRAD_RTOL = 5e-4  # gradients vs the dense oracle, of each gradient's max
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
OPS_PER_PAIR = 26  # forward f32 operations per evaluated (pixel, slot) pair, exp as one
# backward f32 arithmetic per evaluated pair (exp as one); the per-slot sums
# over pixels add one operation per reduced value and pair on top (10, or 12
# with absgrad). The kernel's butterfly spends 5 adds per value: its own
# overhead, not work the function needs, so not in the bound.
OPS_PER_PAIR_BWD = 55
N_SERVE, W_SERVE, H_SERVE, SH_SERVE = 1_000_000, 1280, 720, 3
N_GT, N_VIEWS, TRAIN_STEPS = 200_000, 8, 6


def log(*a):
    print(*a, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- scenes
def stream_scene(n=600, c=2, seed=0, w=64, h=48, spherical=False):
    """The parity scene of tests/test_stream_raster.py::_scene."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=1.2, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = np.exp(rng.normal(loc=-2.8, scale=0.5, size=(n, 3))).astype(np.float32)
    opac = (1.0 / (1.0 + np.exp(-rng.normal(size=(n,))))).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    viewmats[:, 2, 3] = 6.0
    if c > 1:
        viewmats[1:, 0, 3] = 0.3
    Ks = np.zeros((c, 3, 3), np.float32)
    Ks[:, 0, 0] = Ks[:, 1, 1] = (w / (2 * np.pi)) if spherical else 60.0
    Ks[:, 0, 2] = w / 2
    Ks[:, 1, 2] = h / 2
    Ks[:, 2, 2] = 1.0
    return dict(means=means, quats=quats, scales=scales, opac=opac,
                colors=colors, viewmats=viewmats, Ks=Ks, w=w, h=h,
                camera_model="spherical" if spherical else "pinhole")


def empty_scene():
    """All gaussians behind the camera (tests/test_stream_raster.py)."""
    return dict(means=np.full((8, 3), 100.0, np.float32),
                quats=np.tile(np.float32([1, 0, 0, 0]), (8, 1)),
                scales=np.full((8, 3), 0.01, np.float32),
                opac=np.full((8,), 0.9, np.float32),
                colors=np.full((8, 3), 0.5, np.float32),
                viewmats=np.eye(4, dtype=np.float32)[None],
                Ks=np.float32([[[60.0, 0, 16], [0, 60.0, 12], [0, 0, 1]]]),
                w=32, h=24, camera_model="pinhole")


def bench_scene(n, w, h, focal, scale_lo, scale_hi, seed=0):
    """bench.py's uniform scene: means in [-1, 1]^2 x [3, 5], SH degree 3."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    means[:, 2] += 4
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = (np.exp(rng.uniform(scale_lo, scale_hi, (n, 3))) * 3).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, n).astype(np.float32)
    sh = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    Ks = np.array([[[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]]], np.float32)
    return dict(means=means, quats=quats, scales=scales, opac=opac, sh=sh,
                viewmats=np.eye(4, dtype=np.float32)[None], Ks=Ks, w=w, h=h,
                camera_model="pinhole")


def oracle_scene(n=300, seed=0):
    """tests/test_rasterizer.py::make_scene (pinhole, SH degree 1)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    means[:, 2] += 4
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = (np.exp(rng.uniform(-3.5, -2.0, (n, 3))) * 3).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, n).astype(np.float32)
    sh = (rng.normal(size=(n, 4, 3)) * 0.3).astype(np.float32)
    return dict(means=means, quats=quats, scales=scales, opac=opac, sh=sh,
                viewmats=np.eye(4, dtype=np.float32)[None],
                Ks=np.float32([[[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]]]),
                w=64, h=64, camera_model="pinhole")


# ------------------------------------------------------------- helpers
def stream_inputs(sc, dev):
    """Project a scene and build the kernel's inputs -> (cfg, st_starts,
    packed, isect)."""
    import torch
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.ops.projection import project_gaussians
    from splat_one_tpu_torch.ops.stream_raster import StreamCfg

    t = lambda x: torch.as_tensor(x, device=dev)
    kw = (dict(sh_coeffs=t(sc["sh"]), sh_degree=3 if sc["sh"].shape[1] == 16 else 1)
          if "sh" in sc else dict(colors=t(sc["colors"])))
    proj = project_gaussians(t(sc["means"]), t(sc["quats"]), t(sc["scales"]),
                             t(sc["opac"]), t(sc["viewmats"]), t(sc["Ks"]),
                             sc["w"], sc["h"], camera_model=sc["camera_model"], **kw)
    C, N = proj.depths.shape
    _, _, sw, sh = si.supertile_grid(sc["w"], sc["h"], 16)
    caps = si.StreamCaps.choose(N, C, C * sw * sh)
    isect = si.build_stream_intersections(proj, sc["w"], sc["h"], 16, caps,
                                          camera_model=sc["camera_model"])
    cfg = StreamCfg.from_caps(caps, sc["w"], sc["h"], 16, C, N,
                              wrap_x=(sc["camera_model"] == "spherical"))
    packed = si.pack_stream(si.build_fields(proj), isect, caps)
    return cfg, isect.st_starts, packed, isect


def compare_fwd(name, cfg, st_starts, packed):
    """Kernel vs plain version on the same inputs; returns (max_abs_err,
    kernel out, plain out)."""
    import torch
    from splat_one_tpu_torch.ops import stream_raster as sr

    out_k = sr.stream_fwd(cfg, st_starts, packed)
    torch.cuda.synchronize()
    out_p = sr.stream_fwd_plain(cfg, st_starts, packed)
    torch.cuda.synchronize()
    worst = 0.0
    parts = []
    for ch, label in ((slice(0, 3), "rgb"), (slice(3, 4), "alpha"),
                      (slice(4, 5), "depth")):
        a, b = out_k[:, :, ch], out_p[:, :, ch]
        err = float((a - b).abs().max()) if a.numel() else 0.0
        scale = float(b.abs().max()) if b.numel() else 0.0
        parts.append(f"{label} abs {err:.3e} rel {err / max(scale, 1e-30):.3e}")
        require(err <= KERNEL_TOL * max(1.0, scale),
                f"{name}: {label} kernel vs plain abs err {err:.3e}")
        worst = max(worst, err)
    nch_eq = bool(torch.equal(out_k[:, :, sr.CH_NCHUNKS], out_p[:, :, sr.CH_NCHUNKS]))
    require(nch_eq, f"{name}: n_chunks differ")
    require(bool(torch.equal(out_k[:, :, 6:], torch.zeros_like(out_k[:, :, 6:]))),
            f"{name}: pad channels not zero")
    log(f"  {name}: CS={cfg.cs} " + "; ".join(parts) + "; n_chunks equal")
    return worst, out_k, out_p


def gated_pairs(cfg, st_starts, packed, out):
    """(pixel, slot) evaluations this run's data needs: gated slots of every
    tile's processed chunks (k < n_chunks of the tile), times 256 pixels."""
    import torch
    from splat_one_tpu_torch.ops import stream_raster as sr

    G = cfg.chunk
    dev = packed.device
    starts = st_starts.long()
    s0, s1 = starts[:-1], starts[1:]
    base0 = torch.div(s0, G, rounding_mode="floor") * G
    nch = out[:, :, sr.CH_NCHUNKS, 0].long()  # [CS, NT]
    _, _, tx, ty = sr._tile_geometry(cfg, torch.arange(cfg.cs, device=dev))
    total = 0
    slots = torch.arange(G, device=dev)
    for k in range(int(nch.max()) if nch.numel() else 0):
        sel = torch.nonzero((nch > k).any(-1))[:, 0]
        rows = base0[sel, None] + k * G + slots
        rowmask = (rows >= s0[sel, None]) & (rows < s1[sel, None])
        gate = sr._chunk_gate(cfg, packed[rows], tx[sel], ty[sel], rowmask)
        total += int((gate & (nch[sel] > k)[..., None]).sum())
    return total * cfg.npix


def cuda_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_trace(fn, iters):
    """torch.profiler over ``iters`` calls of ``fn``: device activities
    (kernels, copies, memsets) per call, device busy ms per call (union of
    their intervals), the idle share between the first device activity
    and the last, and the six activity names with the most device time as
    (name, count per call, ms per call). None where the profiler saw no
    device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    by_name = {}
    for e in events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    top = [(name, n / iters, us / iters / 1e3) for name, (n, us) in top]
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    return len(spans) / iters, busy / iters / 1e3, 1.0 - busy / window, top


def serve_params(sc):
    """bench scene -> the JAX Trainer's parameter convention (numpy)."""
    opac = sc["opac"].astype(np.float64)
    return {
        "means": sc["means"],
        "quats": sc["quats"],
        "scales": np.log(sc["scales"]),
        "opacities": np.log(opac / (1.0 - opac)).astype(np.float32),
        "sh0": sc["sh"][:, :1],
        "shN": sc["sh"][:, 1:],
    }


def yaw_pose(yaw, tx=0.0, ty=0.0, tz=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    c2w[:3, 3] = [tx, ty, tz]
    return c2w


def seeded_gout(cfg, seed, dev):
    """A cotangent of the forward output, normal from ``seed``."""
    import torch
    from splat_one_tpu_torch.ops import stream_raster as sr

    rng = np.random.default_rng(seed)
    g = rng.normal(size=(cfg.cs, cfg.nt, sr.OUT_CH, cfg.npix)).astype(np.float32)
    return torch.as_tensor(g, device=dev)


def column_err(name, label, got, want):
    """Max abs err of got vs want over every column; fails past
    KERNEL_TOL * max(1, max|want|) of its column."""
    import torch

    if got.numel() == 0:
        return 0.0
    err = (got - want).abs().amax(0)
    scale = torch.clamp(want.abs().amax(0), min=1.0)
    worst = int(torch.argmax(err / scale))
    require(bool((err <= KERNEL_TOL * scale).all()),
            f"{name}: {label} column {worst} kernel vs plain abs err {float(err[worst]):.3e}")
    return float(err.max())


def compare_bwd(name, cfg, st_starts, st_starts_al, packed, out, gout, m0):
    """Backward kernel vs plain version on the same inputs (key column
    exactly, gradient columns within KERNEL_TOL), then the segmented
    reduce kernel vs plain on the kernel's sorted rows. Returns (max abs
    err bwd, max abs err reduce, kernel rows, sorted rows, bounds)."""
    import torch
    from splat_one_tpu_torch.ops import seg_reduce as sgr
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.ops import stream_raster as sr

    pg_k = sr.stream_bwd(cfg, st_starts, st_starts_al, packed, out, gout)
    torch.cuda.synchronize()
    pg_p = sr.stream_bwd_plain(cfg, st_starts, st_starts_al, packed, out, gout)
    torch.cuda.synchronize()
    require(bool(torch.equal(pg_k[:, si.GCOL_KEY:], pg_p[:, si.GCOL_KEY:])),
            f"{name}: backward key / pad columns differ")
    e_bwd = column_err(name, "backward", pg_k[:, :si.GCOL_KEY], pg_p[:, :si.GCOL_KEY])
    n_payload = si.N_GCOLS if cfg.absgrad else si.GCOL_ABSDX
    rows, bounds = si.sort_grad_rows(pg_k, m0)
    red_k = sgr.segment_reduce_rows(rows, bounds, n_payload)
    red_p = sgr.segment_reduce_plain(rows, bounds, n_payload)
    torch.cuda.synchronize()
    e_red = column_err(name, "seg_reduce", red_k.T, red_p.T)
    n_rows = int((pg_k[:, si.GCOL_KEY] > 0).sum())
    log(f"  {name}: stream_bwd (absgrad {cfg.absgrad}) abs err {e_bwd:.3e} over "
        f"{n_rows} keyed rows, key column equal; seg_reduce abs err {e_red:.3e} "
        f"over {m0} gaussians")
    return e_bwd, e_red, pg_k, rows, bounds


def oracle_grad_check(dev):
    """End-to-end gradients through the kernels vs the dense oracle by
    autograd: tests/test_rasterizer.py::TestGradParity (150 gaussians,
    seed 7, 64x64, SH degree 1, random weights on rgb, alpha and expected
    depth), each gradient within GRAD_RTOL of its max."""
    import torch
    from splat_one_tpu_torch.ops.projection import project_gaussians
    from splat_one_tpu_torch.ops.reference import composite_reference
    from splat_one_tpu_torch.render.rasterization import rasterization

    sc = oracle_scene(150, seed=7)
    rng = np.random.default_rng(0)
    wts = [torch.as_tensor(rng.normal(size=(1, 64, 64, c)).astype(np.float32), device=dev)
           for c in (3, 1, 1)]
    names = ("means", "quats", "scales", "opac", "sh")
    grads = []
    for path in ("kernels", "oracle"):
        leaves = [torch.tensor(sc[k], device=dev, requires_grad=True) for k in names]
        vm, K = (torch.as_tensor(sc[k], device=dev) for k in ("viewmats", "Ks"))
        if path == "kernels":
            render, alpha, _ = rasterization(*leaves[:4], leaves[4], vm, K, 64, 64,
                                             sh_degree=1, render_mode="RGB+ED")
            rgb, d_exp = render[..., :3], render[..., 3:]
        else:
            proj = project_gaussians(*leaves[:4], vm, K, 64, 64, sh_coeffs=leaves[4],
                                     sh_degree=1)
            rgb, alpha, d = composite_reference(proj, 64, 64)
            d_exp = d / torch.clamp(alpha, min=1e-10)
        loss = (rgb * wts[0]).sum() + (alpha * wts[1]).sum() + (d_exp * wts[2]).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    worst = 0.0
    for name, gk, go in zip(names, *grads):
        rel = float((gk - go).abs().max() / (go.abs().max() + 1e-8))
        require(bool(torch.isfinite(gk).all()), f"oracle grads: {name} not finite")
        require(rel <= GRAD_RTOL, f"oracle grads: {name} rel err {rel:.3e}")
        worst = max(worst, rel)
    log(f"  oracle 64x64 (150 gaussians) end-to-end gradients, kernels vs dense "
        f"oracle by autograd: worst rel err {worst:.2e} (bar {GRAD_RTOL})")


def bench_caps(proj, w, h):
    """bench.py's caps: one warm-up build at generous caps, then caps sized
    from the measured intersection count (StreamCaps.choose_observed)."""
    from splat_one_tpu_torch.ops import stream_isect as si

    C, N = proj.depths.shape
    _, _, sgw, sgh = si.supertile_grid(w, h, 16)
    caps0 = si.StreamCaps.choose(N, C, C * sgw * sgh, avg_supertiles_per_gaussian=4.0)
    n0 = int(si.build_stream_intersections(proj, w, h, 16, caps0).n_isect)
    return si.StreamCaps.choose_observed(n0, C * sgw * sgh)


def ring_scene(dev):
    """The Trainer's scene: the port renders N_GT volumetric GT gaussians
    (make_gt_gaussians, seed 0, SH degree 0) from N_VIEWS ring cameras
    (ring_cameras, radius 3, height -0.8, 60 deg) at 1280x720."""
    import torch
    from splat_one_tpu_torch.core.sh import rgb_to_sh
    from splat_one_tpu_torch.core.transforms import invert_se3
    from splat_one_tpu_torch.data.synthetic import make_gt_gaussians, ring_cameras
    from splat_one_tpu_torch.ops.projection import project_gaussians
    from splat_one_tpu_torch.render.rasterization import rasterization
    from splat_one_tpu_torch.train.trainer import SceneData

    means, quats, scales, opac, rgb = make_gt_gaussians(N_GT, seed=0)
    c2ws, Ks = ring_cameras(N_VIEWS, 3.0, -0.8, 60.0, W_SERVE, H_SERVE)
    t = lambda x: torch.as_tensor(x, device=dev)
    sh0 = rgb_to_sh(t(rgb))[:, None, :]
    images = []
    with torch.no_grad():
        for i in range(N_VIEWS):
            vm, K = invert_se3(t(c2ws[i:i + 1])), t(Ks[i:i + 1])
            proj = project_gaussians(t(means), t(quats), t(scales), t(opac), vm, K,
                                     W_SERVE, H_SERVE, colors=t(rgb))
            render, _, info = rasterization(
                t(means), t(quats), t(scales), t(opac), sh0, vm, K, W_SERVE, H_SERVE,
                sh_degree=0, caps=bench_caps(proj, W_SERVE, H_SERVE))
            require(not bool(info["overflow"]), "GT render overflow")
            images.append(torch.clamp(render[0], 0.0, 1.0).cpu().numpy())
    rng = np.random.default_rng(2)
    sel = rng.choice(N_GT, size=5000, replace=False)
    eyes = c2ws[:, :3, 3]
    return SceneData(
        camtoworlds=c2ws, Ks=Ks, images=np.stack(images).astype(np.float32),
        points=means[sel], points_rgb=rgb[sel],
        scene_scale=float(np.linalg.norm(eyes - eyes.mean(0), axis=-1).max() * 1.1),
        camera_model="pinhole")


def training_phase(dev, card, sc, max_err):
    """Phase 5 (see the module docstring). ``sc`` is the serving scene,
    bench.py's; ``max_err`` collects kernel-vs-plain errors. Returns the
    Trainer run's launch counts and the kernels-line rows of the two
    backward kernels."""
    import torch
    from splat_one_tpu_torch.app.viewer import load_checkpoint_params, make_render_fn
    from splat_one_tpu_torch.ops import seg_reduce as sgr
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.ops import stream_raster as sr
    from splat_one_tpu_torch.ops.projection import Projected, project_gaussians
    from splat_one_tpu_torch.render.rasterization import rasterization
    from splat_one_tpu_torch.train.config import Config
    from splat_one_tpu_torch.train.strategy import DefaultStrategyCfg
    from splat_one_tpu_torch.train.trainer import Trainer
    from splat_one_tpu_torch.utils import cuda_build

    W, H, N = W_SERVE, H_SERVE, N_SERVE
    names = ("means", "quats", "scales", "opac", "sh")
    leaves = [torch.tensor(sc[k], device=dev, requires_grad=True) for k in names]
    vm, Kt = (torch.as_tensor(sc[k], device=dev) for k in ("viewmats", "Ks"))
    with torch.no_grad():
        proj0 = project_gaussians(*(x.detach() for x in leaves[:4]), vm, Kt, W, H,
                                  sh_coeffs=leaves[4].detach(), sh_degree=3)
    caps = bench_caps(proj0, W, H)
    cfg = sr.StreamCfg.from_caps(caps, W, H, 16, 1, N)

    # (a) bench.py's step
    log(f"phase 5a: fwd+bwd step, {N} gaussians, SH 3, {W}x{H}, RGB+ED, loss "
        f"sum(render) + sum(alpha), exp_cap {caps.exp_cap}, pad_cap {caps.pad_cap} | {card}")

    def step():
        render, alpha, info = rasterization(*leaves[:4], leaves[4], vm, Kt, W, H,
                                            sh_degree=3, render_mode="RGB+ED", caps=caps)
        loss = render.sum() + alpha.sum()
        return loss, torch.autograd.grad(loss, leaves), info

    step()
    torch.cuda.synchronize()
    cuda_build.launch_counts.clear()
    step_times = []
    for _ in range(7):
        t0 = time.perf_counter()
        loss, grads, info = step()
        torch.cuda.synchronize()
        step_times.append((time.perf_counter() - t0) * 1e3)
    counts = dict(cuda_build.launch_counts)
    log(f"  launch counts over 7 steps: {counts}")
    for k in ("stream_fwd", "stream_bwd", "seg_reduce"):
        require(counts.get(k, 0) == 7, f"{k} launched {counts.get(k, 0)} times in 7 steps")
    require(not bool(info["overflow"]), "training step overflow")
    require(bool(torch.isfinite(loss)), "training step loss not finite")
    for name, g in zip(names, grads):
        require(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0),
                f"training step gradient {name}")
    step_ms = statistics.median(step_times)
    log(f"  step: median {step_ms:.3f} ms over 7 (host clock, synchronized), "
        f"{W * H / step_ms / 1e3:.3f} Mpix/s; n_isect {int(info['n_isect'])}; "
        f"steps {', '.join(f'{t:.1f}' for t in step_times)} ms | {card}")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    log(f"  step peak memory above the inputs: "
        f"{(torch.cuda.max_memory_allocated() - base_mem) / 2**20:.0f} MiB")
    trace = device_trace(step, 3)
    if trace is None:
        log("  trace step: not measured (the profiler saw no device activity)")
    else:
        log(f"  trace step (torch.profiler, 3 steps): {trace[0]:.0f} device activities "
            f"per step, device busy {trace[1]:.3f} ms per step, device idle share "
            f"{trace[2]:.3f} of the traced window | {card}")
        for kname, n, ms in trace[3]:
            log(f"    {ms:.3f} ms, {n:.0f}x per step: {kname[:100]}")

    # the step's cotangent of the forward output (assembly + ED + loss)
    with torch.no_grad():
        isect = si.build_stream_intersections(proj0, W, H, 16, caps)
        packed = si.pack_stream(si.build_fields(proj0), isect, caps)
        out = sr.stream_fwd(cfg, isect.st_starts, packed)
    out_leaf = out.detach().requires_grad_(True)
    rgb, a, d = sr.stream_to_image(cfg, out_leaf)
    gl = torch.cat([rgb, d / torch.clamp(a, min=1e-10)], -1).sum() + a.sum()
    gout, = torch.autograd.grad(gl, out_leaf)

    # per-layer split (CUDA events), the same computation as step()
    layers = {k: [] for k in ("projection fwd", "build + pack", "fwd kernel",
                              "bwd kernel", "key sort", "seg_reduce kernel",
                              "projection bwd")}
    n_pay = si.GCOL_ABSDX
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        proj = project_gaussians(*leaves[:4], vm, Kt, W, H, sh_coeffs=leaves[4],
                                 sh_degree=3)
        ev[1].record()
        psg = Projected(*(x.detach() for x in proj))
        isect = si.build_stream_intersections(psg, W, H, 16, caps)
        packed = si.pack_stream(si.build_fields(psg), isect, caps)
        ev[2].record()
        out = sr.stream_fwd(cfg, isect.st_starts, packed)
        ev[3].record()
        pg = sr.stream_bwd(cfg, isect.st_starts, isect.st_starts_al, packed, out, gout)
        ev[4].record()
        rows, bounds = si.sort_grad_rows(pg, N)
        ev[5].record()
        seg = sgr.segment_reduce_rows(rows, bounds, n_pay)
        ev[6].record()
        col = lambda *c: seg[list(c)].T.reshape(1, N, len(c))
        cot = [col(si.GCOL_DX, si.GCOL_DY), col(si.GCOL_DCA, si.GCOL_DCB, si.GCOL_DCC),
               col(si.GCOL_DR, si.GCOL_DG, si.GCOL_DB),
               seg[si.GCOL_DOPAC].reshape(1, N), seg[si.GCOL_DDEPTH].reshape(1, N)]
        g_split = torch.autograd.grad(
            [proj.means2d, proj.conics, proj.colors, proj.opacities, proj.depths],
            leaves, grad_outputs=cot)
        ev[7].record()
        torch.cuda.synchronize()
        for i, key in enumerate(layers):
            layers[key].append(ev[i].elapsed_time(ev[i + 1]))
    for name, gs, g in zip(names, g_split, grads):
        rel = float((gs - g).abs().max() / g.abs().max())
        require(rel <= 1e-6, f"layer split gradient {name} differs from the step's: {rel:.2e}")
    log("  layers (median of 5, CUDA events): " + ", ".join(
        f"{k} {statistics.median(v):.3f} ms" for k, v in layers.items()))

    def timed(fn, n=5):  # median host ms of fn() ending in synchronize()
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    def fwd_only():
        render, alpha, _ = rasterization(*leaves[:4], leaves[4], vm, Kt, W, H,
                                         sh_degree=3, render_mode="RGB+ED", caps=caps)
        return render.sum() + alpha.sum()

    def proj_bwd():
        p = project_gaussians(*leaves[:4], vm, Kt, W, H, sh_coeffs=leaves[4], sh_degree=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.autograd.grad([p.means2d, p.conics, p.colors, p.opacities, p.depths],
                            leaves, grad_outputs=cot)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    fwd_ms = timed(fwd_only)
    pb_ms = statistics.median([proj_bwd() for _ in range(5)])
    log(f"  step split by host clock (synchronized, median of 5): forward to the loss "
        f"{fwd_ms:.3f} ms, so backward {step_ms - fwd_ms:.3f} ms; projection backward "
        f"alone {pb_ms:.3f} ms")
    trace = device_trace(proj_bwd, 3)
    if trace is not None:
        log(f"  trace projection backward: {trace[0]:.0f} device activities, busy "
            f"{trace[1]:.3f} ms, idle share {trace[2]:.3f}")
        for kname, n, ms in trace[3]:
            log(f"    {ms:.3f} ms, {n:.0f}x: {kname[:100]}")

    # both kernels at these inputs: vs plain, time, bound
    st, st_al = isect.st_starts, isect.st_starts_al
    e_b, e_r, pg_k, rows_k, bounds_k = compare_bwd(
        "training 1M pinhole", cfg, st, st_al, packed, out, gout, N)
    max_err["stream_bwd"] = max(max_err["stream_bwd"], e_b)
    max_err["seg_reduce"] = max(max_err["seg_reduce"], e_r)
    bwd_ms = cuda_ms(lambda: sr.stream_bwd(cfg, st, st_al, packed, out, gout), 10)
    bwd_plain_ms = cuda_ms(lambda: sr.stream_bwd_plain(cfg, st, st_al, packed, out, gout), 1)
    red_ms = cuda_ms(lambda: sgr.segment_reduce_rows(rows_k, bounds_k, n_pay), 20)
    red_plain_ms = cuda_ms(lambda: sgr.segment_reduce_plain(rows_k, bounds_k, n_pay), 3)
    keys = pg_k[:, si.GCOL_KEY].long()
    payload = pg_k[:, :n_pay].contiguous()
    keyed = keys > 0
    keys_live, payload_live = keys[keyed] - 1, payload[keyed]

    # the library yardstick (library_ms): one index_add_ over the keyed rows,
    # unsorted, the rows the kernel reads; beside it index_add_ over every
    # unsorted pad_cap row, where the unwritten key-0 rows all add into one
    # row. End to end from the backward's rows: the key sort plus the kernel
    # against the keyed-row selection plus index_add_.
    def library_reduce():
        acc = torch.zeros((N, n_pay), device=dev)
        return acc.index_add_(0, keys_live, payload_live)

    def library_reduce_all():
        acc = torch.zeros((N + 1, n_pay), device=dev)
        return acc.index_add_(0, keys, payload)

    def e2e_kernel():
        rows, bounds = si.sort_grad_rows(pg_k, N)
        return sgr.segment_reduce_rows(rows, bounds, n_pay)

    def e2e_library():
        m = pg_k[:, si.GCOL_KEY] > 0
        acc = torch.zeros((N, n_pay), device=dev)
        return acc.index_add_(0, pg_k[m, si.GCOL_KEY].long() - 1, pg_k[m, :n_pay])

    lib_ms = cuda_ms(library_reduce, 20)
    lib_all_ms = cuda_ms(library_reduce_all, 20)
    e2e_k_ms = cuda_ms(e2e_kernel, 10)
    e2e_l_ms = cuda_ms(e2e_library, 10)
    red_ref = sgr.segment_reduce_rows(rows_k, bounds_k, n_pay)
    lib_diff = max(float((library_reduce().T - red_ref).abs().max()),
                   float((library_reduce_all()[1:].T - red_ref).abs().max()),
                   float((e2e_library().T - e2e_kernel()).abs().max()))
    # bounds count what this run's data needs: the chunks the tiles reached
    # (early termination leaves the rest of each stream unread and its
    # gradient rows unwritten) and, for the reduce, the keyed rows
    pairs = gated_pairs(cfg, st, packed, out)
    starts = st.long()
    base0 = torch.div(starts[:-1], cfg.chunk, rounding_mode="floor") * cfg.chunk
    chunks = torch.minimum(-torch.div(base0 - starts[1:], cfg.chunk, rounding_mode="floor"),
                           out[:, :, sr.CH_NCHUNKS, 0].long().amax(-1))
    n_chunks = int(chunks.sum())
    # slot rows read and gradient rows written (64 B each), fwd_out channels
    # 0-5 and gout channels 0-4 read
    bwd_bytes = (2 * n_chunks * cfg.chunk * si.NF * 4
                 + (6 + 5) * cfg.cs * cfg.nt * cfg.npix * 4)
    ops_per_pair = OPS_PER_PAIR_BWD + n_pay
    bwd_ops_s = pairs * ops_per_pair / F32_OPS_PER_S
    bwd_bound = max(bwd_bytes / HBM_BYTES_PER_S, bwd_ops_s) * 1e3
    bwd_by = "bytes" if bwd_bytes / HBM_BYTES_PER_S >= bwd_ops_s else "operations"
    n_keyed = int((pg_k[:, si.GCOL_KEY] > 0).sum())
    # keyed rows' payload and the bounds read, the per-gaussian sums written
    red_bytes = n_keyed * n_pay * 4 + (N + 1) * 4 + n_pay * N * 4
    red_bound = red_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  stream_bwd at 1M/720p: {bwd_ms:.4f} ms (CUDA events, 10 launches); plain "
        f"version {bwd_plain_ms:.1f} ms; bound {bwd_bound:.4f} ms by {bwd_by} "
        f"({bwd_bytes / 1e6:.1f} MB over {n_chunks} chunks reached, {pairs / 1e6:.1f} M "
        f"pixel-slot pairs x {ops_per_pair} ops) | {card}")
    log(f"  seg_reduce at 1M/720p: {red_ms:.4f} ms (CUDA events, 20 launches); plain "
        f"version {red_plain_ms:.2f} ms; bound {red_bound:.4f} ms by bytes "
        f"({red_bytes / 1e6:.1f} MB: {n_keyed} keyed rows of pad_cap {cfg.pad_cap}) "
        f"| {card}")
    log(f"  index_add_ over the {n_keyed} keyed rows (unsorted) {lib_ms:.4f} ms; over "
        f"all {cfg.pad_cap} unsorted rows {lib_all_ms:.4f} ms; end to end from the "
        f"backward's rows: key sort + seg_reduce kernel {e2e_k_ms:.4f} ms, keyed-row "
        f"selection + index_add_ {e2e_l_ms:.4f} ms (CUDA events; max abs diff to the "
        f"kernel {lib_diff:.2e}) | {card}")
    del proj, psg, g_split, grads, pg, rows, seg, pg_k, rows_k, payload, keys, leaves
    del keyed, keys_live, payload_live, red_ref
    torch.cuda.empty_cache()

    # (b) the port's Trainer at full width
    log(f"phase 5b: Trainer, {N} random-init gaussians (capacity 1,048,576), SH 3, "
        f"{W}x{H}, {TRAIN_STEPS} steps; GT: {N_GT} gaussians, {N_VIEWS} ring views | {card}")
    t0 = time.perf_counter()
    scene = ring_scene(dev)
    log(f"  GT render of {N_VIEWS} views: {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        tcfg = Config(
            result_dir=tmp, camera_model="pinhole", sh_degree=3, batch_size=1,
            init_type="random", init_num_pts=N, capacity=1_048_576,
            max_steps=TRAIN_STEPS, eval_steps=[TRAIN_STEPS], save_steps=[TRAIN_STEPS],
            tb_every=TRAIN_STEPS, test_every=8,
            strategy=DefaultStrategyCfg(refine_start_iter=2, refine_stop_iter=100,
                                        refine_every=3, reset_every=5))
        t0 = time.perf_counter()
        trainer = Trainer(tcfg, scene)
        log(f"  Trainer init (random init, 3-NN scales on the host): "
            f"{time.perf_counter() - t0:.1f} s")
        n0 = int(trainer.state.alive.sum())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.launch_counts.clear()
        t0 = time.perf_counter()
        hist = trainer.train(log_every=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        tcounts = dict(cuda_build.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  launch counts on the training path ({TRAIN_STEPS} steps, 2 refines, "
            f"1 eval render): {tcounts}")
        for k in ("stream_bwd", "seg_reduce"):
            require(tcounts.get(k, 0) == TRAIN_STEPS,
                    f"{k} launched {tcounts.get(k, 0)} times in {TRAIN_STEPS} steps")
        require(tcounts.get("stream_fwd", 0) >= TRAIN_STEPS, "stream_fwd launches")
        losses = [h["loss"] for h in hist]
        n_gs = [h["num_GS"] for h in hist]
        require(len(hist) == TRAIN_STEPS and all(np.isfinite(losses)), f"losses {losses}")
        # the Trainer samples overflow every 10 steps; here every step must fit
        require(all(h["overflow"] == 0 for h in hist),
                f"Trainer intersection overflow: {[h['overflow'] for h in hist]}")
        require(all(n <= trainer.capacity for n in n_gs), "alive count above capacity")
        require(n_gs[2] != n_gs[1], f"the refine at step 3 left the alive count at {n_gs[1]}")
        dts = np.diff([0.0] + [h["time_s"] for h in hist]) * 1e3
        log(f"  losses {', '.join(f'{x:.5f}' for x in losses)}; alive {n0} -> "
            f"{', '.join(map(str, n_gs))}; capacity {trainer.capacity}; n_isect "
            f"{', '.join(str(int(h['n_isect'])) for h in hist)} (no overflow, exp_cap "
            f"{trainer.caps.exp_cap})")
        log(f"  step times (host clock, each ends reading the loss) "
            f"{', '.join(f'{x:.1f}' for x in dts)} ms; whole run {train_s:.1f} s; "
            f"peak memory {peak:.2f} GiB | {card}")
        with open(f"{tmp}/stats/val_step{TRAIN_STEPS:04d}.json") as f:
            stats = json.load(f)
        log(f"  eval: psnr {stats['psnr']:.3f}, ssim {stats['ssim']:.4f}, "
            f"lpips {stats['lpips']}")
        require(np.isfinite(stats["psnr"]) and stats["lpips"] is None, "eval stats")
        params, alive = load_checkpoint_params(f"{tmp}/ckpts/ckpt_{TRAIN_STEPS}.npz")
        require(int(alive.sum()) == n_gs[-1], "checkpoint alive count")
        fn = make_render_fn(params, alive, W, H, sh_degree=3)
        c2w, K = scene.camtoworlds[0], scene.Ks[0]
        rgb_v = torch.clamp(fn.render(c2w, K)[0], 0, 1).cpu().numpy()
        rgb_t, _ = trainer.render_view(c2w, K)
        diff = float(np.abs(rgb_v - rgb_t).max())
        log(f"  checkpoint served through load_checkpoint_params -> make_render_fn: "
            f"max abs diff to the Trainer's render {diff:.2e}")
        require(np.isfinite(rgb_v).all() and rgb_v.shape == (H, W, 3) and diff <= 1e-5,
                "checkpoint render")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    return {"launches": tcounts, "kernels": [
        dict(name="stream_bwd", route="cuda", source="splat_one_tpu_torch/csrc/stream_bwd.cu",
             replaces="splat_one_tpu/ops/stream_raster.py:397",
             launches=tcounts.get("stream_bwd", 0), max_abs_err=max_err["stream_bwd"],
             ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bwd_bound, bound_by=bwd_by,
             library_ms=None),
        dict(name="seg_reduce", route="cuda", source="splat_one_tpu_torch/csrc/seg_reduce.cu",
             replaces="splat_one_tpu/ops/seg_reduce.py:67",
             launches=tcounts.get("seg_reduce", 0), max_abs_err=max_err["seg_reduce"],
             ms=red_ms, plain_ms=red_plain_ms, bound_ms=red_bound, bound_by="bytes",
             library_ms=lib_ms),
    ]}


# ---------------------------------------------------------------- main
def main():
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"| {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    from splat_one_tpu_torch.app.viewer import make_render_fn, params_from_numpy
    from splat_one_tpu_torch.core.transforms import invert_se3
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.ops import stream_raster as sr
    from splat_one_tpu_torch.ops.projection import project_gaussians
    from splat_one_tpu_torch.ops.reference import composite_reference
    from splat_one_tpu_torch.render.rasterization import rasterization
    from splat_one_tpu_torch.utils import cuda_build

    # phase 2: build, from the sources, whatever an earlier run left
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    blog = cuda_build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, entry in sorted(blog.items()):
        log(f"  {name}: nvcc {entry['seconds']:.1f} s")
        for line in entry["ptxas"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"    {line.strip()}")
    for name in cuda_build.SIGNATURES:
        cuda_build.library(name)

    # phase 3: kernels vs plain versions, and vs the oracle
    log("phase 3: stream_fwd, stream_bwd and seg_reduce kernels vs plain versions")
    scenes = {
        "pinhole": stream_scene(),
        "spherical": stream_scene(spherical=True),
        "edge-partial 40x24": stream_scene(n=200, c=1, w=40, h=24),
        "empty": empty_scene(),
        "100k 640x480": bench_scene(100_000, 640, 480, 500.0, -5.5, -4.0, seed=1),
    }
    # kernel vs plain max abs err, over every comparison of this run
    max_err = {"stream_fwd": 0.0, "stream_bwd": 0.0, "seg_reduce": 0.0}
    for i, (name, sc) in enumerate(scenes.items()):
        cfg, st, packed, isect = stream_inputs(sc, dev)
        e, out_k, _ = compare_fwd(name, cfg, st, packed)
        max_err["stream_fwd"] = max(max_err["stream_fwd"], e)
        # both reduced widths: with absgrad (12 columns) on every other scene
        cfg_b = dataclasses.replace(cfg, absgrad=(i % 2 == 0))
        e_b, e_r, *_ = compare_bwd(name, cfg_b, st, isect.st_starts_al, packed, out_k,
                                   seeded_gout(cfg, i, dev),
                                   cfg.num_cameras * cfg.num_gaussians)
        max_err["stream_bwd"] = max(max_err["stream_bwd"], e_b)
        max_err["seg_reduce"] = max(max_err["seg_reduce"], e_r)
        torch.cuda.synchronize()

    osc = oracle_scene()
    t = lambda x: torch.as_tensor(x, device=dev)
    args = [t(osc[k]) for k in ("means", "quats", "scales", "opac", "sh",
                                "viewmats", "Ks")]
    render, alpha, info = rasterization(*args, 64, 64, sh_degree=1,
                                        render_mode="RGB+D")
    proj = project_gaussians(*args[:4], args[5], args[6], 64, 64,
                             sh_coeffs=args[4], sh_degree=1)
    rgb_o, a_o, d_o = composite_reference(proj, 64, 64)
    torch.cuda.synchronize()
    e_rgb = float((render[..., :3] - rgb_o).abs().max())
    e_a = float((alpha - a_o).abs().max())
    e_d = float((render[..., 3:] - d_o).abs().max())
    log(f"  oracle 64x64 (300 gaussians): rgb {e_rgb:.2e} alpha {e_a:.2e} "
        f"depth {e_d:.2e} (atol {ORACLE_ATOL})")
    require(not bool(info["overflow"]), "oracle scene overflow")
    require(max(e_rgb, e_a) <= ORACLE_ATOL, "kernel path vs oracle (rgb/alpha)")
    require(e_d <= 5 * ORACLE_ATOL, "kernel path vs oracle (depth)")
    oracle_grad_check(dev)

    # phase 4: serving at full width
    log(f"phase 4: serving {N_SERVE} gaussians, SH {SH_SERVE}, "
        f"{W_SERVE}x{H_SERVE} | {card}")
    sc = bench_scene(N_SERVE, W_SERVE, H_SERVE, 1000.0, -6.5, -5.0, seed=0)
    K = sc["Ks"][0]
    params, alive = params_from_numpy(serve_params(sc), np.ones(N_SERVE, bool), "cuda")
    render_fn = make_render_fn(params, alive, W_SERVE, H_SERVE, sh_degree=SH_SERVE,
                               camera_model="pinhole")
    requests = [
        ("pinhole front", yaw_pose(0.0), "pinhole"),
        ("pinhole shifted", yaw_pose(0.0, tx=0.25, ty=-0.1), "pinhole"),
        ("pinhole yawed", yaw_pose(0.12, tx=-0.3, tz=0.2), "pinhole"),
        ("spherical", yaw_pose(0.0), "spherical"),
    ]
    torch.cuda.synchronize()
    cuda_build.launch_counts.clear()
    outputs = [render_fn.render(c2w, K, cm) for _, c2w, cm in requests]
    images = [render_fn(c2w, K, cm) for _, c2w, cm in requests[:1]]
    torch.cuda.synchronize()
    counts = dict(cuda_build.launch_counts)
    log(f"  launch counts on the serving path: {counts}")
    n_renders = len(requests) + len(images)
    require(counts.get("stream_fwd", 0) == n_renders,
            f"stream_fwd launched {counts.get('stream_fwd', 0)} times "
            f"for {n_renders} renders")
    require(not counts.get("stream_bwd") and not counts.get("seg_reduce"),
            "serving launched a backward kernel")
    for (name, _, cm), (rgb, depth, a, info) in zip(requests, outputs):
        require(tuple(rgb.shape) == (H_SERVE, W_SERVE, 3), f"{name}: rgb shape")
        require(tuple(depth.shape) == (H_SERVE, W_SERVE, 1), f"{name}: depth shape")
        require(bool(torch.isfinite(rgb).all() & torch.isfinite(depth).all()),
                f"{name}: non-finite output")
        require(bool(((a >= 0) & (a <= 1)).all()), f"{name}: alpha outside [0, 1]")
        require(not bool(info["overflow"]), f"{name}: intersection overflow")
        log(f"  {name}: n_isect {int(info['n_isect'])}, mean alpha "
            f"{float(a.mean()):.4f}, mean rgb {float(rgb.mean()):.4f}")
    require(images[0].dtype == np.uint8 and images[0].shape == (H_SERVE, W_SERVE, 3),
            "served image")

    req_ms = {}
    for name, c2w, cm in requests:
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            render_fn.render(c2w, K, cm)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        req_ms[name] = statistics.median(times)
        log(f"  request {name}: median {req_ms[name]:.3f} ms over 7 "
            f"(host clock, synchronized) | {card}")
    for name, c2w, cm in (requests[0], requests[-1]):
        trace = device_trace(lambda: render_fn.render(c2w, K, cm), 5)
        if trace is None:
            log(f"  trace {name}: not measured (the profiler saw no device activity)")
        else:
            log(f"  trace {name} (torch.profiler, 5 requests): {trace[0]:.0f} device "
                f"activities per request, device busy {trace[1]:.3f} ms per request, "
                f"device idle share {trace[2]:.3f} of the traced window | {card}")
            for kname, n, ms in trace[3]:
                log(f"    {ms:.3f} ms, {n:.0f}x per request: {kname[:100]}")

    # per-layer split of the first pinhole request (CUDA events)
    rf = render_fn
    viewmat = invert_se3(torch.as_tensor(requests[0][1], device=dev)[None])
    Kt = torch.as_tensor(K, device=dev)[None]
    N = N_SERVE
    _, _, sgw, sgh = si.supertile_grid(W_SERVE, H_SERVE, 16)
    caps = si.StreamCaps.choose(N, 1, sgw * sgh)
    cfg = sr.StreamCfg.from_caps(caps, W_SERVE, H_SERVE, 16, 1, N)
    layers = {"projection": [], "isect build + pack": [], "kernel": [],
              "assembly": []}
    for _ in range(7):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        proj = project_gaussians(rf.means, rf.quats, rf.scales, rf.opacities,
                                 viewmat, Kt, W_SERVE, H_SERVE,
                                 sh_coeffs=rf.colors, sh_degree=SH_SERVE)
        ev[1].record()
        isect = si.build_stream_intersections(proj, W_SERVE, H_SERVE, 16, caps)
        packed = si.pack_stream(si.build_fields(proj), isect, caps)
        ev[2].record()
        out = sr.stream_fwd(cfg, isect.st_starts, packed)
        ev[3].record()
        rgb, a, d = sr.stream_to_image(cfg, out)
        img = torch.cat([rgb, d / torch.clamp(a, min=1e-10)], dim=-1)
        ev[4].record()
        torch.cuda.synchronize()
        for i, key in enumerate(layers):
            layers[key].append(ev[i].elapsed_time(ev[i + 1]))
    require(bool(torch.isfinite(img).all()), "layer split output")
    log("  layers (median of 7, CUDA events): " + ", ".join(
        f"{k} {statistics.median(v):.3f} ms" for k, v in layers.items()))

    # the kernel at the main path's inputs: vs plain, time, bound, memory
    st = isect.st_starts
    err, out_k, _ = compare_fwd("serving 1M pinhole", cfg, st, packed)
    max_err["stream_fwd"] = max(max_err["stream_fwd"], err)
    # the spherical request's pose is the identity, as the scene's viewmat
    cfg_s, st_s, packed_s, _ = stream_inputs(dict(sc, camera_model="spherical"), dev)
    max_err["stream_fwd"] = max(max_err["stream_fwd"], compare_fwd(
        "serving 1M spherical", cfg_s, st_s, packed_s)[0])
    kernel_ms = cuda_ms(lambda: sr.stream_fwd(cfg, st, packed), 20)
    plain_ms = cuda_ms(lambda: sr.stream_fwd_plain(cfg, st, packed), 1)
    n_isect = int(isect.n_isect)
    bytes_moved = n_isect * si.NF * 4 + (cfg.cs + 1) * 4 + out_k.numel() * 4
    pairs = gated_pairs(cfg, st, packed, out_k)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = pairs * OPS_PER_PAIR / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    rf.render(requests[0][1], K, "pinhole")
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    log(f"  stream_fwd at 1M/720p: {kernel_ms:.4f} ms (CUDA events, 20 launches); "
        f"plain version {plain_ms:.1f} ms; bound {bound_ms:.4f} ms by {bound_by} "
        f"({bytes_moved / 1e6:.1f} MB, {pairs / 1e6:.1f} M pixel-slot pairs); "
        f"render peak memory above the parameters {peak_mib:.0f} MiB | {card}")

    fwd_row = {
        "name": "stream_fwd",
        "route": "cuda",
        "source": "splat_one_tpu_torch/csrc/stream_fwd.cu",
        "replaces": "splat_one_tpu/ops/stream_raster.py:302",
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    del params, alive, render_fn, outputs, proj, isect, packed, out_k
    torch.cuda.empty_cache()

    rows = training_phase(dev, card, sc, max_err)
    kernels = [dict(fwd_row, launches=rows["launches"].get("stream_fwd", 0),
                    max_abs_err=max_err["stream_fwd"])] + rows["kernels"]

    # phase 6: the kernels line, the card line, the result line
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
