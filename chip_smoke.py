"""GPU smoke run of the PyTorch/CUDA port (splat_one_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every kernel in splat_one_tpu_torch/csrc (nvcc,
     sm_90a), timed, with ptxas register and shared-memory use;
  3. kernel vs plain version on the card: small pinhole, spherical,
     edge-partial and empty scenes and a 100k-gaussian 640x480 scene;
     the kernel path against the dense oracle on a small scene;
  4. serving at full width: the 1M-gaussian, SH degree 3, 1280x720
     scene of bench.py (seed 0) through params_from_numpy ->
     make_render_fn, three pinhole and one spherical request; launch
     counts, output checks, per-request and per-layer times, peak memory;
     the kernel against its plain version at these inputs;
  5. the kernels line (JSON), then the card line, then the result line.
"""

import json
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

KERNEL_TOL = 1e-5  # kernel vs plain: max abs err <= tol * max(1, max|plain|)
ORACLE_ATOL = 1e-4  # renders vs the dense oracle
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
OPS_PER_PAIR = 26  # f32 operations per evaluated (pixel, slot) pair, exp as one
N_SERVE, W_SERVE, H_SERVE, SH_SERVE = 1_000_000, 1280, 720, 3


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

    # phase 3: kernel vs plain version, and vs the oracle
    log("phase 3: stream_fwd kernel vs plain version")
    scenes = {
        "pinhole": stream_scene(),
        "spherical": stream_scene(spherical=True),
        "edge-partial 40x24": stream_scene(n=200, c=1, w=40, h=24),
        "empty": empty_scene(),
        "100k 640x480": bench_scene(100_000, 640, 480, 500.0, -5.5, -4.0, seed=1),
    }
    max_err = 0.0  # kernel vs plain, over every comparison of this run
    for name, sc in scenes.items():
        cfg, st, packed, _ = stream_inputs(sc, dev)
        max_err = max(max_err, compare_fwd(name, cfg, st, packed)[0])
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
    log(f"  launch counts on the main path: {counts}")
    n_renders = len(requests) + len(images)
    require(counts.get("stream_fwd", 0) == n_renders,
            f"stream_fwd launched {counts.get('stream_fwd', 0)} times "
            f"for {n_renders} renders")
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
    max_err = max(max_err, err)
    # the spherical request's pose is the identity, as the scene's viewmat
    cfg_s, st_s, packed_s, _ = stream_inputs(dict(sc, camera_model="spherical"), dev)
    max_err = max(max_err, compare_fwd("serving 1M spherical", cfg_s, st_s, packed_s)[0])
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

    # phase 5: the kernels line, the card line, the result line
    kernels = [{
        "name": "stream_fwd",
        "route": "cuda",
        "source": "splat_one_tpu_torch/csrc/stream_fwd.cu",
        "replaces": "splat_one_tpu/ops/stream_raster.py:302",
        "launches": counts.get("stream_fwd", 0),
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
