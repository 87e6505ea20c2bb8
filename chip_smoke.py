"""GPU smoke run of the PyTorch/CUDA port (splat_one_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every kernel in splat_one_tpu_torch/csrc (nvcc,
     sm_90a, one process per source, all at once), timed, with ptxas
     register, shared-memory and spill figures per kernel; the forward
     and backward compositing kernels must not spill;
  3. kernels vs plain versions on the card: small pinhole, spherical,
     edge-partial and empty scenes, a deep-stack scene (a supertile of 12
     chunks whose tiles stop after 12, 1, 7 and 0 of them), a crowded
     spherical scene (a supertile of 36 chunks across the azimuth seam,
     its tiles stopping after 1, 16 and 28 of them and one never) and a
     100k-gaussian 640x480 scene, for the stream forward, backward (with
     and without absgrad), keyed_perm and segmented-reduce kernels and
     (3b) the tiled forward and backward kernels and the tiled reduction
     on the same scenes' per-tile layouts and the seg_broadcast kernel on
     their stream builds and a ragged random problem; the forward kernels give their plain versions' bits (with
     each input's blocks: the tiles that composite a chunk and the
     longest tiles' chunks); each backward kernel launched twice gives the
     same bits; the
     stream and tiled paths' renders and end-to-end gradients against the
     dense oracle and against each other on small scenes;
  4. serving at full width: the 1M-gaussian, SH degree 3, 1280x720
     scene of bench.py (seed 0) through params_from_numpy ->
     make_render_fn, three pinhole and one spherical request; launch
     counts, output checks, per-request and per-layer times, peak memory;
     the forward kernel against its plain version at the pinhole front
     and spherical inputs, its time and bound at both;
     (4b) the same scene through rasterization(impl="tiled"), pinhole
     front and spherical, against the stream render: layer split, the
     tiled forward kernel vs its plain version, time and bound at both
     poses, memory;
  5. training at full width: (a) bench.py's fwd+bwd step on the same
     scene (loss sum(render) + sum(alpha), gradients into all five
     inputs): step time, Mpix/s, per-layer times, device trace, peak
     memory, launch counts, both backward kernels against their plain
     versions at these inputs (stream_bwd with and without absgrad), the
     reduction of its rows (keyed_perm and seg_reduce bit for bit, with
     and without absgrad; the path's time beside the keyed-row selection
     + index_add_ and the parent's sort and gather; each kernel's device
     time and bound); (a-i) the same step through impl="tiled", its
     gradients against the stream step's, the tiled backward kernel and
     the tiled reduction at these inputs; (a-ii) the stream build under
     SPLAT_SEG_BROADCAST=cond with the observed window: the layout equal
     to the default build's, the seg_broadcast kernel launched with no
     fallback, its device time and bound, the kernel path beside the
     default expansion in turns; (b) the port's
     Trainer, 1M random-init gaussians at 1280x720, SH degree 3, GT
     rendered by the port from 200k gaussians seen by 8 ring cameras,
     with a densification refine in its 6 steps, and its checkpoint
     served back through the viewer's loader; (c) the same Trainer with
     raster_impl="tiled", 4 steps and a refine, its first loss against
     (b)'s; (d) make_synthetic_scene on the card (its defaults, the
     surface rings, spherical), its tiled GT against the stream render;
  6. the kernels line (JSON; the forward rows also carry spherical_ms and
     spherical_bound_ms; the seg_reduce row is the stream reduction path,
     with its kernel's and its tiled launch's figures beside), then the
     card line, then the result line.
"""

import contextlib
import dataclasses
import json
import os
import re
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
# with absgrad). The kernels' sums over pixels spend, per 64-pixel warp and
# slot, 15 shuffles and up to 22 selects beside the adds: their own
# overhead, not work the function needs, so not in the bound.
OPS_PER_PAIR_BWD = 55
N_SERVE, W_SERVE, H_SERVE, SH_SERVE = 1_000_000, 1280, 720, 3
N_GT, N_VIEWS, TRAIN_STEPS = 200_000, 8, 6
TRAIN_CAPACITY = 1_048_576  # the Trainers' splat buffers (phases 5b, 5c)
TILED_STEPS = 4  # phase 5c
REL_RENDER, REL_GRAD = 1e-5, 5e-4  # stream vs tiled (tests/test_stream_raster.py)
NO_SPILL = ("stream_fwd", "stream_bwd", "tile_fwd", "tile_bwd")  # held to 0 B of spill


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


def ptxas_entries(text):
    """[(kernel, registers, spill stores B, spill loads B, the rest of the
    "Used ..." line)] for each entry function in nvcc's -Xptxas -v output."""
    out, kern, spill = [], "?", (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)(ILb([01])E)?", m.group(1))
            kern = (k.group(1) + {None: "", "0": "<false>", "1": "<true>"}[k.group(3)]
                    if k else m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m:
            out.append((kern, int(m.group(1)), *spill, m.group(2).strip(", ")))
    return out


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


def deep_stack_scene(seed=0):
    """Long streams whose tiles stop at different chunks (also the scene of
    the backward kernels' gpu tests, tests/test_torch_stream_raster.py).
    96x32 px, one pinhole camera,
    three supertiles. Supertile 0: tile 0 a deep stack (1,100 small
    translucent gaussians over every depth, its right columns uncovered, so
    it never terminates: 12 chunks), tile 1 40 gaussians in front of all
    the others (chunk 0 only), tile 2 300 in the front of the depths, tile
    3 none. Supertile 2: 600 wide near-opaque gaussians that saturate its
    tiles after 2 of its 6 chunks; supertile 1 sees their tails. On the
    tiled path tile 0 holds 9 chunks."""
    rng = np.random.default_rng(seed)
    f, w, h = 60.0, 96, 32
    groups = [  # count, u range, v range (px), depth range, sigma (px), opacity
        (1100, (3, 11), (3, 11), (3.0, 5.0), (0.6, 1.2), (0.1, 0.4)),
        (40, (20, 28), (4, 12), (2.0, 2.5), (0.6, 1.2), (0.1, 0.4)),
        (300, (4, 12), (20, 28), (3.0, 3.8), (0.6, 1.2), (0.1, 0.4)),
        (600, (62, 98), (-2, 34), (3.0, 5.0), (3.0, 5.0), (0.8, 0.95)),
    ]
    means, scales, opac = [], [], []
    for n, ur, vr, zr, sr, orng in groups:
        u, v, z = rng.uniform(*ur, n), rng.uniform(*vr, n), rng.uniform(*zr, n)
        means.append(np.stack([(u - w / 2) * z / f, (v - h / 2) * z / f, z], 1))
        scales.append(np.repeat((rng.uniform(*sr, n) * z / f)[:, None], 3, 1))
        opac.append(rng.uniform(*orng, n))
    means = np.concatenate(means).astype(np.float32)
    n = means.shape[0]
    return dict(means=means, quats=np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
                scales=np.concatenate(scales).astype(np.float32),
                opac=np.concatenate(opac).astype(np.float32),
                colors=rng.uniform(size=(n, 3)).astype(np.float32),
                viewmats=np.eye(4, dtype=np.float32)[None],
                Ks=np.float32([[[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]]),
                w=w, h=h, camera_model="pinhole")


def crowded_spherical_scene(seed=0):
    """A spherical view of a compact cluster (also the scene of the forward
    kernels' gpu tests, tests/test_torch_stream_raster.py): 128x64 px, the
    identity camera, the cluster behind it (azimuth +-180 deg), so that it
    straddles the azimuth seam (u = 0 = 128 px). Supertile 0 holds 36
    chunks; its tile 0 saturates in chunk 0 (600 wide near-opaque
    gaussians in front), tile 1 never terminates (2,400 small translucent
    ones over every depth, its right columns uncovered), tiles 2 and 3
    saturate after 16 and 28 chunks (opaque layers at the middle and the
    back of the depths); 400 translucent ones cross the seam. On the tiled
    path tile 0 stops after 1 of its 19 chunks and tile 1 runs all 27."""
    rng = np.random.default_rng(seed)
    w, h = 128, 64
    groups = [  # count, u range, v range (px), radial depth range, sigma (px), opacity
        (600, (-1, 17), (-1, 17), (2.0, 2.6), (2.0, 3.0), (0.8, 0.95)),
        (2400, (17, 27), (2, 14), (2.0, 6.0), (0.5, 1.0), (0.05, 0.2)),
        (600, (-1, 17), (15, 33), (3.6, 4.0), (2.0, 3.0), (0.8, 0.95)),
        (600, (15, 33), (15, 33), (5.0, 5.4), (2.0, 3.0), (0.8, 0.95)),
        (400, (-6, 6), (18, 30), (2.0, 6.0), (1.0, 2.5), (0.1, 0.3)),
    ]
    means, scales, opac = [], [], []
    for n, ur, vr, rr, sr, orng in groups:
        u, v, r = rng.uniform(*ur, n), rng.uniform(*vr, n), rng.uniform(*rr, n)
        lon = (u / w - 0.5) * 2 * np.pi  # the port's equirectangular mapping
        lat = (0.5 - v / h) * np.pi
        means.append(np.stack([r * np.cos(lat) * np.sin(lon), -r * np.sin(lat),
                               r * np.cos(lat) * np.cos(lon)], 1))
        scales.append(np.repeat((rng.uniform(*sr, n) * 2 * np.pi / w * r)[:, None], 3, 1))
        opac.append(rng.uniform(*orng, n))
    means = np.concatenate(means).astype(np.float32)
    n = means.shape[0]
    f = w / (2 * np.pi)
    return dict(means=means, quats=np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
                scales=np.concatenate(scales).astype(np.float32),
                opac=np.concatenate(opac).astype(np.float32),
                colors=rng.uniform(size=(n, 3)).astype(np.float32),
                viewmats=np.eye(4, dtype=np.float32)[None],
                Ks=np.float32([[[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]]),
                w=w, h=h, camera_model="spherical")


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


# ------------------------------------------------------- tiled helpers
def project(sc, dev):
    """Project a scene dict on ``dev``."""
    import torch
    from splat_one_tpu_torch.ops.projection import project_gaussians

    t = lambda x: torch.as_tensor(x, device=dev)
    kw = (dict(sh_coeffs=t(sc["sh"]), sh_degree=3 if sc["sh"].shape[1] == 16 else 1)
          if "sh" in sc else dict(colors=t(sc["colors"])))
    return project_gaussians(t(sc["means"]), t(sc["quats"]), t(sc["scales"]),
                             t(sc["opac"]), t(sc["viewmats"]), t(sc["Ks"]),
                             sc["w"], sc["h"], camera_model=sc["camera_model"], **kw)


def tile_inputs(sc, proj):
    """The gen-1 layout of a projected scene at IsectCaps.choose defaults
    -> (cfg, tile_starts, packed, isect)."""
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops.tile_raster import RasterCfg

    C, N = proj.depths.shape
    w, h = sc["w"], sc["h"]
    caps = itx.IsectCaps.choose(N, C, (-(-w // 16)) * (-(-h // 16)))
    isect = itx.build_intersections(proj, w, h, 16, caps, camera_model=sc["camera_model"])
    require(not bool(isect.overflow), "tiled layout overflow")
    cfg = RasterCfg(width=w, height=h, tile_size=16, num_cameras=C, num_gaussians=N,
                    chunk=caps.chunk, align_cap=caps.align_cap,
                    wrap_x=(sc["camera_model"] == "spherical"))
    packed = itx.pack_fields(proj.means2d, proj.conics, proj.colors, proj.opacities,
                             proj.depths, isect)
    return cfg, isect.tile_starts, packed, isect


def timed_once(fn):
    """(fn(), its ms by CUDA events) for one call."""
    import torch

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def compare_tile_fwd(name, cfg, starts, packed):
    """tile_fwd kernel vs its plain version, every output bit for bit ->
    (max abs err, kernel out, plain ms)."""
    import torch
    from splat_one_tpu_torch.ops import tile_raster as tr

    out_k = tr.tile_fwd(cfg, starts, packed)
    out_p, plain_ms = timed_once(lambda: tr.tile_fwd_plain(cfg, starts, packed))
    worst = column_err(name, "tile_fwd", out_k[:, :5].transpose(0, 1).reshape(5, -1).T,
                       out_p[:, :5].transpose(0, 1).reshape(5, -1).T)
    require(bool(torch.equal(out_k, out_p)), f"{name}: tile_fwd differs from its plain "
            f"version (max abs err {worst:.3e}; n_chunks equal: "
            f"{bool(torch.equal(out_k[:, tr.CH_NCHUNKS], out_p[:, tr.CH_NCHUNKS]))})")
    log(f"  {name}: tile_fwd {fwd_blocks_line('tile_fwd', cfg, starts, out_k)}")
    return worst, out_k, plain_ms


def compare_tile_bwd(name, cfg, starts, packed, out, gout):
    """tile_bwd kernel vs its plain version, and a second launch bit for
    bit -> (max abs err, kernel rows, plain ms)."""
    import torch
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import tile_raster as tr

    pg_k = tr.tile_bwd(cfg, starts, packed, out, gout)
    require(bool(torch.equal(pg_k, tr.tile_bwd(cfg, starts, packed, out, gout))),
            f"{name}: two tile_bwd launches differ")
    pg_p, plain_ms = timed_once(lambda: tr.tile_bwd_plain(cfg, starts, packed, out, gout))
    require(not bool(pg_k[:, itx.N_GROWS:].any()), f"{name}: tile_bwd pad columns")
    return column_err(name, "tile_bwd", pg_k, pg_p), pg_k, plain_ms


def tile_work(cfg, out):
    """(chunks processed over all tiles, (pixel, slot) pairs): every slot of
    a processed chunk is evaluated at all 256 pixels, in the forward and
    in the backward's replay alike."""
    from splat_one_tpu_torch.ops import tile_raster as tr

    n_chunks = int(out[:, tr.CH_NCHUNKS, 0].sum())
    return n_chunks, n_chunks * cfg.chunk * cfg.npix


def tile_fwd_pairs(cfg, starts, packed, out):
    """(pixel, slot) pairs tile_fwd evaluates: the rows of every tile's
    processed chunks whose opacity is not below ALPHA_MIN / 2 (the kernel
    skips the others, padding rows included), times 256 pixels."""
    import torch
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import tile_raster as tr
    from splat_one_tpu_torch.ops.reference import ALPHA_MIN

    s0 = starts[:-1].long()
    ends = s0 + out[:, tr.CH_NCHUNKS, 0].long() * cfg.chunk
    edges = torch.zeros(packed.shape[0] + 1, dtype=torch.long, device=packed.device)
    edges.index_add_(0, s0, torch.ones_like(s0))
    edges.index_add_(0, ends, -torch.ones_like(ends))
    processed = torch.cumsum(edges, 0)[:-1] > 0  # the tiles' ranges are disjoint
    live = ~(packed[:, itx.ROW_OPAC] < 0.5 * ALPHA_MIN)
    return int((processed & live).sum()) * cfg.npix


def seg_broadcast_problem(proj, w, h, camera_model):
    """The stream builder's expansion problem for a projection:
    ((sx0, sy0, span, ka, offsets, depth, counts), its SlotGrid), as
    stream_isect.build_stream_intersections hands it to seg_broadcast."""
    import torch
    from splat_one_tpu_torch.ops import seg_broadcast as sgb
    from splat_one_tpu_torch.ops import stream_isect as si

    C, N = proj.depths.shape
    _, _, sw, sh = si.supertile_grid(w, h, 16)
    sx0, span_x, sy0, span_y = si.parent_spans(proj, w, h, 16, si.SS, camera_model)
    counts = span_x * span_y
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    prob = (sx0, sy0, torch.clamp(span_x, min=1), torch.zeros_like(counts), offsets,
            proj.depths.reshape(-1), counts)
    return prob, sgb.SlotGrid(n=N, sw=sw, ns=sw * sh, cs=C * sw * sh,
                              wrap=camera_model == "spherical")


def compare_seg_broadcast(name, prob, grid, exp_cap, slab):
    """seg_broadcast kernel vs its plain version (every slot's key and
    owner equal) and, where every window covers its chunk, the kernel path
    vs the default path on the live slots -> (plain ms, covered)."""
    import torch
    from splat_one_tpu_torch.ops import seg_broadcast as sgb

    okv, pbases, offs_pad = sgb.coverage_windows(prob[4], prob[6], exp_cap, slab)
    args = (*prob[:4], prob[5], offs_pad, pbases, exp_cap, grid, slab)
    key_k, g_k = sgb.expand_parent_meta(*args)
    (key_p, g_p), plain_ms = timed_once(lambda: sgb.expand_parent_meta_plain(*args))
    require(bool(torch.equal(key_k, key_p)) and bool(torch.equal(g_k, g_p)),
            f"{name}: seg_broadcast kernel vs plain differ")
    covered = bool(okv.all())
    n_live = min(int(prob[4][-1] + prob[6][-1]), exp_cap)
    if covered:
        got = sgb.expand_slots(*prob, exp_cap, grid, "kernel", slab)
        want = sgb.expand_slots(*prob, exp_cap, grid, "xla")
        for g, w_, col in zip(got, want, ("key", "parent")):
            require(bool(torch.equal(g[:n_live].long(), w_[:n_live].long())),
                    f"{name}: seg_broadcast {col} differs from the default expansion")
    log(f"  {name}: seg_broadcast kernel equal to its plain version over {key_k.shape[0]} "
        f"slots (slab {slab}); {'kernel path equal to the default expansion on the ' + str(n_live) + ' live slots' if covered else 'a window does not cover its chunk'}")
    return plain_ms, covered


@contextlib.contextmanager
def seg_broadcast_path(value):
    """SPLAT_SEG_BROADCAST set to ``value`` (None: unset) inside the block."""
    old = os.environ.pop("SPLAT_SEG_BROADCAST", None)
    if value is not None:
        os.environ["SPLAT_SEG_BROADCAST"] = value
    try:
        yield
    finally:
        os.environ.pop("SPLAT_SEG_BROADCAST", None)
        if old is not None:
            os.environ["SPLAT_SEG_BROADCAST"] = old


def ragged_problem(dev, mp=300_000, seed=3):
    """tests/test_seg_broadcast.py's ragged runs at scale: counts 1-8, a
    third of the parents with none, random metadata and depths."""
    import torch

    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 9, size=mp)
    counts[rng.uniform(size=mp) < 0.35] = 0
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cols = [rng.integers(0, 40, mp), rng.integers(0, 23, mp), rng.integers(1, 6, mp),
            rng.integers(0, 1000, mp), offsets]
    depth = (rng.normal(size=mp) * 37.3 + 5).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=dev)
    return tuple(t(c).long() for c in cols) + (t(depth), t(counts).long())


def stream_vs_tiled(dev):
    """The port's two rasterizer paths on the small pinhole and spherical
    scenes (tests/test_stream_raster.py::test_stream_matches_tiled): loss
    and renders within REL_RENDER, every input gradient within REL_GRAD."""
    import torch
    from splat_one_tpu_torch.render.rasterization import rasterization

    names = ("means", "quats", "scales", "opac", "colors")
    for spherical in (False, True):
        sc = stream_scene(spherical=spherical)
        res = {}
        for impl in ("stream", "tiled"):
            leaves = [torch.tensor(sc[k], device=dev, requires_grad=True) for k in names]
            vm, K = (torch.as_tensor(sc[k], device=dev) for k in ("viewmats", "Ks"))
            render, alpha, info = rasterization(*leaves, vm, K, sc["w"], sc["h"],
                                                render_mode="RGB+ED",
                                                camera_model=sc["camera_model"], impl=impl)
            require(not bool(info["overflow"]), f"{impl} overflow")
            wts = torch.linspace(0.5, 1.5, render.numel(), device=dev).reshape(render.shape)
            loss = (render * wts).sum() + 0.3 * alpha.sum()
            res[impl] = (float(loss.detach()), render.detach(), alpha.detach(),
                         torch.autograd.grad(loss, leaves))
        (l_s, r_s, a_s, g_s), (l_t, r_t, a_t, g_t) = res["stream"], res["tiled"]
        rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-8))
        errs = [abs(l_s - l_t) / abs(l_t), rel(r_s, r_t), rel(a_s, a_t)]
        require(max(errs) < REL_RENDER, f"{sc['camera_model']}: stream vs tiled {errs}")
        gerr = [rel(x, y) for x, y in zip(g_s, g_t)]
        require(max(gerr) < REL_GRAD, f"{sc['camera_model']}: stream vs tiled grads {gerr}")
        log(f"  stream vs tiled, {sc['camera_model']} 64x48: loss/render/alpha rel "
            f"{max(errs):.2e} (bar {REL_RENDER}), gradients rel {max(gerr):.2e} "
            f"(bar {REL_GRAD})")


def tiled_kernel_checks(scenes, dev, max_err):
    """Phase 3b (see the module docstring)."""
    import torch
    from splat_one_tpu_torch.ops import seg_broadcast as sgb
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.utils import cuda_build

    from splat_one_tpu_torch.ops import tile_raster as tr

    log("phase 3b: tile_fwd, tile_bwd, seg_reduce (tiled) and seg_broadcast kernels vs "
        "plain versions")
    for i, (name, sc) in enumerate(scenes.items()):
        proj = project(sc, dev)
        cfg, starts, packed, isect = tile_inputs(sc, proj)
        e_f, out_k, _ = compare_tile_fwd(name, cfg, starts, packed)
        rng = np.random.default_rng(10 + i)
        gout = torch.as_tensor(rng.normal(size=tuple(out_k.shape)).astype(np.float32),
                               device=dev)
        e_b, pg_k, _ = compare_tile_bwd(name, cfg, starts, packed, out_k, gout)
        e_r, _ = compare_tiled_reduction(name, pg_k, isect,
                                         cfg.num_cameras * cfg.num_gaussians)
        max_err["tile_fwd"] = max(max_err["tile_fwd"], e_f)
        max_err["tile_bwd"] = max(max_err["tile_bwd"], e_b)
        max_err["seg_reduce"] = max(max_err["seg_reduce"], e_r)
        log(f"  {name}: CT={cfg.ct}, n_isect {int(isect.n_isect)}, up to "
            f"{int(out_k[:, tr.CH_NCHUNKS, 0].max())} chunks a tile; tile_fwd abs err {e_f:.3e}, "
            f"n_chunks equal; tile_bwd abs err {e_b:.3e} over "
            f"{int((pg_k.abs().amax(1) > 0).sum())} written rows, two launches equal; "
            f"the tiled reduction equal to its plain version bit for bit")
        # seg_broadcast on the same scene's stream build
        C, N = proj.depths.shape
        _, _, sw, sh = si.supertile_grid(sc["w"], sc["h"], 16)
        caps = si.StreamCaps.choose(N, C, C * sw * sh)
        prob, grid = seg_broadcast_problem(proj, sc["w"], sc["h"], sc["camera_model"])
        compare_seg_broadcast(name, prob, grid, caps.exp_cap, caps.sb_slab)
        with seg_broadcast_path(None):
            want = si.build_stream_intersections(proj, sc["w"], sc["h"], 16, caps,
                                                 camera_model=sc["camera_model"])
        with seg_broadcast_path("cond"):
            fb = dict(cuda_build.launch_counts).get("seg_broadcast_fallback", 0)
            got = si.build_stream_intersections(proj, sc["w"], sc["h"], 16, caps,
                                                camera_model=sc["camera_model"])
            require(dict(cuda_build.launch_counts).get("seg_broadcast_fallback", 0) == fb,
                    f"{name}: seg_broadcast fell back")
        for f in want._fields:
            require(bool(torch.equal(getattr(got, f), getattr(want, f))),
                    f"{name}: stream layout field {f} differs under SPLAT_SEG_BROADCAST=cond")
        torch.cuda.synchronize()
    prob = ragged_problem(dev)
    n_isect = int(prob[4][-1] + prob[6][-1])
    exp_cap = -(-(n_isect + 2048) // 1024) * 1024
    slab = sgb.required_slab(prob[4], prob[6], exp_cap)
    # 100,000 parents a camera, 41 supertiles a row, the past-the-total id
    # far above the rest
    grid = sgb.SlotGrid(n=100_000, sw=41, ns=41 * 23, cs=1 << 20, wrap=False)
    for g in (grid, grid._replace(wrap=True)):
        _, covered = compare_seg_broadcast(
            f"ragged {prob[0].shape[0]} parents, zero-count runs, wrap {g.wrap}", prob, g,
            exp_cap, slab)
    require(covered and slab < sgb.SLAB, f"ragged problem: slab {slab}, covered {covered}")
    max_err["seg_broadcast"] = 0.0  # every comparison above is exact equality
    stream_vs_tiled(dev)


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
    require(bool(torch.equal(out_k, out_p)), f"{name}: stream_fwd differs from its plain "
            "version")
    log(f"  {name}: CS={cfg.cs} " + "; ".join(parts) + "; every output bit equal; "
        + fwd_blocks_line("stream_fwd", cfg, st_starts, out_k))
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


def fwd_blocks_line(name, cfg, starts, out):
    """How a forward input spreads over the kernel's blocks, from its output
    (name "stream_fwd" or "tile_fwd"): the supertiles (stream) and tiles
    that composite a chunk, the longest tiles' chunks and all the chunks
    composited."""
    import torch

    G = cfg.chunk
    s = starts.long()
    if name == "stream_fwd":
        nch = out[:, :, 5, 0].long()  # [CS, NT]
        base0 = torch.div(s[:-1], G, rounding_mode="floor") * G
        stream = -torch.div(base0 - s[1:], G, rounding_mode="floor")
        head = (f"{int((nch.amax(-1) > 0).sum())} of {cfg.cs} supertiles (the longest "
                f"stream {int(stream.max()) if stream.numel() else 0} chunks), ")
    else:
        nch = out[:, 5, 0].long()
        head = ""
    top = torch.sort(nch.flatten(), descending=True).values[:4].tolist()
    return (f"{head}{int((nch > 0).sum())} of {nch.numel()} tiles composite a chunk; the "
            f"longest tiles {', '.join(map(str, top))} chunks; {int(nch.sum())} tile-chunks")


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


# the launches of keyed_perm (csrc/keyed_perm.cu), by kernel name
KEYED_PERM_KERNELS = ("count_kernel", "scan_totals_kernel", "scan_top_kernel",
                      "scan_write_kernel", "place_kernel", "rank_kernel")


def device_ms(fn, iters, names=None):
    """Device time per call of ``fn`` (torch.profiler over ``iters``
    calls): the summed durations of its device activities whose name holds
    one of ``names`` (all of them for None). For a kernel shorter than its
    wrapper's host work, back-to-back CUDA events time the host; this times
    the kernel. None where the profiler saw no such activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and (names is None or any(n in e.name for n in names)))
    return us / iters / 1e3 if us else None


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
    exactly, gradient columns within KERNEL_TOL; a second launch bit for
    bit), then the reduction of the kernel's rows: keyed_perm and the
    segmented reduce kernel each bit for bit against their plain versions.
    Returns (max abs err bwd, max abs err reduce, kernel rows, perm,
    bounds)."""
    import torch
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.ops import stream_raster as sr

    pg_k = sr.stream_bwd(cfg, st_starts, st_starts_al, packed, out, gout)
    require(bool(torch.equal(pg_k, sr.stream_bwd(cfg, st_starts, st_starts_al, packed,
                                                 out, gout))),
            f"{name}: two stream_bwd launches differ")
    torch.cuda.synchronize()
    pg_p = sr.stream_bwd_plain(cfg, st_starts, st_starts_al, packed, out, gout)
    torch.cuda.synchronize()
    require(bool(torch.equal(pg_k[:, si.GCOL_KEY:], pg_p[:, si.GCOL_KEY:])),
            f"{name}: backward key / pad columns differ")
    e_bwd = column_err(name, "backward", pg_k[:, :si.GCOL_KEY], pg_p[:, :si.GCOL_KEY])
    n_payload = si.N_GCOLS if cfg.absgrad else si.GCOL_ABSDX
    e_red, perm, bounds = compare_stream_reduction(name, pg_k, m0, n_payload)
    n_rows = int((pg_k[:, si.GCOL_KEY] > 0).sum())
    log(f"  {name}: stream_bwd (absgrad {cfg.absgrad}) abs err {e_bwd:.3e} over "
        f"{n_rows} keyed rows, key column equal, two launches equal; keyed_perm and "
        f"seg_reduce equal to their plain versions bit for bit over {m0} gaussians")
    return e_bwd, e_red, pg_k, perm, bounds


def compare_stream_reduction(name, pg, m0, n_payload):
    """The stream reduction of the backward's rows ``pg``: keyed_perm and
    seg_reduce kernels against their plain versions, every output bit
    for bit, and the path (reduce_stream_grads) equal to them ->
    (max abs err, perm, bounds)."""
    import torch
    from splat_one_tpu_torch.ops import seg_reduce as sgr
    from splat_one_tpu_torch.ops import stream_isect as si

    perm, bounds = sgr.keyed_perm(pg, m0)
    red_k = sgr.segment_reduce_rows(pg, perm, bounds, n_payload)
    perm_p, bounds_p = sgr.keyed_perm_plain(pg, m0)
    require(bool(torch.equal(bounds, bounds_p))
            and bool(torch.equal(perm[:perm_p.shape[0]], perm_p)),
            f"{name}: keyed_perm differs from its plain version")
    red_p = sgr.segment_reduce_plain(pg, perm_p, bounds_p, n_payload)
    e_red = column_err(name, "seg_reduce", red_k.T, red_p.T)
    require(bool(torch.equal(red_k, red_p)), f"{name}: seg_reduce differs from its plain "
            f"version (max abs err {e_red:.3e})")
    require(bool(torch.equal(si.reduce_stream_grads(pg, m0, n_payload), red_k)),
            f"{name}: reduce_stream_grads differs from its kernels")
    return e_red, perm, bounds


def compare_tiled_reduction(name, pg, isect, m0):
    """gather_reduction (the seg_reduce kernel through rank_perm, written at
    rank_src) against the plain version, bit for bit -> (max abs err,
    plain ms)."""
    import torch
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import seg_reduce as sgr

    got = itx.gather_reduction(pg, isect, m0)
    want, plain_ms = timed_once(lambda: sgr.segment_reduce_plain(
        pg, isect.rank_perm, isect.rank_bounds, itx.N_GROWS, out_index=isect.rank_src))
    err = column_err(name, "seg_reduce (tiled)", got.T, want.T)
    require(bool(torch.equal(got, want)), f"{name}: tiled seg_reduce differs from its "
            f"plain version (max abs err {err:.3e})")
    return err, plain_ms


def oracle_grad_check(dev, impl="stream"):
    """End-to-end gradients through the kernels of ``impl`` vs the dense
    oracle by autograd: tests/test_rasterizer.py::TestGradParity (150
    gaussians, seed 7, 64x64, SH degree 1, random weights on rgb, alpha and
    expected depth), each gradient within GRAD_RTOL of its max."""
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
                                             sh_degree=1, render_mode="RGB+ED", impl=impl)
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
    log(f"  oracle 64x64 (150 gaussians) end-to-end gradients, {impl} kernels vs "
        f"dense oracle by autograd: worst rel err {worst:.2e} (bar {GRAD_RTOL})")


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
    for k in ("stream_fwd", "stream_bwd", "keyed_perm", "seg_reduce"):
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
                              "bwd kernel", "keyed_perm kernel", "seg_reduce kernel",
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
        perm, bounds = sgr.keyed_perm(pg, N)
        ev[5].record()
        seg = sgr.segment_reduce_rows(pg, perm, bounds, n_pay)
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
    e_a, _, *_ = compare_bwd("training 1M pinhole, absgrad",
                             dataclasses.replace(cfg, absgrad=True), st, st_al, packed,
                             out, gout, N)
    e_b, e_r, pg_k, perm_k, bounds_k = compare_bwd(
        "training 1M pinhole", cfg, st, st_al, packed, out, gout, N)
    max_err["stream_bwd"] = max(max_err["stream_bwd"], e_a, e_b)
    max_err["seg_reduce"] = max(max_err["seg_reduce"], e_r)
    bwd_ms = cuda_ms(lambda: sr.stream_bwd(cfg, st, st_al, packed, out, gout), 10)
    bwd_abs_ms = cuda_ms(lambda: sr.stream_bwd(dataclasses.replace(cfg, absgrad=True), st,
                                               st_al, packed, out, gout), 10)
    bwd_plain_ms = cuda_ms(lambda: sr.stream_bwd_plain(cfg, st, st_al, packed, out, gout), 1)

    # the reduction from the backward's rows: the path (keyed_perm, then the
    # indexed seg_reduce), each kernel, the plain versions, and the yardsticks:
    # the keyed-row selection + index_add_ from the same rows (library_ms),
    # index_add_ over rows already selected, the stable torch.sort of the
    # key column that keyed_perm replaces, and the parent's composition
    # (sort_grad_rows: that sort and a gather of every row)
    keys = pg_k[:, si.GCOL_KEY].long()
    keyed = keys > 0
    keys_live, payload_live = keys[keyed] - 1, pg_k[keyed, :n_pay]
    key32 = pg_k[:, si.GCOL_KEY].to(torch.int32)

    def library_reduce():
        m = pg_k[:, si.GCOL_KEY] > 0
        acc = torch.zeros((N, n_pay), device=dev)
        return acc.index_add_(0, pg_k[m, si.GCOL_KEY].long() - 1, pg_k[m, :n_pay])

    def library_selected():
        acc = torch.zeros((N, n_pay), device=dev)
        return acc.index_add_(0, keys_live, payload_live)

    path_ms = cuda_ms(lambda: si.reduce_stream_grads(pg_k, N, n_pay), 20)
    path_dev = device_ms(lambda: si.reduce_stream_grads(pg_k, N, n_pay), 20)
    perm_ev = cuda_ms(lambda: sgr.keyed_perm(pg_k, N), 20)
    red_ev = cuda_ms(lambda: sgr.segment_reduce_rows(pg_k, perm_k, bounds_k, n_pay), 20)
    # the kernels' own device time: each is shorter than its wrapper's host work
    perm_ms = device_ms(lambda: sgr.keyed_perm(pg_k, N), 20,
                        KEYED_PERM_KERNELS) or perm_ev
    red_ms = device_ms(lambda: sgr.segment_reduce_rows(pg_k, perm_k, bounds_k, n_pay), 20,
                       ("seg_reduce_kernel",)) or red_ev
    lib_ms = cuda_ms(library_reduce, 20)
    lib_sel_ms = cuda_ms(library_selected, 20)
    sort_ms = cuda_ms(lambda: torch.sort(key32, stable=True), 20)
    copy_ms = cuda_ms(lambda: si.sort_grad_rows(pg_k, N), 10)
    perm_p, bounds_p = sgr.keyed_perm_plain(pg_k, N)
    perm_plain_ms = cuda_ms(lambda: sgr.keyed_perm_plain(pg_k, N), 3)
    red_plain_ms = cuda_ms(lambda: sgr.segment_reduce_plain(pg_k, perm_p, bounds_p, n_pay), 3)
    red_ref = si.reduce_stream_grads(pg_k, N, n_pay)
    srt, bounds0 = si.sort_grad_rows(pg_k, N)
    ident = torch.arange(srt.shape[0], dtype=torch.int32, device=dev)
    require(bool(torch.equal(red_ref, sgr.segment_reduce_rows(srt, ident, bounds0, n_pay))),
            "the reduction read in place differs from the sums over the sorted copy")
    del srt, ident
    lib_diff = max(float((library_reduce().T - red_ref).abs().max()),
                   float((library_selected().T - red_ref).abs().max()))
    # bounds count what this run's data needs: the chunks the tiles reached
    # (early termination leaves the rest of each stream unread and its
    # gradient rows unwritten) and, for the reduction, the keyed rows
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
    n_keyed = int(keyed.sum())
    # keyed_perm: the key column read (4 B a row), bounds and the keyed rows'
    # indices written; seg_reduce: the keyed rows' payload, their index
    # entries and the bounds read, the per-gaussian sums written; the path:
    # both, bounds and perm counted once as the kernel's output and input
    perm_bytes = cfg.pad_cap * 4 + (N + 1) * 4 + n_keyed * 4
    red_bytes = n_keyed * (n_pay + 1) * 4 + (N + 1) * 4 + n_pay * N * 4
    path_bytes = cfg.pad_cap * 4 + n_keyed * n_pay * 4 + n_pay * N * 4
    perm_bound = perm_bytes / HBM_BYTES_PER_S * 1e3
    red_bound = red_bytes / HBM_BYTES_PER_S * 1e3
    path_bound = path_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  stream_bwd at 1M/720p: {bwd_ms:.4f} ms (CUDA events, 10 launches; with "
        f"absgrad {bwd_abs_ms:.4f} ms); plain "
        f"version {bwd_plain_ms:.1f} ms; bound {bwd_bound:.4f} ms by {bwd_by} "
        f"({bwd_bytes / 1e6:.1f} MB over {n_chunks} chunks reached, {pairs / 1e6:.1f} M "
        f"pixel-slot pairs x {ops_per_pair} ops) | {card}")
    log(f"  the stream reduction at 1M/720p from the backward's rows ({n_keyed} keyed of "
        f"pad_cap {cfg.pad_cap}, {n_pay} columns): reduce_stream_grads {path_ms:.4f} ms "
        f"(CUDA events, 20 calls; device busy {path_dev or float('nan'):.4f} ms a call), "
        f"bound {path_bound:.4f} ms by bytes ({path_bytes / 1e6:.1f} MB), "
        f"{path_bound / path_ms:.3f} of it | {card}")
    log(f"  keyed_perm {perm_ms:.4f} ms (its kernels' device time, torch.profiler, 20 calls; "
        f"CUDA events through the wrapper {perm_ev:.4f} ms), bound {perm_bound:.4f} ms "
        f"({perm_bytes / 1e6:.1f} MB), plain {perm_plain_ms:.2f} ms, stable torch.sort of "
        f"the key column {sort_ms:.4f} ms; seg_reduce {red_ms:.4f} ms (device time; CUDA "
        f"events {red_ev:.4f} ms), bound {red_bound:.4f} ms ({red_bytes / 1e6:.1f} MB), "
        f"{red_bound / red_ms:.3f} of it, plain {red_plain_ms:.2f} ms | {card}")
    log(f"  yardsticks from the same rows: keyed-row selection + index_add_ {lib_ms:.4f} ms "
        f"(the path {'at or under' if path_ms <= lib_ms else 'ABOVE'} it); index_add_ over "
        f"the selected rows alone {lib_sel_ms:.4f} ms (max abs diff to the kernels "
        f"{lib_diff:.2e}); the parent's sort_grad_rows (sort + gather of every row) "
        f"{copy_ms:.4f} ms, its sums bit-equal to the path's | {card}")
    del proj, psg, g_split, pg, seg, pg_k, perm_k, bounds_k, keys, key32
    del keyed, keys_live, payload_live, red_ref, perm_p, bounds_p
    torch.cuda.empty_cache()
    tile_bwd_row, tiled_red = tiled_step_phase(dev, card, leaves, vm, Kt, grads, max_err)
    sb_row = seg_broadcast_phase(dev, card, leaves, vm, Kt, proj0, caps)
    del grads, leaves
    torch.cuda.empty_cache()

    # (b) the port's Trainer at full width
    log(f"phase 5b: Trainer, {N} random-init gaussians (capacity {TRAIN_CAPACITY}), SH 3, "
        f"{W}x{H}, {TRAIN_STEPS} steps; GT: {N_GT} gaussians, {N_VIEWS} ring views | {card}")
    t0 = time.perf_counter()
    scene = ring_scene(dev)
    log(f"  GT render of {N_VIEWS} views: {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        tcfg = Config(
            result_dir=tmp, camera_model="pinhole", sh_degree=3, batch_size=1,
            init_type="random", init_num_pts=N, capacity=TRAIN_CAPACITY,
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
        for k in ("stream_bwd", "keyed_perm", "seg_reduce"):
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
    del trainer, fn
    torch.cuda.empty_cache()

    tiled_counts = tiled_trainer_phase(dev, card, scene, losses[0])
    synthetic_phase(dev, card)
    tile_bwd_row["launches"] = tiled_counts.get("tile_bwd", 0)
    return {"launches": tcounts, "tiled_launches": tiled_counts,
            "tile_bwd": tile_bwd_row, "seg_broadcast": sb_row, "kernels": [
        dict(name="stream_bwd", route="cuda", source="splat_one_tpu_torch/csrc/stream_bwd.cu",
             replaces="splat_one_tpu/ops/stream_raster.py:397",
             launches=tcounts.get("stream_bwd", 0), max_abs_err=max_err["stream_bwd"],
             ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bwd_bound, bound_by=bwd_by,
             library_ms=None),
        # the stream reduction path from the backward's rows (keyed_perm, then
        # this kernel); kernel_* the kernel alone, tiled_* its tiled launch
        dict(name="seg_reduce", route="cuda", source="splat_one_tpu_torch/csrc/seg_reduce.cu",
             replaces="splat_one_tpu/ops/seg_reduce.py:67",
             launches=tcounts.get("seg_reduce", 0), max_abs_err=max_err["seg_reduce"],
             ms=path_ms, plain_ms=perm_plain_ms + red_plain_ms, bound_ms=path_bound,
             bound_by="bytes", library_ms=lib_ms, device_ms=path_dev, kernel_ms=red_ms,
             kernel_events_ms=red_ev, kernel_bound_ms=red_bound,
             library_selected_ms=lib_sel_ms,
             tiled_launches=tiled_counts.get("seg_reduce", 0), **tiled_red),
        dict(name="keyed_perm", route="cuda", source="splat_one_tpu_torch/csrc/keyed_perm.cu",
             replaces="splat_one_tpu/ops/stream_isect.py:543",
             launches=tcounts.get("keyed_perm", 0), max_abs_err=max_err["keyed_perm"],
             ms=perm_ms, plain_ms=perm_plain_ms, bound_ms=perm_bound, bound_by="bytes",
             library_ms=sort_ms, events_ms=perm_ev),
    ]}


# ------------------------------------------------------- tiled phases
def tiled_render_phase(dev, card, sc, max_err):
    """Phase 4b (see the module docstring). Returns the kernels-line row
    of tile_fwd without its launches."""
    import torch
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import tile_raster as tr
    from splat_one_tpu_torch.ops.projection import project_gaussians
    from splat_one_tpu_torch.render.rasterization import rasterization
    from splat_one_tpu_torch.utils import cuda_build

    W, H, N = W_SERVE, H_SERVE, N_SERVE
    caps = itx.IsectCaps.choose(N, 1, (-(-W // 16)) * (-(-H // 16)))
    log(f"phase 4b: tiled render, {N} gaussians, SH 3, {W}x{H}, impl='tiled' at "
        f"IsectCaps.choose defaults (exp_cap {caps.exp_cap}, align_cap {caps.align_cap}) "
        f"| {card}")
    t = lambda x: torch.as_tensor(x, device=dev)
    g = [t(sc[k]) for k in ("means", "quats", "scales", "opac", "sh")]
    vm, K = t(sc["viewmats"]), t(sc["Ks"])
    inputs = {}
    with torch.no_grad():
        for cm in ("pinhole", "spherical"):
            cuda_build.launch_counts.clear()
            render_t, alpha_t, info = rasterization(*g, vm, K, W, H, sh_degree=3,
                                                    render_mode="RGB+D", camera_model=cm,
                                                    impl="tiled")
            torch.cuda.synchronize()
            counts = dict(cuda_build.launch_counts)
            require(counts.get("tile_fwd", 0) == 1 and not counts.get("stream_fwd"),
                    f"{cm}: tiled render launches {counts}")
            require(not bool(info["overflow"]), f"{cm}: tiled render overflow")
            render_s, alpha_s, info_s = rasterization(*g, vm, K, W, H, sh_degree=3,
                                                      render_mode="RGB+D", camera_model=cm)
            err = max(float((render_t - render_s).abs().max()),
                      float((alpha_t - alpha_s).abs().max()))
            require(err <= ORACLE_ATOL and bool(torch.isfinite(render_t).all()),
                    f"{cm}: tiled vs stream render abs err {err:.3e}")
            log(f"  {cm}: n_isect {int(info['n_isect'])} tile intersections "
                f"({int(info_s['n_isect'])} supertile slots); tiled vs stream render "
                f"max abs diff {err:.2e} (rgb, depth, alpha; bar {ORACLE_ATOL}); "
                f"launches {counts}")
            proj = project_gaussians(*g[:4], vm, K, W, H, sh_coeffs=g[4], sh_degree=3,
                                     camera_model=cm)
            inputs[cm] = tile_inputs(dict(w=W, h=H, camera_model=cm), proj)
        del proj, render_t, alpha_t, render_s, alpha_s

        cfg, st, packed, isect = inputs["pinhole"]
        layers = {"projection": [], "build": [], "pack": [], "kernel": [], "assembly": []}
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            proj = project_gaussians(*g[:4], vm, K, W, H, sh_coeffs=g[4], sh_degree=3)
            ev[1].record()
            isect = itx.build_intersections(proj, W, H, 16, caps)
            ev[2].record()
            packed = itx.pack_fields(proj.means2d, proj.conics, proj.colors,
                                     proj.opacities, proj.depths, isect)
            ev[3].record()
            out = tr.tile_fwd(cfg, isect.tile_starts, packed)
            ev[4].record()
            rgb, a, d = tr.tiles_to_image(cfg, out)
            img = torch.cat([rgb, d / torch.clamp(a, min=1e-10)], dim=-1)
            ev[5].record()
            torch.cuda.synchronize()
            for i, key in enumerate(layers):
                layers[key].append(ev[i].elapsed_time(ev[i + 1]))
        require(bool(torch.isfinite(img).all()), "tiled layer split output")
        log("  layers, pinhole (median of 5, CUDA events): " + ", ".join(
            f"{k} {statistics.median(v):.3f} ms" for k, v in layers.items()))
        trace = device_trace(lambda: itx.build_intersections(proj, W, H, 16, caps), 3)
        if trace is not None:
            log(f"  trace tiled build (torch.profiler, 3 builds): {trace[0]:.0f} device "
                f"activities, busy {trace[1]:.3f} ms, idle share {trace[2]:.3f}")
            for kname, n, ms in trace[3]:
                log(f"    {ms:.3f} ms, {n:.0f}x per build: {kname[:100]}")
        st = isect.tile_starts
        e, out_k, plain_ms = compare_tile_fwd("tiled 1M pinhole", cfg, st, packed)
        max_err["tile_fwd"] = max(max_err["tile_fwd"], e)
        e_s, out_s, _ = compare_tile_fwd("tiled 1M spherical", *inputs["spherical"][:3])
        max_err["tile_fwd"] = max(max_err["tile_fwd"], e_s)
        kernel_ms = cuda_ms(lambda: tr.tile_fwd(cfg, st, packed), 20)
        sph_ms = cuda_ms(lambda: tr.tile_fwd(*inputs["spherical"][:3]), 10)

        def tile_bound(c, starts, pk, o):
            """(bound ms, by what, chunks, pairs, bytes) of tile_fwd: the rows
            of the chunks the tiles composited read once, the output written
            once, the rows of those chunks that can composite at every pixel x
            OPS_PER_PAIR."""
            n_chunks, _ = tile_work(c, o)
            pairs = tile_fwd_pairs(c, starts, pk, o)
            nbytes = n_chunks * c.chunk * itx.NF * 4 + (c.ct + 1) * 4 + o.numel() * 4
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = pairs * OPS_PER_PAIR / F32_OPS_PER_S * 1e3
            return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
                    n_chunks, pairs, nbytes)

        bound_ms, bound_by, n_chunks, pairs, bytes_moved = tile_bound(cfg, st, packed, out_k)
        sph_bound_ms, sph_by, sph_chunks, sph_pairs, _ = tile_bound(*inputs["spherical"][:3],
                                                                    out_s)
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        rasterization(*g, vm, K, W, H, sh_degree=3, render_mode="RGB+ED", impl="tiled")
        torch.cuda.synchronize()
        peak_mib = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    log(f"  tile_fwd at 1M/720p pinhole: {kernel_ms:.4f} ms (CUDA events, 20 launches); "
        f"spherical {sph_ms:.4f} ms (10 launches), bound {sph_bound_ms:.4f} ms by {sph_by} "
        f"({sph_chunks} chunks, {sph_pairs / 1e6:.1f} M pairs); plain version "
        f"{plain_ms:.1f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({n_chunks} chunks processed of "
        f"{int(isect.n_slots) // cfg.chunk}, {pairs / 1e6:.1f} M pixel-slot pairs x "
        f"{OPS_PER_PAIR} ops, {bytes_moved / 1e6:.1f} MB); render peak memory above the "
        f"inputs {peak_mib:.0f} MiB | {card}")
    return dict(name="tile_fwd", route="cuda", source="splat_one_tpu_torch/csrc/tile_fwd.cu",
                replaces="splat_one_tpu/ops/tile_raster.py:147", max_abs_err=None,
                ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, spherical_ms=sph_ms, spherical_bound_ms=sph_bound_ms)


def tiled_step_phase(dev, card, leaves, vm, Kt, grads_stream, max_err):
    """Phase 5a-i (see the module docstring). Returns the kernels-line row
    of tile_bwd without its launches."""
    import torch
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import tile_raster as tr
    from splat_one_tpu_torch.ops.projection import Projected, project_gaussians
    from splat_one_tpu_torch.render.rasterization import rasterization
    from splat_one_tpu_torch.utils import cuda_build

    W, H, N = W_SERVE, H_SERVE, N_SERVE
    names = ("means", "quats", "scales", "opac", "sh")
    log(f"phase 5a-i: the same step through impl='tiled' | {card}")

    def step():
        render, alpha, info = rasterization(*leaves[:4], leaves[4], vm, Kt, W, H,
                                            sh_degree=3, render_mode="RGB+ED", impl="tiled")
        loss = render.sum() + alpha.sum()
        return loss, torch.autograd.grad(loss, leaves), info

    step()
    torch.cuda.synchronize()
    cuda_build.launch_counts.clear()
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        loss, grads, info = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = dict(cuda_build.launch_counts)
    for k in ("tile_fwd", "tile_bwd", "seg_reduce"):
        require(counts.get(k, 0) == 7, f"tiled step: {k} launched {counts.get(k, 0)} times")
    require(not any(counts.get(k) for k in ("stream_fwd", "stream_bwd", "keyed_perm")),
            f"tiled step launched a stream kernel: {counts}")
    require(not bool(info["overflow"]) and bool(torch.isfinite(loss)), "tiled step")
    rels = []
    for name, gt, gs in zip(names, grads, grads_stream):
        rel = float((gt - gs).abs().max() / gs.abs().max())
        require(bool(torch.isfinite(gt).all()) and rel <= REL_GRAD,
                f"tiled step gradient {name} vs the stream step's: rel {rel:.3e}")
        rels.append(rel)
    step_ms = statistics.median(times)
    log(f"  step: median {step_ms:.3f} ms over 7 (host clock, synchronized), "
        f"{W * H / step_ms / 1e3:.3f} Mpix/s; n_isect {int(info['n_isect'])}; launch "
        f"counts {counts}; gradients vs the stream step's: worst rel {max(rels):.2e} "
        f"(bar {REL_GRAD}) | {card}")

    # the tiled backward kernel at these inputs, with the step's cotangent
    with torch.no_grad():
        proj = project_gaussians(*(x.detach() for x in leaves[:4]), vm, Kt, W, H,
                                 sh_coeffs=leaves[4].detach(), sh_degree=3)
        cfg, st, packed, isect = tile_inputs(dict(w=W, h=H, camera_model="pinhole"),
                                             Projected(*proj))
        out = tr.tile_fwd(cfg, st, packed)
    out_leaf = out.detach().requires_grad_(True)
    rgb, a, d = tr.tiles_to_image(cfg, out_leaf)
    gl = torch.cat([rgb, d / torch.clamp(a, min=1e-10)], -1).sum() + a.sum()
    gout, = torch.autograd.grad(gl, out_leaf)
    e_b, pg_k, plain_ms = compare_tile_bwd("tiled 1M pinhole step", cfg, st, packed, out, gout)
    max_err["tile_bwd"] = max(max_err["tile_bwd"], e_b)
    bwd_ms = cuda_ms(lambda: tr.tile_bwd(cfg, st, packed, out, gout), 10)
    n_chunks, pairs = tile_work(cfg, out)
    # replayed slot rows read and gradient rows written (64 B each),
    # fwd_out channels 0-5 and gout channels 0-4 read
    bwd_bytes = 2 * n_chunks * cfg.chunk * itx.NF * 4 + (6 + 5) * cfg.ct * cfg.npix * 4
    ops_per_pair = OPS_PER_PAIR_BWD + itx.N_GROWS
    bytes_ms = bwd_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = pairs * ops_per_pair / F32_OPS_PER_S * 1e3
    bound_ms, bound_by = max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")
    log(f"  tile_bwd at 1M/720p: {bwd_ms:.4f} ms (CUDA events, 10 launches); plain version "
        f"{plain_ms:.1f} ms; bound {bound_ms:.4f} ms by {bound_by} ({n_chunks} chunks "
        f"replayed, {pairs / 1e6:.1f} M pixel-slot pairs x {ops_per_pair} ops, "
        f"{bwd_bytes / 1e6:.1f} MB); abs err vs plain {e_b:.3e} | {card}")

    # the tiled reduction (one seg_reduce launch through rank_perm, written at
    # rank_src) at these rows: vs plain, time, bound; beside it the live-slot
    # selection + index_add_ from the same rows and the parent's row gather
    e_r, red_plain_ms = compare_tiled_reduction("tiled 1M pinhole step", pg_k, isect, N)
    max_err["seg_reduce"] = max(max_err["seg_reduce"], e_r)
    red_ev = cuda_ms(lambda: itx.gather_reduction(pg_k, isect, N), 20)
    red_ms = device_ms(lambda: itx.gather_reduction(pg_k, isect, N), 20,
                       ("seg_reduce_kernel",)) or red_ev

    def library():
        live = isect.slot_rank < N
        flat = isect.rank_src.long()[isect.slot_rank[live].long()]
        acc = torch.zeros((N, itx.N_GROWS), device=dev)
        return acc.index_add_(0, flat, pg_k[live, :itx.N_GROWS])

    lib_ms = cuda_ms(library, 10)
    lib_diff = float((library().T - itx.gather_reduction(pg_k, isect, N)).abs().max())
    copy_ms = cuda_ms(lambda: pg_k[isect.rank_perm.long()], 5)
    n_int = int(isect.rank_bounds[-1])
    # the runs' payload and index entries, the bounds and rank_src read, the
    # per-gaussian sums written
    red_bytes = n_int * (itx.N_GROWS + 1) * 4 + (N + 1) * 4 + N * 4 + itx.N_GROWS * N * 4
    red_bound = red_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  the tiled reduction at 1M/720p ({n_int} intersections, {itx.N_GROWS} columns): "
        f"gather_reduction (one seg_reduce launch) {red_ms:.4f} ms (device time, 20 calls; "
        f"CUDA events {red_ev:.4f} ms), bound {red_bound:.4f} ms by bytes ({red_bytes / 1e6:.1f} MB), "
        f"{red_bound / red_ms:.3f} of it; plain version {red_plain_ms:.1f} ms; live-slot "
        f"selection + index_add_ from the same rows {lib_ms:.4f} ms (max abs diff "
        f"{lib_diff:.2e}); the parent's gather of every row by rank_perm alone "
        f"{copy_ms:.4f} ms | {card}")
    tiled_red = dict(tiled_ms=red_ms, tiled_events_ms=red_ev, tiled_bound_ms=red_bound,
                     tiled_plain_ms=red_plain_ms, tiled_library_ms=lib_ms)
    return dict(name="tile_bwd", route="cuda", source="splat_one_tpu_torch/csrc/tile_bwd.cu",
                replaces="splat_one_tpu/ops/tile_raster.py:221", max_abs_err=None,
                ms=bwd_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None), tiled_red


def seg_broadcast_phase(dev, card, leaves, vm, Kt, proj0, caps):
    """Phase 5a-ii (see the module docstring). Returns the kernels-line
    row of seg_broadcast."""
    import torch
    from splat_one_tpu_torch.ops import seg_broadcast as sgb
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.render.rasterization import rasterization
    from splat_one_tpu_torch.utils import cuda_build

    W, H = W_SERVE, H_SERVE
    slab = si.observed_sb_slab(proj0, W, H, 16, caps)
    caps_sb = dataclasses.replace(caps, sb_slab=slab)
    log(f"phase 5a-ii: stream build under SPLAT_SEG_BROADCAST=cond, observed window "
        f"{slab} parents (observed_sb_slab), exp_cap {caps.exp_cap} | {card}")
    with seg_broadcast_path(None):
        want = si.build_stream_intersections(proj0, W, H, 16, caps_sb)
    with seg_broadcast_path("cond"), torch.no_grad():
        cuda_build.launch_counts.clear()
        render, alpha, info = rasterization(*(x.detach() for x in leaves[:4]),
                                            leaves[4].detach(), vm, Kt, W, H, sh_degree=3,
                                            render_mode="RGB+ED", caps=caps_sb)
        torch.cuda.synchronize()
        counts = dict(cuda_build.launch_counts)
        got = si.build_stream_intersections(proj0, W, H, 16, caps_sb)
    require(counts.get("seg_broadcast", 0) == 1 and not counts.get("seg_broadcast_fallback"),
            f"seg_broadcast launches on the cond path: {counts}")
    require(not bool(info["overflow"]) and bool(torch.isfinite(render).all()), "cond render")
    for f in want._fields:
        require(bool(torch.equal(getattr(got, f), getattr(want, f))),
                f"stream layout field {f} differs under SPLAT_SEG_BROADCAST=cond")
    log(f"  rasterization under cond: launch counts {counts}; every StreamIsect field "
        f"equal to the default build's (n_isect {int(want.n_isect)})")
    prob, grid = seg_broadcast_problem(proj0, W, H, "pinhole")
    exp_cap = caps.exp_cap
    plain_ms, covered = compare_seg_broadcast("1M pinhole", prob, grid, exp_cap, slab)
    require(covered, "the observed window does not cover the 1M problem")
    okv, pbases, offs_pad = sgb.coverage_windows(prob[4], prob[6], exp_cap, slab)
    args = (*prob[:4], prob[5], offs_pad, pbases, exp_cap, grid, slab)
    k_ev = cuda_ms(lambda: sgb.expand_parent_meta(*args), 20)
    k_ms = device_ms(lambda: sgb.expand_parent_meta(*args), 20,
                     ("seg_broadcast_kernel",)) or k_ev
    # the whole expansion by each path, slot keys included, in turns
    paths = {"kernel": [], "xla": []}
    for which in ("kernel", "xla", "xla", "kernel"):
        paths[which].append(cuda_ms(
            lambda: sgb.expand_slots(*prob, exp_cap, grid, which, slab), 20))
    path_ms, default_ms = (statistics.mean(paths[w]) for w in ("kernel", "xla"))
    mp = prob[0].shape[0]
    n_isect = int(want.n_isect)
    parents = torch.arange(mp, device=dev)

    def library():  # one PyTorch call for the slot -> parent map
        return torch.repeat_interleave(parents, prob[6], output_size=n_isect)

    lib_ms = cuda_ms(library, 10)
    _, g_k = sgb.expand_parent_meta(*args)
    require(bool(torch.equal(library(), g_k[:n_isect].long())),
            "repeat_interleave expansion differs from the kernel's")
    nb = pbases.shape[0]
    # the parents' four int64 columns, depth and offset read, pbases read,
    # the 8-byte key and 4-byte owner of every slot written
    sb_bytes = mp * (4 * 8 + 4 + 4) + nb * 4 + nb * sgb.CH * 12
    bound_ms = sb_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  seg_broadcast at 1M/720p: {k_ms:.4f} ms (device time, 20 launches; CUDA events "
        f"through the wrapper {k_ev:.4f} ms); plain "
        f"version {plain_ms:.1f} ms; bound {bound_ms:.4f} ms by bytes ({sb_bytes / 1e6:.1f} "
        f"MB: {mp} parents' columns, {nb} x {sgb.CH} slots' keys and owners), "
        f"{bound_ms / k_ms:.3f} of it; repeat_interleave (the slot -> parent map alone) "
        f"{lib_ms:.4f} ms | {card}")
    log(f"  the expansion with the slots' sort keys, in turns (20 calls each): kernel path "
        f"(windows + kernel) {', '.join(f'{x:.4f}' for x in paths['kernel'])} ms; default "
        f"path (index_add_ + cumsum + gathers + decode) "
        f"{', '.join(f'{x:.4f}' for x in paths['xla'])} ms; the kernel path "
        f"{'no slower than' if path_ms <= default_ms else 'SLOWER than'} the default | {card}")
    return dict(name="seg_broadcast", route="cuda",
                source="splat_one_tpu_torch/csrc/seg_broadcast.cu",
                replaces="splat_one_tpu/ops/seg_broadcast.py:73",
                launches=counts.get("seg_broadcast", 0), max_abs_err=0.0, ms=k_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms,
                events_ms=k_ev, path_ms=path_ms, default_path_ms=default_ms)


def tiled_trainer_phase(dev, card, scene, first_loss):
    """Phase 5c (see the module docstring): the phase-5b Trainer through
    raster_impl="tiled". Returns the run's launch counts."""
    import torch
    from splat_one_tpu_torch.ops.intersect import IsectCaps
    from splat_one_tpu_torch.train.config import Config
    from splat_one_tpu_torch.train.strategy import DefaultStrategyCfg
    from splat_one_tpu_torch.train.trainer import Trainer
    from splat_one_tpu_torch.utils import cuda_build

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tiled_")
    try:
        tcfg = Config(
            result_dir=tmp, camera_model="pinhole", sh_degree=3, batch_size=1,
            init_type="random", init_num_pts=N_SERVE, capacity=TRAIN_CAPACITY,
            raster_impl="tiled", max_steps=TILED_STEPS, eval_steps=[TILED_STEPS],
            save_steps=[], tb_every=TILED_STEPS, test_every=8,
            strategy=DefaultStrategyCfg(refine_start_iter=2, refine_stop_iter=100,
                                        refine_every=3, reset_every=5))
        trainer = Trainer(tcfg, scene)
        caps0 = trainer.caps
        require(isinstance(caps0, IsectCaps), f"tiled Trainer caps {caps0}")
        log(f"phase 5c: Trainer(raster_impl='tiled'), {N_SERVE} random-init gaussians "
            f"(capacity {TRAIN_CAPACITY}: exp_cap {caps0.exp_cap}, align_cap {caps0.align_cap}), "
            f"SH 3, {W_SERVE}x{H_SERVE}, {TILED_STEPS} steps, phase 5b's scene | {card}")
        torch.cuda.synchronize()
        cuda_build.launch_counts.clear()
        t0 = time.perf_counter()
        hist = trainer.train(log_every=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = dict(cuda_build.launch_counts)
        log(f"  launch counts on the tiled training path ({TILED_STEPS} steps, 1 refine, "
            f"1 eval render): {counts}")
        for k, n in (("tile_fwd", TILED_STEPS + 1), ("tile_bwd", TILED_STEPS),
                     ("seg_reduce", TILED_STEPS)):
            require(counts.get(k, 0) == n, f"{k} launched {counts.get(k, 0)} times, not {n}")
        require(not any(counts.get(k) for k in ("stream_fwd", "stream_bwd", "keyed_perm")),
                f"the tiled Trainer launched a stream kernel: {counts}")
        losses = [h["loss"] for h in hist]
        n_gs = [h["num_GS"] for h in hist]
        require(len(hist) == TILED_STEPS and all(np.isfinite(losses)), f"losses {losses}")
        require(all(h["overflow"] == 0 for h in hist),
                f"tiled Trainer overflow: {[h['overflow'] for h in hist]}")
        require(n_gs[2] != n_gs[1], f"the refine at step 3 left the alive count at {n_gs[1]}")
        rel = abs(losses[0] - first_loss) / abs(first_loss)
        require(rel <= 1e-4, f"first tiled loss {losses[0]} vs stream {first_loss}")
        dts = np.diff([0.0] + [h["time_s"] for h in hist]) * 1e3
        log(f"  losses {', '.join(f'{x:.5f}' for x in losses)} (first vs phase 5b's "
            f"{first_loss:.5f}: rel {rel:.2e}); alive {', '.join(map(str, n_gs))}; n_isect "
            f"{', '.join(str(int(h['n_isect'])) for h in hist)} (no overflow; exp_cap "
            f"{trainer.caps.exp_cap} after the refine, capacity {trainer.capacity})")
        log(f"  step times (host clock, each ends reading the loss) "
            f"{', '.join(f'{x:.1f}' for x in dts)} ms; whole run {train_s:.1f} s | {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def synthetic_phase(dev, card):
    """Phase 5d (see the module docstring)."""
    import torch
    from splat_one_tpu_torch.core.sh import rgb_to_sh
    from splat_one_tpu_torch.core.transforms import invert_se3
    from splat_one_tpu_torch.data.synthetic import make_synthetic_scene
    from splat_one_tpu_torch.ops.intersect import IsectCaps
    from splat_one_tpu_torch.render.rasterization import rasterization
    from splat_one_tpu_torch.utils import cuda_build

    log(f"phase 5d: make_synthetic_scene on the card | {card}")
    for label, kw in (("defaults", {}), ("surface", dict(surface=True)),
                      ("spherical", dict(camera_model="spherical"))):
        cuda_build.launch_counts.clear()
        t0 = time.perf_counter()
        scene, gt = make_synthetic_scene(**kw)
        secs = time.perf_counter() - t0
        counts = dict(cuda_build.launch_counts)
        M, H, W = scene.images.shape[:3]
        require(counts.get("tile_fwd", 0) == M, f"{label}: launches {counts}")
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        g = [t(gt[k]) for k in ("means", "quats", "scales", "opacities")]
        sh0 = rgb_to_sh(t(gt["rgb"]))[:, None, :]
        viewmats, Ks = invert_se3(t(scene.camtoworlds)), t(scene.Ks)
        caps = IsectCaps.choose(g[0].shape[0], 1, (-(-W // 16)) * (-(-H // 16)))
        err_t = err_s = 0.0
        n_isect = []
        with torch.no_grad():
            for i in range(M):
                args = (*g, sh0, viewmats[i:i + 1], Ks[i:i + 1], W, H)
                kw_r = dict(sh_degree=0, camera_model=scene.camera_model)
                r_t, _, info = rasterization(*args, caps=caps, **kw_r)
                r_s, _, _ = rasterization(*args, impl="stream", **kw_r)
                require(not bool(info["overflow"]), f"{label}: view {i} overflows its caps")
                n_isect.append(int(info["n_isect"]))
                img = torch.as_tensor(scene.images[i], device=dev)
                err_t = max(err_t, float((torch.clamp(r_t[0], 0, 1) - img).abs().max()))
                err_s = max(err_s, float((torch.clamp(r_s[0], 0, 1) - img).abs().max()))
        require(err_t <= 1e-6 and err_s <= ORACLE_ATOL,
                f"{label}: GT vs re-render {err_t:.2e}, vs stream {err_s:.2e}")
        require(scene.images.max() > 0.2, f"{label}: empty GT")
        log(f"  {label} ({M} views {W}x{H}, {g[0].shape[0]} gaussians, {secs:.1f} s): "
            f"n_isect {min(n_isect)}-{max(n_isect)} of exp_cap {caps.exp_cap}, no overflow; "
            f"GT vs the stream render max abs diff {err_s:.2e} (bar {ORACLE_ATOL}); "
            f"launches {counts}")


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
        for kern, regs, stores, loads, rest in ptxas_entries(entry["ptxas"]):
            log(f"    {kern}: {regs} registers, {stores} B spill stores, {loads} B spill "
                f"loads; {rest}")
            if name in NO_SPILL:
                require(stores == 0 and loads == 0, f"{name}: {kern} spills")
    for name in cuda_build.SIGNATURES:
        cuda_build.library(name)

    # phase 3: kernels vs plain versions, and vs the oracle
    log("phase 3: stream_fwd, stream_bwd, keyed_perm and seg_reduce kernels vs plain "
        "versions")
    scenes = {
        "pinhole": stream_scene(),
        "spherical": stream_scene(spherical=True),
        "edge-partial 40x24": stream_scene(n=200, c=1, w=40, h=24),
        "empty": empty_scene(),
        "deep-stack 96x32": deep_stack_scene(),
        "crowded spherical 128x64": crowded_spherical_scene(),
        "100k 640x480": bench_scene(100_000, 640, 480, 500.0, -5.5, -4.0, seed=1),
    }
    # kernel vs plain max abs err, over every comparison of this run
    max_err = {k: 0.0 for k in ("stream_fwd", "stream_bwd", "seg_reduce", "keyed_perm",
                                "tile_fwd", "tile_bwd", "seg_broadcast")}
    for i, (name, sc) in enumerate(scenes.items()):
        cfg, st, packed, isect = stream_inputs(sc, dev)
        e, out_k, _ = compare_fwd(name, cfg, st, packed)
        max_err["stream_fwd"] = max(max_err["stream_fwd"], e)
        # both reduced widths: without and with absgrad (10 and 12 columns)
        for absgrad in (False, True):
            e_b, e_r, *_ = compare_bwd(name, dataclasses.replace(cfg, absgrad=absgrad), st,
                                       isect.st_starts_al, packed, out_k,
                                       seeded_gout(cfg, i, dev),
                                       cfg.num_cameras * cfg.num_gaussians)
            max_err["stream_bwd"] = max(max_err["stream_bwd"], e_b)
            max_err["seg_reduce"] = max(max_err["seg_reduce"], e_r)
        torch.cuda.synchronize()

    tiled_kernel_checks(scenes, dev, max_err)

    osc = oracle_scene()
    t = lambda x: torch.as_tensor(x, device=dev)
    args = [t(osc[k]) for k in ("means", "quats", "scales", "opac", "sh",
                                "viewmats", "Ks")]
    proj = project_gaussians(*args[:4], args[5], args[6], 64, 64,
                             sh_coeffs=args[4], sh_degree=1)
    rgb_o, a_o, d_o = composite_reference(proj, 64, 64)
    for impl in ("stream", "tiled"):
        render, alpha, info = rasterization(*args, 64, 64, sh_degree=1,
                                            render_mode="RGB+D", impl=impl)
        torch.cuda.synchronize()
        e_rgb = float((render[..., :3] - rgb_o).abs().max())
        e_a = float((alpha - a_o).abs().max())
        e_d = float((render[..., 3:] - d_o).abs().max())
        log(f"  oracle 64x64 (300 gaussians), {impl}: rgb {e_rgb:.2e} alpha {e_a:.2e} "
            f"depth {e_d:.2e} (atol {ORACLE_ATOL})")
        require(not bool(info["overflow"]), "oracle scene overflow")
        require(max(e_rgb, e_a) <= ORACLE_ATOL, f"{impl} kernel path vs oracle (rgb/alpha)")
        require(e_d <= 5 * ORACLE_ATOL, f"{impl} kernel path vs oracle (depth)")
        oracle_grad_check(dev, impl)

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
    require(not any(counts.get(k) for k in ("stream_bwd", "keyed_perm", "seg_reduce")),
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
    cfg_s, st_s, packed_s, isect_s = stream_inputs(dict(sc, camera_model="spherical"), dev)
    e_s, out_s, _ = compare_fwd("serving 1M spherical", cfg_s, st_s, packed_s)
    max_err["stream_fwd"] = max(max_err["stream_fwd"], e_s)
    kernel_ms = cuda_ms(lambda: sr.stream_fwd(cfg, st, packed), 20)
    sph_ms = cuda_ms(lambda: sr.stream_fwd(cfg_s, st_s, packed_s), 10)
    plain_ms = cuda_ms(lambda: sr.stream_fwd_plain(cfg, st, packed), 1)

    def stream_bound(c, starts, pk, n_isect, o):
        """(bound ms, by what, MB, gated pairs) of stream_fwd on these inputs:
        each slot row read once, the output written once, and the gated
        pairs of the chunks the tiles composited x OPS_PER_PAIR."""
        bytes_moved = n_isect * si.NF * 4 + (c.cs + 1) * 4 + o.numel() * 4
        pairs = gated_pairs(c, starts, pk, o)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = pairs * OPS_PER_PAIR / F32_OPS_PER_S * 1e3
        return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
                bytes_moved / 1e6, pairs)

    bound_ms, bound_by, mb, pairs = stream_bound(cfg, st, packed, int(isect.n_isect), out_k)
    sph_bound_ms, sph_by, sph_mb, sph_pairs = stream_bound(
        cfg_s, st_s, packed_s, int(isect_s.n_isect), out_s)
    del out_s, packed_s, isect_s
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    rf.render(requests[0][1], K, "pinhole")
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    log(f"  stream_fwd at 1M/720p: {kernel_ms:.4f} ms (CUDA events, 20 launches); "
        f"plain version {plain_ms:.1f} ms; bound {bound_ms:.4f} ms by {bound_by} "
        f"({mb:.1f} MB, {pairs / 1e6:.1f} M pixel-slot pairs); spherical "
        f"{sph_ms:.4f} ms (10 launches), bound {sph_bound_ms:.4f} ms by {sph_by} "
        f"({sph_mb:.1f} MB, {sph_pairs / 1e6:.1f} M pixel-slot pairs); render peak memory "
        f"above the parameters {peak_mib:.0f} MiB | {card}")

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
        "spherical_ms": sph_ms,
        "spherical_bound_ms": sph_bound_ms,
    }
    del params, alive, render_fn, outputs, proj, isect, packed, out_k
    torch.cuda.empty_cache()
    tile_fwd_row = tiled_render_phase(dev, card, sc, max_err)
    torch.cuda.empty_cache()

    rows = training_phase(dev, card, sc, max_err)
    kernels = [dict(fwd_row, launches=rows["launches"].get("stream_fwd", 0),
                    max_abs_err=max_err["stream_fwd"])] + rows["kernels"] + [
        dict(tile_fwd_row, launches=rows["tiled_launches"].get("tile_fwd", 0),
             max_abs_err=max_err["tile_fwd"]),
        dict(rows["tile_bwd"], max_abs_err=max_err["tile_bwd"]),
        dict(rows["seg_broadcast"], max_abs_err=max_err["seg_broadcast"]),
    ]
    for row in kernels:
        require(row["launches"] > 0, f"{row['name']} was not launched on its path")

    # phase 6: the kernels line, the card line, the result line
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
