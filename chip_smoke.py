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
     (e) the train stage from a workdir, through its entry points: a
     workdir written at full width (reconstruction.json with one 1280x720
     perspective camera, 24 ring shots, a reference_lla and the 200k GT
     means as points; images/ rendered by the port from that GT), then
     (i) app.pipeline.train_splats in process (capacity 1,048,576, SH 3,
     40 steps with refines at 10, 20, 30, a reset at 25, a save and an
     eval: the stream kernels' launches, the losses read back from tb/
     falling, the checkpoint and stats); (ii) to_scene_data(streaming=True):
     the decoder that ran, its images against the in-RAM ones, a 3-step
     Trainer on it with the in-RAM first loss; (iii) `python -m
     splat_one_tpu_torch.app.cli train <wd> --ckpt <npz> --compression
     png` in a subprocess: its val stats, the 52 trajectory frames
     (RGB | depth, 2560x720) and the compressed planes with their stats;
     (iv) `... app.cli viewer <wd> --port <p>` in a subprocess: GET / and
     three /render requests (two pinhole, one spherical), each a
     1280x720 JPEG, timed, then the process stopped; (v) the options at
     the same capacity, 6 steps with refines each: (a) pose_opt +
     bilateral grid + depth loss on sparse_depth_map depths (cc_psnr),
     (b) app_opt, (c) MCMCStrategyCfg's defaults refining from step 0
     every 3 (n_relocated, n_grown): finite losses, a checkpoint that loads
     back equal, peak memory; (vi) each part's wall time;
  7. the multi-GPU slice on one card (run before phase 6 prints): (a) the
     phase-4 scene's supertile grid (1M gaussians, SH 3, 1280x720; 920
     supertiles) in 4 slabs of 230, pinhole front and spherical: each
     slab through render.rasterization.composite_slab (the per-rank body
     of parallel.tile_sharded and parallel.ring_sharded), from the whole
     projection, at its slab offset; the stitched slabs against the
     unsharded render (rgb and alpha within 1e-5 abs on the tiles that
     never stopped early; on those that may have, since a slab's chunk
     boundaries move the stop, within 2 TERM_THRESH times the largest
     colour, the tail a stop may drop, and slab 1's output at an offset
     one supertile off read for scale; accumulated depth within 1e-4),
     the slabs' summed gradients (each
     slab's backward, then the projection's) against the unsharded step's
     within 5e-4 of each gradient's max; each slab's build + composite
     and fwd+bwd time, the slowest, the unsharded ones beside, the bytes
     a gauss rank would send per step; at slab 1's offset (pinhole)
     stream_fwd (bits), stream_bwd (KERNEL_TOL), keyed_perm and seg_reduce
     (bits), and seg_broadcast (bits, at both poses: the spherical slab's
     segmented parents too)
     against their plain versions, and every slab's build through the
     seg_broadcast kernel equal to the default expansion's; (b) tile_fwd
     and tile_bwd at a tile offset on phase 4b's pinhole layout (a slab of
     900 of its 3,600 tiles, built with tile_lo): the slab's forward equal
     to the whole layout's tiles, both kernels against their plain
     versions; (c) the mesh Trainer in a world of one rank on NCCL
     (multihost.initialize with a local address, global_mesh(1, 1),
     Trainer(..., mesh=mesh)): phase 5b's scene, config and capacity, 6
     steps with a refine, the first loss within 1e-5 rel of phase 5b's,
     its gathered checkpoint through the viewer's loader, its sharded
     checkpoint round-tripped equal, the process group destroyed;
  8. SfM on the card (run after phase 7, before phase 6 prints; no kernel
     of the script's table lies on this path): (a) the port's SfM
     functions on CPU tensors and on the card, at the CPU tests' bars, on
     8 ring views of the textured sphere at 128x128 (the script's torch
     copy of tests/test_app_pipeline.py's ray tracer): extract_features
     and extract_hahog (the blurred levels within 1e-6 of the CPU's, at
     most 0.5 % of the valid keypoints unstable: in one set only or moved
     > 0.05 px; scales exact; fed the CPU's blurred levels, the same
     keypoints, xys, orientations and descriptors within 1e-4), match_pairs_batched (equal), ransac_essential (8-point, 1024
     hypotheses; 5-point, 256) and ransac_pnp with the same draws (the
     same inlier masks), bundle_adjust (cost within 1e-4 rel, cameras and
     points within 1e-4 of the extent; its host syncs counted); (b)
     BASELINE config 3 (scripts/sfm_scale_bench.py): 60 spiral views at
     256x256 rendered on the card, the true focal set through
     CameraModelManager, then `cli detect-features --max-keypoints 1500
     --feature-process-size 256`, `match-features --order-neighbors 8
     --vlad-neighbors 6`, `create-tracks` and `reconstruct` in process:
     each stage's wall time and peak memory, the time of the device
     pieces, every view registered, aligned centre errors (median < 0.08,
     max < 0.15 of the spread), the final global bundle replayed for LM
     iterations/s and host syncs per call; (c) the same 60 poses at
     1024x1024 through `detect-features` and `match-features` at their
     defaults (+ 8 order and 6 VLAD neighbours): keypoints per image,
     pairs and matches kept, stage times and peak memory, ms a pair of
     the batched matching and of the batched verification; (d) `cli train
     --max-steps 20` on (b)'s workdir: the stream kernels launched, the
     loss falls;
  9. the rest of the Features and Matching stages (run after phase 8; no
     kernel of the script's table lies on this path): (a) ORB, AKAZE
     (MSURF, MLDB), SURF (hessian threshold 500), ALIKED aliked-n16 and
     the compact tier (random weights from a seeded generator), each on
     the card against the port on the CPU on spiral view 0 at 1024x1024
     (the CLI's feature_process_size) with 2048 keypoints: from the image
     at most 0.5 % of the keypoints unstable (in one set only or moved >
     0.05 px), scales equal; the tight bars from shared inputs: AKAZE
     fed the CPU's evolution levels, SURF the CPU's integral image (the
     same keypoints, xys, orientations and descriptors within 1e-4),
     ALIKED the same weights (score and feature maps within 1e-4, SDDH
     at shared keypoints within 1e-4), ORB's BRIEF bits (at most 0.1 %
     differing); TF32 off for the matmuls and inside the convolution
     scope; ms an image on the card and peak memory; (b) LightGlue's
     official forward at full width (input 128, 256 wide, 9 layers, 4
     heads; cvg/LightGlue's ALIKED configuration) with random weights on
     (a)'s ALIKED n16 features of views 0 and 1 (2048 keypoints a side):
     the log-assignment's error, card and CPU, against the same forward
     in float64 on the CPU within 2048 x 2^-24 of its largest entry (the
     f32 bound of the longest reduction, 2048 keys), ms a pair; the trainable tier's scores within 1e-3 of the CPU's, ms
     a pair; (c) the first 24
     views of (b)'s spiral at 256 px (cut from 60 for the phase's
     budget) through `cli detect-features --feature-type ORB|AKAZE|SURF`
     and `ALIKED --aliked-checkpoint` with (a)'s weights as npz, then
     `match-features` (+ `--matching-type lightglue
     --lightglue-checkpoint` with (b)'s for ALIKED), `create-tracks` and
     `reconstruct`: keypoints a view, verified pairs, views registered and
     the centre error (no registration bar: the JAX package holds none
     for these detectors; random weights match nothing); (d)
     `rig_constrained_adjust` (tests/test_rigs.py's stereo rig) on the
     card against the CPU: cost within 1e-4 rel, cameras, points and the
     calibrated relative within 1e-4 of the extent;
 10. the Masks and Depth stages, LPIPS and term_thresh (run after phase 9;
     no kernel of the script's table lies on (a)-(d)): TF32 off for the
     matmuls and inside the convolution scope; (a) LPIPS (AlexNet, random
     weights in the published layouts through scripts/convert_weights.py's
     convert_lpips) on a 1280x720 pair of phase 8's scene, card vs CPU
     within 1e-5 rel (the value and the five feature maps), ms a pair; the
     other half ran in phase 5e (i): Trainer.eval with
     $SPLAT_ONE_TPU_LPIPS_WEIGHTS set reports a finite LPIPS, stream_fwd
     launched once a val view (phase 5b runs with the variable unset and
     requires lpips None); (b) SAM 2.1 hiera_l (embed 144, heads 2, stages
     (2, 6, 36, 4), global (23, 33, 43), windows (8, 4, 16, 8): the
     reference's sam2.1_hiera_large) on random_checkpoint weights, a
     1280x720 view at 1024x1024: the embedding, s0, s1, logits and IoU
     (1, 2 and 4 clicks) card vs CPU within SAM_RTOL of their largest
     entries, the masks equal except where |logit| is under that bar;
     set_image and predict ms, peak memory; the compact tier the same way;
     (c) Depth-Anything-V2 vitl (the published Large: width 1024, 24
     layers, 16 heads, features 256, out_channels 256, 512, 1024, 1024;
     random weights in DA-V2's layout through convert_depth) and the
     compact vits at 518x518, card vs CPU within DEPTH_RTOL, ms an image,
     peak memory; infer_equirectangular on a 2048x1024 panorama and
     infer_fisheye on a 1280x960 fisheye with the network's share beside
     the host's numpy; (d) the first 8 views of 8b's spiral at 256 px
     through `cli create-masks` (with (b)'s checkpoint, then classical),
     `estimate-depth` (default, --equirect, --camera-aware on a fisheye
     camera), then `detect-features` with and without the classical
     masks: no valid keypoint inside a masked-out region with them, some
     without; files written and wall times; (e) stream_fwd and tile_fwd at
     term_thresh 0, 1e-5 and 1e-3 on phase 3's scenes and the 1M scene,
     every output bit their plain versions' (n_chunks with them), the
     chunks walked falling as the threshold rises; in phase 7 the
     stitched slabs at term_thresh 0 against the whole grid's stream_fwd
     within 1e-5 on every pixel; phase 10's wall time (budget 150 s);
  6. the kernels line (JSON; the forward rows also carry spherical_ms and
     spherical_bound_ms; the seg_reduce row is the stream reduction path,
     with its kernel's and its tiled launch's figures beside), then the
     card line, then the result line. Each row also carries
     stage_launches, its launches in phase 5e (i), slab_launches, its
     launches on phase 7's path runs (the comparisons with the plain
     versions not counted; required > 0), and offset_ms, its time at a
     nonzero slab offset in phase 7 (pinhole, slab 1 of 4; device time for
     keyed_perm, seg_reduce and seg_broadcast).
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

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
WD_SHOTS, WD_STEPS = 24, 40  # phase 5e: the workdir's shots, train_splats' steps
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


def compare_tile_fwd(name, cfg, starts, packed, tile_offset=0):
    """tile_fwd kernel vs its plain version (a slab's at its
    ``tile_offset``), every output bit for bit -> (max abs err, kernel out,
    plain ms)."""
    import torch
    from splat_one_tpu_torch.ops import tile_raster as tr

    out_k = tr.tile_fwd(cfg, starts, packed, tile_offset)
    out_p, plain_ms = timed_once(lambda: tr.tile_fwd_plain(cfg, starts, packed, tile_offset))
    worst = column_err(name, "tile_fwd", out_k[:, :5].transpose(0, 1).reshape(5, -1).T,
                       out_p[:, :5].transpose(0, 1).reshape(5, -1).T)
    require(bool(torch.equal(out_k, out_p)), f"{name}: tile_fwd differs from its plain "
            f"version (max abs err {worst:.3e}; n_chunks equal: "
            f"{bool(torch.equal(out_k[:, tr.CH_NCHUNKS], out_p[:, tr.CH_NCHUNKS]))})")
    log(f"  {name}: tile_fwd {fwd_blocks_line('tile_fwd', cfg, starts, out_k)}")
    return worst, out_k, plain_ms


def compare_tile_bwd(name, cfg, starts, packed, out, gout, tile_offset=0):
    """tile_bwd kernel vs its plain version (a slab's at its
    ``tile_offset``), and a second launch bit for bit -> (max abs err,
    kernel rows, plain ms)."""
    import torch
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import tile_raster as tr

    args = (cfg, starts, packed, out, gout, tile_offset)
    pg_k = tr.tile_bwd(*args)
    require(bool(torch.equal(pg_k, tr.tile_bwd(*args))),
            f"{name}: two tile_bwd launches differ")
    pg_p, plain_ms = timed_once(lambda: tr.tile_bwd_plain(*args))
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


def seg_broadcast_problem(proj, w, h, camera_model, st_lo=0, n_st_local=0):
    """The stream builder's expansion problem for a projection (or one
    slab of it): ((sx0, sy0, span, ka, offsets, depth, counts), its
    SlotGrid), as stream_isect.build_stream_intersections hands it to
    seg_broadcast."""
    from splat_one_tpu_torch.ops import stream_isect as si

    *prob, grid = si.slot_parents(proj, w, h, 16, si.SS, camera_model, st_lo, n_st_local)
    return tuple(prob), grid


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


def compare_fwd(name, cfg, st_starts, packed, tile_offset=0):
    """Kernel vs plain version on the same inputs (a slab's at its
    ``tile_offset``); returns (max_abs_err, kernel out, plain out)."""
    import torch
    from splat_one_tpu_torch.ops import stream_raster as sr

    out_k = sr.stream_fwd(cfg, st_starts, packed, tile_offset)
    torch.cuda.synchronize()
    out_p = sr.stream_fwd_plain(cfg, st_starts, packed, tile_offset)
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


def gated_pairs(cfg, st_starts, packed, out, tile_offset=0):
    """(pixel, slot) evaluations this run's data needs: gated slots of every
    tile's processed chunks (k < n_chunks of the tile), times 256 pixels
    (a slab's cells at ``tile_offset``)."""
    import torch
    from splat_one_tpu_torch.ops import stream_raster as sr

    G = cfg.chunk
    dev = packed.device
    starts = st_starts.long()
    s0, s1 = starts[:-1], starts[1:]
    base0 = torch.div(s0, G, rounding_mode="floor") * G
    nch = out[:, :, sr.CH_NCHUNKS, 0].long()  # [CS, NT]
    _, _, tx, ty = sr._tile_geometry(cfg, torch.arange(cfg.cs, device=dev) + tile_offset)
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


def compare_bwd(name, cfg, st_starts, st_starts_al, packed, out, gout, m0, tile_offset=0):
    """Backward kernel vs plain version on the same inputs (a slab's at
    its ``tile_offset``; key column exactly, gradient columns within
    KERNEL_TOL; a second launch bit for bit), then the reduction of the
    kernel's rows: keyed_perm and the segmented reduce kernel each bit for
    bit against their plain versions. Returns (max abs err bwd, max abs
    err reduce, kernel rows, perm, bounds)."""
    import torch
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.ops import stream_raster as sr

    args = (cfg, st_starts, st_starts_al, packed, out, gout, tile_offset)
    pg_k = sr.stream_bwd(*args)
    require(bool(torch.equal(pg_k, sr.stream_bwd(*args))),
            f"{name}: two stream_bwd launches differ")
    torch.cuda.synchronize()
    pg_p = sr.stream_bwd_plain(*args)
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


def phase5b_config(result_dir):
    """Phase 5b's Trainer configuration (phase 7c trains it on a mesh)."""
    from splat_one_tpu_torch.train.config import Config
    from splat_one_tpu_torch.train.strategy import DefaultStrategyCfg

    return Config(
        result_dir=result_dir, camera_model="pinhole", sh_degree=3, batch_size=1,
        init_type="random", init_num_pts=N_SERVE, capacity=TRAIN_CAPACITY,
        max_steps=TRAIN_STEPS, eval_steps=[TRAIN_STEPS], save_steps=[TRAIN_STEPS],
        tb_every=TRAIN_STEPS, test_every=8,
        strategy=DefaultStrategyCfg(refine_start_iter=2, refine_stop_iter=100,
                                    refine_every=3, reset_every=5))


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
        t0 = time.perf_counter()
        trainer = Trainer(phase5b_config(tmp), scene)
        log(f"  Trainer init (random init, 3-NN scales on the host): "
            f"{time.perf_counter() - t0:.1f} s")
        n0 = int(trainer.state.alive.sum())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.launch_counts.clear()
        t0 = time.perf_counter()
        with lpips_weights(None):  # the eval's no-weights gate: lpips None
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
    return {"launches": tcounts, "tiled_launches": tiled_counts, "scene": scene,
            "first_loss": losses[0],
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


# ------------------------------------------------- phase 5e: the train stage
def _varint(buf, i):
    v = shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if b < 0x80:
            return v, i


def _pb_fields(buf):
    """[(field, value)] of a protobuf message (varint, 64-bit, bytes, 32-bit)."""
    out, i = [], 0
    while i < len(buf):
        key, i = _varint(buf, i)
        wire = key & 7
        if wire == 0:
            v, i = _varint(buf, i)
        elif wire == 2:
            n, i = _varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            n = 8 if wire == 1 else 4
            v, i = buf[i:i + n], i + n
        out.append((key >> 3, v))
    return out


def tb_scalars(tb_dir, tag):
    """[(step, value)] of the scalar ``tag`` in the TensorBoard event files
    under ``tb_dir`` (TFRecord framing; Event.step = field 2, Event.summary
    = 5, Summary.value = 1, Value.tag = 1, Value.simple_value = 2)."""
    import struct

    out = []
    for name in sorted(os.listdir(tb_dir)):
        with open(os.path.join(tb_dir, name), "rb") as fh:
            raw = fh.read()
        pos = 0
        while pos + 12 <= len(raw):
            n = struct.unpack("<Q", raw[pos:pos + 8])[0]
            event = dict(_pb_fields(raw[pos + 12:pos + 12 + n]))
            pos += 16 + n
            for f, val in _pb_fields(event.get(5, b"")):
                fields = dict(_pb_fields(val))
                if f == 1 and fields.get(1) == tag.encode():
                    out.append((event[2], struct.unpack("<f", fields[2])[0]))
    return out


def write_workdir(dev, wd):
    """Phase 5e's workdir at full width: ``reconstruction.json`` (one
    perspective camera W_SERVE x H_SERVE, k1 = k2 = 0; WD_SHOTS shots on
    a ring; a reference_lla; the N_GT means of make_gt_gaussians(N_GT,
    seed=0) with their DC colours as uint8) and ``images/<shot>.png``,
    each rendered by the port from that GT at its shot's pose. Returns the
    seconds of the renders and of the PNG writes."""
    import torch
    from PIL import Image
    from scipy.spatial.transform import Rotation
    from splat_one_tpu_torch.core.sh import rgb_to_sh
    from splat_one_tpu_torch.core.transforms import invert_se3
    from splat_one_tpu_torch.data.opensfm import Parser
    from splat_one_tpu_torch.data.synthetic import make_gt_gaussians, ring_cameras
    from splat_one_tpu_torch.ops.projection import project_gaussians
    from splat_one_tpu_torch.render.rasterization import rasterization

    W, H = W_SERVE, H_SERVE
    os.makedirs(os.path.join(wd, "images"))
    means, quats, scales, opac, rgb = make_gt_gaussians(N_GT, seed=0)
    c2ws, Ks = ring_cameras(WD_SHOTS, 3.0, -0.8, 60.0, W, H)
    shots = {}
    for i, c2w in enumerate(c2ws):
        w2c = np.linalg.inv(c2w)
        shots[f"shot_{i:03d}.png"] = {
            "rotation": Rotation.from_matrix(w2c[:3, :3]).as_rotvec().tolist(),
            "translation": w2c[:3, 3].tolist(), "camera": "cam0"}
    colors = np.round(np.clip(rgb, 0, 1) * 255).astype(int)
    rec = {"cameras": {"cam0": {"projection_type": "perspective", "width": W, "height": H,
                                "focal": float(Ks[0, 0, 0]) / max(W, H),
                                "k1": 0.0, "k2": 0.0}},
           "shots": shots,
           "points": {str(i): {"coordinates": means[i].tolist(), "color": colors[i].tolist()}
                      for i in range(N_GT)},
           "reference_lla": {"latitude": 47.3769, "longitude": 8.5417, "altitude": 408.0}}
    with open(os.path.join(wd, "reconstruction.json"), "w") as fh:
        json.dump([rec], fh)
    p = Parser(wd, normalize=False)  # the GT's frame, the Ks the Trainer reads
    t = lambda x: torch.as_tensor(x, device=dev)
    g = [t(x) for x in (means, quats, scales, opac)]
    sh0 = rgb_to_sh(t(rgb))[:, None, :]
    t_render = t_png = 0.0
    with torch.no_grad():
        for i, name in enumerate(p.image_names):
            t0 = time.perf_counter()
            vm, K = invert_se3(t(p.camtoworlds[i:i + 1])), t(p.Ks[i:i + 1])
            proj = project_gaussians(*g, vm, K, W, H, colors=t(rgb))
            out, _, info = rasterization(*g, sh0, vm, K, W, H, sh_degree=0,
                                         caps=bench_caps(proj, W, H))
            require(not bool(info["overflow"]), f"workdir GT render {name} overflows")
            img = (torch.clamp(out[0], 0, 1) * 255).round().to(torch.uint8).cpu().numpy()
            t1 = time.perf_counter()
            Image.fromarray(img).save(os.path.join(wd, "images", name), compress_level=1)
            t_render += t1 - t0
            t_png += time.perf_counter() - t1
    return t_render, t_png


def _peak_gib(dev):
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")


def _reset_peak(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _states_equal(a, b):
    """Every tensor of two TrainStates equal (shapes, dtypes, values)."""
    import torch

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in leaves(x[k])]
        if isinstance(x, tuple):
            return [v for y in x for v in leaves(y)]
        return [] if x is None else [torch.as_tensor(x)]

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def train_stage_phase(dev, card):
    """Phase 5e (see the module docstring): the train stage from a workdir
    through its entry points. Returns the launch counts of part (i)."""
    import torch
    from PIL import Image
    from splat_one_tpu_torch.app.pipeline import train_splats
    from splat_one_tpu_torch.data.depth_supervision import sparse_depth_map
    from splat_one_tpu_torch.data.opensfm import Parser, to_scene_data
    from splat_one_tpu_torch.train.config import Config
    from splat_one_tpu_torch.train.strategy import DefaultStrategyCfg, MCMCStrategyCfg
    from splat_one_tpu_torch.train.trainer import Trainer
    from splat_one_tpu_torch.utils import cuda_build

    import PIL
    import scipy

    W, H = W_SERVE, H_SERVE
    t_phase = time.perf_counter()
    log(f"phase 5e: the train stage from a workdir: {WD_SHOTS} shots {W}x{H}, {N_GT} SfM "
        f"points (the GT's means), SH 3, {WD_STEPS} steps | {card}")
    log(f"  the host's tools: Python {sys.version.split()[0]}, Pillow {PIL.__version__}, "
        f"scipy {scipy.__version__}, g++ {shutil.which('g++')}, ffmpeg "
        f"{shutil.which('ffmpeg')} (render_traj writes an mp4 only with ffmpeg)")
    walls = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_wd_")
    wd = os.path.join(tmp, "work")
    res = os.path.join(wd, "results")
    try:
        t0 = time.perf_counter()
        t_render, t_png = write_workdir(dev, wd)
        walls["workdir"] = time.perf_counter() - t0
        log(f"  workdir written: GT renders {t_render:.2f} s, PNG writes {t_png:.2f} s, "
            f"reconstruction.json {os.path.getsize(os.path.join(wd, 'reconstruction.json'))} B")

        # (i) train_splats in process
        cfg = Config(
            sh_degree=3, sh_degree_interval=10, max_steps=WD_STEPS, eval_steps=[WD_STEPS],
            save_steps=[WD_STEPS], tb_every=1, test_every=8,
            strategy=DefaultStrategyCfg(refine_start_iter=5, refine_stop_iter=30,
                                        refine_every=10, reset_every=25))
        _reset_peak(dev)
        cuda_build.launch_counts.clear()
        t0 = time.perf_counter()
        trainer, hist = train_splats(wd, cfg, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls["train_splats"] = time.perf_counter() - t0
        counts = dict(cuda_build.launch_counts)
        n_val = len(trainer.val_idx)
        num_gs = [v for _, v in tb_scalars(os.path.join(res, "tb"), "train/num_GS")]
        # the capacity of 4 x the points; doubled only past 0.9 full
        require(trainer.capacity == TRAIN_CAPACITY
                or (trainer.capacity == 2 * TRAIN_CAPACITY
                    and max(num_gs) > 0.9 * TRAIN_CAPACITY),
                f"train_splats capacity {trainer.capacity}, not {TRAIN_CAPACITY}")
        require((trainer.width, trainer.height, trainer.n_images) == (W, H, WD_SHOTS),
                "train_splats scene size")
        log(f"  (i) train_splats: capacity {trainer.capacity}, {len(trainer.train_idx)} training "
            f"views, {n_val} validation; launch counts {counts}")
        for k in ("stream_bwd", "keyed_perm", "seg_reduce"):
            require(counts.get(k, 0) == WD_STEPS,
                    f"{k} launched {counts.get(k, 0)} times in {WD_STEPS} steps")
        require(counts.get("stream_fwd", 0) == WD_STEPS + n_val,
                f"stream_fwd launched {counts.get('stream_fwd', 0)} times, not "
                f"{WD_STEPS} steps + {n_val} eval renders")
        losses = [v for _, v in tb_scalars(os.path.join(res, "tb"), "train/loss")]
        require(len(losses) == WD_STEPS and all(np.isfinite(losses)), f"tb losses {losses}")
        # the reset at step 25 clamps every opacity to 0.01, so the loss
        # jumps there; it must fall from the 5 steps after it to the last 5
        after_reset = float(np.mean(losses[25:30]))
        require(float(np.mean(losses[-5:])) < after_reset,
                f"losses did not fall after the reset: {losses[25:30]} -> {losses[-5:]}")
        require(hist[-1]["loss"] == losses[-1], "history vs tb loss")
        ckpt = os.path.join(res, "ckpts", f"ckpt_{WD_STEPS}.npz")
        val_json = os.path.join(res, "stats", f"val_step{WD_STEPS:04d}.json")
        require(os.path.exists(ckpt) and os.path.exists(val_json), "checkpoint / stats JSON")
        with open(val_json) as fh:
            val = json.load(fh)
        steps_ms = (hist[-1]["time_s"] * 1e3) / WD_STEPS
        log(f"  losses (tb): {', '.join(f'{x:.4f}' for x in losses)}")
        log(f"  mean of steps 26-30 (after the reset) {after_reset:.5f}, of the last 5 "
            f"{np.mean(losses[-5:]):.5f}; alive "
            f"{int(num_gs[0])} -> {int(num_gs[-1])} (refines at 10, 20, 30, reset at 25); "
            f"eval psnr {val['psnr']:.3f}, ssim {val['ssim']:.4f}")
        log(f"  train_splats {walls['train_splats']:.2f} s (parse, load, init, "
            f"{WD_STEPS} steps, save, eval); the loop {hist[-1]['time_s']:.2f} s, "
            f"{steps_ms:.1f} ms a step (host clock, tb read every step); peak memory "
            f"{_peak_gib(dev):.2f} GiB | {card}")
        first_loss = losses[0]
        eval_with_lpips(dev, card, trainer, tmp, WD_STEPS)
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # (ii) the streaming scene
        t0 = time.perf_counter()
        parser = Parser(wd)
        ram = to_scene_data(parser)
        st_scene = to_scene_data(parser, streaming=True)
        st = st_scene.images
        diff = np.abs(st[np.arange(WD_SHOTS)] - ram.images.astype(np.float32) / 255.0)
        # PIL decodes PNG exactly; the native loader's bilinear resample
        # differs on the last row and column (tests/test_native_loader.py)
        exact = st.backend == "pil"
        why = [ln for ln in (st.native_error or "").splitlines() if "error" in ln][:1]
        log(f"  (ii) streaming scene: decoder {st.backend!r}"
            + (f" (the native loader did not build: {why[0].strip()})" if why else "")
            + f"; max abs difference to the in-RAM images {diff.max():.3g} (interior "
            f"{diff[:, 1:-1, 1:-1].max():.3g})")
        require(diff.max() == 0 if exact
                else diff[:, 1:-1, 1:-1].max() == 0 and diff.max() <= 1 / 255,
                "streaming images differ from the in-RAM images")
        scfg = lambda d: Config(sh_degree=3, max_steps=3, eval_steps=[], save_steps=[],
                                tb_every=100, result_dir=os.path.join(tmp, d),
                                camera_model="pinhole")
        tr_s = Trainer(scfg("stream"), st_scene, device=dev)
        h_s = tr_s.train(log_every=1)
        del tr_s
        tr_r = Trainer(dataclasses.replace(scfg("ram"), max_steps=1), ram, device=dev)
        h_r = tr_r.train(log_every=1)
        del tr_r
        walls["streaming"] = time.perf_counter() - t0
        require(len(h_s) == 3 and all(np.isfinite([h["loss"] for h in h_s])),
                "streaming Trainer losses")
        require(h_s[0]["loss"] == h_r[0]["loss"] if exact
                else abs(h_s[0]["loss"] - h_r[0]["loss"]) <= 1e-4 * abs(h_r[0]["loss"]),
                f"first loss streaming {h_s[0]['loss']} vs in RAM {h_r[0]['loss']}")
        require(abs(h_r[0]["loss"] - first_loss) <= 1e-6 * abs(first_loss),
                f"first loss {h_r[0]['loss']} vs train_splats' {first_loss}")
        s_losses = ", ".join(f"{h['loss']:.6f}" for h in h_s)
        log(f"  streaming Trainer, 3 steps: losses {s_losses}; the in-RAM Trainer's first "
            f"{h_r[0]['loss']:.6f}, train_splats' {first_loss:.6f}; {walls['streaming']:.2f} s")
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # (iii) the eval-only CLI run in a subprocess
        os.remove(val_json)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "splat_one_tpu_torch.app.cli", "train", wd, "--ckpt", ckpt,
             "--compression", "png", "--device", str(dev)],
            capture_output=True, text=True, timeout=900)
        walls["cli_eval"] = time.perf_counter() - t0
        require(proc.returncode == 0,
                f"cli train --ckpt exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        with open(val_json) as fh:
            val2 = json.load(fh)
        with open(os.path.join(res, "stats", f"compress_step{WD_STEPS:04d}.json")) as fh:
            comp_stats = json.load(fh)
        require(abs(val2["psnr"] - val["psnr"]) <= 1e-4 * abs(val["psnr"]),
                f"eval-only psnr {val2['psnr']} vs the trained Trainer's {val['psnr']}")
        traj_dir = os.path.join(res, "videos", f"traj_{WD_STEPS}")
        frames = sorted(os.listdir(traj_dir))
        n_interp = max(1, 60 // (WD_SHOTS - 10 - 1))
        require(len(frames) == n_interp * (WD_SHOTS - 10 - 1),
                f"{len(frames)} trajectory frames")
        with Image.open(os.path.join(traj_dir, frames[-1])) as im:
            require(im.size == (2 * W, H), f"trajectory frame size {im.size}")
        mt = [os.path.getmtime(os.path.join(traj_dir, f)) for f in frames]
        fps = (len(mt) - 1) / max(mt[-1] - mt[0], 1e-9)
        comp_dir = os.path.join(res, "compression")
        planes = sorted(os.listdir(comp_dir))
        require(len(planes) == 7 + 15 and "meta.json" in planes, f"compression planes {planes}")
        comp_bytes = sum(os.path.getsize(os.path.join(comp_dir, f)) for f in planes)
        require(np.isfinite(comp_stats["psnr"]), "compressed eval psnr")
        n_gs = comp_stats["num_GS"]
        log(f"  (iii) cli train --ckpt --compression png (subprocess, "
            f"{walls['cli_eval']:.2f} s): psnr {val2['psnr']:.3f} (in process "
            f"{val['psnr']:.3f}), compressed psnr {comp_stats['psnr']:.3f}; {len(frames)} "
            f"trajectory frames {2 * W}x{H} at {fps:.2f} frames/s (render + PNG, file "
            f"times); {len(planes)} compression files, {comp_bytes} B for {n_gs} gaussians "
            f"({comp_bytes / max(n_gs, 1):.2f} B each; the checkpoint {os.path.getsize(ckpt)} B)")

        # (iv) the viewer subprocess
        port = _free_port()
        t0 = time.perf_counter()
        viewer_log = open(os.path.join(tmp, "viewer.log"), "w+")
        viewer_proc = subprocess.Popen(
            [sys.executable, "-m", "splat_one_tpu_torch.app.cli", "viewer", wd, "--port",
             str(port), "--device", str(dev)],
            stdout=viewer_log, stderr=subprocess.STDOUT, text=True)
        try:
            url = f"http://127.0.0.1:{port}"
            deadline = time.time() + 300
            while True:
                try:
                    with urllib.request.urlopen(url + "/", timeout=10) as r:
                        require(r.status == 200 and b"<img" in r.read(), "viewer page")
                    break
                except (urllib.error.URLError, ConnectionError) as e:
                    if viewer_proc.poll() is not None:
                        viewer_log.seek(0)
                        require(False, f"viewer exited {viewer_proc.returncode}: "
                                       f"{viewer_log.read()[-3000:]}")
                    require(time.time() < deadline, f"viewer did not come up: {e!r}")
                    time.sleep(0.5)
            t_up = time.perf_counter() - t0
            req_ms = []
            for q in ("x=0&y=-0.2&z=-1.5&yaw=0&pitch=0", "x=0.3&y=-0.2&z=-1.4&yaw=-0.2&pitch=0",
                      "x=0&y=0&z=0&yaw=0&pitch=0&model=spherical"):
                t1 = time.perf_counter()
                with urllib.request.urlopen(f"{url}/render?{q}", timeout=120) as r:
                    body = r.read()
                    require(r.status == 200 and r.headers["Content-Type"] == "image/jpeg",
                            f"/render?{q}: {r.status} {r.headers['Content-Type']}")
                req_ms.append((time.perf_counter() - t1) * 1e3)
                with Image.open(io.BytesIO(body)) as im:
                    require(im.size == (W, H), f"viewer image {im.size}, not {W}x{H}")
        finally:
            viewer_proc.terminate()
            try:
                viewer_proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                viewer_proc.kill()
                viewer_proc.wait()
            viewer_log.close()
        walls["viewer"] = time.perf_counter() - t0
        log(f"  (iv) cli viewer (subprocess): up in {t_up:.2f} s; GET / 200; /render 200 "
            f"image/jpeg {W}x{H} (the Trainer's size, the page's camera 640x480): "
            f"{', '.join(f'{x:.1f}' for x in req_ms)} ms (pinhole, pinhole, spherical; "
            f"host clock through HTTP and the JPEG encode); stopped")

        # (v) the options on the same workdir at the same capacity
        t0 = time.perf_counter()
        depths = np.stack([sparse_depth_map(parser.points, parser.camtoworlds[i],
                                            parser.Ks[i], W, H) for i in range(WD_SHOTS)])
        log(f"  (v) sparse depth maps: {int((depths > 0).sum())} supervised pixels over "
            f"{WD_SHOTS} views ({time.perf_counter() - t0:.2f} s)")
        opt_steps = 6
        base = dict(sh_degree=3, max_steps=opt_steps, eval_steps=[opt_steps],
                    save_steps=[opt_steps], tb_every=100, camera_model="pinhole")
        dstrat = DefaultStrategyCfg(refine_start_iter=0, refine_stop_iter=100, refine_every=3,
                                    reset_every=1000)
        options = (
            ("a: pose_opt + bilateral grid + depth loss", ram._replace(depths=depths),
             dict(pose_opt=True, use_bilateral_grid=True, depth_loss=True, strategy=dstrat)),
            ("b: app_opt", ram, dict(app_opt=True, strategy=dstrat)),
            ("c: MCMC (MCMCStrategyCfg defaults, refine from step 0 every 3)", ram,
             dict(strategy=dataclasses.replace(MCMCStrategyCfg(), refine_start_iter=0,
                                               refine_every=3))),
        )
        for i, (label, scene, kw) in enumerate(options):
            t1 = time.perf_counter()
            ocfg = Config(result_dir=os.path.join(tmp, f"opt{i}"), **base, **kw)
            _reset_peak(dev)
            tr = Trainer(ocfg, scene, device=dev)
            require(tr.capacity == TRAIN_CAPACITY, f"{label}: capacity {tr.capacity}")
            h = tr.train(log_every=1)
            peak = _peak_gib(dev)
            ls = [x["loss"] for x in h]
            require(len(ls) == opt_steps and all(np.isfinite(ls)), f"{label}: losses {ls}")
            with open(os.path.join(tmp, f"opt{i}", "stats",
                                   f"val_step{opt_steps:04d}.json")) as fh:
                ostats = json.load(fh)
            extra = ""
            if kw.get("use_bilateral_grid"):
                require(np.isfinite(ostats.get("cc_psnr", np.nan)), f"{label}: cc_psnr")
                moved = float(tr.state.pose_params.abs().max())
                require(moved > 0, f"{label}: the pose embeddings did not move")
                extra = (f", cc_psnr {ostats['cc_psnr']:.3f}, pose max |embed| {moved:.2e}, "
                         f"depth loss {h[-1]['depthloss']:.5f}")
            if isinstance(kw["strategy"], MCMCStrategyCfg):
                ref = [x for x in h if "n_grown" in x]
                require(len(ref) == 2, f"{label}: refines {ref}")
                extra = ", refines " + "; ".join(
                    f"step {x['step']}: n_relocated {int(x['n_relocated'])}, n_grown "
                    f"{int(x['n_grown'])}" for x in ref)
            path = tr.save_checkpoint(tr.state.step)
            back = Trainer(ocfg, scene, device=dev)
            back.load_checkpoint(path)
            require(_states_equal(back.state, tr.state), f"{label}: checkpoint round trip")
            del back, tr
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            walls[f"option_{label[0]}"] = time.perf_counter() - t1
            log(f"  ({label}): losses {', '.join(f'{x:.5f}' for x in ls)}; psnr "
                f"{ostats['psnr']:.3f}{extra}; checkpoint saved and loaded back equal; "
                f"peak memory {peak:.2f} GiB; {walls[f'option_{label[0]}']:.2f} s | {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    walls["phase"] = time.perf_counter() - t_phase
    log(f"  (vi) wall times: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))
    return counts


# ---------------------------------------------------------------- main
# ------------------------------------------- phase 7: the multi-GPU slice
SLABS = 4  # phase 7: the gauss ranks whose slabs one card runs in turn
# the floats of one gaussian's projected fields in the gauss exchange
# (parallel/comm.py gather_gauss): means2d 2, conic 3, depth, radius,
# rgb 3, opacity, valid
FIELD_FLOATS = 12


def never_stopped(alpha, ts=16):
    """[C, H, W] bool from an image's alpha [C, H, W, 1]: the pixel's
    16 px tile has a pixel with T = 1 - alpha at or above TERM_THRESH, so
    its walk never stopped before the end of its stream (T only falls).
    The tile's pixels past the image's edge count as stopped."""
    import torch
    from splat_one_tpu_torch.ops.stream_raster import TERM_THRESH

    T = 1.0 - alpha[..., 0]
    C, H, W = T.shape
    Tp = torch.nn.functional.pad(T, (0, -W % ts, 0, -H % ts))
    m = Tp.reshape(C, Tp.shape[1] // ts, ts, Tp.shape[2] // ts, ts).amax((2, 4))
    m = m.repeat_interleave(ts, 1).repeat_interleave(ts, 2)[:, :H, :W]
    return m >= TERM_THRESH


def stitched_without_stop(fields, n, W, H, caps, caps_full, cm):
    """Phase 10e on phase 7's grid: each of the ``n`` slabs through
    stream_fwd at term_thresh 0, stitched, against the whole grid's
    stream_fwd at term_thresh 0 -> max abs err of (rgb, alpha, depth)."""
    import dataclasses as dc

    import torch
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.ops import stream_raster as sr
    from splat_one_tpu_torch.ops.projection import Projected
    from splat_one_tpu_torch.render.rasterization import slab_cfg

    N = fields.depths.shape[1]
    proj = Projected(*(x.detach() for x in fields))
    table = si.build_fields(proj)
    with torch.no_grad():
        cfg_s, cs_local, cs_global = slab_cfg(caps, W, H, 16, 1, N, n, cm)
        cfg_s = dc.replace(cfg_s, term_thresh=0.0)
        outs = []
        for i in range(n):
            isect = si.build_stream_intersections(proj, W, H, 16, caps, camera_model=cm,
                                                  st_lo=i * cs_local, n_st_local=cs_local)
            outs.append(sr.stream_fwd(cfg_s, isect.st_starts, si.pack_stream(table, isect, caps),
                                      i * cs_local))
        slabs = sr.stream_to_image(dc.replace(cfg_s, cs_local=0), torch.cat(outs)[:cs_global])
        cfg_f = sr.StreamCfg.from_caps(caps_full, W, H, 16, 1, N, wrap_x=cm == "spherical",
                                       term_thresh=0.0)
        isect = si.build_stream_intersections(proj, W, H, 16, caps_full, camera_model=cm)
        whole = sr.stream_to_image(cfg_f, sr.stream_fwd(cfg_f, isect.st_starts,
                                                        si.pack_stream(table, isect, caps_full)))
    return tuple(float((a - b).abs().max()) for a, b in zip(slabs, whole))


def slab_phase(dev, card, sc, scene, first_loss, max_err):
    """Phase 7 (see the module docstring). ``sc`` is the serving scene,
    ``scene`` and ``first_loss`` phase 5b's. Returns (the launch counts of
    the phase's path runs, each kernel's ms at a nonzero slab offset)."""
    import collections

    import torch
    import torch.distributed as dist
    from splat_one_tpu_torch.app.viewer import load_checkpoint_params
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import seg_broadcast as sgb
    from splat_one_tpu_torch.ops import seg_reduce as sgr
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.ops import stream_raster as sr
    from splat_one_tpu_torch.ops import tile_raster as tr
    from splat_one_tpu_torch.ops.projection import Projected, project_gaussians
    from splat_one_tpu_torch.parallel import multihost
    from splat_one_tpu_torch.render.rasterization import (composite_slab, rasterization,
                                                          slab_cfg)
    from splat_one_tpu_torch.train.trainer import Trainer
    from splat_one_tpu_torch.utils import cuda_build

    W, H, N, n = W_SERVE, H_SERVE, N_SERVE, SLABS
    path = collections.Counter()

    @contextlib.contextmanager
    def on_path():
        """The block's launches count as the slab path's, not a comparison's."""
        torch.cuda.synchronize()
        before = dict(cuda_build.launch_counts)
        yield
        torch.cuda.synchronize()
        for k, v in cuda_build.launch_counts.items():
            path[k] += v - before.get(k, 0)

    def timed(fn, reps=3):  # median host ms of fn() ending in synchronize()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    t_phase = time.perf_counter()
    names = ("means", "quats", "scales", "opac", "sh")
    leaves = [torch.tensor(sc[k], device=dev, requires_grad=True) for k in names]
    vm, K = (torch.as_tensor(sc[k], device=dev) for k in ("viewmats", "Ks"))
    diff = (0, 1, 2, 4, 5)  # the Projected fields with gradients
    offset_ms = {}
    log(f"phase 7a: the multi-GPU slice on one card: the supertile grid of the phase-4 scene "
        f"({N} gaussians, SH 3, {W}x{H}) in {n} slabs, each slab through "
        f"composite_slab, the per-rank body of parallel.tile_sharded and "
        f"parallel.ring_sharded | {card}")

    def body(i, fields, caps, cm):  # slab i's output [cs_local, NT, OUT_CH, P]
        return composite_slab(fields, i, n, W, H, 16, caps, cm)[0]

    for cm in ("pinhole", "spherical"):
        with torch.no_grad():
            psg = project_gaussians(*(x.detach() for x in leaves[:4]), vm, K, W, H,
                                    sh_coeffs=leaves[4].detach(), sh_degree=3,
                                    camera_model=cm)
        # the caps: the unsharded render's from a warm-up count, one per-slab
        # budget for every rank from the largest slab's
        _, _, sgw, sgh = si.supertile_grid(W, H, 16)
        warm = si.StreamCaps.choose(N, 1, sgw * sgh, avg_supertiles_per_gaussian=4.0)
        n_full = int(si.build_stream_intersections(psg, W, H, 16, warm,
                                                   camera_model=cm).n_isect)
        caps_full = si.StreamCaps.choose_observed(n_full, sgw * sgh)
        _, cs_local, cs_global = slab_cfg(warm, W, H, 16, 1, N, n)
        warm_s = si.StreamCaps.choose(N, 1, cs_local, avg_supertiles_per_gaussian=4.0)
        n_slab = [int(si.build_stream_intersections(
            psg, W, H, 16, warm_s, camera_model=cm, st_lo=i * cs_local,
            n_st_local=cs_local).n_isect) for i in range(n)]
        require(sum(n_slab) == n_full, f"{cm}: the slabs' intersections {n_slab} do not add "
                f"up to the grid's {n_full}")
        caps = si.StreamCaps.choose_observed(max(n_slab), cs_local)
        cfg_s = slab_cfg(caps, W, H, 16, 1, N, n, cm)[0]
        full_cfg = dataclasses.replace(cfg_s, cs_local=0)
        log(f"  {cm}: {cs_global} supertiles in {n} slabs of {cs_local} "
            f"({n * cs_local - cs_global} phantom); slab intersections {n_slab} (the whole "
            f"grid's {n_full}); per-slab caps exp_cap {caps.exp_cap}")

        # the unsharded step: loss sum(rgb) + sum(depth) + sum(alpha), RGB+D
        def unsharded():
            return rasterization(*leaves[:4], leaves[4], vm, K, W, H, sh_degree=3,
                                 render_mode="RGB+D", camera_model=cm, caps=caps_full)

        def unsharded_step():
            r, a, _ = unsharded()
            return torch.autograd.grad(r.sum() + a.sum(), leaves)

        render_u, alpha_u, info_u = unsharded()
        require(not bool(info_u["overflow"]), f"{cm}: unsharded overflow")
        grads_u = torch.autograd.grad(render_u.sum() + alpha_u.sum(), leaves)
        render_u, alpha_u = render_u.detach(), alpha_u.detach()
        with torch.no_grad():
            req_u = timed(unsharded)
        step_u = timed(unsharded_step)

        # every slab from the whole projection, stitched
        proj = project_gaussians(*leaves[:4], vm, K, W, H, sh_coeffs=leaves[4], sh_degree=3,
                                 camera_model=cm)
        fields = Projected(*(x.detach().requires_grad_(i in diff) for i, x in enumerate(proj)))
        with on_path():
            outs = [body(i, fields, caps, cm) for i in range(n)]
        rgb, alpha, depth = sr.stream_to_image(full_cfg, torch.cat(outs)[:cs_global])
        # a tile stops at the first chunk start where all its pixels have
        # T < TERM_THRESH, and a slab's chunks start elsewhere in a
        # supertile's stream than the whole grid's: where a tile may have
        # stopped, one render keeps a tail the other drops, at most
        # T x colour < TERM_THRESH x the largest colour (ROADMAP Queue 3,
        # early termination). Those pixels are held to twice that (alpha's
        # colour is 1), the others to 1e-5
        c_max = max(1.0, float(fields.colors.detach().abs().max()))
        stop_bar = (2 * sr.TERM_THRESH * c_max, 2 * sr.TERM_THRESH)
        free = (never_stopped(alpha_u) & never_stopped(alpha)).detach()
        d_rgb = (rgb - render_u[..., :3]).detach().abs().amax(-1)
        d_a = (alpha - alpha_u).detach().abs()[..., 0]
        e_rgb, e_a = float(d_rgb[free].max()), float(d_a[free].max())
        s_rgb = float(d_rgb[~free].max()) if bool((~free).any()) else 0.0
        s_a = float(d_a[~free].max()) if bool((~free).any()) else 0.0
        e_d = float((depth - render_u[..., 3:]).detach().abs().max())
        require(max(e_rgb, e_a) <= 1e-5 and s_rgb <= stop_bar[0] and s_a <= stop_bar[1]
                and e_d <= 1e-4,
                f"{cm}: stitched slabs vs unsharded: rgb {e_rgb:.2e} / {s_rgb:.2e}, alpha "
                f"{e_a:.2e} / {s_a:.2e} (tiles that never stopped / may have), depth "
                f"{e_d:.2e}")
        # each slab's backward (autograd adds the slabs' field gradients),
        # then the projection's backward once
        with on_path():
            gf = torch.autograd.grad(rgb.sum() + depth.sum() + alpha.sum(),
                                     [fields[i] for i in diff])
        gp = torch.autograd.grad([proj[i] for i in diff], leaves, grad_outputs=gf)
        worst = 0.0
        for name, a, b in zip(names, gp, grads_u):
            rel = float((a - b).abs().max() / b.abs().max())
            require(rel <= GRAD_RTOL, f"{cm}: the slabs' {name} gradient rel err {rel:.2e}")
            worst = max(worst, rel)
        log(f"  {cm}: stitched slabs vs the unsharded render: rgb {e_rgb:.2e}, alpha "
            f"{e_a:.2e} (bar 1e-5) on the {int(free.sum())} pixels of tiles that never "
            f"stopped early, rgb {s_rgb:.2e} (bar 2 x TERM_THRESH x the largest colour "
            f"{c_max:.3f} = {stop_bar[0]:.2e}), alpha {s_a:.2e} (bar {stop_bar[1]:.0e}) on the "
            f"{int((~free).sum())} of tiles that may have; accumulated depth {e_d:.2e} (bar "
            f"1e-4); the slabs' "
            f"summed gradients vs the unsharded step's: worst rel {worst:.2e} of each "
            f"gradient's max (bar {GRAD_RTOL})")

        # (10e) with term_thresh 0 no tile stops early: the stitched slabs
        # against the unsharded grid within 1e-5 on every pixel
        e0 = stitched_without_stop(fields, n, W, H, caps, caps_full, cm)
        log(f"  {cm}, term_thresh 0 (10e): stitched slabs vs the unsharded stream_fwd: rgb "
            f"{e0[0]:.2e}, alpha {e0[1]:.2e} on all {W * H} pixels (bar 1e-5); depth "
            f"{e0[2]:.2e} (bar 1e-4)")
        require(max(e0[:2]) <= 1e-5 and e0[2] <= 1e-4,
                f"{cm}: stitched slabs at term_thresh 0 differ by {e0}")

        # per-slab times: the body's forward, and with its backward to the fields
        leaf = torch.cat(outs).detach()[:cs_global].requires_grad_(True)
        r2, a2, d2 = sr.stream_to_image(full_cfg, leaf)
        g_cat, = torch.autograd.grad(r2.sum() + d2.sum() + a2.sum(), leaf)
        g_cat = torch.cat([g_cat, g_cat.new_zeros((n * cs_local - cs_global,)
                                                  + tuple(g_cat.shape[1:]))])
        del outs, rgb, alpha, depth, gf, gp, r2, a2, d2, leaf
        slab_req, slab_step = [], []
        for i in range(n):
            gi = g_cat[i * cs_local:(i + 1) * cs_local]
            with torch.no_grad():
                slab_req.append(timed(lambda: body(i, fields, caps, cm)))
            slab_step.append(timed(lambda: torch.autograd.grad(
                body(i, fields, caps, cm), [fields[j] for j in diff],
                grad_outputs=gi)))
        with torch.no_grad():
            proj_ms = timed(lambda: project_gaussians(
                *(x.detach() for x in leaves[:4]), vm, K, W, H, sh_coeffs=leaves[4].detach(),
                sh_degree=3, camera_model=cm))
            shard_ms = timed(lambda: project_gaussians(
                *(x.detach()[:N // n] for x in leaves[:4]), vm, K, W, H,
                sh_coeffs=leaves[4].detach()[:N // n], sh_degree=3, camera_model=cm))
        log(f"  {cm}: per slab (host clock, synchronized, median of 3): build + composite "
            f"{', '.join(f'{x:.3f}' for x in slab_req)} ms; with the backward to the fields "
            f"{', '.join(f'{x:.3f}' for x in slab_step)} ms; the slowest slab {max(slab_req):.3f}"
            f" / {max(slab_step):.3f} ms; unsharded request {req_u:.3f} ms, fwd+bwd step "
            f"{step_u:.3f} ms (both with the projection: of all {N} gaussians "
            f"{proj_ms:.3f} ms, of one rank's {N // n} {shard_ms:.3f} ms) | {card}")
        if cm == "pinhole":
            field_bytes = FIELD_FLOATS * 4 * (N // n)
            slab_bytes = cs_local * cfg_s.nt * sr.OUT_CH * cfg_s.npix * 4
            sent = 2 * (n - 1) * field_bytes + (n - 1) * slab_bytes
            log(f"  the exchange a gauss rank would send per step (1 camera, {n} gauss ranks, "
                f"counted from the shapes, as a ring all_gather sends them): {n - 1} shards' "
                f"fields ({field_bytes / 1e6:.1f} MB each) in the fields' all_gather and "
                f"{n - 1} in its reduce_scatter back, and {n - 1} x {slab_bytes / 1e6:.1f} MB "
                f"of slab outputs in the slabs' all_gather: {sent / 1e6:.1f} MB")

        # the kernels at slab 1's nonzero offset against their plain versions
        # (the compositing kernels and the reduction at the pinhole pose:
        # the spherical slab's 956-chunk stream would hold the plain
        # backward for minutes; the spherical offsets are in the stitched
        # render and gradients above)
        st_lo = cs_local
        name = f"slab 1 of {n} ({cm}, offset {st_lo})"
        if cm == "pinhole":
            isect = si.build_stream_intersections(psg, W, H, 16, caps, camera_model=cm,
                                                  st_lo=st_lo, n_st_local=cs_local)
            packed = si.pack_stream(si.build_fields(psg), isect, caps)
            e, out_k, _ = compare_fwd(name, cfg_s, isect.st_starts, packed, st_lo)
            max_err["stream_fwd"] = max(max_err["stream_fwd"], e)
            # the reading of an offset one supertile off, for scale beside
            # the stitched render's bars: the bars must see it
            wrong = sr.stream_fwd(cfg_s, isect.st_starts, packed, st_lo + 1)
            e_off = float((wrong - out_k)[:, :, :4].abs().max())
            require(e_off > stop_bar[0], f"{name}: an offset one supertile off reads only "
                    f"{e_off:.2e}, within the stitched render's bar {stop_bar[0]:.2e}")
            log(f"  {name}: the same slab at an offset one supertile off reads max abs "
                f"{e_off:.3e} on rgb/alpha against the right offset's output (the stitched "
                f"render's bars: 1e-5 and {stop_bar[0]:.2e})")
            del wrong
            gout = g_cat[st_lo:st_lo + cs_local].contiguous()
            st, st_al = isect.st_starts, isect.st_starts_al
            e_b, e_r, pg, perm, bounds = compare_bwd(name, cfg_s, st, st_al, packed, out_k,
                                                     gout, N, st_lo)
            max_err["stream_bwd"] = max(max_err["stream_bwd"], e_b)
            max_err["seg_reduce"] = max(max_err["seg_reduce"], e_r)
        probs = [seg_broadcast_problem(psg, W, H, cm, i * cs_local, cs_local)
                 for i in range(n)]
        windows = [sgb.required_slab(p[4], p[6], caps.exp_cap) for p, _ in probs]
        prob, grid = probs[1]
        compare_seg_broadcast(name, prob, grid, caps.exp_cap, windows[1])
        # every slab's build through the seg_broadcast kernel (the observed
        # windows): the default expansion's layout
        want = [si.build_stream_intersections(psg, W, H, 16, caps, camera_model=cm,
                                              st_lo=i * cs_local, n_st_local=cs_local)
                for i in range(n)]
        caps_k = dataclasses.replace(caps, sb_slab=max(windows))
        with seg_broadcast_path("kernel"), on_path():
            got = [si.build_stream_intersections(psg, W, H, 16, caps_k, camera_model=cm,
                                                 st_lo=i * cs_local, n_st_local=cs_local)
                   for i in range(n)]
        for i, (a, b) in enumerate(zip(got, want)):
            for f in a._fields:
                require(bool(torch.equal(getattr(a, f), getattr(b, f))),
                        f"{cm}: slab {i}: {f} through the seg_broadcast kernel differs")
        log(f"  {cm}: the {n} slab builds through the seg_broadcast kernel (windows "
            f"{windows}{', segmented spherical parents' if grid.segmented else ''}) give the "
            f"default expansion's layouts")
        if cm == "pinhole":
            okv, pbases, offs_pad = sgb.coverage_windows(prob[4], prob[6], caps.exp_cap,
                                                         windows[1])
            sb_args = (*prob[:4], prob[5], offs_pad, pbases, caps.exp_cap, grid, windows[1])
            offset_ms["stream_fwd"] = cuda_ms(
                lambda: sr.stream_fwd(cfg_s, st, packed, st_lo), 20)
            offset_ms["stream_bwd"] = cuda_ms(
                lambda: sr.stream_bwd(cfg_s, st, st_al, packed, out_k, gout, st_lo), 10)
            offset_ms["keyed_perm"] = device_ms(
                lambda: sgr.keyed_perm(pg, N), 20, KEYED_PERM_KERNELS
            ) or cuda_ms(lambda: sgr.keyed_perm(pg, N), 20)
            offset_ms["seg_reduce"] = device_ms(
                lambda: sgr.segment_reduce_rows(pg, perm, bounds, si.GCOL_ABSDX), 20,
                ("seg_reduce_kernel",)
            ) or cuda_ms(lambda: sgr.segment_reduce_rows(pg, perm, bounds, si.GCOL_ABSDX), 20)
            offset_ms["seg_broadcast"] = device_ms(
                lambda: sgb.expand_parent_meta(*sb_args), 20, ("seg_broadcast_kernel",)
            ) or cuda_ms(lambda: sgb.expand_parent_meta(*sb_args), 20)
            del isect, packed, out_k, gout, pg, perm, bounds
        del proj, fields, g_cat, got, want
        torch.cuda.empty_cache()
        log(f"  {cm}: done at {time.perf_counter() - t_phase:.1f} s into the phase")

    # (b) the tiled kernels at a tile offset, on the phase-4b layout
    t_b = time.perf_counter()
    with torch.no_grad():
        psg = project_gaussians(*(x.detach() for x in leaves[:4]), vm, K, W, H,
                                sh_coeffs=leaves[4].detach(), sh_degree=3)
    cfg_f, st_f, pk_f, _ = tile_inputs(dict(w=W, h=H, camera_model="pinhole"), psg)
    nt = -(-cfg_f.ct // n)
    tile_lo = nt
    caps_t = itx.IsectCaps.choose(N, 1, nt)
    isect_t = itx.build_intersections(psg, W, H, 16, caps_t, tile_lo=tile_lo,
                                      n_tiles_local=nt)
    require(not bool(isect_t.overflow), "tile slab overflow")
    cfg_t = dataclasses.replace(cfg_f, align_cap=caps_t.align_cap, ct_local=nt)
    log(f"phase 7b: tile_fwd / tile_bwd at tile offset {tile_lo}: tiles [{tile_lo}, "
        f"{tile_lo + nt}) of the {cfg_f.ct} of phase 4b's pinhole layout | {card}")
    tf = [x.detach().clone().requires_grad_(True)
          for x in (psg.means2d, psg.conics, psg.colors, psg.opacities, psg.depths)]
    rng = np.random.default_rng(7)
    gout_t = torch.as_tensor(rng.normal(size=(nt, tr.OUT_CH, cfg_t.npix)).astype(np.float32),
                             device=dev)
    with on_path():
        out_t = tr.composite_tiles(cfg_t, *tf, isect_t, tile_offset=tile_lo)
        torch.autograd.grad(out_t, tf, grad_outputs=gout_t)
    out_f = tr.tile_fwd(cfg_f, st_f, pk_f)
    require(bool(torch.equal(out_t.detach(), out_f[tile_lo:tile_lo + nt])),
            "the tile slab's forward differs from the whole layout's tiles")
    del out_f, pk_f, st_f
    packed_t = itx.pack_fields(psg.means2d, psg.conics, psg.colors, psg.opacities,
                               psg.depths, isect_t)
    st_t = isect_t.tile_starts
    name = f"tile slab 1 of {n} (offset {tile_lo})"
    e, out_k, _ = compare_tile_fwd(name, cfg_t, st_t, packed_t, tile_lo)
    max_err["tile_fwd"] = max(max_err["tile_fwd"], e)
    e_b, _, _ = compare_tile_bwd(name, cfg_t, st_t, packed_t, out_k, gout_t, tile_lo)
    max_err["tile_bwd"] = max(max_err["tile_bwd"], e_b)
    offset_ms["tile_fwd"] = cuda_ms(lambda: tr.tile_fwd(cfg_t, st_t, packed_t, tile_lo), 20)
    offset_ms["tile_bwd"] = cuda_ms(
        lambda: tr.tile_bwd(cfg_t, st_t, packed_t, out_k, gout_t, tile_lo), 10)
    log(f"  the slab's forward equals the whole layout's tiles bit for bit; tile_fwd "
        f"{offset_ms['tile_fwd']:.4f} ms, tile_bwd {offset_ms['tile_bwd']:.4f} ms at the "
        f"offset (CUDA events) | {card}")
    log(f"  at slab 1's offsets (pinhole): stream_fwd {offset_ms['stream_fwd']:.4f} ms, "
        f"stream_bwd {offset_ms['stream_bwd']:.4f} ms (CUDA events); keyed_perm "
        f"{offset_ms['keyed_perm']:.4f} ms, seg_reduce {offset_ms['seg_reduce']:.4f} ms, "
        f"seg_broadcast "
        f"{offset_ms['seg_broadcast']:.4f} ms (device time; CUDA events where the profiler "
        f"saw none) | {card}")
    del psg, tf, out_t, out_k, packed_t, isect_t, leaves
    torch.cuda.empty_cache()
    log(f"  (b) {time.perf_counter() - t_b:.1f} s")

    # (c) the mesh Trainer in a world of one rank on NCCL
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        multihost.initialize(0, 1, 0, "127.0.0.1", _free_port(), device="cuda",
                             timeout_s=300)
        require(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = multihost.global_mesh(1, 1)
        trainer = Trainer(phase5b_config(tmp), scene, mesh=mesh)
        log(f"phase 7c: Trainer(mesh=global_mesh(1, 1)) on NCCL ({mesh.device}), phase 5b's "
            f"scene and capacity, {TRAIN_STEPS} steps, per-slab exp_cap "
            f"{trainer.caps.exp_cap} | {card}")
        t0 = time.perf_counter()
        with on_path():
            hist = trainer.train(log_every=1)
        train_s = time.perf_counter() - t0
        losses = [h["loss"] for h in hist]
        n_gs = [h["num_GS"] for h in hist]
        require(len(hist) == TRAIN_STEPS and all(np.isfinite(losses)), f"losses {losses}")
        require(all(h["overflow"] == 0 for h in hist), "mesh Trainer overflow")
        require(n_gs[2] != n_gs[1], f"the refine at step 3 left the alive count at {n_gs[1]}")
        rel = abs(losses[0] - first_loss) / abs(first_loss)
        require(rel <= 1e-5, f"first mesh loss {losses[0]} vs phase 5b's {first_loss}")
        params, alive = load_checkpoint_params(f"{tmp}/ckpts/ckpt_{TRAIN_STEPS}.npz")
        require(int(alive.sum()) == n_gs[-1] and params["means"].shape[0] == trainer.capacity,
                "the mesh checkpoint through the viewer's loader")
        saved = trainer.state
        trainer.load_checkpoint_sharded(trainer.save_checkpoint_sharded(TRAIN_STEPS))
        require(_states_equal(saved, trainer.state), "the sharded checkpoint round trip")
        dts = np.diff([0.0] + [h["time_s"] for h in hist]) * 1e3
        log(f"  losses {', '.join(f'{x:.5f}' for x in losses)} (first vs phase 5b's "
            f"{first_loss:.5f}: rel {rel:.2e}, bar 1e-5); alive {', '.join(map(str, n_gs))}; "
            f"the gathered checkpoint loads in the viewer, the sharded one round-trips equal")
        log(f"  step times (host clock, each ends reading the loss) "
            f"{', '.join(f'{x:.1f}' for x in dts)} ms; whole run {train_s:.1f} s | {card}")
        del trainer, saved, params, alive
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"  phase 7 launches on its paths: {dict(path)}; wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(path), offset_ms


# ------------------------------------------------- phase 8: SfM on the card
# (b): BASELINE config 3 (scripts/sfm_scale_bench.py:34-100): a two-turn
# spiral of views at 256 px, 1500 keypoints, 8 order + 6 VLAD neighbours
SFM_VIEWS, SFM_RES, SFM_KP, SFM_ORDER, SFM_VLAD = 60, 256, 1500, 8, 6
SFM_FULL_RES = 1024  # (c): the CLI's default feature_process_size
SFM_A_VIEWS, SFM_A_RES = 8, 128  # (a): the card against the CPU
SFM_TRAIN_STEPS = 20  # (d)
SFM_MEDIAN_BAR, SFM_MAX_BAR = 0.08, 0.15  # of the spread (tests/test_app_pipeline.py:133-134)


def sphere_images(dev, c2ws, Ks, W, H, R_s=5.0, seed=0):
    """The textured-sphere ray tracer of tests/test_app_pipeline.py on
    ``dev``: the same 300 plane waves drawn by numpy from ``seed``, each
    view's rays cast from its c2w and K (f32), the image normalized to
    [0, 1]. Returns uint8 [H, W] arrays."""
    import torch

    rng = np.random.default_rng(seed)
    n_wave = 300
    k = rng.normal(size=(n_wave, 3))
    k *= rng.uniform(2.0, 35.0, (n_wave, 1)) / np.linalg.norm(k, axis=1, keepdims=True)
    ph = rng.uniform(0, 2 * np.pi, n_wave)
    amp = rng.uniform(0.3, 1.0, n_wave) / np.sqrt(n_wave)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    k, ph, amp = t(k), t(ph), t(amp)
    v, u = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32) + 0.5,
                          torch.arange(W, device=dev, dtype=torch.float32) + 0.5, indexing="ij")
    out = []
    for c2w, K in zip(c2ws, Ks):
        d = torch.stack([(u - float(K[0, 2])) / float(K[0, 0]),
                         (v - float(K[1, 2])) / float(K[1, 1]), torch.ones_like(u)], -1)
        d = (d @ t(c2w[:3, :3]).T).reshape(-1, 3)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = t(c2w[:3, 3])
        b = d @ o
        tt = -b + torch.sqrt(torch.clamp(b * b - (o @ o - R_s ** 2), min=0))
        p = o + tt[:, None] * d
        img = torch.cat([torch.cos(c @ k.T + ph) @ amp for c in p.split(1 << 18)])
        img = (img - img.min()) / (img.max() - img.min())
        out.append((img.reshape(H, W) * 255).to(torch.uint8).cpu().numpy())
    return out


def spiral_cameras(n, W, H, radius=2.0, fov_deg=60.0, turns=2.0, z0=-0.6, z1=0.6):
    """scripts/sfm_scale_bench.py's look_at_spiral: n views on a two-turn
    spiral around the sphere, looking at its centre."""
    from splat_one_tpu_torch.data.synthetic import look_at

    f = 0.5 * W / np.tan(np.radians(fov_deg) / 2)
    c2ws, Ks = [], []
    for i in range(n):
        a = 2 * np.pi * turns * i / n
        h = z0 + (z1 - z0) * i / max(n - 1, 1)
        c2ws.append(look_at(np.array([radius * np.cos(a), h, radius * np.sin(a)]), np.zeros(3)))
        Ks.append(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32))
    return np.stack(c2ws), np.stack(Ks)


def sfm_workdir(dev, wd, c2ws, Ks, W, H):
    """images/view_NNN.png rendered on the card, ``extract-metadata``
    through the CLI and the true focal set through CameraModelManager (as
    scripts/sfm_scale_bench.py does). Returns the render + write seconds."""
    from PIL import Image
    from splat_one_tpu_torch.app import cli
    from splat_one_tpu_torch.app.camera_models import CameraModelManager

    t0 = time.perf_counter()
    os.makedirs(os.path.join(wd, "images"))
    for i, im in enumerate(sphere_images(dev, c2ws, Ks, W, H)):
        Image.fromarray(im).convert("RGB").save(os.path.join(wd, "images", f"view_{i:03d}.png"),
                                                compress_level=1)
    t_images = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()):
        require(cli.main(["extract-metadata", wd, "--device", str(dev)]) == 0, "extract-metadata")
    mgr = CameraModelManager(wd)
    for cam_id in list(mgr.models):
        mgr.set_override(cam_id, focal=float(Ks[0][0, 0] / W))
    mgr.save()
    require(mgr.propagate_to_exif() == len(c2ws), "focal override propagated")
    return t_images


def aligned_center_errors(wd, c2ws):
    """Camera-centre errors of the workdir's reconstruction.json against
    the GT c2ws after the similarity (Umeyama) alignment, as fractions of
    the GT centres' mean distance from their centroid; and the number of
    registered views."""
    from splat_one_tpu_torch.data.opensfm import Parser

    p = Parser(wd, normalize=False)
    idx = [int(re.findall(r"\d+", nm)[0]) for nm in p.image_names]
    A = p.camtoworlds[:, :3, 3].astype(np.float64)
    B = c2ws[idx, :3, 3].astype(np.float64)
    muA, muB = A.mean(0), B.mean(0)
    U, S, Vt = np.linalg.svd((A - muA).T @ (B - muB))
    D = np.diag([1, 1, np.sign(np.linalg.det(Vt.T @ U.T))])
    R_al = Vt.T @ D @ U.T
    scale = np.trace(np.diag(S) @ D) / np.sum((A - muA) ** 2)
    err = np.linalg.norm(scale * (A - muA) @ R_al.T + muB - B, axis=-1)
    spread = np.linalg.norm(c2ws[:, :3, 3] - c2ws[:, :3, 3].mean(0), axis=-1).mean()
    return err / spread, len(idx)


def kp_compare(fa, fb):
    """Valid keypoints of two Features matched at the same scale within
    half a pixel (a level's keypoints are >= 1 px apart): (matched index
    pairs, a's unmatched, b's unmatched)."""
    va = np.flatnonzero(fa.valid.cpu().numpy())
    vb = np.flatnonzero(fb.valid.cpu().numpy())
    xa, xb = fa.xys.cpu().numpy(), fb.xys.cpu().numpy()
    sa, sb = fa.scales.cpu().numpy(), fb.scales.cpu().numpy()
    pairs, used = [], set()
    for i in va:
        same = vb[(sb[vb] == sa[i]) & (np.abs(xb[vb] - xa[i]).max(-1) < 0.5)]
        if len(same):
            pairs.append((int(i), int(same[0])))
            used.add(int(same[0]))
    return (pairs, sorted(set(va.tolist()) - {i for i, _ in pairs}),
            sorted(set(vb.tolist()) - used))


def kp_diffs(fa, fb, pairs):
    """Max |xy|, |orientation| (mod 2 pi) and |descriptor| differences over
    matched keypoints, and whether the scales are equal."""
    ia = np.array([i for i, _ in pairs], int)
    ib = np.array([j for _, j in pairs], int)
    g = lambda f, name, i: getattr(f, name).cpu().numpy()[i]
    d_or = g(fa, "orientations", ia) - g(fb, "orientations", ib)
    return (float(np.abs(g(fa, "xys", ia) - g(fb, "xys", ib)).max(initial=0)),
            float(np.abs((d_or + np.pi) % (2 * np.pi) - np.pi).max(initial=0)),
            float(np.abs(g(fa, "descriptors", ia) - g(fb, "descriptors", ib)).max(initial=0)),
            bool(np.array_equal(g(fa, "scales", ia), g(fb, "scales", ib))))


def two_view_scene(n=200, noise=1e-3, outliers=0.3, seed=0):
    """tests/test_sfm_geometry.py's synth_two_view: bearings of n points
    seen from two poses, noise on the bearings, the first outliers * n of
    camera 2's replaced by random directions. Returns f32 (b1, b2)."""
    import torch
    from splat_one_tpu_torch.sfm.ba import _rodrigues

    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3))
    X[:, 2] += 4.0
    R = _rodrigues(torch.tensor([0.05, -0.1, 0.02])).double().numpy()
    b1 = X / np.linalg.norm(X, axis=-1, keepdims=True)
    X2 = X @ R.T + np.array([0.8, 0.1, -0.05])
    b2 = X2 / np.linalg.norm(X2, axis=-1, keepdims=True)
    b1 = b1 + rng.normal(0, noise, b1.shape)
    b2 = b2 + rng.normal(0, noise, b2.shape)
    b1 /= np.linalg.norm(b1, axis=-1, keepdims=True)
    b2 /= np.linalg.norm(b2, axis=-1, keepdims=True)
    n_out = int(outliers * n)
    d = rng.normal(size=(n_out, 3))
    b2[:n_out] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return b1.astype(np.float32), b2.astype(np.float32)


def ba_problem_arrays(n_cams=6, n_pts=200, noise=1e-3, seed=0):
    """tests/test_sfm_geometry.py's TestBundleAdjust.make_problem plus its
    starting point (cameras off by 0.02, points by 0.05, camera 0 at GT):
    (cams0, X0, cam_idx, pt_idx, bearings, X)."""
    import torch
    from splat_one_tpu_torch.sfm.ba import _rodrigues

    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n_pts, 3))
    X[:, 2] += 5
    cams = []
    for i in range(n_cams):
        t_i = np.array([i * 0.4 - 1.0, 0, 0]) + rng.normal(0, 0.05, 3)
        cams.append(np.concatenate([rng.normal(0, 0.1, 3), t_i]))
    cams = np.stack(cams).astype(np.float32)
    ci, pi, bs = [], [], []
    for c in range(n_cams):
        R = _rodrigues(torch.as_tensor(cams[c, :3])).double().numpy()
        p = X @ R.T + cams[c, 3:]
        b = p / np.linalg.norm(p, axis=-1, keepdims=True) + rng.normal(0, noise, p.shape)
        bs.append(b / np.linalg.norm(b, axis=-1, keepdims=True))
        ci += [c] * n_pts
        pi += list(range(n_pts))
    rng = np.random.default_rng(1)
    cams0 = cams + rng.normal(0, 0.02, cams.shape).astype(np.float32)
    cams0[0] = cams[0]
    X0 = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    return cams0, X0, np.array(ci), np.array(pi), np.concatenate(bs), X.astype(np.float32)


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def count_syncs(fn):
    """(fn's result, the host syncs it made): torch's sync debug mode warns
    at every call that waits for the card; the warnings are counted."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def sfm_card_vs_cpu(dev, card):
    """Phase 8 (a): the same port functions on CPU tensors and on the
    card, at the CPU tests' bars."""
    import torch
    from splat_one_tpu_torch.data.synthetic import ring_cameras
    from splat_one_tpu_torch.sfm import ba as B
    from splat_one_tpu_torch.sfm import features as F
    from splat_one_tpu_torch.sfm import geometry as geo
    from splat_one_tpu_torch.sfm import matching as M

    cpu = torch.device("cpu")
    W = H = SFM_A_RES
    c2ws, Ks = ring_cameras(SFM_A_VIEWS, 2.0, -0.3, 60.0, W, H)
    imgs = [im.astype(np.float32) / 255.0 for im in sphere_images(dev, c2ws, Ks, W, H)]
    log(f"phase 8a: SfM functions on the card against the CPU: {SFM_A_VIEWS} ring views "
        f"{W}x{H} | {card}")
    feats_cpu = []
    for name, fn, from_pyr, sigmas in (
            ("extract_features", F.extract_features, F.sift_from_pyramid, F.sift_sigmas()),
            ("extract_hahog", F.extract_hahog, F.hahog_from_pyramid, F.hahog_sigmas())):
        n_kp = n_only = 0
        worst, worst_pyr, d_blur, max_moved = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 0.0, 0.0
        for im in imgs:
            # the blur in f32 on both (a TF32 convolution would differ by ~1e-3)
            levels = [F._gaussian_blur(torch.as_tensor(im), s) for s in sigmas]
            for s_, lv in zip(sigmas, levels):
                lv_card = F._gaussian_blur(torch.as_tensor(im, device=dev), s_).cpu()
                d_blur = max(d_blur, float((lv - lv_card).abs().max()))
            fa = fn(torch.as_tensor(im))
            fb = fn(torch.as_tensor(im, device=dev))
            pairs, only_a, only_b = kp_compare(fa, fb)
            # keypoints whose subpixel offset moved > 0.05 px: an ill-conditioned
            # quadratic fit the blur's rounding decides, as a one-set keypoint
            moved = [(i, j) for i, j in pairs if np.abs(
                fa.xys[i].numpy() - fb.xys[j].cpu().numpy()).max() > 0.05]
            stable = [p_ for p_ in pairs if p_ not in moved]
            dxy, dor, dde, same = kp_diffs(fa, fb, pairs)
            require(same and len(pairs) > 20,
                    f"{name} from the image: {len(pairs)} common, scales {same}")
            worst = [max(a, b) for a, b in zip(worst, kp_diffs(fa, fb, stable)[:3])]
            n_kp += len(pairs)
            n_only += len(only_a) + len(only_b) + len(moved)
            max_moved = max(max_moved, dxy)
            # the CPU's blurred levels through the card's detector: the tight bars
            fc = from_pyr([lv.to(dev) for lv in levels])
            pairs, only_a, only_b = kp_compare(fa, fc)
            dxy, dor, dde, same = kp_diffs(fa, fc, pairs)
            require(not only_a and not only_b and same and max(dxy, dor, dde) <= 1e-4,
                    f"{name} from the CPU pyramid: {only_a} {only_b} xy {dxy} or {dor} "
                    f"desc {dde} scales {same}")
            worst_pyr = [max(a, b) for a, b in zip(worst_pyr, (dxy, dor, dde))]
            if name == "extract_features":
                feats_cpu.append(fa)
        log(f"  {name}: blurred levels within {d_blur:.2e} of the CPU's (bar 1e-6); from the "
            f"image {n_kp} common valid keypoints over {SFM_A_VIEWS} images, {n_only} unstable "
            f"(in one set only, or moved > 0.05 px, up to {max_moved:.3f}: an extremum, edge "
            f"test or subpixel fit the blur's rounding decides; bar 0.5 %); the rest max |xy| "
            f"{worst[0]:.2e} px, orientation {worst[1]:.2e}, descriptor "
            f"{worst[2]:.2e}, scales equal; from the CPU's pyramid the same keypoints, |xy| "
            f"{worst_pyr[0]:.2e}, orientation {worst_pyr[1]:.2e}, descriptor "
            f"{worst_pyr[2]:.2e} (bars 1e-4)")
        require(d_blur <= 1e-6, f"{name}: the card's blur differs by {d_blur}")
        require(n_only <= max(2, 0.005 * n_kp), f"{name}: {n_only} unstable keypoints")

    descs = [f.descriptors.numpy() for f in feats_cpu]
    valids = [f.valid.numpy() for f in feats_cpu]
    pairs = M.pairs_to_match(len(descs), device=cpu)
    ma = M.match_pairs_batched(descs, valids, pairs, device=cpu)
    mb = M.match_pairs_batched(descs, valids, pairs, device=dev)
    require(set(ma) == set(mb) and all(np.array_equal(ma[p], mb[p]) for p in ma),
            "match_pairs_batched: the card's matches differ from the CPU's")
    log(f"  match_pairs_batched: {len(pairs)} pairs, {sum(len(m) for m in ma.values())} "
        f"matches, equal on the card and the CPU")

    b1, b2 = two_view_scene()
    valid = np.arange(256) < 200
    pad = lambda b: np.concatenate([b, np.tile([[0, 0, 1.0]], (56, 1)).astype(np.float32)])
    g = torch.Generator().manual_seed(0)
    for solver, n_hyp in (("8pt", 1024), ("5pt", 256)):
        u = torch.randint(0, 1 << 30, (n_hyp, 5 if solver == "5pt" else 8), generator=g)
        res = [geo.ransac_essential(u.to(d), torch.as_tensor(pad(b1), device=d),
                                    torch.as_tensor(pad(b2), device=d),
                                    torch.as_tensor(valid, device=d), threshold=0.008,
                                    solver=solver) for d in (cpu, dev)]
        inl = [r.inliers.cpu().numpy() for r in res]
        require(np.array_equal(*inl), f"ransac_essential {solver}: inlier masks differ "
                                      f"({int(inl[0].sum())} vs {int(inl[1].sum())})")
        log(f"  ransac_essential {solver}, {n_hyp} hypotheses, the same draws: "
            f"{int(inl[0].sum())} inliers of 200 (60 outliers), the same masks")
    rng = np.random.default_rng(3)
    X = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    X[:, 2] += 4
    R = B._rodrigues(torch.tensor([0.2, -0.1, 0.3])).numpy()
    p = X @ R.T + np.array([0.5, -0.2, 0.1], np.float32)
    bb = p / np.linalg.norm(p, axis=-1, keepdims=True) + rng.normal(0, 1e-3, p.shape)
    bb[:10] = rng.normal(size=(10, 3))
    bb = (bb / np.linalg.norm(bb, axis=-1, keepdims=True)).astype(np.float32)
    u = torch.randint(0, 1 << 30, (128, 6), generator=g)
    res = [geo.ransac_pnp(u.to(d), torch.as_tensor(X, device=d), torch.as_tensor(bb, device=d),
                          torch.ones(60, dtype=torch.bool, device=d), threshold=0.01)
           for d in (cpu, dev)]
    require(np.array_equal(res[0][2].cpu().numpy(), res[1][2].cpu().numpy()),
            "ransac_pnp: inlier masks differ")
    dR = float((res[0][0] - res[1][0].cpu()).abs().max())
    log(f"  ransac_pnp, 128 hypotheses, the same draws: {int(res[0][3])} inliers of 60 (10 "
        f"outliers), the same masks; |R| diff {dR:.2e}")

    cams0, X0, ci, pi, bs, Xgt = ba_problem_arrays()
    out = {}
    for d in (cpu, dev):
        prob = B.build_problem(ci, pi, bs, 6, 200, device=d)
        c0, x0 = torch.as_tensor(cams0, device=d), torch.as_tensor(X0, device=d)
        fn = lambda: B.bundle_adjust(c0, x0, prob, B.BAConfig(max_iterations=15,
                                                              cg_iterations=25))
        if d.type == "cuda":  # the first call in the process, then a warm one
            _, n_sync_cold = count_syncs(fn)
            out[d.type], n_sync = count_syncs(fn)
        else:
            out[d.type], n_sync, n_sync_cold = fn(), None, None
    out.setdefault("cuda", out["cpu"])  # a CPU rehearsal compares the CPU with itself
    (ca, xa, ia), (cb, xb, ib) = out["cpu"], out["cuda"]
    fa, fb = float(ia["final_cost"]), float(ib["final_cost"])
    ext = float((Xgt.max(0) - Xgt.min(0)).max())
    dc = float((ca - cb.cpu()).abs().max()) / ext
    dx = float((xa - xb.cpu()).abs().max()) / ext
    log(f"  bundle_adjust (6 cameras, 200 points, 15 LM x 25 CG): final cost cpu {fa:.9g} "
        f"card {fb:.9g} (rel {abs(fa - fb) / fa:.2e}, bar 1e-4); cameras {dc:.2e}, points "
        f"{dx:.2e} of the extent (bar 1e-4); host syncs in the card's call: {n_sync} (the "
        f"process's first call: {n_sync_cold})")
    require(abs(fa - fb) <= 1e-4 * fa and dc <= 1e-4 and dx <= 1e-4,
            "bundle_adjust: the card's solution differs from the CPU's")
    return n_sync


@contextlib.contextmanager
def sfm_timers():
    """Wall time (synchronized) and call count of the SfM's device pieces
    (ransac_essential, ransac_pnp, triangulate, decompose_essential,
    bundle_adjust) and of the reconstruction's host-side triangulation and
    reprojection checks (triangulate_nview, _reproj_ok) wherever the
    stages call them; also keeps the arguments of every bundle_adjust
    call."""
    import collections

    from splat_one_tpu_torch.sfm import ba as B
    from splat_one_tpu_torch.sfm import geometry as geo
    from splat_one_tpu_torch.sfm import reconstruct as RC

    spent = collections.defaultdict(float)
    calls = collections.Counter()
    ba_calls = []
    originals = {(mod, name): getattr(mod, name) for mod, name in (
        (geo, "ransac_essential"), (geo, "ransac_pnp"), (geo, "triangulate"),
        (geo, "decompose_essential"), (B, "bundle_adjust"), (RC, "triangulate_nview"),
        (RC, "_reproj_ok"))}
    host = {"triangulate_nview", "_reproj_ok"}

    def wrap(name, fn):
        def timed(*a, **kw):
            if name not in host:
                _sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if name not in host:
                _sync()
            spent[name] += time.perf_counter() - t0
            calls[name] += 1
            if name == "bundle_adjust":
                ba_calls.append((a, kw))
            return out
        return timed

    for (mod, name), fn in originals.items():
        setattr(mod, name, wrap(name, fn))
    try:
        yield spent, calls, ba_calls
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)


def sfm_scale_run(dev, card, tmp):
    """Phase 8 (b): BASELINE config 3 through the port's CLI on the card."""
    from splat_one_tpu_torch.app import cli
    from splat_one_tpu_torch.sfm import ba as B
    from splat_one_tpu_torch.sfm.reconstruct import ReconstructConfig

    n, W = SFM_VIEWS, SFM_RES
    wd = os.path.join(tmp, "spiral")
    c2ws, Ks = spiral_cameras(n, W, W)
    log(f"phase 8b: SfM at the repo's scale (BASELINE config 3): {n} spiral views {W}x{W}, "
        f"{SFM_KP} keypoints, {SFM_ORDER} order + {SFM_VLAD} VLAD neighbours, through the "
        f"port's CLI on the card | {card}")
    walls = {"images + metadata": sfm_workdir(dev, wd, c2ws, Ks, W, W)}
    stages = [
        ("detect-features", ["--max-keypoints", str(SFM_KP), "--feature-process-size", str(W)]),
        ("match-features", ["--order-neighbors", str(SFM_ORDER), "--vlad-neighbors",
                            str(SFM_VLAD)]),
        ("create-tracks", []), ("reconstruct", [])]
    peaks = {}
    with sfm_timers() as (spent, calls, ba_calls):
        for name, extra in stages:
            if name == "reconstruct":
                spent_before, calls_before = dict(spent), dict(calls)
            _reset_peak(dev)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([name, wd, "--device", str(dev)] + extra)
            walls[name] = time.perf_counter() - t0
            peaks[name] = _peak_gib(dev)
            require(rc == 0, f"cli {name} exited {rc}")
            if name == "reconstruct":
                text = buf.getvalue()
                report = json.loads(text[text.index("{"): text.rindex("}") + 1])
            log(f"  cli {name}: {walls[name]:.2f} s, peak memory {peaks[name]:.2f} GiB; the "
                f"device pieces so far: " + ", ".join(
                    f"{k} {calls[k]}x {spent[k]:.2f} s" for k in sorted(calls)))
        spent, calls = dict(spent), dict(calls)
    with open(os.path.join(wd, "matches", "matches.json")) as fh:
        n_pairs = len(json.load(fh))
    with open(os.path.join(wd, "tracks.json")) as fh:
        n_tracks = len(json.load(fh))
    err, n_reg = aligned_center_errors(wd, c2ws)
    med, mx = float(np.median(err)), float(err.max())
    log(f"  {n_reg}/{n} views registered, {report['n_points']} points, {n_pairs} verified "
        f"pairs, {n_tracks} tracks, init attempts {report.get('init_attempts')}; aligned "
        f"centre error median {med:.4f}, max {mx:.4f} of the spread (bars {SFM_MEDIAN_BAR}, "
        f"{SFM_MAX_BAR}; the JAX package on the CPU: 0.0023 median, BASELINE.md:75)")
    require(n_reg == n and report["n_images"] == n, f"{n_reg} of {n} views registered")
    require(med < SFM_MEDIAN_BAR and mx < SFM_MAX_BAR, f"centre errors {med} / {mx}")
    # the final global bundle, replayed: LM iterations/s and host syncs
    final_iters = ReconstructConfig().final_bundle_max_iterations
    a, kw = [c for c in ba_calls if c[0][3].max_iterations == final_iters][-1]
    cams, pts, problem, cfg = a
    B.bundle_adjust(*a, **kw)  # warm
    _sync()
    t0 = time.perf_counter()
    B.bundle_adjust(*a, **kw)
    _sync()
    ba_s = time.perf_counter() - t0
    local_iters = ReconstructConfig().local_bundle_max_iterations
    la, lkw = [c for c in ba_calls if c[0][3].max_iterations == local_iters][-1]
    n_sync = n_sync_local = None
    if dev.type == "cuda":
        _, n_sync = count_syncs(lambda: B.bundle_adjust(*a, **kw))
        _, n_sync_local = count_syncs(lambda: B.bundle_adjust(*la, **lkw))
    n_edges = int(problem.valid.sum())
    log(f"  final global bundle: {cams.shape[0]} cameras (padded), {pts.shape[0]} points "
        f"(padded), {n_edges} edges of {problem.valid.shape[0]}, {cfg.max_iterations} LM x "
        f"{cfg.cg_iterations} CG iterations in {ba_s * 1e3:.1f} ms = "
        f"{cfg.max_iterations / ba_s:.1f} LM iterations/s (host clock, synchronized); host "
        f"syncs per bundle_adjust call: {n_sync} (global), {n_sync_local} (local) | {card}")
    rec_spent = {k: spent[k] - spent_before.get(k, 0.0) for k in spent}
    rec_calls = {k: calls[k] - calls_before.get(k, 0) for k in calls}
    rest = walls["reconstruct"] - sum(rec_spent.values())
    log(f"  reconstruct's {walls['reconstruct']:.2f} s: " + ", ".join(
        f"{k} {rec_spent[k]:.2f} s over {rec_calls[k]} calls"
        for k in sorted(rec_spent, key=rec_spent.get, reverse=True))
        + f", the rest of the host loop {rest:.2f} s; stage walls "
        + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))
    return wd, dict(walls=walls, peaks=peaks, med=med, mx=mx, lm_its=cfg.max_iterations / ba_s,
                    n_sync=n_sync)


def sfm_full_width(dev, card, tmp):
    """Phase 8 (c): detect-features and match-features at the CLI's
    defaults on the same poses rendered at 1024x1024."""
    from splat_one_tpu_torch.app import cli, pipeline
    from splat_one_tpu_torch.sfm import matching as M

    n, W = SFM_VIEWS, SFM_FULL_RES
    wd = os.path.join(tmp, "full")
    c2ws, Ks = spiral_cameras(n, W, W)
    log(f"phase 8c: the CLI's defaults at full width: the {n} poses at {W}x{W}, "
        f"detect-features (2048 keypoints, feature_process_size 1024) and match-features "
        f"(brute force, + {SFM_ORDER} order and {SFM_VLAD} VLAD neighbours) | {card}")
    t_img = sfm_workdir(dev, wd, c2ws, Ks, W, W)
    walls = {}
    for name, extra in (("detect-features", []),
                        ("match-features", ["--order-neighbors", str(SFM_ORDER),
                                            "--vlad-neighbors", str(SFM_VLAD)])):
        _reset_peak(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            require(cli.main([name, wd, "--device", str(dev)] + extra) == 0, f"cli {name}")
        walls[name] = (time.perf_counter() - t0, _peak_gib(dev))
    images = pipeline._images(wd)
    feats = pipeline._load_features(wd, images)
    n_valid = np.array([int(feats[nm]["valid"].sum()) for nm in images])
    with open(os.path.join(wd, "matches", "matches.json")) as fh:
        kept = [len(m) for m in json.load(fh).values()]
    descs = [feats[nm]["descriptors"] for nm in images]
    valids = [feats[nm]["valid"] for nm in images]
    pairs = M.pairs_to_match(n, order_neighbors=SFM_ORDER, descriptors=descs,
                             desc_valids=valids, vlad_neighbors=SFM_VLAD, device=dev)
    _sync()
    t0 = time.perf_counter()
    raw = M.match_pairs_batched(descs, valids, pairs, device=dev)
    _sync()
    t_match = time.perf_counter() - t0
    bearings = [feats[nm]["bearings"] for nm in images]
    ang = float(np.median([float(feats[nm]["angular_res"]) for nm in images]))
    t0 = time.perf_counter()
    M.robust_filter_matches_batched(raw, bearings, threshold=min(1.6 * ang, 0.008), device=dev)
    _sync()
    t_verify = time.perf_counter() - t0
    n_raw = [len(m) for m in raw.values()]
    log(f"  images + metadata {t_img:.2f} s; valid keypoints per image: mean "
        f"{n_valid.mean():.0f}, min {n_valid.min()}, max {n_valid.max()}")
    log(f"  {len(pairs)} candidate pairs, {int(np.mean(n_raw))} putative matches a pair "
        f"(mean); {len(kept)} pairs kept with {sum(kept)} verified matches "
        f"({np.mean(kept):.0f} a pair)")
    for name, (s, peak) in walls.items():
        log(f"  cli {name}: {s:.2f} s, peak memory {peak:.2f} GiB | {card}")
    log(f"  a pair: batched matching {t_match / len(pairs) * 1e3:.2f} ms, batched verification "
        f"{t_verify / max(len(raw), 1) * 1e3:.2f} ms (host clock, synchronized; "
        f"{t_match:.2f} s and {t_verify:.2f} s in all)")
    require(n_valid.min() > 300 and len(kept) > n and sum(kept) > 1000,
            "too few keypoints or verified pairs at full width")
    return dict(walls=walls, match_ms=t_match / len(pairs) * 1e3,
                verify_ms=t_verify / max(len(raw), 1) * 1e3)


def sfm_train(dev, card, wd):
    """Phase 8 (d): ``cli train --max-steps 20`` on (b)'s workdir, from the
    port's own reconstruction.json. Trainer.train logs every step here (the
    CLI's default logs the last one only) so the loss can be read."""
    import functools

    from splat_one_tpu_torch.app import cli
    from splat_one_tpu_torch.app import pipeline
    from splat_one_tpu_torch.train.trainer import Trainer
    from splat_one_tpu_torch.utils import cuda_build

    log(f"phase 8d: cli train --max-steps {SFM_TRAIN_STEPS} on 8b's workdir (the port's SfM "
        f"output) | {card}")
    got = {}
    orig_train, orig_stage = Trainer.train, pipeline.train_splats

    def stage(*a, **kw):
        got["trainer"], got["hist"] = orig_stage(*a, **kw)
        return got["trainer"], got["hist"]

    Trainer.train = functools.partialmethod(orig_train, log_every=1)
    pipeline.train_splats = stage
    try:
        _reset_peak(dev)
        cuda_build.launch_counts.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["train", wd, "--max-steps", str(SFM_TRAIN_STEPS), "--device",
                           str(dev)])
        wall = time.perf_counter() - t0
    finally:
        Trainer.train, pipeline.train_splats = orig_train, orig_stage
    counts = dict(cuda_build.launch_counts)
    require(rc == 0, f"cli train exited {rc}")
    losses = [h["loss"] for h in got["hist"]]
    tr = got["trainer"]
    log(f"  {tr.n_images} images {tr.width}x{tr.height}, {int(tr._n_alive())} gaussians from "
        f"the SfM points (capacity {tr.capacity}); launches {counts}; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; {wall:.2f} s, peak memory "
        f"{_peak_gib(dev):.2f} GiB | {card}")
    require(len(losses) == SFM_TRAIN_STEPS and all(np.isfinite(losses)), "train losses")
    require(float(np.mean(losses[-5:])) < float(np.mean(losses[:5])), "the loss did not fall")
    for k in ("stream_fwd", "stream_bwd") if dev.type == "cuda" else ():
        require(counts.get(k, 0) >= SFM_TRAIN_STEPS, f"{k} launched {counts.get(k, 0)} times")
    return counts


def sfm_phase(dev, card):
    """Phase 8 (see the module docstring)."""
    t_phase = time.perf_counter()
    out = {"n_sync_a": sfm_card_vs_cpu(dev, card)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sfm_")
    try:
        wd, out["b"] = sfm_scale_run(dev, card, tmp)
        out["d"] = sfm_train(dev, card, wd)
        out["c"] = sfm_full_width(dev, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 8 wall {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------- phase 9: the rest of the Features and Matching stages
FEAT_RES = 1024  # (a): the CLI's feature_process_size, one spiral view rendered at it
FEAT_KP = 2048  # (a), (b): the CLI's max_keypoints; LightGlue's keypoints a side
FEAT_VIEWS = 24  # (c): the first views of 8b's spiral (cut from 60 for the phase's budget)
FEAT_UNSTABLE = 0.005  # (a) from the image: at most this share of keypoints unstable
MAP_TOL = 1e-4  # (a): ALIKED's score and feature maps, card vs CPU, abs
LG_TOL = 1e-3  # (b): the trainable tier's scores, card vs CPU, abs
# (b): the official forward's error against a float64 run on the CPU, of
# its largest entry: the f32 bound of the longest reduction (K = 2048 keys,
# K * 2^-24). cuBLAS sums a near-uniform attention row over the 2048 keys
# ~20x less exactly than the CPU's blocked sum (both within the bound)
LG_RTOL = 2048 * 2.0 ** -24
SURF_THR = 500.0  # (a): OpenCV's scale; the default 3000 finds no keypoint on this view at 1024 px


def _warm_ms(fn, dev, reps=3):
    """(fn's result, the median ms of ``reps`` warm synchronized calls,
    their peak device memory in GiB)."""
    fn()
    _sync()
    _reset_peak(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times), _peak_gib(dev)


def _outcome(fa, fb):
    """Card against CPU features from the same image: (common keypoints,
    unstable ones: in one set only or moved > 0.05 px; the stable ones'
    max |xy|, |orientation|, |descriptor| differences, scales equal)."""
    pairs, only_a, only_b = kp_compare(fa, fb)
    moved = [(i, j) for i, j in pairs if np.abs(
        fa.xys[i].cpu().numpy() - fb.xys[j].cpu().numpy()).max() > 0.05]
    stable = [p_ for p_ in pairs if p_ not in moved]
    return len(pairs), len(only_a) + len(only_b) + len(moved), kp_diffs(fa, fb, stable)


def _exact(name, fa, fb, tol=1e-4):
    """The tight bars: the same valid keypoints, xys, orientations and
    descriptors within ``tol``, scales equal."""
    pairs, only_a, only_b = kp_compare(fa, fb)
    dxy, dor, dde, same = kp_diffs(fa, fb, pairs)
    require(not only_a and not only_b and same and max(dxy, dor, dde) <= tol and len(pairs) > 20,
            f"{name}: {len(pairs)} common, {only_a[:5]} {only_b[:5]}, xy {dxy} or {dor} desc "
            f"{dde} scales {same}")
    return len(pairs), dxy, dor, dde


def detectors_card_vs_cpu(dev, card):
    """Phase 9 (a): each new detector on the card against the port on the
    CPU, one spiral view at FEAT_RES. Returns the rows, ALIKED n16's
    parameters (for (c)) and its card features of views 0 and 1 (for (b))."""
    import torch
    from splat_one_tpu_torch.models import aliked_tpu as AL
    from splat_one_tpu_torch.sfm import akaze as AK
    from splat_one_tpu_torch.sfm import orb as OR
    from splat_one_tpu_torch.sfm import surf as SU
    from splat_one_tpu_torch.sfm.features import _f32_conv

    cpu = torch.device("cpu")
    # the parity runs' numerics: matmuls in f32, and the convolution scope
    # switches cuDNN's TF32 off whatever the global flag says
    require(not torch.backends.cuda.matmul.allow_tf32, "matmul TF32 is on")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    with _f32_conv():
        require(not torch.backends.cudnn.allow_tf32, "_f32_conv left cuDNN's TF32 on")
    torch.backends.cudnn.allow_tf32 = prev
    W, K = FEAT_RES, FEAT_KP
    c2ws, Ks = spiral_cameras(SFM_VIEWS, W, W)
    ims = [torch.as_tensor(im.astype(np.float32) / 255.0)
           for im in sphere_images(dev, c2ws[:2], Ks[:2], W, W)]
    img_c, img_d = ims[0], ims[0].to(dev)
    log(f"phase 9a: the new detectors on the card against the CPU: spiral view 0 at {W}x{W}, "
        f"{K} keypoints | {card}")
    n16_c = AL.init_aliked_ckpt("aliked-n16", device=cpu)
    n16_d = {k: v.to(dev) for k, v in n16_c.items()}
    cmp_c = AL.init_aliked(128, device=cpu)
    cmp_d = {k: v.to(dev) for k, v in cmp_c.items()}
    dets = [
        ("ORB", lambda a, p: OR.extract_orb(a, max_keypoints=K), None),
        ("AKAZE MSURF", lambda a, p: AK.extract_akaze(a, K), "levels"),
        ("AKAZE MLDB", lambda a, p: AK.extract_akaze(a, K, descriptor="MLDB"), "levels"),
        ("SURF", lambda a, p: SU.extract_surf(a, K, hessian_threshold=SURF_THR), "integral"),
        ("ALIKED aliked-n16", lambda a, p: AL.extract_aliked_ckpt(p, a, K), "weights"),
        ("ALIKED compact", lambda a, p: AL.extract_aliked(p, a, K), "weights"),
    ]
    out = {}
    for name, fn, shared in dets:
        p_c, p_d = (n16_c, n16_d) if "n16" in name else (cmp_c, cmp_d)
        t0 = time.perf_counter()
        fa = fn(img_c, p_c)
        cpu_s = time.perf_counter() - t0
        fb, ms, peak = _warm_ms(lambda: fn(img_d, p_d), dev)
        n_common, n_unstable, (dxy, dor, dde, same) = _outcome(fa, fb)
        n_valid = int(fa.valid.sum())
        require(same and n_common > 100, f"{name}: {n_common} common, scales {same}")
        require(n_unstable <= max(2, FEAT_UNSTABLE * n_common),
                f"{name}: {n_unstable} unstable keypoints of {n_common}")
        if name == "ORB":
            # BRIEF bits of the stable keypoints: a differing bit is a near tie
            pairs = kp_compare(fa, fb)[0]
            ia, ib = [i for i, _ in pairs], [j for _, j in pairs]
            bits = fa.descriptors[ia].numpy() != fb.descriptors[ib].cpu().numpy()
            require(bits.mean() <= 1e-3, f"ORB: {bits.sum()} BRIEF bits differ")
            tight = f"BRIEF bits differing {int(bits.sum())} of {bits.size} (bar 0.1 %)"
        elif shared == "levels":
            kw = dict(descriptor="MLDB") if "MLDB" in name else {}
            levels = AK.akaze_evolution(img_c)
            fc = AK.akaze_from_evolution(levels, K, **kw)
            fd = AK.akaze_from_evolution([[(L.to(dev), s) for L, s in o] for o in levels], K, **kw)
            n, exy, eor, ede = _exact(f"{name} from the CPU's levels", fc, fd)
            tight = (f"from the CPU's {sum(len(o) for o in levels)} levels: the same {n} "
                     f"keypoints, |xy| {exy:.2e}, orientation {eor:.2e}, descriptor {ede:.2e}")
        elif shared == "integral":
            ii = SU._integral(img_c * 255.0)
            ii_d = SU._integral(img_d * 255.0).cpu()
            fc = SU.surf_from_integral(img_c, ii, K, hessian_threshold=SURF_THR)
            fd = SU.surf_from_integral(img_d, ii.to(dev), K, hessian_threshold=SURF_THR)
            n, exy, eor, ede = _exact(f"{name} from the CPU's integral image", fc, fd)
            tight = (f"the card's integral image within {float((ii - ii_d).abs().max()):.3g} of "
                     f"the CPU's (max {float(ii.max()):.4g}); from the CPU's: the same {n} "
                     f"keypoints, |xy| {exy:.2e}, orientation {eor:.2e}, descriptor {ede:.2e}")
        else:
            compact = "compact" in name
            pad = lambda t: t[None, ..., None] if compact else t[..., None].expand(
                t.shape + (3,))[None]
            enc = AL.aliked_forward if compact else AL.aliked_encoder
            s_c, f_c = enc(p_c, pad(img_c))
            s_d, f_d = enc(p_d, pad(img_d))
            es = float((s_c - s_d.cpu()).abs().max())
            ef = float((f_c - f_d.cpu()).abs().max())
            require(max(es, ef) <= MAP_TOL, f"{name}: maps differ by {es} / {ef}")
            tight = f"the same weights: score map within {es:.2e}, features {ef:.2e}"
            if not compact:
                xy = fa.xys
                dc = AL.sddh_descriptors(p_c, f_c[0], xy, K=3, M=16)
                dd = AL.sddh_descriptors(p_d, f_c[0].to(dev), xy.to(dev), K=3, M=16)
                ed = float((dc - dd.cpu()).abs().max())
                require(ed <= 1e-4, f"{name}: SDDH at the CPU's keypoints differs by {ed}")
                tight += f" (bar {MAP_TOL}); SDDH at shared keypoints {ed:.2e} (bar 1e-4)"
            del s_c, f_c, s_d, f_d
        log(f"  {name}: {n_valid} valid keypoints; from the image {n_common} common, "
            f"{n_unstable} unstable (bar {FEAT_UNSTABLE:.1%}), the rest |xy| {dxy:.2e} px, "
            f"orientation {dor:.2e}, descriptor {dde:.2e}; {tight}; card {ms:.2f} ms an image "
            f"(median of 3, host clock, synchronized), peak memory {peak:.3f} GiB; CPU "
            f"{cpu_s:.2f} s | {card}")
        out[name] = dict(ms=ms, peak=peak, n_valid=n_valid, unstable=n_unstable)
        if "n16" in name:
            f0 = fb
    f1 = AL.extract_aliked_ckpt(n16_d, ims[1].to(dev), K)
    return out, n16_c, (f0, f1)


def lightglue_card_vs_cpu(dev, card, feats):
    """Phase 9 (b): LightGlue at full width with random weights, the card
    against the CPU on the card's ALIKED n16 features of two views."""
    import torch
    from splat_one_tpu_torch.models import lightglue_tpu as LG

    cpu = torch.device("cpu")
    fa, fb = feats
    size = (FEAT_RES, FEAT_RES)
    sd_c = LG.init_lightglue_ckpt(device=cpu)  # 128 -> 256, 9 layers, 4 heads
    sd_d = {k: v.to(dev) for k, v in sd_c.items()}
    args = [t.cpu().numpy() for t in (fa.xys, fb.xys, fa.descriptors, fb.descriptors)]
    n_layers = sum(k.endswith("self_attn.Wqkv.weight") for k in sd_c)
    log(f"phase 9b: LightGlue, the official forward at full width with random weights: input "
        f"{args[2].shape[1]}, {sd_c['input_proj.weight'].shape[0]} wide, {n_layers} layers, 4 "
        f"heads, {len(args[0])} x {len(args[1])} keypoints (9a's ALIKED n16, views 0 and 1) "
        f"| {card}")
    t0 = time.perf_counter()
    s_c = LG.lightglue_forward_ckpt(sd_c, *args, size, size)
    cpu_s = time.perf_counter() - t0
    s_d, ms, peak = _warm_ms(lambda: LG.lightglue_forward_ckpt(sd_d, *args, size, size), dev)
    err = float((s_c - s_d.cpu()).abs().max())
    # 9 random layers grow the logits: rounding, not the port, sets the gap;
    # both f32 runs are held against the same forward in float64
    s_64 = LG.lightglue_forward_ckpt({k: v.double() for k, v in sd_c.items()}, *args, size, size)
    e_cpu = float((s_c.double() - s_64).abs().max())
    e_card = float((s_d.cpu().double() - s_64).abs().max())
    bar = LG_RTOL * float(s_64.abs().max())
    m_c, ok_c = LG.filter_matches_ckpt(s_c)
    m_d, ok_d = LG.filter_matches_ckpt(s_d)
    agree = float(np.mean(m_c == m_d))
    log(f"  log-assignment {tuple(s_d.shape)}: card within {err:.2e} of the CPU (max |s| "
        f"{float(s_c.abs().max()):.3g}); against float64 on the CPU: card {e_card:.2e}, CPU f32 "
        f"{e_cpu:.2e} (bar {bar:.2e}: 2048 x 2^-24 of max |s|); argmax rows "
        f"equal {agree:.4f} (random weights leave near-equal rows), matches kept "
        f"{int(ok_c.sum())} / {int(ok_d.sum())}; card {ms:.2f} ms a pair (median of 3), peak "
        f"memory {peak:.3f} GiB; CPU {cpu_s:.2f} s | {card}")
    require(bool(torch.isfinite(s_d).all()) and max(e_card, e_cpu) <= bar,
            f"LightGlue: the errors {e_card} (card), {e_cpu} (CPU) against float64 exceed {bar}")
    p_c = LG.init_lightglue(args[2].shape[1], device=cpu)
    p_d = {k: v.to(dev) for k, v in p_c.items()}
    va, vb = fa.valid.cpu().numpy(), fb.valid.cpu().numpy()
    xy = [a / np.float32(FEAT_RES) for a in args[:2]]
    t = lambda a, d, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=d)
    sc = LG.lightglue_scores(p_c, t(args[2], cpu), t(args[3], cpu), t(xy[0], cpu),
                             t(xy[1], cpu), t(va, cpu, torch.bool), t(vb, cpu, torch.bool))
    sd_, ms_t, _ = _warm_ms(lambda: LG.lightglue_scores(
        p_d, t(args[2], dev), t(args[3], dev), t(xy[0], dev), t(xy[1], dev),
        t(va, dev, torch.bool), t(vb, dev, torch.bool)), dev)
    errs = [float((a - b.cpu()).abs().max()) for a, b in zip(sc, sd_)]
    _, ms_m, _ = _warm_ms(lambda: LG.match_lightglue(p_d, args[2], args[3], args[0], args[1], size,
                                                    size, va, vb), dev)
    log(f"  trainable tier ({LG.N_LAYERS} layers, {LG.DIM} wide): sim, ma, mb within "
        f"{errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e} of the CPU (bar {LG_TOL}); card "
        f"{ms_t:.2f} ms a pair (scores), {ms_m:.2f} ms with the assignment and host copies | "
        f"{card}")
    require(max(errs) <= LG_TOL, f"trainable LightGlue differs by {errs}")
    return dict(ms=ms, err=e_card, ms_trainable=ms_t), sd_c


def stages_through_cli(dev, card, tmp, aliked_params, lg_params):
    """Phase 9 (c): the Features and Matching stages of the new detectors
    and LightGlue through the CLI, then create-tracks and reconstruct, on
    the first FEAT_VIEWS views of 8b's spiral at 256 px."""
    from splat_one_tpu_torch.app import cli, pipeline
    from splat_one_tpu_torch.models import aliked_tpu as AL
    from splat_one_tpu_torch.models import lightglue_tpu as LG

    n, W = FEAT_VIEWS, SFM_RES
    c2ws, Ks = spiral_cameras(SFM_VIEWS, W, W)
    c2ws, Ks = c2ws[:n], Ks[:n]
    base = os.path.join(tmp, "feat_base")
    sfm_workdir(dev, base, c2ws, Ks, W, W)
    al_npz, lg_npz = os.path.join(tmp, "aliked_n16.npz"), os.path.join(tmp, "lightglue.npz")
    np.savez(al_npz, **AL.params_to_numpy(aliked_params))
    np.savez(lg_npz, **LG.params_to_numpy(lg_params))
    log(f"phase 9c: the stages through the CLI on the first {n} of 8b's {SFM_VIEWS} spiral views "
        f"(cut for the phase's budget) at {W}x{W}: detect-features --max-keypoints {SFM_KP} "
        f"--feature-process-size {W}, match-features --order-neighbors {SFM_ORDER} "
        f"--vlad-neighbors {SFM_VLAD}, create-tracks, reconstruct | {card}")
    runs = [("ORB", [], []), ("AKAZE", [], []), ("SURF", [], []),
            ("ALIKED", ["--aliked-checkpoint", al_npz],
             ["--matching-type", "lightglue", "--lightglue-checkpoint", lg_npz])]
    out = {}
    for ft, det_extra, match_extra in runs:
        wd = os.path.join(tmp, f"feat_{ft}")
        shutil.copytree(base, wd)
        walls = {}
        stages = [("detect-features", ["--feature-type", ft, "--max-keypoints", str(SFM_KP),
                                       "--feature-process-size", str(W)] + det_extra),
                  ("match-features", ["--order-neighbors", str(SFM_ORDER), "--vlad-neighbors",
                                      str(SFM_VLAD)] + match_extra),
                  ("create-tracks", []), ("reconstruct", [])]
        report = None
        for name, extra in stages:
            if name == "reconstruct" and n_tracks == 0:
                break
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([name, wd, "--device", str(dev)] + extra)
            walls[name] = time.perf_counter() - t0
            require(rc == 0, f"{ft}: cli {name} exited {rc}")
            if name == "create-tracks":
                with open(os.path.join(wd, "tracks.json")) as fh:
                    n_tracks = len(json.load(fh))
            if name == "reconstruct":
                text = buf.getvalue()
                report = json.loads(text[text.index("{"): text.rindex("}") + 1])
        images = pipeline._images(wd)
        feats = pipeline._load_features(wd, images)
        kp = np.array([int(feats[nm]["valid"].sum()) for nm in images])
        require(all(feats[nm]["xys"].shape == (SFM_KP, 2) for nm in images), f"{ft}: npz shapes")
        with open(os.path.join(wd, "matches", "matches.json")) as fh:
            kept = [len(m) for m in json.load(fh).values()]
        if report is not None and report.get("n_images", 0) >= 3:
            err, n_reg = aligned_center_errors(wd, c2ws)
            rec = (f"{n_reg}/{n} views registered, centre error median {np.median(err):.4f}, "
                   f"max {err.max():.4f} of the spread")
        elif report is not None:
            n_reg = report.get("n_images", 0)
            rec = f"{n_reg}/{n} views registered"
        else:
            n_reg = 0
            rec = "reconstruct not run: no tracks" + (
                " (random weights match nothing)" if match_extra else "")
        log(f"  {ft}{' + LightGlue' if match_extra else ''}: valid keypoints a view mean "
            f"{kp.mean():.0f} (min {kp.min()}, max {kp.max()}); {len(kept)} verified pairs, "
            f"{sum(kept)} matches; {n_tracks} tracks; {rec}; walls " + ", ".join(
                f"{k} {v:.2f} s" for k, v in walls.items()) + f" | {card}")
        out[ft] = dict(kp=float(kp.mean()), pairs=len(kept), registered=n_reg, walls=walls)
        shutil.rmtree(wd, ignore_errors=True)
    return out


def rig_scene(n_inst=8, n_pts=60, noise=1e-3, seed=0):
    """tests/test_rigs.py's stereo rig orbiting a point cloud, with the
    starting point of its constrained-BA test: (GT X, edges (cam, point,
    bearing), shot ids, assignments, start cameras, start points)."""
    from splat_one_tpu_torch.sfm import rigs as RG

    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    rel = np.array([0.0, 0.05, 0.0, 0.2, 0.0, 0.01])
    poses, assign = {}, {}
    for i in range(n_inst):
        ang = 2 * np.pi * i / n_inst
        c = np.array([3 * np.sin(ang), 0.3 * np.sin(2 * ang), 3 * np.cos(ang)])
        z = -c / np.linalg.norm(c)
        x = np.cross(np.array([0, 1.0, 0]), z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        inst = np.concatenate([RG._R_to_rvec(R), -R @ c])
        poses[f"s{i}_L"], poses[f"s{i}_R"] = inst, RG.compose(rel, inst)
        assign[f"i{i}"] = [(f"s{i}_L", "camL"), (f"s{i}_R", "camR")]
    shot_ids = sorted(poses)
    cams_gt = np.stack([poses[s] for s in shot_ids]).astype(np.float32)
    ci, pi, bs = [], [], []
    for k, s in enumerate(shot_ids):
        p = X @ RG._rvec_to_R(cams_gt[k, :3]).T + cams_gt[k, 3:]
        b = p / np.linalg.norm(p, axis=-1, keepdims=True) + rng.normal(0, noise, p.shape)
        bs.append(b / np.linalg.norm(b, axis=-1, keepdims=True))
        ci += [k] * n_pts
        pi += list(range(n_pts))
    rng = np.random.default_rng(4)
    cams0 = cams_gt + rng.normal(0, 0.01, cams_gt.shape).astype(np.float32)
    cams0[0] = cams_gt[0]
    X0 = (X + rng.normal(0, 0.03, X.shape)).astype(np.float32)
    return (X, (np.array(ci), np.array(pi), np.concatenate(bs).astype(np.float32)), shot_ids,
            assign, cams0, X0)


def rigs_card_vs_cpu(dev, card):
    """Phase 9 (d): rig_constrained_adjust on the card against the CPU."""
    import torch
    from splat_one_tpu_torch.sfm import ba as B
    from splat_one_tpu_torch.sfm import rigs as RG

    X, (ci, pi, bs), shot_ids, assign, cams0, X0 = rig_scene()
    res = {}
    for d in (torch.device("cpu"), dev):
        prob = B.build_problem(ci, pi, bs, len(shot_ids), len(X), device=d)
        t0 = time.perf_counter()
        res[d.type] = RG.rig_constrained_adjust(prob, cams0, X0, shot_ids, assign,
                                                cfg=B.BAConfig(max_iterations=8, cg_iterations=20),
                                                rounds=2)
        _sync()
        res[d.type + "_s"] = time.perf_counter() - t0
    (ca, xa, cal_a, ia), (cb, xb, cal_b, ib) = res["cpu"], res[dev.type]
    fa, fb = float(ia["final_cost"]), float(ib["final_cost"])
    ext = float((X.max(0) - X.min(0)).max())
    dc, dx = float(np.abs(ca - cb).max()) / ext, float(np.abs(xa - xb).max()) / ext
    drel = float(np.abs(cal_a["camR"] - cal_b["camR"]).max())
    log(f"phase 9d: rig_constrained_adjust (8 instances x 2 cameras, 60 points, 2 rounds of 8 LM "
        f"x 20 CG): final cost cpu {fa:.9g} card {fb:.9g} (rel {abs(fa - fb) / fa:.2e}, bar "
        f"1e-4); cameras {dc:.2e}, points {dx:.2e} of the extent, the calibrated relative "
        f"{drel:.2e} (bars 1e-4); card {res[dev.type + '_s']:.2f} s, CPU {res['cpu_s']:.2f} s "
        f"| {card}")
    require(abs(fa - fb) <= 1e-4 * fa and max(dc, dx, drel) <= 1e-4,
            "rig_constrained_adjust: the card's solution differs from the CPU's")
    for i in range(8):
        got = RG.compose(cb[shot_ids.index(f"s{i}_R")], RG.invert(cb[shot_ids.index(f"s{i}_L")]))
        require(np.allclose(got, cal_b["camR"], atol=1e-6), "the card's poses leave the rig")


def features_phase(dev, card):
    """Phase 9 (see the module docstring)."""
    t_phase = time.perf_counter()
    out = {}
    out["a"], n16_c, feats = detectors_card_vs_cpu(dev, card)
    out["b"], lg_c = lightglue_card_vs_cpu(dev, card, feats)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_feat_")
    try:
        out["c"] = stages_through_cli(dev, card, tmp, n16_c, lg_c)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rigs_card_vs_cpu(dev, card)
    log(f"  phase 9 wall {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------- phase 10: the Masks and Depth stages, LPIPS, term_thresh
SAM_CONFIG = "hiera_l"  # (b): sam2.1_hiera_large, the reference's masks tab
SAM_IMG = (1280, 720)  # (b): the image, W x H, resized to 1024 x 1024 by set_image
DEPTH_RES = 518  # (c): DA-V2's input (37 x 37 patches)
# (c): DA-V2 Large's DPT out_channels (DepthAnything/Depth-Anything-V2 run.py
# model_configs); its width, depth, heads and features are CONFIGS["vitl"]
DAV2_VITL_OUT = (256, 512, 1024, 1024)
# (b), (c): card vs CPU, of each output's largest entry: the f32 bound of
# the longest reduction on the path (hiera_l's MLP, 4 x 1152 = 4608 terms;
# DA-V2 vitl's 4 x 1024 = 4096) times 2^-24, widened 4x for the depth of
# the stacks (48 and 24 blocks) that carry it
SAM_RTOL = 4 * 4608 * 2.0 ** -24
DEPTH_RTOL = 4 * 4096 * 2.0 ** -24
LPIPS_RTOL = 1e-5  # (a): card vs CPU
MD_VIEWS = 8  # (d): the first views of 8b's spiral
TERMS = (0.0, 1e-5, 1e-3)  # (e): the early-stop thresholds
LPIPS_ENV = "SPLAT_ONE_TPU_LPIPS_WEIGHTS"


def _empty_cache():
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _scripts_path():
    """scripts/ of this checkout on sys.path (its weight converters import
    numpy and torch only)."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    if d not in sys.path:
        sys.path.insert(0, d)


@contextlib.contextmanager
def lpips_weights(path):
    """LPIPS' weight file for the block: ``$SPLAT_ONE_TPU_LPIPS_WEIGHTS``
    (what subprocesses read) and ``models.lpips.DEFAULT_WEIGHTS`` (what
    this process read at import) set to ``path``; ``None``: the variable
    unset and the default a path with no file. Both restored after."""
    from splat_one_tpu_torch.models import lpips as LP

    old_env, old_default = os.environ.get(LPIPS_ENV), LP.DEFAULT_WEIGHTS
    d = tempfile.mkdtemp(prefix="chip_smoke_nolpips_")
    try:
        if path is None:
            os.environ.pop(LPIPS_ENV, None)
            LP.DEFAULT_WEIGHTS = os.path.join(d, "none.npz")
        else:
            os.environ[LPIPS_ENV] = LP.DEFAULT_WEIGHTS = path
        yield
    finally:
        LP.DEFAULT_WEIGHTS = old_default
        if old_env is None:
            os.environ.pop(LPIPS_ENV, None)
        else:
            os.environ[LPIPS_ENV] = old_env
        shutil.rmtree(d, ignore_errors=True)


def lpips_weight_file(d, seed=0):
    """Random weights of LPIPS' AlexNet (torchvision's feature convs) and
    linear heads in their published torch layouts, through
    scripts/convert_weights.py's convert_lpips -> the .npz path."""
    import torch

    _scripts_path()
    from convert_weights import convert_lpips

    rng = np.random.default_rng(seed)
    shapes = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3),
              (256, 256, 3, 3)]
    anet, lins = {}, {}
    for i, (j, s) in enumerate(zip((0, 3, 6, 8, 10), shapes)):
        anet[f"features.{j}.weight"] = torch.tensor(rng.normal(scale=0.05, size=s)
                                                    .astype(np.float32))
        anet[f"features.{j}.bias"] = torch.tensor(rng.normal(scale=0.05, size=s[0])
                                                  .astype(np.float32))
        lins[f"lins.{i}.model.1.weight"] = torch.tensor(
            rng.uniform(0.0, 0.2, size=(1, s[0], 1, 1)).astype(np.float32))
    torch.save(anet, os.path.join(d, "alex.pth"))
    torch.save(lins, os.path.join(d, "lin.pth"))
    out = os.path.join(d, "lpips_alex.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        convert_lpips(os.path.join(d, "alex.pth"), os.path.join(d, "lin.pth"), out)
    return out


def eval_with_lpips(dev, card, trainer, tmp, step):
    """Phase 10a's second half, on phase 5e's trainer: Trainer.eval with
    an LPIPS weight file reports a finite LPIPS, its renders launched
    through stream_fwd."""
    import torch
    from splat_one_tpu_torch.utils import cuda_build

    path = lpips_weight_file(tmp)
    with lpips_weights(path):
        _sync()
        n0 = cuda_build.launch_counts["stream_fwd"]
        t0 = time.perf_counter()
        stats = trainer.eval(step, stage="lpips")
        wall = time.perf_counter() - t0
        n = cuda_build.launch_counts["stream_fwd"] - n0
    n_val = len(trainer.val_idx)
    log(f"  (10a) Trainer.eval with ${LPIPS_ENV} set (random AlexNet + heads through "
        f"convert_lpips): lpips {stats['lpips']}, psnr {stats['psnr']:.3f}; stream_fwd "
        f"launched {n} times for {n_val} val renders; {wall:.2f} s | {card}")
    require(stats["lpips"] is not None and np.isfinite(stats["lpips"]),
            f"eval lpips {stats['lpips']}")
    require(n == n_val, f"stream_fwd launched {n} times in an eval of {n_val} views")


def lpips_card_vs_cpu(dev, card, tmp, imgs):
    """Phase 10a: LPIPS on a 1280x720 pair, the card against the CPU."""
    import torch
    from splat_one_tpu_torch.models import lpips as LP

    path = lpips_weight_file(tmp)
    p_c, p_d = LP.load_weights(path, device="cpu"), LP.load_weights(path, device=dev)
    x, y = (torch.as_tensor(np.repeat(im[None, ..., None], 3, -1).astype(np.float32) / 255.0)
            for im in imgs)
    t0 = time.perf_counter()
    v_c = float(LP.lpips(p_c, x, y))
    cpu_s = time.perf_counter() - t0
    xd, yd = x.to(dev), y.to(dev)
    v_d, ms, peak = _warm_ms(lambda: float(LP.lpips(p_d, xd, yd)), dev)
    rel = abs(v_d - v_c) / abs(v_c)
    f_errs = [_rel_err(a, b) for a, b in zip(LP._alex_features(p_d, xd * 2 - 1),
                                             LP._alex_features(p_c, x * 2 - 1))]
    log(f"phase 10a: LPIPS (AlexNet, random weights through convert_lpips) on a "
        f"{x.shape[2]}x{x.shape[1]} pair of phase 8's views: card {v_d!r}, CPU {v_c!r} "
        f"(rel {rel:.2e}, bar {LPIPS_RTOL}); the five feature maps of the first image card vs "
        f"CPU {', '.join(f'{e:.2e}' for e in f_errs)} of their largest entries; card "
        f"{ms:.2f} ms a pair (median of 3, host clock, synchronized), peak memory "
        f"{peak:.3f} GiB; CPU {cpu_s:.2f} s | {card}")
    require(np.isfinite(v_d) and rel <= LPIPS_RTOL and max(f_errs) <= LPIPS_RTOL,
            f"LPIPS card {v_d} vs CPU {v_c}, features {f_errs}")
    return dict(ms=ms, rel=rel)


def _rel_err(a, b):
    """max |a - b| over max |b| (a, b tensors or arrays; a on any device)."""
    import torch

    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    require(a.shape == b.shape, f"shapes {a.shape} vs {b.shape}")
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def sam2_card_vs_cpu(dev, card, tmp, rgb):
    """Phase 10b: SAM 2.1 hiera_l (random_checkpoint) and the compact
    tier, the card against the CPU on one image. Returns the .npz path."""
    import torch
    from splat_one_tpu_torch.models import sam2_hiera as SM

    t0 = time.perf_counter()
    path = os.path.join(tmp, f"sam2_{SAM_CONFIG}.npz")
    np.savez(path, **SM.random_checkpoint(SAM_CONFIG, seed=0))
    setup_s = time.perf_counter() - t0
    cfg = SM.CONFIGS[SAM_CONFIG]
    H0, W0 = rgb.shape[:2]
    log(f"phase 10b: SAM 2.1 {SAM_CONFIG} (embed {cfg['embed_dim']}, heads "
        f"{cfg['num_heads']}, stages {cfg['stages']}, global {cfg['global_att']}, windows "
        f"{cfg['window_spec']}), random_checkpoint weights ({os.path.getsize(path) / 2**30:.2f} "
        f"GiB npz, {setup_s:.1f} s), a {W0}x{H0} view of phase 8's scene | {card}")
    p_c = SM.SAM2Predictor(path, config=SAM_CONFIG, device="cpu")
    p_d = SM.SAM2Predictor(path, config=SAM_CONFIG, device=dev)
    log(f"  the predictors' input {p_d.img_size}x{p_d.img_size}")
    t0 = time.perf_counter()
    p_c.set_image(rgb)
    cpu_s = time.perf_counter() - t0
    _, set_ms, peak = _warm_ms(lambda: p_d.set_image(rgb), dev)
    (e_c, (s0_c, s1_c)), (e_d, (s0_d, s1_d)) = p_c._emb, p_d._emb
    errs = {"embed": _rel_err(e_d, e_c), "s0": _rel_err(s0_d, s0_c),
            "s1": _rel_err(s1_d, s1_c)}
    clicks = np.array([[W0 * 0.5, H0 * 0.5], [W0 * 0.1, H0 * 0.1], [W0 * 0.7, H0 * 0.4],
                       [W0 * 0.3, H0 * 0.8]], np.float32)
    labels = np.array([1, 0, 1, 0])
    pred_ms = {}
    for k in (1, 2, 4):
        (m_d, iou_d, l_d), ms, _ = _warm_ms(lambda: p_d.predict(clicks[:k], labels[:k]), dev)
        m_c, iou_c, l_c = p_c.predict(clicks[:k], labels[:k])
        pred_ms[k] = ms
        errs[f"logits {k}"] = _rel_err(l_d, l_c)
        errs[f"iou {k}"] = _rel_err(iou_d, iou_c)
        sure = np.abs(l_c) > SAM_RTOL * np.abs(l_c).max()
        require(np.array_equal((l_d > 0)[sure], (l_c > 0)[sure]),
                f"SAM2 mask signs differ beyond the bar ({k} clicks)")
        n_diff = int((m_d != m_c).sum())
        if np.array_equal(l_d > 0, l_c > 0):
            require(n_diff == 0, f"SAM2 masks differ ({k} clicks)")
        errs[f"mask px {k}"] = n_diff
    log(f"  card vs CPU (max err / max |CPU|; bar {SAM_RTOL:.2e}): " + ", ".join(
        f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}" for k, v in errs.items()))
    log(f"  set_image {set_ms:.1f} ms (median of 3, host clock, synchronized; PIL resize "
        f"in), peak memory {peak:.2f} GiB; predict {', '.join(f'{k} click(s) {v:.2f} ms' for k, v in pred_ms.items())} "
        f"(3 masks, PIL resize out); CPU set_image {cpu_s:.1f} s | {card}")
    require(all(v <= SAM_RTOL for k, v in errs.items() if isinstance(v, float)),
            f"SAM2 card vs CPU: {errs}")
    # the compact tier, from the same seeded init on both
    c_c, c_d = SM.HieraPredictor(device="cpu"), SM.HieraPredictor(device=dev)
    c_c.set_image(rgb)
    _, cset_ms, _ = _warm_ms(lambda: c_d.set_image(rgb), dev)
    (cm_c, ci_c, cl_c) = c_c.predict(clicks[:2], labels[:2])
    (cm_d, ci_d, cl_d), cpred_ms, _ = _warm_ms(lambda: c_d.predict(clicks[:2], labels[:2]), dev)
    cerr = {"embed": _rel_err(c_d._emb, c_c._emb), "logits": _rel_err(cl_d, cl_c),
            "iou": _rel_err(ci_d, ci_c)}
    sure = np.abs(cl_c) > SAM_RTOL * np.abs(cl_c).max()
    log(f"  compact tier (seeded init): card vs CPU {', '.join(f'{k} {v:.2e}' for k, v in cerr.items())} "
        f"(bar {SAM_RTOL:.2e}), mask pixels differing {int((cm_d != cm_c).sum())}; set_image "
        f"{cset_ms:.2f} ms, predict {cpred_ms:.2f} ms | {card}")
    require(max(cerr.values()) <= SAM_RTOL
            and np.array_equal((cl_d > 0)[sure], (cl_c > 0)[sure]),
            f"compact SAM card vs CPU: {cerr}")
    del p_c, p_d, c_c, c_d
    _empty_cache()
    return path, dict(set_ms=set_ms, predict_ms=pred_ms, peak=peak, errs=errs)


def dav2_state_dict(gen, C, D, heads, F, out_ch, n):
    """Random Depth-Anything-V2 weights with the published key names and
    layouts (tests/test_weight_converters.py's schema at any width): the
    weights N(0, 1 / fan_in), layer-norm scales 1, LayerScale 1, biases
    N(0, 0.01^2), embeddings N(0, 0.02^2)."""
    import torch

    def w(*s):
        fan_in = int(np.prod(s[1:])) if len(s) > 1 else 1
        return torch.randn(*s, generator=gen) / np.sqrt(fan_in)

    b = lambda c: torch.randn(c, generator=gen) * 0.01
    sd = {"pretrained.patch_embed.proj.weight": w(C, 3, 14, 14),
          "pretrained.patch_embed.proj.bias": b(C),
          "pretrained.pos_embed": torch.randn(1, 1 + n * n, C, generator=gen) * 0.02,
          "pretrained.cls_token": torch.randn(1, 1, C, generator=gen) * 0.02,
          "pretrained.norm.weight": torch.ones(C), "pretrained.norm.bias": b(C)}
    for d in range(D):
        p = f"pretrained.blocks.{d}"
        sd.update({f"{p}.norm1.weight": torch.ones(C), f"{p}.norm1.bias": b(C),
                   f"{p}.attn.qkv.weight": w(3 * C, C), f"{p}.attn.qkv.bias": b(3 * C),
                   f"{p}.attn.proj.weight": w(C, C), f"{p}.attn.proj.bias": b(C),
                   f"{p}.norm2.weight": torch.ones(C), f"{p}.norm2.bias": b(C),
                   f"{p}.mlp.fc1.weight": w(4 * C, C), f"{p}.mlp.fc1.bias": b(4 * C),
                   f"{p}.mlp.fc2.weight": w(C, 4 * C), f"{p}.mlp.fc2.bias": b(C),
                   f"{p}.ls1.gamma": torch.ones(C), f"{p}.ls2.gamma": torch.ones(C)})
    for i, co in enumerate(out_ch):
        sd[f"depth_head.projects.{i}.weight"] = w(co, C, 1, 1)
        sd[f"depth_head.projects.{i}.bias"] = b(co)
        sd[f"depth_head.scratch.layer{i + 1}_rn.weight"] = w(F, co, 3, 3)
    for i, s in ((0, 4), (1, 2)):  # ConvTranspose2d [cin, cout, s, s]
        sd[f"depth_head.resize_layers.{i}.weight"] = w(out_ch[i], out_ch[i], s, s)
        sd[f"depth_head.resize_layers.{i}.bias"] = b(out_ch[i])
    sd["depth_head.resize_layers.3.weight"] = w(out_ch[3], out_ch[3], 3, 3)
    sd["depth_head.resize_layers.3.bias"] = b(out_ch[3])
    for j in range(1, 5):
        p = f"depth_head.scratch.refinenet{j}"
        for u in (1, 2):
            for c in (1, 2):
                sd[f"{p}.resConfUnit{u}.conv{c}.weight"] = w(F, F, 3, 3)
                sd[f"{p}.resConfUnit{u}.conv{c}.bias"] = b(F)
        sd[f"{p}.out_conv.weight"] = w(F, F, 1, 1)
        sd[f"{p}.out_conv.bias"] = b(F)
    sd["depth_head.scratch.output_conv1.weight"] = w(F // 2, F, 3, 3)
    sd["depth_head.scratch.output_conv1.bias"] = b(F // 2)
    sd["depth_head.scratch.output_conv2.0.weight"] = w(32, F // 2, 3, 3)
    sd["depth_head.scratch.output_conv2.0.bias"] = b(32)
    sd["depth_head.scratch.output_conv2.2.weight"] = w(1, 32, 1, 1)
    sd["depth_head.scratch.output_conv2.2.bias"] = torch.full((1,), 0.1)
    return sd


def _timed_network(model):
    """Wrap ``model.infer_image`` so that its calls' seconds add up in the
    returned list (the network's share of an infer_* call)."""
    inner, spent = model.infer_image, [0.0]

    def timed(bgr):
        t0 = time.perf_counter()
        out = inner(bgr)  # a host array: the card's work is done
        spent[0] += time.perf_counter() - t0
        return out

    model.infer_image = timed
    return spent


def depth_card_vs_cpu(dev, card, tmp, rgb):
    """Phase 10c: DA-V2 vitl (faithful) and the compact vits, the card
    against the CPU at 518x518; the panorama and fisheye paths timed."""
    import torch
    from PIL import Image
    from splat_one_tpu_torch.models import depth_tpu as DT

    _scripts_path()
    from convert_weights import convert_depth

    t0 = time.perf_counter()
    cfg = DT.CONFIGS["vitl"]
    C, D, heads, F_ = cfg["width"], cfg["depth"], cfg["heads"], cfg["features"]
    out_ch = DAV2_VITL_OUT
    n = DEPTH_RES // DT.PATCH
    torch.save(dav2_state_dict(torch.Generator().manual_seed(0), C, D, heads, F_, out_ch, n),
               os.path.join(tmp, "dav2_vitl.pth"))
    npz = os.path.join(tmp, "dav2_vitl.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        convert_depth(os.path.join(tmp, "dav2_vitl.pth"), "vitl", npz)
    os.remove(os.path.join(tmp, "dav2_vitl.pth"))
    setup_s = time.perf_counter() - t0
    log(f"phase 10c: Depth-Anything-V2 vitl (width {C}, {D} layers, {heads} heads, features "
        f"{F_}, out_channels {list(out_ch)}; random weights in DA-V2's layout through "
        f"convert_depth, {os.path.getsize(npz) / 2**30:.2f} GiB, {setup_s:.1f} s) and the "
        f"compact vits, at {DEPTH_RES}x{DEPTH_RES} | {card}")
    m_d = DT.DepthAnythingTPU("vitl", checkpoint=npz, device=dev)
    require(m_d._faithful and m_d.has_weights, "vitl: the faithful forward")
    with np.load(npz) as z:
        p_c = DT.params_from_numpy({k: z[k] for k in z.files}, "cpu")
    im = np.asarray(Image.fromarray(rgb).resize((DEPTH_RES, DEPTH_RES))).astype(np.float32) / 255
    x = torch.as_tensor(((im - DT.IMAGENET_MEAN) / DT.IMAGENET_STD)[None])
    t0 = time.perf_counter()
    o_c = DT.depth_forward_faithful(p_c, x)
    cpu_s = time.perf_counter() - t0
    xd = x.to(dev)
    with torch.no_grad():
        o_d, net_ms, peak = _warm_ms(lambda: DT.depth_forward_faithful(m_d.params, xd), dev)
    err = _rel_err(o_d, o_c)
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    d_img, img_ms, _ = _warm_ms(lambda: m_d.infer_image(bgr), dev)
    log(f"  vitl: card vs CPU {err:.2e} of max {float(o_c.abs().max()):.4g} (bar "
        f"{DEPTH_RTOL:.2e}); the network {net_ms:.1f} ms an image, infer_image "
        f"{img_ms:.1f} ms ({rgb.shape[1]}x{rgb.shape[0]} in and out; median of 3, host clock, "
        f"synchronized), peak memory {peak:.2f} GiB; CPU {cpu_s:.1f} s | {card}")
    require(err <= DEPTH_RTOL and bool(torch.isfinite(o_d).all())
            and d_img.shape == rgb.shape[:2], f"vitl card vs CPU {err}")
    # the compact vits (the CLI's default without a checkpoint), one seeded init
    v_d = DT.DepthAnythingTPU("vits", device=dev)
    v_c = DT.init_depth_model(torch.Generator().manual_seed(0), "vits")
    xs = torch.as_tensor(im[None])
    o_vc = DT.depth_forward(v_c, xs)
    with torch.no_grad():
        o_vd, v_ms, v_peak = _warm_ms(lambda: DT.depth_forward(v_d.params, xs.to(dev)), dev)
    v_err = _rel_err(o_vd, o_vc)
    log(f"  compact vits (seeded init): card vs CPU {v_err:.2e} of max "
        f"{float(o_vc.abs().max()):.4g} (bar {DEPTH_RTOL:.2e}); {v_ms:.2f} ms an image, peak "
        f"memory {v_peak:.2f} GiB | {card}")
    require(v_err <= DEPTH_RTOL, f"compact vits card vs CPU {v_err}")
    # the panorama and fisheye paths: the network's share beside the host's
    out = {}
    pano = np.asarray(Image.fromarray(bgr).resize((2048, 1024)))
    fish = np.asarray(Image.fromarray(bgr).resize((1280, 960)))
    K = np.array([[1280 / np.pi, 0, 640], [0, 1280 / np.pi, 480], [0, 0, 1]], np.float32)
    for name, fn in (("infer_equirectangular 2048x1024", lambda: m_d.infer_equirectangular(pano)),
                     ("infer_fisheye 1280x960", lambda: m_d.infer_fisheye(
                         fish, K, dist=np.array([0.02, -0.01, 0.0, 0.0])))):
        fn()  # warm
        spent = _timed_network(m_d)
        t0 = time.perf_counter()
        d = fn()
        wall = (time.perf_counter() - t0) * 1e3
        del m_d.infer_image
        require(np.isfinite(d).all(), f"{name}: non-finite depth")
        out[name] = (wall, spent[0] * 1e3)
        log(f"  {name}: {wall:.1f} ms (host clock), of it infer_image {spent[0] * 1e3:.1f} ms "
            f"(the network and its PIL resizes), the host's numpy "
            f"{wall - spent[0] * 1e3:.1f} ms | {card}")
    del m_d, v_d, p_c
    _empty_cache()
    return dict(err=err, net_ms=net_ms, img_ms=img_ms, peak=peak, vits_err=v_err, vits_ms=v_ms,
                paths=out)


def masks_depth_stages(dev, card, tmp, sam_npz):
    """Phase 10d: create-masks, estimate-depth and detect-features through
    the CLI on the first MD_VIEWS views of 8b's spiral."""
    from PIL import Image
    from splat_one_tpu_torch.app import cli

    W = SFM_RES
    c2ws, Ks = spiral_cameras(SFM_VIEWS, W, W)
    wd = os.path.join(tmp, "md")
    sfm_workdir(dev, wd, c2ws[:MD_VIEWS], Ks[:MD_VIEWS], W, W)
    names = sorted(os.listdir(os.path.join(wd, "images")))
    with open(os.path.join(wd, "masks_clicks.json"), "w") as fh:
        json.dump({nm: {"points": [[W / 2, W / 2], [W / 8, W / 8]], "labels": [1, 0]}
                   for nm in names}, fh)
    log(f"phase 10d: the Masks and Depth stages through the CLI on the first {MD_VIEWS} of "
        f"8b's spiral views at {W}x{W}, then detect-features with the masks | {card}")
    wd_f = os.path.join(tmp, "md_fisheye")
    shutil.copytree(wd, wd_f)
    with open(os.path.join(wd_f, "camera_models.json")) as fh:
        models = json.load(fh)
    for m in models.values():
        m.update(projection_type="fisheye", k1=0.01, k2=0.0)
    with open(os.path.join(wd_f, "camera_models.json"), "w") as fh:
        json.dump(models, fh)
    runs = [("create-masks --checkpoint (SAM 2.1 hiera_l)", ["create-masks", wd, "--checkpoint",
                                                            sam_npz], "masks"),
            ("create-masks (classical)", ["create-masks", wd], "masks"),
            ("estimate-depth", ["estimate-depth", wd], "depth"),
            ("estimate-depth --equirect", ["estimate-depth", wd, "--equirect"], "depth"),
            ("estimate-depth --camera-aware (fisheye camera)",
             ["estimate-depth", wd_f, "--camera-aware"], "depth")]
    walls = {}
    for label, argv, sub in runs:
        d = os.path.join(argv[1], sub)
        shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv + ["--device", str(dev)])
        walls[label] = time.perf_counter() - t0
        files = sorted(os.listdir(d)) if os.path.isdir(d) else []
        want = MD_VIEWS if sub == "masks" else 2 * MD_VIEWS
        require(rc == 0 and len(files) == want, f"cli {label}: rc {rc}, {len(files)} files")
        log(f"  {label}: {len(files)} files in {sub}/ ({files[0]} ..), {walls[label]:.2f} s")
    for nm in names:
        dep = np.load(os.path.join(wd_f, "depth", os.path.splitext(nm)[0] + "_depth.npy"))
        require(dep.shape == (W, W) and np.isfinite(dep).all(), f"{nm}: fisheye depth")
    # detect-features with the classical masks, and without them
    kps = {}
    for with_masks in (True, False):
        if not with_masks:
            shutil.move(os.path.join(wd, "masks"), os.path.join(tmp, "masks_aside"))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["detect-features", wd, "--max-keypoints", str(SFM_KP),
                           "--feature-process-size", str(W), "--device", str(dev)])
        walls[f"detect-features, masks {with_masks}"] = time.perf_counter() - t0
        require(rc == 0, "detect-features")
        inside = total = 0
        for nm in names:
            m = np.asarray(Image.open(os.path.join(tmp if not with_masks else wd,
                                                   "masks_aside" if not with_masks else "masks",
                                                   nm + ".png")))
            with np.load(os.path.join(wd, "features", nm + ".features.npz")) as z:
                xy = z["xys"][z["valid"]].astype(int)
            inside += int((m[xy[:, 1], xy[:, 0]] <= 127).sum())
            total += len(xy)
        kps[with_masks] = (inside, total)
    log(f"  detect-features: valid keypoints inside the masked-out regions {kps[True][0]} of "
        f"{kps[True][1]} with the masks, {kps[False][0]} of {kps[False][1]} without; "
        + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items() if k.startswith("detect"))
        + f" | {card}")
    require(kps[True][0] < kps[False][0] and kps[True][0] == 0,
            f"the masks were not honoured: {kps}")
    return walls


def term_thresh_kernels(dev, card, scenes, sc):
    """Phase 10e: stream_fwd and tile_fwd against their plain versions at
    each of TERMS on phase 3's scenes and the 1M bench scene: every output
    bit equal (n_chunks with them)."""
    import dataclasses as dc

    import torch
    from splat_one_tpu_torch.ops import stream_raster as sr
    from splat_one_tpu_torch.ops import tile_raster as tr

    log(f"phase 10e: term_thresh {TERMS} through stream_fwd and tile_fwd against their plain "
        f"versions | {card}")
    rows = []
    for name, s in list(scenes.items()) + [("1M bench 1280x720", sc)]:
        cfg, st, packed, _ = stream_inputs(s, dev)
        cfg_t, st_t, packed_t, _ = tile_inputs(s, project(s, dev))
        walked = {}
        for t in TERMS:
            for kind, c, a, b, k_fn, p_fn, ch in (
                    ("stream", dc.replace(cfg, term_thresh=t), st, packed, sr.stream_fwd,
                     sr.stream_fwd_plain, (slice(None), slice(None), sr.CH_NCHUNKS, 0)),
                    ("tile", dc.replace(cfg_t, term_thresh=t), st_t, packed_t, tr.tile_fwd,
                     tr.tile_fwd_plain, (slice(None), tr.CH_NCHUNKS, 0))):
                out_k = k_fn(c, a, b)
                out_p = p_fn(c, a, b)
                _sync()
                require(bool(torch.equal(out_k, out_p)),
                        f"{name}: {kind}_fwd at term_thresh {t} differs from its plain version")
                walked[(kind, t)] = int(out_k[ch].sum())
        for kind in ("stream", "tile"):
            w = [walked[(kind, t)] for t in TERMS]
            require(w[0] >= w[1] >= w[2], f"{name}: {kind} chunks walked {w} not monotone")
        rows.append(name)
        log(f"  {name}: every output bit equal at each threshold; chunks walked (summed over "
            f"tiles) stream {', '.join(str(walked[('stream', t)]) for t in TERMS)}, tile "
            f"{', '.join(str(walked[('tile', t)]) for t in TERMS)}")
        del packed, packed_t
    _empty_cache()
    return rows


def masks_depth_phase(dev, card, scenes, sc):
    """Phase 10 (see the module docstring)."""
    import torch
    from splat_one_tpu_torch.sfm.features import _f32_conv

    t_phase = time.perf_counter()
    require(not torch.backends.cuda.matmul.allow_tf32, "matmul TF32 is on")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    with _f32_conv():
        require(not torch.backends.cudnn.allow_tf32, "_f32_conv left cuDNN's TF32 on")
    torch.backends.cudnn.allow_tf32 = prev
    W0, H0 = SAM_IMG
    c2ws, Ks = spiral_cameras(SFM_VIEWS, W0, H0)
    views = sphere_images(dev, c2ws[:2], Ks[:2], W0, H0)
    rgb = np.repeat(views[0][..., None], 3, -1)
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_md_")
    try:
        walls = {}
        for part, fn in (("a", lambda: lpips_card_vs_cpu(dev, card, tmp, views)),
                         ("b", lambda: sam2_card_vs_cpu(dev, card, tmp, rgb)),
                         ("c", lambda: depth_card_vs_cpu(dev, card, tmp, rgb))):
            t0 = time.perf_counter()
            out[part] = fn()
            walls[part] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["d"] = masks_depth_stages(dev, card, tmp, out["b"][0])
        walls["d"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    out["e"] = term_thresh_kernels(dev, card, scenes, sc)
    walls["e"] = time.perf_counter() - t0
    log(f"  phase 10 wall {time.perf_counter() - t_phase:.1f} s (budget 150 s): "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items()) + f" | {card}")
    return out


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
    torch.cuda.empty_cache()
    stage_counts = train_stage_phase(dev, card)
    slab_counts, offset_ms = slab_phase(dev, card, sc, rows.pop("scene"), rows["first_loss"],
                                        max_err)
    torch.cuda.empty_cache()
    sfm_phase(dev, card)
    features_phase(dev, card)
    masks_depth_phase(dev, card, scenes, sc)
    kernels = [dict(fwd_row, launches=rows["launches"].get("stream_fwd", 0),
                    max_abs_err=max_err["stream_fwd"])] + rows["kernels"] + [
        dict(tile_fwd_row, launches=rows["tiled_launches"].get("tile_fwd", 0),
             max_abs_err=max_err["tile_fwd"]),
        dict(rows["tile_bwd"], max_abs_err=max_err["tile_bwd"]),
        dict(rows["seg_broadcast"], max_abs_err=max_err["seg_broadcast"]),
    ]
    for row in kernels:
        require(row["launches"] > 0, f"{row['name']} was not launched on its path")
        # the train stage's own run (phase 5e (i)): steps + eval renders
        row["stage_launches"] = stage_counts.get(row["name"], 0)
        # phase 7's path runs; the row's time at a nonzero slab offset
        row["slab_launches"] = slab_counts.get(row["name"], 0)
        require(row["slab_launches"] > 0, f"{row['name']} was not launched in phase 7")
        row["offset_ms"] = offset_ms[row["name"]]

    # phase 6: the kernels line, the card line, the result line
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
