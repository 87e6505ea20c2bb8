"""Anatomy of the four compositing kernels on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 raster_anatomy.py [--parent DIR]

Inputs: bench.py's 1M-gaussian scene (SH degree 3, 1280x720, seed 0) as
chip_smoke.py builds it, pinhole front and spherical: the forward kernels
at phase 4 / 4b's inputs, the backward kernels at the fwd+bwd step's
(``chip_smoke.step_bwd_inputs``: phase 5a / 5a-i's, the step loss's
cotangent). It builds csrc/stream_fwd.cu, tile_fwd.cu, stream_bwd.cu and
tile_bwd.cu as they are and variants of each (text substitutions of the
source or its headers; it fails where a substitution's text is in
neither), into splat_one_tpu_torch/_build/anatomy/: for the forward
kernels one part removed (the per-warp cull of slots that miss the
warp's pixels, the exp, the tiled kernel's padding skip), one pixel a
thread, other unrollings and 2 and 3 chunk buffers; for the backward
kernels one part removed (the walk, the sums, the division, the
gradients, the in-kernel zero fill). It fails unless every build of a
kernel as it is, and every variant marked exact, gives the bits of the
wrapper's build at both poses (a backward kernel launched into a buffer
of NaNs, so that it writes every row); times every build at both poses
in turns (CUDA events, two rounds, the second in reverse order; a
backward launch includes its output's allocation, torch.empty, or
torch.zeros for a parent build from before the in-kernel fill, whose
kernel needs the zeroed buffer its wrapper gave it) with the card's name
and power limit;
prints for each forward input the blocks that composite a chunk and the
longest tile's chunks, and how the backward's per-slot work spreads over
the 32-pixel warps of the plain versions' tree (live: some pixel
composites; dead: gated, none does; ungated; the share of the busiest
warp's live slots the others reach between two barriers: a supertile's
32 warps for stream_bwd, also a tile's 8, and the block time its tiles
would take synchronised alone).
``--parent DIR`` also times the csrc sources in DIR (another version of
the kernels, unpacked with git archive) in the same turns, and then, with
this version's kernels and DIR's swapped into the wrappers in turns (this,
DIR, DIR, this; DIR's backward kernels from before the in-kernel fill
with their own launcher arguments, into zeroed outputs): the pinhole
front and spherical serving requests (make_render_fn; DIR's stream_fwd)
and chip_smoke.py's fwd+bwd step through each rasterizer path at both
poses (DIR's forward and backward kernels of the path): host ms (median
of 7 synchronized calls) and device busy ms per call (a torch.profiler
trace of 3), the outputs of the two equal.
"""

import argparse
import contextlib
import ctypes
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import chip_smoke as cs

FWD = ("stream_fwd", "tile_fwd")
BWD = ("stream_bwd", "tile_bwd")

# kernel -> variant -> ([(text, replacement)], same bits as the kernel);
# a text is replaced in the kernel's source and the headers that hold it
_FWD_COMMON = {
    "one pixel a thread": ([("constexpr int PPT = 2;", "constexpr int PPT = 1;")], True),
    "unroll 1": ([("constexpr int UNROLL = 4;", "constexpr int UNROLL = 1;")], True),
    "unroll 2": ([("constexpr int UNROLL = 4;", "constexpr int UNROLL = 2;")], True),
    "unroll 8": ([("constexpr int UNROLL = 4;", "constexpr int UNROLL = 8;")], True),
    "stages 2": ([("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")], True),
    "stages 3": ([("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")], True),
    "no cull": ([("return !misses_block<WRAP>(", "return true || !misses_block<WRAP>(")],
                True),
    "no exp": ([("b.y * expf(-sigma)", "b.y * (1.0f - sigma)")], False),
}
_BWD_COMMON = {
    "no sums": ([("const float sum = bwd::half_warp_sum<NR>(spend, lane);",
                  "const float sum = spend[0] + spend[NR - 1];")], False),
    "no division": ([("bwd::div_rn(dconst[q] - pre[q], inv)", "(dconst[q] - pre[q])"),
                     ("bwd::div_rn(gAT[q], inv)", "gAT[q]")], False),
    "no gradients": ([("float v[2][NR];", "continue;\n      float v[2][NR];")], False),
}


def _no_fill(range_end, cap):
    """The in-kernel zero fill of the rows no chunk reaches, removed."""
    return ([(f"const int64_t hi = 4 * static_cast<int64_t>({range_end});",
              "const int64_t hi = 0;"),
             (f"const int64_t n_out = head + 4 * static_cast<int64_t>({cap}) - tail0;",
              "const int64_t n_out = 0;")], False)


VARIANTS = {
    "stream_fwd": _FWD_COMMON,
    "tile_fwd": dict(_FWD_COMMON, **{"no padding skip": ([(
        "return !(row[fwd::OPAC] < 0.5f * fwd::ALPHA_MIN);", "return true;")], True)}),
    "stream_bwd": dict(_BWD_COMMON, **{
        "no walk": ([("for (unsigned m = gmask[i]; m != 0; m &= m - 1) {",
                      "for (unsigned m = 0; m != 0; m &= m - 1) {")], False),
        "no fill": _no_fill("st_starts_al[t + 1]", "pad_cap")}),
    "tile_bwd": dict(_BWD_COMMON, **{
        "no walk": ([("for (int g = 0; g < G; ++g) {", "for (int g = 0; g < 0; ++g) {")],
                    False),
        "no fill": _no_fill("starts[t + 1]", "align_cap")}),
}

# The backward launchers of a version from before the in-kernel fill
# (without the output's capacity; their wrappers zeroed the output), and
# the text of that argument in a version with the fill.
_UNFILLED = {
    "stream_bwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p],
    "tile_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
}
_CAP_ARG = {"stream_bwd": "int pad_cap", "tile_bwd": "int align_cap"}

def build(src_dir, name, label, subs=()):
    """Start nvcc on ``src_dir/name.cu`` with ``subs`` applied to it and
    its headers -> (label, library path, process). Raises where a
    substitution's text is in none of them."""
    from splat_one_tpu_torch.utils import cuda_build

    src = Path(src_dir)
    files = {p.name: p.read_text() for p in [src / f"{name}.cu", *sorted(src.glob("*.cuh"))]}
    for a, b in subs:
        hits = [f for f, text in files.items() if a in text]
        cs.require(hits, f"{label}: {a!r} is in neither {name}.cu nor its headers")
        for f in hits:
            files[f] = files[f].replace(a, b)
    d = cuda_build.BUILD_DIR / "anatomy" / label.replace(" ", "_").replace("/", "_")
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f, text in files.items():
        (d / f).write_text(text)
    so = d / f"lib{name}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(d / f"{name}.cu")]
    return label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)


def warp_slots(cfg, st, packed, out, stream):
    """Live, dead and ungated (32-pixel warp, slot) visits of the backward
    replay; the mean over (barrier group, chunk) of the warps' mean live
    slots over the busiest warp's, the group a supertile's 32 warps
    (stream: the block's barrier) or a tile's 8 (tiled); and for the
    stream, the same over each tile's 8 warps, and the block time a
    supertile's tiles would take if each synchronised only its own 8
    warps over the time they take synchronised with the supertile's 32
    (a warp's work a chunk: its gated slots + 2.5 x its live ones)."""
    import torch
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.ops import stream_raster as sr
    from splat_one_tpu_torch.ops import tile_raster as tr
    from splat_one_tpu_torch.ops.reference import ALPHA_MIN

    G, P = cfg.chunk, cfg.npix
    dev = packed.device
    s = st.long()
    slots = torch.arange(G, device=dev)
    if stream:
        NT = cfg.nt
        s0, s1 = s[:-1], s[1:]
        base0 = torch.div(s0, G, rounding_mode="floor") * G
        nch = out[:, :, sr.CH_NCHUNKS, 0].long()
        nchunks = torch.minimum(-torch.div(-(s1 - base0), G, rounding_mode="floor"),
                                nch.amax(-1))
        px, py, tx, ty = sr._tile_geometry(cfg, torch.arange(cfg.cs, device=dev))
        cols = (si.COL_X, si.COL_Y, si.COL_CA, si.COL_CB, si.COL_CC, si.COL_OPAC)
    else:
        NT = 1
        s0 = s[:-1]
        nchunks = torch.minimum(torch.div(s[1:] - s0, G, rounding_mode="floor"),
                                out[:, tr.CH_NCHUNKS, 0].long())
        px, py = (x[:, None] for x in tr._tile_pixels(cfg, torch.arange(cfg.ct, device=dev)))
        cols = (itx.ROW_X, itx.ROW_Y, itx.ROW_CA, itx.ROW_CB, itx.ROW_CC, itx.ROW_OPAC)
    live_n = dead_n = ung_n = 0
    shares, shares_tile = [], []
    t_tile = t_cluster = 0.0
    for k in range(int(nchunks.max())):
        for sel in torch.split(torch.nonzero(k < nchunks)[:, 0], 128):
            S = sel.shape[0]
            if stream:
                rows = base0[sel, None] + k * G + slots
                rowmask = (rows >= s0[sel, None]) & (rows < s1[sel, None])
                chunk = packed[rows]
                gate = sr._chunk_gate(cfg, chunk, tx[sel], ty[sel], rowmask) & \
                    (k < nch[sel])[..., None]  # [S, NT, G]
            else:
                chunk = packed[s0[sel, None] + k * G + slots]
                gate = torch.ones((S, 1, G), dtype=torch.bool, device=dev)
            c = chunk.permute(0, 2, 1)[:, None, :, :, None]  # [S, 1, NF, G, 1]
            x, y, ca, cb, cc, op = (c[:, :, i] for i in cols)
            dx = x - px[sel][:, :, None, :]
            if cfg.wrap_x:
                dx = dx - cfg.width * torch.round(dx * sr._inv_width(cfg))
            dy = y - py[sel][:, :, None, :]
            sig = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
            alive = (sig >= 0) & (op * torch.exp(-sig) >= ALPHA_MIN)  # [S, NT, G, P]
            live = alive.reshape(S, NT, G, P // 32, 32).any(-1) & gate[..., None]
            n_live = live.sum(2).reshape(S, -1).float()  # per warp
            n_gated = gate[..., None].expand_as(live).sum(2).reshape(S, -1)
            live_n += int(n_live.sum())
            dead_n += int((n_gated - n_live).sum())
            ung_n += int((G - n_gated).sum())
            busy = n_live.amax(1)
            shares.append((n_live.mean(1)[busy > 0] / busy[busy > 0]).cpu())
            per_tile = n_live.reshape(S * NT, -1)
            busy = per_tile.amax(1)
            shares_tile.append((per_tile.mean(1)[busy > 0] / busy[busy > 0]).cpu())
            work = (n_gated + 2.5 * n_live).reshape(S, NT, -1)
            t_tile += float(work.amax(2).sum())
            t_cluster += float(NT * work.reshape(S, -1).amax(1).sum())
    share = float(torch.cat(shares).mean()) if shares else 0.0
    share_tile = float(torch.cat(shares_tile).mean()) if shares_tile else 0.0
    return live_n, dead_n, ung_n, share, share_tile, t_tile / max(t_cluster, 1.0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="csrc directory of another version of the kernels to time")
    ap.add_argument("--iters", type=int, default=10, help="launches per timing")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("raster_anatomy: CUDA is not available")
        return 1
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.ops import stream_raster as sr
    from splat_one_tpu_torch.ops import tile_raster as tr
    from splat_one_tpu_torch.utils import cuda_build

    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    W, H, N = cs.W_SERVE, cs.H_SERVE, cs.N_SERVE
    sc = cs.bench_scene(N, W, H, 1000.0, -6.5, -5.0, seed=0)

    src = cuda_build.CSRC_DIR
    names = FWD + BWD
    jobs = [build(src, n, n) for n in names]  # the kernels as they are
    if args.parent:
        jobs += [build(args.parent, n, f"{n} of {args.parent}") for n in names]
        # the parent's backward launchers from before the in-kernel fill
        unfilled = {f"{n} of {args.parent}" for n in BWD
                    if _CAP_ARG[n] not in (Path(args.parent) / f"{n}.cu").read_text()}
    else:
        unfilled = set()
    exact = [label for label, _, _ in jobs]  # builds that must give the wrapper's bits
    for n in names:
        for k, (subs, same) in VARIANTS[n].items():
            jobs.append(build(src, n, f"{n} {k}", subs))
            if same:
                exact.append(f"{n} {k}")

    # the inputs, while nvcc runs
    fwd_in = {}  # (kernel, camera model) -> (cfg, starts, packed)
    bwd_in = {}  # (kernel, camera model) -> the backward's inputs at the step's
    for cm in ("pinhole", "spherical"):
        with torch.no_grad():
            scm = dict(sc, camera_model=cm)
            fwd_in[("stream_fwd", cm)] = cs.stream_inputs(scm, dev)[:3]
            fwd_in[("tile_fwd", cm)] = cs.tile_inputs(scm, cs.project(scm, dev))[:3]
        step = cs.step_bwd_inputs(sc, dev, cm)
        bwd_in[("stream_bwd", cm)] = step["stream"]
        bwd_in[("tile_bwd", cm)] = step["tiled"][:5]
        if cm == "pinhole":
            caps = cs.bench_caps(cs.project(sc, dev), W, H)

    def launch(label, cm="pinhole", fill=torch.empty):
        """One launch of build ``label`` at ``cm``'s input; the backward
        kernels into ``fill``'s buffer (a build from before the in-kernel
        fill, which leaves the rows no chunk reaches to its wrapper's
        zeroed buffer, into zeros, with its own launcher arguments)."""
        fn = fns[label]
        name = label.split()[0]
        stream = torch.cuda.current_stream().cuda_stream
        if label in unfilled:
            fill = torch.zeros
        if name in FWD:
            c, st, pk = fwd_in[(name, cm)]
            inv_w = sr._inv_width(c)
            if name == "stream_fwd":
                o = torch.empty((c.cs, c.nt, sr.OUT_CH, c.npix), device=dev)
                rc = fn(st.data_ptr(), pk.data_ptr(), o.data_ptr(), c.cs, c.sw, c.sh, c.tw, 0,
                        int(c.wrap_x), float(c.width), inv_w, float(c.term_thresh), stream)
            else:
                o = torch.empty((c.ct, tr.OUT_CH, c.npix), device=dev)
                rc = fn(st.data_ptr(), pk.data_ptr(), o.data_ptr(), c.ct, c.tw, c.tw * c.th, 0,
                        int(c.wrap_x), float(c.width), inv_w, float(c.term_thresh), stream)
        elif name == "stream_bwd":
            c, st, st_al, pk, fo, go = bwd_in[(name, cm)]
            o = fill((c.pad_cap, si.NF), device=dev)
            cap = () if label in unfilled else (c.pad_cap,)
            rc = fn(st.data_ptr(), st_al.data_ptr(), pk.data_ptr(), fo.data_ptr(),
                    go.data_ptr(), o.data_ptr(), c.cs, *cap, c.sw, c.sh, c.tw, 0,
                    int(c.wrap_x), float(c.width), sr._inv_width(c), 0, stream)
        else:
            c, st, pk, fo, go = bwd_in[(name, cm)]
            o = fill((c.align_cap, itx.NF), device=dev)
            cap = () if label in unfilled else (c.align_cap,)
            rc = fn(st.data_ptr(), pk.data_ptr(), fo.data_ptr(), go.data_ptr(), o.data_ptr(),
                    c.ct, *cap, c.tw, c.tw * c.th, 0, int(c.wrap_x), float(c.width),
                    sr._inv_width(c), stream)
        cs.require(rc == 0, f"{label}: launch failed ({rc})")
        return o

    nan_fill = lambda shape, device: torch.full(shape, float("nan"), device=device)
    fns, libs = {}, {}
    for label, so, proc in jobs:
        text, _ = proc.communicate()
        cs.require(proc.returncode == 0, f"nvcc failed for {label}:\n{text}")
        ents = cs.ptxas_entries(text)
        print(f"{label}: " + "; ".join(f"{k} {r} registers, {a} B spill stores, {b} B spill "
                                       f"loads, {rest}" for k, r, a, b, rest in ents),
              flush=True)
        name = label.split()[0]
        libs[label] = cuda_build.load(so, name)
        fns[label] = getattr(libs[label], name)
        if label in unfilled:
            fns[label].argtypes = _UNFILLED[name]

    ref = {}
    with torch.no_grad():  # the wrappers, through the package's own builds
        for cm in ("pinhole", "spherical"):
            ref[("stream_fwd", cm)] = sr.stream_fwd(*fwd_in[("stream_fwd", cm)])
            ref[("tile_fwd", cm)] = tr.tile_fwd(*fwd_in[("tile_fwd", cm)])
            ref[("stream_bwd", cm)] = sr.stream_bwd(*bwd_in[("stream_bwd", cm)])
            ref[("tile_bwd", cm)] = tr.tile_bwd(*bwd_in[("tile_bwd", cm)])
    # every timed (build, input): each kernel at both poses
    runs = [(label, cm) for label in fns for cm in ("pinhole", "spherical")]
    for label, cm in runs:
        name = label.split()[0]
        if label in exact:  # the backward kernels into NaNs: every row written
            cs.require(torch.equal(launch(label, cm, nan_fill), ref[(name, cm)]),
                       f"{label} ({cm}): bits differ from the wrapper's build")
    print(f"equal bits to the wrappers' builds at both poses (the backward kernels "
          f"launched into NaNs, {', '.join(sorted(unfilled)) or 'none'} into zeros): "
          f"{', '.join(exact)}", flush=True)

    for name, cm in ((n, m) for n in FWD for m in ("pinhole", "spherical")):
        c, st, _ = fwd_in[(name, cm)]
        print(f"{name} {cm}: " + cs.fwd_blocks_line(name, c, st, ref[(name, cm)]), flush=True)

    times = {r: [] for r in runs}
    for order in (runs, runs[::-1]):
        for label, cm in order:
            times[(label, cm)].append(cs.cuda_ms(lambda: launch(label, cm), args.iters))
    for cm in ("pinhole", "spherical"):
        c, c_t = bwd_in[("stream_bwd", cm)][0], bwd_in[("tile_bwd", cm)][0]
        zs = cs.cuda_ms(lambda: torch.zeros((c.pad_cap, si.NF), device=dev), args.iters)
        zt = cs.cuda_ms(lambda: torch.zeros((c_t.align_cap, itx.NF), device=dev), args.iters)
        print(f"[{cm}] a zeroed backward output alone (in the times below of the builds "
              f"from before the in-kernel fill, which need one): stream_bwd "
              f"{zs:.4f} ms ({c.pad_cap} rows), tile_bwd {zt:.4f} ms ({c_t.align_cap} rows) "
              f"| {card}", flush=True)
    for label, cm in runs:
        ts = times[(label, cm)]
        print(f"{label} [{cm}]: {statistics.mean(ts):.4f} ms ({', '.join(f'{x:.4f}' for x in ts)}; "
              f"CUDA events, {args.iters} launches) | {card}", flush=True)
    for name, cm in ((n, m) for n in BWD for m in ("pinhole", "spherical")):
        c, st, *rest = bwd_in[(name, cm)]
        pk, fo = (rest[1], rest[2]) if name == "stream_bwd" else (rest[0], rest[1])
        live, dead, ung, share, share_tile, decoupled = warp_slots(c, st, pk, fo,
                                                                   name == "stream_bwd")
        print(f"{name} [{cm}] (32-pixel warp, slot) visits: live {live}, dead {dead}, "
              f"ungated {ung}; mean live slots of the warps between two barriers over the "
              f"busiest one's, per chunk: {share:.3f}" + (
                  f" (a supertile's 32 warps; a tile's 8: {share_tile:.3f}; its tiles "
                  f"synchronised alone would take {decoupled:.3f} of the block time)"
                  if name == "stream_bwd" else ""), flush=True)
    if args.parent:
        del fwd_in, bwd_in, ref
        torch.cuda.empty_cache()
        serving(sc, libs, args.parent, card)
        end_to_end(sc, caps, libs, args.parent, unfilled, card)
    return 0


def in_turns(kernels, swaps, run, label, card, unfilled=False):
    """``run()`` with each entry of ``kernels`` ({which: {kernel name:
    library}}) swapped into the wrappers in turns this, parent, parent,
    this (``unfilled``: the parent's backward kernels are from before the
    in-kernel fill): host ms (median of 7 synchronized calls), device busy
    ms per call (torch.profiler, 3 calls), and whether the outputs of the
    two are equal."""
    import torch
    from splat_one_tpu_torch.utils import cuda_build

    ms, busy, outs = {k: [] for k in kernels}, {k: [] for k in kernels}, {}
    for which in ("this", "parent", "parent", "this"):
        with contextlib.ExitStack() as stack:
            if which == "parent" and unfilled:
                stack.enter_context(unfilled_bwd_launches())
            for name in swaps:
                stack.enter_context(cuda_build.swapped(name, kernels[which][name]))
                cs.require(cuda_build.library(name) is kernels[which][name],
                           f"{name}: swap not in effect")
            outs[which] = run()
            torch.cuda.synchronize()
            times = []
            for _ in range(7):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[which].append(statistics.median(times))
            trace = cs.device_trace(run, 3)
            busy[which].append(trace[1] if trace else float("nan"))
    same = all(torch.equal(a, b) for a, b in zip(outs["this"], outs["parent"]))
    print(f"{label}: " + "; ".join(
        f"{which} {', '.join(f'{x:.3f}' for x in ms[which])} ms (host, median of 7), "
        f"device busy {', '.join(f'{x:.3f}' for x in busy[which])} ms"
        for which in kernels) + f"; outputs equal: {same} | {card}", flush=True)
    cs.require(same, f"{label}: this version's and the parent's outputs differ")


@contextlib.contextmanager
def unfilled_bwd_launches():
    """Within the block the backward wrappers launch their swapped-in
    library with the launcher arguments of a build from before the
    in-kernel fill, into an output zeroed first, as that build's own
    wrappers did (the library's argument types are set where it is
    loaded)."""
    import torch
    from splat_one_tpu_torch.ops import stream_raster as sr
    from splat_one_tpu_torch.ops import tile_raster as tr
    from splat_one_tpu_torch.utils import cuda_build

    def stream_launch(cfg, st, st_al, packed, fwd_out, gout, pgrad, tile_offset=0):
        pgrad.zero_()
        fn = cuda_build.library("stream_bwd").stream_bwd
        rc = fn(st.data_ptr(), st_al.data_ptr(), packed.data_ptr(), fwd_out.data_ptr(),
                gout.data_ptr(), pgrad.data_ptr(), cfg.cs, cfg.sw, cfg.sh, cfg.tw,
                int(tile_offset), int(cfg.wrap_x), float(cfg.width), sr._inv_width(cfg),
                int(cfg.absgrad), torch.cuda.current_stream().cuda_stream)
        cs.require(rc == 0, f"parent stream_bwd: launch failed ({rc})")

    def tile_launch(cfg, starts, packed, fwd_out, gout, pgrad, tile_offset=0):
        pgrad.zero_()
        fn = cuda_build.library("tile_bwd").tile_bwd
        rc = fn(starts.data_ptr(), packed.data_ptr(), fwd_out.data_ptr(), gout.data_ptr(),
                pgrad.data_ptr(), cfg.ct, cfg.tw, cfg.tw * cfg.th, int(tile_offset),
                int(cfg.wrap_x), float(cfg.width), sr._inv_width(cfg),
                torch.cuda.current_stream().cuda_stream)
        cs.require(rc == 0, f"parent tile_bwd: launch failed ({rc})")

    saved = sr._launch_stream_bwd, tr._launch_tile_bwd
    sr._launch_stream_bwd, tr._launch_tile_bwd = stream_launch, tile_launch
    try:
        yield
    finally:
        sr._launch_stream_bwd, tr._launch_tile_bwd = saved


def serving(sc, libs, parent, card):
    """The pinhole front and spherical requests of chip_smoke.py's phase 4
    with this version's stream_fwd and ``parent``'s in turns."""
    import torch
    from splat_one_tpu_torch.app.viewer import make_render_fn, params_from_numpy

    W, H, N = cs.W_SERVE, cs.H_SERVE, cs.N_SERVE
    params, alive = params_from_numpy(cs.serve_params(sc), np.ones(N, bool), "cuda")
    fn = make_render_fn(params, alive, W, H, sh_degree=3, camera_model="pinhole")
    kernels = {"this": {"stream_fwd": libs["stream_fwd"]},
               "parent": {"stream_fwd": libs[f"stream_fwd of {parent}"]}}
    for cm in ("pinhole", "spherical"):
        with torch.no_grad():
            in_turns(kernels, ["stream_fwd"], lambda: fn.render(cs.yaw_pose(0.0), sc["Ks"][0], cm)[:3],
                     f"{cm} request, 1M / SH 3 / {W}x{H}", card)


def end_to_end(sc, caps, libs, parent, unfilled, card):
    """The fwd+bwd step of chip_smoke.py's phases 5a and 5a-i, pinhole
    front and spherical, with the path's forward and backward kernels as
    they are and ``parent``'s in turns (its backward kernels in
    ``unfilled``: from before the in-kernel fill)."""
    import torch
    from splat_one_tpu_torch.render.rasterization import rasterization

    dev = torch.device("cuda")
    W, H = cs.W_SERVE, cs.H_SERVE
    leaves = [torch.tensor(sc[k], device=dev, requires_grad=True)
              for k in ("means", "quats", "scales", "opac", "sh")]
    vm, K = (torch.as_tensor(sc[k], device=dev) for k in ("viewmats", "Ks"))
    caps_s = cs.bench_caps(cs.project(dict(sc, camera_model="spherical"), dev), W, H,
                           "spherical")
    for cm, impl, names in ((cm, impl, names) for cm in ("pinhole", "spherical")
                            for impl, names in (("stream", ("stream_fwd", "stream_bwd")),
                                                ("tiled", ("tile_fwd", "tile_bwd")))):
        kw = (dict(caps=caps if cm == "pinhole" else caps_s) if impl == "stream"
              else dict(impl="tiled"))

        def step():
            render, alpha, _ = rasterization(*leaves[:4], leaves[4], vm, K, W, H,
                                             sh_degree=3, render_mode="RGB+ED",
                                             camera_model=cm, **kw)
            return torch.autograd.grad(render.sum() + alpha.sum(), leaves)

        kernels = {"this": {n: libs[n] for n in names},
                   "parent": {n: libs[f"{n} of {parent}"] for n in names}}
        in_turns(kernels, names, step, f"{impl} fwd+bwd step [{cm}], 1M / SH 3 / {W}x{H} "
                 f"(gradients)", card, unfilled=f"{names[1]} of {parent}" in unfilled)


if __name__ == "__main__":
    sys.exit(main())
