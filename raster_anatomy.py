"""Anatomy of the four compositing kernels on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 raster_anatomy.py [--parent DIR]

Inputs: bench.py's 1M-gaussian scene (SH degree 3, 1280x720, seed 0) as
chip_smoke.py builds it: the forward kernels at phase 4 / 4b's inputs,
pinhole front and spherical; the backward kernels at phase 5a / 5a-i's,
pinhole front, with the step's cotangent. It builds csrc/stream_fwd.cu,
tile_fwd.cu, stream_bwd.cu and tile_bwd.cu as they are and variants of
each (text substitutions of the source or its headers; it fails where a
substitution's text is in neither), into splat_one_tpu_torch/_build/anatomy/:
for the forward kernels one part removed (the per-warp cull of slots
that miss the warp's pixels, the exp, the tiled kernel's padding skip),
one pixel a thread, other unrollings and 2 and 3 chunk buffers; for the
backward kernels one part removed. It fails unless every build of a
kernel as it is, and every variant marked exact, gives the bits of the
wrapper's build; times
every build in turns (CUDA events, two rounds, the second in reverse
order) with the card's name and power limit; prints for each forward
input the blocks that composite a chunk and the longest tile's chunks, and
how the backward's per-slot work spreads over the 32-pixel warps of the
plain versions' tree (live: some pixel composites; dead: gated, none
does; ungated; the share of the busiest warp's live slots the others reach
between two barriers).
``--parent DIR`` also times the csrc sources in DIR (another version of
the kernels, unpacked with git archive) in the same turns, and then, with
this version's kernels and DIR's swapped into the wrappers in turns (this,
DIR, DIR, this): the pinhole front and spherical serving requests
(make_render_fn; DIR's stream_fwd) and chip_smoke.py's fwd+bwd step
through each rasterizer path (DIR's forward and backward kernels of the
path): host ms (median of 7 synchronized calls) and device busy ms per
call (a torch.profiler trace of 3), the outputs of the two equal.
"""

import argparse
import contextlib
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
VARIANTS = {
    "stream_fwd": _FWD_COMMON,
    "tile_fwd": dict(_FWD_COMMON, **{"no padding skip": ([(
        "return !(row[fwd::OPAC] < 0.5f * fwd::ALPHA_MIN);", "return true;")], True)}),
    "stream_bwd": dict(_BWD_COMMON, **{"no walk": ([
        ("for (unsigned m = gmask[i]; m != 0; m &= m - 1) {",
         "for (unsigned m = 0; m != 0; m &= m - 1) {")], False)}),
    "tile_bwd": dict(_BWD_COMMON, **{"no walk": ([
        ("for (int g = 0; g < G; ++g) {", "for (int g = 0; g < 0; ++g) {")], False)}),
}


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
    replay, and the mean over (block, chunk) of the warps' mean live slots
    over the busiest warp's."""
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
    shares = []
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
    share = float(torch.cat(shares).mean()) if shares else 0.0
    return live_n, dead_n, ung_n, share


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
    from splat_one_tpu_torch.ops.projection import project_gaussians
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
    exact = [label for label, _, _ in jobs]  # builds that must give the wrapper's bits
    for n in names:
        for k, (subs, same) in VARIANTS[n].items():
            jobs.append(build(src, n, f"{n} {k}", subs))
            if same:
                exact.append(f"{n} {k}")

    # the inputs, while nvcc runs
    fwd_in = {}  # (kernel, camera model) -> (cfg, starts, packed)
    with torch.no_grad():
        for cm in ("pinhole", "spherical"):
            scm = dict(sc, camera_model=cm)
            fwd_in[("stream_fwd", cm)] = cs.stream_inputs(scm, dev)[:3]
            fwd_in[("tile_fwd", cm)] = cs.tile_inputs(scm, cs.project(scm, dev))[:3]
        t = lambda x: torch.as_tensor(x, device=dev)
        g = [t(sc[k]) for k in ("means", "quats", "scales", "opac", "sh")]
        proj = project_gaussians(*g[:4], t(sc["viewmats"]), t(sc["Ks"]), W, H,
                                 sh_coeffs=g[4], sh_degree=3)
        caps = cs.bench_caps(proj, W, H)
        cfg = sr.StreamCfg.from_caps(caps, W, H, 16, 1, N)
        isect = si.build_stream_intersections(proj, W, H, 16, caps)
        packed = si.pack_stream(si.build_fields(proj), isect, caps)
        out = sr.stream_fwd(cfg, isect.st_starts, packed)
        cfg_t, st_t, packed_t, _ = cs.tile_inputs(dict(w=W, h=H, camera_model="pinhole"), proj)
        out_t = tr.tile_fwd(cfg_t, st_t, packed_t)

    def step_cotangent(o, to_image):  # the step's loss: sum(render, ED) + sum(alpha)
        leaf = o.detach().requires_grad_(True)
        rgb, a, d = to_image(leaf)
        loss = torch.cat([rgb, d / torch.clamp(a, min=1e-10)], -1).sum() + a.sum()
        return torch.autograd.grad(loss, leaf)[0].contiguous()

    gout = step_cotangent(out, lambda o: sr.stream_to_image(cfg, o))
    gout_t = step_cotangent(out_t, lambda o: tr.tiles_to_image(cfg_t, o))

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

    def launch(label, cm="pinhole"):
        fn = fns[label]
        name = label.split()[0]
        stream = torch.cuda.current_stream().cuda_stream
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
            o = torch.zeros((cfg.pad_cap, si.NF), device=dev)
            rc = fn(isect.st_starts.data_ptr(), isect.st_starts_al.data_ptr(),
                    packed.data_ptr(), out.data_ptr(), gout.data_ptr(), o.data_ptr(),
                    cfg.cs, cfg.sw, cfg.sh, cfg.tw, 0, 0, float(W), sr._inv_width(cfg), 0,
                    stream)
        else:
            o = torch.zeros((cfg_t.align_cap, itx.NF), device=dev)
            rc = fn(st_t.data_ptr(), packed_t.data_ptr(), out_t.data_ptr(), gout_t.data_ptr(),
                    o.data_ptr(), cfg_t.ct, cfg_t.tw, cfg_t.tw * cfg_t.th, 0, 0, float(W),
                    sr._inv_width(cfg), stream)
        cs.require(rc == 0, f"{label}: launch failed ({rc})")
        return o

    with torch.no_grad():  # the wrappers, through the package's own builds
        ref = {"stream_bwd": sr.stream_bwd(cfg, isect.st_starts, isect.st_starts_al, packed,
                                           out, gout),
               "tile_bwd": tr.tile_bwd(cfg_t, st_t, packed_t, out_t, gout_t)}
        for cm in ("pinhole", "spherical"):
            ref[("stream_fwd", cm)] = sr.stream_fwd(*fwd_in[("stream_fwd", cm)])
            ref[("tile_fwd", cm)] = tr.tile_fwd(*fwd_in[("tile_fwd", cm)])
    # every timed (build, input): the forward kernels at both poses
    runs = [(label, cm) for label in fns
            for cm in (("pinhole", "spherical") if label.split()[0] in FWD else ("pinhole",))]
    for label, cm in runs:
        name = label.split()[0]
        if label in exact:
            want = ref[(name, cm)] if name in FWD else ref[name]
            cs.require(torch.equal(launch(label, cm), want),
                       f"{label} ({cm}): bits differ from the wrapper's build")
    print(f"equal bits to the wrappers' builds (forward kernels at both poses): "
          f"{', '.join(exact)}", flush=True)

    for name, cm in ((n, m) for n in FWD for m in ("pinhole", "spherical")):
        c, st, _ = fwd_in[(name, cm)]
        print(f"{name} {cm}: " + cs.fwd_blocks_line(name, c, st, ref[(name, cm)]), flush=True)

    times = {r: [] for r in runs}
    for order in (runs, runs[::-1]):
        for label, cm in order:
            times[(label, cm)].append(cs.cuda_ms(lambda: launch(label, cm), args.iters))
    zs = cs.cuda_ms(lambda: torch.zeros((cfg.pad_cap, si.NF), device=dev), args.iters)
    zt = cs.cuda_ms(lambda: torch.zeros((cfg_t.align_cap, itx.NF), device=dev), args.iters)
    print(f"the backward wrappers' zeroed outputs alone (included below): stream_bwd "
          f"{zs:.4f} ms, tile_bwd {zt:.4f} ms | {card}")
    for label, cm in runs:
        ts = times[(label, cm)]
        print(f"{label} [{cm}]: {statistics.mean(ts):.4f} ms ({', '.join(f'{x:.4f}' for x in ts)}; "
              f"CUDA events, {args.iters} launches) | {card}", flush=True)
    for name, args_ in (("stream_bwd", (cfg, isect.st_starts, packed, out, True)),
                        ("tile_bwd", (cfg_t, st_t, packed_t, out_t, False))):
        live, dead, ung, share = warp_slots(*args_)
        print(f"{name} (32-pixel warp, slot) visits: live {live}, dead {dead}, ungated "
              f"{ung}; mean live slots of a block's warps over its busiest warp's, per "
              f"chunk: {share:.3f}")
    if args.parent:
        del fwd_in, ref, isect, packed, out, out_t, packed_t, gout, gout_t
        torch.cuda.empty_cache()
        serving(sc, libs, args.parent, card)
        end_to_end(sc, caps, libs, args.parent, card)
    return 0


def in_turns(kernels, swaps, run, label, card):
    """``run()`` with each entry of ``kernels`` ({which: {kernel name:
    library}}) swapped into the wrappers in turns this, parent, parent,
    this: host ms (median of 7 synchronized calls), device busy ms per call
    (torch.profiler, 3 calls), and whether the outputs of the two are
    equal."""
    import torch
    from splat_one_tpu_torch.utils import cuda_build

    ms, busy, outs = {k: [] for k in kernels}, {k: [] for k in kernels}, {}
    for which in ("this", "parent", "parent", "this"):
        with contextlib.ExitStack() as stack:
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


def end_to_end(sc, caps, libs, parent, card):
    """The fwd+bwd step of chip_smoke.py's phases 5a and 5a-i, with the
    path's forward and backward kernels as they are and ``parent``'s in
    turns."""
    import torch
    from splat_one_tpu_torch.render.rasterization import rasterization

    dev = torch.device("cuda")
    W, H = cs.W_SERVE, cs.H_SERVE
    leaves = [torch.tensor(sc[k], device=dev, requires_grad=True)
              for k in ("means", "quats", "scales", "opac", "sh")]
    vm, K = (torch.as_tensor(sc[k], device=dev) for k in ("viewmats", "Ks"))
    for impl, names in (("stream", ("stream_fwd", "stream_bwd")),
                        ("tiled", ("tile_fwd", "tile_bwd"))):
        kw = dict(caps=caps) if impl == "stream" else dict(impl="tiled")

        def step():
            render, alpha, _ = rasterization(*leaves[:4], leaves[4], vm, K, W, H,
                                             sh_degree=3, render_mode="RGB+ED", **kw)
            return torch.autograd.grad(render.sum() + alpha.sum(), leaves)

        kernels = {"this": {n: libs[n] for n in names},
                   "parent": {n: libs[f"{n} of {parent}"] for n in names}}
        in_turns(kernels, names, step, f"{impl} fwd+bwd step, 1M / SH 3 / {W}x{H} "
                 f"(gradients)", card)


if __name__ == "__main__":
    sys.exit(main())
