"""Anatomy of the two backward compositing kernels on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 bwd_anatomy.py [--parent DIR]

At chip_smoke.py's phase 5a / 5a-i inputs (bench.py's 1M-gaussian scene,
SH degree 3, 1280x720, pinhole front, the step's cotangent) it builds
csrc/stream_bwd.cu and csrc/tile_bwd.cu as they are and variants with
one part of the per-slot work taken out (text substitutions of the
source; it fails where a substitution's text is not in the source), into
splat_one_tpu_torch/_build/anatomy/; fails unless every build of a kernel
as it is gives the bits of the wrapper's build; times every build in turns (CUDA
events, two rounds, the second in reverse order) with the card's name and
power limit; and counts how the per-slot work spreads over the 32-pixel
warps of the plain versions' tree: live (some pixel composites), dead
(gated but no pixel composites), ungated, and the share of the busiest
warp's live slots that the others reach between two barriers.
``--parent DIR`` also times the csrc sources in DIR (another version of
the kernels, unpacked with git archive) in the same turns, and then
chip_smoke.py's fwd+bwd step through each rasterizer path with the
backward kernel as it is and DIR's in its place (host ms, median of 7
synchronized steps, in turns this, DIR, DIR, this; device busy ms per step
from a torch.profiler trace of 3 steps; the gradients of the two equal).
"""

import argparse
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import chip_smoke as cs

# variant -> [(source text, replacement)], the same for both kernels but
# for the walk over a chunk's slots
_COMMON = {
    "no sums": [("const float sum = bwd::half_warp_sum<NR>(spend, lane);",
                 "const float sum = spend[0] + spend[NR - 1];")],
    "no division": [("bwd::div_rn(dconst[q] - pre[q], inv)", "(dconst[q] - pre[q])"),
                    ("bwd::div_rn(gAT[q], inv)", "gAT[q]")],
    "no gradients": [("float v[2][NR];", "continue;\n      float v[2][NR];")],
}
VARIANTS = {
    "stream_bwd": dict(_COMMON, **{"no walk": [
        ("for (unsigned m = gmask[i]; m != 0; m &= m - 1) {",
         "for (unsigned m = 0; m != 0; m &= m - 1) {")]}),
    "tile_bwd": dict(_COMMON, **{"no walk": [
        ("for (int g = 0; g < G; ++g) {", "for (int g = 0; g < 0; ++g) {")]}),
}


def build(src_dir, name, label, subs=()):
    """Start nvcc on ``src_dir/name.cu`` with ``subs`` applied -> (label,
    library path, process). Raises where a substitution's text is not in
    the source."""
    from splat_one_tpu_torch.utils import cuda_build

    text = (Path(src_dir) / f"{name}.cu").read_text()
    for a, b in subs:
        cs.require(a in text, f"{label}: {a!r} is not in {name}.cu")
        text = text.replace(a, b)
    d = cuda_build.BUILD_DIR / "anatomy" / label.replace(" ", "_").replace(",", "")
    d.mkdir(parents=True, exist_ok=True)
    for h in Path(src_dir).glob("*.cuh"):
        shutil.copy(h, d / h.name)
    (d / f"{name}.cu").write_text(text)
    so = d / f"lib{name}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
           str(d / f"{name}.cu")]
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
        print("bwd_anatomy: CUDA is not available")
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
    t = lambda x: torch.as_tensor(x, device=dev)
    g = [t(sc[k]) for k in ("means", "quats", "scales", "opac", "sh")]
    with torch.no_grad():
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

    src = cuda_build.CSRC_DIR
    names = ("stream_bwd", "tile_bwd")
    jobs = [build(src, n, n) for n in names]  # the kernels as they are
    if args.parent:
        jobs += [build(args.parent, n, f"{n} of {args.parent}") for n in names]
    exact = [label for label, _, _ in jobs]  # builds that must give the wrapper's bits
    jobs += [build(src, n, f"{n} {k}", v) for n in names for k, v in VARIANTS[n].items()]
    fns, libs = {}, {}
    for label, so, proc in jobs:
        text, _ = proc.communicate()
        cs.require(proc.returncode == 0, f"nvcc failed for {label}:\n{text}")
        ents = cs.ptxas_entries(text)
        print(f"{label}: " + "; ".join(f"{k} {r} registers, {a} B spill stores, {b} B spill "
                                       f"loads" for k, r, a, b, _ in ents), flush=True)
        name = label.split()[0]
        libs[label] = cuda_build.load(so, name)
        fns[label] = getattr(libs[label], name)

    inv_w = float(np.float32(1.0 / W))

    def launch(label):
        fn = fns[label]
        stream = torch.cuda.current_stream().cuda_stream
        if label.startswith("stream_bwd"):
            pg = torch.zeros((cfg.pad_cap, si.NF), device=dev)
            rc = fn(isect.st_starts.data_ptr(), isect.st_starts_al.data_ptr(),
                    packed.data_ptr(), out.data_ptr(), gout.data_ptr(), pg.data_ptr(),
                    cfg.cs, cfg.sw, cfg.sh, cfg.tw, 0, float(W), inv_w, 0, stream)
        else:
            pg = torch.zeros((cfg_t.align_cap, itx.NF), device=dev)
            rc = fn(st_t.data_ptr(), packed_t.data_ptr(), out_t.data_ptr(), gout_t.data_ptr(),
                    pg.data_ptr(), cfg_t.ct, cfg_t.tw, cfg_t.tw * cfg_t.th, 0, float(W),
                    inv_w, stream)
        cs.require(rc == 0, f"{label}: launch failed ({rc})")
        return pg

    with torch.no_grad():  # the wrappers, through the package's own builds
        ref = {"stream_bwd": sr.stream_bwd(cfg, isect.st_starts, isect.st_starts_al, packed,
                                           out, gout),
               "tile_bwd": tr.tile_bwd(cfg_t, st_t, packed_t, out_t, gout_t)}
    for label in exact:
        cs.require(torch.equal(launch(label), ref[label.split()[0]]),
                   f"{label}: bits differ from the wrapper's build")
    print(f"equal bits to the wrappers' builds: {', '.join(exact)}")
    labels = list(fns)
    times = {k: [] for k in labels}
    for order in (labels, labels[::-1]):
        for label in order:
            times[label].append(cs.cuda_ms(lambda: launch(label), args.iters))
    zs = cs.cuda_ms(lambda: torch.zeros((cfg.pad_cap, si.NF), device=dev), args.iters)
    zt = cs.cuda_ms(lambda: torch.zeros((cfg_t.align_cap, itx.NF), device=dev), args.iters)
    print(f"the wrappers' zeroed outputs alone (included below): stream_bwd {zs:.4f} ms, "
          f"tile_bwd {zt:.4f} ms | {card}")
    for label in labels:
        print(f"{label}: {statistics.mean(times[label]):.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in times[label])}; CUDA events, "
              f"{args.iters} launches) | {card}")
    for name, args_ in (("stream_bwd", (cfg, isect.st_starts, packed, out, True)),
                        ("tile_bwd", (cfg_t, st_t, packed_t, out_t, False))):
        live, dead, ung, share = warp_slots(*args_)
        print(f"{name} (32-pixel warp, slot) visits: live {live}, dead {dead}, ungated "
              f"{ung}; mean live slots of a block's warps over its busiest warp's, per "
              f"chunk: {share:.3f}")
    if args.parent:
        end_to_end(sc, caps, libs, args.parent, card)
    return 0


def end_to_end(sc, caps, libs, parent, card):
    """The fwd+bwd step of chip_smoke.py's phases 5a and 5a-i, with the
    backward kernel as it is and ``parent``'s swapped into the wrapper."""
    import torch
    from splat_one_tpu_torch.render.rasterization import rasterization
    from splat_one_tpu_torch.utils import cuda_build

    dev = torch.device("cuda")
    W, H = cs.W_SERVE, cs.H_SERVE
    leaves = [torch.tensor(sc[k], device=dev, requires_grad=True)
              for k in ("means", "quats", "scales", "opac", "sh")]
    vm, K = (torch.as_tensor(sc[k], device=dev) for k in ("viewmats", "Ks"))
    for impl, name in (("stream", "stream_bwd"), ("tiled", "tile_bwd")):
        kw = dict(caps=caps) if impl == "stream" else dict(impl="tiled")

        def step():
            render, alpha, _ = rasterization(*leaves[:4], leaves[4], vm, K, W, H,
                                             sh_degree=3, render_mode="RGB+ED", **kw)
            return torch.autograd.grad(render.sum() + alpha.sum(), leaves)

        kernels = {"this": libs[name], "parent": libs[f"{name} of {parent}"]}
        ms, busy, grads = {k: [] for k in kernels}, {k: [] for k in kernels}, {}
        for which in ("this", "parent", "parent", "this"):
            with cuda_build.swapped(name, kernels[which]):
                cs.require(cuda_build.library(name) is kernels[which],
                           f"{name}: swap not in effect")
                grads[which] = step()
                torch.cuda.synchronize()
                times = []
                for _ in range(7):
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                ms[which].append(statistics.median(times))
                trace = cs.device_trace(step, 3)
                busy[which].append(trace[1] if trace else float("nan"))
        same = all(torch.equal(a, b) for a, b in zip(grads["this"], grads["parent"]))
        print(f"{impl} fwd+bwd step, 1M / SH 3 / {W}x{H}: " + "; ".join(
            f"{which} step {', '.join(f'{x:.3f}' for x in ms[which])} ms (host, median of 7), "
            f"device busy {', '.join(f'{x:.3f}' for x in busy[which])} ms per step"
            for which in kernels) + f"; gradients equal: {same} | {card}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
