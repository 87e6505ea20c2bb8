"""Anatomy of the per-gaussian gradient reduction on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 reduce_anatomy.py --parent DIR

``DIR`` holds the csrc sources of another version of the kernels
(unpacked with git archive); its ``seg_reduce.cu`` must be the contiguous
reduce of key-sorted rows (C launcher ``seg_reduce(rows, bounds, out, m0,
n_payload, stream)``), the reduce before the indexed one. The parent's
reduction paths are rebuilt here from it:
- stream: ``stream_isect.sort_grad_rows`` (a stable sort of every
  pad_cap key and a gather of every row) and that kernel;
- tiled: a gather of every align_cap row by ``rank_perm``, that kernel,
  and a scatter through ``rank_src``.

Inputs: chip_smoke.py's phase 5a / 5a-i: bench.py's 1M-gaussian scene
(SH degree 3, 1280x720, seed 0), the step's cotangent, the backward
kernels' gradient rows (stream_bwd without absgrad: 10 payload columns;
tile_bwd: 12). For each path, the parent's and this version's
(``stream_isect.reduce_stream_grads``, ``intersect.gather_reduction``):
1. a torch.profiler trace of one call with shapes: every device activity
   in order (name, ms), the host ops that launched the most device time
   with their input shapes, the host's synchronisations, device busy and
   host ms of the call;
2. CUDA-event times in turns (this, parent, parent, this), the outputs of
   the two equal bit for bit;
3. the candidates for the stream path's row order, each followed by the
   same seg_reduce launch and held to its bits, in turns: (a) the keyed
   rows selected (torch.nonzero: a host synchronisation) and their keys
   alone sorted stably; (b) keyed_perm, the counting sort the port ships;
   (c) the stable sort of all pad_cap keys, its whole order passed as the
   index with the searchsorted bounds (no read back);
4. this version's seg_reduce.cu against variants of itself (text
   substitutions; it fails where one no longer matches), at both inputs,
   in turns: one and two lanes a gaussian with U = 1, 2 and 4 rows in
   flight a lane, for both outputs (each variant sets the planar and the
   indexed shape; they must give the kernel's bits), and, at the tiled input, the sums written as 4-byte
   values into the planes of a [12, M0] output at rank_src (the layout the
   plain version has) and at the rank itself (no scatter; other bits);
5. chip_smoke.py's fwd+bwd step through each rasterizer path with the
   parent's reduction and this version's swapped in, in turns: host ms
   (median of 7), device busy ms per step (a trace of 3), peak memory above
   the inputs, gradients equal.
Every line carries the card's name and power limit.
"""

import argparse
import contextlib
import ctypes
import statistics
import sys
import time

import chip_smoke as cs

# seg_reduce.cu's shape constants as the source sets them
_SHAPE = {"U": 2, "LANES_PLANAR": 1, "LANES_INDEXED": 2}


def _shape(lanes, u):
    """Substitutions that give both outputs ``lanes`` lanes a gaussian and
    ``u`` rows in flight a lane."""
    return [(f"constexpr int {k} = {v};",
             f"constexpr int {k} = {lanes if k.startswith('LANES') else u};")
            for k, v in _SHAPE.items()]


_PLANAR_OUT = ("  if (OUT_IDX) {\n    float4* o", "  if (false) {\n    float4* o")
# seg_reduce.cu variant -> ([(text, replacement)], same bits as the kernel)
VARIANTS = dict(
    {f"{n} lane{'s' * (n > 1)}, U {u}": (_shape(n, u), True)
     for n in (1, 2) for u in (1, 2, 4)},
    **{"planar writes at the index": ([_PLANAR_OUT], False),
       "planar writes at the rank": ([_PLANAR_OUT, ("const int dst = OUT_IDX ? out_index[m] : m;",
                                                    "const int dst = m;")], False)})


def parent_reduce(lib):
    """The parent's reduction paths around its contiguous kernel ``lib``
    -> (stream fn(pgrads, num_flat, n_payload), tiled fn(pgrads, isect,
    num_flat))."""
    import torch
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import stream_isect as si

    def kernel(rows, bounds, n_payload):
        m0 = bounds.shape[0] - 1
        out = torch.empty((n_payload, m0), dtype=torch.float32, device=rows.device)
        rc = lib.seg_reduce(rows.data_ptr(), bounds.data_ptr(), out.data_ptr(), m0,
                            n_payload, torch.cuda.current_stream().cuda_stream)
        cs.require(rc == 0, f"parent seg_reduce launch failed ({rc})")
        return out

    def stream(pgrads, num_flat, n_payload=si.N_GCOLS):
        rows, bounds = si.sort_grad_rows(pgrads, num_flat)
        return kernel(rows, bounds, n_payload)

    def tiled(pgrads, isect, num_flat):
        rows = pgrads[isect.rank_perm.long()]
        per_rank = kernel(rows, isect.rank_bounds, itx.N_GROWS)
        out = per_rank.new_empty((itx.N_GROWS, num_flat))
        out[:, isect.rank_src.long()] = per_rank
        return out

    return stream, tiled


def trace_call(label, fn, card):
    """Part 1 for one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    busy = sum(e.time_range.end - e.time_range.start for e in dev) / 1e3
    window = ((dev[-1].time_range.end - dev[0].time_range.start) / 1e3) if dev else 0.0
    print(f"[{label}] one call: host {host_ms:.4f} ms (ends in synchronize), "
          f"{len(dev)} device activities, device busy {busy:.4f} ms over a window of "
          f"{window:.4f} ms | {card}", flush=True)
    for e in dev:
        print(f"    {(e.time_range.end - e.time_range.start) / 1e3:.4f} ms  {e.name[:110]}",
              flush=True)
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    ops = [a for a in prof.key_averages(group_by_input_shape=True)
           if a.device_type == DeviceType.CPU]
    print(f"  [{label}] host ops by the device time they launched (input shapes):",
          flush=True)
    for a in sorted(ops, key=lambda a: -getattr(a, key))[:10]:
        if getattr(a, key) <= 0:
            break
        print(f"    {getattr(a, key) / 1e3:.4f} ms device, {a.cpu_time_total / 1e3:.4f} ms "
              f"host, x{a.count}: {a.key} {a.input_shapes}", flush=True)
    syncs = [a for a in ops if any(s in a.key for s in ("Synchronize", "Memcpy", "item",
                                                        "_local_scalar_dense", "nonzero"))]
    print(f"  [{label}] host synchronisations and copies: " + (", ".join(
        f"{a.key} x{a.count} ({a.cpu_time_total / 1e3:.4f} ms)" for a in syncs) or "none"),
        flush=True)


def order_candidates(pg, n, n_pay, iters, card):
    """Part 3: (perm, bounds) by each candidate, then seg_reduce; times in
    turns, bits equal to the shipped path's."""
    import torch
    from splat_one_tpu_torch.ops import seg_reduce as sgr
    from splat_one_tpu_torch.ops import stream_isect as si

    queries = torch.arange(1, n + 2, dtype=torch.int32, device=pg.device)

    def compacted():
        key32 = pg[:, si.GCOL_KEY].to(torch.int32)
        rows = torch.nonzero(key32 > 0)[:, 0]
        sk, order = torch.sort(key32[rows], stable=True)
        return rows[order].int(), torch.searchsorted(sk, queries, out_int32=True)

    def full_sort():
        sk, order = torch.sort(pg[:, si.GCOL_KEY].to(torch.int32), stable=True)
        return order.int(), torch.searchsorted(sk, queries, out_int32=True)

    cands = {"(a) compacted keys sorted": compacted,
             "(b) keyed_perm": lambda: sgr.keyed_perm(pg, n),
             "(c) all keys sorted": full_sort}
    want = si.reduce_stream_grads(pg, n, n_pay)
    for k, fn in cands.items():
        cs.require(torch.equal(sgr.segment_reduce_rows(pg, *fn(), n_pay), want),
                   f"{k}: the reduction's bits differ")
    ms = {k: [] for k in cands}
    for order in (list(cands), list(cands)[::-1]):
        for k in order:
            ms[k].append(cs.cuda_ms(lambda: sgr.segment_reduce_rows(pg, *cands[k](), n_pay),
                                    iters))
    print("stream row order candidates + seg_reduce (CUDA events, in turns): " + "; ".join(
        f"{k} {', '.join(f'{x:.4f}' for x in v)} ms" for k, v in ms.items())
        + f"; every one bit-equal | {card}", flush=True)


def variant_times(vlibs, pg, n, n_pay, pg_t, isect_t, iters, card):
    """Part 4: the kernel as it is and its variants, at the stream input
    (through keyed_perm's index) and the tiled one, in turns."""
    import torch
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import seg_reduce as sgr
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.utils import cuda_build

    perm, bounds = sgr.keyed_perm(pg, n)
    inputs = {"stream": (pg, perm, bounds, None, n_pay),
              "tiled": (pg_t, isect_t.rank_perm, isect_t.rank_bounds, isect_t.rank_src,
                        itx.N_GROWS)}
    libs = dict(vlibs, **{"as it is": cuda_build.library("seg_reduce")})

    def launch(label, path, out):
        rows, p, b, idx, npay = inputs[path]
        rc = libs[label].seg_reduce(rows.data_ptr(), p.data_ptr(), b.data_ptr(),
                                    idx.data_ptr() if idx is not None else None,
                                    out.data_ptr(), n, npay,
                                    torch.cuda.current_stream().cuda_stream)
        cs.require(rc == 0, f"seg_reduce {label}: launch failed ({rc})")
        return out

    runs = [(label, path) for label in libs for path in inputs
            if path == "tiled" or "writes" not in label]
    fresh = lambda: torch.zeros((n, si.NF), device=pg.device)
    for label, path in runs:
        if label in VARIANTS and VARIANTS[label][1]:
            cs.require(torch.equal(launch(label, path, fresh()),
                                   launch("as it is", path, fresh())),
                       f"seg_reduce {label} ({path}): bits differ from the kernel's")
    out = fresh()
    times = {r: [] for r in runs}
    for order in (runs, runs[::-1]):
        for label, path in order:
            times[(label, path)].append(cs.cuda_ms(lambda: launch(label, path, out), iters))
    for (label, path), ts in times.items():
        print(f"seg_reduce {label} [{path}]: {statistics.mean(ts):.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in ts)}; CUDA events, {iters} launches) | "
              f"{card}", flush=True)


@contextlib.contextmanager
def reduction(which, fns):
    """Within the block the rasterizers reduce with ``fns[which]`` (a pair
    of stream and tiled functions); ``"this"`` leaves the package's own."""
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import stream_isect as si

    saved = si.reduce_stream_grads, itx.gather_reduction
    if which != "this":
        si.reduce_stream_grads, itx.gather_reduction = fns[which]
    try:
        yield
    finally:
        si.reduce_stream_grads, itx.gather_reduction = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="csrc directory holding the contiguous seg_reduce.cu")
    ap.add_argument("--iters", type=int, default=20, help="calls per timing")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("reduce_anatomy: CUDA is not available")
        return 1
    import raster_anatomy as ra
    from splat_one_tpu_torch.ops import intersect as itx
    from splat_one_tpu_torch.ops import stream_isect as si
    from splat_one_tpu_torch.ops import stream_raster as sr
    from splat_one_tpu_torch.ops import tile_raster as tr
    from splat_one_tpu_torch.ops.projection import project_gaussians
    from splat_one_tpu_torch.render.rasterization import rasterization
    from splat_one_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    label, so, proc = ra.build(args.parent, "seg_reduce", "seg_reduce of parent")
    variants = {k: ra.build(cuda_build.CSRC_DIR, "seg_reduce", f"seg_reduce {k}", subs)
                for k, (subs, _) in VARIANTS.items()}
    for name, entry in sorted(cuda_build.build().items()):
        if name in ("seg_reduce", "keyed_perm"):
            for kern, regs, stores, loads, rest in cs.ptxas_entries(entry["ptxas"]):
                print(f"  {name}: {kern} {regs} registers, {stores} B spill stores, "
                      f"{loads} B spill loads; {rest}", flush=True)
    text, _ = proc.communicate()
    cs.require(proc.returncode == 0, f"nvcc failed for {label}:\n{text}")
    vlibs = {}
    for k, (vlabel, vso, vproc) in variants.items():
        vtext, _ = vproc.communicate()
        cs.require(vproc.returncode == 0, f"nvcc failed for {vlabel}:\n{vtext}")
        vlibs[k] = cuda_build.load(vso, "seg_reduce")
    plib = ctypes.CDLL(str(so))
    plib.seg_reduce.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    plib.seg_reduce.restype = ctypes.c_int
    fns = {"parent": parent_reduce(plib)}

    W, H, N = cs.W_SERVE, cs.H_SERVE, cs.N_SERVE
    sc = cs.bench_scene(N, W, H, 1000.0, -6.5, -5.0, seed=0)
    t = lambda x: torch.as_tensor(x, device=dev)
    leaves = [torch.tensor(sc[k], device=dev, requires_grad=True)
              for k in ("means", "quats", "scales", "opac", "sh")]
    vm, K = t(sc["viewmats"]), t(sc["Ks"])

    def cotangent(o, to_image):  # the step's loss: sum(render, ED) + sum(alpha)
        leaf = o.detach().requires_grad_(True)
        rgb, a, d = to_image(leaf)
        loss = torch.cat([rgb, d / torch.clamp(a, min=1e-10)], -1).sum() + a.sum()
        return torch.autograd.grad(loss, leaf)[0].contiguous()

    with torch.no_grad():
        proj = project_gaussians(*(x.detach() for x in leaves[:4]), vm, K, W, H,
                                 sh_coeffs=leaves[4].detach(), sh_degree=3)
        caps = cs.bench_caps(proj, W, H)
        cfg = sr.StreamCfg.from_caps(caps, W, H, 16, 1, N)
        isect = si.build_stream_intersections(proj, W, H, 16, caps)
        packed = si.pack_stream(si.build_fields(proj), isect, caps)
        out = sr.stream_fwd(cfg, isect.st_starts, packed)
        cfg_t, st_t, packed_t, isect_t = cs.tile_inputs(dict(w=W, h=H, camera_model="pinhole"),
                                                        proj)
        out_t = tr.tile_fwd(cfg_t, st_t, packed_t)
    gout = cotangent(out, lambda o: sr.stream_to_image(cfg, o))
    gout_t = cotangent(out_t, lambda o: tr.tiles_to_image(cfg_t, o))
    with torch.no_grad():
        pg = sr.stream_bwd(cfg, isect.st_starts, isect.st_starts_al, packed, out, gout)
        pg_t = tr.tile_bwd(cfg_t, st_t, packed_t, out_t, gout_t)
    del packed, out, packed_t, out_t
    n_pay = si.GCOL_ABSDX
    n_keyed = int((pg[:, si.GCOL_KEY] > 0).sum())
    print(f"inputs: stream rows [{cfg.pad_cap}, {si.NF}] ({n_keyed} keyed, n_isect "
          f"{int(isect.n_isect)}), {n_pay} payload columns; tiled rows [{cfg_t.align_cap}, "
          f"{itx.NF}] ({int(isect_t.n_slots)} aligned slots in use, "
          f"{int(isect_t.rank_bounds[-1])} intersections), {itx.N_GROWS} payload columns",
          flush=True)

    calls = {
        "stream": {"this": lambda: si.reduce_stream_grads(pg, N, n_pay),
                   "parent": lambda: fns["parent"][0](pg, N, n_pay)},
        "tiled": {"this": lambda: itx.gather_reduction(pg_t, isect_t, N),
                  "parent": lambda: fns["parent"][1](pg_t, isect_t, N)},
    }
    with torch.no_grad():
        for path, by in calls.items():
            for which in ("parent", "this"):
                trace_call(f"{path} reduction, {which}", by[which], card)
            cs.require(torch.equal(by["this"](), by["parent"]()),
                       f"{path}: this reduction's bits differ from the parent's")
            ms = {"this": [], "parent": []}
            for which in ("this", "parent", "parent", "this"):
                ms[which].append(cs.cuda_ms(by[which], args.iters))
            print(f"{path} reduction from the backward's rows (CUDA events, {args.iters} "
                  f"calls, in turns): " + "; ".join(
                      f"{w} {', '.join(f'{x:.4f}' for x in v)} ms" for w, v in ms.items())
                  + f"; outputs equal bit for bit | {card}", flush=True)
    order_candidates(pg, N, n_pay, args.iters, card)
    variant_times(vlibs, pg, N, n_pay, pg_t, isect_t, args.iters, card)
    del pg, pg_t, isect_t
    torch.cuda.empty_cache()

    for impl in ("stream", "tiled"):
        kw = dict(caps=caps) if impl == "stream" else dict(impl="tiled")

        def step():
            render, alpha, _ = rasterization(*leaves[:4], leaves[4], vm, K, W, H,
                                             sh_degree=3, render_mode="RGB+ED", **kw)
            return torch.autograd.grad(render.sum() + alpha.sum(), leaves)

        ms, busy, peak, outs = {}, {}, {}, {}
        for which in ("this", "parent", "parent", "this"):
            with reduction(which, fns):
                outs[which] = step()
                torch.cuda.synchronize()
                times = []
                for _ in range(7):
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                ms.setdefault(which, []).append(statistics.median(times))
                trace = cs.device_trace(step, 3)
                busy.setdefault(which, []).append(trace[1] if trace else float("nan"))
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                step()
                torch.cuda.synchronize()
                peak.setdefault(which, []).append(
                    (torch.cuda.max_memory_allocated() - base) / 2**20)
        same = all(torch.equal(a, b) for a, b in zip(outs["this"], outs["parent"]))
        print(f"{impl} fwd+bwd step, 1M / SH 3 / {W}x{H}, reduction swapped in turns: " +
              "; ".join(f"{w} host {', '.join(f'{x:.3f}' for x in ms[w])} ms (median of "
                        f"7), device busy {', '.join(f'{x:.3f}' for x in busy[w])} ms, peak "
                        f"memory above the inputs {', '.join(f'{x:.0f}' for x in peak[w])} MiB"
                        for w in ms) + f"; gradients equal: {same} | {card}", flush=True)
        cs.require(same, f"{impl} step: this reduction's gradients differ from the parent's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
