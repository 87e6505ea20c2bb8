"""The port's ``Renderer`` serving 2D Gaussian Splatting models
(``primitive="2dgs"``: ``rasterization_2dgs``, ``ops.surfels``).

On the CPU:

- at the benchmark's ``garden_2dgs`` layout cut to 3,000 surfels in 4,096
  rows and 96 x 64 pixels, and on scenes of surfels seen nearly edge-on
  and just past the near plane, the port's rgb, expected depth and alpha
  match the plain reference (``benchmark/reference/surfel.py``);
- every pixel where a surfel's alpha (in float64, from its float32 ray
  transform) reaches 1/255 lies inside the box the build uses;
- the 3DGS ``Renderer`` on the same weights still matches the 3DGS
  reference, and differs from the 2DGS render;
- the kernel wrappers refuse autograd and CPU tensors before loading a
  library, and pass ctypes' conversion of their launchers' signatures;
- a traced request counts ``n_visible`` in ``render.project``, which
  ``visible_share.2dgs`` reads; the cell's counts and readers;
- the viewer's server serves a 2DGS checkpoint; the harness finds
  ``garden_2dgs.view``'s files; the surfel reference imports neither JAX
  nor the port.

On the card (``-m gpu``; ``python -m pytest tests/test_torch_viewer_2dgs.py
-m gpu --noconftest``): the three kernels against their plain versions
(the projection's fields but the colours, the pack's table and the
forward's output bit for bit; the colours within PROJ_COLOR_ATOL), one
launch each a request, and autograd refused.
"""

import contextlib
import ctypes
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark import scene as S
from benchmark.models import gaussians as G
from benchmark.models import surfels as M
from benchmark.reference import render as R
from benchmark.reference import surfel as RS
from benchmark.tests import bench_tiny as B
from splat_one_tpu_torch.app import viewer
from splat_one_tpu_torch.ops import stream_isect as si
from splat_one_tpu_torch.ops import stream_raster as sr
from splat_one_tpu_torch.ops import surfels as SF
from splat_one_tpu_torch.render.rasterization import rasterization_2dgs
from splat_one_tpu_torch.utils import cuda_build, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 96, 64
SEED = 2**31 + 23
# Port against reference, both float32. The projection's and the alpha's
# operations are the same up to the order of a few sums (the reference's
# matrix products, its dual conics as sums over three terms); the
# compositing differs in form (the reference's transmittance is the exp of
# a cumulative sum of log1p, the port's a running product), so a pixel
# behind ~80 layers moves by a few ulps of 1 (read: 6e-7), and the
# tile's stop at 1e-5 can take one chunk more or fewer, up to ~1e-5.
RGB_MAX = 2e-5
RGB_MEAN = 1e-6
ALPHA_MAX = 2e-5
DEPTH_REL = 2e-5  # mean |ED - reference| over alpha > 0.5, over the mean ED there
# The kernel's colours against the plain projection's: the SH sum's order
# (as csrc/project_fwd.cu's).
PROJ_COLOR_ATOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = B.tiny_config("garden_2dgs", n=3000, cap=4096, w=W, h=H)
    weights, alive = M.make_weights(cfg, SEED, torch.device("cpu"))
    return cfg, weights, alive


def _compare(rgb, ed, alpha, ref):
    d = (rgb - ref.rgb).abs()
    m = ref.alpha[..., 0] > 0.5
    assert bool(m.any())
    depth_rel = float((ed - ref.depth).abs()[m].mean() / ref.depth[m].mean())
    assert float(d.max()) <= RGB_MAX and float(d.mean()) <= RGB_MEAN, (float(d.max()),
                                                                       float(d.mean()))
    assert float((alpha - ref.alpha).abs().max()) <= ALPHA_MAX
    assert depth_rel <= DEPTH_REL, depth_rel


@pytest.mark.parametrize("angle", [0.3, 2.0, 4.5])
def test_renderer_matches_the_reference(model, angle):
    cfg, weights, alive = model
    pose, K = S.orbit_pose(cfg["cameras"], angle), S.intrinsics(cfg)
    ref = RS.render(M.reference_rows(weights, alive), pose, K, W, H, RS.camera("pinhole"),
                    M.color)
    assert ref.visible > 1000 and float(ref.alpha.min()) > 0.99 and ref.needed > 10 * W * H
    rd = viewer.Renderer(weights, alive, W, H, device="cpu", primitive="2dgs")
    rgb, ed, alpha, info = rd.render(pose, K)
    _compare(rgb, ed, alpha, ref)
    assert int(info["valid"].sum()) == ref.visible


def _rotation_quats(Rm):
    """wxyz quaternions of rotation matrices [N, 3, 3] (trace > -1)."""
    tr = Rm[:, 0, 0] + Rm[:, 1, 1] + Rm[:, 2, 2]
    w = torch.sqrt(torch.clamp(1 + tr, min=1e-12)) / 2
    return torch.stack([w, (Rm[:, 2, 1] - Rm[:, 1, 2]) / (4 * w),
                        (Rm[:, 0, 2] - Rm[:, 2, 0]) / (4 * w),
                        (Rm[:, 1, 0] - Rm[:, 0, 1]) / (4 * w)], 1)


def _hard_scene(mode: str, n: int = 400, seed: int = 1):
    """Stored weights of ``n`` surfels in front of a camera at the origin
    looking down +z (K: f 150, 160 x 120): ``random``; ``edge``, each
    disc holding the ray to its centre up to 1e-3 (seen edge-on);
    ``near``, a tenth of them with centres 0.02 to 0.32 in front of the
    camera and small discs (some reaching the camera plane, which culls
    them)."""
    g = torch.Generator().manual_seed(seed)
    means = torch.randn((n, 3), generator=g) * torch.tensor([1.0, 0.8, 0.3]) + torch.tensor(
        [0, 0, 3.0])
    quats = torch.randn((n, 4), generator=g)
    log_scales = torch.randn((n, 3), generator=g) * 0.7 - 2.5
    if mode == "edge":
        d = means / means.norm(dim=1, keepdim=True)
        t_u = torch.linalg.cross(d, torch.randn((n, 3), generator=g))
        t_u = t_u / t_u.norm(dim=1, keepdim=True)
        t_v = d + 1e-3 * torch.randn((n, 3), generator=g) * torch.rand((n, 1), generator=g)
        t_v = t_v - (t_v * t_u).sum(1, keepdim=True) * t_u
        t_v = t_v / t_v.norm(dim=1, keepdim=True)
        quats = _rotation_quats(torch.stack([t_u, t_v, torch.linalg.cross(t_u, t_v)], -1))
        log_scales = torch.randn((n, 3), generator=g) * 0.5 - 2.3
    elif mode == "near":  # a tenth of the rows
        k = n // 10
        means[:k] = means[:k] * torch.tensor([0.05, 0.05, 0.0]) + torch.tensor([0, 0, 1.0]) * (
            0.02 + 0.3 * torch.rand((k, 1), generator=g))
        log_scales[:k] = torch.randn((k, 3), generator=g) * 0.5 - 4.5
    opac = torch.rand(n, generator=g) * 0.998 + 0.001
    weights = {"means": means, "quats": quats, "scales": log_scales,
               "opacities": torch.logit(opac), "sh0": (torch.rand((n, 1, 3), generator=g) - 0.5)
               / G.SH_C0, "shN": 0.1 * torch.randn((n, 15, 3), generator=g)}
    K = np.float32([[150, 0, 80], [0, 150, 60], [0, 0, 1]])
    return weights, torch.ones(n, dtype=torch.bool), np.eye(4, dtype=np.float32), K


@pytest.mark.parametrize("mode", ["edge", "near"])
def test_edge_on_and_near_plane_surfels(mode):
    weights, alive, pose, K = _hard_scene(mode)
    ref = RS.render(G.reference_rows(weights, alive), pose, K, 160, 120, RS.camera("pinhole"),
                    G.color)
    assert ref.visible > 100
    rd = viewer.Renderer(weights, alive, 160, 120, device="cpu", primitive="2dgs")
    rgb, ed, alpha, info = rd.render(pose, K)
    assert not bool(info["overflow"])
    _compare(rgb, ed, alpha, ref)
    valid = info["valid"][0]
    assert int(valid.sum()) == ref.visible
    if mode == "near":  # some discs reach the camera plane and are culled
        assert int(valid.sum()) < len(valid)


@pytest.mark.parametrize("mode", ["random", "edge", "near"])
def test_boxes_hold_every_pixel_alpha_reaches(mode):
    """Every pixel centre where a valid surfel's alpha, worked out in
    float64 from its float32 ray transform, is at least 1/255 lies inside
    its box: the build and the forward's gate drop no pair the model
    needs."""
    weights, alive, pose, K = _hard_scene(mode)
    act = G.reference_rows(weights, alive)
    w2c = torch.as_tensor(np.linalg.inv(pose))[None]
    p = SF.project_surfels_plain(act["means"], act["quats"], act["scales"],
                                 act["opacities"], w2c, torch.as_tensor(K)[None], 160, 120,
                                 act["sh"], 3)
    T, m, box = (x[0].double() for x in (p.transforms, p.means2d, p.boxes))
    o = act["opacities"].double()
    ys, xs = torch.meshgrid(torch.arange(120, dtype=torch.float64) + 0.5,
                            torch.arange(160, dtype=torch.float64) + 0.5, indexing="ij")
    xs, ys = xs.reshape(-1, 1), ys.reshape(-1, 1)
    idx = torch.nonzero(p.valid[0])[:, 0]
    assert len(idx) > 100
    reached = 0
    for i in idx.tolist():
        c = torch.linalg.cross(xs * T[i, 6:9] - T[i, 0:3], ys * T[i, 6:9] - T[i, 3:6])
        g3 = (c[:, 0] / c[:, 2]) ** 2 + (c[:, 1] / c[:, 2]) ** 2
        g2 = 2 * ((xs[:, 0] - m[i, 0]) ** 2 + (ys[:, 0] - m[i, 1]) ** 2)
        hit = (o[i] * torch.exp(-0.5 * torch.minimum(g3, g2)) >= 1 / 255) & (c[:, 2] != 0)
        out = hit & (((xs[:, 0] - box[i, 0]).abs() > box[i, 2])
                     | ((ys[:, 0] - box[i, 1]).abs() > box[i, 3]))
        assert not bool(out.any()), (mode, i)
        reached += int(hit.sum())
    assert reached > 1000


def test_3dgs_renderer_unchanged_on_the_same_weights(model):
    cfg, weights, alive = model
    pose, K = S.orbit_pose(cfg["cameras"], 2.0), S.intrinsics(cfg)
    ref = R.render(G.reference_rows(weights, alive), pose, K, W, H, R.camera("pinhole"),
                   G.color)
    rgb3 = viewer.Renderer(weights, alive, W, H, device="cpu").render(pose, K)[0]
    assert float((rgb3 - ref.rgb).abs().max()) <= 5e-5
    rgb2 = viewer.Renderer(weights, alive, W, H, device="cpu", primitive="2dgs").render(
        pose, K)[0]
    assert float((rgb2 - rgb3).abs().mean()) > 1e-3  # the primitive matters


def test_renderer_refuses_what_2dgs_does_not_serve(model):
    cfg, weights, alive = model
    with pytest.raises(ValueError, match="primitive"):
        viewer.Renderer(weights, alive, W, H, device="cpu", primitive="3dgs+")
    rows = {k: v for k, v in weights.items() if k not in ("sh0", "shN")}
    rows["colors"] = torch.zeros((weights["means"].shape[0], 3))
    with pytest.raises(ValueError, match="SH colour"):
        viewer.Renderer(rows, alive, W, H, device="cpu", primitive="2dgs")
    rd = viewer.Renderer(weights, alive, W, H, device="cpu", primitive="2dgs")
    with pytest.raises(ValueError, match="pinhole"):
        rd.render(S.orbit_pose(cfg["cameras"], 1.0), S.intrinsics(cfg), "spherical")


def _kernel_must_not_run(name):
    raise AssertionError(f"the {name} library was asked for")


def _projection_inputs(n=40, c=1):
    """(means, quats, scales, opacities, viewmats, Ks, width, height, SH
    coefficients of degree 3, 3)."""
    g = torch.Generator().manual_seed(3)
    return (torch.randn((n, 3), generator=g), torch.randn((n, 4), generator=g),
            torch.rand((n, 3), generator=g), torch.rand(n, generator=g),
            torch.eye(4).expand(c, 4, 4).contiguous(),
            torch.tensor([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]]).expand(c, 3, 3)
            .contiguous(), 64, 48, torch.zeros((n, 16, 3)), 3)


def _pack_inputs(c=1, n=40, exp_cap=256):
    f = torch.zeros
    return (f((c, n, 2)), f((c, n, 9)), f((c, n)), f((c, n, 3)), f((c, n)),
            torch.full((exp_cap,), c * n, dtype=torch.int32))


def _bad_calls():
    ins = _projection_inputs()
    recorded = (ins[0].clone().requires_grad_(True),) + ins[1:]
    pack = _pack_inputs()
    caps = si.StreamCaps(exp_cap=256, n_supertiles=12)
    pack_rec = (pack[0].clone().requires_grad_(True),) + pack[1:]
    return [
        ("projection under autograd", lambda: SF.surfel_project(*recorded), "autograd"),
        ("projection of CPU tensors", lambda: SF.surfel_project(*ins), "CUDA device"),
        ("projection of two-column scales",
         lambda: SF.surfel_project(ins[0], ins[1], ins[2][:, :2].contiguous(), *ins[3:]),
         "scales must be float32"),
        ("projection at SH degree 5", lambda: SF.surfel_project(*ins[:9], 5), "SH degree"),
        ("pack under autograd", lambda: SF.surfel_pack(*pack_rec, caps), "autograd"),
        ("pack of CPU tensors", lambda: SF.surfel_pack(*pack, caps), "CUDA device"),
        ("pack of a short slot order",
         lambda: SF.surfel_pack(*pack[:5], pack[5][:100], caps), "sorted_g must be"),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _bad_calls()])
def test_kernel_wrappers_refuse_before_loading(case, monkeypatch):
    """Autograd, device, shape and dtype are checked in Python and raise
    ValueError before any library is built: the surfel kernels have no
    backward, so a CUDA render that autograd records through is refused."""
    monkeypatch.setattr(cuda_build, "library", _kernel_must_not_run)
    _, call, says = next(c for c in _bad_calls() if c[0] == case)
    with pytest.raises(ValueError, match=says):
        call()


def test_wrapper_calls_match_signatures(monkeypatch):
    """Each wrapper's arguments pass ctypes' conversion for its kernel's
    ``SIGNATURES`` entry, in number and kind, with the sizes in their
    places; one launch each, counted."""
    seen = {}

    def launcher(name):
        def fn(*args):
            seen[name] = args
            return 0
        return ctypes.CFUNCTYPE(ctypes.c_int, *cuda_build.SIGNATURES[name])(fn)

    libs = {n: SimpleNamespace(**{n: launcher(n)})
            for n in ("surfel_project", "surfel_pack", "surfel_fwd")}
    monkeypatch.setattr(cuda_build, "library", lambda name: libs[name])
    monkeypatch.setattr(SF, "_check_cuda", lambda named, dev: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_build, "launch_counts", cuda_build.launch_counts.copy())
    out = SF.surfel_project(*_projection_inputs(c=2))
    assert [tuple(t.shape) for t in out] == [(2, 40, 2), (2, 40, 9), (2, 40), (2, 40, 4),
                                             (2, 40, 3), (2, 40)]
    assert list(seen["surfel_project"][13:19]) == [40, 2, 16, 16, 64, 48]
    caps = si.StreamCaps(exp_cap=256, n_supertiles=12)
    packed = SF.surfel_pack(*_pack_inputs(c=2), caps)
    assert tuple(packed.shape) == (caps.packed_rows, si.NF)
    assert list(seen["surfel_pack"][7:10]) == [256, 80, caps.packed_rows]
    cfg = sr.StreamCfg.from_caps(caps, 64, 48, 16, 1, 40)
    monkeypatch.setattr(sr, "_check_kernel_inputs", lambda name, cfg, *t: list(t))
    st = torch.zeros(cfg.cs + 1, dtype=torch.int32)
    fake = SimpleNamespace(device=SimpleNamespace(type="cuda"), requires_grad=False,
                           data_ptr=lambda: 0)
    monkeypatch.setattr(torch, "empty", lambda shape, **kw: SimpleNamespace(
        data_ptr=lambda: 0, shape=shape))
    SF.surfel_fwd(cfg, st, fake)
    assert list(seen["surfel_fwd"][3:6]) == [cfg.cs, cfg.sw, cfg.sh]
    assert [cuda_build.launch_counts[n] for n in libs] == [1, 1, 1]


def test_request_counts_n_visible(model):
    cfg, weights, alive = model
    rd = viewer.Renderer(weights, alive, W, H, device="cpu", primitive="2dgs")
    pose, K = S.orbit_pose(cfg["cameras"], 1.0), S.intrinsics(cfg)
    valid = rd.render(pose, K)[3]["valid"]
    with profile(activities=[ProfilerActivity.CPU]):
        rd(pose, K)
    recs = profiling.spans()
    by_id = {r.id: r for r in recs}
    (proj,) = [r for r in recs if "n_visible" in dict(r.counts)]
    assert proj.name == "render.project" and by_id[proj.parent].name == "render"
    assert dict(proj.counts)["n_visible"] == int(valid.sum()) > 1000
    ctx = SimpleNamespace(trace=SimpleNamespace(device=[("k", 0.0, 1.0)]), cfg=cfg)
    assert harness.load_metric("visible_share.2dgs").read(ctx) == pytest.approx(
        100 * int(valid.sum()) / cfg["n_gaussians"])


def test_counts_and_readers():
    """``mfu.2dgs`` counts the surfel model's operations; the two
    rooflines bound by the surfel's own work per pair and per surfel."""
    ctx = SimpleNamespace(model=M, unit_s=0.05)
    ctx.work = lambda: {"n_alive": 5000, "pixels": 600,
                        "rows": [{"visible": 1000, "pairs": 9000},
                                 {"visible": 3000, "pairs": 7000}]}
    assert (M.OPS_PER_GAUSSIAN, M.BYTES_PER_GAUSSIAN, M.OPS_PER_PAIR, M.FIELDS) == (
        348, 232, 53, 16)
    ops = 5000 * 348 + 8000 * 53 + 600 * 8
    assert harness.load_metric("mfu.2dgs").read(ctx) == pytest.approx(
        100 * ops / (0.05 * 67e12))
    us = {"surfel_fwd_kernel": 2.0, "surfel_project_kernel": 4.0}
    ctx.trace = SimpleNamespace(device=[(f"void (anonymous namespace)::{k}(int)", 0.0, v)
                                        for k, v in us.items()], host=[], window=(0.0, 9.0))
    fwd = sum(max(p * 53 / 67e12, 4 * (v * 16 + 600 * 5) / 3.35e12)
              for v, p in ((1000, 9000), (3000, 7000)))
    assert harness.load_metric("surfel_fwd_roofline.2dgs").read(ctx) == pytest.approx(
        100 * fwd / 2e-6)
    proj = sum(max(5000 * 348 / 67e12, (5000 * 232 + 4 * v * 16) / 3.35e12)
               for v in (1000, 3000))
    assert harness.load_metric("surfel_project_roofline.2dgs").read(ctx) == pytest.approx(
        100 * proj / 4e-6)


def test_server_serves_a_2dgs_checkpoint(model, tmp_path):
    cfg, weights, alive = model
    ckpts = tmp_path / "results" / "ckpts"
    ckpts.mkdir(parents=True)
    np.savez(ckpts / "ckpt_7.npz", alive=alive.numpy(),
             **{f"params['{k}']": v.numpy() for k, v in weights.items()})
    server = viewer.workdir_server(str(tmp_path), port=0, device="cpu", primitive="2dgs")
    pose = S.orbit_pose(cfg["cameras"], 1.0)
    K = np.float32([[320, 0, 320], [0, 320, 240], [0, 0, 1]])
    frame = server.render_fn(pose, K, "spherical")  # the page's toggle: pinhole all the same
    want = viewer.Renderer(weights, alive, 640, 480, device="cpu", primitive="2dgs")(pose, K)
    assert frame.shape == (480, 640, 3) and frame.dtype == np.uint8
    assert np.array_equal(frame, want) and frame.std() > 1


def test_harness_finds_the_cell():
    spec = harness.load_spec()
    cell, cfg, mix, limits = harness.cell_files(spec, "garden_2dgs.view")
    assert cell["chips"] == 1 and harness.model_name(cfg) == "surfels"
    assert mix["kind"] == "view_2dgs"
    assert {k: v for k, v in mix.items() if k not in ("kind", "why")} == {
        k: v for k, v in B.mix("view").items() if k not in ("kind", "why")}
    assert set(limits) == {"frame_mae", "rgb_mae", "depth_rel"}
    kind = harness.load_kind(mix["kind"])
    assert kind._view.R is RS and callable(kind.run) and callable(kind.control_readings)
    assert harness.load_kind("view").R is R  # the 3DGS kind keeps its reference
    assert [m["name"] for m in harness.end_to_end_for(spec, "garden_2dgs.view")] == [
        "view_p95_ms", "peak_mem_gib", "setup_s"]
    layer = [m["name"] for m in harness.per_layer_for(spec, "garden_2dgs.view")]
    assert sorted(layer) == sorted(
        f"{m}.2dgs" for m in ("launches", "idle_share", "entry_ms", "entry_idle_ms",
                              "projection_ms", "projection_idle_ms", "build_ms",
                              "build_idle_ms", "kernels_ms", "kernels_idle_ms",
                              "outside_idle_ms", "sort_use", "mfu", "surfel_fwd_roofline",
                              "surfel_project_roofline", "visible_share"))
    for name in layer:
        assert callable(harness.load_metric(name).read)
    conf = next(c for c in spec["configs"] if c["name"] == "garden_2dgs")
    assert conf["reduced"] == [] and cfg["reduced"] == []
    assert "2403.17888" in cfg["source"] and "rasterization_2dgs" in cfg["source"]
    assert "simple_trainer_2dgs.py" in cfg["source"] and "garden" in cfg["source"]
    assert "ED depth" in cfg["departures"] and "scales" in cfg["assumed"]
    garden = B.tiny_config("garden")
    assert {k: garden[k] for k in ("scene", "cameras", "dead_rows", "sh_degree")} == {
        k: B.tiny_config("garden_2dgs")[k] for k in ("scene", "cameras", "dead_rows",
                                                      "sh_degree")}


def test_reference_imports_neither_jax_nor_the_port():
    code = (
        "import sys, torch\n"
        "from benchmark import harness as H\n"
        "from benchmark.reference import surfel as RS\n"
        "from benchmark.tests import bench_tiny as B\n"
        "from benchmark import scene as S\n"
        "cfg = B.tiny_config('garden_2dgs', n=500, cap=1024, w=48, h=32)\n"
        "m = H.load_model(cfg)\n"
        "w, alive = m.make_weights(cfg, 3, torch.device('cpu'))\n"
        "r = RS.render(m.reference_rows(w, alive), S.orbit_pose(cfg['cameras'], 1.0),\n"
        "              S.intrinsics(cfg), 48, 32, RS.camera('pinhole'), m.color)\n"
        "assert r.visible > 0 and r.needed > 0\n"
        "bad = sorted({k.split('.')[0] for k in sys.modules}\n"
        "             & {'jax', 'jaxlib', 'flax', 'splat_one_tpu', 'splat_one_tpu_torch'})\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        assert "garden_2dgs.view" in json.load(f)["end_to_end"][0]["workloads"]


# ------------------------------------------------------------------ the card


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cuda_scene(mode):
    """A hard scene's activated rows on the card, every 7th with opacity 0
    (as a dead row is served), and its camera."""
    weights, alive, pose, K = _hard_scene(mode, n=3000, seed=5)
    act = G.reference_rows(weights, alive)
    act["opacities"][::7] = 0.0
    d = {k: act[k].cuda() for k in ("means", "quats", "scales", "opacities", "sh")}
    vm = torch.as_tensor(np.linalg.inv(pose), device="cuda")[None]
    return d, vm, torch.as_tensor(K, device="cuda")[None]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["random", "edge", "near"])
def test_cuda_kernels_match_plain(mode):
    """The projection kernel's fields equal the plain version's bit for
    bit but the colours (within PROJ_COLOR_ATOL); on that projection's
    layout the pack kernel's table and the forward kernel's output equal
    their plain versions' bit for bit; one launch each."""
    _gpu()
    d, vm, K = _cuda_scene(mode)
    args = (d["means"], d["quats"], d["scales"], d["opacities"], vm, K, 160, 120, d["sh"], 3)
    with torch.no_grad():
        n0 = dict(cuda_build.launch_counts)
        got = SF.project_surfels(*args)
        want = SF.project_surfels_plain(*args)
        for f in ("means2d", "transforms", "depths", "boxes", "valid"):
            a, b = getattr(got, f), getattr(want, f)
            assert torch.equal(a, b), (f, float((a.float() - b.float()).abs().max()))
        assert float((got.colors - want.colors).abs().max()) <= PROJ_COLOR_ATOL
        assert int(got.valid.sum()) > 500
        _, _, sw, sh = si.supertile_grid(160, 120, 16)
        caps = si.StreamCaps.choose(3000, 1, sw * sh)
        isect = si.build_stream_intersections(got, 160, 120, 16, caps)
        packed = SF.pack_surfel_fields(got, isect, caps)
        plain = si.pack_stream(SF.surfel_field_columns(
            got.means2d, got.transforms, got.opacities, got.colors, got.depths), isect, caps)
        assert torch.equal(packed.view(torch.int32), plain.view(torch.int32))
        cfg = sr.StreamCfg.from_caps(caps, 160, 120, 16, 1, 3000)
        out = SF.surfel_fwd(cfg, isect.st_starts, packed)
        ref = SF.surfel_fwd_plain(cfg, isect.st_starts, packed)
        assert torch.equal(out, ref), float((out - ref).abs().max())
        assert float(out[:, :, 3].max()) > 0.5
    for name in ("surfel_project", "surfel_pack", "surfel_fwd"):
        assert cuda_build.launch_counts[name] == n0.get(name, 0) + 1


@pytest.mark.gpu
def test_cuda_renderer_matches_the_reference_and_refuses_autograd(model):
    """On the card one 2DGS request launches each surfel kernel once and
    matches the reference (run on the card) within the CPU tolerances;
    under autograd ``rasterization_2dgs`` raises."""
    _gpu()
    cfg, weights, alive = model
    pose, K = S.orbit_pose(cfg["cameras"], 2.0), S.intrinsics(cfg)
    rd = viewer.Renderer(weights, alive, W, H, device="cuda", primitive="2dgs")
    n0 = dict(cuda_build.launch_counts)
    rgb, ed, alpha, _ = rd.render(pose, K)
    for name in ("surfel_project", "surfel_pack", "surfel_fwd"):
        assert cuda_build.launch_counts[name] == n0.get(name, 0) + 1
    act = {k: v.cuda() for k, v in M.reference_rows(weights, alive).items()}
    ref = RS.render(act, pose, K, W, H, RS.camera("pinhole"), M.color)
    _compare(rgb, ed, alpha, ref)
    means = rd.means.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="autograd"):
        rasterization_2dgs(means, rd.quats, rd.scales, rd.opacities, rd.colors,
                           torch.eye(4, device="cuda")[None],
                           torch.as_tensor(K, device="cuda")[None], W, H, sh_degree=3)
