"""The port's ``Renderer`` serving gsplat's appearance model, on the CPU.

A model trained with the appearance head (``features`` / ``colors`` and
the head's parameters) is served as ``sigmoid(colors + head(embedding,
features, SH basis of the view direction))``:

- at the benchmark's ``garden_app`` layout cut to 3,000 gaussians in 4,096
  rows and 96 x 64 pixels, with the published widths (features 32,
  embedding 16, three linear layers of 64, SH 3), the port's render
  matches the plain reference (``benchmark.reference.render`` with
  ``models/gaussians_app.color``), and the same render without the head
  (``sigmoid(colors)``) misses it by over 10x the tolerances;
- a features / colours model without the head's parameters is refused;
- a ``Trainer(app_opt=True)`` checkpoint, loaded by
  ``load_checkpoint_params`` and ``load_checkpoint_app_params`` and served
  by ``make_render_fn``, gives ``Trainer.render_view``'s frame, for the
  Trainer's own head (two linear layers) and for gsplat's (three);
- under a profiler a request records ``viewer.appearance`` inside
  ``viewer.request``, before ``render``, and
  ``benchmark.appearance_spans`` charges that span's device time and idle
  to ``appearance`` and sums to ``benchmark.spans.attribute``'s totals;
- the harness finds ``garden_app.view``'s files and readers, and the
  model's reference imports nothing of JAX or the port.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import appearance_spans as A
from benchmark import harness
from benchmark import scene as S
from benchmark import spans as SP
from benchmark import trace as T
from benchmark.models import gaussians_app as M
from benchmark.reference import render as R
from benchmark.tests import bench_tiny as B
from splat_one_tpu_torch.app import viewer
from splat_one_tpu_torch.data.synthetic import make_synthetic_scene
from splat_one_tpu_torch.train.config import Config
from splat_one_tpu_torch.train.trainer import SceneData, Trainer
from splat_one_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 96, 64
SEED = 2**31 + 19
# Port against reference, both float32 on the CPU. The colour differs by
# a few ulps (the direction normalised another way, the head's sums in
# another order); the compositing's tile stop at transmittance 1e-5 and
# alpha's last ulps through ~100 layers move a pixel by up to ~1e-5.
RGB_MAX = 5e-5
RGB_MEAN = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = B.tiny_config("garden_app", n=3000, cap=4096, w=W, h=H)
    weights, alive = M.make_weights(cfg, SEED, torch.device("cpu"))
    return cfg, weights, alive


def _errors(rgb, ref):
    d = (rgb - ref.rgb).abs()
    return float(d.max()), float(d.mean())


@pytest.mark.parametrize("angle", [0.3, 2.0, 4.5])
def test_renderer_serves_the_head(model, angle):
    cfg, weights, alive = model
    pose, K = S.orbit_pose(cfg["cameras"], angle), S.intrinsics(cfg)
    ref = R.render(M.reference_rows(weights, alive), pose, K, W, H, R.camera("pinhole"),
                   M.color)
    assert ref.visible > 1000 and float(ref.alpha.min()) > 0.99
    rd = viewer.Renderer(weights["rows"], alive, W, H, device="cpu",
                         app_params=weights["app"])
    rgb, ed, alpha, _ = rd.render(pose, K)
    err_max, err_mean = _errors(rgb, ref)
    assert err_max <= RGB_MAX and err_mean <= RGB_MEAN
    assert float((alpha - ref.alpha).abs().max()) <= 1e-4
    # the head left out: today's sigmoid(colors) misses by far
    rows = {k: v for k, v in weights["rows"].items() if k != "features"}
    rgb0 = viewer.Renderer(rows, alive, W, H, device="cpu").render(pose, K)[0]
    err0_max, err0_mean = _errors(rgb0, ref)
    assert err0_max >= 10 * RGB_MAX and err0_mean >= 10 * RGB_MEAN
    assert err0_mean >= 1e-2


def test_features_without_head_are_refused(model):
    _, weights, alive = model
    with pytest.raises(ValueError, match="appearance head"):
        viewer.Renderer(weights["rows"], alive, W, H, device="cpu")


@pytest.fixture(scope="module")
def scene():
    s, _ = make_synthetic_scene(n_gaussians=400, n_cameras=6, width=64, height=64,
                                n_points=200, device="cpu")
    return s


@pytest.mark.parametrize("head", ["trainer", "gsplat"])
def test_app_checkpoint_serves_render_view(scene, tmp_path, head):
    cfg = Config(result_dir=str(tmp_path), app_opt=True, sh_degree=3, capacity=512,
                 camera_model="pinhole", test_every=6, max_steps=1, eval_steps=[],
                 save_steps=[])
    tr = Trainer(cfg, SceneData(*scene), device="cpu")
    app = dict(tr.state.app_params)
    g = torch.Generator().manual_seed(5)
    app["embeds"] = torch.randn(app["embeds"].shape, generator=g)
    if head == "gsplat":
        assert sorted(app) == ["b0", "b1", "embeds", "w0", "w1"]
        for i, (di, do) in enumerate([(64, 64), (64, 64), (64, 3)]):
            app[f"w{i}"] = torch.randn((di, do), generator=g) * (2.0 / di) ** 0.5
            app[f"b{i}"] = torch.randn(do, generator=g) * 0.1
    tr.state = tr.state._replace(app_params=app)
    ckpt = tr.save_checkpoint(0)
    params, alive = viewer.load_checkpoint_params(ckpt, device="cpu")
    app_params = viewer.load_checkpoint_app_params(ckpt, device="cpu")
    assert sorted(app_params) == sorted(app) and {"features", "colors"} <= set(params)
    with pytest.raises(ValueError, match="appearance head"):
        viewer.make_render_fn(params, alive, 64, 64, device="cpu")
    fn = viewer.make_render_fn(params, alive, 64, 64, device="cpu", app_params=app_params)
    for i in (1, 4):
        rgb_v = fn.render(scene.camtoworlds[i], scene.Ks[i])[0]
        rgb_t, _ = tr.render_view(scene.camtoworlds[i], scene.Ks[i])
        assert float(rgb_t.std()) > 0.01
        np.testing.assert_allclose(np.clip(rgb_v.numpy(), 0, 1), rgb_t, atol=1e-6)
    # the embedding matters: image 3's in place of image 0's changes the colours
    other = viewer.make_render_fn(params, alive, 64, 64, device="cpu",
                                  app_params=dict(app_params, embeds=app_params["embeds"][[3]]))
    rgb_o = other.render(scene.camtoworlds[1], scene.Ks[1])[0]
    assert float((rgb_o - fn.render(scene.camtoworlds[1], scene.Ks[1])[0]).abs().max()) > 1e-3
    plain = Config(result_dir=str(tmp_path / "plain"), sh_degree=1, capacity=512,
                   camera_model="pinhole", max_steps=1, eval_steps=[], save_steps=[])
    assert viewer.load_checkpoint_app_params(
        Trainer(plain, SceneData(*scene), device="cpu").save_checkpoint(0)) is None


def test_request_records_the_appearance_span(model):
    cfg, weights, alive = model
    rd = viewer.Renderer(weights["rows"], alive, W, H, device="cpu",
                         app_params=weights["app"])
    pose, K = S.orbit_pose(cfg["cameras"], 1.0), S.intrinsics(cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        rd(pose, K)
    recs = profiling.spans()
    by_id = {r.id: r for r in recs}
    (app,) = [r for r in recs if r.name == "viewer.appearance"]
    assert by_id[app.parent].name == "viewer.request"
    assert not app.counts
    render = next(r for r in recs if r.name == "render")
    assert app.end_ns <= render.start_ns


US = 1000  # ns


def _rec(name, i, parent, start, end, counts=()):
    return profiling.SpanRecord(name, i, parent, 1, start * US, end * US, counts)


# one request, us on the trace's axis: the head's span between the inputs
# and the render, with two launches and an idle gap inside
SPANS = [_rec("viewer.request", 1, 0, 10, 90), _rec("viewer.inputs", 2, 1, 11, 14),
         _rec("viewer.appearance", 3, 1, 14, 30),
         _rec("render", 4, 1, 30, 82), _rec("render.project", 5, 4, 32, 40),
         _rec("render.build", 6, 4, 40, 60), _rec("render.composite", 7, 4, 60, 80)]
CALLS = [("cudaMemcpyAsync", 12), ("cudaLaunchKernel", 15), ("cudaLaunchKernel", 22),
         ("cudaLaunchKernel", 33), ("cudaLaunchKernel", 45), ("cudaLaunchKernel", 65),
         ("cudaLaunchKernel", 95)]
OPS = [("Memcpy HtoD (Pageable -> Device)", 13, 14), ("mm", 16, 20), ("sigmoid", 23, 29),
       ("project_fwd_kernel", 34, 38), ("sort", 46, 55), ("stream_fwd_kernel", 66, 76),
       ("fill", 96, 98)]


def test_appearance_attribution(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    monkeypatch.setattr(profiling, "anchors", lambda: [5500])
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    host = [(profiling.ANCHOR, 5.0, 6.0)] + [(n, float(t), t + 0.5) for n, t in CALLS]
    tr = T.Trace(device=[(n, float(s), float(e)) for n, s, e in OPS],
                 host=sorted(host, key=lambda h: h[1]), window=(0.0, 100.0))
    ctx = type("Ctx", (), dict(trace=tr, units=2))()
    got, base = A.attribute(tr), SP.attribute(tr)
    assert got["device"] == pytest.approx({"entry": 1.0, "appearance": 10.0,
                                           "projection": 4.0, "build": 9.0, "kernels": 10.0,
                                           "outside": 2.0})
    # spans.py charges the head's span to outside; the totals are the same
    assert base["device"]["outside"] == pytest.approx(12.0)
    assert sum(got["device"].values()) == pytest.approx(sum(base["device"].values()))
    assert sum(got["device"].values()) == pytest.approx(T.busy_us(tr))
    assert sum(got["idle"].values()) == pytest.approx(sum(base["idle"].values()))
    # the gaps 14-16 and 20-23 and the first us of 29-34
    assert got["idle"]["appearance"] == pytest.approx(2.0 + 3.0 + 1.0)
    assert A.device_ms(ctx, "appearance") == pytest.approx(5e-3)
    assert A.idle_ms(ctx, "appearance") == pytest.approx(3e-3)
    for name, want in (("appearance_ms.app", 5e-3), ("appearance_idle_ms.app", 3e-3),
                       ("outside_idle_ms.app", A.idle_ms(ctx, "outside"))):
        assert harness.load_metric(name).read(ctx) == pytest.approx(want)
    # the roofline: the rows the frames show over the span's device time
    ctx.model = M
    ctx.work = lambda: {"rows": [{"visible": 1000, "pairs": 0}] * 2}
    bound = 2 * 1000 * M.APP_OPS_PER_ROW / 67e12
    assert harness.load_metric("appearance_roofline.app").read(ctx) == pytest.approx(
        100 * bound / 10e-6)


def test_mfu_counts_the_head_on_screen():
    # the projection for every live gaussian, the head for the rows on screen
    ctx = type("Ctx", (), dict(model=M, unit_s=0.05))()
    ctx.work = lambda: {"n_alive": 5000, "pixels": 600,
                        "rows": [{"visible": 1000, "pairs": 9000},
                                 {"visible": 3000, "pairs": 7000}]}
    ops = (5000 * 248 + 8000 * 26 + 600 * 8) + 2000 * 16960
    assert harness.load_metric("mfu.app").read(ctx) == pytest.approx(
        100 * ops / (0.05 * 67e12))
    ctx.unit_s = None
    assert harness.load_metric("mfu.app").read(ctx) is None


def test_harness_finds_the_cell():
    spec = harness.load_spec()
    cell, cfg, mix, limits = harness.cell_files(spec, "garden_app.view")
    assert cell["chips"] == 1 and harness.model_name(cfg) == "gaussians_app"
    assert set(limits) == {"frame_mae", "rgb_mae", "depth_rel"}
    model = harness.load_model(cfg)
    assert (model.OPS_PER_GAUSSIAN, model.APP_OPS_PER_ROW) == (248, 16960)
    assert (model.BYTES_PER_GAUSSIAN, model.APP_BYTES_PER_ROW) == (56, 164)
    assert [m["name"] for m in harness.end_to_end_for(spec, "garden_app.view")] == [
        "view_p95_ms", "peak_mem_gib", "setup_s"]
    layer = [m["name"] for m in harness.per_layer_for(spec, "garden_app.view")]
    assert sorted(layer) == sorted(
        f"{m}.app" for m in ("appearance_ms", "appearance_idle_ms", "appearance_roofline",
                             "mfu", "idle_share", "launches", "projection_ms", "build_ms",
                             "kernels_ms", "entry_ms", "entry_idle_ms", "projection_idle_ms",
                             "build_idle_ms", "kernels_idle_ms", "outside_idle_ms", "sort_use",
                             "stream_fwd_roofline", "project_fwd_roofline"))
    for name in layer:
        assert callable(harness.load_metric(name).read)
    conf = next(c for c in spec["configs"] if c["name"] == "garden_app")
    assert conf["reduced"] == [] and cfg["reduced"] == []


def test_reference_imports_neither_jax_nor_the_port():
    code = (
        "import sys, torch\n"
        "from benchmark import harness as H\n"
        "from benchmark.reference import render as R\n"
        "from benchmark.tests import bench_tiny as B\n"
        "from benchmark import scene as S\n"
        "cfg = B.tiny_config('garden_app', n=500, cap=1024, w=48, h=32)\n"
        "m = H.load_model(cfg)\n"
        "w, alive = m.make_weights(cfg, 3, torch.device('cpu'))\n"
        "r = R.render(m.reference_rows(w, alive), S.orbit_pose(cfg['cameras'], 1.0),\n"
        "             S.intrinsics(cfg), 48, 32, R.camera('pinhole'), m.color)\n"
        "assert r.visible > 0\n"
        "bad = sorted({k.split('.')[0] for k in sys.modules}\n"
        "             & {'jax', 'jaxlib', 'flax', 'splat_one_tpu', 'splat_one_tpu_torch'})\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        assert "garden_app.view" in json.load(f)["end_to_end"][0]["workloads"]
