"""The port's ``utils/profiling.py`` and ``utils/logger.py``, on the CPU.

- ``trace`` writes a TensorBoard-loadable trace file into its directory
  that names the ops run inside it, and the spans recorded inside it as
  events of their own row, around the ops they enclose.
- The span recorder: without a profiler ``span`` is the shared no-op and
  Renderer requests record nothing; under ``torch.profiler`` two Renderer
  requests give two trees of the render path's spans, each child inside
  its parent, one request id a tree; ``n_isect`` read at collection is
  ``info["n_isect"]``; a span and a ``record_function`` nested either way
  land nested on the profiler's axis within 5 us; a new session empties
  the records; records past the cap are counted, not kept; spans of
  threads opened at once keep each thread's tree (the parent stack is a
  thread's own) and lose no record.
- ``memory_stats()`` is ``{}`` without CUDA (as JAX's skips devices
  without stats); ``Trainer.eval`` reports the largest ``*_peak_gib`` as
  ``mem`` (JAX ``train/trainer.py:983-992``), and no ``mem`` without one.
- ``setup_logger`` against JAX's: the same handler types and format, the
  same ``<workdir>/logs/app.log``, one logger per workdir.
"""

import glob
import json
import logging
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from splat_one_tpu.utils import logger as jlogger
from splat_one_tpu_torch.utils import logger as tlogger
from splat_one_tpu_torch.utils import profiling


def test_trace_writes_a_trace(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    torch.mm(a, a)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    mms = sorted(e["ts"] for e in events if e.get("name") == "aten::mm")
    assert len(mms) == 3
    rows = [e for e in events if e.get("cat") == "span"]
    assert sorted(e["name"] for e in rows) == ["inner"] * 3 + ["outer"] * 3
    assert {e["tid"] for e in rows} == {profiling.SPAN_ROW}
    assert any(e.get("ph") == "M" and e.get("args") == {"name": profiling.SPAN_ROW}
               for e in events)
    inner = sorted((e for e in rows if e["name"] == "inner"), key=lambda e: e["ts"])
    for e, ts in zip(inner, mms):
        assert e["ts"] - 5 <= ts <= e["ts"] + e["dur"] + 5
        assert e["args"]["parent"] and e["args"]["request"] != e["args"]["id"]


W, H = 64, 48
# each span of a Renderer request and its parent
TREE = {"viewer.request": None, "viewer.inputs": "viewer.request",
        "render": "viewer.request", "render.project": "render",
        "render.build": "render", "render.composite": "render",
        "build.pack": "render.composite", "render.assemble": "render",
        "viewer.frame": "viewer.request"}


@pytest.fixture(scope="module")
def renderer():
    from splat_one_tpu_torch.app.viewer import Renderer

    g = torch.Generator().manual_seed(0)
    n = 300
    params = {"means": torch.rand(n, 3, generator=g) * 2 - 1 + torch.tensor([0.0, 0.0, 4.0]),
              "quats": torch.randn(n, 4, generator=g), "scales": torch.full((n, 3), -3.0),
              "opacities": torch.randn(n, generator=g),
              "sh0": torch.randn(n, 1, 3, generator=g) * 0.5,
              "shN": torch.randn(n, 15, 3, generator=g) * 0.1}
    rd = Renderer(params, torch.ones(n, dtype=torch.bool), W, H, sh_degree=3, device="cpu")
    K = np.float32([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]])
    return rd, np.eye(4, dtype=np.float32), K


def _anchor_offset(prof):
    marks = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name == profiling.ANCHOR)
    return profiling.clock_offset_us(profiling.anchors(), marks)


def test_spans_off_record_nothing(renderer):
    rd, c2w, K = renderer
    profiling.clear()
    assert profiling.span("render") is profiling.span("viewer.request")
    assert profiling.span("render") is profiling._NO_SPAN
    assert profiling.count("rows", 3) is None
    for _ in range(2):
        rd(c2w, K)
    assert profiling.spans() == [] and profiling.anchors() == []


def test_two_requests_two_trees(renderer):
    rd, c2w, K = renderer
    with profile(activities=[ProfilerActivity.CPU]):
        frames = [rd(c2w, K) for _ in range(2)]
    assert all(f.shape == (H, W, 3) for f in frames)
    recs = profiling.spans()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent == 0]
    assert [r.name for r in roots] == ["viewer.request"] * 2
    assert len(profiling.anchors()) == 2 and profiling.dropped() == 0
    for root in roots:
        tree = [r for r in recs if r.request == root.id]
        assert sorted(r.name for r in tree) == sorted(TREE)
        for r in tree:
            if r is root:
                continue
            parent = by_id[r.parent]
            assert parent.name == TREE[r.name]
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    assert roots[0].end_ns <= roots[1].start_ns
    assert {r.request for r in recs} == {roots[0].id, roots[1].id}


def test_build_counts_read_at_collection(renderer):
    from splat_one_tpu_torch.ops.stream_isect import StreamCaps, supertile_grid

    rd, c2w, K = renderer
    with profile(activities=[ProfilerActivity.CPU]):
        info = rd.render(c2w, K)[3]
    counts = {r.name: dict(r.counts) for r in profiling.spans() if r.counts}
    _, _, sw, sh = supertile_grid(W, H, 16)
    assert counts == {
        "render.build": {"n_isect": int(info["n_isect"]),
                         "exp_cap": StreamCaps.choose(300, 1, sw * sh).exp_cap}}
    assert 0 < counts["render.build"]["n_isect"] <= counts["render.build"]["exp_cap"]
    assert all(type(v) is int for c in counts.values() for v in c.values())


def test_span_lands_on_the_profilers_axis():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with profiling.span("root"):
                with record_function("test.outer"):
                    with profiling.span("inner"):
                        pass
                with profiling.span("outer"):
                    with record_function("test.inner"):
                        pass
    off = _anchor_offset(prof)
    ev = {name: sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.name == name) for name in ("test.outer", "test.inner")}
    rec = {name: sorted((profiling.trace_us(r.start_ns, off), profiling.trace_us(r.end_ns, off))
                        for r in profiling.spans() if r.name == name)
           for name in ("inner", "outer")}
    assert len(ev["test.outer"]) == len(rec["inner"]) == 5
    for (o0, o1), (i0, i1) in zip(ev["test.outer"], rec["inner"]):
        assert o0 - 5 <= i0 <= i1 <= o1 + 5
    for (o0, o1), (i0, i1) in zip(rec["outer"], ev["test.inner"]):
        assert o0 - 5 <= i0 <= i1 <= o1 + 5


def test_a_new_session_empties_the_records(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            pass
    assert [r.name for r in profiling.spans()] == ["a"]
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert profiling.spans() == [] and profiling.anchors() == []
    monkeypatch.setattr(profiling._REC, "cap", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.span("b"):
                pass
    assert len(profiling.spans()) == 2 and len(profiling.anchors()) == 2
    assert profiling.dropped() == 2  # a record and an anchor
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_threads_keep_their_own_trees():
    n_threads, n_requests = 16, 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client():
            for _ in range(n_requests):
                with profiling.span("viewer.request"):
                    with profiling.span("render"):
                        with profiling.span("render.build"):
                            profiling.count("n_isect", 1)

        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=client) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = profiling.spans()
    assert len(recs) == 3 * n_threads * n_requests and profiling.dropped() == 0
    assert len({r.id for r in recs}) == len(recs)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name == "viewer.request":
            assert r.parent == 0 and r.request == r.id
        else:
            parent = by_id[r.parent]
            assert parent.name == {"render": "viewer.request", "render.build": "render"}[r.name]
            assert parent.request == r.request
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    assert all(r.counts == (("n_isect", 1),) for r in recs if r.name == "render.build")


def test_memory_stats_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only answer")
    assert profiling.memory_stats() == {}


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    from splat_one_tpu_torch.data.synthetic import make_synthetic_scene
    from splat_one_tpu_torch.train.config import Config
    from splat_one_tpu_torch.train.trainer import Trainer

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    scene, _ = make_synthetic_scene(n_gaussians=64, n_cameras=3, width=32, height=32,
                                    device="cpu")
    cfg = Config(max_steps=1, eval_steps=[], save_steps=[], capacity=128, sh_degree=1,
                 camera_model="pinhole", result_dir=str(tmp_path_factory.mktemp("r")))
    yield Trainer(cfg, scene, device="cpu")
    torch.set_num_threads(n)


@pytest.mark.parametrize("stats,mem", [
    ({}, None),
    ({"dev0_gib": 0.5, "dev0_peak_gib": 1.25, "dev1_gib": 0.1, "dev1_peak_gib": 2.5}, 2.5),
])
def test_eval_reports_peak_memory(trainer, monkeypatch, stats, mem):
    from splat_one_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setattr(trainer_mod, "memory_stats", lambda: dict(stats))
    out = trainer.eval(0)
    assert out.get("mem") == mem
    assert "psnr" in out


def _handlers(logger):
    return [(type(h), h.formatter._fmt, getattr(h, "baseFilename", None))
            for h in logger.handlers]


def test_setup_logger_matches_jax(tmp_path):
    wd_j, wd_t = tmp_path / "j", tmp_path / "t"
    lj = jlogger.setup_logger(str(wd_j))
    lt = tlogger.setup_logger(str(wd_t))
    try:
        assert lt.level == lj.level == logging.INFO
        hj, ht = _handlers(lj), _handlers(lt)
        assert [h[:2] for h in ht] == [h[:2] for h in hj]
        assert [h[2] for h in ht] == [None if h[2] is None else str(wd_t / "logs" / "app.log")
                                      for h in hj]
        assert tlogger.setup_logger(str(wd_t)) is lt  # one logger a workdir
        other = tlogger.setup_logger(str(tmp_path / "o"))
        assert other is not lt and other.handlers[0].baseFilename.startswith(
            str(tmp_path / "o"))
        lt.info("hello")
        for h in lt.handlers:
            h.flush()
        line = (wd_t / "logs" / "app.log").read_text().strip()
        assert line.endswith(f"| INFO | {lt.name} | hello")
    finally:
        for lg in (lj, lt, tlogger.setup_logger(str(tmp_path / "o"))):
            for h in list(lg.handlers):
                h.close()
                lg.removeHandler(h)
        assert os.path.exists(wd_j / "logs" / "app.log")
