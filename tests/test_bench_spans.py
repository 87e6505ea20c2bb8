"""The benchmark's span reader (``benchmark/spans.py``) on a hand-built
trace, on the CPU.

One request's spans, its host enqueue calls, its device operations and
the idle gaps between them are laid out by hand on a 100 us window, the
spans' clock tied to the trace's by one anchor, so the device time and
the idle of each layer are known exactly:

- each operation is charged to the innermost span open when it was
  enqueued (``build.pack``'s launch to the build, though it runs inside
  ``render.composite``); device time enqueued with no span open is
  ``outside``;
- idle is split at the spans' edges, and the five idle parts sum to the
  window's idle;
- an operation more than the enqueue calls, or a copy call against a
  kernel, gives no device time (the idle still reads);
- no recorder, no anchor, or a dropped record gives nothing;
- ``sort_use`` is the mean of ``n_isect / exp_cap`` over the builds.
"""

from types import SimpleNamespace

import pytest

from benchmark import spans as S
from benchmark import trace as T
from splat_one_tpu_torch.utils import profiling

US = 1000  # ns


def _rec(name, i, parent, start, end, counts=()):
    return profiling.SpanRecord(name, i, parent, 1, start * US, end * US, counts)


SPANS = [  # one request, us on the trace's axis
    _rec("viewer.request", 1, 0, 10, 90),
    _rec("render", 2, 1, 12, 82),
    _rec("render.project", 3, 2, 20, 40),
    _rec("render.build", 4, 2, 40, 60, (("exp_cap", 1000), ("n_isect", 250))),
    _rec("render.composite", 5, 2, 60, 80),
    _rec("build.pack", 6, 5, 62, 70),
]
CALLS = [("cudaLaunchKernel", 15), ("cudaLaunchKernel", 25), ("cudaMemsetAsync", 45),
         ("cudaLaunchKernel", 65), ("cudaLaunchKernel", 75), ("cudaMemcpyAsync", 85),
         ("cudaLaunchKernel", 95)]
OPS = [("gather", 16, 22), ("gemv", 26, 36), ("Memset (Device)", 46, 47), ("cat", 66, 70),
       ("stream_fwd_kernel", 76, 84), ("Memcpy DtoH (Device -> Pageable)", 86, 88),
       ("fill", 96, 98)]
DEVICE = {"entry": 8.0, "projection": 10.0, "build": 5.0, "kernels": 8.0, "outside": 2.0}
IDLE = {"entry": 10.0, "projection": 8.0, "build": 23.0, "kernels": 8.0, "outside": 18.0}


def _trace(calls=CALLS, ops=OPS):
    host = [(profiling.ANCHOR, 5.0, 6.0), ("aten::copy_", 84.0, 89.0)]
    host += [(n, float(t), t + 0.5) for n, t in calls]
    return T.Trace(device=[(n, float(s), float(e)) for n, s, e in ops],
                   host=sorted(host, key=lambda h: h[1]), window=(0.0, 100.0))


@pytest.fixture
def recorded(monkeypatch):
    """The recorder holds SPANS and one anchor stamped at its event's middle."""
    state = {"spans": list(SPANS), "anchors": [5500], "dropped": 0}
    monkeypatch.setattr(profiling, "spans", lambda: state["spans"])
    monkeypatch.setattr(profiling, "anchors", lambda: state["anchors"])
    monkeypatch.setattr(profiling, "dropped", lambda: state["dropped"])
    return state


def _ctx(tr, units=2):
    return SimpleNamespace(trace=tr, units=units)


def test_device_and_idle_by_layer(recorded):
    ctx = _ctx(_trace())
    for layer in ("entry", "projection", "build", "kernels"):
        assert S.device_ms(ctx, layer) == pytest.approx(DEVICE[layer] * 1e-3 / 2, abs=1e-12)
    for layer in ("entry", "projection", "build", "kernels", "outside"):
        assert S.idle_ms(ctx, layer) == pytest.approx(IDLE[layer] * 1e-3 / 2, abs=1e-12)
    got = S.attribute(ctx.trace)
    assert got["device"] == pytest.approx(DEVICE)
    assert sum(got["idle"].values()) == pytest.approx(T.window_us(ctx.trace)
                                                      - T.busy_us(ctx.trace))
    assert sum(DEVICE.values()) == pytest.approx(T.busy_us(ctx.trace))
    assert S.sort_use(ctx) == pytest.approx(25.0)


def test_unpaired_enqueues_give_no_device_time(recorded):
    extra = _ctx(_trace(ops=OPS + [("late", 99.0, 99.5)]))
    assert S.device_ms(extra, "entry") is None
    assert S.idle_ms(extra, "outside") is not None
    wrong_kind = list(CALLS)
    wrong_kind[2] = ("cudaLaunchKernel", 45)
    assert S.device_ms(_ctx(_trace(calls=wrong_kind)), "build") is None


@pytest.mark.parametrize("fault", ["no spans", "dropped", "no anchor", "no recorder"])
def test_nothing_to_read(recorded, monkeypatch, fault):
    if fault == "no spans":
        recorded["spans"] = []
    elif fault == "dropped":
        recorded["dropped"] = 1
    elif fault == "no anchor":
        recorded["anchors"] = []
    else:
        monkeypatch.delattr(profiling, "spans")
    ctx = _ctx(_trace())
    assert S.device_ms(ctx, "build") is None
    assert S.idle_ms(ctx, "build") is None
    assert S.sort_use(ctx) is None


def test_sort_use_is_the_mean_over_builds(recorded):
    recorded["spans"] = SPANS + [_rec("render.build", 7, 2, 91, 92,
                                      (("exp_cap", 1000), ("n_isect", 500)))]
    assert S.sort_use(_ctx(_trace())) == pytest.approx(37.5)


def test_segments_take_the_innermost_span():
    segs = S.segments([(10, 90, "a"), (20, 40, "b"), (25, 30, "c"), (40, 60, "d")], 0, 100)
    assert segs == [(0, 10, None), (10, 20, "a"), (20, 25, "b"), (25, 30, "c"), (30, 40, "b"),
                    (40, 60, "d"), (60, 90, "a"), (90, 100, None)]
    assert S.segments([(-5, 5, "a"), (95, 120, "b")], 0, 100) == [
        (0, 5, "a"), (5, 95, None), (95, 100, "b")]
