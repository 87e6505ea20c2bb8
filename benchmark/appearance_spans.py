"""The program's spans in a traced run charged to the layers of
``PERF.md`` §3 with the appearance head as a layer of its own: the
span ``viewer.appearance`` (``app.viewer.Renderer``, around the head's
evaluation) is the layer ``appearance``, every other span is charged as
``benchmark.spans.LAYER`` charges it.

``benchmark.spans`` charges a span it does not know to ``outside``; this
module works its attribution out again, with the same rules (device
time by the k-th enqueue call and the k-th device operation, idle split
by the innermost open span, time with no span open ``outside``) and its
helpers (``segments``, ``host_kind``, ``device_kind``), under the wider
map. A program without the span gives 0 to ``appearance``; one without
the recorder gives nothing, as in ``benchmark.spans``.
"""

from __future__ import annotations

import bisect
from typing import Dict, Optional

from benchmark import spans as S
from benchmark import trace as T

LAYER = {**S.LAYER, "viewer.appearance": "appearance"}

_last: Optional[tuple] = None  # (trace, its attribution)


def _layer(name: Optional[str]) -> str:
    return LAYER.get(name, S.OUTSIDE)


def attribute(tr: T.Trace) -> Optional[dict]:
    """{"device": {layer: us} or None, "idle": {layer: us}} of a traced
    run, or None where the program left no spans; worked out once for the
    last trace asked about."""
    global _last
    if _last is None or _last[0] is not tr:
        _last = (tr, _attribute(tr))
    return _last[1]


def _attribute(tr: T.Trace) -> Optional[dict]:
    try:
        from splat_one_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    records, stamps = profiling.spans(), profiling.anchors()
    marks = [(s, e) for n, s, e in tr.host if n == profiling.ANCHOR]
    if not records or profiling.dropped() or not stamps or len(stamps) != len(marks):
        return None
    off = profiling.clock_offset_us(stamps, marks)
    spans = [(profiling.trace_us(r.start_ns, off), profiling.trace_us(r.end_ns, off), r.name)
             for r in records]
    segs = S.segments(spans, *tr.window)
    return {"device": _device(tr, segs), "idle": _idle(tr, segs)}


def _device(tr: T.Trace, segs) -> Optional[Dict[str, float]]:
    w0, w1 = tr.window
    calls = [(s, S.host_kind(n)) for n, s, _ in tr.host if w0 <= s <= w1 and S.host_kind(n)]
    ops = [(S.device_kind(n), e - s) for n, s, e in tr.device if w0 <= s <= w1]
    if not ops or len(calls) != len(ops):
        return None
    if any(kind != op_kind for (_, kind), (op_kind, _) in zip(calls, ops)):
        return None
    starts = [s for s, _, _ in segs]
    out: Dict[str, float] = {}
    for (t, _), (_, dur) in zip(calls, ops):
        i = bisect.bisect_right(starts, t) - 1
        lay = _layer(segs[i][2]) if i >= 0 else S.OUTSIDE
        out[lay] = out.get(lay, 0.0) + dur
    return out


def _idle(tr: T.Trace, segs) -> Dict[str, float]:
    w0, w1 = tr.window
    edges = [w0] + [x for s, e in T.clipped(tr) for x in (s, e)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    out: Dict[str, float] = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            s0, s1, name = segs[k]
            lay = _layer(name)
            out[lay] = out.get(lay, 0.0) + min(s1, g1) - max(s0, g0)
            k += 1
    return out


def device_ms(ctx, layer: str) -> Optional[float]:
    """Device ms a traced unit of work of the operations ``layer``'s spans
    enqueued."""
    if ctx.trace is None or not ctx.units:
        return None
    got = attribute(ctx.trace)
    if got is None or got["device"] is None:
        return None
    return got["device"].get(layer, 0.0) * 1e-3 / ctx.units


def idle_ms(ctx, layer: str) -> Optional[float]:
    """Device idle ms a traced unit of work while ``layer``'s spans were the
    innermost open on the host."""
    if ctx.trace is None or not ctx.trace.device or not ctx.units:
        return None
    got = attribute(ctx.trace)
    if got is None:
        return None
    return got["idle"].get(layer, 0.0) * 1e-3 / ctx.units
