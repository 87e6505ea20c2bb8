"""The program's spans in a traced run, charged to the layers of
``PERF.md`` §3: the device time and the device idle of each layer, and
the build sort's share of useful keys.

The spans come from ``splat_one_tpu_torch.utils.profiling``: their
records (``spans()``) and the anchors they left on the profiler's host
row (``anchors()``, host events named ``ANCHOR``), which put every span
on the trace's time axis. A program without that recorder (an earlier
commit) gives nothing to read, and every reader here returns None.

- Device time: the k-th host enqueue call of the window (a kernel
  launch, an async copy or a memset) is the k-th device operation that
  starts in it, on the one stream a viewer request runs on; each
  operation is charged to the innermost span open on the host when it
  was enqueued. Where the two counts differ, or a call's kind is not
  its operation's (a copy call against a kernel), there is no answer.
- Idle: each idle interval of the window (``trace.clipped``'s
  complement) is split by the innermost span open on the host at each
  instant; time with no span open is ``outside`` (the client's loop).
- ``sort_use``: the ``n_isect`` count over the ``exp_cap`` keys the
  build sorts, the mean over the traced requests' builds, in percent.

The spans are taken as one host thread's, properly nested. One reading
a trace, shared by every metric of the run (``attribute``).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from benchmark import trace as T

LAYER = {
    "viewer.request": "entry", "viewer.inputs": "entry", "render": "entry",
    "render.assemble": "entry", "viewer.frame": "entry",
    "render.project": "projection",
    "render.build": "build", "build.pack": "build",
    "render.composite": "kernels",
}
OUTSIDE = "outside"

_last: Optional[tuple] = None  # (trace, its attribution)


def _profiling():
    try:
        from splat_one_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def host_kind(name: str) -> Optional[str]:
    """The device operation a host call enqueues, or None."""
    if name.startswith(("cudaLaunch", "cuLaunch")):
        return "kernel"
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return "Memcpy"
    if name.startswith(("cudaMemset", "cuMemset")):
        return "Memset"
    return None


def device_kind(name: str) -> str:
    return name[:6] if name.startswith(("Memcpy", "Memset")) else "kernel"


def segments(spans: List[Tuple[float, float, str]], w0: float, w1: float):
    """[(start, end, name or None)] covering [w0, w1] in order: the
    innermost span open at each instant (None: no span)."""
    out = []
    stack: List[Tuple[float, str]] = []
    t = w0

    def emit(upto):
        nonlocal t
        upto = min(max(upto, w0), w1)
        if upto > t:
            out.append((t, upto, stack[-1][1] if stack else None))
            t = upto

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        stack.append((e, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(w1)
    return out


def _layer(name: Optional[str]) -> str:
    return LAYER.get(name, OUTSIDE)


def idle_by_layer(tr: T.Trace, segs) -> Dict[str, float]:
    """us of device idle in the window under each layer's spans."""
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


def device_by_layer(tr: T.Trace, segs) -> Optional[Dict[str, float]]:
    """us of device time of the operations each layer's spans enqueued,
    or None where the enqueue calls and the operations do not pair."""
    w0, w1 = tr.window
    calls = [(s, host_kind(n)) for n, s, _ in tr.host if w0 <= s <= w1 and host_kind(n)]
    ops = [(device_kind(n), e - s) for n, s, e in tr.device if w0 <= s <= w1]
    if not ops or len(calls) != len(ops):
        return None
    if any(kind != op_kind for (_, kind), (op_kind, _) in zip(calls, ops)):
        return None
    starts = [s for s, _, _ in segs]
    out: Dict[str, float] = {}
    for (t, _), (_, dur) in zip(calls, ops):
        i = bisect.bisect_right(starts, t) - 1
        lay = _layer(segs[i][2]) if i >= 0 else OUTSIDE
        out[lay] = out.get(lay, 0.0) + dur
    return out


def attribute(tr: T.Trace) -> Optional[dict]:
    """{"device": {layer: us} or None, "idle": {layer: us}, "sort_use": %
    or None} of a traced run, or None where the program left no spans;
    worked out once for the last trace asked about."""
    global _last
    if _last is None or _last[0] is not tr:
        _last = (tr, _attribute(tr))
    return _last[1]


def _attribute(tr: T.Trace) -> Optional[dict]:
    prof = _profiling()
    if prof is None:
        return None
    records, stamps = prof.spans(), prof.anchors()
    marks = [(s, e) for n, s, e in tr.host if n == prof.ANCHOR]
    if not records or prof.dropped() or not stamps or len(stamps) != len(marks):
        return None
    off = prof.clock_offset_us(stamps, marks)
    spans = [(prof.trace_us(r.start_ns, off), prof.trace_us(r.end_ns, off), r.name)
             for r in records]
    segs = segments(spans, *tr.window)
    uses = []
    for r in records:
        c = dict(r.counts)
        if "n_isect" in c and c.get("exp_cap"):
            uses.append(100.0 * c["n_isect"] / c["exp_cap"])
    return {"device": device_by_layer(tr, segs), "idle": idle_by_layer(tr, segs),
            "sort_use": sum(uses) / len(uses) if uses else None}


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
    innermost open on the host (``outside``: none open)."""
    if ctx.trace is None or not ctx.trace.device or not ctx.units:
        return None
    got = attribute(ctx.trace)
    if got is None:
        return None
    return got["idle"].get(layer, 0.0) * 1e-3 / ctx.units


def sort_use(ctx) -> Optional[float]:
    if ctx.trace is None or not ctx.trace.device:
        return None
    got = attribute(ctx.trace)
    return None if got is None else got["sort_use"]
