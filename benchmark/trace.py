"""The traced part of a run: ``torch.profiler`` over a few units of work,
reduced to what the per-layer readers and the result's ``breakdown`` need.

- device intervals: every activity the profiler saw on the card (kernels,
  copies, memsets) with its name, start and end;
- busy: the union of those intervals inside the traced window (the host
  span of the ``benchmark.window`` record), idle = window - busy;
- kernels: the device activities that are neither a copy nor a memset,
  one per launch;
- idle gaps: the spaces between merged device intervals, each named by
  the innermost host operation running at its middle.

Copied in spirit from the repo's bring-up script (its ``device_trace``:
the union of intervals, the idle share), with the window taken from a
host span instead of the first and last device activity, so host time
before the first launch counts as idle.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, NamedTuple, Tuple

WINDOW = "benchmark.window"


class Trace(NamedTuple):
    device: List[Tuple[str, float, float]]  # (name, start us, end us), sorted
    host: List[Tuple[str, float, float]]  # host ops (name, start us, end us), sorted
    window: Tuple[float, float]  # us


def capture(fn) -> Trace:
    """Run ``fn`` (which must end in a device synchronisation) under the
    profiler and keep its events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
    dev, host, window = [], [], None
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if e.name != WINDOW:  # the window's own annotation on the device row
                dev.append(span)
        elif e.name == WINDOW:
            window = span[1:]
        else:
            host.append(span)
    if window is None:
        raise RuntimeError("the profiler lost the window's span")
    dev.sort(key=lambda s: s[1])
    host.sort(key=lambda s: s[1])
    return Trace(dev, host, window)


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def clipped(tr: Trace):
    """Merged device intervals clipped to the window."""
    w0, w1 = tr.window
    return [(max(s, w0), min(e, w1)) for s, e in merged((s, e) for _, s, e in tr.device)
            if e > w0 and s < w1]


def busy_us(tr: Trace) -> float:
    return sum(e - s for s, e in clipped(tr))


def window_us(tr: Trace) -> float:
    return tr.window[1] - tr.window[0]


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def kernel_launches(tr: Trace) -> int:
    w0, w1 = tr.window
    return sum(1 for n, s, _ in tr.device if is_kernel(n) and w0 <= s <= w1)


def device_seconds(tr: Trace, match) -> float:
    """Summed device time of the activities whose name ``match`` accepts."""
    return sum(e - s for n, s, e in tr.device if match(n)) * 1e-6


def top_device_ops(tr: Trace, k: int = 10):
    by = {}
    for n, s, e in tr.device:
        by[n] = by.get(n, 0.0) + (e - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[n[:160], us * 1e-6] for n, us in top]


def idle_gaps(tr: Trace, k: int = 10, longest: int = 400):
    """The longest idle gaps of the window, summed by the host operation
    running at each gap's middle (innermost of the enclosing ones)."""
    w0, w1 = tr.window
    iv = clipped(tr)
    edges = [w0] + [x for s, e in iv for x in (s, e)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    starts = [s for _, s, _ in tr.host]
    by = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            n, hs, he = tr.host[j]
            if he >= mid and (best is None or he - hs < best[1]):
                best = (n, he - hs)
        name = best[0] if best else "(no host operation)"
        by[name] = by.get(name, 0.0) + (e - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[n[:160], us * 1e-6] for n, us in top]
