"""Profiling utilities: the port of ``splat_one_tpu/utils/profiling.py``.

  - ``trace``: a context manager around ``torch.profiler`` (CPU and CUDA
    activities) writing a TensorBoard-loadable Chrome trace into
    ``log_dir``, with the program's spans on a row of their own
    ("program spans", one event a span, its counts as arguments) on the
    trace's own time axis, so that one file shows the layers above the
    kernels they enqueued,
  - ``span`` / ``count`` / ``spans`` / ``clear``: the program's span
    recorder (below),
  - ``memory_stats``: current and peak allocated memory per CUDA device
    (the ``torch.cuda.max_memory_allocated`` the Trainer's eval reports).

The span recorder. ``with span("render.build"):`` marks one layer's part
of a request; ``count(name, value)`` attaches a number to the innermost
open span. While no torch profiler runs, ``span`` costs one flag test and
returns a shared no-op object, and ``count`` one flag test. While one
runs, each span appends one ``SpanRecord`` (name, id, parent id, request
id, start and end in ``time.time_ns()``, counts) to a bounded in-memory
list; the parent stack is per thread, a root span's id is its request
id, and records past ``SPAN_CAP`` are dropped and counted (``dropped``).
A new profiler session empties the list. A count's value may be a 0-d
tensor (on the device), or a callable returning one: it is read (called)
when ``spans()`` collects the records, never on the request path. Spans launch nothing and synchronise nothing,
and they are not ``record_function`` ranges, which would put an
annotation on the profiler's device row.

One clock with the profiler: each root span first leaves an anchor, an
empty ``record_function`` named ``ANCHOR`` around a ``time.time_ns()``
(``anchors()``). ``clock_offset_us`` turns the anchors' host events in a
trace into the offset that places every span on that trace's time axis
(``trace_us(t_ns, offset)``), within half an anchor's recorded length.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import statistics
import threading
import time
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

SPAN_CAP = 1 << 16  # records (and anchors) kept a profiler session
ANCHOR = "splat_one_tpu_torch.spans.anchor"
SPAN_ROW = "program spans"


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: int  # 0 for a root span
    request: int  # the root span's id
    start_ns: int  # time.time_ns()
    end_ns: int
    counts: Tuple[Tuple[str, int], ...]  # (name, value) from ``count``


class _Local(threading.local):
    def __init__(self):
        self.stack: List["_Span"] = []


class _Recorder:
    """The process's records of one profiler session."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = cap
        self.ids = itertools.count(1)
        self.local = _Local()
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        with self.lock:
            self.records: List[SpanRecord] = []
            self.anchors: List[int] = []
            self.dropped = 0

    def add(self, rec: SpanRecord):
        with self.lock:
            if len(self.records) < self.cap:
                self.records.append(rec)
            else:
                self.dropped += 1

    def anchor(self):
        with _RecordFunctionFast(ANCHOR):
            t = time.time_ns()
        with self.lock:
            if len(self.anchors) < self.cap:
                self.anchors.append(t)
            else:
                self.dropped += 1


_REC = _Recorder()


def _hook_session_start():
    """Empty the records whenever a torch profiler session starts: wraps
    the function every ``torch.autograd.profiler.profile`` calls as it
    starts, the one that raises the flag ``span`` tests."""
    start = _autograd_profiler._run_on_profiler_start
    if getattr(start, "_empties_spans", False):
        return

    def run_on_profiler_start():
        start()
        _REC.reset()

    run_on_profiler_start._empties_spans = True
    _autograd_profiler._run_on_profiler_start = run_on_profiler_start


_hook_session_start()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "start", "counts")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _REC.local.stack
        self.id = next(_REC.ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            _REC.anchor()
            self.parent, self.request = 0, self.id
        self.counts = []
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _REC.local.stack.pop()
        _REC.add(SpanRecord(self.name, self.id, self.parent, self.request, self.start,
                            end, tuple(self.counts)))
        return False


def span(name: str):
    """``with span(name):`` records one span while a torch profiler runs;
    otherwise returns the shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def count(name: str, value) -> None:
    """Attach ``value`` (an int, a 0-d tensor, or a callable returning
    one, read or called at collection) to the innermost open span of this
    thread, while a profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _REC.local.stack
    if stack:
        stack[-1].counts.append((name, value))


def spans() -> List[SpanRecord]:
    """The records of the current (or last) profiler session, in the
    order the spans ended, their counts read as ints."""
    with _REC.lock:
        records = list(_REC.records)
    return [r._replace(counts=tuple((k, int(v() if callable(v) else v)) for k, v in r.counts))
            if r.counts else r for r in records]


def anchors() -> List[int]:
    """The ``time.time_ns()`` inside each anchor, in the order left."""
    with _REC.lock:
        return list(_REC.anchors)


def dropped() -> int:
    """Records and anchors dropped because the list was full."""
    return _REC.dropped


def clear() -> None:
    """Empty the records, the anchors and the dropped count."""
    _REC.reset()


def clock_offset_us(stamps_ns: Sequence[int],
                    events_us: Sequence[Tuple[float, float]]) -> float:
    """The offset from ``time.time_ns()`` (as us) to a trace's time axis:
    ``stamps_ns`` the anchors' stamps (``anchors()``), ``events_us`` the
    (start, end) of the trace's host events named ``ANCHOR``, in order.
    Each stamp lies inside its event, so the median of stamp - event
    midpoint errs by at most half an event's length. Raises if the two
    counts differ."""
    if not stamps_ns or len(stamps_ns) != len(events_us):
        raise ValueError(f"{len(stamps_ns)} anchors against {len(events_us)} anchor events")
    return statistics.median(t / 1e3 - 0.5 * (s + e) for t, (s, e) in zip(stamps_ns, events_us))


def trace_us(t_ns: int, offset_us: float) -> float:
    """A ``time.time_ns()`` stamp on the trace's axis (``clock_offset_us``)."""
    return t_ns / 1e3 - offset_us


def _add_spans(path: str) -> None:
    """Write the recorded spans into the Chrome trace at ``path`` as
    complete events on their own row, on the trace's axis."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    marks = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("name") == ANCHOR and e.get("ph") == "X")
    records = spans()
    if not records:
        return
    off = clock_offset_us(anchors(), marks)
    pid = os.getpid()
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_ROW,
                   "args": {"name": SPAN_ROW}})
    for r in records:
        args = {"id": r.id, "parent": r.parent, "request": r.request, **dict(r.counts)}
        events.append({"ph": "X", "cat": "span", "name": r.name, "pid": pid,
                       "tid": SPAN_ROW, "ts": trace_us(r.start_ns, off),
                       "dur": (r.end_ns - r.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("results/profile"):`` — view in TensorBoard's profiler
    plugin or chrome://tracing (``<log_dir>/*.pt.trace.json``); the spans
    recorded inside the block are the row "program spans"."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def ready(prof):
        os.makedirs(log_dir, exist_ok=True)
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 10**6}.pt.trace.json"
        path = os.path.join(log_dir, name)
        prof.export_chrome_trace(path)
        _add_spans(path)

    with torch.profiler.profile(activities=acts, on_trace_ready=ready):
        yield


def memory_stats() -> Dict[str, float]:
    """Per-device allocated memory in GiB (current / peak); ``{}`` where
    there is no CUDA device."""
    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        if not ms:
            continue
        cur = ms.get("allocated_bytes.all.current", 0)
        out[f"dev{i}_gib"] = cur / 2**30
        out[f"dev{i}_peak_gib"] = ms.get("allocated_bytes.all.peak", cur) / 2**30
    return out
