"""Profiling utilities: the port of ``splat_one_tpu/utils/profiling.py``.

  - ``trace``: a context manager around ``torch.profiler`` (CPU and CUDA
    activities) writing a TensorBoard-loadable trace into ``log_dir``,
  - ``device_timer``: seconds per call of a function, timed with CUDA
    events on the card and ``perf_counter`` on the CPU,
  - ``memory_stats``: current and peak allocated memory per CUDA device
    (the ``torch.cuda.max_memory_allocated`` the Trainer's eval reports).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("results/profile"):`` — view in TensorBoard's profiler
    plugin or chrome://tracing (``<log_dir>/*.pt.trace.json``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def _on_cuda(out) -> bool:
    """Whether any tensor in ``out`` (a tensor or a nest of tuples, lists
    and dicts) lies on a CUDA device."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_cuda(o) for o in out)
    return False


def device_timer(
    fn: Callable,
    *args,
    iters: int = 10,
    host_roundtrip_s: float = 0.0,
) -> float:
    """Seconds per call of ``fn(*args)``, after one warm call. Where the
    warm call's output lies on a CUDA device the ``iters`` calls are timed
    by CUDA events on the current stream; otherwise by ``perf_counter``.
    ``host_roundtrip_s`` is subtracted from the total once (a fixed cost
    of reading the result back, where the caller knows one)."""
    cuda = _on_cuda(fn(*args))
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        total = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        total = time.perf_counter() - t0
    return max((total - host_roundtrip_s) / iters, 0.0)


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
