"""Profiling helpers: device traces and throughput counters (JAX `utils/profiling.py`).

- `device_trace` wraps `torch.profiler` (CPU and, where present, CUDA
  activity) and writes a Chrome/Perfetto trace (`trace.json`) into
  `log_dir`;
- `device_busy_us` reads from that trace the time in which the device ran
  at least one kernel, copy or memset;
- `Throughput` tracks steps per second per device over a sliding window;
- `timed_value` times a call to its end on the device: it synchronises the
  device of the first tensor of the result (CUDA calls return before the
  card is done).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch

__all__ = ["device_trace", "device_busy_us", "Throughput", "timed_value"]


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the body with `torch.profiler`; the trace goes to
    `<log_dir>/trace.json`, viewable in Perfetto or chrome://tracing.
    Yields the profiler (its `key_averages()` sums the time by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# the device's own work in a Chrome trace of torch.profiler (Kineto's categories)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_us(trace_path: str) -> float:
    """Microseconds in which the device was busy, from the Chrome trace that
    `device_trace` wrote: the union of the intervals of its kernels, copies
    and memsets, so that each is counted once and overlapping ones once
    together.  The user annotations drawn on the device's timeline
    (`gpu_user_annotation`) are not device work and are left out.  (A sum
    of `self_device_time_total` over `key_averages()` counts a kernel
    launched by an aten op twice, under the op and as its own event, and
    building those events from a long trace takes minutes.)"""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_WORK)
    busy, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for v in out:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def timed_value(fn, *args, **kwargs):
    """Run `fn` and wait for its device; returns (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    leaf = _first_tensor(out)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return out, time.perf_counter() - t0


class Throughput:
    """Sliding steps/sec (per device) counter."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []

    def tick(self, n_steps: int = 1) -> Optional[float]:
        now = time.perf_counter()
        self._times.append((now, n_steps))
        self._times = self._times[-self.window:]
        if len(self._times) < 2:
            return None
        dt = self._times[-1][0] - self._times[0][0]
        steps = sum(n for _, n in self._times[1:])
        if dt <= 0:
            return None
        return steps / dt / max(torch.cuda.device_count(), 1)
