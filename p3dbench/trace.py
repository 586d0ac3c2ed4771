"""Reading a ``torch.profiler`` trace of a bounded sub-window.

The device's busy time is the union of its operations' intervals (kernels,
copies, sets), so operations that overlap on two streams count once; the
idle share is the rest of the traced window's wall time. Only the
device's activity is recorded, so the profiler adds little to the host's
time. Operations are sorted into layers by symbol name (``kernels.json``).
Idle gaps are named by the innermost span of the benchmark (``span``) that
encloses them: spans are timed on the host's clock and placed on the
profiler's by a marker, one small operation launched on the idle device at
a known host time as the traced window opens.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

_spans = None  # [(name, host start, host end)] while a window is traced


@functools.cache
def _layers() -> dict:
    return json.loads((Path(__file__).parent / "kernels.json").read_text())


def layer_of(name: str) -> str | None:
    """The layer whose pattern matches a device operation's name."""
    for layer, patterns in _layers().items():
        if any(re.search(p, name) for p in patterns):
            return layer
    return None


@contextlib.contextmanager
def span(name: str):
    """A span of the benchmark, kept while a window is traced."""
    if _spans is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _spans.append((name, t0, time.perf_counter()))


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device operations and benchmark spans of one traced window, times in
    seconds on the profiler's clock."""

    def __init__(self, ops, spans, window_s: float, steps: int):
        self.ops = ops          # [(name, start, end)]
        self.spans = spans      # [(name, start, end)]
        self.window_s = window_s
        self.steps = steps

    @classmethod
    def from_profiler(cls, t: dict, steps: int) -> "Trace":
        """From what ``traced`` yielded: the device's operations, the first
        of them the marker, which places the host's spans."""
        cuda = torch.autograd.DeviceType.CUDA
        ops = sorted((e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                      e.name) for e in t["prof"].events()
                     if e.device_type == cuda)
        ops = [(n, s, e) for s, e, n in ops]
        spans = []
        if ops:
            shift = ops[0][1] - t["marker_host"]
            spans = [(n, s + shift, e + shift) for n, s, e in t["spans"]]
            ops = ops[1:]
        return cls(ops, spans, t["window_s"], steps)

    def busy_s(self, layer: str | None = None) -> float:
        return union_seconds((s, e) for n, s, e in self.ops
                             if layer is None or layer_of(n) == layer)

    def launches(self) -> int:
        """Kernel launches: device operations other than copies and sets."""
        return sum(1 for n, _, _ in self.ops
                   if not n.startswith(("Memcpy", "Memset")))

    def span_times(self, name: str) -> list[float]:
        return [e - s for n, s, e in self.spans if n == name]

    def idle_gaps(self, top: int = 10):
        """[[span name, seconds]] of the longest gaps between device
        operations inside the window, named by the innermost enclosing
        span."""
        busy = merged((s, e) for _, s, e in self.ops)
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])
                if b[0] > a[1]]
        gaps.sort(reverse=True)
        out = []
        for g, s, e in gaps[:top]:
            mid = (s + e) / 2
            inside = [(t1 - t0, n) for n, t0, t1 in self.spans
                      if t0 <= mid <= t1]
            out.append([min(inside)[1] if inside else "none", g])
        return out

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        tot = {}
        for n, s, e in self.ops:
            tot[n] = tot.get(n, 0.0) + (e - s)
        return [[n[:120], t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def traced(device):
    """Profile the device's activity in the block; yields a dict that
    holds, once the block has ended with the device synchronised, the
    profiler, the window's wall seconds, the spans and the host time at
    which the marker was launched."""
    global _spans
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    out = {"spans": []}
    _spans = out["spans"]
    try:
        with profile(activities=acts) as prof:
            if cuda:
                torch.cuda.synchronize(device)
            t0 = out["marker_host"] = time.perf_counter()
            torch.ones(1, device=device)
            yield out
            if cuda:
                torch.cuda.synchronize(device)
            out["window_s"] = time.perf_counter() - t0
    finally:
        _spans = None
    out["prof"] = prof
