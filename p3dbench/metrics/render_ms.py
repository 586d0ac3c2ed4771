"""Median host-clock time of the renderer's calls, image in host memory
included, from the benchmark's own timings of frames run just before the
profiled ones (the profiler slows the host)."""

import statistics


def read(s):
    vals = s.get("render_s", [])
    return statistics.median(vals) * 1e3 if vals else None
