"""The force kernels' share of their roofline: the least time an H100
needs for the pairs in the cutoff (counted by the benchmark from the
positions at the traced window's start and end) and the particles' bytes,
every traced step, over the device time of the kernels ``kernels.json``
files under "force". Nothing when no force kernel ran."""

from p3dbench.bounds import least_seconds


def read(s):
    if s["force_s"] <= 0:
        return None
    least = least_seconds(s["pairs"], s["n"], s["wrap"]) * s["steps"]
    return 100.0 * least / s["force_s"]
