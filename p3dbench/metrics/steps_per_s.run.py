"""Committed steps a second of the traced window (host clock; the
profiler records the device's activity alone), in a cell whose rate
follows the host too far to be held to a bound end to end."""


def read(s):
    return s["steps"] / s["window_s"] \
        if s["steps"] and s["window_s"] > 0 else None
