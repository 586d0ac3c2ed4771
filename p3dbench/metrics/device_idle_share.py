"""Share of the traced window's wall time in which no operation ran on the
device (the union of their intervals)."""


def read(s):
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) \
        if s["window_s"] > 0 else None
