"""Share of the traced window's wall time that the host spent blocked on
the card: the summed length of the program's ``sync.*`` spans over the
window."""

from p3dbench.program_trace import recording, seconds


def read(s):
    rec = recording() if s["steps"] and s["window_s"] > 0 else None
    if rec is None:
        return None
    return 100.0 * seconds(rec, "sync.") / s["window_s"]
