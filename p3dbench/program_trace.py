"""What the program recorded of its own work in the traced window: its
spans and counters (``particle3d_tpu_torch.utils.profiling.recorded()``),
which it keeps while a ``torch.profiler`` session records and which are
read once the window has closed. A span has ``name``, ``parent`` (the
index of its enclosing span, -1 for none), ``start`` and ``end`` (host
seconds); spans are listed in the order they started.

Nothing here is computed by the program: self times and sums are the
benchmark's own arithmetic on those fields. A program without the
recorder, or one that recorded nothing, reads as None.
"""

from __future__ import annotations


def recording():
    """The latest recording, or None."""
    try:
        from particle3d_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    rec = recorded()
    return rec if rec.spans or rec.counters else None


def self_seconds(rec, name: str) -> float:
    """Summed self time of the spans named ``name``: each one's duration
    less the time its child spans cover."""
    own = {i: s.end - s.start for i, s in enumerate(rec.spans)
           if s.name == name}
    for s in rec.spans:
        if s.parent in own:
            own[s.parent] -= s.end - s.start
    return sum(own.values())


def seconds(rec, prefix: str) -> float:
    """Summed duration of the spans whose names start with ``prefix``."""
    return sum(s.end - s.start for s in rec.spans
               if s.name.startswith(prefix))


def frame_waits(rec, prefix: str, last: str) -> list[float]:
    """Per frame, the summed duration of the spans whose names start with
    ``prefix``; a frame ends with its span named ``last``."""
    out, acc = [], 0.0
    for s in rec.spans:
        if s.name.startswith(prefix):
            acc += s.end - s.start
            if s.name == last:
                out.append(acc)
                acc = 0.0
    return out


def per_step_ms(s, name: str, steps_counter: str):
    """Self milliseconds of the spans named ``name`` a step counted by
    ``steps_counter``; None without a recording or steps."""
    rec = recording() if s["steps"] else None
    if rec is None or not rec.counters.get(steps_counter):
        return None
    return 1e3 * self_seconds(rec, name) / rec.counters[steps_counter]


def syncs_per_step(s):
    """Host synchronisations a committed step of the traced window."""
    rec = recording() if s["steps"] else None
    if rec is None:
        return None
    return rec.counters.get("host_syncs", 0) / s["steps"]
