"""Median over the traced frames of how long the renderer waited for the
card once it had queued the frame's work: the summed length of a frame's
``sync.render_*`` spans (its blocking uploads, the palette's among them,
and the copy of the image to the host, which ends the frame)."""

import statistics

from p3dbench.program_trace import frame_waits, recording


def read(s):
    rec = recording() if s["steps"] else None
    waits = frame_waits(rec, "sync.render_", "sync.render_copy") if rec \
        else []
    return statistics.median(waits) * 1e3 if waits else None
