"""Times a committed step of the traced frames that the host waited for
the card: the program's ``host_syncs`` counter (one a blocking read,
copy or synchronise, the renderer's included) over the committed
steps."""

from p3dbench.program_trace import syncs_per_step as read  # noqa: F401
