"""Host milliseconds a step run that the overflow sidecar takes to queue
its work: the self time of the program's ``dense.sidecar`` spans over
``ladder.steps_run``."""

from p3dbench.program_trace import per_step_ms


def read(s):
    return per_step_ms(s, "dense.sidecar", "ladder.steps_run")
