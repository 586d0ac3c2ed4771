"""Host milliseconds a step run that the dense step's rebind takes to
queue its work: the self time of the program's ``dense.rebind`` spans
over ``ladder.steps_run`` (rewound steps included: they ran)."""

from p3dbench.program_trace import per_step_ms


def read(s):
    return per_step_ms(s, "dense.rebind", "ladder.steps_run")
