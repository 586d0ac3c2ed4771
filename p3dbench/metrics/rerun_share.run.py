"""Share of the steps the capacity ladder ran in the traced episode that
it threw away: the program's counters ``ladder.steps_rewound`` over
``ladder.steps_run`` (a window that masks is rewound and run again at
twice the capacity)."""

from p3dbench.program_trace import recording


def read(s):
    rec = recording() if s["steps"] else None
    if rec is None or not rec.counters.get("ladder.steps_run"):
        return None
    c = rec.counters
    return 100.0 * c.get("ladder.steps_rewound", 0) / c["ladder.steps_run"]
