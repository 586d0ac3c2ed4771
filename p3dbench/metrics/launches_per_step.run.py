"""``launches_per_step`` in the cells that report ``steps_per_s`` per
layer only: kernel launches a committed step of the traced window."""

from p3dbench.metrics.launches_per_step import read  # noqa: F401
