"""``device_idle_share`` in the cells that report ``steps_per_s`` per
layer only: the traced window's share in which the device was idle."""

from p3dbench.metrics.device_idle_share import read  # noqa: F401
