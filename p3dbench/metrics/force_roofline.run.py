"""``force_roofline`` in the cells that report ``steps_per_s`` per layer
only: the force kernels' share of their roofline."""

from p3dbench.metrics.force_roofline import read  # noqa: F401
