"""App shell: the simulation driver with its fixed-timestep loop and live
controls, headless video export, and the browser UI's HTTP server."""

from .driver import SimulationApp

__all__ = ["SimulationApp"]
