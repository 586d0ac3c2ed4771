"""Kernel launches a step: the device's kernel events in the traced window
over the steps traced."""


def read(s):
    return s["launches"] / s["steps"] if s["steps"] else None
