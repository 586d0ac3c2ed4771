"""Named scene presets."""

from .presets import PRESETS, list_presets, make_scene

__all__ = ["PRESETS", "list_presets", "make_scene"]
