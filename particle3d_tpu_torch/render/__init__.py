"""Rendering on the frame's device: camera math and the z-buffered
point-splat rasterizer."""

from .camera import (Camera, camera_axes, default_camera, move_camera,
                     projection_matrix, rotate_camera, view_matrix)
from .splat import render_frame

__all__ = ["Camera", "camera_axes", "default_camera", "view_matrix",
           "projection_matrix", "move_camera", "rotate_camera",
           "render_frame"]
