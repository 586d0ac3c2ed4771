"""Camera: spherical-angle axes, view and projection matrices, movement
(port of ``particle3d_tpu.render.camera``).

The camera is host state: a frozen dataclass of numpy float32 values, its
matrices float32 [4, 4] arrays that ``render.splat`` copies to the
frame's device. It reproduces the reference's ``CameraSystem``:

  * forward = (cos(pitch) sin(yaw), sin(pitch), -cos(pitch) cos(yaw))
  * WASD/QE translation at SPEED = 5 units/s
  * arrow rotation at 90 deg/s, pitch clamped to +-90.9999 (PITCH_LIMIT)
  * perspective(fovy=90 deg, aspect, near=0.001, far=1000)

The reference computes up = forward x right, which inverts the vertical
axis; up = right x forward is the default, and ``reference_up=True``
keeps the reference's framing.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

SPEED = 5.0
ROTATION_SPEED = 90.0  # deg/s
PITCH_LIMIT = 90.9999


def _f32(x):
    return np.asarray(x, np.float32)


@dataclasses.dataclass(frozen=True)
class Camera:
    position: Any  # f32[3]
    pitch: Any = 0.0  # degrees
    yaw: Any = 0.0  # degrees
    up_hint: Any = None  # f32[3], world up
    fov_deg: float = 90.0
    near: float = 0.001
    far: float = 1000.0
    reference_up: bool = False

    def __post_init__(self):
        if self.up_hint is None:
            object.__setattr__(self, "up_hint", _f32([0.0, 1.0, 0.0]))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def default_camera(world_size: float = 10.0) -> Camera:
    """The reference's starting pose: (1, 0, 1.6 * world) looking down -z."""
    return Camera(position=_f32([1.0, 0.0, 1.6 * world_size]))


def _normalize(v):
    return v / np.linalg.norm(v)


def camera_axes(cam: Camera):
    """(forward, right, up), float32 [3] each."""
    pitch = np.deg2rad(_f32(cam.pitch))
    yaw = np.deg2rad(_f32(cam.yaw))
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    forward = _normalize(np.stack([cp * sy, sp, -cp * cy]))
    right = _normalize(np.cross(forward, _f32(cam.up_hint)))
    if cam.reference_up:
        up = _normalize(np.cross(forward, right))  # inverted vertical
    else:
        up = _normalize(np.cross(right, forward))
    return forward, right, up


def move_camera(cam: Camera, dt, direction) -> Camera:
    """Translate along a unit direction at SPEED."""
    return cam.replace(position=_f32(cam.position + _f32(direction)
                                     * np.float32(SPEED) * np.float32(dt)))


def rotate_camera(cam: Camera, pitch_delta, yaw_delta) -> Camera:
    """Rotate, clamping the pitch to +-PITCH_LIMIT."""
    return cam.replace(
        pitch=np.clip(_f32(cam.pitch) + np.float32(pitch_delta),
                      np.float32(-PITCH_LIMIT), np.float32(PITCH_LIMIT)),
        yaw=_f32(cam.yaw) + np.float32(yaw_delta))


def view_matrix(cam: Camera):
    """Right-handed look-to view matrix, row-major: view @ [p; 1]."""
    forward, _, up = camera_axes(cam)
    eye = _f32(cam.position)
    f = forward
    s = _normalize(np.cross(f, up))
    u = np.cross(s, f)
    return np.stack([
        np.concatenate([s, [-np.dot(s, eye)]]),
        np.concatenate([u, [-np.dot(u, eye)]]),
        np.concatenate([-f, [np.dot(f, eye)]]),
        _f32([0.0, 0.0, 0.0, 1.0]),
    ]).astype(np.float32)


def projection_matrix(cam: Camera, aspect):
    """OpenGL-style perspective (cgmath ``perspective``)."""
    fct = np.float32(1.0) / np.tan(np.deg2rad(_f32(cam.fov_deg)) / np.float32(2.0))
    near, far = cam.near, cam.far
    m = np.array([[1.0, 0.0, 0.0, 0.0],
                  [0.0, 1.0, 0.0, 0.0],
                  [0.0, 0.0, (far + near) / (near - far),
                   2 * far * near / (near - far)],
                  [0.0, 0.0, -1.0, 0.0]], np.float32)
    m[0, 0] = fct / _f32(aspect)
    m[1, 1] = fct
    return m
