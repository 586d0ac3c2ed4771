"""Headless trajectory rendering (port of ``particle3d_tpu.app.headless``):
simulate on the state's device, render each snapshot there, export a GIF
or PNG frames (PIL, imported by the two export functions only)."""

from __future__ import annotations

import os

import numpy as np

from ..config import SimConfig
from ..engine.step import trajectory, warmup
from ..render.camera import Camera, default_camera
from ..render.splat import render_frame
from ..state import ParticleState


def render_trajectory(state: ParticleState, cfg: SimConfig, dt: float,
                      num_steps: int, *, snapshot_every: int = 4,
                      width: int = 480, height: int = 360,
                      camera: Camera | None = None):
    """-> (final_state, frames uint8 [S, H, W, 3] on the host)."""
    if camera is None:
        camera = default_camera(float(np.asarray(cfg.world_size)))
    state = warmup(state, cfg)
    final, snaps = trajectory(state, cfg, dt, num_steps, snapshot_every)
    frames = [render_frame(snaps[i], state.species, cfg, camera, width,
                           height).cpu().numpy()
              for i in range(snaps.shape[0])]
    return final, np.stack(frames)


def save_gif(frames: np.ndarray, path: str, fps: int = 20) -> None:
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)


def save_frames(frames: np.ndarray, out_dir: str) -> None:
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(out_dir, f"frame_{i:05d}.png"))
