"""Render the demo GIF on the card (port of the JAX package's
``examples/render_demo.py``).

The 262k clip runs the exact production path, ``simulate_dense_carry`` on
a dense cell layout kept across frames (a preset without a cell grid runs
``simulate``), with an orbiting camera and the dilation renderer::

    python -m particle3d_tpu_torch.examples.render_demo [--out build/demo_262k.gif] [--frames 80]
    python -m particle3d_tpu_torch.examples.render_demo --preset reference --device cpu

The default output lies under ``build/``; the JAX package's
``docs/demo_262k.gif`` is its own.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..render.camera import Camera


def orbit_camera(cam0: Camera, world: float, i: int, frames: int) -> Camera:
    """Frame ``i`` of ``frames`` on a circle of radius ``world`` at height
    world / 4, looking at the origin: yaw -angle, pitch -10 degrees
    (forward = (sin(yaw)cos(p), sin(p), -cos(yaw)cos(p)))."""
    ang = 2 * np.pi * i / frames
    r = world * 1.0
    return cam0.replace(
        position=np.asarray([r * np.sin(ang), 0.25 * world, r * np.cos(ang)],
                            np.float32),
        yaw=np.float32(-np.degrees(ang)), pitch=np.float32(-10.0))


def render_demo(preset: str = "particle_life_large",
                out: str = "build/demo_262k.gif", frames: int = 80,
                steps_per_frame: int = 4, warm_steps: int = 240,
                width: int = 480, height: int = 360, device="cuda",
                say=print) -> dict:
    """Settle ``preset`` for ``warm_steps``, then film ``frames`` frames,
    ``steps_per_frame`` steps apart, into the GIF ``out``. Returns a record:
    preset, n, steps taken, frames, ms a frame (steps and render, host
    clock after a sync), the largest masked count of the dense windows and
    the kernel launches."""
    import torch

    from ..app.headless import save_gif
    from ..engine.step import simulate, warmup
    from ..models import make_scene
    from ..ops import kernel_launches
    from ..render.camera import default_camera
    from ..render.splat import render_frame

    st, cfg, dt = make_scene(preset, device=device)
    dev = st.positions.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    before = kernel_launches()
    st = warmup(st, cfg)
    masked = [0]
    if cfg.neighbor == "celllist_pallas" and cfg.cell_grid is not None:
        # keep the layout across frames: the sorting build runs once
        from ..engine.step import simulate_dense_carry
        from ..ops.celllist_dense import (build_dense, default_mover_capacity,
                                          scatter_back)

        nsc, cap = cfg.cell_grid, cfg.cell_capacity
        mcap = default_mover_capacity(st.n)
        ds = [build_dense(st, cfg, nsc, cap)]

        def advance(s, k):
            ds[0], (_, mis) = simulate_dense_carry(ds[0], cfg, dt, k, nsc,
                                                   cap, mcap)
            masked[0] = max(masked[0], int(mis))
            return scatter_back(ds[0], s)
    else:
        def advance(s, k):
            return simulate(s, cfg, dt, k)

    t0 = time.perf_counter()
    if warm_steps:
        st = advance(st, warm_steps)
        sync()
        say(f"warmed {warm_steps} steps in {time.perf_counter() - t0:.1f}s")

    w = float(np.asarray(cfg.world_size))
    cam0 = default_camera(w)
    imgs = []
    t0 = time.perf_counter()
    for i in range(frames):
        st = advance(st, steps_per_frame)
        imgs.append(render_frame(st.positions, st.species, cfg,
                                 orbit_camera(cam0, w, i, frames), width,
                                 height).cpu().numpy())
    sec = time.perf_counter() - t0
    say(f"{frames} frames x {steps_per_frame} steps in {sec:.1f}s")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_gif(np.stack(imgs), out, fps=20)
    say(f"wrote {out}")
    launches = {k: c - before[k] for k, c in kernel_launches().items()}
    return {"preset": preset, "n": st.n,
            "steps": warm_steps + frames * steps_per_frame, "frames": frames,
            "ms_per_frame": sec / frames * 1e3, "max_masked": masked[0],
            "out": out, "kernel_launches_by_kernel": launches}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="particle_life_large")
    p.add_argument("--out", default="build/demo_262k.gif")
    p.add_argument("--frames", type=int, default=80)
    p.add_argument("--steps-per-frame", type=int, default=4)
    p.add_argument("--warm-steps", type=int, default=240,
                   help="settle the scene before filming")
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    return render_demo(a.preset, a.out, a.frames, a.steps_per_frame,
                       a.warm_steps, a.width, a.height, a.device)


if __name__ == "__main__":
    main()
