"""Command-line interface of the PyTorch port.

    python -m particle3d_tpu_torch run --preset particle_life_large --steps 48
    python -m particle3d_tpu_torch run --preset reference --steps 5 --device cpu
    python -m particle3d_tpu_torch run --preset reference --gif out.gif
    python -m particle3d_tpu_torch run --preset reference --record t.p3t
    python -m particle3d_tpu_torch replay --traj t.p3t --gif out.gif
    python -m particle3d_tpu_torch run --preset reference --checkpoint ck.npz
    python -m particle3d_tpu_torch resume --checkpoint ck.npz --steps 100
    python -m particle3d_tpu_torch serve --preset particle_life_large --port 8971
    python -m particle3d_tpu_torch presets
    python -m particle3d_tpu_torch tune --preset particle_life_large --steps 8
    python -m particle3d_tpu_torch slab --config slab_8m --steps 10
    torchrun --nproc_per_node=4 -m particle3d_tpu_torch slab --config slab_8m
    python -m particle3d_tpu_torch bench
    python -m particle3d_tpu_torch bench --device cpu

``run`` prints one JSON line: the JAX package's fields plus the number of
force-kernel launches (``kernel_launches``, with one count per kernel in
``kernel_launches_by_kernel``) and, for the cell-list presets, the capacity
ladder's history. ``--device cuda`` (the default) never falls back to the
CPU. ``--gif``, ``--record`` and ``--checkpoint`` write a GIF, a ``.p3t``
trajectory or an npz checkpoint; their progress lines go to stderr.
``resume`` continues a checkpoint (either package's), ``replay`` renders a
trajectory to a GIF, and ``serve`` runs the browser UI
(``app.server``). Every command that steps or renders takes ``--device``.

``tune`` times candidate (grid, capacity) geometries of a preset's
``simulate_dense`` windows (``utils.tune``) and prints the JAX package's
JSON line: ``preset``, ``n``, ``best`` and the ranked ``results``.

``slab`` runs a ``models.presets.SLAB_RUNS`` configuration on the slab
decomposition, stay-sharded: one rank by default, or every rank of a
torchrun launch (one process per card, NCCL). After one untimed step,
rank 0 prints one JSON line with the timed window's ms/step and
diagnostics.

``bench`` runs the benchmark harness (``bench.py``): the JAX package's
timed paths and exactness gates on the card, one JSON line with its keys.
``--device cpu`` runs its small CPU branch; a failed gate exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def _simulate_best(state, cfg, dt, steps):
    """Route cell-list presets through the exact dense-layout path with
    capacity escalation. Returns (state, history or None)."""
    from .engine import step as engine

    if (cfg.neighbor == "celllist_pallas" and cfg.cell_grid is not None
            and cfg.cell_capacity is not None):
        out, _, history = engine.simulate_dense_adaptive(
            state, cfg, dt, steps, verbose=lambda m: print(m, file=sys.stderr))
        return out, history
    return engine.simulate(state, cfg, dt, steps), None


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device(name: str) -> torch.device:
    from .state import resolve_device

    return resolve_device(name)


def _say(msg: str):
    """Progress lines go to stderr: stdout carries the JSON record."""
    print(msg, file=sys.stderr, flush=True)


def _cmd_run(a):
    from .app.headless import render_trajectory, save_gif
    from .engine.step import trajectory, warmup
    from .models import make_scene
    from .ops import kernel_launches
    from .utils.checkpoint import (_config_to_jsonable, load_checkpoint,
                                   save_checkpoint)
    from .utils.metrics import measure_metrics
    from .utils.trajio import TrajectoryWriter

    device = _device(a.device)
    state, cfg, dt = make_scene(a.preset, seed=a.seed, n=a.n, device=device)
    if a.dt:
        dt = a.dt
    start_step = 0
    if a.checkpoint and a.checkpoint_every and os.path.exists(a.checkpoint):
        # restart: resume from the newest periodic snapshot
        state, cfg, start_step, _ = load_checkpoint(a.checkpoint, device=device)
        _say(f"resuming from {a.checkpoint} at step {start_step}")
    launches0 = kernel_launches()
    _sync(device)
    t0 = time.perf_counter()
    history = None
    if a.record:
        state = warmup(state, cfg)
        meta = {"config": _config_to_jsonable(cfg), "dt": float(dt),
                "snapshot_every": a.snapshot_every}
        chunk = a.snapshot_every * 64  # bounds the snapshots held at once
        with TrajectoryWriter(a.record, state.n, state.species, meta) as tw:
            done = 0
            while done < a.steps:
                k = min(chunk, a.steps - done)
                state, snaps = trajectory(state, cfg, dt, k,
                                          snapshot_every=a.snapshot_every)
                tw.append_batch(snaps)
                done += k
        _say(f"recorded {tw.frames} frames to {a.record}")
    elif a.gif:
        state, frames = render_trajectory(
            state, cfg, dt, a.steps, snapshot_every=a.snapshot_every,
            width=a.width, height=a.height)
        save_gif(frames, a.gif, fps=a.fps)
        _say(f"wrote {a.gif} ({frames.shape[0]} frames)")
    elif a.checkpoint and a.checkpoint_every:
        # periodic snapshots: after a crash, the same command resumes
        state = warmup(state, cfg)
        done = start_step
        history = []
        while done < a.steps:
            k = min(a.checkpoint_every, a.steps - done)
            state, hist = _simulate_best(state, cfg, dt, k)
            history += hist or []
            done += k
            save_checkpoint(a.checkpoint, state, cfg, done)
    else:
        state = warmup(state, cfg)
        state, history = _simulate_best(state, cfg, dt, a.steps)
    _sync(device)
    el = time.perf_counter() - t0
    launches = {k: c - launches0[k] for k, c in kernel_launches().items()}
    rec = {"preset": a.preset, "n": state.n, "steps": a.steps,
           "device": str(device), "wall_s": round(el, 3),
           "steps_per_s": round(a.steps / el, 2),
           **measure_metrics(state).as_dict(),
           "kernel_launches": sum(launches.values()),
           "kernel_launches_by_kernel": launches,
           "history": history}
    print(json.dumps(rec))
    if a.checkpoint:
        save_checkpoint(a.checkpoint, state, cfg, a.steps)
        _say(f"wrote {a.checkpoint}")
    return rec


def _cmd_resume(a):
    from .engine.step import warmup
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.metrics import measure_metrics

    device = _device(a.device)
    state, cfg, step0, _ = load_checkpoint(a.checkpoint, device=device)
    state = warmup(state, cfg)
    state, _ = _simulate_best(state, cfg, a.dt, a.steps)
    _sync(device)
    rec = {"resumed_from": step0, "now": step0 + a.steps,
           **measure_metrics(state).as_dict()}
    print(json.dumps(rec))
    out = a.out or a.checkpoint
    save_checkpoint(out, state, cfg, step0 + a.steps)
    _say(f"wrote {out}")
    return rec


def _cmd_replay(a):
    import numpy as np

    from .app.headless import save_gif
    from .render.camera import default_camera
    from .render.splat import render_frame
    from .utils.checkpoint import _config_from_jsonable
    from .utils.trajio import TrajectoryReader

    device = _device(a.device)
    tr = TrajectoryReader(a.traj)
    cfg = _config_from_jsonable(tr.meta["config"])
    cam = default_camera(float(np.asarray(cfg.world_size)))
    species = torch.as_tensor(np.array(tr.species), device=device)
    frames = [render_frame(torch.as_tensor(np.array(tr[i]), device=device),
                           species, cfg, cam, a.width, a.height).cpu().numpy()
              for i in range(0, len(tr), a.every)]
    save_gif(np.stack(frames), a.gif, fps=a.fps)
    print(f"replayed {len(frames)} of {len(tr)} frames -> {a.gif}")


def _cmd_serve(a):
    from .app.server import main as serve_main

    argv = ["--preset", a.preset, "--port", str(a.port), "--host", a.host,
            "--seed", str(a.seed), "--device", a.device]
    if a.n:
        argv += ["--n", str(a.n)]
    serve_main(argv)


def _cmd_slab(a):
    from .models.presets import slab_run
    from .parallel import (init_sharded_dense, initialize_distributed,
                           make_mesh, sharded_dense_steps)

    device = torch.device(a.device)
    initialize_distributed(backend="nccl" if device.type == "cuda" else "gloo")
    mesh = make_mesh(device=a.device)
    n, cfg, dt, kw = slab_run(a.config)
    carry = init_sharded_dense(a.seed, n, cfg, mesh, nsc=kw["nsc"],
                               cap=kw["cap"], migcap=kw["migcap"])
    # one untimed step, thrown away (the step functions never write their
    # inputs): it builds and loads the kernel before the clock starts
    sharded_dense_steps(carry, cfg, dt, 1, mesh, n=n, **kw)
    _sync(mesh.device)
    t0 = time.perf_counter()
    carry, (mov, mask, limbo, lost, shipped) = sharded_dense_steps(
        carry, cfg, dt, a.steps, mesh, n=n, **kw)
    _sync(mesh.device)
    el = time.perf_counter() - t0
    rec = {"config": a.config, "n": n, "steps": a.steps, "ranks": mesh.size,
           "device": str(mesh.device), "wall_s": round(el, 3),
           "ms_per_step": round(el / a.steps * 1e3, 3),
           "max_movers": int(mov), "max_masked": int(mask),
           "max_limbo": int(limbo), "lost": int(lost),
           "shipped": int(shipped)}
    if mesh.rank == 0:
        print(json.dumps(rec))
    if mesh.size > 1:
        torch.distributed.destroy_process_group()
    return rec


def _cmd_presets(a):
    from .models import list_presets

    for p in list_presets():
        print(p)


def _cmd_tune(a):
    from .models import make_scene
    from .utils.tune import tune

    state, cfg, dt = make_scene(a.preset, seed=a.seed, n=a.n,
                                device=_device(a.device))
    results = tune(state, cfg, dt, steps=a.steps, verbose=_say)
    rec = {"preset": a.preset, "n": state.n, "best": results[0].as_dict(),
           "results": [r.as_dict() for r in results]}
    print(json.dumps(rec))
    return rec


def _cmd_bench(a):
    from .bench import main as bench_main

    return bench_main(["--device", a.device])


def main(argv=None):
    p = argparse.ArgumentParser(prog="particle3d_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a trajectory headlessly")
    r.add_argument("--preset", default="reference")
    r.add_argument("--n", type=int, default=None)
    r.add_argument("--steps", type=int, default=600)
    r.add_argument("--dt", type=float, default=None)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    r.add_argument("--gif", default=None)
    r.add_argument("--snapshot-every", type=int, default=4)
    r.add_argument("--fps", type=int, default=20)
    r.add_argument("--width", type=int, default=480)
    r.add_argument("--height", type=int, default=360)
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--checkpoint-every", type=int, default=None,
                   help="write the checkpoint every N steps and resume from "
                        "it if it exists (snapshot-based restart)")
    r.add_argument("--record", default=None,
                   help="stream position frames (every --snapshot-every "
                        "steps) to this .p3t trajectory file")
    r.set_defaults(fn=_cmd_run)

    rp = sub.add_parser("replay", help="render a recorded trajectory to GIF")
    rp.add_argument("--traj", required=True)
    rp.add_argument("--gif", required=True)
    rp.add_argument("--every", type=int, default=1)
    rp.add_argument("--fps", type=int, default=20)
    rp.add_argument("--width", type=int, default=480)
    rp.add_argument("--height", type=int, default=360)
    rp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    rp.set_defaults(fn=_cmd_replay)

    s = sub.add_parser("serve", help="interactive browser UI")
    s.add_argument("--preset", default="reference")
    s.add_argument("--n", type=int, default=None)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    s.set_defaults(fn=_cmd_serve)

    c = sub.add_parser("resume", help="resume from a checkpoint")
    c.add_argument("--checkpoint", required=True)
    c.add_argument("--steps", type=int, default=100)
    c.add_argument("--dt", type=float, default=1.0 / 60.0)
    c.add_argument("--out", default=None)
    c.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    c.set_defaults(fn=_cmd_resume)

    sl = sub.add_parser("slab", help="stay-sharded slab run of a SLAB_RUNS "
                                     "configuration (torchrun for several ranks)")
    # not --run: torchrun would take it for an abbreviation of its --run-path
    sl.add_argument("--config", default="slab_2m")
    sl.add_argument("--steps", type=int, default=10)
    sl.add_argument("--seed", type=int, default=0)
    sl.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sl.set_defaults(fn=_cmd_slab)

    t = sub.add_parser("tune", help="time candidate cell geometries of a "
                                    "preset on the card")
    t.add_argument("--preset", default="particle_life_large")
    t.add_argument("--n", type=int, default=None)
    t.add_argument("--steps", type=int, default=8,
                   help="steps per timing window")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    t.set_defaults(fn=_cmd_tune)

    b = sub.add_parser("bench", help="time the port's paths and assert their "
                                     "exactness gates (one JSON line)")
    b.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    b.set_defaults(fn=_cmd_bench)

    ls = sub.add_parser("presets", help="list ported scene presets")
    ls.set_defaults(fn=_cmd_presets)

    a = p.parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":
    main()
