"""Command-line interface of the PyTorch port.

    python -m particle3d_tpu_torch run --preset particle_life_large --steps 48
    python -m particle3d_tpu_torch run --preset reference --steps 5 --device cpu
    python -m particle3d_tpu_torch presets

``run`` prints one JSON line: the JAX package's fields plus the number of
force-kernel launches (``kernel_launches``, with one count per kernel in
``kernel_launches_by_kernel``) and, for the cell-list presets, the capacity
ladder's history. ``--device cuda`` (the default) never falls back to the
CPU.
"""

from __future__ import annotations

import argparse
import json
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


def _cmd_run(a):
    from .engine.step import warmup
    from .models import make_scene
    from .ops import kernel_launches
    from .utils.metrics import measure_metrics

    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu to run the plain torch path)")
    state, cfg, dt = make_scene(a.preset, seed=a.seed, n=a.n, device=device)
    if a.dt:
        dt = a.dt
    launches0 = kernel_launches()
    _sync(device)
    t0 = time.perf_counter()
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
    return rec


def _cmd_presets(a):
    from .models import list_presets

    for p in list_presets():
        print(p)


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
    r.set_defaults(fn=_cmd_run)

    ls = sub.add_parser("presets", help="list ported scene presets")
    ls.set_defaults(fn=_cmd_presets)

    a = p.parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":
    main()
