"""Command-line interface of the PyTorch port.

    python -m particle3d_tpu_torch run --preset particle_life_large --steps 48
    python -m particle3d_tpu_torch run --preset reference --steps 5 --device cpu
    python -m particle3d_tpu_torch presets
    python -m particle3d_tpu_torch slab --config slab_8m --steps 10
    torchrun --nproc_per_node=4 -m particle3d_tpu_torch slab --config slab_8m

``run`` prints one JSON line: the JAX package's fields plus the number of
force-kernel launches (``kernel_launches``, with one count per kernel in
``kernel_launches_by_kernel``) and, for the cell-list presets, the capacity
ladder's history. ``--device cuda`` (the default) never falls back to the
CPU.

``slab`` runs a ``models.presets.SLAB_RUNS`` configuration on the slab
decomposition, stay-sharded: one rank by default, or every rank of a
torchrun launch (one process per card, NCCL). After one untimed step,
rank 0 prints one JSON line with the timed window's ms/step and
diagnostics.
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

    sl = sub.add_parser("slab", help="stay-sharded slab run of a SLAB_RUNS "
                                     "configuration (torchrun for several ranks)")
    # not --run: torchrun would take it for an abbreviation of its --run-path
    sl.add_argument("--config", default="slab_2m")
    sl.add_argument("--steps", type=int, default=10)
    sl.add_argument("--seed", type=int, default=0)
    sl.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sl.set_defaults(fn=_cmd_slab)

    ls = sub.add_parser("presets", help="list ported scene presets")
    ls.set_defaults(fn=_cmd_presets)

    a = p.parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":
    main()
