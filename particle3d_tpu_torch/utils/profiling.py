"""Where the time of the exact main path goes (counterpart of the JAX
package's ``utils.profiling``).

    python -m particle3d_tpu_torch.utils.profiling --out build/profile
    python -m particle3d_tpu_torch.utils.profiling --preset particle_life_large \\
        --cap 64 --out build/profile
    python -m particle3d_tpu_torch.utils.profiling --path culled \\
        --preset particle_life_large --out build/profile
    python -m particle3d_tpu_torch.utils.profiling --path cadenced \\
        --preset particle_life_large --cap 64 --out build/profile
    python -m particle3d_tpu_torch.utils.profiling --path slab \\
        --preset slab_8m --steps 4 --out build/profile
    python -m particle3d_tpu_torch.utils.profiling --path simulate \\
        --preset particle_life_large_allpairs --neighbor allpairs_mxu \\
        --steps 4 --out build/profile

For each preset: the all-in ms/step of a 16-step and a 32-step window of
the chosen path (best of two, after a warm-up): ``dense``
(``simulate_dense``, the default), ``cadenced`` (``simulate_cadenced``,
the layout rebuilt every ``--rebuild-every`` steps, 4 by default: the
app's batch), ``culled`` (``simulate_culled``, one
Morton sort per window), ``simulate`` (the preset's own backend,
e.g. ``allpairs_pallas``, or ``--neighbor``'s: the K5 path has no preset
of its own) or ``slab`` (``sharded_dense_steps`` on a
1-rank mesh, from an ``init_sharded_dense`` carry of a
``models.presets.SLAB_RUNS`` entry, named as the preset); the marginal
ms/step between them, and a ``torch.profiler`` run over one 16-step window
giving the device's busy time (kernel events only), its idle share against
the unprofiled window of the same length (the profiler slows the host),
kernel launches per step and the largest kernels.
Writes ``profile.json`` plus each preset's kernel table and Chrome trace to
``--out``; prints one JSON line per preset.

``StepTimer`` is the app's rolling wall-clock timer; its callers
synchronise the card before the block it times ends. ``benchmark_steps``
times calls of a function with the card synchronised around the clock,
and ``trace`` records a ``torch.profiler`` trace of a block under a
directory (the JAX package's helpers of the same names).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import time

import torch
from torch.profiler import (ProfilerActivity, profile,
                            tensorboard_trace_handler)

WINDOW = 16


class StepTimer:
    """Rolling wall-clock timer (EMA) of a ``with`` block. The block must
    end with the card synchronised, or the timer reads the enqueue."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema_s: float | None = None
        self.last_s: float = 0.0
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.last_s = time.perf_counter() - self._t0
        self.ema_s = (self.last_s if self.ema_s is None
                      else self.alpha * self.last_s
                      + (1 - self.alpha) * self.ema_s)
        return False

    @property
    def ema_ms(self) -> float:
        return 1000.0 * (self.ema_s or 0.0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cuda_devices(x, found=None) -> set:
    """The CUDA devices of the tensors in ``x``, found by walking tuples,
    lists, dicts and dataclasses."""
    found = set() if found is None else found
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _cuda_devices(y, found)
    elif isinstance(x, dict):
        for y in x.values():
            _cuda_devices(y, found)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), found)
    return found


def _sync_result(out):
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def benchmark_steps(fn, *args, warmup: int = 1, iters: int = 5):
    """Time ``fn(*args)``: ``warmup`` untimed calls, then ``iters`` calls
    between two synchronisations of the devices of the tensors ``fn``
    returns. Returns (seconds_per_call, last_result)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync_result(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync_result(out)
    return (time.perf_counter() - t0) / iters, out


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA kernels when a card is present) and write it under ``log_dir`` in
    the TensorBoard plugin's format (``*.pt.trace.json``, a Chrome trace).
    Yields the profiler, whose ``key_averages()`` hold the same events."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _wall_s(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


PATHS = ("dense", "cadenced", "culled", "simulate", "slab")


def _path_fn(path: str, rebuild_every: int = 4):
    from ..engine import step as engine

    if path == "dense":
        return engine.simulate_dense
    if path == "cadenced":
        return lambda st, cfg, dt, k: engine.simulate_cadenced(
            st, cfg, dt, k, rebuild_every=rebuild_every)
    if path == "culled":
        return lambda st, cfg, dt, k: engine.simulate_culled(st, cfg, dt, k,
                                                             window=k)
    if path == "simulate":
        return engine.simulate
    raise ValueError(f"unknown path {path!r}; one of {PATHS}")


def _slab_scene(name: str, device):
    """(run, n, cfg) of a 1-rank slab window from a SLAB_RUNS entry."""
    from ..models.presets import slab_run
    from ..parallel import init_sharded_dense, make_mesh, sharded_dense_steps

    n, cfg, dt, kw = slab_run(name)
    mesh = make_mesh(1, device=device)
    carry = init_sharded_dense(5, n, cfg, mesh, nsc=kw["nsc"], cap=kw["cap"],
                               migcap=kw["migcap"])
    return (lambda k: sharded_dense_steps(carry, cfg, dt, k, mesh, n=n, **kw),
            n, cfg)


def profile_window(state, cfg, dt, steps: int = WINDOW, top: int = 25,
                   trace_path: str | None = None, path: str = "dense",
                   rebuild_every: int = 4):
    """Time and profile windows of ``path`` from ``state``. Device fields
    are None when the state is not on a CUDA device."""
    fn = _path_fn(path, rebuild_every)
    return _measure(lambda k: fn(state, cfg, dt, k), state.n,
                    state.positions.device, cfg, path, steps, top, trace_path)


def _measure(run, n: int, device, cfg, path: str, steps: int, top: int,
             trace_path: str | None):
    """profile_window's measurements of ``run(k)``, which runs k steps."""
    for k in (steps, 2 * steps):
        run(k)
    times = {steps: [], 2 * steps: []}
    for _ in range(2):
        for k in times:
            times[k].append(_wall_s(lambda: run(k), device))
    t1, t2 = min(times[steps]), min(times[2 * steps])
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        wall = _wall_s(lambda: run(steps), device)
    if trace_path:
        prof.export_chrome_trace(trace_path)
    ka = prof.key_averages()
    rec = {"n": n, "path": path, "neighbor": cfg.neighbor,
           "cell_capacity": cfg.cell_capacity, "steps": steps,
           "window_ms_per_step": t1 / steps * 1e3,
           "window2_ms_per_step": t2 / (2 * steps) * 1e3,
           "marginal_ms_per_step": (t2 - t1) / steps * 1e3,
           "profiled_wall_ms_per_step": wall / steps * 1e3,
           "device_busy_ms_per_step": None, "device_idle_share": None,
           "kernels_per_step": None, "top_kernels_ms_per_step": None}
    if cuda:
        kern = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        rows = sorted(kern, key=lambda e: -e.self_device_time_total)[:top]
        rec.update(
            device_busy_ms_per_step=busy_ms / steps,
            device_idle_share=1.0 - busy_ms / (t1 * 1e3),
            kernels_per_step=sum(e.count for e in kern) / steps,
            top_kernels_ms_per_step=[
                [e.key[:60], e.self_device_time_total / 1e3 / steps,
                 e.count / steps] for e in rows])
    return rec, ka


def main(argv=None):
    from ..models import make_scene

    p = argparse.ArgumentParser(prog="particle3d_tpu_torch.utils.profiling",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", action="append",
                   help="preset to profile (repeatable; default: "
                        "particle_life_large and particle_life_1m)")
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--cap", type=int, default=None,
                   help="override the preset's cell capacity")
    p.add_argument("--steps", type=int, default=WINDOW)
    p.add_argument("--path", choices=PATHS, default="dense")
    p.add_argument("--rebuild-every", type=int, default=4,
                   help="layout rebuilds of the cadenced path, in steps")
    p.add_argument("--neighbor", default=None,
                   help="override the preset's force backend")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=os.path.join("build", "profile"))
    a = p.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    os.makedirs(a.out, exist_ok=True)
    res = {}
    default = (["slab_8m", "slab_2m"] if a.path == "slab"
               else ["particle_life_large", "particle_life_1m"])
    for preset in a.preset or default:
        tag = preset if a.cap is None else f"{preset}_cap{a.cap}"
        if a.path not in ("dense", "slab"):
            tag = f"{tag}_{a.path}"
        if a.neighbor is not None:
            tag = f"{tag}_{a.neighbor}"
        trace = os.path.join(a.out, f"trace_{tag}.json")
        if a.path == "slab":
            run, n, cfg = _slab_scene(preset, device)
            rec, ka = _measure(run, n, device, cfg, a.path, a.steps, 25, trace)
        else:
            state, cfg, dt = make_scene(preset, seed=a.seed, n=a.n,
                                        device=device)
            if a.cap is not None:
                cfg = cfg.replace(cell_capacity=a.cap)
            if a.neighbor is not None:
                cfg = cfg.replace(neighbor=a.neighbor)
            rec, ka = profile_window(state, cfg, dt, a.steps, trace_path=trace,
                                     path=a.path,
                                     rebuild_every=a.rebuild_every)
        table = ka.table(sort_by="self_cuda_time_total" if device.type == "cuda"
                         else "self_cpu_time_total", row_limit=40)
        with open(os.path.join(a.out, f"profile_{tag}.txt"), "w") as f:
            f.write(table)
        res[tag] = rec
        print(json.dumps({tag: {k: v for k, v in rec.items()
                                if k != "top_kernels_ms_per_step"}}))
        for row in rec["top_kernels_ms_per_step"] or []:
            print("   ", row)
    with open(os.path.join(a.out, "profile.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
