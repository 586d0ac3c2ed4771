"""Where the time of the exact main path goes (counterpart of the JAX
package's ``utils.profiling``).

    python -m particle3d_tpu_torch.utils.profiling --out build/profile
    python -m particle3d_tpu_torch.utils.profiling --preset particle_life_large \\
        --cap 64 --out build/profile

For each preset: the all-in ms/step of a 16-step and a 32-step
``simulate_dense`` window (best of two, after a warm-up), the marginal
ms/step between them, and a ``torch.profiler`` run over one 16-step window
giving the device's busy time (kernel events only), its idle share against
the unprofiled window of the same length (the profiler slows the host),
kernel launches per step and the largest kernels.
Writes ``profile.json`` plus each preset's kernel table and Chrome trace to
``--out``; prints one JSON line per preset.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

WINDOW = 16


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _wall_s(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def profile_window(state, cfg, dt, steps: int = WINDOW, top: int = 25,
                   trace_path: str | None = None):
    """Time and profile ``simulate_dense`` windows from ``state``. Device
    fields are None when the state is not on a CUDA device."""
    from ..engine.step import simulate_dense

    device = state.positions.device
    run = lambda k: simulate_dense(state, cfg, dt, k)  # noqa: E731
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
    rec = {"n": state.n, "cell_capacity": cfg.cell_capacity, "steps": steps,
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
    for preset in a.preset or ["particle_life_large", "particle_life_1m"]:
        state, cfg, dt = make_scene(preset, seed=a.seed, n=a.n, device=device)
        if a.cap is not None:
            cfg = cfg.replace(cell_capacity=a.cap)
        tag = preset if a.cap is None else f"{preset}_cap{a.cap}"
        rec, ka = profile_window(
            state, cfg, dt, a.steps,
            trace_path=os.path.join(a.out, f"trace_{tag}.json"))
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
