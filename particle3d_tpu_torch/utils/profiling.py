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
of its own), ``slab`` (``sharded_dense_steps`` on a
1-rank mesh, from an ``init_sharded_dense`` carry of a
``models.presets.SLAB_RUNS`` entry, named as the preset), ``adaptive``
(``simulate_dense_adaptive``, the capacity ladder in 64-step windows) or
``app`` (a ``SimulationApp``'s ``run_steps`` batches of
``--rebuild-every`` steps); the marginal ms/step between them, and a
``torch.profiler`` run over one 16-step window giving the device's busy
time (the union of its operations' intervals), its idle share against
that profiled window's wall time, kernel launches per step, the largest
kernels, and each of the port's spans (self ms a step, spans a step) and
counters (a step) recorded in the window.
Writes ``profile.json`` plus each preset's kernel table and Chrome trace to
``--out``; prints one JSON line per preset.

``StepTimer`` is the app's rolling wall-clock timer; its callers
synchronise the card before the block it times ends. ``benchmark_steps``
times calls of a function with the card synchronised around the clock,
and ``trace`` records a ``torch.profiler`` trace of a block under a
directory (the JAX package's helpers of the same names).

The port's own spans and counters: ``span(name, **attrs)`` around a
phase, ``host_sync(name)`` around a call that blocks on the card (a span
that also counts ``host_syncs``), ``count(name, n)``. They record only
while a ``torch.profiler`` session records (torch's own flag,
``torch.autograd.profiler._is_profiler_enabled``), so any profiled run
collects them and nothing else does; off, a call reads the flag and
returns one shared null context. Times are ``time.perf_counter()`` on the
host: nothing is launched on, waited for or read from the card.
``recorded()`` gives the latest session's spans and counters.
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
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import (ProfilerActivity, profile,
                            tensorboard_trace_handler)

WINDOW = 16


class Span:
    """One recorded span: ``parent`` is the index of the enclosing span in
    its recording (-1 for none), ``start`` and ``end`` are
    ``time.perf_counter()`` seconds."""

    __slots__ = ("name", "attrs", "parent", "start", "end", "_rec")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Add attributes known only once the span's work has run."""
        self.attrs.update(attrs)

    def __enter__(self):
        rec = self._rec = _recording_now()
        self.parent = rec._open[-1] if rec._open else -1
        rec._open.append(len(rec.spans))
        rec.spans.append(self)
        self.end = None
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        self._rec._open.pop()
        return False


class _NullSpan:
    """What ``span`` returns while nothing records: one shared instance."""

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class Recording:
    """The spans (in the order they started) and the counters of one
    profiler session."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._open: list[int] = []

    def innermost(self) -> Span | None:
        """The innermost span still open."""
        return self.spans[self._open[-1]] if self._open else None

    def self_seconds(self) -> list[float]:
        """Each span's duration less the time its child spans cover."""
        out = [s.end - s.start for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.end - s.start
        return out


_recording = Recording()
_live = False  # _recording belongs to the session now recording


def _recording_now() -> Recording:
    """The running session's recording; its first span or count opens a
    new one."""
    global _recording, _live
    if not _live:
        _recording, _live = Recording(), True
    return _recording


def _idle():
    """Called while no session records: the next one starts afresh."""
    global _live
    _live = False
    return _NULL


def span(name: str, **attrs):
    """A span of the port's own work, recorded while a ``torch.profiler``
    session records; otherwise a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _idle() if _live else _NULL
    return Span(name, attrs)


def host_sync(name: str):
    """``span(name)`` around one call that blocks until the card has run
    what was queued (a read of a device value, a blocking copy, a
    synchronise); each also counts one ``host_syncs``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _idle() if _live else _NULL
    count("host_syncs")
    return Span(name, {})


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter of the recording session."""
    if _autograd_profiler._is_profiler_enabled:
        c = _recording_now().counters
        c[name] = c.get(name, 0) + n
    elif _live:
        _idle()


def recorded() -> Recording:
    """The spans and counters of the latest recording session."""
    if not _autograd_profiler._is_profiler_enabled:
        _idle()
    return _recording


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


PATHS = ("dense", "cadenced", "culled", "simulate", "slab", "adaptive", "app")


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
    if path == "adaptive":
        return engine.simulate_dense_adaptive
    if path == "app":
        return lambda st, cfg, dt, k: _app_batches(st, cfg, dt, k,
                                                   rebuild_every)
    raise ValueError(f"unknown path {path!r}; one of {PATHS}")


def _app_batches(state, cfg, dt, k: int, batch: int):
    """k steps of a fresh ``SimulationApp`` on ``state``, in
    ``run_steps(batch)`` calls (the last one shorter)."""
    from ..app.driver import SimulationApp

    app = SimulationApp(state=state, cfg=cfg, device=state.positions.device,
                        update_rate=1.0 / float(dt))
    for done in range(0, k, batch):
        app.run_steps(min(batch, k - done))
    return app.state


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


def _union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def span_table(rec: Recording, steps: int) -> dict:
    """{span name: [self ms a step, spans a step]}, most self time first."""
    tot = {}
    for s, t in zip(rec.spans, rec.self_seconds()):
        ms, calls = tot.get(s.name, (0.0, 0))
        tot[s.name] = (ms + t * 1e3, calls + 1)
    return {n: [ms / steps, calls / steps] for n, (ms, calls) in
            sorted(tot.items(), key=lambda kv: -kv[1][0])}


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
    spans = recorded()
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
           "kernels_per_step": None, "top_kernels_ms_per_step": None,
           "span_self_ms_per_step": span_table(spans, steps),
           "counters_per_step": {k: v / steps for k, v in
                                 sorted(spans.counters.items())}}
    if cuda:
        dev_t = torch.autograd.DeviceType.CUDA
        # the union of the device's operations, so that work overlapping
        # on two streams counts once; idle against the profiled window
        busy_ms = _union_s((e.time_range.start, e.time_range.end)
                           for e in prof.events()
                           if e.device_type == dev_t) / 1e3
        kern = [e for e in ka if e.device_type == dev_t]
        rows = sorted(kern, key=lambda e: -e.self_device_time_total)[:top]
        rec.update(
            device_busy_ms_per_step=busy_ms / steps,
            device_idle_share=1.0 - busy_ms / (wall * 1e3),
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
        tables = ("top_kernels_ms_per_step", "span_self_ms_per_step",
                  "counters_per_step")
        print(json.dumps({tag: {k: v for k, v in rec.items()
                                if k not in tables}}))
        for row in rec["top_kernels_ms_per_step"] or []:
            print("   ", row)
        for name, (ms, calls) in rec["span_self_ms_per_step"].items():
            print(f"    span {name}: {ms:.4f} ms self, {calls:g} a step")
        for name, v in rec["counters_per_step"].items():
            print(f"    counter {name}: {v:g} a step")
    with open(os.path.join(a.out, "profile.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    # ``python -m`` runs a second copy of this module; the port's spans
    # record into the package's, so run that one's ``main``
    from particle3d_tpu_torch.utils.profiling import main as _main

    _main()
