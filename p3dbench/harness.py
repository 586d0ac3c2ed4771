"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the plain reference, and the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` at the root
of the checkout lists the cells and metrics, ``configs/<config>.json``
holds a configuration as it is run, ``traffic/<traffic>.json`` a traffic
mix, whose ``driver`` names the module of ``drivers/`` that runs it, and
``metrics/<name>.py`` the reader of a per-layer metric (its
``read(summary)`` returns the value, or None when it finds nothing to
read).

A driver module defines ``Cell(config, traffic, seed, device)`` with ``setup()``, ``window(seconds) -> {metric: value}``,
``traced() -> steps`` (the profiled sub-window; an optional
``before_trace()`` runs just before it), ``summary(trace) -> dict`` (what
the metric readers read), ``context() -> [lines]``, ``release()`` (frees
the program's state once its outputs are kept) and ``check() -> [(name,
value, limit)]``; a comparison holds when its value is at most its
limit. The count of units of work run is ``units``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "particle3d_tpu")


def say(msg: str):
    print(f"[p3dbench] {msg}", file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(bench: dict, workload: str):
    """(workload entry, configuration entry) of a cell named in
    ``BENCHMARK.json``."""
    wl = {w["name"]: w for w in bench["workloads"]}
    if workload not in wl:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"one of {sorted(wl)}")
    w = wl[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return w, cfg


def load_config(entry: dict, root: Path = ROOT) -> dict:
    return json.loads((root / entry["file"]).read_text())


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def load_driver(name: str):
    return importlib.import_module(f"p3dbench.drivers.{name}")


def load_reader(name: str):
    """The module ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"p3dbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The metric entries this cell reports in a run of this kind."""
    kind = "per_layer" if traced else "end_to_end"
    e2e = {m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])}
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])
            and (not traced or m["moves"] in e2e)]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, overrides=None, bench: dict | None = None, say=None):
    """Run one cell once. Returns ``(result, checks)``: the result line's
    object and the comparisons [(name, value, limit)]. ``overrides``
    replaces configuration and traffic values (tests run cells at small
    sizes on the CPU)."""
    from . import trace as tr

    say = say or (lambda msg: None)
    bench = bench or load_benchmark()
    wl, centry = cell_spec(bench, workload)
    config = {**load_config(centry), **(overrides or {}).get("config", {})}
    traffic = {**load_traffic(wl["traffic"]),
               **(overrides or {}).get("traffic", {})}
    driver = load_driver(traffic["driver"])
    cell = driver.Cell(config, traffic, seed, device)
    cell.setup()
    _sync(device)
    setup_s = process_age_s()
    cuda = torch.device(device).type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    metrics = {}
    summary = None
    if trace:
        getattr(cell, "before_trace", lambda: None)()
        with tr.traced(device) as t:
            steps = cell.traced()
        summary = cell.summary(tr.Trace.from_profiler(t, steps))
        metrics = {m["name"]: load_reader(m["name"]).read(summary)
                   for m in metrics_of(bench, workload, True)}
    else:
        metrics.update(cell.window(seconds))
        metrics["setup_s"] = setup_s
    _sync(device)
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    if not trace and cuda:
        # the device memory the window's work held at its peak
        metrics["memory_peak_gb"] = peak_window / 1e9
    say(f"device memory peak: set-up {peak_setup} B, window {peak_window} B")
    for line in cell.context():
        say(line)
    cell.release()
    t0 = time.perf_counter()
    checks = cell.check()
    say(f"comparison with the reference: {time.perf_counter() - t0:.1f} s")
    out_metrics = {m["name"]: {"value": metrics[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench, workload, trace)
                   if metrics.get(m["name"]) is not None}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1,
                "memory_peak_bytes": max(peak_setup, peak_window)}
    failed = sum(1 for _, v, lim in checks if not v <= lim)
    result = {"correct": failed == 0, "attempted": cell.units,
              "failed": failed, "metrics": out_metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["limits"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks
