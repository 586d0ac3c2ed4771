"""Readings that the limits of ``correct`` are set from: the program's
comparisons on many seeds and the control's (the plain reference in the
next lower precision, in the program's place) on a few, at a cell's own
size, in one process. Not run by the benchmark's own runs.

    python3 p3dbench/control.py --workload pl262k.run --seeds 11-22 \\
        --control-seeds 31-33

Prints one JSON line a seed: ``{"side": "program"|"control", "seed": s,
"readings": {name: value}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out += list(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def readings(workload, seed, side, overrides, device):
    """One seed's comparisons: the program's (set-up, one traced unit of
    work, the check) or the control's."""
    from p3dbench import harness

    bench = harness.load_benchmark()
    wl, centry = harness.cell_spec(bench, workload)
    ov = overrides or {}
    config = {**harness.load_config(centry), **ov.get("config", {})}
    traffic = {**harness.load_traffic(wl["traffic"]), **ov.get("traffic", {})}
    driver = harness.load_driver(traffic["driver"])
    if side == "control":
        checks = driver.control_checks(config, traffic, seed, device)
    else:
        cell = driver.Cell(config, traffic, seed, device)
        cell.setup()
        cell.traced()
        cell.release()
        checks = cell.check()
    return {n: v for n, v, _ in checks}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    a = p.parse_args(argv)
    import torch

    device = torch.device("cuda", 0)
    for side, ss in (("program", seeds(a.seeds)),
                     ("control", seeds(a.control_seeds))):
        for s in ss:
            t0 = time.perf_counter()
            r = readings(a.workload, s, side, None, device)
            torch.cuda.empty_cache()
            print(json.dumps({"side": side, "seed": s, "readings": r,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)


if __name__ == "__main__":
    main()
