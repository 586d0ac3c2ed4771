"""Run one cell of the benchmark once and print its result line.

    python3 p3dbench/run.py --workload pl262k.run --seed 7 --seconds 30 --trace 0

Set-up (the program's kernels built once into the checkout's ``build/``,
the scene drawn from ``--seed`` on the card, one warm-up of the cell's own
shapes), then ``--seconds`` of measured work (``--trace 0``: the cell's
end-to-end metrics) or a bounded profiled sub-window (``--trace 1``: its
per-layer metrics), then the comparison with the plain reference. The
last line of standard output is one JSON object; the last lines of
standard error give each compared number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# caches of anything that compiles at run time, at fixed paths inside the
# checkout (the program's own kernels build into ``build/kernels``)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    # one process, one host thread for the program's CPU-side operations:
    # idle worker threads spinning beside the launching thread would make
    # the host-bound rates swing between processes
    torch.set_num_threads(1)
    from p3dbench import harness
    from p3dbench.harness import say

    bench = harness.load_benchmark()
    wl, _ = harness.cell_spec(bench, a.workload)
    chips = int(wl["chips"])
    if not torch.cuda.is_available():
        say("no CUDA device: the benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < chips:
        say(f"{a.workload} needs {chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    result, checks = harness.run_cell(a.workload, a.seed, a.seconds,
                                      bool(a.trace), torch.device("cuda", 0),
                                      bench=bench, say=say)
    found = harness.forbidden_modules()
    if found:
        say(f"modules of JAX or the JAX package loaded: {found}")
        return 3
    for name, value, limit in checks:
        say(f"check {name} {value!r} limit {limit!r} "
            f"{'ok' if value <= limit else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
