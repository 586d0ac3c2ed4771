"""Where a slab run's masked rows come from: the scene or the port.

    python -m particle3d_tpu_torch.utils.slab_census [--config slab_2m]
        [--seed 0] [--steps 20]

Runs a ``models.presets.SLAB_RUNS`` configuration on one rank from
``init_sharded_dense(seed)`` (the ``slab`` command's scene; its generator
draws on the card, so this runs on the GPU only), in windows of 1, 2, ..
``--steps`` steps from the same initial carry: each window is a prefix of
the longest, so the first window that reports masked rows ends on the step
where they first appear. For that carry it counts, with numpy, the live
rows (occupied slots and limbo) of every cell against the capacity. A cell
holding more rows than ``cap`` forces masked rows when the configuration
has no sidecar (``ocap`` 0): then the scene causes them, and the excess
over the capacity should match the masked count. Prints one JSON line per
window up to that step.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def census(carry, cfg, nsc: int, cap: int) -> dict:
    """Rows per cell of a one-rank carry, counted on the host."""
    from ..ops.celllist_sweep import bin_sid

    data, pid, ld, lp, _ = carry
    pos = torch.cat([data[pid >= 0][:, :3], ld[lp >= 0][:, :3]])
    cells = bin_sid(pos, cfg, nsc).cpu().numpy()
    count = np.bincount(cells, minlength=nsc ** 3)
    over = count > cap
    return {"rows": int(count.sum()), "max_per_cell": int(count.max()),
            "mean_per_cell": float(count.mean()),
            "cells_over_cap": int(over.sum()),
            "rows_over_cap": int((count[over] - cap).sum()),
            "limbo_rows": int((lp >= 0).sum())}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="slab_2m")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=20)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("slab_census: no CUDA device; the scene is drawn on "
                         "the GPU")
    from ..models.presets import slab_run
    from ..parallel import init_sharded_dense, make_mesh, sharded_dense_steps

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    n, cfg, dt, kw = slab_run(a.config)
    mesh = make_mesh(1, device="cuda")
    init = init_sharded_dense(a.seed, n, cfg, mesh, nsc=kw["nsc"],
                              cap=kw["cap"], migcap=kw["migcap"])
    base = {"config": a.config, "seed": a.seed, "n": n, "cap": kw["cap"],
            "ocap": kw["ocap"], "device": smi}
    print(json.dumps({**base, "steps": 0,
                      **census(init, cfg, kw["nsc"], kw["cap"])}), flush=True)
    for s in range(1, a.steps + 1):
        carry, (mov, mask, limbo, lost, _) = sharded_dense_steps(
            init, cfg, dt, s, mesh, n=n, **kw)
        rec = {**base, "steps": s, "max_masked": int(mask),
               "max_limbo": int(limbo), "lost": int(lost),
               "max_movers": int(mov)}
        if int(mask):
            rec.update(census(carry, cfg, kw["nsc"], kw["cap"]))
        print(json.dumps(rec), flush=True)
        if int(mask):
            return 0
    print(json.dumps({**base, "steps": a.steps, "masked": 0,
                      **census(carry, cfg, kw["nsc"], kw["cap"])}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
