"""Cell-geometry tuner for the production cell-list path (port of
``particle3d_tpu.utils.tune``).

``cell_grid`` (supercells per axis) and ``cell_capacity`` (slots per
supercell) fix the shapes of K1 and of the dense layout, and their product
drives every per-slot cost of the step. The best pair depends on N, the
box, the cutoff and how strongly the scene clusters, so ``tune`` measures
it: it times fenced whole windows of ``simulate_dense`` on the state's
device at each candidate and ranks mask-free geometries first.

K1 takes any capacity, so every raw capacity is a candidate: the list is
the JAX package's with ``require_aligned=False`` (Mosaic's alignment model
is not ported). A candidate that fails is a fault and raises: the JAX
module skips failing candidates because Mosaic may refuse to compile one,
which has no counterpart here.

    python -m particle3d_tpu_torch tune --preset particle_life_large
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass
class TuneResult:
    nsc: int
    cap: int
    ms_per_step: float
    steps_per_s: float
    max_movers: int
    capacity_masked: int

    def as_dict(self):
        return dataclasses.asdict(self)


def effective_cutoff(cfg) -> float:
    r = float(np.asarray(cfg.particle_effect_radius))
    return min(r, 1.0) if cfg.force_law == "particle_life" else r


def candidate_geometries(cfg, n: int, max_candidates: int = 8):
    """(nsc, cap) pairs with cell width >= the cutoff and capacities of
    1.25-4x the mean occupancy (the sidecar serves the tail above the
    mean), densest grid first."""
    w = float(np.asarray(cfg.world_size))
    nsc_max = max(3, int(w / effective_cutoff(cfg) + 1e-6))
    out = []
    for nsc in range(nsc_max, max(2, nsc_max // 2 - 1), -1):
        mean_occ = n / float(nsc ** 3)
        caps = {max(2, int(-(-mean_occ * s // 1)))
                for s in (1.25, 1.5, 2.0, 2.5, 3.0, 4.0)}
        out += [(nsc, cap) for cap in sorted(caps)]
        if len(out) >= max_candidates:
            break
    return out[:max_candidates]


def tune(state, cfg, dt, steps: int = 16, candidates=None, verbose=print,
         reps: int = 3):
    """Time each candidate geometry on the state's device; returns
    TuneResults ranked mask-free first, then fastest.

    Each candidate runs one warm ``steps``-step ``simulate_dense`` window
    (which also gives the masking diagnostic), then ``reps`` timed windows,
    each fenced by a host read of a reduction of the output positions: the
    cost a caller of whole windows pays. Geometries that mask rows stay in
    the list but rank after every exact one (a masked step is not the same
    work)."""
    from ..engine.step import simulate_dense

    if candidates is None:
        candidates = candidate_geometries(cfg, state.n)
    if not candidates:
        raise ValueError("no valid cell geometries for this config")

    def fenced(x):
        return float(torch.sum(x.reshape(-1)[:8]))

    results = []
    for nsc, cap in candidates:
        cfg2 = cfg.replace(neighbor="celllist_pallas", cell_grid=nsc,
                           cell_capacity=cap)
        out, diag = simulate_dense(state, cfg2, dt, steps)
        fenced(out.positions)
        t0 = time.perf_counter()
        for _ in range(reps):
            out, _ = simulate_dense(state, cfg2, dt, steps)
            fenced(out.positions)
        sec = max((time.perf_counter() - t0) / reps / steps, 1e-9)
        res = TuneResult(nsc=nsc, cap=cap, ms_per_step=sec * 1e3,
                         steps_per_s=1.0 / sec, max_movers=int(diag[0]),
                         capacity_masked=int(diag[1]))
        results.append(res)
        if verbose:
            verbose(f"[tune] nsc={nsc:3d} cap={cap:3d}: "
                    f"{res.ms_per_step:8.2f} ms/step "
                    f"({res.steps_per_s:6.1f} steps/s), "
                    f"masked {res.capacity_masked}")
    results.sort(key=lambda r: (r.capacity_masked > 0, r.ms_per_step))
    return results
