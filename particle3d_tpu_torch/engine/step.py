"""Simulation step, trajectories and the exact dense-layout drivers
(PyTorch port of ``particle3d_tpu.engine.step``).

The step is eager PyTorch around the force kernel; loops that the JAX
package runs under ``lax.scan`` are Python loops here. Euler reproduces the
reference update order exactly:

    1. v += force_sum * kick * dt      2. v += gravity * dt
    3. stop-at-zero drag               4. x += v * dt      5. boundary

Config scalars and ``dt`` are float32 (``config.f32``) as in the JAX
package, which traces them as float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, f32
from ..state import ParticleState
from ..ops import forces as F
from ..ops.allpairs import allpairs_forces
from .boundaries import apply_boundary

# backends whose kernels are not ported yet, and where ROADMAP.md lists them
_NOT_PORTED = {
    "allpairs_pallas": "the all-pairs kernels K2/K3 (ROADMAP.md queue 2)",
    "allpairs_culled": "the culled all-pairs kernel K4 (ROADMAP.md queue 2)",
    "allpairs_mxu": "the MXU all-pairs kernel K5 (ROADMAP.md queue 2)",
    "celllist": "the XLA-style cell list (ROADMAP.md queue 1, 'all-pairs backends')",
}


def _vec3(values, like: torch.Tensor) -> torch.Tensor:
    """f32[3] on ``like``'s device, built by fills (no host copy)."""
    return torch.stack([F.scalar_like(x, like) for x in np.asarray(values)])


def pair_accel(positions, state: ParticleState, cfg: SimConfig):
    """Pairwise-interaction acceleration at ``positions``, dispatched on
    ``cfg.neighbor``."""
    u, v = F.pair_features(state, cfg)
    if cfg.neighbor == "allpairs":
        f = allpairs_forces(positions, u, v, cfg)
    elif cfg.neighbor == "celllist_pallas":
        from ..ops.celllist_sweep import fresh_celllist_forces

        f = fresh_celllist_forces(positions, u, v, cfg)
    elif cfg.neighbor in _NOT_PORTED:
        raise NotImplementedError(
            f"neighbor backend {cfg.neighbor!r} needs "
            f"{_NOT_PORTED[cfg.neighbor]}, not ported yet")
    else:
        raise ValueError(f"unknown neighbor backend {cfg.neighbor!r}")
    return f * float(F.kick_scale(cfg))


def _drag(v, cfg: SimConfig, dt):
    """Stop-at-zero drag: zero v iff |coefficient * dt| > 1."""
    c = f32(cfg.coefficient) * f32(dt)
    if abs(c) > 1.0:
        return torch.zeros_like(v)
    return v - v * float(c)


def _total_accel(positions, state, cfg, accel_fn):
    return accel_fn(positions, state, cfg) + _vec3(cfg.acceleration, positions)


def _step_euler(state: ParticleState, cfg: SimConfig, dt, accel_fn):
    dtf = float(f32(dt))
    a = accel_fn(state.positions, state, cfg)
    v = state.velocities + a * dtf
    v = v + _vec3(np.asarray(cfg.acceleration, np.float32) * f32(dt), v)
    v = _drag(v, cfg, dt)
    x = state.positions + v * dtf
    x, v = apply_boundary(x, v, cfg)
    return state.replace(positions=x, velocities=v)


def _step_velocity_verlet(state: ParticleState, cfg: SimConfig, dt, accel_fn):
    """x += v dt + a dt^2/2; v += (a + a') dt/2, then drag."""
    dtf = float(f32(dt))
    a0 = state.accel
    v = state.velocities
    x = state.positions + v * dtf + 0.5 * a0 * dtf * dtf
    x, v = apply_boundary(x, v, cfg)
    a1 = _total_accel(x, state, cfg, accel_fn)
    v = v + 0.5 * (a0 + a1) * dtf
    v = _drag(v, cfg, dt)
    return state.replace(positions=x, velocities=v, accel=a1)


def _step_leapfrog(state: ParticleState, cfg: SimConfig, dt, accel_fn):
    """Kick-drift-kick leapfrog with cached acceleration."""
    dtf = float(f32(dt))
    a0 = state.accel
    v_half = state.velocities + 0.5 * a0 * dtf
    x = state.positions + v_half * dtf
    x, v_half = apply_boundary(x, v_half, cfg)
    a1 = _total_accel(x, state, cfg, accel_fn)
    v = v_half + 0.5 * a1 * dtf
    v = _drag(v, cfg, dt)
    return state.replace(positions=x, velocities=v, accel=a1)


def warmup(state: ParticleState, cfg: SimConfig) -> ParticleState:
    """Populate the cached acceleration (velocity_verlet / leapfrog)."""
    if cfg.integrator == "euler":
        return state
    return state.replace(accel=_total_accel(state.positions, state, cfg, pair_accel))


def step(state: ParticleState, cfg: SimConfig, dt, accel_fn=None) -> ParticleState:
    """One simulation step. ``accel_fn(positions, state, cfg)`` overrides
    the pairwise-force backend."""
    accel_fn = accel_fn or pair_accel
    if cfg.integrator == "euler":
        return _step_euler(state, cfg, dt, accel_fn)
    if cfg.integrator == "velocity_verlet":
        return _step_velocity_verlet(state, cfg, dt, accel_fn)
    if cfg.integrator == "leapfrog":
        return _step_leapfrog(state, cfg, dt, accel_fn)
    raise ValueError(f"unknown integrator {cfg.integrator!r}")


def simulate(state: ParticleState, cfg: SimConfig, dt, num_steps: int) -> ParticleState:
    for _ in range(num_steps):
        state = step(state, cfg, dt)
    return state


def trajectory(state: ParticleState, cfg: SimConfig, dt, num_steps: int,
               snapshot_every: int = 1):
    """Returns (final_state, positions[S, N, 3]) with a snapshot every
    ``snapshot_every`` steps; a trailing partial window still runs and
    emits one final snapshot."""
    snaps = []
    done = 0
    while done < num_steps:
        k = min(snapshot_every, num_steps - done)
        state = simulate(state, cfg, dt, k)
        snaps.append(state.positions)
        done += k
    if not snaps:
        return state, state.positions.new_zeros((0,) + tuple(state.positions.shape))
    return state, torch.stack(snaps)


def simulate_dense(state: ParticleState, cfg: SimConfig, dt, num_steps: int,
                   nsc: int | None = None, cap: int | None = None,
                   mcap: int | None = None, ocap: int | None = None):
    """Exact cell-list trajectory on the incrementally maintained dense
    layout (``ops.celllist_dense``). Returns ``(final_state, (max_movers,
    max_masked))`` as device scalars: per-step maxima of supercell crossers
    and of force-frozen rows (0 for an exact run). Overflow up to ``ocap``
    is served exactly by the sidecar and does not count as masked."""
    from ..ops.celllist_dense import (OCAP, build_dense, default_mover_capacity,
                                      scatter_back)

    nsc = cfg.cell_grid if nsc is None else nsc
    cap = cfg.cell_capacity if cap is None else cap
    if nsc is None or cap is None:
        raise ValueError("simulate_dense needs cfg.cell_grid / cfg.cell_capacity")
    if mcap is None:
        mcap = default_mover_capacity(state.n)
    if ocap is None:
        ocap = OCAP if cfg.overflow_capacity is None else cfg.overflow_capacity

    ds0 = build_dense(state, cfg, nsc, cap, ocap)
    # particles the build could not place ride the whole window frozen
    n_dropped = state.n - (ds0.pid >= 0).sum()
    ds, (mx_mov, mx_mis) = _dense_scan(ds0, cfg, dt, num_steps, nsc, cap, mcap,
                                       ocap=ocap)
    return scatter_back(ds, state), (mx_mov, torch.maximum(mx_mis, n_dropped))


def _sidecar_apply(f, positions, ds, mis_idx, cfg, nsc, cap):
    """Add the overflow sidecar's exact forces: forces on the misplaced
    rows and from them onto aligned receivers."""
    if nsc < 3:
        raise NotImplementedError(
            f"the overflow sidecar for cell_grid={nsc} < 3 (sidecar_sweeps) "
            f"is not ported yet: ROADMAP.md queue 1, 'sidecar_sweeps path'")
    from ..ops.overflow import neighborhood_apply

    return neighborhood_apply(f, positions, ds.u, ds.v, ds.r2 > 0.0, mis_idx,
                              cfg, nsc, cap)


def dense_pair_forces(positions, ds, mis, cfg: SimConfig, nsc: int, cap: int,
                      ocap: int):
    """Exact pair-force sums [S, 3] on the dense layout: K1 on aligned rows,
    plus the overflow sidecar for the ``mis`` worklist when ``ocap``."""
    from ..ops.celllist_dense import dense_forces_fresh

    f = dense_forces_fresh(positions, ds, cfg, nsc, cap)
    f = f * (ds.r2 > 0.0).to(f.dtype)[:, None]
    if ocap:
        f = _sidecar_apply(f, positions, ds, mis, cfg, nsc, cap)
    return f


def _dense_scan(ds0, cfg: SimConfig, dt, num_steps: int, nsc: int, cap: int,
                mcap: int, ocap: int | None = None):
    """num_steps of step + incremental rebind on an existing dense layout."""
    from ..ops.celllist_dense import OCAP, rebind, sidecar_indices

    if ocap is None:
        ocap = OCAP if cfg.overflow_capacity is None else cfg.overflow_capacity
    dev = ds0.pid.device
    s_total = ds0.pid.shape[0]
    dummy_species = torch.zeros(s_total, dtype=torch.int64, device=dev)
    dummy_masses = torch.zeros(s_total, dtype=torch.float32, device=dev)
    kick = float(F.kick_scale(cfg))

    ds = ds0
    mis = sidecar_indices(ds0, ocap) if ocap else None
    mx_mov = torch.zeros((), dtype=torch.int64, device=dev)
    mx_mis = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(num_steps):
        def accel_fn(positions, st, c, ds=ds, mis=mis):
            return dense_pair_forces(positions, ds, mis, c, nsc, cap, ocap) * kick

        ps = ParticleState(positions=ds.pos, velocities=ds.vel,
                           species=dummy_species, masses=dummy_masses,
                           accel=ds.acc)
        ps = step(ps, cfg, dt, accel_fn=accel_fn)
        ds = ds.replace(data=torch.cat([ps.positions, ps.velocities, ps.accel], 1))
        ds, n_mov, n_mis, mis = rebind(ds, cfg, nsc, cap, mcap, ocap)
        if ocap:
            n_mis = n_mis - (mis < s_total).sum()
        mx_mov = torch.maximum(mx_mov, n_mov)
        mx_mis = torch.maximum(mx_mis, n_mis)
    return ds, (mx_mov, mx_mis)


def simulate_dense_adaptive(state: ParticleState, cfg: SimConfig, dt,
                            num_steps: int, chunk: int = 64,
                            nsc: int | None = None, cap: int | None = None,
                            max_cap: int = 512, verbose=None,
                            ocap: int | None = None):
    """Long-horizon exact cell-list driver with capacity escalation.

    Runs ``chunk``-step windows of ``simulate_dense``. A window that
    reports masked rows is rewound and re-run from its starting state at
    double the capacity (up to ``max_cap``), so every committed window is
    exact. K1 takes any capacity, so no feasibility model limits the
    ladder. Masking that persists at ``max_cap`` raises: the culled
    all-pairs rung that the JAX package falls back to needs K4, not ported
    yet. Returns ``(state, cap, history)``, history listing ``(steps, cap,
    masked)`` per committed window.
    """
    nsc = cfg.cell_grid if nsc is None else nsc
    cap = cfg.cell_capacity if cap is None else cap
    if nsc is None or cap is None:
        raise ValueError("simulate_dense_adaptive needs cfg.cell_grid / "
                         "cfg.cell_capacity")
    done = 0
    history = []
    while done < num_steps:
        k = min(chunk, num_steps - done)
        out, (_, mis) = simulate_dense(state, cfg.replace(cell_capacity=cap),
                                       dt, k, nsc=nsc, cap=cap, ocap=ocap)
        masked = int(mis)
        if masked > 0:
            if cap >= max_cap:
                raise RuntimeError(
                    f"step {done}: {masked} rows masked at max_cap={max_cap}; "
                    f"the culled all-pairs rung (K4) that would take over is "
                    f"not ported yet (ROADMAP.md queue 2, K4)")
            new_cap = min(2 * cap, max_cap)
            if verbose:
                verbose(f"[adaptive] step {done}: {masked} capacity-masked at "
                        f"cap={cap} -> rewinding window, cap={new_cap}")
            cap = new_cap
            continue
        state = out
        done += k
        history.append((k, cap, masked))
    return state, cap, history
