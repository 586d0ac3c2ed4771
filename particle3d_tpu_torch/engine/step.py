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

import time

import numpy as np
import torch

from ..config import SimConfig, f32
from ..state import ParticleState
from ..ops import forces as F
from ..ops.allpairs import allpairs_forces
from ..utils.profiling import count, host_sync, span
from .boundaries import apply_boundary


def _vec3(values, like: torch.Tensor) -> torch.Tensor:
    """f32[3] on ``like``'s device, built by fills (no host copy)."""
    return torch.stack([F.scalar_like(x, like) for x in np.asarray(values)])


def pair_accel(positions, state: ParticleState, cfg: SimConfig):
    """Pairwise-interaction acceleration at ``positions``, dispatched on
    ``cfg.neighbor``."""
    u, v = F.pair_features(state, cfg)
    if cfg.neighbor == "allpairs":
        f = allpairs_forces(positions, u, v, cfg)
    elif cfg.neighbor == "allpairs_pallas":
        from ..ops.allpairs_sweep import pallas_allpairs_forces

        f = pallas_allpairs_forces(positions, u, v, cfg)
    elif cfg.neighbor == "allpairs_culled":
        from ..ops.allpairs_sweep import pallas_allpairs_forces_culled

        f = pallas_allpairs_forces_culled(positions, u, v, cfg)
    elif cfg.neighbor == "allpairs_mxu":
        from ..ops.allpairs_mxu_sweep import pallas_allpairs_forces_mxu

        f = pallas_allpairs_forces_mxu(positions, u, v, cfg)
    elif cfg.neighbor == "celllist":
        from ..ops.celllist import celllist_forces

        f = celllist_forces(positions, u, v, cfg)
    elif cfg.neighbor == "celllist_pallas":
        from ..ops.celllist_sweep import fresh_celllist_forces

        f = fresh_celllist_forces(positions, u, v, cfg)
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
    rows and from them onto aligned receivers. The 27-cell neighbourhood
    sweeps when the grid has them (nsc >= 3), else the dense sweeps over
    every slot (``sidecar_sweeps``)."""
    from ..ops.compaction import index_add_rows
    from ..ops.overflow import neighborhood_apply, sidecar_sweeps

    if nsc >= 3:
        return neighborhood_apply(f, positions, ds.u, ds.v, ds.r2 > 0.0,
                                  mis_idx, cfg, nsc, cap)
    s_total = ds.pid.shape[0]
    mvalid = mis_idx < s_total
    msafe = torch.clamp(mis_idx, max=s_total - 1)
    f_mis, f_from = sidecar_sweeps(
        positions, ds.u, ds.v, ds.pid >= 0,
        positions[msafe], ds.u[msafe], ds.v[msafe], mvalid, cfg)
    f_from = torch.where((ds.r2 > 0.0)[:, None], f_from, 0.0)
    return index_add_rows(f + f_from, msafe, f_mis, mvalid)


def dense_pair_forces(positions, ds, mis, cfg: SimConfig, nsc: int, cap: int,
                      ocap: int):
    """Exact pair-force sums [S, 3] on the dense layout: K1 on aligned rows,
    plus the overflow sidecar for the ``mis`` worklist when ``ocap``."""
    from ..ops.celllist_dense import dense_forces_fresh

    with span("dense.forces"):
        f = dense_forces_fresh(positions, ds, cfg, nsc, cap)
    # a select, not a multiply: an empty slot's row is a stale copy that can
    # sit on top of the particle it left, where a singular law (Lennard-
    # Jones) gives it an infinite force, and inf * 0 would be a NaN that
    # integrates and then poisons its neighbours as a source (0 * NaN)
    f = torch.where((ds.r2 > 0.0)[:, None], f, 0.0)
    if ocap:
        with span("dense.sidecar"):
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
        with span("dense.rebind"):
            ds, n_mov, n_mis, mis = rebind(ds, cfg, nsc, cap, mcap, ocap)
            if ocap:
                n_mis = n_mis - (mis < s_total).sum()
        mx_mov = torch.maximum(mx_mov, n_mov)
        mx_mis = torch.maximum(mx_mis, n_mis)
    return ds, (mx_mov, mx_mis)


def simulate_dense_carry(ds, cfg: SimConfig, dt, num_steps: int, nsc: int,
                         cap: int, mcap: int, ocap: int | None = None):
    """``simulate_dense`` continued on a dense layout that already exists
    (``ops.celllist_dense.build_dense``): the interactive driver keeps the
    layout across tick batches, so only its first batch pays the sorting
    build. Returns ``(layout, (max_movers, max_masked))``; masked counts
    frozen rows only (the sidecar keeps up to ``ocap`` misplaced rows
    exact, as in ``simulate_dense``)."""
    return _dense_scan(ds, cfg, dt, num_steps, nsc, cap, mcap, ocap=ocap)


def _cadenced_window(s: ParticleState, cfg: SimConfig, dt, k: int, nsc: int,
                     cap: int, forces_for=None):
    """k steps on one frozen layout built from ``s``. Returns ``(state,
    drift, dropped)`` with device scalars: the largest displacement from
    the layout's anchor, and the particles the build left without a slot
    (they keep their state from ``s``). ``forces_for(layout)`` gives the
    slot forces ``f(pos_flat, cfg)`` on the layout (default:
    ``dense_forces``; ``parallel.domain`` splits them over ranks)."""
    from ..ops.celllist_sweep import (build_layout, dense_forces, layout_drift,
                                      slot_of_particle)

    with span("cadenced.build"):
        u, v = F.pair_features(s, cfg)
        layout = build_layout(s.positions, u, v, cfg, nsc, cap)
    # the state moves into the slots and integrates there: between rebuilds
    # nothing is gathered or scattered. Empty slots ride as inert rows at
    # the origin: never sources (gate -1), and K1 selects their own force
    # to exactly 0, so no force is multiplied by a mask (under
    # Lennard-Jones a row on top of another would give inf * 0 = NaN)
    slot = layout.slot_particle.reshape(-1)
    present = slot >= 0
    safe = torch.where(present, slot, 0)

    def to_slots(a):
        return torch.where(present.reshape((-1,) + (1,) * (a.dim() - 1)),
                           a[safe], torch.zeros((), dtype=a.dtype,
                                                device=a.device))

    dense = ParticleState(*(to_slots(getattr(s, f))
                            for f in ParticleState.__dataclass_fields__))
    kick = float(F.kick_scale(cfg))
    forces = (forces_for(layout) if forces_for is not None else
              lambda p, c: dense_forces(layout, p, c, nsc, cap))

    def accel_fn(positions, st, c):
        return forces(positions, c) * kick

    for _ in range(k):
        dense = step(dense, cfg, dt, accel_fn=accel_fn)
    inv = slot_of_particle(layout, s.n)
    ok = (inv >= 0)[:, None]
    inv_safe = torch.clamp(inv, min=0)
    s = s.replace(**{f: torch.where(ok, getattr(dense, f)[inv_safe],
                                    getattr(s, f))
                     for f in ("positions", "velocities", "accel")})
    with span("cadenced.drift"):
        drift = layout_drift(layout, s.positions, cfg)
    return s, drift, s.n - present.sum()


def simulate_cadenced(state: ParticleState, cfg: SimConfig, dt,
                      num_steps: int, rebuild_every: int = 8,
                      nsc: int | None = None, cap: int | None = None):
    """Trajectory on the column-sweep cell list with cadenced layout
    rebuilds: the binning is redone every ``rebuild_every`` steps, and in
    between the state integrates in the frozen slot layout, K1 reading the
    layout's cached features and gates (the MD skin / Verlet-list
    pattern). One K1 launch a step; no host synchronisation.

    Exact while every particle drifts less than
    ``ops.celllist_sweep.drift_budget(cfg, nsc)`` between rebuilds and no
    build overflows its capacity. Returns ``(state, max_drift,
    max_dropped)`` as device scalars, so callers can check the drift and
    rewind a window whose build dropped particles (those ride the window
    frozen)."""
    nsc = cfg.cell_grid if nsc is None else nsc
    cap = cfg.cell_capacity if cap is None else cap
    if nsc is None or cap is None:
        raise ValueError("simulate_cadenced needs cfg.cell_grid / "
                         "cfg.cell_capacity")
    dev = state.positions.device
    max_drift = torch.zeros((), dtype=torch.float32, device=dev)
    max_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    done = 0
    while done < num_steps:
        k = min(rebuild_every, num_steps - done)
        state, drift, dropped = _cadenced_window(state, cfg, dt, k, nsc, cap)
        max_drift = torch.maximum(max_drift, drift)
        max_dropped = torch.maximum(max_dropped, dropped)
        done += k
    return state, max_drift, max_dropped


def _ladder_counts(steps: int, rewound: bool, probe: bool = False):
    """The capacity ladder's counters for one window it ran."""
    count("ladder.steps_run", steps)
    if rewound:
        count("ladder.steps_rewound", steps)
        count("ladder.windows_rewound")
    if probe:
        count("ladder.probes")


def _sync(t: torch.Tensor):
    """Wait for the card before a host clock is read: without it a timer
    measures the enqueue, not the work."""
    with host_sync("sync.ladder_timer"):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


def _culled_window(state: ParticleState, cfg: SimConfig, dt, num_steps: int,
                   t: int):
    """``num_steps`` steps of the culled rung on a Morton-sorted state. Each
    step rebuilds the survival mask from the live positions and the exact
    worklist of surviving tile pairs (``torch.nonzero``: one host sync a
    step), then runs K4 over it. Returns ``(state, counts)``, the surviving
    pair count of every force evaluation."""
    from ..ops.allpairs_sweep import (_pad_rows, _round_to,
                                      build_pair_worklist, pair_survival_mask,
                                      pallas_allpairs_forces_pairlist)

    n = state.n
    np_ = _round_to(n, t)
    nt = np_ // t
    u, v = F.pair_features(state, cfg)
    kick = float(F.kick_scale(cfg))
    counts = []

    def accel_fn(positions, st, c):
        mask = pair_survival_mask(_pad_rows(positions.to(torch.float32), np_),
                                  n, t, nt, c)
        wp, pairs = build_pair_worklist(mask, nt)
        counts.append(pairs)
        return pallas_allpairs_forces_pairlist(positions, u, v, c, wp,
                                               t=t) * kick

    for _ in range(num_steps):
        state = step(state, cfg, dt, accel_fn=accel_fn)
    return state, counts


def _culled_sort_phase(state: ParticleState, order_total, cfg: SimConfig):
    """Morton-sort the state and compose the permutation. (The JAX package
    also counts the sorted layout's surviving pairs here, to size its
    static worklist; the port's worklist has no capacity.)"""
    from ..ops.allpairs_sweep import morton_keys

    order = torch.argsort(morton_keys(state.positions, cfg.world_size),
                          stable=True)
    state = ParticleState(*(getattr(state, f)[order]
                            for f in ParticleState.__dataclass_fields__))
    return state, order_total[order]


def _culled_unsort_phase(state: ParticleState, order_total):
    inv = torch.empty_like(order_total)
    inv[order_total] = torch.arange(order_total.shape[0],
                                    device=order_total.device)
    return ParticleState(*(getattr(state, f)[inv]
                           for f in ParticleState.__dataclass_fields__))


def simulate_culled(state: ParticleState, cfg: SimConfig, dt, num_steps: int,
                    window: int = 16, t: int | None = None):
    """Exact trajectory through the worklist-culled all-pairs sweep (K4):
    the terminal rung of the capacity ladder, for scenes clustered past
    every cell capacity.

    The state is Morton-sorted once per ``window`` steps (a stale order
    only loosens tile bounds, never exactness, because every step rebuilds
    the survival mask from the live positions). Every step builds the
    exact worklist of surviving tile pairs with ``torch.nonzero`` (one host
    sync) and K4 walks only those. The JAX package instead compacts into a
    static worklist capacity ``wp_cap`` with quantised buckets and rewinds
    a window that overflows it; an eager port needs none of that, so
    ``retries`` is always 0 and ``wp_cap`` reports the largest worklist
    seen.

    Returns ``(state, stats)`` with the state back in particle order;
    stats = dict(windows, retries, max_count, max_pair_frac,
    mean_pair_frac, wp_cap).
    """
    from ..ops.allpairs_sweep import KERNEL_TILE, _round_to

    n = state.n
    t = KERNEL_TILE if t is None else t
    np_ = _round_to(n, t)
    nt = np_ // t
    pairs_total = nt * (nt + 1) // 2
    done = windows = max_count = 0
    max_frac = mean_frac_acc = 0.0
    order_total = torch.arange(n, device=state.positions.device)
    while done < num_steps:
        k = min(window, num_steps - done)
        state, order_total = _culled_sort_phase(state, order_total, cfg)
        with span("culled.window", steps=k):
            state, counts = _culled_window(state, cfg, dt, k, t)
        mx = max(counts) if counts else 0
        max_count = max(max_count, mx)
        max_frac = max(max_frac, mx / pairs_total)
        mean_frac_acc += sum(counts) / (max(len(counts), 1) * pairs_total)
        done += k
        windows += 1
    state = _culled_unsort_phase(state, order_total)
    return state, {"windows": windows, "retries": 0, "max_count": max_count,
                   "max_pair_frac": max_frac,
                   "mean_pair_frac": mean_frac_acc / max(windows, 1),
                   "wp_cap": max_count}


def simulate_dense_adaptive(state: ParticleState, cfg: SimConfig, dt,
                            num_steps: int, chunk: int = 64,
                            nsc: int | None = None, cap: int | None = None,
                            max_cap: int = 512, verbose=None,
                            probe_factor: float = 3.0,
                            ocap: int | None = None,
                            _timer=time.perf_counter):
    """Long-horizon exact cell-list driver with capacity escalation and the
    culled all-pairs rung (the JAX package's driver).

    Runs ``chunk``-step windows of ``simulate_dense``. A window that
    reports masked rows is rewound and re-run from its starting state at
    double the capacity, up to ``max_cap`` (K1 takes any capacity, so no
    feasibility model limits the ladder). Masking that persists at
    ``max_cap`` rewinds the window onto ``simulate_culled`` (K4), which
    has no capacity at all; every committed window is exact.

    The ladder is cost-aware: once a capacity's first window is behind it,
    every window is wall-timed (after a device sync), and an escalated rung
    slower than ``probe_factor`` x the cheapest committed rung, or any rung
    at >= 4x the starting capacity, makes the next window run on the culled
    rung as a probe (committed, not wasted); a faster probe switches the
    run over. On the culled rung, every 8th window, or as soon as the
    surviving-pair fraction halves from its value at the switch, re-probes
    the cell path at the last working capacity, and a mask-free, faster
    probe switches back. ``_timer`` replaces the clock (tests).

    Returns ``(state, cap, history)``, history listing ``(steps,
    cap_or_backend, masked)`` per committed window, with backend
    ``"allpairs"`` for culled windows (always mask-free).
    """
    nsc = cfg.cell_grid if nsc is None else nsc
    cap = cfg.cell_capacity if cap is None else cap
    if nsc is None or cap is None:
        raise ValueError("simulate_dense_adaptive needs cfg.cell_grid / "
                         "cfg.cell_capacity")
    say = verbose or (lambda msg: None)
    cap0 = cap
    fallback = False
    done = 0
    history = []
    best_rung_sec = None   # cheapest committed cell-window sec/step
    probe_pending = False  # the next window tries the culled rung
    rung_sec = None        # sec/step of the window that triggered the probe
    seen_caps = set()      # capacities whose first window is behind them
    probed_caps = set()    # rungs already raced against the culled rung
    culled_sec = None      # latest steady (non-first) culled sec/step
    culled_seen = False
    switch_frac = None     # mean pair fraction when the culled rung took over
    fb_since_probe = 0     # culled windows since the last cell re-probe
    reprobe_every = 8
    while done < num_steps:
        k = min(chunk, num_steps - done)
        if fallback or probe_pending:
            if fallback and not probe_pending and fb_since_probe >= reprobe_every:
                fb_since_probe = 0
                with span("ladder.window", cap=cap, steps=k) as win:
                    t0 = _timer()
                    outp, (_, misp) = simulate_dense(
                        state, cfg.replace(cell_capacity=cap), dt, k, nsc=nsc,
                        cap=cap, ocap=ocap)
                    with host_sync("sync.ladder_masked"):
                        masked_p = int(misp)
                    if masked_p == 0:
                        _sync(outp.positions)
                        secp = (_timer() - t0) / k
                    win.set(outcome="rewound" if masked_p else "probe")
                _ladder_counts(k, masked_p > 0, probe=True)
                if masked_p == 0:
                    state = outp
                    done += k
                    history.append((k, cap, 0))
                    if culled_sec is not None and secp < culled_sec:
                        fallback = False
                        probed_caps.discard(cap)
                        say(f"[adaptive] cell re-probe cap={cap} "
                            f"{secp * 1e3:.0f} ms/step beats culled "
                            f"({culled_sec * 1e3:.0f}) — back on the cell path")
                    else:
                        say(f"[adaptive] cell re-probe cap={cap} "
                            f"{secp * 1e3:.0f} ms/step loses to culled "
                            f"({(culled_sec or 0) * 1e3:.0f}) — staying culled")
                    continue
                say(f"[adaptive] cell re-probe cap={cap}: still masking — "
                    f"staying culled (window rewound)")
            with span("ladder.window", cap="allpairs", steps=k,
                      outcome="probe" if probe_pending else "committed"):
                t0 = _timer()
                state, stc = simulate_culled(state, cfg, dt, k,
                                             window=min(k, 16))
                frac = stc["mean_pair_frac"]
                _sync(state.positions)
                sec = (_timer() - t0) / k
            _ladder_counts(k, False, probe=probe_pending)
            done += k
            history.append((k, "allpairs", 0))
            if fallback:
                fb_since_probe += 1
                if culled_seen:
                    culled_sec = sec
                else:
                    culled_seen = True  # the first culled window is not timed
                    switch_frac = frac
                if switch_frac is not None and frac < 0.5 * switch_frac:
                    fb_since_probe = reprobe_every  # dispersed: re-probe next
            if probe_pending:
                probe_pending = False
                if rung_sec is not None and sec < rung_sec:
                    fallback = True
                    say(f"[adaptive] culled probe {sec * 1e3:.0f} ms/step "
                        f"beats rung cap={cap} ({rung_sec * 1e3:.0f}) — "
                        f"switching to the culled backend")
                elif not fallback:
                    say(f"[adaptive] culled probe {sec * 1e3:.0f} ms/step "
                        f"loses to rung cap={cap} ({(rung_sec or 0) * 1e3:.0f})"
                        f" — staying on the cell path")
            continue
        with span("ladder.window", cap=cap, steps=k) as win:
            t0 = _timer()
            out, (_, mis) = simulate_dense(
                state, cfg.replace(cell_capacity=cap), dt, k, nsc=nsc,
                cap=cap, ocap=ocap)
            with host_sync("sync.ladder_masked"):
                masked = int(mis)
            _sync(out.positions)
            sec = (_timer() - t0) / k
            win.set(outcome="rewound" if masked else "committed")
        _ladder_counts(k, masked > 0)
        if masked > 0:
            if cap < max_cap:
                new_cap = min(2 * cap, max_cap)
                say(f"[adaptive] step {done}: {masked} capacity-masked at "
                    f"cap={cap} -> rewinding window, cap={new_cap}")
                cap = new_cap
                continue
            fallback = True
            say(f"[adaptive] step {done}: {masked} masked at max_cap={cap} — "
                f"rewinding window, falling back to the culled all-pairs "
                f"sweep (exact)")
            continue
        state = out
        done += k
        history.append((k, cap, masked))
        if cap in seen_caps:
            if best_rung_sec is None or sec < best_rung_sec:
                best_rung_sec = sec
            slow = best_rung_sec is not None and sec > probe_factor * best_rung_sec
            deep = cap >= 4 * cap0
            if (cap > cap0 and cap not in probed_caps and (slow or deep)
                    and done < num_steps):
                probe_pending = True
                probed_caps.add(cap)
                rung_sec = sec
                why = (f"{sec / best_rung_sec:.1f}x the cheapest rung" if slow
                       else f"deep rung (>= 4x cap0={cap0})")
                say(f"[adaptive] rung cap={cap} at {sec * 1e3:.0f} ms/step: "
                    f"{why} — probing the culled backend")
        else:
            seen_caps.add(cap)
    return state, cap, history
