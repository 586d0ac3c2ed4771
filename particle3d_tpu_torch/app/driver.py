"""Interactive simulation driver, ``SimulationApp`` (port of
``particle3d_tpu.app.driver``).

Mirrors the reference app's shell:

  * a fixed-timestep accumulator at ``update_rate`` steps a second, with a
    capped catch-up of at most 5 physics steps a frame,
  * every live control of the reference's side panel and properties
    window: particle count, world size, update rate, walls, effect
    radius, interaction force, drag, repulsion threshold, gravity,
    per-species colours and the attraction matrix,
  * WASD/QE and arrow-key camera control,
  * frame rendering on the card and wall-clock metrics (frame and update
    time).

The state lives on ``device`` (default the card; raises without one).
New particles are drawn from an explicit CPU ``torch.Generator``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import ConfigError, SimConfig
from ..engine.step import simulate, warmup
from ..render.camera import (camera_axes, default_camera, move_camera,
                             rotate_camera)
from ..render.splat import render_frame
from ..state import init_scene, resize, resolve_device, to_device
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.metrics import measure_metrics
from ..utils.profiling import StepTimer, host_sync, span


class SimulationApp:
    def __init__(self, state=None, cfg: SimConfig | None = None, *,
                 n: int = 1000, seed: int = 0, update_rate: float = 60.0,
                 device="cuda", generator: torch.Generator | None = None):
        self.cfg = (cfg or SimConfig()).validate()
        self.device = resolve_device(device)
        self._gen = (generator if generator is not None
                     else torch.Generator().manual_seed(seed))
        if state is None:
            state = init_scene(self._gen, n, self.cfg, self.device)
        self.state = warmup(to_device(state, self.device), self.cfg)
        self.camera = default_camera(float(np.asarray(self.cfg.world_size)))
        self.update_rate = update_rate
        self._accum = 0.0
        self._last_time: float | None = None
        self.step_index = 0
        self.update_timer = StepTimer()
        self.frame_timer = StepTimer()
        # exactness of the cadenced cell-list path (see run_steps)
        self.max_drift = 0.0
        self.capacity_masked = 0
        self._per_step_rebuild = False
        # the dense cell layout of the carry path, kept across tick batches;
        # dropped by every control that changes particles, features or the
        # cell geometry
        self._dense = None
        self._dense_geom = None
        # sticky capacity escalation: a batch that masks is rewound and
        # re-run at twice the capacity (up to max_cap), which then stays
        self._cap_escalated: int | None = None
        self.max_cap = 512
        # set when masking persists at max_cap: later batches run the
        # capacity-free culled rung (exact, slower)
        self._cell_fallback = False
        from ..ops.celllist_dense import OCAP

        self.ocap = (OCAP if self.cfg.overflow_capacity is None
                     else self.cfg.overflow_capacity)
        # recovery probe throttle (see _maybe_recover)
        self._recheck = False
        self._degraded_batches = 0

    def _sync(self):
        with host_sync("sync.app_batch_end"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _build_drops(self, dense) -> int:
        """Particles a fresh dense build left without a slot."""
        with host_sync("sync.app_build_drop"):
            return int(self.state.n - (dense.pid >= 0).sum())

    def _invalidate_dense(self) -> None:
        """Called by every scene-changing control: drops the kept layout
        and asks for a recovery probe on the next batch."""
        self._dense = None
        self._recheck = True

    def _maybe_recover(self) -> None:
        """Undo escalation or the fallback once the scene no longer needs
        it. Every 32nd degraded batch, or the batch after a scene-changing
        control, builds the base geometry's layout once; if it drops no
        particle, the app returns to the base capacity and keeps that
        layout. A reset that comes too early costs one rewound batch."""
        if not (self._cell_fallback or self._cap_escalated):
            return
        self._degraded_batches += 1
        if not (self._recheck or self._degraded_batches >= 32):
            return
        self._recheck = False
        self._degraded_batches = 0
        from ..ops.celllist_dense import build_dense

        nsc, base_cap = self._cell_geometry()
        if self._cap_escalated and base_cap >= self._cap_escalated:
            return
        dense = build_dense(self.state, self.cfg, nsc, base_cap, self.ocap)
        if self._build_drops(dense) == 0:
            self._cell_fallback = False
            self._cap_escalated = None
            self._dense = dense
            self._dense_geom = (nsc, base_cap)

    # ------------------------------------------------------------------ #
    # frame loop
    # ------------------------------------------------------------------ #
    def tick(self, real_dt: float | None = None, max_catchup: int = 5) -> int:
        """Advance wall-clock time and run 0..max_catchup fixed physics
        steps (the reference's catch-up rule). Returns the steps run."""
        now = time.perf_counter()
        if real_dt is None:
            real_dt = 0.0 if self._last_time is None else now - self._last_time
        self._last_time = now
        self._accum += real_dt
        dt = 1.0 / self.update_rate
        n_steps = 0
        if self._accum >= dt:
            n_steps = min(int(self._accum * self.update_rate), max_catchup)
        if n_steps:
            with self.update_timer:
                self.run_steps(n_steps)
            self._accum -= n_steps * dt
        return n_steps

    def drift_budget(self) -> float:
        """Largest drift the frozen layout tolerates between rebuilds,
        (cell_width - cutoff) / 2; <= 0 means the cadenced path can never
        be exact for this config."""
        from ..ops.celllist_sweep import drift_budget

        return drift_budget(self.cfg, self._cell_geometry()[0])

    def _cell_geometry(self) -> tuple[int, int]:
        """(nsc, cap) of the cell backend, derived when not configured."""
        from ..ops.celllist import default_capacity, grid_dims

        nsc, cap = self.cfg.cell_grid, self.cfg.cell_capacity
        if nsc is None:
            nsc = grid_dims(float(np.asarray(self.cfg.world_size)),
                            float(np.asarray(self.cfg.particle_effect_radius)))
        if cap is None:
            cap = default_capacity(self.state.n, nsc, slack=2.5)
        return nsc, cap

    def _run_fallback(self, dt, n_steps: int) -> None:
        """Advance on the capacity-free culled rung (``simulate_culled``,
        K4; exact): the end of the escalation ladder, on every device. (The
        JAX package runs plain all-pairs here when it interprets its
        kernels on the CPU.)"""
        from ..engine.step import simulate_culled

        self.state, _ = simulate_culled(self.state, self.cfg, dt, n_steps,
                                        window=n_steps)
        self._dense = None  # not _invalidate_dense: no control changed
        self._sync()
        self.step_index += n_steps

    def _escalate(self, cap: int) -> int | None:
        """The next rung, twice ``cap`` up to ``max_cap``, which then
        sticks; None when the ladder ends, which sets the fallback."""
        if cap >= self.max_cap:
            self._cell_fallback = True
            return None
        self._cap_escalated = min(2 * cap, self.max_cap)
        return self._cap_escalated

    def run_steps(self, n_steps: int) -> None:
        """Run n_steps at the fixed timestep; returns with the card
        synchronised.

        On the cell-list backend the layout rebuild is cadenced across the
        batch only while that is exact: when the drift budget is <= 0,
        observed drift ever exceeded it, the batch is one step, or the
        current speeds could use the budget up within the batch (2x
        margin), the batch runs on the dense layout kept across batches
        (``simulate_dense_carry``; the layout is repaired every step, no
        drift condition).

        A batch that masks (dense path: a build drop or frozen rows;
        cadenced path: a build drop) is never committed: it re-runs at
        the next capacity, and past ``max_cap`` on the culled rung. No
        committed batch is inexact."""
        with span("app.batch", steps=n_steps) as batch:
            batch.set(path=self._run_batch(n_steps))

    def _run_batch(self, n_steps: int) -> str:
        """``run_steps``' batch; returns the path that committed it."""
        dt = np.float32(1.0 / self.update_rate)
        if self.cfg.neighbor != "celllist_pallas":
            self.state = simulate(self.state, self.cfg, dt, n_steps)
            self._sync()
            self.step_index += n_steps
            return "simulate"
        self._maybe_recover()
        if self._cell_fallback:
            self._run_fallback(dt, n_steps)
            return "fallback"
        nsc, cap = self._cell_geometry()
        if self._cap_escalated:
            cap = max(cap, self._cap_escalated)
        budget = self.drift_budget()
        with host_sync("sync.app_speed"):
            vmax = float(torch.sqrt(torch.max(torch.sum(
                self.state.velocities ** 2, dim=-1))))
        est_drift = 2.0 * vmax * float(dt) * n_steps
        if (budget <= 0.0 or self._per_step_rebuild or n_steps == 1
                or est_drift > budget):
            path = "carry"
            committed = self._run_carry(dt, n_steps, nsc, cap)
        else:
            path = "cadenced"
            committed = self._run_cadenced(dt, n_steps, nsc, cap, budget)
        if not committed:
            # the masked batch was never committed: re-run it on the
            # capacity-free rung
            self._run_fallback(dt, n_steps)
            return "fallback"
        self._sync()
        self.step_index += n_steps
        return path

    def _run_carry(self, dt, n_steps: int, nsc: int, cap: int) -> bool:
        """The batch on the kept dense layout; False if it masked at
        max_cap."""
        from ..engine.step import simulate_dense_carry
        from ..ops.celllist_dense import (build_dense, default_mover_capacity,
                                          scatter_back)

        while True:
            if self._dense is None or self._dense_geom != (nsc, cap):
                dense = build_dense(self.state, self.cfg, nsc, cap, self.ocap)
                # a first-build drop would ride the whole batch frozen:
                # escalate before running anything
                if self._build_drops(dense) > 0:
                    cap = self._escalate(cap)
                    if cap is None:
                        return False
                    continue
                self._dense = dense
                self._dense_geom = (nsc, cap)
            new_dense, (_, mis) = simulate_dense_carry(
                self._dense, self.cfg, dt, n_steps, nsc, cap,
                default_mover_capacity(self.state.n), self.ocap)
            with host_sync("sync.app_masked"):
                masked = int(mis)
            if masked > 0:
                # rewind (self.state is still the batch's start)
                self._dense = None
                cap = self._escalate(cap)
                if cap is None:
                    return False
                continue
            break
        self._dense = new_dense
        self.state = scatter_back(self._dense, self.state)
        with host_sync("sync.app_masked"):
            self.capacity_masked = max(self.capacity_masked, int(mis))
        return True

    def _run_cadenced(self, dt, n_steps: int, nsc: int, cap: int,
                      budget: float) -> bool:
        """The batch on one frozen layout; False if its build dropped
        particles at max_cap."""
        from ..engine.step import simulate_cadenced

        while True:
            out, drift, dropped = simulate_cadenced(
                self.state, self.cfg, dt, n_steps, rebuild_every=n_steps,
                nsc=nsc, cap=cap)
            with host_sync("sync.app_dropped"):
                dropped = int(dropped)
            if dropped == 0:
                break
            # the build froze particles: rewind and escalate
            cap = self._escalate(cap)
            if cap is None:
                return False
        self.state = out
        # the state moved outside the kept dense layout, which would now
        # replay stale rows (no control changed: not _invalidate_dense)
        self._dense = None
        with host_sync("sync.app_drift"):
            drift = float(drift)
        self.max_drift = max(self.max_drift, drift)
        if drift > budget:
            # this batch may have missed in-range pairs: stop trusting
            # frozen layouts for this scene
            self._per_step_rebuild = True
        return True

    # ------------------------------------------------------------------ #
    # live controls
    # ------------------------------------------------------------------ #
    def set_particle_count(self, n: int) -> None:
        """Truncate, or extend with new random particles."""
        if n == self.state.n:
            return
        self.state = resize(self.state, self._gen, n, self.cfg)
        self._invalidate_dense()

    def set_world_size(self, w: float) -> None:
        """Clamped to >= 2 * radius, as the UI does."""
        r = float(np.asarray(self.cfg.particle_effect_radius))
        self.cfg = self.cfg.replace(world_size=max(float(w), 2.0 * r))
        self._invalidate_dense()

    def set_update_rate(self, tps: float) -> None:
        self.update_rate = float(np.clip(tps, 1.0, 1000.0))

    def set_walls(self, walls: bool) -> None:
        self.cfg = self.cfg.replace(boundary="clamp" if walls else "wrap")
        self._invalidate_dense()

    def set_effect_radius(self, r: float) -> None:
        w = float(np.asarray(self.cfg.world_size))
        self.cfg = self.cfg.replace(
            particle_effect_radius=float(np.clip(r, 1e-3, w / 2.0)))
        self._invalidate_dense()

    def set_interaction_force(self, f: float) -> None:
        self.cfg = self.cfg.replace(
            interaction_force=float(np.clip(f, 0.0, 10.0)))
        self._invalidate_dense()

    def set_drag(self, c: float) -> None:
        self.cfg = self.cfg.replace(coefficient=float(np.clip(c, 0.0, 1.0)))
        self._invalidate_dense()

    def set_min_pull_ratio(self, m: float) -> None:
        self.cfg = self.cfg.replace(
            min_pull_ratio=float(np.clip(m, 1e-4, 1.0)))
        self._invalidate_dense()

    def set_gravity(self, x: float, y: float, z: float) -> None:
        self.cfg = self.cfg.replace(acceleration=np.array([x, y, z], np.float32))
        self._invalidate_dense()

    def set_color(self, species: int, rgb) -> None:
        colors = np.asarray(self.cfg.colors).copy()
        colors[species] = np.asarray(rgb, np.float32)
        self.cfg = self.cfg.replace(colors=colors)
        self._invalidate_dense()

    def set_attraction(self, i: int, j: int, value: float) -> None:
        """Edits are clamped to [-1, 1], as the UI does."""
        m = np.asarray(self.cfg.attraction_matrix).copy()
        m[i, j] = float(np.clip(value, -1.0, 1.0))
        self.cfg = self.cfg.replace(attraction_matrix=m)
        self._invalidate_dense()

    def set_attraction_matrix(self, m) -> None:
        m = np.asarray(m, np.float32)
        if m.shape != (self.cfg.id_count, self.cfg.id_count):
            raise ConfigError(f"attraction matrix must be "
                              f"{(self.cfg.id_count,) * 2}, got {m.shape}")
        self.cfg = self.cfg.replace(attraction_matrix=m)
        self._invalidate_dense()

    # ------------------------------------------------------------------ #
    # camera
    # ------------------------------------------------------------------ #
    def handle_keys(self, keys: set[str], dt: float) -> None:
        """WASD/QE translate, arrows rotate."""
        fwd, right, up = camera_axes(self.camera)
        cam = self.camera
        for key, direction in (("w", fwd), ("s", -fwd), ("a", -right),
                               ("d", right), ("q", -up), ("e", up)):
            if key in keys:
                cam = move_camera(cam, dt, direction)
        rot = 90.0 * dt  # ROTATION_SPEED
        for key, pitch, yaw in (("up", rot, 0.0), ("down", -rot, 0.0),
                                ("left", 0.0, -rot), ("right", 0.0, rot)):
            if key in keys:
                cam = rotate_camera(cam, pitch, yaw)
        self.camera = cam

    # ------------------------------------------------------------------ #
    # output
    # ------------------------------------------------------------------ #
    def render(self, width: int = 640, height: int = 480,
               method: str = "dilate") -> np.ndarray:
        """uint8 [H, W, 3], rendered on the state's device."""
        with self.frame_timer:
            frame = render_frame(self.state.positions, self.state.species,
                                 self.cfg, self.camera, width, height,
                                 method=method)
            with host_sync("sync.render_copy"):
                img = frame.cpu().numpy()
        return img

    def metrics(self) -> dict:
        m = measure_metrics(self.state).as_dict()
        m.update(n=self.state.n, step_index=self.step_index,
                 update_ms=self.update_timer.ema_ms,
                 frame_ms=self.frame_timer.ema_ms,
                 update_rate=self.update_rate)
        if self.cfg.neighbor == "celllist_pallas":
            m.update(max_drift=self.max_drift,
                     drift_budget=self.drift_budget(),
                     per_step_rebuild=self._per_step_rebuild,
                     capacity_masked=self.capacity_masked,
                     cell_capacity=(self._cap_escalated
                                    or self._cell_geometry()[1]),
                     cell_fallback=self._cell_fallback)
        return m

    def save(self, path: str) -> None:
        save_checkpoint(path, self.state, self.cfg, self.step_index)

    @classmethod
    def load(cls, path: str, device="cuda") -> "SimulationApp":
        state, cfg, step_index, _ = load_checkpoint(path, device=device)
        app = cls(state=state, cfg=cfg, device=device)
        app.step_index = step_index
        return app
