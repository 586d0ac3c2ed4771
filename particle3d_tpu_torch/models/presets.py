"""Named scene presets (port of ``particle3d_tpu.models.presets``).

Every preset is ``(generator, n, device) -> (state, cfg, dt)`` with the
JAX package's geometry, law, integrator and ``dt``. Scenes are drawn from
a CPU ``torch.Generator`` seeded by ``make_scene``, so a seed gives the
same scene on every device (not the JAX package's scene: the two
frameworks' generators differ).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import SimConfig, reference_config
from ..state import ParticleState, init_scene, resolve_device, to_device


def _reference(gen, n, device):
    """The reference app's demo: N=1000 particle-life, periodic box."""
    n = 1000 if n is None else n
    cfg = reference_config()
    return init_scene(gen, n, cfg, device), cfg, 1.0 / 60.0


def _reference_walls(gen, n, device):
    """The reference demo in a clamped box (forces still wrap)."""
    n = 1000 if n is None else n
    cfg = reference_config().replace(boundary="clamp")
    return init_scene(gen, n, cfg, device), cfg, 1.0 / 60.0


def _particle_life_large(gen, n, device):
    """N=262,144 particle life on the column-sweep cell list: a 24^3 grid
    (cell width 1.67 >= the effective cutoff 1.0), cap 32 near the mean
    occupancy, overflow served by the sidecar. Below N=32,768 the JAX
    package selects the all-pairs kernel instead, as here."""
    n = 262144 if n is None else n
    if n >= 32768:
        cfg = reference_config(world_size=40.0).replace(
            neighbor="celllist_pallas", cell_grid=24, cell_capacity=32)
    else:
        cfg = reference_config(world_size=40.0).replace(neighbor="allpairs_pallas")
    return init_scene(gen, n, cfg, device), cfg, 1.0 / 60.0


def _particle_life_1m(gen, n, device):
    """N=1,048,576 particle life on the exact path: 40^3 grid, cap 32,
    sidecar budget 128."""
    n = 1_048_576 if n is None else n
    cfg = reference_config(world_size=64.0).replace(
        neighbor="celllist_pallas", cell_grid=40, cell_capacity=32,
        overflow_capacity=128)
    return init_scene(gen, n, cfg, device), cfg, 1.0 / 60.0


def _particle_life_large_allpairs(gen, n, device):
    """Large-N particle life on the all-pairs kernels: K2 from N=2,048."""
    n = 262144 if n is None else n
    cfg = reference_config(world_size=40.0).replace(neighbor="allpairs_pallas")
    return init_scene(gen, n, cfg, device), cfg, 1.0 / 60.0


def _verlet_elastic(gen, n, device):
    """N=16,384 springs, velocity Verlet, elastic walls, all-pairs kernels."""
    n = 16384 if n is None else n
    cfg = SimConfig(
        force_law="spring", spring_stiffness=2.0, spring_rest_length=0.4,
        particle_effect_radius=0.8, world_size=12.0,
        integrator="velocity_verlet", boundary="reflect", restitution=1.0,
        coefficient=0.0, neighbor="allpairs_pallas", wrap_forces=False,
    ).validate()
    st = init_scene(gen, n, cfg, device)
    vel = 0.5 * torch.randn((n, 3), generator=gen, dtype=torch.float32)
    return st.replace(velocities=vel.to(st.positions.device)), cfg, 2e-3


def _gravity_nbody(gen, n, device):
    """N=65,536 gravitating bodies: a Gaussian cloud with solid-body spin,
    leapfrog, all-pairs kernels, masses uniform in [0.5, 1.5] / N."""
    n = 65536 if n is None else n
    cfg = SimConfig(
        force_law="gravity", gravity_constant=0.05, gravity_softening=0.05,
        particle_effect_radius=10.0, world_size=20.0, integrator="leapfrog",
        boundary="wrap", coefficient=0.0, neighbor="allpairs_pallas",
        wrap_forces=False,
    ).validate()
    f = torch.float32
    pos = 1.5 * torch.randn((n, 3), generator=gen, dtype=f)
    omega = torch.tensor([0.0, 0.0, 0.35], dtype=f).expand(n, 3)
    vel = torch.linalg.cross(omega, pos)
    vel = vel + 0.02 * torch.randn((n, 3), generator=gen, dtype=f)
    masses = (0.5 + torch.rand(n, generator=gen, dtype=f)) / n
    st = ParticleState(pos, vel, torch.zeros(n, dtype=torch.int64), masses,
                       torch.zeros((n, 3), dtype=f))
    return to_device(st, device), cfg, 5e-3


def _spring_lattice(gen, n, device):
    """Hookean springs on a cubic lattice (spacing 0.25) falling in a
    reflecting box: the jelly-cube demo, on the plain all-pairs backend."""
    n = 4096 if n is None else n
    cfg = SimConfig(
        force_law="spring", spring_stiffness=8.0, spring_rest_length=0.5,
        particle_effect_radius=0.75, world_size=16.0,
        integrator="velocity_verlet", boundary="reflect", restitution=0.8,
        coefficient=0.2, neighbor="allpairs", wrap_forces=False,
        acceleration=np.array([0.0, -2.0, 0.0], np.float32),
    ).validate()
    side = round(n ** (1 / 3))
    while side ** 3 < n:
        side += 1
    half = 0.25 * side * 0.5
    lin = torch.linspace(-half, half, side, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
    st = init_scene(gen, n, cfg, device)
    return (st.replace(positions=grid.reshape(-1, 3)[:n].to(st.positions.device)),
            cfg, 2e-3)


def _lj_gas(gen, n, device):
    """BASELINE config 3: N=262,144 Lennard-Jones gas in a periodic box of
    32, velocity Verlet. From N=32,768 the column-sweep cell list on a 32^3
    grid (cell width 1.0, twice the 0.5 cutoff; mean occupancy 8, cap 16);
    below, the XLA-style cell list on an 8^3 grid. A near-uniform lattice
    plus 0.02-sigma jitter avoids Lennard-Jones blow-ups at t = 0;
    velocities have sigma 0.1."""
    n = 262144 if n is None else n
    big = n >= 32768
    cfg = SimConfig(
        force_law="lennard_jones", lj_epsilon=0.2, lj_sigma=0.15,
        particle_effect_radius=0.5, world_size=32.0,
        integrator="velocity_verlet", boundary="wrap", coefficient=0.0,
        neighbor="celllist_pallas" if big else "celllist",
        cell_grid=32 if big else 8,
        cell_capacity=16 if big else max(16, 4 * n // 512),
    ).validate()
    side = round(n ** (1 / 3))
    while side ** 3 < n:
        side += 1
    lin = torch.linspace(-15.5, 15.5, side, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
    jitter = 0.02 * torch.randn((n, 3), generator=gen, dtype=torch.float32)
    st = init_scene(gen, n, cfg, device)
    vel = 0.1 * torch.randn((n, 3), generator=gen, dtype=torch.float32)
    dev = st.positions.device
    return (st.replace(positions=(grid.reshape(-1, 3)[:n] + jitter).to(dev),
                       velocities=vel.to(dev)), cfg, 1e-3)


PRESETS: dict[str, Callable] = {
    "reference": _reference,
    "reference_walls": _reference_walls,
    "particle_life_large": _particle_life_large,
    "particle_life_1m": _particle_life_1m,
    "particle_life_large_allpairs": _particle_life_large_allpairs,
    "verlet_elastic": _verlet_elastic,
    "gravity_nbody": _gravity_nbody,
    "spring_lattice": _spring_lattice,
    "lj_gas": _lj_gas,
}


def list_presets() -> list[str]:
    return sorted(PRESETS)


def make_scene(name: str, seed: int = 0, n: int | None = None,
               device="cuda"):
    """-> (state, cfg, dt) for a preset, on the card unless ``device``
    says otherwise (raises without a card)."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; presets: {list_presets()}")
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return PRESETS[name](gen, n, device)


# The JAX bench's one-chip runs of the slab decomposition (bench.py, "slab
# stay-sharded" at N=2M and N=8M): particle life at 8 particles per unit^3,
# default 5-species matrix, dt 1/60, on a 1-rank mesh. Geometry and static
# capacities as the bench measured them: (44, 64) without the sidecar at
# 2M, tail-covering (68, 64) with a 128-row sidecar at 8M; mcap ~2.25x the
# movers per step, migcap 4,096 (one rank has no slab crossers).
SLAB_RUNS = {
    "slab_2m": dict(n=2_097_152, world_size=64.0, nsc=44, cap=64,
                    mcap=114_688, migcap=4096, ocap=0),
    "slab_8m": dict(n=8 * 1024 * 1024, world_size=100.0, nsc=68, cap=64,
                    mcap=419_840, migcap=4096, ocap=128),
}


def slab_run(name: str, **overrides):
    """-> (n, cfg, dt, kw) of a ``SLAB_RUNS`` entry, ``overrides`` replacing
    its values: ``kw`` holds the geometry and capacities that
    ``init_sharded_dense`` (nsc, cap, migcap) and ``sharded_dense_steps``
    (all of them) take."""
    r = {**SLAB_RUNS[name], **overrides}
    n = r.pop("n")
    cfg = SimConfig(world_size=r.pop("world_size"), neighbor="celllist_pallas",
                    cell_grid=r["nsc"], cell_capacity=r["cap"]).validate()
    return n, cfg, 1.0 / 60.0, r
