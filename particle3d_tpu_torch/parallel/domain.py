"""Compute-sharded cell-list forces: the column-slab decomposition (port of
``particle3d_tpu.parallel.domain``).

The state is replicated: every rank holds the whole cadenced layout
(``ops.celllist_sweep.CellLayout``) and the whole state, and integrates all
of it. Only the force sweep is split: rank r sweeps the supercell grid's
x-planes ``[r * nsc / D, (r + 1) * nsc / D)`` with K1 in halo mode, and one
``all_gather`` of the slot forces a step puts them back in global column
order. The slab decomposition with sharded state is
``parallel.domain_sharded``; the ring (``parallel.ring``) shards all-pairs
laws.

Each rank's K1 call reads its planes as receivers and, as sources, those
planes plus one plane on each side taken from the replicated layout: the
same operands as ``domain_sharded``'s halo call, with no exchange. The
positions are folded next to their cells as ``dense_forces`` folds them,
the halo planes across the global x seam are shifted by -+w (the kernel
applies no x image shift in halo mode; ``domain_sharded.fix_halos``), and
the z ghosts carry the +-w shift. So the forces are those of the
single-device ``dense_forces`` on the same layout; at one rank the same
kernel instance runs on the same values.

The JAX module rolls the column axis instead, so that each device's slab
starts at column 0, and leaves out the fold and the z image shift of the
ghost rows; on a periodic box with pairs across the seams its forces
differ from the single-device path's (ROADMAP.md queue 3). That roll is not
ported. Periodic boxes only, as in the JAX module.

The layout's source features and gates do not change between rebuilds:
``sharded_cell_simulate`` cuts each rank's share of them once a layout;
only the positions are folded, cut and ghosted every step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SimConfig
from ..ops.celllist_sweep import (CellLayout, column_sweep_forces,
                                  fold_to_cells, ghost_positions)
from ..ops.params import pack_params
from ..state import ParticleState
from .domain_sharded import fix_halos
from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class _RankSlab:
    """One rank's K1 operands that a layout fixes: receiver columns
    ``[c0, c1)``, its source columns (the receivers' planes and one plane on
    each side, wrapped), and their features and gates."""

    c0: int
    c1: int
    src_cols: torch.Tensor  # i64 [(planes + 2) * nsc]
    u_d: torch.Tensor       # f32 [c1 - c0, P, CS]
    vt_g: torch.Tensor      # f32 [len(src_cols), P, G]
    r2_g: torch.Tensor      # f32 [len(src_cols), 1, G]


def _check(cfg: SimConfig, nsc: int, mesh: Mesh):
    if not cfg.wrap_forces:
        raise ValueError(
            "the column-slab decomposition supports periodic boxes only, as "
            "in the JAX package; walled boxes run sharded through "
            "parallel.domain_sharded (state-sharded slabs) or "
            "parallel.sharded_simulate (ring)")
    if nsc % mesh.size:
        raise ValueError(f"nsc={nsc} must divide by mesh size {mesh.size}")


def _rank_slab(layout: CellLayout, cfg: SimConfig, nsc: int,
               mesh: Mesh) -> _RankSlab:
    planes = nsc // mesh.size
    p0 = mesh.rank * planes
    dev = layout.u_d.device
    src_planes = torch.arange(p0 - 1, p0 + planes + 1, device=dev) % nsc
    src_cols = (src_planes[:, None] * nsc
                + torch.arange(nsc, device=dev)[None]).reshape(-1)
    return _RankSlab(
        c0=p0 * nsc, c1=(p0 + planes) * nsc, src_cols=src_cols,
        u_d=layout.u_d[p0 * nsc:(p0 + planes) * nsc].contiguous(),
        vt_g=layout.vt_g[src_cols].contiguous(),
        r2_g=layout.r2_g[src_cols].contiguous())


def _slab_forces(rs: _RankSlab, pos_flat, cfg: SimConfig, nsc: int, cap: int,
                 mesh: Mesh):
    """K1 halo on this rank's planes, gathered: f32 [NCOL*CS, 3]."""
    ncol, cs = nsc * nsc, nsc * cap
    pos_r = fold_to_cells(pos_flat.reshape(ncol, cs, 3).float(),
                          cfg.world_size, nsc, cap)
    src = pos_r[rs.src_cols]
    left, right = fix_halos(src[:nsc], src[-nsc:], cfg, mesh.size, mesh.rank)
    src = torch.cat([left, src[nsc:-nsc], right])
    out = column_sweep_forces(
        pos_r[rs.c0:rs.c1].permute(0, 2, 1).contiguous(), rs.u_d,
        ghost_positions(src, cfg, cap), rs.vt_g, rs.r2_g, pack_params(cfg),
        cfg.force_law, True, nsc, cap, halo=True)
    return mesh.all_gather(out).permute(0, 2, 1).reshape(-1, 3)


def sharded_dense_forces(layout: CellLayout, pos_flat, cfg: SimConfig,
                         nsc: int, cap: int, mesh: Mesh):
    """Forces f32 [NCOL*CS, 3] for positions already in the layout's slots
    (replicated: every rank passes the same ``layout`` and ``pos_flat``),
    this rank's x-planes swept by K1 in halo mode and the planes of all
    ranks gathered; exactly 0 on empty slots. Equal to the single-device
    ``ops.celllist_sweep.dense_forces`` on the same layout (module
    docstring). Periodic boxes and ``nsc`` divisible by the mesh size
    only (``ValueError`` otherwise)."""
    _check(cfg, nsc, mesh)
    return _slab_forces(_rank_slab(layout, cfg, nsc, mesh), pos_flat, cfg, nsc,
                        cap, mesh)


def sharded_cell_simulate(state: ParticleState, cfg: SimConfig, dt,
                          num_steps: int, mesh: Mesh, rebuild_every: int = 8,
                          nsc: int | None = None, cap: int | None = None):
    """Cadenced cell-list trajectory (``engine.step.simulate_cadenced``)
    with the force sweep split over the mesh's ranks. The state enters and
    leaves replicated; every ``rebuild_every`` steps each rank rebuilds
    the layout, cuts its share of the layout's features and gates, and in
    between one K1 launch and one ``all_gather`` a step give the forces.
    ``num_steps`` must be a multiple of ``rebuild_every``. Returns
    ``(state, max_drift)``, the drift a device scalar (check it against
    ``ops.celllist_sweep.drift_budget``)."""
    from ..engine.step import _cadenced_window

    nsc = cfg.cell_grid if nsc is None else nsc
    cap = cfg.cell_capacity if cap is None else cap
    if nsc is None or cap is None:
        raise ValueError("sharded_cell_simulate needs cfg.cell_grid / "
                         "cfg.cell_capacity")
    if num_steps % rebuild_every:
        raise ValueError(f"num_steps={num_steps} must be a multiple of "
                         f"rebuild_every={rebuild_every}")
    _check(cfg, nsc, mesh)

    def forces_for(layout):
        rs = _rank_slab(layout, cfg, nsc, mesh)
        return lambda pos_flat, c: _slab_forces(rs, pos_flat, c, nsc, cap,
                                                mesh)

    max_drift = torch.zeros((), device=state.positions.device)
    for _ in range(num_steps // rebuild_every):
        state, drift, _ = _cadenced_window(state, cfg, dt, rebuild_every, nsc,
                                           cap, forces_for=forces_for)
        max_drift = torch.maximum(max_drift, drift)
    return state, max_drift
