"""Ring-sharded all-pairs forces (port of ``particle3d_tpu.parallel.ring``).

Each rank holds one shard of the particles. Every step, each rank computes
forces on its receivers from the source block it currently holds and
passes the block to its right neighbour; after D blocks every receiver has
seen every source. The exchange of the next block is posted before the
current block's forces, so transfer and compute overlap.

Shards may differ in size (N need not divide by the mesh size): blocks are
padded to the largest shard and a validity mask circulates with them.

``ring_forces_2level`` is the ring of a (hosts x devices) mesh
(``mesh.make_mesh_2d``): the block makes a full revolution of the fast
in-host ring between single hops across hosts, so only ``d_dcn`` of its
``d_dcn * d_ici`` hops leave a host.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..engine.step import step as _step
from ..ops import forces as F
from ..ops.allpairs import allpairs_forces
from ..state import ParticleState
from .mesh import Mesh, Mesh2D, balanced_counts


def masked_rect_operands(positions, u, src_pos, src_v, src_ok,
                         cfg: SimConfig):
    """K3's operands for the receivers against one source block, the
    masked sources (``src_ok`` False; None masks none) gated off through
    r2 = -1."""
    from ..ops.allpairs_sweep import rect_operands

    ops = list(rect_operands(positions, u, src_pos, src_v, cfg))
    if src_ok is not None:
        ops[4] = torch.where(src_ok, ops[4], -1.0)
    return ops


def _rect_forces(positions, u, src_pos, src_v, src_ok, cfg: SimConfig):
    """K3 on ``masked_rect_operands``; plain K3 on CPU tensors."""
    from ..ops.allpairs_sweep import rect_sweep

    return rect_sweep(*masked_rect_operands(positions, u, src_pos, src_v,
                                            src_ok, cfg))


def _block_forces(positions, u, src_pos, src_v, src_ok, cfg: SimConfig):
    """Forces on the receivers from one source block: K3 under
    ``allpairs_pallas``, plain all-pairs otherwise."""
    if cfg.neighbor == "allpairs_pallas":
        return _rect_forces(positions, u, src_pos, src_v, src_ok, cfg)
    return allpairs_forces(positions, u, None, cfg, src_positions=src_pos,
                           src_v=src_v, src_valid=src_ok)


def _masked_block_forces(positions, u, src_pos, src_v, src_ok,
                         cfg: SimConfig):
    """``ring_forces_masked``'s block: K3 on CUDA tensors whatever the
    backend, the plain all-pairs sweep on CPU tensors (the JAX package's
    XLA sweep)."""
    if positions.device.type == "cuda":
        return _rect_forces(positions, u, src_pos, src_v, src_ok, cfg)
    return allpairs_forces(positions, u, None, cfg, src_positions=src_pos,
                           src_v=src_v, src_valid=src_ok)


def _ring(positions, u, v, ok, cfg: SimConfig, mesh: Mesh, block_fn):
    acc = torch.zeros_like(positions)
    # the mask travels as floats (not every backend sends booleans)
    blocks = [positions, v] + ([] if ok is None else [ok.float()])
    for hop in range(mesh.size):
        pending = (mesh.exchange_start(to_right=blocks)
                   if hop < mesh.size - 1 else None)
        acc = acc + block_fn(positions, u, blocks[0], blocks[1],
                             None if ok is None else blocks[2] > 0.0, cfg)
        if pending is not None:
            blocks = pending.wait()[0]
    return acc


def ring_forces(positions, u, v, cfg: SimConfig, mesh: Mesh, ok=None):
    """Forces [n_local, 3] on this rank's receivers from every rank's
    sources. ``ok`` masks padding rows of the sources (all ranks must pass
    blocks of one size)."""
    return _ring(positions, u, v, ok, cfg, mesh, _block_forces)


def ring_forces_masked(positions, u, v, ok, cfg: SimConfig, mesh: Mesh):
    """``ring_forces`` over compacted row buffers: ``ok`` marks live rows
    and circulates with the sources (particle life's repulsion does not
    depend on the coefficient, so zero-V padding would still repel).
    Padding receivers compute garbage that callers drop. Each block is a
    masked rectangular sweep, K3 on the card whatever ``cfg.neighbor``
    says. The exact rung of the slab path
    (``domain_sharded.sharded_exact_steps``) runs on it."""
    return _ring(positions, u, v, ok, cfg, mesh, _masked_block_forces)


def ring_forces_2level(positions, u, v, cfg: SimConfig, mesh: Mesh2D):
    """Forces [n_local, 3] on this rank's receivers over a (dcn, ici) mesh:
    the source block circulates the ``ici`` ring once, then hops once along
    ``dcn``, ``d_dcn`` times. A block back from a full revolution is the
    one that started it, so the revolution's last hop and the final
    ``dcn`` hop are not sent; the blocks are summed in the JAX package's
    order. All ranks hold blocks of one size."""
    acc = torch.zeros_like(positions)
    blocks = [positions, v]
    d_dcn, d_ici = mesh.shape
    for outer in range(d_dcn):
        start = blocks
        for hop in range(d_ici):
            pending = (mesh.ici.exchange_start(to_right=blocks)
                       if hop < d_ici - 1 else None)
            acc = acc + _block_forces(positions, u, blocks[0], blocks[1],
                                      None, cfg)
            if pending is not None:
                blocks = pending.wait()[0]
        if outer < d_dcn - 1:
            blocks = mesh.dcn.ppermute(start, 1)
    return acc


def shard_state(state: ParticleState, mesh: Mesh) -> ParticleState:
    """This rank's shard of a full state: a contiguous block of rows, n // D
    of them (one more on the first n % D ranks)."""
    counts = balanced_counts(state.n, mesh.size)
    lo = sum(counts[:mesh.rank])
    hi = lo + counts[mesh.rank]
    return ParticleState(*(getattr(state, f)[lo:hi]
                           for f in ParticleState.__dataclass_fields__))


def _padded_accel(state: ParticleState, cfg: SimConfig, mesh: Mesh):
    """accel_fn for this rank's shard: ring forces, with padding and a
    validity mask when the shards differ in size (one collective to learn
    the sizes)."""
    n_loc = state.n
    sizes = mesh.all_gather(torch.tensor([n_loc], device=state.positions.device))
    m = int(sizes.max())
    ragged = int(sizes.min()) != m
    kick = float(F.kick_scale(cfg))
    u, v = F.pair_features(state, cfg)
    ok = None
    if ragged:
        pad = m - n_loc
        u = torch.cat([u, u.new_zeros((pad, u.shape[1]))])
        v = torch.cat([v, v.new_zeros((pad, v.shape[1]))])
        ok = torch.arange(m, device=u.device) < n_loc

    def accel_fn(positions, st, c):
        if ragged:
            positions = torch.cat([positions,
                                   positions.new_zeros((m - n_loc, 3))])
        return ring_forces(positions, u, v, c, mesh, ok)[:n_loc] * kick

    return accel_fn


def sharded_step(state: ParticleState, cfg: SimConfig, dt,
                 mesh: Mesh) -> ParticleState:
    """One step of this rank's shard (``shard_state``) with ring forces."""
    return _step(state, cfg, dt, accel_fn=_padded_accel(state, cfg, mesh))


def sharded_simulate(state: ParticleState, cfg: SimConfig, dt, num_steps: int,
                     mesh: Mesh) -> ParticleState:
    """``num_steps`` steps of this rank's shard: one D-hop ring per force
    evaluation. Species and masses do not change, so the pair features and
    the shard sizes are settled once."""
    accel_fn = _padded_accel(state, cfg, mesh)
    for _ in range(num_steps):
        state = _step(state, cfg, dt, accel_fn=accel_fn)
    return state
