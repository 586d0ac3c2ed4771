"""Particle life as the reference simulator states it, in plain PyTorch.

The law (the reference's ``src/lib.rs``): a pair at distance d inside the
effect radius pulls particle i towards j by

    d < m:          d / m - 1                      (repulsion, any species)
    m < d < 1:      A[s_i, s_j] (1 - |2d - 1 - m| / (1 - m))
    otherwise:      0

with m the minimum pull ratio, along the unit vector i -> j under the
minimum image of the periodic box; the sum is scaled by interaction force
times effect radius into an acceleration. Euler, in the reference's
order: v += a dt, v += gravity dt, v -= v c dt (c the drag coefficient),
x += v dt, then each coordinate wraps once into [-w/2, w/2].

Only pairs closer than 1 contribute, so the sum runs over the candidates
of a cell table of width >= 1/2 that this module builds itself: the
5 x 5 x 5 cells around a particle's own hold every partner. Everything is
computed in the dtype of the positions handed in (float64 for the
reference), over candidate pairs in chunks, so that it fits beside the
program's freed state.
"""

from __future__ import annotations

import torch

# the law is zero from this distance on
CUTOFF = 1.0

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest, ties
    away from zero, as the tensor cores take a float32 operand."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


# cells per cutoff along an axis: finer cells enumerate fewer candidates
SUBDIV = 2


class CellTable:
    """Particles sorted by cell of an nc^3 grid of width >= cutoff /
    SUBDIV, with each cell's start and count in the sorted order (x-major
    cell ids), and each cell's neighbour cells within reach of the cutoff."""

    def __init__(self, pos, world: float, cutoff: float = CUTOFF):
        dev = pos.device
        nc = max(2 * SUBDIV + 1, int(world * SUBDIV / cutoff + 1e-9))
        width = world / nc
        c = torch.floor((pos.double() + world / 2) / width).to(torch.int64)
        c = c.clamp(0, nc - 1)
        cid = (c[:, 0] * nc + c[:, 1]) * nc + c[:, 2]
        self.order = torch.argsort(cid, stable=True)
        self.cid = cid[self.order]
        self.counts = torch.bincount(cid, minlength=nc ** 3)
        self.starts = torch.cumsum(self.counts, 0) - self.counts
        self.nc, self.world = nc, world
        r = range(-SUBDIV, SUBDIV + 1)
        offs = torch.tensor([(a, b, d) for a in r for b in r for d in r],
                            device=dev)
        i = torch.arange(nc ** 3, device=dev)
        xyz = torch.stack([i // (nc * nc), (i // nc) % nc, i % nc], 1)
        nb = (xyz[:, None, :] + offs[None]) % nc
        self.nbrs = (nb[..., 0] * nc + nb[..., 1]) * nc + nb[..., 2]  # [C, K]

    def candidate_chunks(self, max_pairs: int):
        """(i, j) index pairs into the sorted order: every row against
        every row of its neighbour cells, in chunks of about ``max_pairs``
        pairs."""
        per_cell = self.counts[self.nbrs].sum(1)
        cum = torch.cumsum(per_cell[self.cid], 0)
        n = self.cid.shape[0]
        bounds = [0]
        total = int(cum[-1]) if n else 0
        for k in range(1, -(-total // max_pairs)):
            bounds.append(int(torch.searchsorted(cum, k * max_pairs)))
        bounds.append(n)
        k = self.nbrs.shape[1]
        for a, b in zip(bounds, bounds[1:]):
            if b <= a:
                continue
            rows = torch.arange(a, b, device=cum.device)
            nb = self.nbrs[self.cid[rows]]                     # [R, K]
            cnt = self.counts[nb].reshape(-1)
            st = self.starts[nb].reshape(-1)
            rep = torch.repeat_interleave(
                torch.arange(cnt.shape[0], device=cnt.device), cnt)
            first = torch.cumsum(cnt, 0) - cnt
            j = st[rep] + torch.arange(rep.shape[0], device=cnt.device) \
                - first[rep]
            yield rows[rep // k], j


def accelerations(pos, species, law: dict, max_pairs: int = 1 << 24,
                  geometry_pos=None):
    """Pair accelerations [N, 3] from every particle, in ``pos``'s dtype.
    ``law`` holds world_size,
    attraction_matrix, min_pull_ratio, interaction_force and
    particle_effect_radius. ``geometry_pos`` (default ``pos``) are the
    positions the displacements are taken from: the control passes them
    rounded to a lower precision."""
    dev, dt_ = pos.device, pos.dtype
    world = float(law["world_size"])
    gpos = pos if geometry_pos is None else geometry_pos
    a_mat = torch.as_tensor(law["attraction_matrix"], dtype=dt_, device=dev)
    m = float(law["min_pull_ratio"])
    r = float(law["particle_effect_radius"])
    kick = float(law["interaction_force"]) * r
    tab = CellTable(pos, world)
    gs = gpos[tab.order].to(dt_)
    ss = species[tab.order]
    force = torch.zeros((pos.shape[0], 3), dtype=dt_, device=dev)
    for i, j in tab.candidate_chunks(max_pairs):
        delta = gs[j] - gs[i]
        delta = delta - world * torch.round(delta / world)
        d2 = (delta * delta).sum(-1)
        ok = (d2 > 0) & (d2 < min(r, CUTOFF) ** 2)
        i, j, delta, d2 = i[ok], j[ok], delta[ok], d2[ok]
        d = torch.sqrt(d2)
        coef = a_mat[ss[i], ss[j]]
        tri = coef * (1 - torch.abs(2 * d - 1 - m) / (1 - m))
        mag = torch.where(d < m, d / m - 1,
                          torch.where(d > m, tri, torch.zeros_like(d)))
        force.index_add_(0, tab.order[i], delta * (mag / d)[:, None])
    return force * kick


def euler_step(pos, vel, species, law: dict, dt: float, geometry_pos=None):
    """One step of the reference's Euler update; returns (pos, vel)."""
    a = accelerations(pos, species, law, geometry_pos=geometry_pos)
    g = torch.as_tensor(law.get("acceleration", [0.0, 0.0, 0.0]),
                        dtype=pos.dtype, device=pos.device)
    vel = vel + a * dt
    vel = vel + g * dt
    vel = vel - vel * (float(law["coefficient"]) * dt)
    pos = pos + vel * dt
    half = float(law["world_size"]) / 2
    w = float(law["world_size"])
    pos = torch.where(pos > half, pos - w, torch.where(pos < -half, pos + w, pos))
    return pos, vel
