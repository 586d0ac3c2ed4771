"""The 1-D device mesh of the slab and ring decompositions and its
collectives (port of ``particle3d_tpu.parallel.mesh``).

JAX's mesh is a set of devices that one program spans; here each rank of a
``torch.distributed`` process group is one process on one device, and a
``Mesh`` holds that rank's view: the group, its rank and size, and its
device. The collectives the parallel code needs are methods:

  * ``ppermute`` / ``exchange_start``: every rank sends tensors to its
    right (``+1``) and/or left (``-1``) neighbour on the ring and receives
    the same shapes from the opposite side, as ``jax.lax.ppermute`` with a
    cyclic permutation. All the messages of one call are posted together
    (``dist.batch_isend_irecv``), so no ordering of ranks can deadlock; at
    a mesh of 2, where both neighbours are one rank, tags keep the
    directions apart. ``exchange_start`` returns before the transfer ends,
    so compute can run meanwhile.
  * ``pmax`` / ``psum``: ``all_reduce`` of a tensor;
  * ``all_gather``: the tiled gather (rank blocks concatenated in order).

At size 1 a permute to self returns its inputs, as it does on a 1-device
JAX mesh, and the reductions are the identity: that is their meaning, not
a fallback. The JAX module's ``make_mesh`` and ``make_mesh_2d`` have
their counterparts here; its ``particle_sharding`` and ``replicated`` name
placements of a global array, and here each rank holds its own shard
instead (``ring.shard_state``, ``launch.shard_state_2level``).

A ``Mesh`` may span a subgroup of the process group: ``ranks`` lists the
global rank of each of its members, in mesh order, and the ring's peers
are taken from it (``torch.distributed``'s point-to-point calls address
global ranks). ``make_mesh_2d`` builds the (hosts x devices) mesh of the
2-level ring: a ``Mesh2D`` holding two such 1-D views, ``ici`` over the
devices of one host and ``dcn`` across the hosts.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from ..state import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of a 1-D mesh of ``size`` ranks."""

    size: int
    rank: int
    device: torch.device
    group: Any = None  # the process group; None at size 1
    # global rank of each member in mesh order; None: the WORLD group,
    # where member r is global rank r
    ranks: tuple[int, ...] | None = None

    def _global(self, member: int) -> int:
        member %= self.size
        return member if self.ranks is None else self.ranks[member]

    def exchange_start(self, to_right=(), to_left=()):
        """Post one batch of ring exchanges: each tensor of ``to_right``
        goes to rank + 1 and each of ``to_left`` to rank - 1, and the same
        shapes come back from the other side. Returns a handle whose
        ``wait()`` gives ``(from_left, from_right)``, the lists received
        from rank - 1 and from rank + 1. Inputs must not change until then.
        Sends are posted right then left, receives left then right, each in
        list order, and every message carries its own tag: at size 2, where
        both neighbours are one rank, the two directions cannot cross."""
        to_right = [t.contiguous() for t in to_right]
        to_left = [t.contiguous() for t in to_left]
        if self.size == 1:
            return _Done((to_right, to_left))
        right = self._global(self.rank + 1)
        left = self._global(self.rank - 1)
        from_left = [torch.empty_like(t) for t in to_right]
        from_right = [torch.empty_like(t) for t in to_left]
        ops = [dist.P2POp(dist.isend, t, right, self.group, 2 * k)
               for k, t in enumerate(to_right)]
        ops += [dist.P2POp(dist.isend, t, left, self.group, 2 * k + 1)
                for k, t in enumerate(to_left)]
        ops += [dist.P2POp(dist.irecv, t, left, self.group, 2 * k)
                for k, t in enumerate(from_left)]
        ops += [dist.P2POp(dist.irecv, t, right, self.group, 2 * k + 1)
                for k, t in enumerate(from_right)]
        return _Pending(dist.batch_isend_irecv(ops), (from_left, from_right))

    def ppermute(self, tensors, shift: int):
        """``jax.lax.ppermute`` along the ring: send to rank + shift,
        receive from rank - shift (shift = +1 or -1)."""
        if shift == 1:
            return self.exchange_start(to_right=tensors).wait()[0]
        if shift == -1:
            return self.exchange_start(to_left=tensors).wait()[1]
        raise ValueError(f"ppermute shift must be +-1, got {shift}")

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return x
        x = x.clone()
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (same shape on all ranks), concatenated in
        rank order along dim 0."""
        if self.size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


class _Done:
    def __init__(self, out):
        self._out = out

    def wait(self):
        return self._out


class _Pending:
    def __init__(self, works, out):
        self._works, self._out = works, out

    def wait(self):
        for w in self._works:
            w.wait()
        return self._out


def balanced_counts(n: int, d: int) -> list[int]:
    """Rows per rank when n rows split over d ranks: n // d each, one more
    on the first n % d (N need not divide by the mesh size)."""
    return [n // d + (1 if r < n % d else 0) for r in range(d)]


def _rank_device(device) -> torch.device:
    """``device`` resolved for this rank: a bare "cuda" is the current
    card (``initialize_distributed`` sets it to ``cuda:<local rank>``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The mesh of this rank. ``n_devices=1`` needs no process group; a
    larger mesh needs an initialised group (``launch.initialize_distributed``)
    of exactly that size and raises otherwise, as the JAX package raises
    when fewer devices exist than requested. ``None`` takes the group's
    size (1 without one). ``device`` defaults to the card: on a CUDA mesh
    of several ranks each takes ``cuda:<local rank>`` as its current device
    (``initialize_distributed`` sets it)."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    if n_devices is None:
        n_devices = world
    dev = _rank_device(device)
    if n_devices == 1:  # this rank alone: no collective is ever issued
        return Mesh(1, 0, dev, None)
    if not initialised:
        raise ValueError(
            f"make_mesh: {n_devices} ranks requested but torch.distributed "
            f"is not initialised (launch one process per rank, e.g. torchrun "
            f"--nproc_per_node={n_devices}, and call initialize_distributed)")
    if world != n_devices:
        raise ValueError(f"make_mesh: {n_devices} ranks requested but the "
                         f"process group has {world}")
    return Mesh(n_devices, dist.get_rank(), dev, dist.group.WORLD)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A rank's view of a (dcn, ici) mesh of ``dcn * ici`` ranks, global
    rank ``i * ici + j`` at row i, column j: ``ici`` is row i's 1-D mesh
    (one host's devices), ``dcn`` column j's (one device of each host).
    Particle blocks follow the global ranks, as JAX's ``P(("dcn",
    "shard"))`` orders them."""

    dcn: Mesh
    ici: Mesh

    @property
    def shape(self) -> tuple[int, int]:
        return self.dcn.size, self.ici.size

    @property
    def size(self) -> int:
        return self.dcn.size * self.ici.size

    @property
    def rank(self) -> int:
        return self.dcn.rank * self.ici.size + self.ici.rank

    @property
    def device(self) -> torch.device:
        return self.ici.device


def make_mesh_2d(dcn: int, ici: int, device="cuda") -> Mesh2D:
    """The (hosts x devices) mesh over every rank of the process group,
    which must hold exactly ``dcn * ici`` ranks (a 1 x 1 mesh needs none).
    Every rank creates every subgroup, rows then columns, in one order, as
    ``torch.distributed.new_group`` requires."""
    if dcn < 1 or ici < 1:
        raise ValueError(f"make_mesh_2d: bad shape {dcn}x{ici}")
    dev = _rank_device(device)
    if dcn * ici == 1:
        one = Mesh(1, 0, dev, None)
        return Mesh2D(one, one)
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    if world != dcn * ici:
        raise ValueError(f"make_mesh_2d: {dcn}x{ici} ranks requested but the "
                         f"process group has {world}"
                         + ("" if initialised else " (not initialised)"))
    me = dist.get_rank()

    def view(rows, size, member):
        mine = None
        for ranks in rows:
            ranks = tuple(ranks)
            group = dist.new_group(list(ranks)) if size > 1 else None
            if me in ranks:
                mine = Mesh(size, member, dev, group,
                            ranks if size > 1 else None)
        return mine

    i, j = divmod(me, ici)
    ici_mesh = view([range(a * ici, (a + 1) * ici) for a in range(dcn)], ici,
                    j)
    dcn_mesh = view([range(b, dcn * ici, ici) for b in range(ici)], dcn, i)
    return Mesh2D(dcn_mesh, ici_mesh)
