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
a fallback. JAX's ``particle_sharding`` / ``replicated`` have no
counterpart: each rank holds its own shard.
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
    group: Any = None  # the default process group; None at size 1

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
        right = (self.rank + 1) % self.size
        left = (self.rank - 1) % self.size
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
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
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
