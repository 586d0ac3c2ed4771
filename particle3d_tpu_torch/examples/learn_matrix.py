"""Differentiable simulation: recover a hidden attraction matrix by
gradient descent through the simulator (port of the JAX package's
``examples/learn_matrix.py``).

The step is plain torch on the ``allpairs`` backend, so autograd flows
through a whole trajectory. This example:

  1. simulates a short trajectory of a batch of scenes with a hidden 3x3
     attraction matrix,
  2. observes only a few position snapshots,
  3. recovers the matrix by Adam on the capped snapshot mismatch, with
     ``torch.utils.checkpoint`` on each step so the backward pass keeps
     one state a step instead of every intermediate of the pair sweep.

The scenes of the batch step together through ``torch.func.vmap``. Runs on
the card unless asked for the CPU:

    python -m particle3d_tpu_torch.examples.learn_matrix
    python -m particle3d_tpu_torch.examples.learn_matrix --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import SimConfig
from ..engine.step import step
from ..state import ParticleState, init_scene, resolve_device

HIDDEN = np.array([[0.6, -0.9, 0.3],
                   [0.4, 0.5, -0.7],
                   [-0.5, 0.8, 0.2]], np.float32)
LOSS_CAP = 0.09  # per-particle squared error cap


def scene_config(k: int, world_size: float) -> SimConfig:
    """The example's law: k species, radius 2, drag 2, force 2, zero
    matrix (``attraction_matrix`` is replaced by the matrix learned)."""
    return SimConfig(
        world_size=world_size, id_count=k, particle_effect_radius=2.0,
        coefficient=2.0, interaction_force=2.0, min_pull_ratio=0.3,
        attraction_matrix=np.zeros((k, k), np.float32)).validate()


def init_batch(seed: int, batch: int, n: int, cfg: SimConfig, device):
    """(positions [B, N, 3], velocities [B, N, 3], species [B, N]) of
    ``batch`` scenes drawn by ``init_scene`` from one CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    sts = [init_scene(gen, n, cfg, device) for _ in range(batch)]
    return tuple(torch.stack([getattr(s, f) for s in sts])
                 for f in ("positions", "velocities", "species"))


def snapshots(matrix, batch, cfg0: SimConfig, dt, steps: int,
              snapshot_every: int):
    """Positions [B, steps // snapshot_every, N, 3] of the batch's
    trajectories under ``matrix``, one snapshot every ``snapshot_every``
    steps; differentiable with respect to ``matrix`` and the initial
    positions and velocities."""
    pos, vel, species = batch
    n = pos.shape[1]
    masses = torch.ones(n, dtype=torch.float32, device=pos.device)
    zero = torch.zeros((n, 3), dtype=torch.float32, device=pos.device)

    def one(p, v, s, m):
        cfg = cfg0.replace(attraction_matrix=m)
        out = step(ParticleState(p, v, s, masses, zero), cfg, dt)
        return out.positions, out.velocities

    batched = torch.func.vmap(one, in_dims=(0, 0, 0, None))

    def body(p, v, m):
        return batched(p, v, species, m)

    snaps = []
    for _ in range(steps // snapshot_every):
        for _ in range(snapshot_every):
            pos, vel = checkpoint(body, pos, vel, matrix, use_reentrant=False)
        snaps.append(pos)
    return torch.stack(snaps, dim=1)


def snapshot_loss(pred, target):
    """Mean over particles of the squared snapshot error, capped at
    ``LOSS_CAP`` so one near-coincident pair whose slingshot diverges
    cannot dominate the gradient (see the JAX example)."""
    d2 = torch.sum((pred - target) ** 2, dim=-1)
    return torch.mean(torch.clamp(d2, max=LOSS_CAP))


def learn(hidden, batch, cfg0: SimConfig, dt, steps: int,
          snapshot_every: int, iters: int, lr: float, log=None):
    """Adam (clipped to global norm 1) from a zero matrix towards the
    snapshots of ``hidden``. Returns (matrix, losses), one loss an
    iteration, taken before its update."""
    with torch.no_grad():
        target = snapshots(hidden, batch, cfg0, dt, steps, snapshot_every)
    mat = torch.zeros_like(hidden, requires_grad=True)
    opt = torch.optim.Adam([mat], lr=lr)
    losses = []
    for i in range(iters):
        opt.zero_grad()
        loss = snapshot_loss(
            snapshots(mat, batch, cfg0, dt, steps, snapshot_every), target)
        loss.backward()
        torch.nn.utils.clip_grad_norm_([mat], 1.0)
        opt.step()
        losses.append(loss.item())
        if log is not None and (i % 20 == 0 or i == iters - 1):
            err = float(torch.max(torch.abs(mat.detach() - hidden)))
            log(f"iter {i:4d}  loss {losses[-1]:.3e}  "
                f"max |matrix error| {err:.3f}")
    return mat.detach(), losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--snapshot-every", type=int, default=3)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    k = HIDDEN.shape[0]
    hidden = torch.tensor(HIDDEN, device=device)
    cfg0 = scene_config(k, 10.0)
    batch = init_batch(0, 4, args.n, cfg0, device)
    mat, losses = learn(hidden, batch, cfg0, 1.0 / 30.0, args.steps,
                        args.snapshot_every, args.iters, args.lr, log=print)
    print("\nhidden matrix:\n", HIDDEN)
    print("recovered matrix:\n", np.round(mat.cpu().numpy(), 3))
    return mat, losses


if __name__ == "__main__":
    main()
