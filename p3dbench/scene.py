"""The uniform particle-life scene, drawn from the seed.

The recipe of the port's ``bench.particle_life_scene`` and ``init_scene``:
positions uniform in [-w/2, w/2)^3, zero velocities, species uniform over
the configuration's species, unit masses. Drawn on the device with a
``torch.Generator`` of that device in three large calls, so that one seed
gives one scene on every card of a kind.
"""

from __future__ import annotations

import torch


def uniform_scene(seed: int, n: int, world: float, species: int, device):
    """(positions f32[n, 3], velocities f32[n, 3], species i64[n])."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    half = world / 2
    pos = torch.rand((n, 3), generator=gen, device=device) * world - half
    spc = torch.randint(0, species, (n,), generator=gen, device=device)
    return pos, torch.zeros_like(pos), spc
