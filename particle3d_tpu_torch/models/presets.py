"""Named scene presets (port of ``particle3d_tpu.models.presets``, the
presets of the exact particle-life path).

Every preset is ``(generator, n, device) -> (state, cfg, dt)``. Scenes are
drawn from a CPU ``torch.Generator`` seeded by ``make_scene``, so a seed
gives the same scene on every device (not the JAX package's scene: the two
frameworks' generators differ).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import reference_config
from ..state import init_scene


def _reference(gen, n, device):
    """The reference app's demo: N=1000 particle-life, periodic box."""
    n = 1000 if n is None else n
    cfg = reference_config()
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


PRESETS: dict[str, Callable] = {
    "reference": _reference,
    "particle_life_large": _particle_life_large,
    "particle_life_1m": _particle_life_1m,
}


def list_presets() -> list[str]:
    return sorted(PRESETS)


def make_scene(name: str, seed: int = 0, n: int | None = None, device="cpu"):
    """-> (state, cfg, dt) for a ported preset."""
    if name not in PRESETS:
        raise KeyError(f"preset {name!r} is not ported; ported presets: "
                       f"{list_presets()}")
    gen = torch.Generator().manual_seed(seed)
    return PRESETS[name](gen, n, torch.device(device))
