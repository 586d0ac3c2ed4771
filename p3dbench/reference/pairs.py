"""Pairs inside a cutoff, counted in plain PyTorch from positions: the work
a force evaluation needs, whatever computes it."""

from __future__ import annotations

import torch

from .particle_life import CellTable


def ordered_pairs(pos, world: float, cutoff: float,
                  max_pairs: int = 1 << 25) -> int:
    """Ordered pairs (i, j), i != j, with 0 < |x_j - x_i| < cutoff under
    the minimum image of a periodic box."""
    pos = pos.to(torch.float32)
    tab = CellTable(pos, world, cutoff)
    ps = pos[tab.order]
    total = 0
    for i, j in tab.candidate_chunks(max_pairs):
        d = ps[j] - ps[i]
        d = d - world * torch.round(d / world)
        d2 = (d * d).sum(-1)
        total += int(((d2 > 0) & (d2 < cutoff * cutoff)).sum())
    return total


def unordered_pairs(pos, world: float, cutoff: float) -> float:
    return ordered_pairs(pos, world, cutoff) / 2
