"""The least time an H100 could take for the force work a step needs.

Peaks: the H100 SXM's published dense rates at its 700 W limit.
Operations per pair: the two-sided count per unordered pair of the port's
``utils/bounds.py`` (deltas 3, d^2 5, two gates 2, park 1, law parts 10,
two directional scales 4, the i-side sums 6 and the j-side products and
sums 6; plus 7 for the box-unit wrap), an FMA counting two, all at the
FP32 rate; the law's coefficients are looked up from the species table,
which costs loads and no operations. Bytes: what the inputs and outputs
need, each once: positions (3 floats) and the species (one 32-bit index)
read, forces (3 floats) written, a particle.
"""

from __future__ import annotations

PEAK_FP32 = 67e12     # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # B/s, device memory


def ops_two_sided(wrap: bool) -> int:
    """FP32 operations per unordered pair."""
    return 37 + (7 if wrap else 0)


BYTES_PER_PARTICLE = 4 * (3 + 1 + 3)


def least_seconds(pairs: float, n: int, wrap: bool) -> float:
    """Least time for one force evaluation over ``pairs`` unordered pairs
    in the cutoff and ``n`` particles."""
    t_ops = pairs * ops_two_sided(wrap) / PEAK_FP32
    t_bytes = n * BYTES_PER_PARTICLE / PEAK_BYTES
    return max(t_ops, t_bytes)
