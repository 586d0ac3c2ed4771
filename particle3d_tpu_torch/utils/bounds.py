"""The least time an H100 could take for a force kernel's work, from the
operations and bytes that work needs (``chip_smoke.py`` and
``utils/kernel_ab.py`` read every kernel against it).

Operations are counted per pair on the unpadded feature width P (5 columns
for five-species particle life; the kernels' zero padding to 8 or 16 is an
artefact of their layout, as is the padded-row mask). The rank-1
coefficient products U.V, and K5 fast mode's Gram product, are counted at
the tensor cores' TF32 rate, once a product, however an implementation
forms them; everything else at the FP32 rate. The two pipes run side by
side, so the operations take the longer of their two times. An FMA counts
two operations; any other (add, multiply, compare, select, min/max, abs,
rint, square root, division) one. Bytes: each input read once and each
output written once, over the device memory's rate. Peaks: the H100 SXM's
published dense rates at its 700 W limit.

Per pair, FP32 + TF32:
  one-sided (K1, K3), per ordered pair: deltas 3, d^2 5 (a multiply and two
    FMAs), gate and clamp 3, law 12 (sqrt, division, repulsion, the
    triangle's FMA 2, abs, 1 - x, max, 1/d, coefficient, branch compare and
    select), sums 6; plus 12 for K3's world-unit wrap (per axis a multiply
    by 1/w, rint and an FMA) | the coefficient 2P; under gravity the gate
    is 1 (d^2 < r^2) and the law 11 (d^2 > 0 and its and, the select of a
    safe d^2, the softening add, sqrt, division, the cube 2, coefficient
    times G times the cube 2, the select of 0), so 26 in place of 29;
  two-sided (K2, K4), per unordered pair: deltas 3, d^2 5, two gates 2,
    park 1, law parts 10, two directional scales 4, the i-side sums 6 and
    the j-side products and sums 6; plus 7 for the box-unit wrap (rint and
    a subtraction per axis) and the d^2 restore | two coefficients 4P;
  K5, per unordered pair: K2's count without the wrap, plus the fourth sum
    of each side (the ones column): the i-side four FMAs 8, the j-side four
    products and four sums 8 | 4P; fast mode replaces deltas 3 and d^2 5 by
    |p_i|^2 + |p_j|^2 1, 2 - 2 g an FMA 2, the sum 1 and the clamp 1, and
    the Gram product (a multiply and three FMAs, 7) moves to TF32. The
    index-diagonal mask (k = 0 only) and the per-row fix-ups and norms are
    not per pair and are not counted.
"""

from __future__ import annotations

PEAK_FP32 = 67e12    # FLOP/s outside the tensor cores
PEAK_TF32 = 495e12   # FLOP/s, tensor cores, dense
PEAK_BYTES = 3.35e12  # B/s, device memory


_ONE_SIDED_FP32 = {"particle_life": 29, "gravity": 26}


def ops_one_sided(p: int, wrap: bool,
                  law: str = "particle_life") -> tuple[int, int]:
    return _ONE_SIDED_FP32[law] + (12 if wrap else 0), 2 * p


def ops_two_sided(p: int, wrap: bool) -> tuple[int, int]:
    return 37 + (7 if wrap else 0), 4 * p


def ops_mxu(p: int, fast: bool) -> tuple[int, int]:
    return (38, 4 * p + 7) if fast else (41, 4 * p)


def bound(pairs: float, ops: tuple[int, int], nbytes: float):
    """(least ms, "operations" or "bytes", least ms with every operation
    at the FP32 rate, as the port counted before its tensor-core kernels)
    for ``pairs`` pairs of ``ops`` (FP32, TF32) operations each and
    ``nbytes`` bytes."""
    fp32, tf32 = ops
    t_ops = max(pairs * fp32 / PEAK_FP32, pairs * tf32 / PEAK_TF32)
    t_bytes = nbytes / PEAK_BYTES
    t_fp32_only = max(pairs * (fp32 + tf32) / PEAK_FP32, t_bytes)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", t_fp32_only * 1e3)
