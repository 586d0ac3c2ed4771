"""Index compaction and scatter helpers (port of
``particle3d_tpu.ops.compaction``).

``masked_indices`` has exactly the semantics of ``jnp.nonzero(mask,
size=size, fill_value=fill_value)[0]``: ascending indices of the True
entries, truncated or padded to ``size``. The JAX package's MXU rank scan
works around a serial cumsum on the TPU and is not carried over.
``torch.nonzero`` synchronises with the device to learn the count.
"""

from __future__ import annotations

import torch


def masked_indices(mask: torch.Tensor, size: int,
                   fill_value: int | None = None) -> torch.Tensor:
    s = mask.shape[0]
    if fill_value is None:
        fill_value = s
    idx = torch.nonzero(mask).flatten()[:size]
    pad = size - idx.shape[0]
    if pad:
        idx = torch.cat([idx, torch.full((pad,), fill_value, dtype=idx.dtype,
                                         device=idx.device)])
    return idx


def index_add_rows(target: torch.Tensor, index: torch.Tensor,
                   values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``target.index_add(0, index, values)`` (out of place) for the rows
    where ``valid``; the other rows are dropped. Deterministic and free of
    host synchronisation.

    On CUDA, index_add sums duplicate indices with atomics in an order that
    changes from run to run, so it runs under a scoped deterministic mode,
    which sorts the indices and sums each run of equal ones in order. That
    sum is serial per index, so dropped rows must not share one drop row
    (thousands of padded worklist entries on one row measured ~5 ms a
    step): each goes to its own scratch row past the end, sliced off."""
    k = index.shape[0]
    n = target.shape[0]
    spill = n + torch.arange(k, device=index.device)
    buf = torch.cat([target, target.new_zeros((k,) + tuple(target.shape[1:]))])
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        buf = buf.index_add(0, torch.where(valid, index, spill), values)
    finally:
        torch.use_deterministic_algorithms(prev)
    return buf[:n]
