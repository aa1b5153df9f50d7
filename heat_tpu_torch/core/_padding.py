"""Physical extents of split arrays (port of ``heat_tpu.core._padding``).

``heat_tpu`` stores a split array physically padded along ``split`` to a
multiple of the mesh size, so that every device holds one block of
``ceil(n / p)`` rows, the last ones zero. The port keeps ragged LOGICAL
shards instead: rank r holds only its ``chunk`` rows. Where a program is
written on ``heat_tpu``'s physical blocks (the redistribution executor),
the shard is padded to the block on entry (``pad_to``) and trimmed on
exit (``trim_to``), so that per-rank extents follow ``heat_tpu``'s
exactly: ``pad_extent(n, p) // p`` rows a rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["pad_extent", "pad_to", "phys_shape", "trim_to"]


def pad_extent(n: int, size: int) -> int:
    """Physical extent: n rounded up to a multiple of ``size``."""
    if size <= 1 or n == 0:
        return n
    return -(-n // size) * size


def phys_shape(gshape: Tuple[int, ...], split: Optional[int], size: int) -> Tuple[int, ...]:
    """Physical (padded) shape for a logical global shape."""
    if split is None or not gshape:
        return tuple(gshape)
    out = list(gshape)
    out[split] = pad_extent(out[split], size)
    return tuple(out)


def pad_to(t: torch.Tensor, axis: int, extent: int, fill=0) -> torch.Tensor:
    """``t`` padded with ``fill`` at the end of ``axis`` to ``extent``
    (``t`` itself when it is that long already)."""
    n = t.shape[axis]
    if n == extent:
        return t
    if n > extent:
        raise ValueError(f"pad_to: axis {axis} holds {n} > {extent}")
    shape = list(t.shape)
    shape[axis] = extent - n
    return torch.cat([t, t.new_full(shape, fill)], dim=axis)


def trim_to(t: torch.Tensor, axis: int, extent: int) -> torch.Tensor:
    """The first ``extent`` entries of ``t`` along ``axis``."""
    return t if t.shape[axis] == extent else t.narrow(axis, 0, extent)
