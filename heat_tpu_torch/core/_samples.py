"""The samples of an estimator's operands across ranks.

``heat_tpu``'s estimators read ``x.larray``, the whole logical array, and
let XLA place the collectives. The port's estimators take each rank's rows
(samples along axis 0) and state every collective: the rows of a label or
weight vector that go with this rank's rows of ``x``, the classes over
every rank, and statistics summed over the ranks in one all-reduce.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._operations import _whole
from .dndarray import DNDarray

__all__ = []


def rows(x: DNDarray) -> Tuple[DNDarray, torch.Tensor]:
    """``(x, t)``: ``x`` with its samples along axis 0 (an operand split
    along another axis is resplit to 0 first) and this rank's rows ``t``."""
    if x.is_distributed() and x.split != 0:
        x = x.resplit(0)
    return x, x.larray


def aligned(y: DNDarray, x: DNDarray) -> torch.Tensor:
    """The rows of ``y`` (samples along axis 0) that go with this rank's
    rows of ``x`` as ``rows`` returns it: ``y``'s own shard where ``y`` is
    split 0 with ``x``'s map, a slice where ``y`` is whole, else ``y``
    gathered and sliced."""
    if not x.is_distributed():
        return _whole(y)
    counts = x.lshape_map[:, 0]
    if y.is_distributed() and y.split == 0 and (y.lshape_map[:, 0] == counts).all():
        return y.larray
    whole = _whole(y)
    start = int(counts[: x.comm.rank].sum())
    return whole[start : start + int(counts[x.comm.rank])]


def summed(x: DNDarray, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks where ``x`` is distributed (one
    all-reduce), else ``t``."""
    return x.comm.allreduce(t) if x.is_distributed() else t


def classes(y: DNDarray) -> torch.Tensor:
    """The sorted distinct labels of ``y`` over every rank, the same on
    every rank: each rank's distinct labels, then one all-gather of their
    counts and one of the labels."""
    mine = torch.unique(y.larray.reshape(-1))
    if not y.is_distributed():
        return mine
    comm = y.comm
    counts = comm.allgather(torch.tensor([mine.numel()], dtype=torch.int64, device=mine.device))
    return torch.unique(comm.allgather(mine, 0, [int(c) for c in counts.tolist()]))
