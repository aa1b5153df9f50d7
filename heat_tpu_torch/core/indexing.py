"""Indexing functions: ``nonzero`` and ``where``.

Port of ``heat_tpu.core.indexing`` (Heat reference: heat/core/indexing.py).
``nonzero`` of an array split across ranks runs ``heat_tpu``'s
``parallel.distributed_nonzero`` schedule (:767): each rank takes the
nonzero positions of its own rows, shifted by its row offset, and the
coordinates go to even split-0 chunks (one all-gather of the counts, one
all-to-all); the operand is never gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _keys, types
from ._operations import _as_dndarray, _local_operand, _output_counts
from .dndarray import DNDarray
from .sanitation import sanitize_in
from .stride_tricks import broadcast_shapes

__all__ = ["nonzero", "where"]


def nonzero(x: DNDarray) -> DNDarray:
    """The indices of the nonzero elements as an (nnz, ndim) int64 array
    in row-major order (``heat_tpu`` indexing.py:21), split 0 where ``x``
    is split. A split other than 0 is resplit to 0 first, as in
    ``heat_tpu``; a 0-d array raises ``ValueError``, as ``jnp.nonzero``
    does."""
    sanitize_in(x)
    if x.ndim == 0:
        raise ValueError("Calling nonzero on 0d arrays is not allowed. Use atleast_1d(scalar).nonzero() instead.")
    if not x.is_distributed():
        idx = torch.nonzero(x.larray)
        return DNDarray(idx, tuple(idx.shape), types.int64, 0 if x.split is not None else None, x.device, x.comm)
    a = x if x.split == 0 else x.resplit(0)
    idx = torch.nonzero(a.larray)
    idx[:, 0] += int(a.lshape_map[: a.comm.rank, 0].sum())
    return _keys.compact(a, idx, (x.ndim,))


def where(cond: DNDarray, x=None, y=None) -> DNDarray:
    """``x`` where ``cond`` holds, else ``y`` (``heat_tpu`` indexing.py:50),
    broadcast together, in ``types.result_type(x, y)``; with neither
    ``x`` nor ``y``, ``nonzero(cond)``. The result is split as ``cond``,
    else as the first of ``x``, ``y`` that is split and has the result's
    ndim (:67-82). Each rank computes its own rows; an operand split
    elsewhere is resplit to the result's split, a whole one sliced."""
    if x is None and y is None:
        return nonzero(cond)
    if x is None or y is None:
        raise TypeError("either both or neither of x and y should be given")
    sanitize_in(cond)
    promoted = types.result_type(x, y)
    tt = promoted.torch_type()
    ops = [cond] + [t if isinstance(t, DNDarray) or isinstance(t, (bool, int, float, complex)) else
                    _as_dndarray(t, cond) for t in (x, y)]
    shape = broadcast_shapes(*(t.gshape for t in ops if isinstance(t, DNDarray)))
    split = cond.split
    if split is None:
        split = next((t.split for t in ops[1:] if isinstance(t, DNDarray) and t.split is not None
                      and t.ndim == len(shape)), None)
    if split is not None and split >= len(shape):
        split = None
    comm = cond.comm
    counts = displs = lmap = None
    if split is not None and comm.is_distributed():
        for i, t in enumerate(ops):  # an operand split along another axis moves to the result's split
            dim = split - (len(shape) - t.ndim) if isinstance(t, DNDarray) else -1
            if dim >= 0 and t.is_distributed() and t.split != dim and t.gshape[dim] == shape[split]:
                ops[i] = t.resplit(dim)
        counts = _output_counts(ops, len(shape), split, shape, comm)
        displs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        lmap = comm.lshape_map(shape, split)
        lmap[:, split] = counts

    def local(t, dtype):
        if not isinstance(t, DNDarray):
            return t
        return _local_operand(t, len(shape), split, counts, displs).to(dtype)

    c = local(ops[0], torch.bool)
    xv, yv = local(ops[1], tt), local(ops[2], tt)
    if not isinstance(xv, torch.Tensor) and not isinstance(yv, torch.Tensor):
        xv = torch.tensor(xv, dtype=tt, device=c.device)
    res = torch.where(c, xv, yv)
    if res.dtype != tt:
        res = res.to(tt)
    return DNDarray(res.contiguous(), shape, promoted, split, cond.device, comm, lmap)
