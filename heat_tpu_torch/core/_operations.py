"""Generic operation machinery: the reduction (port of
``heat_tpu.core._operations.__reduce_op``, :521; Heat reference:
heat/core/_operations.py:378).

A reduction runs the local partial reduce on this rank's shard and, when
it reduces the split axis of a distributed array, combines the partials
with one ``allreduce`` (reference :466-471). The output's split follows
``heat_tpu``'s rules: None when the split axis is reduced (or every axis),
else the split axis renumbered past the reduced axes, or kept where
``keepdims``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from . import types
from .dndarray import DNDarray
from .sanitation import sanitize_in
from .stride_tricks import sanitize_axis

__all__ = []


def _output_split(split: Optional[int], axes: Tuple[int, ...], reduce_all: bool, keepdims: bool) -> Optional[int]:
    if split is None or reduce_all or split in axes:
        return None
    if keepdims:
        return split
    return split - sum(1 for a in axes if a < split)


def __reduce_op(
    partial_op: Callable[[torch.Tensor, Tuple[int, ...], bool], torch.Tensor],
    x: DNDarray,
    axis: Optional[Union[int, Tuple[int, ...]]] = None,
    out: Optional[DNDarray] = None,
    keepdims: bool = False,
    combine: str = "sum",
    finish: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> DNDarray:
    """Reduce ``x`` over ``axis`` (None: every axis). ``partial_op(t,
    axes, keepdims)`` reduces a shard; ``combine`` names the
    ``allreduce`` op that merges the ranks' partials; ``finish`` (if given)
    maps the merged result to the output (a cast back, say)."""
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    reduce_all = axis is None
    axes = tuple(range(x.ndim)) if reduce_all else ((axis,) if isinstance(axis, int) else tuple(axis))
    split = x.split
    output_split = _output_split(split, axes, reduce_all, keepdims)
    result = partial_op(x.larray, axes, keepdims)
    if split is not None and split in axes and x.comm.is_distributed():
        result = x.comm.allreduce(result, combine)
    if finish is not None:
        result = finish(result)
    if keepdims:
        output_shape = tuple(1 if i in axes else s for i, s in enumerate(x.gshape))
    else:
        output_shape = tuple(s for i, s in enumerate(x.gshape) if i not in axes)
    lmap = None
    if output_split is not None:
        lmap = x.lshape_map
        lmap = lmap.copy() if keepdims else np.delete(lmap, list(axes), axis=1)
        if keepdims:
            lmap[:, list(axes)] = 1
    res_type = types.canonical_heat_type(result.dtype)
    if out is not None:
        sanitize_in(out)
        if out.gshape != output_shape:
            raise ValueError(f"out has shape {out.gshape}, expected {output_shape}")
        out.larray = result.to(out.dtype.torch_type())
        return out
    return DNDarray(result, output_shape, res_type, output_split, x.device, x.comm, lmap)
