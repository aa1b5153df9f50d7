"""Input validation and distribution matching (port of
``heat_tpu.core.sanitation``; Heat reference: heat/core/sanitation.py,
``sanitize_distribution`` at :31, ``sanitize_in`` at :158,
``sanitize_lshape`` at :212, ``sanitize_out`` at :254,
``sanitize_sequence`` at :322, ``scalar_to_1d`` at :341)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "sanitize_distribution",
    "sanitize_in",
    "sanitize_in_tensor",
    "sanitize_lshape",
    "sanitize_infinity",
    "sanitize_out",
    "sanitize_sequence",
    "scalar_to_1d",
]


def sanitize_distribution(*args, target, diff_map=None):
    """Bring every DNDarray of ``args`` to ``target``'s distribution
    (``heat_tpu`` sanitation.py:28; reference :31): an argument split along
    another axis than ``target``'s (counted from the trailing axes, as
    broadcasting aligns them) is resplit there through the planner, and one
    split there is moved by ``redistribute_`` to ``target``'s map of shard
    extents along it, or to the extents of ``diff_map`` (a (size, ndim) map
    of ``target``'s shape). Arguments where ``target`` is not split, that
    are not split, whose aligned axis does not exist or has extent 1 (it
    broadcasts) stay as they are. Returns the one argument, or a tuple of
    them."""
    sanitize_in(target)
    tsplit = target.split
    tmap = target.lshape_map if diff_map is None else np.asarray(diff_map, dtype=np.int64)
    out = []
    for arg in args:
        sanitize_in(arg)
        new_split = None if tsplit is None else tsplit - (target.ndim - arg.ndim)
        if tsplit is None or arg.split is None or new_split < 0 or arg.gshape[new_split] == 1:
            out.append(arg)
            continue
        if arg.split != new_split:
            arg = arg.resplit(new_split)
        counts = tmap[:, tsplit]
        if arg.is_distributed() and arg.gshape[new_split] == target.gshape[tsplit] and \
                not np.array_equal(arg.lshape_map[:, new_split], counts):
            target_map = arg.lshape_map
            target_map[:, new_split] = counts
            arg = arg.copy()
            arg.redistribute_(target_map=target_map)
        out.append(arg)
    if len(out) == 1:
        return out[0]
    return tuple(out)


def sanitize_in(x) -> None:
    """Verify ``x`` is a DNDarray (reference: sanitation.py:158)."""
    from .dndarray import DNDarray

    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")


def sanitize_in_tensor(x) -> None:
    """Verify ``x`` is a torch tensor (``heat_tpu``'s checks a jax array)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"input needs to be a torch.Tensor, but was {type(x)}")


def sanitize_lshape(array, tensor) -> None:
    """Verify that ``tensor`` can be a shard of ``array`` (reference:
    sanitation.py:212): its rank, every extent but the split axis's, and at
    most the global extent along it."""
    gshape = array.gshape
    lshape = tuple(tensor.shape)
    if len(lshape) != len(gshape):
        raise ValueError(f"tensor dims {len(lshape)} do not match array dims {len(gshape)}")
    split = array.split
    if split is None:
        if lshape != gshape:
            raise ValueError(f"tensor shape {lshape} does not match global shape {gshape}")
        return
    for i, (ls, gs) in enumerate(zip(lshape, gshape)):
        if i == split:
            if ls > gs:
                raise ValueError(f"local split extent {ls} exceeds global {gs}")
        elif ls != gs:
            raise ValueError(f"tensor shape {lshape} incompatible with global shape {gshape}")


def sanitize_out(out, output_shape, output_split=None, output_device=None, output_comm=None) -> None:
    """Verify that ``out`` is a DNDarray of the output's shape (``heat_tpu``
    sanitation.py:95); it keeps its own split, device and communicator."""
    from .dndarray import DNDarray

    if not isinstance(out, DNDarray):
        raise TypeError(f"expected out buffer to be a DNDarray, but was {type(out)}")
    if tuple(out.shape) != tuple(output_shape):
        raise ValueError(f"Expecting output buffer of shape {tuple(output_shape)}, got {tuple(out.shape)}")


def sanitize_sequence(seq) -> list:
    """``seq`` as a list; it must be a list or a tuple (reference:
    sanitation.py:322)."""
    if isinstance(seq, list):
        return seq
    if isinstance(seq, tuple):
        return list(seq)
    raise TypeError(f"seq must be a list or a tuple, got {type(seq)}")


def scalar_to_1d(x):
    """A 0-d DNDarray as a 1-D one of one element, not split (reference:
    sanitation.py:341); any other array as it is."""
    from .dndarray import DNDarray

    if x.ndim != 0:
        return x
    return DNDarray(x.larray.reshape(1), (1,), x.dtype, None, x.device, x.comm)


def sanitize_infinity(x):
    """The largest value of ``x``'s type, a stand-in for +inf that integer
    comparisons take (reference: sanitation.py:176): a float for inexact
    types, an int for integers, True for bool."""
    from . import types

    dtype = types.canonical_heat_type(x.dtype)
    if dtype is types.bool:
        return True
    if types.heat_type_is_inexact(dtype):
        return float(types.finfo(dtype).max)
    return int(types.iinfo(dtype).max)
