"""Shape/axis sanitization helpers (from ``heat_tpu.core.stride_tricks``;
Heat reference: heat/core/stride_tricks.py, ``sanitize_axis`` at :115).
Pure geometry, no device code.
"""

from __future__ import annotations

import numpy as np

from typing import Optional, Tuple, Union

__all__ = ["broadcast_shape", "broadcast_shapes", "sanitize_axis", "sanitize_shape"]


def broadcast_shape(shape_a: Tuple[int, ...], shape_b: Tuple[int, ...]) -> Tuple[int, ...]:
    """Broadcast shape of two operands per NumPy rules; raises ValueError on
    incompatibility (reference: stride_tricks.py:12)."""
    return broadcast_shapes(shape_a, shape_b)


def broadcast_shapes(*shapes: Tuple[int, ...]) -> Tuple[int, ...]:
    """Broadcast shape of N operands (reference: stride_tricks.py:70)."""
    try:
        return tuple(int(s) for s in np.broadcast_shapes(*shapes))
    except ValueError:
        raise ValueError(f"operands could not be broadcast, input shapes {shapes}")


def sanitize_axis(
    shape: Tuple[int, ...], axis: Optional[Union[int, Tuple[int, ...]]]
) -> Optional[Union[int, Tuple[int, ...]]]:
    """Check axis validity against ``shape`` and normalize negatives
    (reference: stride_tricks.py:115)."""
    ndim = len(shape)

    if axis is None:
        return None

    if isinstance(axis, (list, tuple)):
        axes = tuple(int(a) for a in axis)
        out = []
        for a in axes:
            if not isinstance(a, (int, np.integer)):
                raise TypeError(f"axis must be None or int or tuple of ints, got {type(a)}")
            if a < -ndim or a >= max(ndim, 1):
                raise ValueError(f"axis {a} is out of bounds for {ndim}-dimensional array")
            out.append(a % ndim if ndim > 0 else 0)
        if len(set(out)) != len(out):
            raise ValueError("duplicate axes given")
        return tuple(out)

    if isinstance(axis, np.ndarray) and axis.ndim == 0:
        axis = int(axis)
    if not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be None or int or tuple of ints, got {type(axis)}")
    axis = int(axis)
    if ndim == 0:
        if axis not in (0, -1):
            raise ValueError(f"axis {axis} is out of bounds for 0-dimensional array")
        return 0
    if axis < -ndim or axis >= ndim:
        raise ValueError(f"axis {axis} is out of bounds for {ndim}-dimensional array")
    return axis % ndim


def sanitize_shape(shape: Union[int, Tuple[int, ...]], lval: int = 0) -> Tuple[int, ...]:
    """Verify and normalize a shape-like into a tuple of non-negative ints
    (reference: stride_tricks.py:186)."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    shape = tuple(shape)
    out = []
    for dim in shape:
        if isinstance(dim, np.ndarray) and dim.ndim == 0:
            dim = dim.item()
        if not isinstance(dim, (int, np.integer)):
            raise TypeError(f"expected shape dimension to be integral, got {type(dim)}")
        dim = int(dim)
        if dim < lval:
            raise ValueError(f"negative dimensions are not allowed, got {dim}")
        out.append(dim)
    return tuple(out)
