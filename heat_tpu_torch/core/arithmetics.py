"""Arithmetic reductions (port of ``heat_tpu.core.arithmetics.sum``,
:283; Heat reference: heat/core/arithmetics.py).

``sum`` takes ``heat_tpu``'s result types, which are ``jnp.sum``'s under
its x64 policy: bool and signed integers sum to int64; float16 and
bfloat16 sum in float32 and come back in their own type; other floats and
complex keep their type. ``jnp.sum`` gives uint64 for uint8, which is no
heat type, so ``heat_tpu`` raises there, and so does the port.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["sum"]

_NARROW_FLOATS = (torch.float16, torch.bfloat16)


def sum(
    a: DNDarray, axis: Optional[Union[int, Tuple[int, ...]]] = None, out: Optional[DNDarray] = None,
    keepdims: bool = False,
) -> DNDarray:
    """Sum over ``axis`` (reference: __reduce_op plus one all-reduce when
    the split axis is reduced, _operations.py:466-471)."""
    dt = a.larray.dtype
    if dt == torch.uint8:
        raise TypeError("sum of uint8 is uint64 (jnp.sum's type), which is not a heat type")
    if dt == torch.bool or (not dt.is_floating_point and not dt.is_complex):
        acc = torch.int64
    elif dt in _NARROW_FLOATS:
        acc = torch.float32
    else:
        acc = dt

    def partial(t: torch.Tensor, axes, keepdims: bool) -> torch.Tensor:
        return torch.sum(t, dim=axes, keepdim=keepdims, dtype=acc)

    finish = (lambda t: t.to(dt)) if dt in _NARROW_FLOATS else None
    return _operations.__reduce_op(partial, a, axis=axis, out=out, keepdims=keepdims, finish=finish)


DNDarray.sum = lambda self, axis=None, out=None, keepdims=False: sum(self, axis=axis, out=out, keepdims=keepdims)
