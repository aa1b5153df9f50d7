"""Pairwise distance computations.

Port of ``heat_tpu.spatial.distance`` (Heat reference:
heat/spatial/distance.py, ``cdist`` :135, ``rbf`` :158, ``manhattan``
:185). ``cdist`` and ``rbf`` come in the direct form (differences, then
squares) and the quadratic-expansion form (‖x‖² + ‖y‖² − 2x·yᵀ, clamped at
0), as in ``heat_tpu``.

``ring=True`` asks for the reference's ring schedule, in which each rank
passes its block of Y around the ring. At world size 1 the ring has one
member, so ``heat_tpu``'s ``_ring_path`` returns None and the plain form
runs; the port does the same. The multi-rank ring comes with the
distributed communicator (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in

__all__ = ["cdist", "manhattan", "rbf"]


def _prepare(X: DNDarray, Y: Optional[DNDarray]):
    for name, t in (("X", X), ("Y", Y)):
        if isinstance(t, DNDarray) and t.is_distributed():
            raise NotImplementedError(
                f"pairwise distances of {name} split across ranks (the ring of spatial/distance.py): "
                "see ROADMAP.md Queue 1, item 3"
            )
    """Validate operands and resolve the compute dtype: float64 if either
    operand is float64, else float32 (reference distance.py:35)."""
    sanitize_in(X)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-dimensional, got {X.ndim}")
    promoted = types.float32 if not types.heat_type_is_inexact(X.dtype) else X.dtype
    if Y is not None:
        sanitize_in(Y)
        if Y.ndim != 2:
            raise ValueError(f"Y must be 2-dimensional, got {Y.ndim}")
        if X.shape[1] != Y.shape[1]:
            raise ValueError(
                f"X and Y must have the same feature dimension, got {X.shape[1]} != {Y.shape[1]}"
            )
        if types.heat_type_is_inexact(Y.dtype):
            promoted = types.promote_types(promoted, Y.dtype)
    if promoted is not types.float64:
        promoted = types.float32
    return promoted


def _cast(X: DNDarray, Y: Optional[DNDarray], dtype):
    tt = dtype.torch_type()
    x = X.larray.to(tt)
    y = x if Y is None else Y.larray.to(device=x.device, dtype=tt)
    return x, y


def _wrap(result: torch.Tensor, X: DNDarray, Y: Optional[DNDarray], dtype) -> DNDarray:
    # output split follows X's sample axis; Y split along axis 0 maps to
    # output axis 1 (reference distance.py, heat_tpu distance.py:68)
    split = 0 if X.split == 0 else (1 if (Y is not None and Y.split == 0) else None)
    return DNDarray(result, tuple(result.shape), dtype, split, X.device, X.comm)


def _sq_expanded(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    y2 = torch.sum(y * y, dim=1, keepdim=True).T
    return torch.clamp_min(x2 + y2 - 2.0 * (x @ y.T), 0.0)


def _sq_direct(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    diff = x[:, None, :] - y[None, :, :]
    return torch.sum(diff * diff, dim=-1)


def cdist(
    X: DNDarray,
    Y: Optional[DNDarray] = None,
    quadratic_expansion: bool = False,
    ring: bool = False,
) -> DNDarray:
    """Pairwise Euclidean distances (reference: distance.py:135). ``Y=None``
    means X against itself. ``ring`` is accepted; at world size 1 the plain
    form runs (module docstring)."""
    dtype = _prepare(X, Y)
    x, y = _cast(X, Y, dtype)
    d2 = _sq_expanded(x, y) if quadratic_expansion else _sq_direct(x, y)
    return _wrap(torch.sqrt(d2), X, Y, dtype)


def manhattan(
    X: DNDarray, Y: Optional[DNDarray] = None, expand: bool = False, ring: bool = False
) -> DNDarray:
    """Pairwise L1 distances (reference: distance.py:185). ``expand`` is
    accepted for the reference's signature; both forms compute the same
    sums."""
    dtype = _prepare(X, Y)
    x, y = _cast(X, Y, dtype)
    result = torch.sum(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)
    return _wrap(result, X, Y, dtype)


def rbf(
    X: DNDarray,
    Y: Optional[DNDarray] = None,
    sigma: float = 1.0,
    quadratic_expansion: bool = False,
    ring: bool = False,
) -> DNDarray:
    """RBF kernel exp(−d²/(2σ²)) (reference: distance.py:158)."""
    dtype = _prepare(X, Y)
    x, y = _cast(X, Y, dtype)
    d2 = _sq_expanded(x, y) if quadratic_expansion else _sq_direct(x, y)
    return _wrap(torch.exp(-d2 / (2.0 * sigma * sigma)), X, Y, dtype)
