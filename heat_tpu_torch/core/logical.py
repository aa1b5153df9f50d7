"""Logical operations and predicates (port of ``heat_tpu.core.logical``;
Heat reference: heat/core/logical.py). ``all`` and ``any`` reduce each
shard and combine the ranks' verdicts with one ``allreduce`` (min or max
of uint8: gloo's ``all_reduce`` takes no bool); ``allclose`` gives one
Python bool, the same on every rank."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = [
    "all",
    "allclose",
    "any",
    "isclose",
    "isfinite",
    "isinf",
    "isnan",
    "isneginf",
    "isposinf",
    "logical_and",
    "logical_not",
    "logical_or",
    "logical_xor",
    "signbit",
]


def _verdict(fn, combine: str):
    def partial(t: torch.Tensor, axes, keepdims: bool) -> torch.Tensor:
        return fn(t.to(torch.bool), dim=axes, keepdim=keepdims).to(torch.uint8)

    return dict(partial_op=partial, combine=combine, finish=lambda t: t.to(torch.bool))


def all(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """True where all elements (along ``axis``) are true (reference:
    logical.py all: a local test and an ``Allreduce`` with LAND)."""
    return _operations.__reduce_op(x=x, axis=axis, out=out, keepdims=keepdims, **_verdict(torch.all, "min"))


def allclose(x: DNDarray, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> bool:
    """Whether all elements of x and y are within the tolerances, the same
    verdict on every rank (reference: logical.py allclose)."""
    from .relational import _all_ranks

    return _all_ranks(isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan))


def any(x: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """True where any element (along ``axis``) is true (an ``Allreduce``
    with LOR)."""
    return _operations.__reduce_op(x=x, axis=axis, out=out, keepdims=keepdims, **_verdict(torch.any, "max"))


def _isclose(a, b, rtol, atol, equal_nan):
    a, b = _operations.operands(a, b)
    if a.device != b.device:  # a number's 0-d tensor joins the array's device
        a, b = (a.to(b.device), b) if a.ndim == 0 else (a, b.to(a.device))
    a, b = torch.broadcast_tensors(a, b)
    if a.dtype == torch.bool:  # jnp compares bools for equality
        return torch.eq(a, b)
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def isclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> DNDarray:
    """Elementwise tolerance comparison |x − y| ≤ atol + rtol·|y|."""
    return _operations.__binary_op(_isclose, x, y, fn_kwargs={"rtol": rtol, "atol": atol, "equal_nan": equal_nan})


def isfinite(x: DNDarray) -> DNDarray:
    """Elementwise finiteness test."""
    return _operations.__local_op(torch.isfinite, x, None, no_cast=True)


def isinf(x: DNDarray) -> DNDarray:
    """Elementwise infinity test."""
    return _operations.__local_op(torch.isinf, x, None, no_cast=True)


def isnan(x: DNDarray) -> DNDarray:
    """Elementwise NaN test."""
    return _operations.__local_op(torch.isnan, x, None, no_cast=True)


def _real_only(fn):
    def op(t):
        if t.dtype.is_complex:
            raise ValueError("isposinf/isneginf are not well defined for complex types")
        return fn(t)

    return op


def isneginf(x: DNDarray, out=None) -> DNDarray:
    """Elementwise -inf test."""
    return _operations.__local_op(_real_only(torch.isneginf), x, out, no_cast=True)


def isposinf(x: DNDarray, out=None) -> DNDarray:
    """Elementwise +inf test."""
    return _operations.__local_op(_real_only(torch.isposinf), x, out, no_cast=True)


def logical_and(t1, t2) -> DNDarray:
    """Elementwise logical AND."""
    return _operations.__binary_op(torch.logical_and, t1, t2)


def logical_not(t: DNDarray, out=None) -> DNDarray:
    """Elementwise logical NOT."""
    return _operations.__local_op(torch.logical_not, t, out, no_cast=True)


def logical_or(t1, t2) -> DNDarray:
    """Elementwise logical OR."""
    return _operations.__binary_op(torch.logical_or, t1, t2)


def logical_xor(t1, t2) -> DNDarray:
    """Elementwise logical XOR."""
    return _operations.__binary_op(torch.logical_xor, t1, t2)


def _signbit(t: torch.Tensor) -> torch.Tensor:
    if t.dtype.is_complex:
        raise ValueError("signbit is not well defined for complex values")
    return torch.signbit(t)


def signbit(x: DNDarray, out=None) -> DNDarray:
    """True where the sign bit is set."""
    return _operations.__local_op(_signbit, x, out, no_cast=True)


DNDarray.all = all
DNDarray.any = any
DNDarray.allclose = allclose
DNDarray.isclose = isclose
