"""Exponential and logarithmic functions (port of
``heat_tpu.core.exponential``; Heat reference: heat/core/exponential.py):
elementwise on each shard alone (``__local_op``, integers taken to
float32), ``logaddexp``/``logaddexp2`` through ``__binary_op``."""

from __future__ import annotations

import math

import torch

from . import _operations
from .arithmetics import _inexact_op
from .dndarray import DNDarray

__all__ = [
    "exp",
    "expm1",
    "exp2",
    "log",
    "log2",
    "log10",
    "log1p",
    "logaddexp",
    "logaddexp2",
    "sqrt",
    "square",
]


def exp(x: DNDarray, out=None) -> DNDarray:
    """Elementwise e**x."""
    return _operations.__local_op(torch.exp, x, out)


def expm1(x: DNDarray, out=None) -> DNDarray:
    """Elementwise e**x - 1 (accurate near zero)."""
    return _operations.__local_op(torch.expm1, x, out)


def _exp2(t: torch.Tensor) -> torch.Tensor:
    if t.dtype.is_complex:
        return torch.pow(2.0, t)
    return torch.exp2(t)


def exp2(x: DNDarray, out=None) -> DNDarray:
    """Elementwise 2**x."""
    return _operations.__local_op(_exp2, x, out)


def log(x: DNDarray, out=None) -> DNDarray:
    """Elementwise natural logarithm."""
    return _operations.__local_op(torch.log, x, out)


def log2(x: DNDarray, out=None) -> DNDarray:
    """Elementwise base-2 logarithm."""
    return _operations.__local_op(torch.log2, x, out)


def log10(x: DNDarray, out=None) -> DNDarray:
    """Elementwise base-10 logarithm."""
    return _operations.__local_op(torch.log10, x, out)


def log1p(x: DNDarray, out=None) -> DNDarray:
    """Elementwise log(1+x) (accurate near zero)."""
    return _operations.__local_op(torch.log1p, x, out)


def logaddexp(t1, t2) -> DNDarray:
    """log(exp(t1) + exp(t2)) without overflow."""
    return _operations.__binary_op(_inexact_op(torch.logaddexp), t1, t2)


def _logaddexp2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_complex():  # ATen's logaddexp2 takes no complex: logaddexp of a·ln 2, b·ln 2
        return torch.logaddexp(a * math.log(2.0), b * math.log(2.0)) / math.log(2.0)
    return torch.logaddexp2(a, b)


def logaddexp2(t1, t2) -> DNDarray:
    """log2(2**t1 + 2**t2) without overflow."""
    return _operations.__binary_op(_inexact_op(_logaddexp2), t1, t2)


def sqrt(x: DNDarray, out=None) -> DNDarray:
    """Elementwise square root."""
    return _operations.__local_op(torch.sqrt, x, out)


def _square(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bool:  # jnp squares bools as int32
        t = t.to(torch.int32)
    return t * t


def square(x: DNDarray, out=None) -> DNDarray:
    """Elementwise square."""
    return _operations.__local_op(_square, x, out, no_cast=True)


DNDarray.exp = exp
DNDarray.log = log
DNDarray.sqrt = sqrt
DNDarray.square = square
DNDarray.exp2 = exp2
DNDarray.expm1 = expm1
DNDarray.log2 = log2
DNDarray.log10 = log10
DNDarray.log1p = log1p
