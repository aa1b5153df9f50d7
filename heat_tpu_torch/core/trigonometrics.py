"""Trigonometric and hyperbolic functions (port of
``heat_tpu.core.trigonometrics``; Heat reference:
heat/core/trigonometrics.py): every one elementwise on each shard alone
(``__local_op``, integers taken to float32), ``atan2`` through
``__binary_op``."""

from __future__ import annotations

import math

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = [
    "acos",
    "acosh",
    "asin",
    "asinh",
    "atan",
    "atan2",
    "atanh",
    "arccos",
    "arccosh",
    "arcsin",
    "arcsinh",
    "arctan",
    "arctan2",
    "arctanh",
    "cos",
    "cosh",
    "deg2rad",
    "degrees",
    "rad2deg",
    "radians",
    "sin",
    "sinh",
    "tan",
    "tanh",
]


def acos(x: DNDarray, out=None) -> DNDarray:
    """Elementwise arccosine."""
    return _operations.__local_op(torch.acos, x, out)


arccos = acos


def acosh(x: DNDarray, out=None) -> DNDarray:
    """Elementwise inverse hyperbolic cosine."""
    return _operations.__local_op(torch.acosh, x, out)


arccosh = acosh


def asin(x: DNDarray, out=None) -> DNDarray:
    """Elementwise arcsine."""
    return _operations.__local_op(torch.asin, x, out)


arcsin = asin


def asinh(x: DNDarray, out=None) -> DNDarray:
    """Elementwise inverse hyperbolic sine."""
    return _operations.__local_op(torch.asinh, x, out)


arcsinh = asinh


def atan(x: DNDarray, out=None) -> DNDarray:
    """Elementwise arctangent."""
    return _operations.__local_op(torch.atan, x, out)


arctan = atan


def _atan2(a, b):
    """``jnp.arctan2`` after ``heat_tpu``'s cast of integer operands to
    float32 (bools go to float32 too); complex operands take XLA's
    −i·log((b + i·a) / sqrt(a² + b²))."""
    a, b = _operations.operands(a, b)
    if not (a.dtype.is_floating_point or a.dtype.is_complex):
        a, b = a.to(torch.float32), b.to(torch.float32)
    if a.dtype.is_complex:
        return -1j * torch.log((b + 1j * a) / torch.sqrt(a * a + b * b))
    return torch.atan2(a, b)


def atan2(t1, t2) -> DNDarray:
    """Quadrant-aware arctangent of t1/t2."""
    return _operations.__binary_op(_atan2, t1, t2)


arctan2 = atan2


def atanh(x: DNDarray, out=None) -> DNDarray:
    """Elementwise inverse hyperbolic tangent."""
    return _operations.__local_op(torch.atanh, x, out)


arctanh = atanh


def cos(x: DNDarray, out=None) -> DNDarray:
    """Elementwise cosine."""
    return _operations.__local_op(torch.cos, x, out)


def cosh(x: DNDarray, out=None) -> DNDarray:
    """Elementwise hyperbolic cosine."""
    return _operations.__local_op(torch.cosh, x, out)


def _scaled(factor: float):
    def op(t):
        if not (t.dtype.is_floating_point or t.dtype.is_complex):
            t = t.to(torch.float32)
        return t * factor

    return op


def deg2rad(x: DNDarray, out=None) -> DNDarray:
    """Degrees to radians: x · (π/180) in x's type."""
    return _operations.__local_op(_scaled(math.pi / 180), x, out)


radians = deg2rad


def rad2deg(x: DNDarray, out=None) -> DNDarray:
    """Radians to degrees: x · (180/π) in x's type."""
    return _operations.__local_op(_scaled(180 / math.pi), x, out)


degrees = rad2deg


def sin(x: DNDarray, out=None) -> DNDarray:
    """Elementwise sine."""
    return _operations.__local_op(torch.sin, x, out)


def sinh(x: DNDarray, out=None) -> DNDarray:
    """Elementwise hyperbolic sine."""
    return _operations.__local_op(torch.sinh, x, out)


def tan(x: DNDarray, out=None) -> DNDarray:
    """Elementwise tangent."""
    return _operations.__local_op(torch.tan, x, out)


def tanh(x: DNDarray, out=None) -> DNDarray:
    """Elementwise hyperbolic tangent."""
    return _operations.__local_op(torch.tanh, x, out)


DNDarray.cos = cos
DNDarray.sin = sin
DNDarray.tan = tan
DNDarray.cosh = cosh
DNDarray.sinh = sinh
DNDarray.tanh = tanh
