"""Complex number operations (port of ``heat_tpu.core.complex_math``; Heat
reference: heat/core/complex_math.py), on native torch complex
(``heat_tpu``'s ``complex_planar`` is a TPU-only workaround)."""

from __future__ import annotations

import torch

from . import _operations
from . import types
from .dndarray import DNDarray

__all__ = ["angle", "conj", "conjugate", "imag", "real"]


def _angle(t: torch.Tensor) -> torch.Tensor:
    if t.dtype.is_complex:
        return torch.angle(t)
    if not t.dtype.is_floating_point:
        t = t.to(torch.float64)  # jnp.angle of bools and integers is float64
    return torch.atan2(torch.zeros_like(t), t)  # π for −0.0, as jnp.angle (torch.angle gives 0)


def angle(x: DNDarray, deg: bool = False, out=None) -> DNDarray:
    """Argument of the complex values (reference: complex_math.py angle)."""
    result = _operations.__local_op(_angle, x, out, no_cast=True)
    if deg:
        from . import trigonometrics

        result = trigonometrics.rad2deg(result, out=out)
    return result


def conj(x: DNDarray, out=None) -> DNDarray:
    """Complex conjugate."""
    return _operations.__local_op(lambda t: torch.conj(t).resolve_conj(), x, out, no_cast=True)


conjugate = conj


def imag(x: DNDarray) -> DNDarray:
    """Imaginary part; zeros of x's type for real input (reference:
    complex_math.py imag)."""
    if types.heat_type_is_complexfloating(x.dtype):
        return _operations.__local_op(lambda t: t.imag.clone(), x, None, no_cast=True)
    return _operations.__local_op(torch.zeros_like, x, None, no_cast=True)


def real(x: DNDarray) -> DNDarray:
    """Real part; the array itself for real input."""
    if types.heat_type_is_complexfloating(x.dtype):
        return _operations.__local_op(lambda t: t.real.clone(), x, None, no_cast=True)
    return x


DNDarray.conj = conj
