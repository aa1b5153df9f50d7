"""Rounding and sign operations (port of ``heat_tpu.core.rounding``; Heat
reference: heat/core/rounding.py). Each runs on every shard alone; the
float-valued ones take integers to float32 first (``__local_op``), bools
stay bools where ``jnp`` keeps them."""

from __future__ import annotations

import builtins

import torch

from . import _operations
from . import types
from .dndarray import DNDarray
from .sanitation import sanitize_in

__all__ = [
    "abs",
    "absolute",
    "ceil",
    "clip",
    "fabs",
    "floor",
    "modf",
    "round",
    "sgn",
    "sign",
    "trunc",
]


def _keeping_bool(fn, name: str):
    """``fn`` where a bool shard comes back as it is (``jnp``'s rounding of
    bools); complex operands raise, as in ``jnp``."""

    def op(t):
        if t.dtype.is_complex:
            raise TypeError(f"{name} does not accept dtype {t.dtype}")
        if t.dtype == torch.bool:
            return t.clone()
        return fn(t)

    return op


def _abs(t: torch.Tensor) -> torch.Tensor:
    return t.clone() if t.dtype == torch.bool else torch.abs(t)


def abs(x, out=None, dtype=None) -> DNDarray:
    """Elementwise absolute value (reference: rounding.py abs); complex
    gives its real type."""
    if dtype is not None:
        dtype = types.canonical_heat_type(dtype)
    result = _operations.__local_op(_abs, x, out, no_cast=True)
    if dtype is not None and result.dtype != dtype:
        result = result.astype(dtype, copy=out is None)
    return result


absolute = abs


def ceil(x: DNDarray, out=None) -> DNDarray:
    """Elementwise ceiling."""
    return _operations.__local_op(_keeping_bool(torch.ceil, "ceil"), x, out)


def clip(x: DNDarray, min=None, max=None, out=None) -> DNDarray:
    """Clip values to [min, max], as ``jnp.clip``: ``maximum`` with min,
    then ``minimum`` with max; the bounds are numbers or DNDarrays that
    broadcast against ``x`` (reference: rounding.py clip requires at least
    one bound)."""
    from . import statistics

    if min is None and max is None:
        raise ValueError("clip requires at least one of min or max")
    if x.larray.is_complex() or any(isinstance(b, builtins.complex) for b in (min, max)):
        raise ValueError("Clip received a complex value either through the input or the min/max keywords.")
    result = x
    if min is not None:
        result = statistics.maximum(result, min)
    if max is not None:
        result = statistics.minimum(result, max)
    if result is x:
        result = x.astype(x.dtype)
    if out is not None:
        return _operations._store(out, result)
    return result


def fabs(x: DNDarray, out=None) -> DNDarray:
    """Float absolute value (casts integer types to float)."""
    return _operations.__local_op(_abs, x, out)


def floor(x: DNDarray, out=None) -> DNDarray:
    """Elementwise floor."""
    return _operations.__local_op(_keeping_bool(torch.floor, "floor"), x, out)


def modf(x: DNDarray, out=None):
    """Fractional and integral parts, in ``promote_types(x.dtype,
    float32)`` (reference: rounding.py modf)."""
    sanitize_in(x)
    tt = types.promote_types(x.dtype, types.float32).torch_type()
    frac = _operations.__local_op(lambda t: t.to(tt) - torch.trunc(t.to(tt)), x, None, no_cast=True)
    integ = _operations.__local_op(lambda t: torch.trunc(t.to(tt)), x, None, no_cast=True)
    if out is not None:
        if not isinstance(out, tuple) or len(out) != 2:
            raise TypeError("out must be a 2-tuple of DNDarrays")
        _operations._store(out[0], frac)
        _operations._store(out[1], integ)
        return out
    return frac, integ


def _round(t: torch.Tensor, decimals: int) -> torch.Tensor:
    """``jnp.round``: half to even of t·10^decimals, divided back, in t's
    type (complex values part by part)."""
    if t.dtype.is_complex:
        return torch.complex(_round(t.real, decimals), _round(t.imag, decimals))
    if decimals == 0:
        return torch.round(t)
    factor = 10.0 ** decimals
    return torch.round(t * factor) / factor


def round(x: DNDarray, decimals: int = 0, out=None, dtype=None) -> DNDarray:
    """Round to ``decimals``, half to even (reference: rounding.py round)."""
    if x.dtype is types.bool:
        raise ValueError(f"data type {x.dtype.__name__} not inexact")
    if dtype is not None:
        dtype = types.canonical_heat_type(dtype)
    result = _operations.__local_op(_round, x, out, decimals=decimals)
    if dtype is not None and result.dtype != dtype:
        result = result.astype(dtype, copy=out is None)
    return result


def _signed(fn, name: str):
    def op(t):
        if t.dtype == torch.bool:
            raise TypeError(f"{name} does not accept dtype bool")
        return fn(t)

    return op


def sgn(x: DNDarray, out=None) -> DNDarray:
    """Elementwise sign (complex: x/|x|)."""
    return _operations.__local_op(_signed(torch.sgn, "sign"), x, out, no_cast=True)


def _sign(t: torch.Tensor) -> torch.Tensor:
    if t.dtype.is_complex:  # the sign of the real part, as numpy
        return _sign(t.real).to(t.dtype)
    if t.dtype.is_floating_point:  # NaN and ±0 are their own sign, as jnp.sign (torch.sign maps NaN to 0)
        return torch.where(torch.isnan(t) | (t == 0), t, torch.sign(t))
    return torch.sign(t)


def sign(x: DNDarray, out=None) -> DNDarray:
    """Elementwise sign; for complex input the sign of the real part
    (reference: rounding.py sign follows numpy)."""
    return _operations.__local_op(_signed(_sign, "sign"), x, out, no_cast=True)


def trunc(x: DNDarray, out=None) -> DNDarray:
    """Truncate toward zero."""
    return _operations.__local_op(_keeping_bool(torch.trunc, "trunc"), x, out)


DNDarray.abs = abs
DNDarray.ceil = ceil
DNDarray.clip = clip
DNDarray.fabs = fabs
DNDarray.floor = floor
DNDarray.round = round
DNDarray.trunc = trunc
