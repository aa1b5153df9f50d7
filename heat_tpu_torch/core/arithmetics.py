"""Arithmetic operations (port of ``heat_tpu.core.arithmetics``; Heat
reference: heat/core/arithmetics.py).

The binary functions run through ``_operations.__binary_op`` (broadcasting,
mixed splits, ``out=`` and ``where=``), the unary ones through
``__local_op``, ``cumsum``/``cumprod`` through ``__cum_op`` and the
reductions through ``__reduce_op``. Result types are ``heat_tpu``'s, which
are ``jnp``'s under its x64 policy: true division, ``hypot``,
``copysign`` and ``logaddexp`` of integers give float32 (float64 from
int64); floor division, the remainders, the power and the shifts of bools
give int32; sums and products of bools and signed integers give int64,
float16 and bfloat16 accumulate in float32 and come back in their own
type. ``jnp.sum`` gives uint64 for uint8, which is no heat type, so
``heat_tpu`` raises there, and so does the port.
"""

from __future__ import annotations

import builtins
from typing import Optional, Tuple, Union

import torch

from . import _operations
from . import types
from .dndarray import DNDarray
from .sanitation import sanitize_in
from .stride_tricks import sanitize_axis

__all__ = [
    "add",
    "bitwise_and",
    "bitwise_not",
    "bitwise_or",
    "bitwise_xor",
    "copysign",
    "cumprod",
    "cumproduct",
    "cumsum",
    "diff",
    "div",
    "divmod",
    "divide",
    "floordiv",
    "floor_divide",
    "fmod",
    "gcd",
    "hypot",
    "invert",
    "lcm",
    "left_shift",
    "mod",
    "mul",
    "multiply",
    "nan_to_num",
    "nanprod",
    "nansum",
    "neg",
    "negative",
    "pos",
    "positive",
    "pow",
    "power",
    "prod",
    "remainder",
    "right_shift",
    "sub",
    "subtract",
    "sum",
]

_NARROW_FLOATS = (torch.float16, torch.bfloat16)


def inexact(dtype: torch.dtype) -> torch.dtype:
    """``jnp``'s inexact type of an operand type (``to_inexact_dtype``): bool
    and integers up to 32 bits give float32, int64 float64, floats and
    complex stay."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.float64 if dtype == torch.int64 else torch.float32


def _as(x, dtype: torch.dtype):
    """A tensor operand cast to ``dtype``; a Python number as it is."""
    return x.to(dtype) if isinstance(x, torch.Tensor) else x


def _dtype_of(a, b) -> torch.dtype:
    return a.dtype if isinstance(a, torch.Tensor) else b.dtype


def _inexact_op(fn):
    """``fn`` on both operands as tensors of their inexact type."""

    def op(a, b):
        tt = inexact(_dtype_of(a, b))
        return fn(*_operations.operands(_as(a, tt), _as(b, tt)))

    return op


def _bool_as_int32(fn):
    """``fn`` with bool operands as int32, as ``jnp`` computes floor
    division, the remainders, the power and the shifts of bools."""

    def op(a, b):
        if _dtype_of(a, b) == torch.bool:
            a, b = _as(a, torch.int32), _as(b, torch.int32)
        return fn(a, b)

    return op


def _reject_complex(fn, name: str, error=TypeError):
    def op(a, b):
        if _dtype_of(a, b).is_complex:
            raise error(f"{name} does not accept complex operands")
        return fn(a, b)

    return op


def _sub(a, b):
    if _dtype_of(a, b) == torch.bool:
        raise TypeError("subtract does not accept dtype bool")
    return torch.sub(a, b)


def _pow(a, b):
    """``torch.pow``; integers to negative integer powers raise, as in numpy
    (``jnp`` wraps them to meaningless values)."""
    dt = _dtype_of(a, b)
    if not (dt.is_floating_point or dt.is_complex):
        negative = b < 0 if not isinstance(b, torch.Tensor) else (b.numel() and bool((b < 0).any()))
        if negative:
            raise ValueError("Integers to negative integer powers are not allowed.")
    if not isinstance(a, torch.Tensor):
        a, _ = _operations.operands(a, b)
    result = torch.pow(a, b)
    if dt.is_complex:  # XLA's zero base: 1 to the power 0, 0 to a positive real power, else NaN
        _, b = _operations.operands(a, b)
        nan = torch.tensor(complex(float("nan"), float("nan")), dtype=dt, device=a.device)
        zero_base = torch.where(b == 0, torch.ones_like(result), torch.where((b.imag == 0) & (b.real > 0),
                                                                             torch.zeros_like(result), nan))
        result = torch.where(a == 0, zero_base, result)
    return result


def _gcd_lcm(fn, name):
    def op(a, b):
        dt = _dtype_of(a, b)
        if dt == torch.bool or dt.is_floating_point or dt.is_complex:
            raise ValueError(f"{name} arguments must be integers, got {dt}")
        return fn(*_operations.operands(a, b))

    return op


def add(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise addition (reference: arithmetics.py add)."""
    return _operations.__binary_op(torch.add, t1, t2, out, where)


def _check_int_or_bool(t, name):
    if isinstance(t, DNDarray) and types.heat_type_is_inexact(t.dtype):
        raise TypeError(f"operation {name} not supported for float dtype {t.dtype}")


def bitwise_and(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise AND of integer/boolean arrays."""
    _check_int_or_bool(t1, "bitwise_and"), _check_int_or_bool(t2, "bitwise_and")
    return _operations.__binary_op(torch.bitwise_and, t1, t2, out, where)


def bitwise_or(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise OR of integer/boolean arrays."""
    _check_int_or_bool(t1, "bitwise_or"), _check_int_or_bool(t2, "bitwise_or")
    return _operations.__binary_op(torch.bitwise_or, t1, t2, out, where)


def bitwise_xor(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise XOR of integer/boolean arrays."""
    _check_int_or_bool(t1, "bitwise_xor"), _check_int_or_bool(t2, "bitwise_xor")
    return _operations.__binary_op(torch.bitwise_xor, t1, t2, out, where)


def bitwise_not(t, out=None) -> DNDarray:
    """Elementwise NOT; alias ``invert``."""
    _check_int_or_bool(t, "bitwise_not")
    return _operations.__local_op(torch.bitwise_not, t, out, no_cast=True)


invert = bitwise_not


def copysign(t1, t2, out=None, where=None) -> DNDarray:
    """Magnitude of t1 with the sign of t2."""
    return _operations.__binary_op(_inexact_op(_reject_complex(torch.copysign, "copysign")), t1, t2, out, where)


def cumprod(a: DNDarray, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative product along ``axis`` (reference: __cum_op with the
    ranks' exclusive product)."""
    return _operations.__cum_op(torch.cumprod, a, axis, out=out, dtype=dtype)


cumproduct = cumprod


def cumsum(a: DNDarray, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative sum along ``axis`` (reference: __cum_op with the ranks'
    exclusive sum)."""
    return _operations.__cum_op(torch.cumsum, a, axis, out=out, dtype=dtype)


def diff(a: DNDarray, n: int = 1, axis: int = -1) -> DNDarray:
    """n-th discrete difference along ``axis`` (reference arithmetics.py
    diff; bools give ``!=``). Along the split axis each rank needs the
    first row of the next rank that holds rows: one ``permute`` a step,
    every rank sending its first row to the rank before it, where a rank
    with no rows sends on the row it got (one more permute for each rank
    with no rows in a run). The result keeps the split and the map of
    shard shapes, the last rank with rows one row shorter a step."""
    sanitize_in(a)
    if n == 0:
        return a
    if n < 0:
        raise ValueError(f"order must be non-negative but was {n}")
    axis = sanitize_axis(a.shape, axis)
    for _ in range(n):
        a = _diff_once(a, axis)
    return a


def _diff_once(a: DNDarray, axis: int) -> DNDarray:
    t = a.larray
    step = torch.ne if t.dtype == torch.bool else torch.sub
    lmap = a.lshape_map if a.split is not None else None
    if a.is_distributed() and axis == a.split:
        comm = a.comm
        p, r = comm.size, comm.rank
        counts = lmap[:, axis]
        gap = [0] * p  # empty ranks right after each rank
        for q in range(p - 2, -1, -1):
            gap[q] = gap[q + 1] + 1 if counts[q + 1] == 0 else 0
        later = [bool(counts[q + 1 :].any()) for q in range(p)]
        rounds = max([gap[q] + 1 for q in range(p) if counts[q] and later[q]], default=0)
        shape = list(t.shape)
        shape[axis] = 1
        carry = t.narrow(axis, 0, 1) if counts[r] else t.new_zeros(shape)
        following = None
        for k in range(rounds):
            got = comm.permute(carry.contiguous(), [(q + 1, q) for q in range(p - 1)])
            if not counts[r]:
                carry = got
            elif k == gap[r]:
                following = got
        if counts[r] and later[r]:
            t = torch.cat([t, following], dim=axis)
        last = max((q for q in range(p) if counts[q]), default=None)
        if last is not None:
            lmap[last, axis] -= 1
    elif lmap is not None:
        lmap[:, axis] = (lmap[:, axis] - 1).clip(min=0)
    head = tuple(slice(1, None) if i == axis else slice(None) for i in range(t.ndim))
    tail = tuple(slice(None, -1) if i == axis else slice(None) for i in range(t.ndim))
    res = step(t[head], t[tail])
    gshape = tuple(max(s - 1, 0) if i == axis else s for i, s in enumerate(a.gshape))
    return DNDarray(res, gshape, types.canonical_heat_type(res.dtype), a.split, a.device, a.comm, lmap)


def div(t1, t2, out=None, where=None) -> DNDarray:
    """True division (reference: arithmetics.py div)."""
    return _operations.__binary_op(_inexact_op(torch.true_divide), t1, t2, out, where)


divide = div


def divmod(t1, t2, out1=None, out2=None, out=None, where=None):
    """Elementwise (floordiv, mod) pair."""
    if out is None:
        out = (out1, out2)
    if not isinstance(out, tuple) or len(out) != 2:
        raise ValueError("out must be a tuple of two DNDarrays")
    d = floordiv(t1, t2, out[0], where)
    m = mod(t1, t2, out[1], where)
    return d, m


def floordiv(t1, t2, out=None, where=None) -> DNDarray:
    """Floor division."""
    op = _reject_complex(_bool_as_int32(torch.floor_divide), "floor_divide")
    return _operations.__binary_op(op, t1, t2, out, where)


floor_divide = floordiv


def fmod(t1, t2, out=None, where=None) -> DNDarray:
    """C-style remainder (sign of the dividend)."""
    return _operations.__binary_op(_reject_complex(_bool_as_int32(torch.fmod), "fmod"), t1, t2, out, where)


def gcd(t1, t2, out=None, where=None) -> DNDarray:
    """Greatest common divisor of integer arrays."""
    return _operations.__binary_op(_gcd_lcm(torch.gcd, "gcd"), t1, t2, out, where)


def hypot(t1, t2, out=None, where=None) -> DNDarray:
    """Hypotenuse sqrt(t1**2 + t2**2)."""
    op = _inexact_op(_reject_complex(torch.hypot, "hypot", ValueError))
    return _operations.__binary_op(op, t1, t2, out, where)


def lcm(t1, t2, out=None, where=None) -> DNDarray:
    """Least common multiple of integer arrays."""
    return _operations.__binary_op(_gcd_lcm(torch.lcm, "lcm"), t1, t2, out, where)


def left_shift(t1, t2, out=None, where=None) -> DNDarray:
    """Bitwise left shift."""
    _check_int_or_bool(t1, "left_shift")
    return _operations.__binary_op(_bool_as_int32(torch.bitwise_left_shift), t1, t2, out, where)


def mod(t1, t2, out=None, where=None) -> DNDarray:
    """Python-style modulo (sign of the divisor); alias ``remainder``."""
    return _operations.__binary_op(_reject_complex(_bool_as_int32(torch.remainder), "remainder"), t1, t2, out, where)


remainder = mod


def mul(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise multiplication."""
    return _operations.__binary_op(torch.mul, t1, t2, out, where)


multiply = mul


def nan_to_num(a: DNDarray, nan=0.0, posinf=None, neginf=None, out=None) -> DNDarray:
    """Replace NaN and ±inf with finite numbers."""

    def op(t):
        if not (t.dtype.is_floating_point or t.dtype.is_complex):
            return t.clone()
        if t.dtype.is_complex:
            return torch.complex(torch.nan_to_num(t.real, nan, posinf, neginf),
                                 torch.nan_to_num(t.imag, nan, posinf, neginf))
        return torch.nan_to_num(t, nan, posinf, neginf)

    return _operations.__local_op(op, a, out, no_cast=True)


def _product_type(dt: torch.dtype) -> torch.dtype:
    """The accumulation type of a sum or product (``jnp``'s): bool and
    signed integers int64, float16 and bfloat16 float32."""
    if dt == torch.uint8:
        raise TypeError("a sum or product of uint8 is uint64 (jnp's type), which is not a heat type")
    if dt == torch.bool or (not dt.is_floating_point and not dt.is_complex):
        return torch.int64
    if dt in _NARROW_FLOATS:
        return torch.float32
    return dt


def _accumulate(a: DNDarray, axis, out, keepdims: bool, partial_of, combine: str) -> DNDarray:
    """A sum or product over ``axis``: ``partial_of(t, axes, keepdims, acc)``
    reduces a shard in the accumulation type (ATen's ``dtype=``: no
    widened copy of the shard), one ``allreduce`` merges the ranks'."""
    dt = a.larray.dtype
    acc = _product_type(dt)

    def partial(t: torch.Tensor, axes, keepdims: bool) -> torch.Tensor:
        return partial_of(t, axes, keepdims, acc)

    finish = (lambda t: t.to(dt)) if dt in _NARROW_FLOATS else None
    return _operations.__reduce_op(partial, a, axis=axis, out=out, keepdims=keepdims, combine=combine,
                                   finish=finish)


def _prod_over(t: torch.Tensor, axes, keepdims: bool, acc: torch.dtype) -> torch.Tensor:
    """``torch.prod`` over several axes (it takes one at a time)."""
    if not axes:
        return t.to(acc)
    for ax in sorted(axes, reverse=True):
        t = torch.prod(t, dim=ax, keepdim=True, dtype=acc)
    return t if keepdims else t.reshape([s for i, s in enumerate(t.shape) if i not in axes])


def _sum_over(t: torch.Tensor, axes, keepdims: bool, acc: torch.dtype) -> torch.Tensor:
    return torch.sum(t, dim=axes, keepdim=keepdims, dtype=acc) if axes else t.to(acc)


def _neutral_nan(t: torch.Tensor, value) -> torch.Tensor:
    if t.dtype.is_floating_point or t.dtype.is_complex:
        return torch.where(torch.isnan(t), torch.tensor(value, dtype=t.dtype, device=t.device), t)
    return t


def nanprod(a: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Product ignoring NaNs (reference: arithmetics.py nanprod)."""
    return _accumulate(a, axis, out, keepdims, lambda t, axes, k, acc: _prod_over(_neutral_nan(t, 1), axes, k, acc),
                       "prod")


def nansum(a: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Sum ignoring NaNs."""
    return _accumulate(a, axis, out, keepdims, lambda t, axes, k, acc: _sum_over(_neutral_nan(t, 0), axes, k, acc),
                       "sum")


def neg(a: DNDarray, out=None) -> DNDarray:
    """Elementwise negation."""
    if a.dtype is types.bool:
        raise TypeError("neg does not accept dtype bool")
    return _operations.__local_op(torch.neg, a, out, no_cast=True)


negative = neg


def pos(a: DNDarray, out=None) -> DNDarray:
    """Elementwise unary plus."""
    return _operations.__local_op(torch.clone, a, out, no_cast=True)


positive = pos


def pow(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise power; an integral Python exponent stays an integer,
    so integer arrays keep their type (numpy semantics)."""
    if isinstance(t2, (builtins.int, builtins.float)) and builtins.float(t2).is_integer():
        t2 = builtins.int(t2)
    return _operations.__binary_op(_bool_as_int32(_pow), t1, t2, out, where)


power = pow


def prod(a: DNDarray, axis=None, out=None, keepdims: bool = False) -> DNDarray:
    """Product over ``axis`` (reference: __reduce_op with MPI.PROD)."""
    return _accumulate(a, axis, out, keepdims, _prod_over, "prod")


def right_shift(t1, t2, out=None, where=None) -> DNDarray:
    """Bitwise right shift."""
    _check_int_or_bool(t1, "right_shift")
    return _operations.__binary_op(_bool_as_int32(torch.bitwise_right_shift), t1, t2, out, where)


def sub(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise subtraction."""
    return _operations.__binary_op(_sub, t1, t2, out, where)


subtract = sub


def sum(
    a: DNDarray, axis: Optional[Union[int, Tuple[int, ...]]] = None, out: Optional[DNDarray] = None,
    keepdims: bool = False,
) -> DNDarray:
    """Sum over ``axis`` (reference: __reduce_op plus one all-reduce when
    the split axis is reduced, _operations.py:466-471)."""
    return _accumulate(a, axis, out, keepdims, _sum_over, "sum")


# ------------------------------------------------------------------ #
# DNDarray operators and methods (``heat_tpu`` arithmetics.py:293-342) #
# ------------------------------------------------------------------ #
def _dunder_abs(self):
    from . import rounding

    return rounding.abs(self)


DNDarray.__add__ = lambda self, other: add(self, other)
DNDarray.__radd__ = lambda self, other: add(other, self)
DNDarray.__iadd__ = lambda self, other: add(self, other)
DNDarray.__sub__ = lambda self, other: sub(self, other)
DNDarray.__rsub__ = lambda self, other: sub(other, self)
DNDarray.__isub__ = lambda self, other: sub(self, other)
DNDarray.__mul__ = lambda self, other: mul(self, other)
DNDarray.__rmul__ = lambda self, other: mul(other, self)
DNDarray.__imul__ = lambda self, other: mul(self, other)
DNDarray.__truediv__ = lambda self, other: div(self, other)
DNDarray.__rtruediv__ = lambda self, other: div(other, self)
DNDarray.__itruediv__ = lambda self, other: div(self, other)
DNDarray.__floordiv__ = lambda self, other: floordiv(self, other)
DNDarray.__rfloordiv__ = lambda self, other: floordiv(other, self)
DNDarray.__mod__ = lambda self, other: mod(self, other)
DNDarray.__rmod__ = lambda self, other: mod(other, self)
DNDarray.__pow__ = lambda self, other: pow(self, other)
DNDarray.__rpow__ = lambda self, other: pow(other, self)
DNDarray.__neg__ = lambda self: neg(self)
DNDarray.__pos__ = lambda self: pos(self)
DNDarray.__abs__ = _dunder_abs
DNDarray.__invert__ = lambda self: invert(self)
DNDarray.__and__ = lambda self, other: bitwise_and(self, other)
DNDarray.__rand__ = lambda self, other: bitwise_and(other, self)
DNDarray.__or__ = lambda self, other: bitwise_or(self, other)
DNDarray.__ror__ = lambda self, other: bitwise_or(other, self)
DNDarray.__xor__ = lambda self, other: bitwise_xor(self, other)
DNDarray.__rxor__ = lambda self, other: bitwise_xor(other, self)
DNDarray.__lshift__ = lambda self, other: left_shift(self, other)
DNDarray.__rshift__ = lambda self, other: right_shift(self, other)
DNDarray.__divmod__ = lambda self, other: divmod(self, other)

DNDarray.add = add
DNDarray.sub = sub
DNDarray.mul = mul
DNDarray.div = div
DNDarray.pow = pow
DNDarray.mod = mod
DNDarray.sum = sum
DNDarray.prod = prod
DNDarray.nansum = nansum
DNDarray.nanprod = nanprod
DNDarray.cumsum = cumsum
DNDarray.cumprod = cumprod
