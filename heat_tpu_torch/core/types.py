"""Type system for heat_tpu_torch.

Port of ``heat_tpu.core.types``: the NumPy-style heat type hierarchy, each
type carried by a ``torch.dtype``, with the torch promotion lattice (Heat
reference: heat/core/types.py, ``canonical_heat_type`` at :494,
``promote_types`` at :838, ``finfo`` at :952).

The port keeps native 64-bit and complex types (the cpu/gpu world of
``heat_tpu``), so ``heat_tpu``'s 64→32-bit degradation does not exist here.
"""

from __future__ import annotations

import builtins
from typing import Any, Iterable, Type, Union

import numpy as np
import torch

__all__ = [
    "datatype",
    "number",
    "integer",
    "signedinteger",
    "unsignedinteger",
    "bool",
    "bool_",
    "floating",
    "int8",
    "byte",
    "int16",
    "short",
    "int32",
    "int",
    "int_",
    "int64",
    "long",
    "uint8",
    "ubyte",
    "float16",
    "half",
    "bfloat16",
    "float32",
    "float",
    "float_",
    "float64",
    "double",
    "complex",
    "flexible",
    "complex64",
    "cfloat",
    "csingle",
    "complex128",
    "cdouble",
    "canonical_heat_type",
    "heat_type_of",
    "heat_type_is_exact",
    "heat_type_is_inexact",
    "heat_type_is_complexfloating",
    "heat_type_is_realfloating",
    "issubdtype",
    "can_cast",
    "promote_types",
    "result_type",
    "finfo",
    "iinfo",
    "iscomplex",
    "isreal",
]


class datatype:
    """Generic base class for heat_tpu_torch data types."""

    _torch_type: Any = None

    @classmethod
    def torch_type(cls) -> torch.dtype:
        """The corresponding ``torch.dtype``."""
        return cls._torch_type


class bool(datatype):
    """1-byte boolean."""

    _torch_type = torch.bool


class number(datatype):
    """Abstract base for all numeric types."""


class integer(number):
    """Abstract base for integer types."""


class signedinteger(integer):
    """Abstract base for signed integers."""


class int8(signedinteger):
    _torch_type = torch.int8


class int16(signedinteger):
    _torch_type = torch.int16


class int32(signedinteger):
    _torch_type = torch.int32


class int64(signedinteger):
    _torch_type = torch.int64


class unsignedinteger(integer):
    """Abstract base for unsigned integers."""


class uint8(unsignedinteger):
    _torch_type = torch.uint8


class floating(number):
    """Abstract base for floating-point types."""


class float16(floating):
    _torch_type = torch.float16


class bfloat16(floating):
    _torch_type = torch.bfloat16


class float32(floating):
    _torch_type = torch.float32


class float64(floating):
    _torch_type = torch.float64


class flexible(datatype):
    """Abstract base for types with flexible/variable size (none is
    concrete, as in ``heat_tpu``)."""


class complex(number):
    """Abstract base for complex floating types."""


class complex64(complex):
    _torch_type = torch.complex64


class complex128(complex):
    _torch_type = torch.complex128


# aliases (reference: types.py:414-428)
bool_ = bool
ubyte = uint8
byte = int8
short = int16
int = int32
int_ = int32
long = int64
half = float16
float = float32
float_ = float32
double = float64
cfloat = complex64
csingle = complex64
cdouble = complex128

_complexfloating = (complex64, complex128)
_inexact = (float16, bfloat16, float32, float64, *_complexfloating)
_exact = (uint8, int8, int16, int32, int64)
_concrete = (bool, *_exact, *_inexact)

# type strings, numpy scalar types and builtins
__type_mappings = {
    "?": bool,
    "B": uint8,
    "b": int8,
    "h": int16,
    "i": int32,
    "l": int64,
    "e": float16,
    "E": bfloat16,
    "f": float32,
    "d": float64,
    "F": complex64,
    "D": complex128,
    "b1": bool,
    "u": uint8,
    "u1": uint8,
    "i1": int8,
    "i2": int16,
    "i4": int32,
    "i8": int64,
    "f2": float16,
    "f4": float32,
    "f8": float64,
    "c8": complex64,
    "c16": complex128,
    "bfloat16": bfloat16,
    np.bool_: bool,
    np.uint8: uint8,
    np.int8: int8,
    np.int16: int16,
    np.int32: int32,
    np.int64: int64,
    np.float16: float16,
    np.float32: float32,
    np.float64: float64,
    np.complex64: complex64,
    np.complex128: complex128,
    builtins.bool: bool,
    builtins.int: int32,
    builtins.float: float32,
    builtins.complex: complex64,
}

# dtype name → heat type (numpy dtypes and their names)
__name_mappings = {t.__name__: t for t in _concrete}

# torch dtype → heat type
__torch_mappings = {t._torch_type: t for t in _concrete}


def canonical_heat_type(a_type: Union[str, Type[datatype], Any]) -> Type[datatype]:
    """Canonicalize a builtin Python type, type string, numpy dtype, torch
    dtype or heat type into the canonical heat type (reference: types.py:494)."""
    try:
        if issubclass(a_type, datatype):
            return a_type
    except TypeError:
        pass
    if isinstance(a_type, torch.dtype):
        mapped = __torch_mappings.get(a_type)
        if mapped is not None:
            return mapped
        raise TypeError(f"data type {a_type} is not understood")
    try:
        mapped = __type_mappings.get(a_type)
    except TypeError:  # unhashable
        mapped = None
    if mapped is not None:
        return mapped
    try:
        mapped = __name_mappings.get(np.dtype(a_type).name)
        if mapped is not None:
            return mapped
    except TypeError:
        pass
    raise TypeError(f"data type {a_type} is not understood")


def heat_type_of(obj: Any) -> Type[datatype]:
    """Infer the canonical heat type of an object — DNDarray, tensor, numpy
    array, scalar or (nested) iterable (reference: types.py:567)."""
    dtype = getattr(obj, "dtype", None)
    if dtype is not None:
        return canonical_heat_type(dtype)
    if isinstance(obj, (builtins.bool, builtins.int, builtins.float, builtins.complex)):
        return canonical_heat_type(type(obj))
    if isinstance(obj, str):
        raise TypeError(f"data type of {obj} is not understood")
    if isinstance(obj, Iterable):
        for elem in obj:
            return heat_type_of(elem)
        raise TypeError(f"data type of empty iterable {obj} is not understood")
    raise TypeError(f"data type of {obj} is not understood")


def heat_type_is_exact(ht_dtype: Type[datatype]) -> builtins.bool:
    """True if ``ht_dtype`` is an integer type."""
    return ht_dtype in _exact


def heat_type_is_inexact(ht_dtype: Type[datatype]) -> builtins.bool:
    """True if ``ht_dtype`` is floating or complex."""
    return ht_dtype in _inexact


def heat_type_is_complexfloating(ht_dtype: Type[datatype]) -> builtins.bool:
    """True if ``ht_dtype`` is complex."""
    return ht_dtype in _complexfloating


def heat_type_is_realfloating(ht_dtype: Type[datatype]) -> builtins.bool:
    """True if ``ht_dtype`` is a real floating type."""
    return ht_dtype in (float16, bfloat16, float32, float64)


def issubdtype(arg1: Any, arg2: Any) -> builtins.bool:
    """NumPy-style type-hierarchy test on heat types (``heat_tpu``
    types.py:437)."""

    def _resolve(arg):
        try:
            if issubclass(arg, datatype):
                return arg
        except TypeError:
            pass
        return canonical_heat_type(arg)

    return issubclass(_resolve(arg1), _resolve(arg2))


# "intuitive" additions over numpy-safe casting: integer → float or complex
# of at least the same width (``heat_tpu`` types.py:450)
_SAFE_EXTRA = {
    (int32, float32),
    (int64, float32),
    (int64, float64),
    (int32, float16),
    (int32, bfloat16),
    (int64, float16),
    (int64, bfloat16),
    (int32, complex64),
    (int64, complex64),
    (int64, complex128),
}


def _numpy_of(t: Type[datatype]) -> np.dtype:
    """The numpy dtype of a heat type, bfloat16 read as float32 (numpy has
    no bfloat16 of its own)."""
    return np.dtype("float32" if t is bfloat16 else t.__name__)


def can_cast(
    from_: Union[str, Type[datatype], Any],
    to: Union[str, Type[datatype], Any],
    casting: str = "intuitive",
) -> builtins.bool:
    """Whether a cast between data types can occur per the casting rule
    (``heat_tpu`` types.py:467): ``no``, ``safe``, ``same_kind``, ``unsafe``
    or ``intuitive`` (safe plus integer → float of the same width). A
    Python number as ``from_`` goes to ``np.can_cast`` as it is."""
    if not isinstance(casting, str):
        raise TypeError(f"expected string, found {type(casting)}")
    if casting not in ("no", "safe", "same_kind", "unsafe", "intuitive"):
        raise ValueError(f"casting must be one of 'no', 'safe', 'same_kind', 'unsafe', 'intuitive', not {casting}")
    if isinstance(from_, (builtins.int, builtins.float, builtins.complex)) and not isinstance(from_, builtins.bool):
        return np.can_cast(from_, _numpy_of(canonical_heat_type(to)))
    from_t = canonical_heat_type(from_)
    to_t = canonical_heat_type(to)
    if casting == "unsafe":
        return True
    if casting == "no":
        return from_t == to_t
    f_np, t_np = _numpy_of(from_t), _numpy_of(to_t)
    if casting == "same_kind":
        return np.can_cast(f_np, t_np, casting="same_kind") or (from_t, to_t) in _SAFE_EXTRA
    safe = np.can_cast(f_np, t_np, casting="safe")
    if from_t is bfloat16:
        safe = to_t in (bfloat16, float32, float64, complex64, complex128)
    if casting == "safe":
        return safe
    return safe or (from_t, to_t) in _SAFE_EXTRA


# The promotion lattice of ``heat_tpu`` (``jnp.result_type`` with x64 on):
# each type's direct successors. "i*", "f*" and "c*" are the weak types of
# Python int, float and complex operands, which yield to any typed operand
# of their kind or above; a Python bool is a typed bool.
_LATTICE = {
    bool: ("i*",),
    "i*": (uint8, int8),
    uint8: (int16,),
    int8: (int16,),
    int16: (int32,),
    int32: (int64,),
    int64: ("f*",),
    "f*": (bfloat16, float16, "c*"),
    bfloat16: (float32,),
    float16: (float32,),
    float32: (float64, complex64),
    float64: (complex128,),
    "c*": (complex64,),
    complex64: (complex128,),
    complex128: (),
}
# a weak result (every operand a Python number) takes the widest type of its kind
_WEAK_DEFAULT = {"i*": int64, "f*": float64, "c*": complex128}


def _above(node) -> frozenset:
    """``node`` and every type above it in the lattice."""
    seen, todo = {node}, [node]
    while todo:
        for nxt in _LATTICE[todo.pop()]:
            if nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
    return frozenset(seen)


_ABOVE = {node: _above(node) for node in _LATTICE}


def _join(nodes) -> Any:
    """The least upper bound of lattice nodes."""
    common = frozenset.intersection(*(_ABOVE[n] for n in nodes))
    return next(n for n in common if _ABOVE[n] == common)


def _lattice_node(obj: Any):
    """An operand's place in the lattice: arrays, numpy scalars and types
    with their (strong) type, Python numbers as weak types."""
    dtype = getattr(obj, "dtype", None)
    if dtype is not None:
        return canonical_heat_type(dtype)
    if isinstance(obj, builtins.bool):
        return bool
    if isinstance(obj, builtins.int):
        return "i*"
    if isinstance(obj, builtins.float):
        return "f*"
    if isinstance(obj, builtins.complex):
        return "c*"
    return canonical_heat_type(obj)


def result_type(*arrays_and_types: Any) -> Type[datatype]:
    """The type that the promotion lattice gives all operands (arrays, heat
    types, scalars) together (``heat_tpu`` types.py:521). Python numbers
    take part as weak types, so ``int`` with a float32 array stays
    float32 and ``float`` with an int32 array gives float64, as
    ``jnp.result_type`` gives them with x64 on; bfloat16 with float16
    gives float32."""
    if not arrays_and_types:
        raise ValueError("at least one array or dtype is required")
    joined = _join([_lattice_node(o) for o in arrays_and_types])
    return _WEAK_DEFAULT.get(joined, joined) if isinstance(joined, str) else joined


def promote_types(
    type1: Union[str, Type[datatype], Any], type2: Union[str, Type[datatype], Any]
) -> Type[datatype]:
    """Smallest type to which both may be safely cast, on the promotion
    lattice of :func:`result_type` (int ∨ float → that float;
    ``heat_tpu`` types.py:508, reference: types.py:838)."""
    return result_type(canonical_heat_type(type1), canonical_heat_type(type2))


def index_torch_type() -> torch.dtype:
    """Dtype of index-valued outputs (sort and topk indices, the inverse of
    unique): int64, which the port always has (``heat_tpu``'s
    ``index_jax_type`` at world size 1 with x64 on)."""
    return torch.int64


class finfo:
    """Machine limits for floating point types (reference: types.py:952).
    A complex type reports the limits of its real part."""

    def __new__(cls, dtype: Type[datatype]):
        try:
            dtype = canonical_heat_type(dtype)
        except TypeError:
            raise TypeError(f"data type {dtype} not inexact, not supported")
        if dtype not in _inexact:
            raise TypeError(f"data type {dtype} not inexact, not supported")
        return super().__new__(cls)._init(dtype)

    def _init(self, dtype):
        tt = dtype.torch_type()
        if tt.is_complex:
            tt = torch.empty((), dtype=tt).real.dtype
        info = torch.finfo(tt)
        self.bits = info.bits
        self.eps = builtins.float(info.eps)
        self.max = builtins.float(info.max)
        self.min = builtins.float(info.min)
        self.tiny = builtins.float(info.tiny)
        return self


class iinfo:
    """Machine limits for integer types (reference: types.py:1007;
    ``heat_tpu`` :591); bool passes the type check and then raises
    ``ValueError``, as ``jnp.iinfo`` does there."""

    def __new__(cls, dtype: Type[datatype]):
        try:
            dtype = canonical_heat_type(dtype)
        except TypeError:
            raise TypeError(f"data type {dtype} not exact, not supported")
        if dtype not in (*_exact, bool):
            raise TypeError(f"data type {dtype} not exact, not supported")
        return super().__new__(cls)._init(dtype)

    def _init(self, dtype):
        if dtype is bool:
            raise ValueError("Invalid integer data type 'b'.")
        info = torch.iinfo(dtype.torch_type())
        self.bits = info.bits
        self.max = builtins.int(info.max)
        self.min = builtins.int(info.min)
        return self


def iscomplex(x):
    """Elementwise: a nonzero imaginary part (``heat_tpu`` types.py:555)."""
    from . import _operations

    return _operations.__local_op(
        lambda t: t.imag != 0 if t.is_complex() else torch.zeros_like(t, dtype=torch.bool), x, None, no_cast=True
    )


def isreal(x):
    """Elementwise: a zero imaginary part (``heat_tpu`` types.py:562)."""
    from . import _operations

    return _operations.__local_op(
        lambda t: t.imag == 0 if t.is_complex() else torch.ones_like(t, dtype=torch.bool), x, None, no_cast=True
    )
