"""Elementwise comparisons (port of ``heat_tpu.core.relational``; Heat
reference: heat/core/relational.py): every one through
``_operations.__binary_op`` (broadcasting, mixed splits), giving bool
arrays split like the dominant operand; ``equal`` gives one Python bool,
the same on every rank."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray
from .stride_tricks import broadcast_shape

__all__ = [
    "eq",
    "equal",
    "ge",
    "greater",
    "greater_equal",
    "gt",
    "le",
    "less",
    "less_equal",
    "lt",
    "ne",
    "not_equal",
]


def _ordered(fn):
    """``fn`` (``torch.lt`` or ``torch.gt``, or their non-strict forms),
    complex operands ordered by real part, then imaginary part, as in
    ``jnp``."""

    def op(a, b):
        a, b = _operations.operands(a, b)
        if not a.dtype.is_complex:
            return fn(a, b)
        tie = a.real == b.real
        first = torch.lt if fn in (torch.lt, torch.le) else torch.gt
        return first(a.real, b.real) | (tie & fn(a.imag, b.imag))

    return op


def eq(t1, t2) -> DNDarray:
    """Elementwise ``t1 == t2`` (reference: relational.py eq)."""
    return _operations.__binary_op(torch.eq, t1, t2)


def equal(t1, t2) -> bool:
    """True if both operands have one broadcast shape and equal elements
    (reference: relational.py equal): the local verdict and one
    ``allreduce``, so that every rank returns the same bool."""
    if not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray):
        raise TypeError("at least one operand must be a DNDarray")
    s1 = tuple(t1.shape) if isinstance(t1, DNDarray) else ()
    s2 = tuple(t2.shape) if isinstance(t2, DNDarray) else ()
    if isinstance(t1, DNDarray) and isinstance(t2, DNDarray) and s1 != s2:
        try:
            broadcast_shape(s1, s2)
        except ValueError:
            return False
    return _all_ranks(eq(t1, t2))


def _all_ranks(x: DNDarray) -> bool:
    """Whether every element of the bool array ``x`` holds, on every rank
    (gloo's ``all_reduce`` takes no bool: the verdict crosses as uint8)."""
    local = x.larray.all().to(torch.uint8).reshape(1)
    if x.is_distributed():
        local = x.comm.allreduce(local, "min")
    return bool(local.item())


def ge(t1, t2) -> DNDarray:
    """Elementwise ``t1 >= t2``."""
    return _operations.__binary_op(_ordered(torch.ge), t1, t2)


greater_equal = ge


def gt(t1, t2) -> DNDarray:
    """Elementwise ``t1 > t2``."""
    return _operations.__binary_op(_ordered(torch.gt), t1, t2)


greater = gt


def le(t1, t2) -> DNDarray:
    """Elementwise ``t1 <= t2``."""
    return _operations.__binary_op(_ordered(torch.le), t1, t2)


less_equal = le


def lt(t1, t2) -> DNDarray:
    """Elementwise ``t1 < t2``."""
    return _operations.__binary_op(_ordered(torch.lt), t1, t2)


less = lt


def ne(t1, t2) -> DNDarray:
    """Elementwise ``t1 != t2``."""
    return _operations.__binary_op(torch.ne, t1, t2)


not_equal = ne

DNDarray.__eq__ = lambda self, other: eq(self, other)
DNDarray.__ne__ = lambda self, other: ne(self, other)
DNDarray.__lt__ = lambda self, other: lt(self, other)
DNDarray.__le__ = lambda self, other: le(self, other)
DNDarray.__gt__ = lambda self, other: gt(self, other)
DNDarray.__ge__ = lambda self, other: ge(self, other)
DNDarray.__hash__ = None
