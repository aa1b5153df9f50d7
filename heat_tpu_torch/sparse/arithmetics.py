"""Elementwise arithmetic on DCSR matrices.

Port of ``heat_tpu.sparse.arithmetics`` (Heat reference:
heat/sparse/arithmetics.py, ``add`` at :16, ``mul`` at :54), exported as
``sparse_add``/``sparse_mul`` by the package, plus the ``+``/``*`` dunders.
"""

from __future__ import annotations

from . import _operations
from .dcsr_matrix import DCSR_matrix

__all__ = ["add", "mul"]


def add(t1: DCSR_matrix, t2) -> DCSR_matrix:
    """Elementwise addition; the result's pattern is the union of both
    operands' patterns (reference arithmetics.py:16)."""
    return _operations.binary_op_csr("add", t1, t2)


def mul(t1: DCSR_matrix, t2) -> DCSR_matrix:
    """Elementwise (Hadamard) multiplication; the result's pattern is the
    intersection (reference arithmetics.py:54). A scalar operand scales
    the values."""
    return _operations.binary_op_csr("mul", t1, t2)


DCSR_matrix.__add__ = lambda self, other: add(self, other)
DCSR_matrix.__radd__ = lambda self, other: add(self, other)
DCSR_matrix.__mul__ = lambda self, other: mul(self, other)
DCSR_matrix.__rmul__ = lambda self, other: mul(self, other)
