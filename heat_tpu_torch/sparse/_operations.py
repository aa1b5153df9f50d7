"""Elementwise binary machinery for DCSR matrices.

Port of ``heat_tpu.sparse._operations`` (Heat reference:
heat/sparse/_operations.py, ``__binary_op_csr`` at :17). The union or
intersection of two patterns comes from one stable sort of linearized
keys ``row * ncols + col`` over both operands' entries (each key appears
at most twice, once per operand, because a CSR pattern has no
duplicates): adjacent equal keys merge, the operation combines them, and
the kept entries are compacted in key order. The keys are int64 once
``m * ncols`` exceeds int32. The arithmetic is ``heat_tpu``'s, so values
and patterns agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import types
from .dcsr_matrix import DCSR_matrix

__all__ = []


def rows_from_indptr(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """COO row index of each stored element:
    ``rows[i] = searchsorted(indptr, i, right=True) - 1`` (int32)."""
    ids = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return (torch.searchsorted(indptr, ids, right=True) - 1).to(torch.int32)


def _binary_csr(op_key: str, cols1, data1, rows1, cols2, data2, rows2, m: int, ncols: int):
    """(indptr, cols, values) of the elementwise ``op_key`` of two CSR
    patterns given as COO rows, columns and values of one dtype."""
    key_dt = torch.int64 if m * ncols > np.iinfo(np.int32).max else torch.int32
    keys = torch.cat([rows1.to(key_dt) * ncols + cols1.to(key_dt), rows2.to(key_dt) * ncols + cols2.to(key_dt)])
    a = torch.cat([data1, torch.zeros_like(data2)])
    b = torch.cat([torch.zeros_like(data1), data2])
    k, order = torch.sort(keys, stable=True)
    a, b = a[order], b[order]
    # duplicate keys are adjacent; fold the earlier slot's values into the
    # later one (each key appears at most twice)
    dup = torch.zeros_like(k, dtype=torch.bool)
    dup[1:] = k[1:] == k[:-1]
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    a_m = a + torch.where(dup, torch.roll(a, 1), zero)
    b_m = b + torch.where(dup, torch.roll(b, 1), zero)
    if op_key == "add":
        val = a_m + b_m
        # union: the last slot of each key group
        keep = torch.ones_like(dup)
        keep[:-1] = k[1:] != k[:-1]
    elif op_key == "mul":
        val = a_m * b_m
        # intersection: the merged slots only
        keep = dup
    else:
        raise ValueError(op_key)
    k, val = k[keep], val[keep]
    rows = torch.div(k, ncols, rounding_mode="floor")
    counts = torch.bincount(rows.to(torch.int64), minlength=m)
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=k.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr.to(torch.int32), (k - rows * ncols).to(torch.int32), val


def binary_op_csr(op_key: str, t1: DCSR_matrix, t2) -> DCSR_matrix:
    """Elementwise binary op on two DCSR matrices, or matrix × scalar for
    ``mul`` (reference _operations.py:17)."""
    from .factories import _from_components

    if np.isscalar(t2) or isinstance(t2, (int, float)):
        if op_key == "mul":
            # promote like dense arithmetic: int matrix x float scalar -> float
            out_type = types.promote_types(t1.dtype, types.canonical_heat_type(type(t2)))
            tt = out_type.torch_type()
            data = t1.data.to(tt) * torch.tensor(t2, dtype=tt, device=t1.data.device)
            return _from_components(t1.indptr, t1.indices, data, t1.shape, t1.split, t1.device, t1.comm)
        raise TypeError(
            "sparse add with a scalar densifies the matrix; convert with to_dense first "
            "(matches the reference's unsupported-op behavior)"
        )
    if not isinstance(t2, DCSR_matrix):
        raise TypeError(f"expected DCSR_matrix or scalar, got {type(t2)}")
    if t1.shape != t2.shape:
        raise ValueError(f"shapes do not match: {t1.shape} vs {t2.shape}")

    tt = types.promote_types(t1.dtype, t2.dtype).torch_type()
    m, ncols = t1.shape
    dev = t1.data.device
    indptr, cols, vals = _binary_csr(
        op_key,
        t1.indices, t1.data.to(tt), t1._rows,
        t2.indices.to(dev), t2.data.to(device=dev, dtype=tt), t2._rows.to(dev),
        m, ncols,
    )
    return _from_components(
        indptr, cols, vals, (m, ncols), t1.split if t1.split is not None else t2.split, t1.device, t1.comm,
    )
