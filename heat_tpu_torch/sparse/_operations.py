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

Across ranks each rank combines the rows of its block. Two operands split
along the rows with the same row map move no data; one with another map
is moved to the first's (one all-to-all of the row lengths, of the
indices and of the values), and one that is whole on every rank gives
each rank its block's rows. The result's gnnz costs one scalar
all-reduce (``DCSR_matrix`` counts it at construction).
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


def _rows_of(A: DCSR_matrix, r0: int, rows: int):
    """(indptr from 0, indices, data) of rows [r0, r0 + rows) of a matrix
    held whole on this rank."""
    indptr, indices, data = A._phys_components
    lo, hi = int(indptr[r0]), int(indptr[r0 + rows])
    return indptr[r0 : r0 + rows + 1] - lo, indices[lo:hi], data[lo:hi]


def _moved(A: DCSR_matrix, counts):
    """(indptr from 0, indices, data) of this rank's rows of the split
    matrix ``A`` moved to the row map ``counts``: rows keep their global
    order, so the rows each rank sends to each other rank are one run
    (three all-to-alls: row lengths, indices, values)."""
    comm = A.comm
    r = comm.rank
    src = np.concatenate([[0], np.cumsum(A.row_counts)])
    dst = np.concatenate([[0], np.cumsum(counts)])

    def overlap(a, b):
        return int(max(0, min(a[1], b[1]) - max(a[0], b[0])))

    send = [overlap(src[r : r + 2], dst[q : q + 2]) for q in range(comm.size)]
    recv = [overlap(src[q : q + 2], dst[r : r + 2]) for q in range(comm.size)]
    indptr, indices, data = A._phys_components
    ptr = indptr.long()
    lengths = comm.alltoall((ptr[1:] - ptr[:-1]).contiguous(), send, recv)
    edges = ptr[torch.as_tensor(np.concatenate([[0], np.cumsum(send)]), device=ptr.device)].tolist()
    send_nnz = [edges[q + 1] - edges[q] for q in range(comm.size)]
    recv_edges = np.concatenate([[0], np.cumsum(recv)])
    sums = torch.cat([torch.zeros(1, dtype=torch.int64, device=lengths.device), torch.cumsum(lengths, 0)])
    at = sums[torch.as_tensor(recv_edges, device=sums.device)].tolist()
    recv_nnz = [at[q + 1] - at[q] for q in range(comm.size)]
    new_ptr = sums.to(torch.int32)
    return new_ptr, comm.alltoall(indices.contiguous(), send_nnz, recv_nnz), comm.alltoall(data.contiguous(), send_nnz,
                                                                                          recv_nnz)


def aligned(A: DCSR_matrix, counts):
    """(indptr from 0, indices, data) of this rank's rows of ``A`` under the
    row map ``counts`` (``A``'s own where it is split that way)."""
    if A.is_distributed():
        if tuple(A.row_counts) == tuple(counts):
            return A._phys_components
        return _moved(A, counts)
    r0 = int(sum(counts[: A.comm.rank]))
    return _rows_of(A, r0, int(counts[A.comm.rank]))


def binary_op_csr(op_key: str, t1: DCSR_matrix, t2) -> DCSR_matrix:
    """Elementwise binary op on two DCSR matrices, or matrix × scalar for
    ``mul`` (reference _operations.py:17). Across ranks the result has the
    row map of the first split operand."""
    from .factories import _from_local

    if np.isscalar(t2) or isinstance(t2, (int, float)):
        if op_key == "mul":
            # promote like dense arithmetic: int matrix x float scalar -> float
            out_type = types.promote_types(t1.dtype, types.canonical_heat_type(type(t2)))
            tt = out_type.torch_type()
            indptr, indices, data = t1._phys_components
            data = data.to(tt) * torch.tensor(t2, dtype=tt, device=data.device)
            return _from_local(indptr, indices, data, t1.shape, t1.split, t1.device, t1.comm, t1.gnnz,
                               t1.row_counts if t1.is_distributed() else None)
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
    split = t1.split if t1.split is not None else t2.split
    counts = None
    if t1.is_distributed() or t2.is_distributed():
        counts = (t1 if t1.is_distributed() else t2).row_counts
        (p1, i1, d1), (p2, i2, d2) = aligned(t1, counts), aligned(t2, counts)
        rows = int(counts[t1.comm.rank])
        r1, r2 = rows_from_indptr(p1, int(i1.shape[0])), rows_from_indptr(p2, int(i2.shape[0]))
    else:
        (_, i1, d1), (_, i2, d2) = t1._phys_components, t2._phys_components
        rows, r1, r2 = m, t1._rows, t2._rows
    dev = d1.device
    indptr, cols, vals = _binary_csr(
        op_key, i1, d1.to(tt), r1, i2.to(dev), d2.to(device=dev, dtype=tt), r2.to(dev), rows, ncols,
    )
    return _from_local(indptr, cols, vals, (m, ncols), split, t1.device, t1.comm, None, counts)
