"""Manipulations for DCSR matrices.

Port of ``heat_tpu.sparse.manipulations`` (Heat reference:
heat/sparse/manipulations.py, ``to_sparse`` at :16, ``to_dense`` at :52),
both attached to the array classes.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.dndarray import DNDarray
from .dcsr_matrix import DCSR_matrix
from .factories import sparse_csr_matrix

__all__ = ["to_dense", "to_sparse"]


def to_sparse(array: DNDarray) -> DCSR_matrix:
    """DNDarray → DCSR_matrix (reference manipulations.py:16). The pattern
    depends on the data, so it is found on the host at construction."""
    if array.ndim != 2:
        raise ValueError(f"to_sparse requires a 2-D DNDarray, got {array.ndim}-D")
    split = 0 if array.split is not None else None
    return sparse_csr_matrix(array.numpy(), dtype=array.dtype, split=split, device=array.device, comm=array.comm)


DNDarray.to_sparse = to_sparse


def to_dense(sparse_matrix: DCSR_matrix, order: str = "C", out: Optional[DNDarray] = None) -> DNDarray:
    """DCSR_matrix → dense DNDarray with the same split (reference
    manipulations.py:52): one scatter on the matrix's device."""
    if order not in ("C",):
        raise NotImplementedError("only order='C' semantics exist")
    m, n = sparse_matrix.shape
    indptr, cols, data = sparse_matrix._phys_components
    dense = torch.zeros((m, n), dtype=data.dtype, device=data.device)
    if sparse_matrix.gnnz:
        dense[sparse_matrix._rows.long(), cols.long()] = data
    result = DNDarray(dense, (m, n), sparse_matrix.dtype, sparse_matrix.split, sparse_matrix.device,
                      sparse_matrix.comm)
    if out is not None:
        if out.shape != result.shape:
            raise ValueError(f"out has shape {out.shape}, expected {result.shape}")
        if out.split != result.split:
            raise ValueError(f"out has split {out.split}, expected {result.split}")
        out.larray = dense.to(out.dtype.torch_type())
        return out
    return result
