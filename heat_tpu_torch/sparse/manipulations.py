"""Manipulations for DCSR matrices.

Port of ``heat_tpu.sparse.manipulations`` (Heat reference:
heat/sparse/manipulations.py, ``to_sparse`` at :16, ``to_dense`` at :52),
both attached to the array classes. Across ranks both work on each rank's
rows: a split-0 DNDarray becomes a split-0 DCSR_matrix with the same row
map, and a split-0 DCSR_matrix a split-0 DNDarray in the chunk geometry
(moved there by one all-to-all only where the matrix has other row
counts).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.dndarray import DNDarray
from .dcsr_matrix import DCSR_matrix
from .factories import _from_local, _to_scipy_csr, _values, sparse_csr_matrix

__all__ = ["to_dense", "to_sparse"]


def to_sparse(array: DNDarray) -> DCSR_matrix:
    """DNDarray → DCSR_matrix (reference manipulations.py:16). The pattern
    depends on the data, so it is found on the host at construction; across
    ranks each rank finds its own rows' (a split-1 operand is resplit to 0
    first)."""
    if array.ndim != 2:
        raise ValueError(f"to_sparse requires a 2-D DNDarray, got {array.ndim}-D")
    if array.is_distributed():
        if array.split != 0:
            array = array.resplit(0)
        csr = _to_scipy_csr(array.larray)
        return _from_local(
            csr.indptr.astype(np.int32), csr.indices.astype(np.int32), _values(csr.data, array.dtype, array.device),
            array.shape, 0, array.device, array.comm, None, array.lshape_map[:, 0],
        )
    split = 0 if array.split is not None else None
    return sparse_csr_matrix(array.numpy(), dtype=array.dtype, split=split, device=array.device, comm=array.comm)


DNDarray.to_sparse = to_sparse


def to_dense(sparse_matrix: DCSR_matrix, order: str = "C", out: Optional[DNDarray] = None) -> DNDarray:
    """DCSR_matrix → dense DNDarray with the same split (reference
    manipulations.py:52): one scatter of each rank's rows on the matrix's
    device."""
    if order not in ("C",):
        raise NotImplementedError("only order='C' semantics exist")
    m, n = sparse_matrix.shape
    _, cols, data = sparse_matrix._phys_components
    rows = sparse_matrix.lshape[0]
    dense = torch.zeros((rows, n), dtype=data.dtype, device=data.device)
    if sparse_matrix.lnnz:
        dense[sparse_matrix._rows.long(), cols.long()] = data
    lmap = None
    if sparse_matrix.is_distributed():
        lmap = np.array([[c, n] for c in sparse_matrix.row_counts], dtype=np.int64)
    result = DNDarray(dense, (m, n), sparse_matrix.dtype, sparse_matrix.split, sparse_matrix.device,
                      sparse_matrix.comm, lmap)
    result.balance_()
    if out is not None:
        if out.shape != result.shape:
            raise ValueError(f"out has shape {out.shape}, expected {result.shape}")
        if out.split != result.split:
            raise ValueError(f"out has split {out.split}, expected {result.split}")
        out.larray = result.larray.to(out.dtype.torch_type())
        return out
    return result
