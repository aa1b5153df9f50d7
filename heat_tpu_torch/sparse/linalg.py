"""Sparse linear algebra: SpMV / SpMM / SDDMM for the sparse formats.

Port of ``heat_tpu.sparse.linalg``. Two engines, chosen by the operand's
type:

* ``DCSR_matrix``: the segment-sum over the scalar entries,
  ``y = index_add(rows, data * x[indices])``, with ``rows`` the cached COO
  row map. On the CPU it adds in entry order, so a rerun repeats the
  bits; on CUDA ``index_add_`` adds with atomics, so a rerun may differ in
  the last bits. ``heat_tpu`` runs no Pallas kernel here either.
* ``DBCSR_matrix``: the brick engine (kernels/spmm.py). A CUDA operand
  whose types ``spmm_serviceable`` admits runs kernel K7, whose reruns
  repeat the bits; other types take the plain version.

The dense operand may be a DNDarray, a torch.Tensor or a numpy array; it
moves to the matrix's device. Sub-float32 data accumulates in float32 and
is cast back at the end. The result is a DNDarray split like the matrix.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..kernels import spmm as _spmm
from .dcsr_matrix import DCSR_matrix
from .dbcsr_matrix import DBCSR_matrix

__all__ = ["matmul", "sddmm"]


def _dense_operand(A, x) -> torch.Tensor:
    """The dense operand as a tensor on ``A``'s device."""
    if isinstance(x, DNDarray):
        x = x.larray
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(A.device.torch_device)


def _check_operand(A, xarr: torch.Tensor) -> None:
    if xarr.ndim not in (1, 2):
        raise ValueError(f"dense operand must be 1-D or 2-D, got {xarr.ndim}-D")
    m, n = A.shape
    if xarr.shape[0] != n:
        raise ValueError(f"dimension mismatch: A is {A.shape}, dense operand has leading dim {xarr.shape[0]}")


def matmul(A: Union[DCSR_matrix, DBCSR_matrix], x: Union[DNDarray, torch.Tensor, np.ndarray]) -> DNDarray:
    """``A @ x`` for a sparse matrix and a dense vector or matrix.

    Returns a DNDarray of shape (m,) or (m, k), split along axis 0 when
    ``A`` is (split like ``A``).
    """
    if not isinstance(A, (DCSR_matrix, DBCSR_matrix)):
        raise TypeError(f"A must be a DCSR_matrix or DBCSR_matrix, got {type(A)}")
    xarr = _dense_operand(A, x)
    _check_operand(A, xarr)
    m, n = A.shape
    out_dtype = types.promote_types(A.dtype, types.canonical_heat_type(xarr.dtype))
    tt = out_dtype.torch_type()
    acc = _spmm.acc_dtype(tt)
    x2d = xarr if xarr.ndim == 2 else xarr[:, None]
    k = int(x2d.shape[1])
    if isinstance(A, DBCSR_matrix):
        bdata, bcol, brow, bmask = A._phys_components
        bd, xa = bdata.to(acc), x2d.to(acc).contiguous()
        if _spmm.spmm_serviceable(bdata.dtype, x2d.dtype, k):
            y = _spmm.brick_spmm(bd, bcol, brow, bmask, A._brick_rowptr, xa, m)
        else:
            y = _spmm.brick_spmm_plain(bd, bcol, brow, bmask, xa, m)
    else:
        _, indices, data = A._phys_components
        y = torch.zeros((m, k), dtype=acc, device=xarr.device)
        if A.gnnz:
            contrib = data.to(acc)[:, None] * x2d.to(acc)[indices.long()]
            y.index_add_(0, A._rows.long(), contrib)
    y = y.to(tt)
    gshape = (m,) if xarr.ndim == 1 else (m, k)
    return DNDarray(y.reshape(gshape), gshape, out_dtype, 0 if A.split == 0 else None, A.device, A.comm)


def sddmm(
    S: DBCSR_matrix,
    u: Union[DNDarray, torch.Tensor, np.ndarray],
    v: Union[DNDarray, torch.Tensor, np.ndarray],
) -> DBCSR_matrix:
    """Sampled dense-dense matmul ``C = S ∘ (u @ vᵀ)``, computed on the
    stored bricks of ``S`` only (pattern kept, pad bricks stay zero).
    ``u`` is (m, d), ``v`` is (n, d); the result shares S's slab
    structure. A CUDA operand whose types ``sddmm_serviceable`` admits
    runs kernel K8."""
    if not isinstance(S, DBCSR_matrix):
        raise TypeError(f"S must be a DBCSR_matrix, got {type(S)}")
    uarr = _dense_operand(S, u)
    varr = _dense_operand(S, v)
    m, n = S.shape
    if uarr.ndim != 2 or varr.ndim != 2:
        raise ValueError("sddmm operands must be 2-D (m, d) and (n, d)")
    if uarr.shape[0] != m or varr.shape[0] != n:
        raise ValueError(
            f"dimension mismatch: S is {S.shape}, u is {tuple(uarr.shape)}, v is {tuple(varr.shape)}"
        )
    if uarr.shape[1] != varr.shape[1]:
        raise ValueError(f"sddmm inner dims differ: {uarr.shape[1]} vs {varr.shape[1]}")
    out_dtype = types.promote_types(
        S.dtype,
        types.promote_types(types.canonical_heat_type(uarr.dtype), types.canonical_heat_type(varr.dtype)),
    )
    tt = out_dtype.torch_type()
    acc = _spmm.acc_dtype(tt)
    sdata, bcol, brow, bmask = S._phys_components
    sd, ua, va = sdata.to(acc), uarr.to(acc).contiguous(), varr.to(acc).contiguous()
    if _spmm.sddmm_serviceable(sdata.dtype, uarr.dtype, varr.dtype, int(uarr.shape[1])):
        out = _spmm.brick_sddmm(sd, brow, bcol, *S._brick_colorder, ua, va)
    else:
        out = _spmm.brick_sddmm_plain(sd, brow, bcol, ua, va)
    return DBCSR_matrix(
        out.to(tt), bcol, brow, bmask, S._slab_meta, S.gnnz, S.nbricks, S.shape, out_dtype, S.split, S.device, S.comm,
    )
