"""DCSR_matrix factories.

Port of ``heat_tpu.sparse.factories`` (Heat reference:
heat/sparse/factories.py, ``sparse_csr_matrix`` at :23): build from scipy
sparse, a torch sparse-CSR tensor, a dense array-like or a DNDarray, with
``split``/``is_split`` semantics. With ``is_split=0`` a list holds this
process's row blocks, stitched in order. The pattern is found on the host
with scipy, as ``heat_tpu`` finds it; the components then land on the
device.
"""

from __future__ import annotations

from typing import Iterable, Optional, Type

import numpy as np
import torch

from ..core import types
from ..core.communication import Communication, sanitize_comm
from ..core.devices import Device, sanitize_device
from .dcsr_matrix import DCSR_matrix

__all__ = ["sparse_csr_matrix"]


def _host_dtype(dtype) -> np.dtype:
    """The numpy dtype that carries values of the heat type ``dtype`` on
    the host: its own, or float32 for bfloat16 (numpy has none; every
    bfloat16 value is exact in float32)."""
    dtype = types.canonical_heat_type(dtype)
    if dtype is types.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(torch.empty((), dtype=dtype.torch_type()).numpy().dtype)


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 as float32 (numpy
    has none; every bfloat16 value is exact in float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _values(values, dtype, device: Device) -> torch.Tensor:
    """Host values as a tensor of heat type ``dtype`` on ``device``."""
    return torch.tensor(np.asarray(values)).to(device=device.torch_device, dtype=dtype.torch_type())


def _from_components(indptr, indices, data, gshape, split, device: Device, comm) -> DCSR_matrix:
    """A DCSR_matrix from global CSR components (host arrays or tensors;
    ``data`` a tensor, whose dtype the matrix takes)."""
    dev = device.torch_device
    indptr = torch.as_tensor(indptr).to(device=dev, dtype=torch.int32)
    indices = torch.as_tensor(indices).to(device=dev, dtype=torch.int32)
    data = data.to(dev)
    return DCSR_matrix(
        indptr, indices, data, int(indices.shape[0]), tuple(int(s) for s in gshape),
        types.canonical_heat_type(data.dtype), split, device, comm, True,
    )


def _to_scipy_csr(obj, dtype_np=None):
    """Normalize any supported input (scipy sparse, a DCSR matrix, a torch
    sparse-CSR or dense tensor, a DNDarray, an array-like) to a scipy CSR
    matrix on the host."""
    import scipy.sparse as sp

    from ..core.dndarray import DNDarray

    if sp.issparse(obj):
        return obj.tocsr()
    if isinstance(obj, DCSR_matrix):
        return sp.csr_matrix(
            (_host_numpy(obj.data), _host_numpy(obj.indices), _host_numpy(obj.indptr)), shape=obj.shape
        )
    if isinstance(obj, DNDarray):
        obj = obj.numpy()
    if isinstance(obj, torch.Tensor):
        if obj.layout == torch.sparse_csr:
            return sp.csr_matrix(
                (_host_numpy(obj.values()), _host_numpy(obj.col_indices()), _host_numpy(obj.crow_indices())),
                shape=tuple(obj.shape),
            )
        obj = _host_numpy(obj)
    dense = np.asarray(obj, dtype=dtype_np)
    if dense.ndim != 2:
        raise ValueError(f"sparse_csr_matrix requires 2-D input, got {dense.ndim}-D")
    return sp.csr_matrix(dense)


def sparse_csr_matrix(
    obj: Iterable,
    dtype: Optional[Type[types.datatype]] = None,
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device: Optional[Device] = None,
    comm: Optional[Communication] = None,
) -> DCSR_matrix:
    """Create a DCSR_matrix (reference factories.py:23).

    ``obj`` may be a scipy sparse matrix, a torch sparse-CSR tensor, a
    dense array-like, a DNDarray, or, with ``is_split=0``, a list of row
    blocks in any of those forms.
    """
    if split is not None and split != 0:
        raise ValueError(f"split must be 0 or None, got {split}")
    if is_split is not None and is_split != 0:
        raise ValueError(f"is_split must be 0 or None, got {is_split}")
    if split is not None and is_split is not None:
        raise ValueError("split and is_split are mutually exclusive")
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    dtype_np = _host_dtype(dtype) if dtype is not None else None

    if is_split is not None and isinstance(obj, (list, tuple)):
        import scipy.sparse as sp

        csr = sp.vstack([_to_scipy_csr(o, dtype_np) for o in obj]).tocsr()
        split = 0
    else:
        csr = _to_scipy_csr(obj, dtype_np)
        if is_split is not None:
            split = 0  # this process's block of a distributed matrix

    if dtype is None:
        dtype = types.canonical_heat_type(csr.data.dtype if csr.nnz else np.float32)
    dtype = types.canonical_heat_type(dtype)
    return _from_components(
        csr.indptr.astype(np.int32), csr.indices.astype(np.int32), _values(csr.data, dtype, device),
        csr.shape, split, device, comm,
    )
