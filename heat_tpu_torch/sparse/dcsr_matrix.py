"""Compressed sparse row matrix, distributed along axis 0.

Port of ``heat_tpu.sparse.dcsr_matrix`` (Heat reference:
heat/sparse/dcsr_matrix.py, ``DCSR_matrix`` at :18). ``heat_tpu`` keeps a
replicated ``indptr`` and shards ``indices``/``data`` evenly over the nnz
axis of its mesh. At world size 1 the "even nnz sharding" is the whole
array: ``indptr`` (m+1,), ``indices`` (gnnz,) and ``data`` (gnnz,) are
torch tensors on the matrix's device, unpadded, and the local (``l*``)
views are the whole matrix.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core import types
from ..core.communication import Communication
from ..core.devices import Device
from ..core.dndarray import DNDarray

__all__ = ["DCSR_matrix"]


class DCSR_matrix:
    """CSR matrix distributed along axis 0 (reference dcsr_matrix.py:18).

    Parameters
    ----------
    indptr : torch.Tensor
        Row pointer, shape (gshape[0] + 1,), int32.
    indices : torch.Tensor
        Column indices, shape (gnnz,), int32.
    data : torch.Tensor
        Values, shape (gnnz,).
    gnnz : int
        Number of stored elements.
    gshape : tuple of int
    dtype : datatype
    split : 0 or None
        Row distribution (only axis 0, as in the reference).
    device, comm, balanced : as in DNDarray.
    """

    def __init__(
        self,
        indptr: torch.Tensor,
        indices: torch.Tensor,
        data: torch.Tensor,
        gnnz: int,
        gshape: Tuple[int, ...],
        dtype,
        split: Optional[int],
        device: Device,
        comm: Communication,
        balanced: bool = True,
    ):
        if split not in (None, 0):
            raise ValueError(f"DCSR_matrix only supports split=0 or None, got {split}")
        self.__indptr = indptr
        self.__indices = indices
        self.__data = data
        self.__rows_cache = None
        self.__gnnz = int(gnnz)
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = dtype
        self.__split = split
        self.__device = device
        self.__comm = comm
        self.__balanced = bool(balanced)

    # ------------------------------------------------------------------ #
    # global components                                                  #
    # ------------------------------------------------------------------ #
    def __matmul__(self, other):
        """``A @ x``: SpMV/SpMM (see sparse.linalg)."""
        from . import linalg as _slinalg

        return _slinalg.matmul(self, other)

    @property
    def indptr(self) -> torch.Tensor:
        """Global indptr (reference dcsr_matrix.py:155)."""
        return self.__indptr

    gindptr = indptr

    @property
    def indices(self) -> torch.Tensor:
        """Global column indices (reference dcsr_matrix.py:179)."""
        return self.__indices

    gindices = indices

    @property
    def data(self) -> torch.Tensor:
        """Global values (reference dcsr_matrix.py:126)."""
        return self.__data

    gdata = data

    @property
    def _rows(self) -> torch.Tensor:
        """COO row index of each stored element, derived once and cached
        (an iterative SpMV would otherwise search indptr per multiply)."""
        if self.__rows_cache is None:
            from ._operations import rows_from_indptr

            self.__rows_cache = rows_from_indptr(self.__indptr, self.__gnnz)
        return self.__rows_cache

    @property
    def _phys_components(self):
        """(indptr, indices, data): at world size 1 the physical
        components are the logical ones."""
        return self.__indptr, self.__indices, self.__data

    @property
    def component_nbytes(self) -> int:
        """Total bytes of the stored components."""
        return sum(c.numel() * c.element_size() for c in self._phys_components)

    @property
    def larray(self):
        """The (indptr, indices, data) triple of this process's row block
        (reference dcsr_matrix.py:119): the whole matrix at world size 1."""
        return (self.lindptr, self.lindices, self.ldata)

    # ------------------------------------------------------------------ #
    # local views: the whole matrix at world size 1                      #
    # ------------------------------------------------------------------ #
    @property
    def lindptr(self) -> torch.Tensor:
        """Local indptr (reference :172)."""
        return self.__indptr

    @property
    def lindices(self) -> torch.Tensor:
        """Local column indices (reference :201)."""
        return self.__indices

    @property
    def ldata(self) -> torch.Tensor:
        """Local values (reference :148)."""
        return self.__data

    # ------------------------------------------------------------------ #
    # metadata                                                           #
    # ------------------------------------------------------------------ #
    @property
    def balanced(self) -> bool:
        return self.__balanced

    @property
    def comm(self) -> Communication:
        return self.__comm

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def dtype(self):
        return self.__dtype

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def nnz(self) -> int:
        """Number of stored elements (reference :215)."""
        return self.__gnnz

    @property
    def gnnz(self) -> int:
        return self.__gnnz

    @property
    def lnnz(self) -> int:
        """nnz of this process's row block (reference :229)."""
        return self.__gnnz

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def gshape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def lshape(self) -> Tuple[int, ...]:
        _, lshape, _ = self.__comm.chunk(self.__gshape, self.__split)
        return lshape

    @property
    def split(self) -> Optional[int]:
        return self.__split

    def is_distributed(self) -> bool:
        return self.__split is not None and self.__comm.is_distributed()

    # ------------------------------------------------------------------ #
    # methods                                                            #
    # ------------------------------------------------------------------ #
    def global_indptr(self) -> DNDarray:
        """Global indptr as a DNDarray (reference dcsr_matrix.py:64)."""
        if self.__split is None:
            raise ValueError("This method works only for distributed matrices")
        return DNDarray(
            self.__indptr, (self.__gshape[0] + 1,), types.canonical_heat_type(self.__indptr.dtype),
            None, self.__device, self.__comm,
        )

    def counts_displs_nnz(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-rank nnz counts and displacements by row block (reference
        :276): one rank holding everything."""
        if self.__split is None:
            raise ValueError("Non-distributed DCSR_matrix. Cannot calculate counts and displacements.")
        return (self.__gnnz,), (0,)

    def astype(self, dtype, copy: bool = True) -> "DCSR_matrix":
        """Cast values to ``dtype`` (reference :292)."""
        dtype = types.canonical_heat_type(dtype)
        data = self.__data.to(dtype.torch_type())
        if not copy:
            self.__data = data
            self.__dtype = dtype
            return self
        return DCSR_matrix(
            self.__indptr, self.__indices, data, self.__gnnz, self.__gshape,
            dtype, self.__split, self.__device, self.__comm,
        )

    def todense(self, order: str = "C", out: Optional[DNDarray] = None) -> DNDarray:
        from . import manipulations

        return manipulations.to_dense(self, order=order, out=out)

    to_dense = todense

    def __repr__(self) -> str:
        from .factories import _host_numpy

        ptr, idx, dat = (_host_numpy(t) for t in self._phys_components)
        return (
            f"(indptr: {ptr}, indices: {idx}, data: {np.asarray(dat)}, "
            f"dtype=ht.{self.__dtype.__name__}, device={self.__device}, split={self.__split})"
        )
