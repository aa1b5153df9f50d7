"""Compressed sparse row matrix, distributed along axis 0.

Port of ``heat_tpu.sparse.dcsr_matrix`` (Heat reference:
heat/sparse/dcsr_matrix.py, ``DCSR_matrix`` at :18). The port keeps the
Heat reference's layout: a matrix split along axis 0 holds on each rank
the row slab of its chunk of the rows (the dense ``lshape_map``; a matrix
declared from blocks of other sizes keeps their row counts, and is not
``balanced``), as a local ``indptr`` that starts at 0, ``indices`` and
``data``. ``gnnz`` and ``gshape`` are global. ``heat_tpu``, one controller
over a mesh, keeps ``indptr`` whole and shards the nnz evenly instead, and
its ``l*`` views are device 0's row block; here they are this rank's.

The global components (``indptr``, ``indices``, ``data``) are this rank's
where the matrix is not split across ranks. Across ranks they are gathered
in row order by the collective ``global_components()``, which every rank
calls (three all-gathers, once; the result is kept), and the properties
then return them; a property read before that raises rather than start a
collective on one rank. ``gnnz`` is counted at construction, by one
all-reduce where the caller does not know it (every rank constructs the
matrix). Everything else stays on the rank.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
        This rank's row pointer, shape (local rows + 1,), int32, from 0.
    indices : torch.Tensor
        This rank's column indices, shape (local nnz,), int32.
    data : torch.Tensor
        This rank's values, shape (local nnz,).
    gnnz : int or None
        Number of stored elements over every rank; None counts them here
        with one all-reduce across ranks.
    gshape : tuple of int
    dtype : datatype
    split : 0 or None
        Row distribution (only axis 0, as in the reference).
    device, comm, balanced : as in DNDarray.
    row_counts : sequence of int, optional
        Every rank's row count where it differs from the chunk geometry.
    """

    def __init__(
        self,
        indptr: torch.Tensor,
        indices: torch.Tensor,
        data: torch.Tensor,
        gnnz: Optional[int],
        gshape: Tuple[int, ...],
        dtype,
        split: Optional[int],
        device: Device,
        comm: Communication,
        balanced: bool = True,
        row_counts: Optional[Sequence[int]] = None,
    ):
        if split not in (None, 0):
            raise ValueError(f"DCSR_matrix only supports split=0 or None, got {split}")
        self.__indptr = indptr
        self.__indices = indices
        self.__data = data
        self.__rows_cache = None
        self.__global = None
        self.__gnnz = None if gnnz is None else int(gnnz)
        if self.__gnnz is None:
            self.__gnnz = self.lnnz
            if split is not None and comm.is_distributed():
                t = torch.tensor([self.lnnz], dtype=torch.int64, device=indices.device)
                self.__gnnz = int(comm.allreduce(t).item())
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = dtype
        self.__split = split
        self.__device = device
        self.__comm = comm
        self.__row_counts = None
        if row_counts is not None and self.is_distributed():
            counts = tuple(int(c) for c in row_counts)
            if counts != tuple(int(c) for c in comm.lshape_map(self.__gshape, 0)[:, 0]):
                self.__row_counts = counts
        self.__balanced = bool(balanced) and self.__row_counts is None

    # ------------------------------------------------------------------ #
    # global components                                                  #
    # ------------------------------------------------------------------ #
    def __matmul__(self, other):
        """``A @ x``: SpMV/SpMM (see sparse.linalg)."""
        from . import linalg as _slinalg

        return _slinalg.matmul(self, other)

    def global_components(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(indptr, indices, data) of the whole matrix: this rank's where
        the matrix is not split across ranks, else gathered in row order
        (one all-gather of the row lengths, of the indices and of the
        values) and kept. Across ranks it is a collective: every rank
        calls it."""
        if not self.is_distributed():
            return self.__indptr, self.__indices, self.__data
        if self.__global is None:
            comm = self.__comm
            lengths = comm.allgather((self.__indptr[1:] - self.__indptr[:-1]).contiguous(), 0, self.row_counts)
            indptr = torch.zeros(self.__gshape[0] + 1, dtype=torch.int64, device=lengths.device)
            indptr[1:] = torch.cumsum(lengths.long(), 0)
            starts = np.concatenate([[0], np.cumsum(self.row_counts)])
            nnz = np.diff(indptr.cpu().numpy()[starts]).tolist()  # every rank's nnz, from the row lengths
            self.__global = (
                indptr.to(torch.int32),
                comm.allgather(self.__indices.contiguous(), 0, nnz),
                comm.allgather(self.__data.contiguous(), 0, nnz),
            )
        return self.__global

    def __gathered(self):
        """The global components for a property: this rank's, or those that
        ``global_components()`` gathered across ranks."""
        if self.is_distributed() and self.__global is None:
            raise RuntimeError(
                "across ranks the global indptr, indices and data are gathered by the collective "
                "global_components(), which every rank calls first; lindptr, lindices and ldata are this rank's"
            )
        return self.global_components()

    @property
    def indptr(self) -> torch.Tensor:
        """Global indptr (reference dcsr_matrix.py:155)."""
        return self.__gathered()[0]

    gindptr = indptr

    @property
    def indices(self) -> torch.Tensor:
        """Global column indices (reference dcsr_matrix.py:179)."""
        return self.__gathered()[1]

    gindices = indices

    @property
    def data(self) -> torch.Tensor:
        """Global values (reference dcsr_matrix.py:126)."""
        return self.__gathered()[2]

    gdata = data

    @property
    def _rows(self) -> torch.Tensor:
        """COO row index (in this rank's rows) of each local stored element,
        derived once and cached (an iterative SpMV would otherwise search
        indptr per multiply)."""
        if self.__rows_cache is None:
            from ._operations import rows_from_indptr

            self.__rows_cache = rows_from_indptr(self.__indptr, self.lnnz)
        return self.__rows_cache

    @property
    def _phys_components(self):
        """(indptr, indices, data) of this rank's row slab."""
        return self.__indptr, self.__indices, self.__data

    @property
    def component_nbytes(self) -> int:
        """Bytes of this rank's stored components."""
        return sum(c.numel() * c.element_size() for c in self._phys_components)

    @property
    def larray(self):
        """The (indptr, indices, data) triple of this process's row block
        (reference dcsr_matrix.py:119)."""
        return (self.lindptr, self.lindices, self.ldata)

    # ------------------------------------------------------------------ #
    # local views                                                        #
    # ------------------------------------------------------------------ #
    @property
    def lindptr(self) -> torch.Tensor:
        """Local indptr, from 0 (reference :172)."""
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
        """Number of stored elements over every rank (reference :215)."""
        return self.gnnz

    @property
    def gnnz(self) -> int:
        return self.__gnnz

    @property
    def lnnz(self) -> int:
        """nnz of this process's row block (reference :229)."""
        return int(self.__indices.shape[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def gshape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def lshape(self) -> Tuple[int, ...]:
        return int(self.__indptr.shape[0]) - 1, self.__gshape[1]

    @property
    def row_counts(self) -> Tuple[int, ...]:
        """Every rank's row count: the chunk geometry unless the matrix was
        declared from blocks of other sizes."""
        if self.__row_counts is not None:
            return self.__row_counts
        if not self.is_distributed():
            return (self.__gshape[0],)
        return tuple(int(c) for c in self.__comm.lshape_map(self.__gshape, 0)[:, 0])

    @property
    def split(self) -> Optional[int]:
        return self.__split

    def is_distributed(self) -> bool:
        return self.__split is not None and self.__comm.is_distributed()

    # ------------------------------------------------------------------ #
    # methods                                                            #
    # ------------------------------------------------------------------ #
    def global_indptr(self) -> DNDarray:
        """Global indptr as a DNDarray (reference dcsr_matrix.py:64); across
        ranks a collective, as ``global_components()``."""
        if self.__split is None:
            raise ValueError("This method works only for distributed matrices")
        indptr = self.global_components()[0]
        return DNDarray(
            indptr, (self.__gshape[0] + 1,), types.canonical_heat_type(indptr.dtype),
            None, self.__device, self.__comm,
        )

    def counts_displs_nnz(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-rank nnz counts and displacements by row block (reference
        :276): one all-gather of the local counts across ranks."""
        if self.__split is None:
            raise ValueError("Non-distributed DCSR_matrix. Cannot calculate counts and displacements.")
        if not self.is_distributed():
            return (self.lnnz,), (0,)
        t = torch.tensor([self.lnnz], dtype=torch.int64, device=self.__indices.device)
        counts = tuple(int(c) for c in self.__comm.allgather(t).tolist())
        return counts, tuple(int(d) for d in np.concatenate([[0], np.cumsum(counts)[:-1]]))

    def astype(self, dtype, copy: bool = True) -> "DCSR_matrix":
        """Cast values to ``dtype`` (reference :292)."""
        dtype = types.canonical_heat_type(dtype)
        data = self.__data.to(dtype.torch_type())
        if not copy:
            self.__data = data
            self.__dtype = dtype
            self.__global = None
            return self
        return DCSR_matrix(
            self.__indptr, self.__indices, data, self.__gnnz, self.__gshape,
            dtype, self.__split, self.__device, self.__comm, self.__balanced, self.__row_counts,
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
