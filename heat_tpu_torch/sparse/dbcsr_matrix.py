"""Block-CSR matrix with fixed (8, 128) bricks, distributed along axis 0.

Port of ``heat_tpu.sparse.dbcsr_matrix``. The stored unit is a full
(8, 128) brick, one float32 tile of the TPU's vector registers there; the
port keeps the brick for parity, and on Hopper a brick is 4 KB that one
warp reads with 16-byte loads (kernels/spmm.py). The dense shape is padded
up to ``(mb*8, nb*128)``, ``mb = ceil(m/8)``, ``nb = ceil(n/128)``, and
block-compressed on the host; pad rows and columns are zero.

``heat_tpu`` lays the bricks out in one slab per device of its mesh. At
world size 1 there is one slab, ``split=0`` and ``split=None`` both give
it, and its components equal bit for bit what
``heat_tpu.sparse.sparse_dbcsr_matrix(csr, split=None)`` builds:

- ``bdata`` (B, 8, 128), ``bcol``/``brow`` (B,) int32, ``bmask`` (B, 8)
  bool, with B = max(1, nbricks): the bricks in BSR order (ascending
  ``brow``, ascending ``bcol`` within a brick row), then pad bricks (zero
  data, all-false mask) at ``brow`` 0;
- ``bmask`` marks which of a brick's 8 rows are rows of the matrix (the
  last brick row is partly padding when m % 8 ≠ 0);
- ``slab_meta`` ((g0, g1, nreal),): the brick-row range of the slab and
  its count of real bricks.

``gnnz`` is the true scalar nnz, ``nbricks`` the stored bricks and
``occupancy = gnnz / (nbricks * 1024)`` the share of brick slots that hold
a nonzero.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core import types
from ..core.communication import Communication, sanitize_comm
from ..core.devices import Device, sanitize_device
from ..core.dndarray import DNDarray
from .dcsr_matrix import DCSR_matrix
from .factories import _host_dtype, _host_numpy, _to_scipy_csr

__all__ = ["DBCSR_matrix", "sparse_dbcsr_matrix", "to_dbcsr", "BRICK_SHAPE"]

#: the stored block: 8 rows x 128 columns
BRICK_SHAPE = (8, 128)


class DBCSR_matrix:
    """Block-CSR matrix with fixed (8, 128) bricks.

    Construct with :func:`sparse_dbcsr_matrix` / :func:`to_dbcsr`. The raw
    constructor takes the slab components of one slab (``slab_meta`` has
    one entry at world size 1) as tensors on one device. The kernels walk
    each brick row's run of real bricks, so a slab whose real bricks are
    not in ascending ``brow`` order is sorted by ``brow``, stably, here;
    the bricks of one row keep their order and pad bricks stay at the
    tail.
    """

    def __init__(
        self,
        bdata: torch.Tensor,
        bcol: torch.Tensor,
        brow: torch.Tensor,
        bmask: torch.Tensor,
        slab_meta: Tuple[Tuple[int, int, int], ...],
        gnnz: int,
        nbricks: int,
        gshape: Tuple[int, int],
        dtype,
        split: Optional[int],
        device: Device,
        comm: Communication,
    ):
        if split not in (None, 0):
            raise ValueError(f"DBCSR_matrix only supports split=0 or None, got {split}")
        slab_meta = tuple(tuple(int(v) for v in t) for t in slab_meta)
        if len(slab_meta) != 1:
            raise ValueError(
                f"a world-size-1 DBCSR_matrix holds one slab, got slab_meta for {len(slab_meta)}; "
                "carry a heat_tpu layout across with interop.dbcsr_from_numpy"
            )
        B = int(bdata.shape[0])
        if tuple(bdata.shape[1:]) != BRICK_SHAPE or bcol.shape != (B,) or brow.shape != (B,) \
                or tuple(bmask.shape) != (B, BRICK_SHAPE[0]):
            raise ValueError(
                f"slab components disagree: bdata {tuple(bdata.shape)}, bcol {tuple(bcol.shape)}, "
                f"brow {tuple(brow.shape)}, bmask {tuple(bmask.shape)}"
            )
        nreal = slab_meta[0][2]
        if not 0 <= nreal <= B:
            raise ValueError(f"slab_meta counts {nreal} real bricks in a slab of {B}")
        if nreal > 1:
            rows = brow[:nreal]
            if bool((rows[1:] < rows[:-1]).any()):
                order = torch.cat([
                    torch.sort(rows, stable=True).indices,
                    torch.arange(nreal, B, device=rows.device),
                ])
                bdata, bcol, brow, bmask = bdata[order], bcol[order], brow[order], bmask[order]
        self.__bdata = bdata
        self.__bcol = bcol
        self.__brow = brow
        self.__bmask = bmask
        self.__rowptr = None
        self.__colorder = None
        self.__slab_meta = slab_meta
        self.__gnnz = int(gnnz)
        self.__nbricks = int(nbricks)
        self.__gshape = (int(gshape[0]), int(gshape[1]))
        self.__dtype = dtype
        self.__split = split
        self.__device = device
        self.__comm = comm

    # ------------------------------------------------------------------ #
    # geometry                                                           #
    # ------------------------------------------------------------------ #
    @property
    def mb(self) -> int:
        """Brick rows: ceil(m / 8)."""
        return -(-max(self.__gshape[0], 1) // BRICK_SHAPE[0])

    @property
    def nb(self) -> int:
        """Brick columns: ceil(n / 128)."""
        return -(-max(self.__gshape[1], 1) // BRICK_SHAPE[1])

    @property
    def slab_bricks(self) -> int:
        """B, the bricks of the slab, pads included."""
        return int(self.__bdata.shape[0])

    @property
    def _phys_components(self):
        """(bdata, bcol, brow, bmask). Pad bricks carry zero data and an
        all-false mask."""
        return self.__bdata, self.__bcol, self.__brow, self.__bmask

    @property
    def _slab_meta(self) -> Tuple[Tuple[int, int, int], ...]:
        """((g0, g1, nreal),): the slab's brick-row range [g0, g1) and its
        count of real (non-pad) bricks."""
        return self.__slab_meta

    @property
    def _brick_rowptr(self) -> torch.Tensor:
        """(mb + 1,) int32: brick row g's real bricks are the slab entries
        ``[rowptr[g], rowptr[g+1])``. Built once from ``brow``, on the
        matrix's device, and cached."""
        if self.__rowptr is None:
            nreal = self.__slab_meta[0][2]
            rows = self.__brow[:nreal].to(torch.int32).contiguous()
            ids = torch.arange(self.mb + 1, dtype=torch.int32, device=rows.device)
            self.__rowptr = torch.searchsorted(rows, ids, out_int32=True)
        return self.__rowptr

    @property
    def _brick_colorder(self):
        """(order (B,) int32, colptr (nb + 1,) int32, longest): every brick
        of the slab, pads included, grouped by ``bcol`` (stably), so that
        brick column c's bricks are ``order[colptr[c] : colptr[c+1]]``, and
        the longest such run. Built once on the matrix's device and cached;
        raises ValueError if a brick's column lies outside [0, nb)."""
        if self.__colorder is None:
            cols, order = torch.sort(self.__bcol.to(torch.int32), stable=True)
            ids = torch.arange(self.nb + 1, dtype=torch.int32, device=cols.device)
            colptr = torch.searchsorted(cols, ids, out_int32=True)
            first, covered, longest = (int(v) for v in torch.stack(
                [cols[0].long(), colptr[-1].long(), (colptr[1:] - colptr[:-1]).max().long()]).tolist())
            if first < 0 or covered != cols.shape[0]:
                raise ValueError(f"brick columns must lie in [0, {self.nb})")
            self.__colorder = (order.to(torch.int32), colptr, longest)
        return self.__colorder

    # ------------------------------------------------------------------ #
    # metadata                                                           #
    # ------------------------------------------------------------------ #
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
        return 2

    @property
    def shape(self) -> Tuple[int, int]:
        return self.__gshape

    @property
    def gshape(self) -> Tuple[int, int]:
        return self.__gshape

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def nnz(self) -> int:
        """True scalar nnz (not brick slots)."""
        return self.__gnnz

    gnnz = nnz

    @property
    def nbricks(self) -> int:
        """Stored bricks."""
        return self.__nbricks

    @property
    def occupancy(self) -> float:
        """Share of stored brick slots that hold a true nonzero."""
        slots = self.__nbricks * BRICK_SHAPE[0] * BRICK_SHAPE[1]
        return self.__gnnz / slots if slots else 0.0

    @property
    def component_nbytes(self) -> int:
        """Bytes of the stored components (brick-padded, not dense)."""
        return sum(a.numel() * a.element_size() for a in self._phys_components)

    def is_distributed(self) -> bool:
        return self.__split is not None and self.__comm.is_distributed()

    # ------------------------------------------------------------------ #
    # ops                                                                #
    # ------------------------------------------------------------------ #
    def __matmul__(self, other):
        """``A @ x``: brick SpMM (kernels/spmm.py via sparse.linalg)."""
        from . import linalg as _slinalg

        return _slinalg.matmul(self, other)

    def astype(self, dtype, copy: bool = True) -> "DBCSR_matrix":
        dtype = types.canonical_heat_type(dtype)
        bdata = self.__bdata.to(dtype.torch_type())
        if not copy:
            self.__bdata = bdata
            self.__dtype = dtype
            return self
        return DBCSR_matrix(
            bdata, self.__bcol, self.__brow, self.__bmask, self.__slab_meta,
            self.__gnnz, self.__nbricks, self.__gshape, dtype, self.__split,
            self.__device, self.__comm,
        )

    # ------------------------------------------------------------------ #
    # conversions                                                        #
    # ------------------------------------------------------------------ #
    def _to_scipy_bsr(self):
        """The matrix as a scipy BSR on the host, in the padded shape
        (mb*8, nb*128). bfloat16 bricks come back as float32 (exact)."""
        bdata, bcol, brow = _bricks_from_slabs(
            _host_numpy(self.__bdata), self.__bcol.cpu().numpy(), self.__brow.cpu().numpy(), self.__slab_meta
        )
        return _scipy_bsr(bdata, bcol, brow, self.mb, self.nb)

    def to_dcsr(self) -> DCSR_matrix:
        """Back to the scalar-entry format (true nonzeros only)."""
        from .factories import _from_components, _values

        csr = self._to_scipy_bsr().tocsr()
        csr.eliminate_zeros()
        m, n = self.__gshape
        csr.resize((m, n))
        csr = csr.tocsr()
        return _from_components(
            csr.indptr.astype(np.int32), csr.indices.astype(np.int32),
            _values(csr.data, self.__dtype, self.__device), (m, n), self.__split, self.__device, self.__comm,
        )

    def todense(self) -> DNDarray:
        from ..core import factories as _factories

        m, n = self.__gshape
        dense = self._to_scipy_bsr().toarray()[:m, :n]
        return _factories.array(dense, dtype=self.__dtype, split=self.__split, device=self.__device, comm=self.__comm)

    to_dense = todense

    def __repr__(self) -> str:
        return (
            f"DBCSR_matrix(shape={self.__gshape}, bricks={self.__nbricks} of "
            f"{BRICK_SHAPE}, nnz={self.__gnnz}, occupancy={self.occupancy:.3f}, "
            f"dtype=ht.{self.__dtype.__name__}, split={self.__split})"
        )


# --------------------------------------------------------------------- #
# host-side layout                                                      #
# --------------------------------------------------------------------- #
def _slab_layout(m: int, mb: int, p: int) -> Tuple[Tuple[int, int], ...]:
    """Per-device brick-row range [g0, g1) of a ``p``-device layout: the
    bricks meeting the device's dense row block [r*c, (r+1)*c), with
    ``heat_tpu``'s chunk ``c`` (m rounded up to a multiple of p, over p)."""
    c = -(-m // p) if p > 1 else max(m, 1)
    out = []
    for r in range(p):
        lo, hi = r * c, min((r + 1) * c, mb * BRICK_SHAPE[0])
        if hi <= lo:
            out.append((mb, mb))
            continue
        out.append((min(lo // BRICK_SHAPE[0], mb), min(-(-hi // BRICK_SHAPE[0]), mb)))
    return tuple(out)


def _bricks_from_slabs(bdata, bcol, brow, slab_meta):
    """The distinct bricks of a slab layout (numpy), in slab order: each
    slab gives the real bricks of the rows it first covers, so a brick row
    that two slabs share is taken from the first (``heat_tpu``'s
    ownership order, ``dbcsr_matrix.py:215-254``)."""
    B = bdata.shape[0] // max(len(slab_meta), 1)
    keep = np.zeros(bdata.shape[0], dtype=bool)
    prev_end = 0
    for r, (g0, g1, nreal) in enumerate(slab_meta):
        lo = r * B
        keep[lo : lo + nreal] = brow[lo : lo + nreal] >= prev_end  # rows below prev_end are upstream's
        prev_end = max(prev_end, g1)
    return bdata[keep], bcol[keep], brow[keep]


def _scipy_bsr(bdata, bcol, brow, mb: int, nb: int):
    """scipy BSR (mb*8, nb*128) of bricks in ascending ``brow`` order."""
    import scipy.sparse as sp

    indptr = np.zeros(mb + 1, dtype=np.int64)
    np.add.at(indptr, brow.astype(np.int64) + 1, 1)
    return sp.bsr_matrix(
        (bdata, bcol, np.cumsum(indptr)), shape=(mb * BRICK_SHAPE[0], nb * BRICK_SHAPE[1]), blocksize=BRICK_SHAPE,
    )


def _from_bricks(bdata_g, bcol_g, brow_g, gnnz: int, gshape, dtype, split, device: Device, comm) -> DBCSR_matrix:
    """The world-size-1 slab of host bricks in BSR order: every brick, then
    one zero pad brick if there is none, the row mask of each brick, on
    ``device``."""
    m, n = int(gshape[0]), int(gshape[1])
    mb = -(-max(m, 1) // BRICK_SHAPE[0])
    ((g0, g1),) = _slab_layout(m, mb, 1)
    nreal = int(bcol_g.shape[0])
    B = max(1, nreal)
    if nreal == 0:
        bdata_g = np.zeros((1, *BRICK_SHAPE), dtype=_host_dtype(dtype))
    bcol = np.zeros(B, dtype=np.int32)
    brow = np.zeros(B, dtype=np.int32)
    bmask = np.zeros((B, BRICK_SHAPE[0]), dtype=bool)
    bcol[:nreal] = bcol_g
    brow[:nreal] = brow_g
    dense_rows = brow[:nreal, None] * BRICK_SHAPE[0] + np.arange(BRICK_SHAPE[0], dtype=np.int32)
    bmask[:nreal] = (dense_rows >= 0) & (dense_rows < max(m, 1))
    dev = device.torch_device
    return DBCSR_matrix(
        torch.from_numpy(np.ascontiguousarray(bdata_g)).to(device=dev, dtype=dtype.torch_type()),
        torch.from_numpy(bcol).to(dev),
        torch.from_numpy(brow).to(dev),
        torch.from_numpy(bmask).to(dev),
        ((g0, g1, nreal),),
        gnnz,
        nreal,
        (m, n),
        dtype,
        split,
        device,
        comm,
    )


# --------------------------------------------------------------------- #
# factories                                                             #
# --------------------------------------------------------------------- #
def sparse_dbcsr_matrix(
    obj,
    dtype=None,
    split: Optional[int] = None,
    device: Optional[Device] = None,
    comm: Optional[Communication] = None,
) -> DBCSR_matrix:
    """Create a DBCSR_matrix from scipy sparse, a dense array-like, a
    DNDarray or a DCSR_matrix. ``split=0`` and ``None`` both give the one
    slab of world size 1; the split is recorded on the matrix."""
    if split is not None and split != 0:
        raise ValueError(f"split must be 0 or None, got {split}")
    device = sanitize_device(device)
    comm = sanitize_comm(comm)

    if isinstance(obj, DCSR_matrix):
        if split is None and obj.split == 0:
            split = 0
        if dtype is None:
            dtype = obj.dtype
    csr = _to_scipy_csr(obj, _host_dtype(dtype) if dtype is not None else None)

    m, n = int(csr.shape[0]), int(csr.shape[1])
    if dtype is None:
        dtype = types.canonical_heat_type(csr.data.dtype if csr.nnz else np.float32)
    dtype = types.canonical_heat_type(dtype)
    gnnz = int(csr.nnz)

    mb = -(-max(m, 1) // BRICK_SHAPE[0])
    nb = -(-max(n, 1) // BRICK_SHAPE[1])
    csr = csr.astype(_host_dtype(dtype)).copy()
    csr.resize((mb * BRICK_SHAPE[0], nb * BRICK_SHAPE[1]))
    bsr = csr.tobsr(blocksize=BRICK_SHAPE)
    bsr.sort_indices()
    brow = np.repeat(np.arange(mb, dtype=np.int32), np.diff(bsr.indptr).astype(np.int64))
    return _from_bricks(np.asarray(bsr.data), bsr.indices.astype(np.int32), brow, gnnz, (m, n), dtype, split,
                        device, comm)


def to_dbcsr(A, split: Optional[int] = None) -> DBCSR_matrix:
    """Convert a DCSR_matrix / DNDarray / array-like to DBCSR, keeping the
    source's split unless ``split`` overrides it."""
    if isinstance(A, (DCSR_matrix, DNDarray)):
        return sparse_dbcsr_matrix(A, split=A.split if split is None else split, device=A.device, comm=A.comm)
    return sparse_dbcsr_matrix(A, split=split)
