"""Block-CSR matrix with fixed (8, 128) bricks, distributed along axis 0.

Port of ``heat_tpu.sparse.dbcsr_matrix``. The stored unit is a full
(8, 128) brick, one float32 tile of the TPU's vector registers there; the
port keeps the brick for parity, and on Hopper a brick is 4 KB that one
warp reads with 16-byte loads (kernels/spmm.py). The dense shape is padded
up to ``(mb*8, nb*128)``, ``mb = ceil(m/8)``, ``nb = ceil(n/128)``, and
block-compressed on the host; pad rows and columns are zero.

``heat_tpu`` lays the bricks out in one slab per device of its mesh, and
the port in one slab per rank, by the same rule (``heat_tpu``
dbcsr_matrix.py:13-30): rank r stores the bricks that meet its dense row
block ``[r*c, (r+1)*c)`` of the chunk geometry (ceil-division blocks, ``c =
ceil(m/p)``), which are the brick rows ``[g0, g1)`` of ``_slab_layout``. A
brick row that straddles two ranks' blocks (``r*c`` is not a multiple of 8
in general) is stored by both; ``bmask`` marks the rows of its block, so no
row is counted twice. A slab holds:

- ``bdata`` (B, 8, 128), ``bcol``/``brow`` (B,) int32 (global brick
  columns and rows), ``bmask`` (B, 8) bool, with B = max(1, nreal): the
  slab's bricks in BSR order (ascending ``brow``, ascending ``bcol`` within
  a brick row), then a pad brick (zero data, all-false mask) at ``brow`` 0
  if it has none; ``heat_tpu`` pads every slab to the mesh's largest, the
  port keeps each rank's own count;
- ``slab_meta``: one ``(g0, g1, nreal)`` a rank (one entry for a matrix that
  is not split across ranks): the brick-row range of each slab and its
  count of real bricks.

At world size 1 (and for ``split=None``) there is one slab, and its
components equal bit for bit what ``heat_tpu.sparse.sparse_dbcsr_matrix(csr,
split=None)`` builds; across ranks rank r's equal ``heat_tpu``'s slab r on
a mesh of as many devices, without the pad bricks.

``gnnz`` is the true scalar nnz, ``nbricks`` the distinct stored bricks
(a straddled brick row's bricks counted once) and ``occupancy = gnnz /
(nbricks * 1024)`` the share of brick slots that hold a nonzero; all three
are global.
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
    constructor takes this rank's slab as tensors on one device and
    ``slab_meta`` with one entry a rank (split 0 across ranks) or one entry.
    The kernels walk each brick row's run of real bricks, so a slab whose
    real bricks are not in ascending ``brow`` order is sorted by ``brow``,
    stably, here; the bricks of one row keep their order and pad bricks
    stay at the tail.
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
        across = split == 0 and comm.is_distributed()
        slabs = comm.size if across else 1
        if len(slab_meta) != slabs:
            raise ValueError(
                f"a DBCSR_matrix {'split across' if across else 'whole on'} {comm.size} rank(s) holds {slabs} "
                f"slab(s), got slab_meta for {len(slab_meta)}; carry a heat_tpu layout across with "
                "interop.dbcsr_from_numpy"
            )
        B = int(bdata.shape[0])
        if tuple(bdata.shape[1:]) != BRICK_SHAPE or bcol.shape != (B,) or brow.shape != (B,) \
                or tuple(bmask.shape) != (B, BRICK_SHAPE[0]):
            raise ValueError(
                f"slab components disagree: bdata {tuple(bdata.shape)}, bcol {tuple(bcol.shape)}, "
                f"brow {tuple(brow.shape)}, bmask {tuple(bmask.shape)}"
            )
        self.__me = comm.rank if across else 0
        nreal = slab_meta[self.__me][2]
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
        """B, the bricks of this rank's slab, pads included."""
        return int(self.__bdata.shape[0])

    @property
    def _phys_components(self):
        """(bdata, bcol, brow, bmask) of this rank's slab. Pad bricks carry
        zero data and an all-false mask."""
        return self.__bdata, self.__bcol, self.__brow, self.__bmask

    @property
    def _slab_meta(self) -> Tuple[Tuple[int, int, int], ...]:
        """One (g0, g1, nreal) a slab: its brick-row range [g0, g1) and its
        count of real (non-pad) bricks; rank r's slab is entry r."""
        return self.__slab_meta

    @property
    def _nreal(self) -> int:
        """Real bricks of this rank's slab."""
        return self.__slab_meta[self.__me][2]

    @property
    def _slab_rows(self) -> Tuple[int, int]:
        """(g0, g1): the brick rows of this rank's slab (all of them, (0,
        mb), for a matrix that is not split across ranks)."""
        if self.is_distributed():
            return self.__slab_meta[self.__me][:2]
        return 0, self.mb

    @property
    def _row_block(self) -> Tuple[int, int]:
        """(r0, r1): the dense rows of the matrix this rank holds, its chunk
        of the rows; (0, m) when not split across ranks."""
        if self.is_distributed():
            r0, (rows, _), _ = self.__comm.chunk(self.__gshape, 0)
            return r0, r0 + rows
        return 0, self.__gshape[0]

    @property
    def _brick_rowptr(self) -> torch.Tensor:
        """(g1 - g0 + 1,) int32: brick row g0 + g's real bricks are the slab
        entries ``[rowptr[g], rowptr[g+1])``, for the slab's brick rows
        [g0, g1) (``_slab_rows``). Built once from ``brow``, on the
        matrix's device, and cached."""
        if self.__rowptr is None:
            g0, g1 = self._slab_rows
            rows = self.__brow[: self._nreal].to(torch.int32).contiguous()
            ids = torch.arange(g0, g1 + 1, dtype=torch.int32, device=rows.device)
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
    def lshape(self) -> Tuple[int, int]:
        """(rows of this rank's block, n)."""
        r0, r1 = self._row_block
        return r1 - r0, self.__gshape[1]

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def nnz(self) -> int:
        """True scalar nnz (not brick slots), over every rank."""
        return self.__gnnz

    gnnz = nnz

    @property
    def nbricks(self) -> int:
        """Distinct stored bricks, over every rank."""
        return self.__nbricks

    @property
    def occupancy(self) -> float:
        """Share of stored brick slots that hold a true nonzero."""
        slots = self.__nbricks * BRICK_SHAPE[0] * BRICK_SHAPE[1]
        return self.__gnnz / slots if slots else 0.0

    @property
    def component_nbytes(self) -> int:
        """Bytes of this rank's stored components (brick-padded, not dense)."""
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
        """The whole matrix as a scipy BSR on the host, in the padded shape
        (mb*8, nb*128). Across ranks every rank sends the bricks of the rows
        it first covers (one all-gather of each component), so a straddled
        brick row comes once. bfloat16 bricks come back as float32 (exact)."""
        nreal = self._nreal
        bdata, bcol, brow = self.__bdata[:nreal], self.__bcol[:nreal], self.__brow[:nreal]
        if self.is_distributed():
            prev_end = max([0] + [g1 for g0, g1, _ in self.__slab_meta[: self.__me]])
            keep = brow >= prev_end  # rows below prev_end are an earlier rank's
            bdata, bcol, brow = bdata[keep], bcol[keep], brow[keep]
            counts = _allgather_counts(self.__comm, int(bcol.shape[0]), bcol.device)
            bdata, bcol, brow = (self.__comm.allgather(t.contiguous(), 0, counts) for t in (bdata, bcol, brow))
        return _scipy_bsr(_host_numpy(bdata), bcol.cpu().numpy(), brow.cpu().numpy(), self.mb, self.nb)

    def to_dcsr(self) -> DCSR_matrix:
        """Back to the scalar-entry format (true nonzeros only), split like
        this matrix: each rank converts the rows of its block from its own
        slab, with no collective but the count of the nonzeros."""
        from .factories import _from_local, _values

        g0, g1 = self._slab_rows
        r0, r1 = self._row_block
        nreal = self._nreal
        bsr = _scipy_bsr(
            _host_numpy(self.__bdata[:nreal]), self.__bcol[:nreal].cpu().numpy(),
            self.__brow[:nreal].cpu().numpy() - g0, max(g1 - g0, 0), self.nb,
        )
        lo = max(r0 - g0 * BRICK_SHAPE[0], 0)  # an empty rank's slab starts past its rows
        csr = bsr.tocsr()[lo : lo + r1 - r0]
        csr.eliminate_zeros()
        csr.resize((r1 - r0, self.__gshape[1]))
        csr = csr.tocsr()
        csr.sort_indices()
        return _from_local(
            csr.indptr.astype(np.int32), csr.indices.astype(np.int32),
            _values(csr.data, self.__dtype, self.__device), self.__gshape, self.__split, self.__device, self.__comm,
        )

    def todense(self) -> DNDarray:
        """The dense matrix, split like this one: each rank places the rows
        of its block from its own bricks (those ``bmask`` marks), with no
        collective."""
        m, n = self.__gshape
        r0, r1 = self._row_block
        nreal = self._nreal
        bdata, bcol, brow, bmask = (t[:nreal] for t in self._phys_components)
        dense = torch.zeros((r1 - r0, self.nb * BRICK_SHAPE[1]), dtype=bdata.dtype, device=bdata.device)
        rows = brow.long()[:, None] * BRICK_SHAPE[0] + torch.arange(BRICK_SHAPE[0], device=bdata.device) - r0
        take = bmask & (rows >= 0) & (rows < r1 - r0)
        t, i = torch.nonzero(take, as_tuple=True)
        cols = bcol.long()[t, None] * BRICK_SHAPE[1] + torch.arange(BRICK_SHAPE[1], device=bdata.device)
        dense.index_put_((rows[t, i][:, None], cols), bdata[t, i], accumulate=True)
        return DNDarray(dense[:, :n].contiguous(), (m, n), self.__dtype, self.__split, self.__device, self.__comm)

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
def _allgather_counts(comm, count: int, device) -> list:
    """Every rank's ``count``, in rank order (one all-gather)."""
    return [int(c) for c in comm.allgather(torch.tensor([count], dtype=torch.int64, device=device)).tolist()]


def _block_extent(m: int, p: int) -> int:
    """The rows of a rank's dense block, ``c``: ceil(m / p) over p ranks,
    max(m, 1) for one (``heat_tpu``'s ``pad_extent(m, p) / p``)."""
    return -(-m // p) if p > 1 else max(m, 1)


def _slab_layout(m: int, mb: int, p: int) -> Tuple[Tuple[int, int], ...]:
    """Per-rank brick-row range [g0, g1) of a ``p``-rank layout: the
    bricks meeting the rank's dense row block [r*c, (r+1)*c), c =
    ``_block_extent(m, p)``."""
    c = _block_extent(m, p)
    out = []
    for r in range(p):
        lo, hi = r * c, min((r + 1) * c, mb * BRICK_SHAPE[0])
        if hi <= lo:
            out.append((mb, mb))
            continue
        out.append((min(lo // BRICK_SHAPE[0], mb), min(-(-hi // BRICK_SHAPE[0]), mb)))
    return tuple(out)


def _bricks_from_slabs(bdata, bcol, brow, slab_meta):
    """The distinct bricks of a slab layout (numpy) with slabs of equal
    length (``heat_tpu``'s physical components), in slab order: each slab
    gives the real bricks of the rows it first covers, so a brick row that
    two slabs share is taken from the first (``heat_tpu``'s ownership
    order, ``dbcsr_matrix.py:215-254``)."""
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


def _slab(bdata, bcol, brow, slab_meta, gnnz: int, nbricks: int, gshape, dtype, split, device: Device,
          comm) -> DBCSR_matrix:
    """The DBCSR_matrix of this rank's real bricks (host numpy, BSR order)
    under ``slab_meta``: one zero pad brick where there is none, the mask
    of the rows of the rank's block, on ``device``."""
    m, n = int(gshape[0]), int(gshape[1])
    p = len(slab_meta)
    me = comm.rank if p > 1 else 0
    nreal = int(bcol.shape[0])
    B = max(1, nreal)
    sdata = np.zeros((B, *BRICK_SHAPE), dtype=_host_dtype(dtype))
    scol = np.zeros(B, dtype=np.int32)
    srow = np.zeros(B, dtype=np.int32)
    smask = np.zeros((B, BRICK_SHAPE[0]), dtype=bool)
    sdata[:nreal] = bdata
    scol[:nreal] = bcol
    srow[:nreal] = brow
    c = _block_extent(m, p)
    dense_rows = srow[:nreal, None] * BRICK_SHAPE[0] + np.arange(BRICK_SHAPE[0], dtype=np.int32)
    smask[:nreal] = (dense_rows >= me * c) & (dense_rows < (me + 1) * c)
    dev = device.torch_device
    return DBCSR_matrix(
        torch.from_numpy(sdata).to(device=dev, dtype=dtype.torch_type()),
        torch.from_numpy(scol).to(dev), torch.from_numpy(srow).to(dev), torch.from_numpy(smask).to(dev),
        slab_meta, gnnz, nbricks, (m, n), dtype, split, device, comm,
    )


def _from_bricks(bdata_g, bcol_g, brow_g, gnnz: int, gshape, dtype, split, device: Device, comm) -> DBCSR_matrix:
    """This rank's slab of the whole matrix's host bricks in BSR order: the
    bricks of the slab's brick rows (every brick where the matrix is not
    split across ranks)."""
    m = int(gshape[0])
    mb = -(-max(m, 1) // BRICK_SHAPE[0])
    p = comm.size if split == 0 and comm.is_distributed() else 1
    bindptr = np.zeros(mb + 1, dtype=np.int64)
    np.add.at(bindptr, brow_g.astype(np.int64) + 1, 1)
    bindptr = np.cumsum(bindptr)
    slab_meta = tuple((g0, g1, int(bindptr[g1] - bindptr[g0])) for g0, g1 in _slab_layout(m, mb, p))
    g0, g1, _ = slab_meta[comm.rank if p > 1 else 0]
    s0, s1 = int(bindptr[g0]), int(bindptr[g1])
    return _slab(bdata_g[s0:s1], bcol_g[s0:s1], brow_g[s0:s1], slab_meta, gnnz, int(bcol_g.shape[0]), gshape, dtype,
                 split, device, comm)


def _band_rows(m: int, split, comm) -> Tuple[int, int]:
    """[lo, hi): the dense rows of the brick rows of this rank's slab, the
    rows a slab is built from (every row where the matrix is not split
    across ranks)."""
    mb = -(-max(m, 1) // BRICK_SHAPE[0])
    p = comm.size if split == 0 and comm.is_distributed() else 1
    g0, g1 = _slab_layout(m, mb, p)[comm.rank if p > 1 else 0]
    return min(g0 * BRICK_SHAPE[0], m), min(g1 * BRICK_SHAPE[0], m)


def _from_band(band, gshape, dtype, split, device: Device, comm) -> DBCSR_matrix:
    """This rank's slab from ``band``, the host scipy CSR of the matrix's
    rows ``_band_rows`` (the whole matrix where it is not split across
    ranks): only the band is blocked into bricks. Across ranks one
    all-gather of every rank's brick count, first-covered bricks and
    nonzeros of its block gives ``slab_meta``, ``nbricks`` and ``gnnz``."""
    m, n = int(gshape[0]), int(gshape[1])
    mb = -(-max(m, 1) // BRICK_SHAPE[0])
    nb = -(-max(n, 1) // BRICK_SHAPE[1])
    p = comm.size if split == 0 and comm.is_distributed() else 1
    me = comm.rank if p > 1 else 0
    ranges = _slab_layout(m, mb, p)
    g0, g1 = ranges[me]
    lo = min(g0 * BRICK_SHAPE[0], m)
    c = _block_extent(m, p)
    r0, r1 = (min(max(b - lo, 0), band.shape[0]) for b in (me * c, (me + 1) * c))
    own_nnz = int(band.indptr[r1] - band.indptr[r0])  # nonzeros of the rank's block, counted before blocking
    band = band.astype(_host_dtype(dtype))  # a copy: resize below works in place
    band.resize(((g1 - g0) * BRICK_SHAPE[0], nb * BRICK_SHAPE[1]))
    bsr = band.tobsr(blocksize=BRICK_SHAPE)
    bsr.sort_indices()
    brow = g0 + np.repeat(np.arange(g1 - g0, dtype=np.int32), np.diff(bsr.indptr).astype(np.int64))
    nreal = int(bsr.indices.shape[0])
    first = int(np.count_nonzero(brow >= max([0] + [e for _, e in ranges[:me]])))  # rows an earlier rank has not
    if p > 1:
        counts = comm.allgather(
            torch.tensor([[nreal, first, own_nnz]], dtype=torch.int64, device=device.torch_device)).tolist()
    else:
        counts = [[nreal, first, own_nnz]]
    slab_meta = tuple((a, b, int(t[0])) for (a, b), t in zip(ranges, counts))
    return _slab(np.asarray(bsr.data), bsr.indices, brow, slab_meta, sum(int(t[2]) for t in counts),
                 sum(int(t[1]) for t in counts), (m, n), dtype, split, device, comm)


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
    DNDarray or a DCSR_matrix (one split across ranks is gathered whole
    first). ``split=0`` gives each rank the slab of its row block, and
    the rank blocks only that slab's rows into bricks (one all-gather of
    the slabs' counts); ``None`` gives every rank the whole matrix as one
    slab."""
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
    lo, hi = _band_rows(m, split, comm)
    return _from_band(csr[lo:hi], (m, n), dtype, split, device, comm)


def to_dbcsr(A, split: Optional[int] = None) -> DBCSR_matrix:
    """Convert a DCSR_matrix / DNDarray / array-like to DBCSR, keeping the
    source's split unless ``split`` overrides it."""
    if isinstance(A, (DCSR_matrix, DNDarray)):
        return sparse_dbcsr_matrix(A, split=A.split if split is None else split, device=A.device, comm=A.comm)
    return sparse_dbcsr_matrix(A, split=split)
