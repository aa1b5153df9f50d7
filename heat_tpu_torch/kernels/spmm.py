"""The brick engine of the DBCSR format: kernels K7 (SpMM) and K8 (SDDMM),
their plain versions, predicates and launch counts (port of
``heat_tpu.kernels.spmm``).

The compute unit is the (8, 128) brick of ``sparse/dbcsr_matrix.py``:

* SpMM ``y = A @ x``: per stored brick t, ``contrib[t] = bdata[t] @
  xb[bcol[t]]``, with ``xb`` the dense operand zero-padded to (nb*128, k)
  and viewed as (nb, 128, k) slabs; each contribution lands on the brick's
  8 output rows ``8*brow[t] + r - r0`` for the rows that ``bmask[t]`` sets,
  ``r0`` the dense row of the output's first row (0 at world size 1, the
  rank's first row across ranks, as ``heat_tpu``'s ``_local_spmm`` places
  a device's rows).
* SDDMM ``C = S ∘ (u @ vᵀ)``: per stored brick, ``out[t] = sdata[t] *
  (ub[brow[t]] @ vb[bcol[t]]ᵀ)``, only the stored tiles computed.

``brick_spmm`` (kernel K7, ``csrc/spmm.cu``) computes all of ``y`` in one
launch: the brick products and the masked row sums, one block per brick
row, with no atomics, so a rerun repeats the bits. It replaces the Pallas
TPU kernel ``heat_tpu/kernels/spmm.py::_brick_spmm_call`` and the XLA
segment-sum after it in ``_local_spmm``. ``brick_sddmm`` (kernel K8)
replaces ``_brick_sddmm_call``. Which of K8's two kernels a call takes is
decided up front (``sddmm_sm90_serviceable``): d % 4 == 0 with u, v and
sdata on 16 bytes takes the Hopper kernel ``csrc/sddmm_sm90.cu`` (3xTF32
``wgmma``, TMA-fed, a persistent grid over the column-ordered bricks);
every other d takes ``csrc/spmm.cu``'s FP32 kernel. The sources note what
bounds each and how its design meets that.

The wrappers run their plain version only when the tensors lie on the
CPU. A CUDA tensor launches a kernel or raises; there is no fallback from
one kernel to another or to the plain version. Each launch adds one to
``SPMM_LAUNCHES`` or ``SDDMM_LAUNCHES``, and a launch of K8's Hopper
kernel also to ``SDDMM_SM90_LAUNCHES``. The
kernels take float32; callers widen bfloat16/float16 to float32 first and
cast back after (``acc_dtype``), and choose between kernel and torch form
up front with ``spmm_serviceable``/``sddmm_serviceable``: float64, integer
and complex operands take the plain version on any device. ``heat_tpu``'s
``HEAT_TPU_SPMM_KERNEL`` gate, its autotune and its telemetry have no
counterpart here, and neither has its k = 1 → 2 pad, which only made two
XLA:CPU paths bit-identical: the kernel takes k = 1 as it is.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "BR",
    "BC",
    "SDDMM_LAUNCHES",
    "SDDMM_SM90_LAUNCHES",
    "SPMM_LAUNCHES",
    "acc_dtype",
    "brick_contrib_plain",
    "brick_sddmm",
    "brick_sddmm_plain",
    "brick_spmm",
    "brick_spmm_plain",
    "sddmm_serviceable",
    "sddmm_sm90_serviceable",
    "spmm_serviceable",
]

BR, BC = 8, 128  # brick rows x columns (sparse.dbcsr_matrix.BRICK_SHAPE)

#: launches of K7 since the count was last set to 0
SPMM_LAUNCHES = 0
#: launches of K8 (either kernel) since the count was last set to 0
SDDMM_LAUNCHES = 0
#: launches of K8's Hopper kernel (``csrc/sddmm_sm90.cu``) since the count was last set to 0
SDDMM_SM90_LAUNCHES = 0

# dtypes whose products the kernels compute (in float32)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# bricks per step of the plain versions, which bounds their gathered
# temporaries (a chunk of SDDMM at d = 64 gathers 1 GB of v rows)
_PLAIN_CHUNK = 1 << 15

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: float32 for bfloat16/float16 data, else the
    dtype itself (``heat_tpu``'s ``_acc_dtype``)."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def spmm_serviceable(a_dtype: torch.dtype, x_dtype: torch.dtype, k: int) -> bool:
    """Whether ``A @ x`` runs K7 on a card: brick and dense operand both
    float32, bfloat16 or float16 (accumulated in float32), and k ≥ 1."""
    return a_dtype in _KERNEL_DTYPES and x_dtype in _KERNEL_DTYPES and k >= 1


def sddmm_serviceable(s_dtype: torch.dtype, u_dtype: torch.dtype, v_dtype: torch.dtype, d: int) -> bool:
    """Whether ``sddmm(S, u, v)`` runs K8 on a card: all three float32,
    bfloat16 or float16 (computed in float32), and d ≥ 1."""
    return all(t in _KERNEL_DTYPES for t in (s_dtype, u_dtype, v_dtype)) and d >= 1


def sddmm_sm90_serviceable(d: int, m: int, ptrs) -> bool:
    """Whether K8 takes its Hopper kernel (``csrc/sddmm_sm90.cu``) for
    float32 operands u (m, d), v and sdata at the data pointers ``ptrs``:
    d a multiple of 4 (TMA's 16-byte row pitch), m ≥ 1 and every pointer
    on 16 bytes. Everything else that ``sddmm_serviceable`` admits takes
    ``csrc/spmm.cu``'s kernel."""
    return d >= 4 and d % 4 == 0 and m >= 1 and all(p % 16 == 0 for p in ptrs)


# --------------------------------------------------------------------- #
# plain versions                                                        #
# --------------------------------------------------------------------- #
def _brick_slabs(x: torch.Tensor, rows: int) -> torch.Tensor:
    """(n, k) → (nblocks, rows, k), zero-padded to nblocks*rows ≥ max(n, 1)."""
    n, k = x.shape
    nblocks = -(-max(n, 1) // rows)
    xp = torch.zeros((nblocks * rows, k), dtype=x.dtype, device=x.device)
    xp[:n] = x
    return xp.reshape(nblocks, rows, k)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product that also serves integer dtypes, which torch.bmm
    does not take on every device."""
    if a.is_floating_point() or a.is_complex():
        return torch.bmm(a, b)
    return (a.unsqueeze(-1) * b.unsqueeze(1)).sum(2, dtype=a.dtype)


def brick_contrib_plain(bdata: torch.Tensor, bcol: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """``contrib[t] = bdata[t] @ xb[bcol[t]]``, (B, 8, k): the function of
    ``heat_tpu``'s ``_brick_spmm_call`` (and ``_contrib_xla``), in the
    dtype of the operands."""
    return _bmm(bdata, xb[bcol.long()])


def brick_spmm_plain(bdata, bcol, brow, bmask, x, m: int, r0: int = 0) -> torch.Tensor:
    """``y = A @ x`` (m, k) with torch ops: the brick products, then each
    brick row r of brick t added into output row ``8*brow[t] + r - r0``
    where ``bmask[t, r]`` is set and the row lies in [0, m) (the function
    of ``heat_tpu``'s ``_local_spmm``: ``r0`` is the dense row of y's first
    row, 0 at world size 1 and a rank's first row across ranks). Computes
    in the dtype of the operands; x (n, k) is read as zero past row n."""
    k = x.shape[1]
    xb = _brick_slabs(x, BC)
    c = max(m, 1)
    y = torch.zeros((c + 1, k), dtype=x.dtype, device=x.device)
    offs = torch.arange(BR, device=x.device)
    for t0 in range(0, bdata.shape[0], _PLAIN_CHUNK):
        sl = slice(t0, t0 + _PLAIN_CHUNK)
        contrib = brick_contrib_plain(bdata[sl], bcol[sl], xb)
        rows = brow[sl].long()[:, None] * BR + offs - r0
        rows = torch.where(bmask[sl] & (rows >= 0) & (rows < c), rows, c)  # excluded rows -> the dropped row c
        y.index_add_(0, rows.reshape(-1), contrib.reshape(-1, k))
    return y[:m]


def brick_sddmm_plain(sdata, brow, bcol, u, v) -> torch.Tensor:
    """``out[t] = sdata[t] * (ub[brow[t]] @ vb[bcol[t]]ᵀ)`` (B, 8, 128)
    with u (m, d) and v (n, d) zero-padded to whole bricks: the function of
    ``heat_tpu``'s ``_sddmm_xla`` and ``_brick_sddmm_call``, in the dtype
    of the operands."""
    ub = _brick_slabs(u, BR)
    vb = _brick_slabs(v, BC)
    out = torch.empty_like(sdata)
    for t0 in range(0, sdata.shape[0], _PLAIN_CHUNK):
        sl = slice(t0, t0 + _PLAIN_CHUNK)
        out[sl] = sdata[sl] * _bmm(ub[brow[sl].long()], vb[bcol[sl].long()].transpose(1, 2))
    return out


# --------------------------------------------------------------------- #
# the kernels' wrappers                                                 #
# --------------------------------------------------------------------- #
_LIB = None
_LIB_SM90 = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("spmm")
        lib.heat_brick_spmm_f32.argtypes = [_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _I, _I, _P]
        lib.heat_brick_spmm_f32.restype = _I
        lib.heat_brick_sddmm_f32.argtypes = [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _I, _I, _P]
        lib.heat_brick_sddmm_f32.restype = _I
        lib.heat_spmm_error_string.argtypes = [_I]
        lib.heat_spmm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _lib_sm90():
    global _LIB_SM90
    if _LIB_SM90 is None:
        from . import _build

        lib = _build.load("sddmm_sm90")
        lib.heat_brick_sddmm_sm90.argtypes = [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _P]
        lib.heat_brick_sddmm_sm90.restype = _I
        lib.heat_spmm_error_string.argtypes = [_I]
        lib.heat_spmm_error_string.restype = ctypes.c_char_p
        _LIB_SM90 = lib
    return _LIB_SM90


def _check(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"the CUDA brick kernels take {name} as {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.heat_spmm_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _cuda_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA brick kernels need CUDA tensors, got {dev}")
    return dev


def brick_spmm(bdata, bcol, brow, bmask, rowptr, x, m: int, g0: int = 0, r0: int = 0) -> torch.Tensor:
    """``y = A @ x`` (m, k) for the slab (bdata, bcol, brow, bmask) of a
    DBCSR matrix (kernel K7 on CUDA).

    The slab's real bricks lie in ascending ``brow`` order, and brick row
    ``g0 + g``'s run is ``[rowptr[g], rowptr[g+1])``
    (``DBCSR_matrix._brick_rowptr``); the kernel visits those runs, the
    plain version every brick by its ``brow``, and pad bricks, whose mask is
    clear, add nothing to either. Output row i is the matrix's dense row
    ``r0 + i``: at world size 1 ``g0 = r0 = 0``, across ranks the slab's
    first brick row and the rank's first row, ``0 <= r0 - 8·g0 < 8``.
    On CUDA: bdata (B, 8, 128) and x (n, k) float32, bcol/brow (B,) and
    rowptr (mb + 1,) int32, bmask (B, 8) bool, all contiguous on one
    device, k ≥ 1, m + r0 ≤ 8·(g0 + mb). x is read as zero past row n. A
    rerun gives the same bits. A slab with no rows to write (m = 0)
    returns without a launch. CPU tensors take the plain version."""
    global SPMM_LAUNCHES
    if bdata.device.type == "cpu" and x.device.type == "cpu":
        return brick_spmm_plain(bdata, bcol, brow, bmask, x, m, r0)
    dev = _cuda_device(bdata, x)
    B = bdata.shape[0]
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D (n, k), got shape {tuple(x.shape)}")
    n, k = x.shape
    mb = rowptr.shape[0] - 1
    off = r0 - BR * g0
    _check("bdata", bdata, dev, torch.float32, (B, BR, BC))
    _check("bcol", bcol, dev, torch.int32, (B,))
    _check("brow", brow, dev, torch.int32, (B,))
    _check("bmask", bmask, dev, torch.bool, (B, BR))
    _check("rowptr", rowptr, dev, torch.int32, (mb + 1,))
    _check("x", x, dev, torch.float32, (n, k))
    if k < 1 or m < 0 or m and not (0 <= off < BR and m <= mb * BR - off):
        raise ValueError(f"K7 takes k ≥ 1, 0 ≤ r0 - 8·g0 < 8 and m + r0 ≤ 8·(g0 + mb), got k={k}, m={m}, "
                         f"mb={mb}, g0={g0}, r0={r0}")
    y = torch.empty((m, k), dtype=torch.float32, device=dev)
    if m == 0:  # a rank whose block holds no rows: its g0 and r0 lie past the matrix
        return y
    lib = _lib()
    if bmask.data_ptr() % 8 or bdata.data_ptr() % 16:
        raise ValueError("bmask rows must be 8-byte aligned and bdata 16-byte aligned")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.heat_brick_spmm_f32(
        bdata.data_ptr(), bcol.data_ptr(), bmask.data_ptr(), rowptr.data_ptr(), x.data_ptr(), y.data_ptr(),
        mb, off, m, n, k, dev.index, stream,
    )
    _raise_on(lib, rc, "brick_spmm kernel launch")
    SPMM_LAUNCHES += 1
    return y


def brick_sddmm(sdata, brow, bcol, corder, colptr, longest: int, u, v) -> torch.Tensor:
    """``out[t] = sdata[t] * (u[8 brow[t] : +8] @ v[128 bcol[t] : +128]ᵀ)``
    (B, 8, 128) for every brick of the slab, u (m, d) and v (n, d) read as
    zero past their last rows (kernel K8 on CUDA).

    The kernels walk the bricks by brick column: ``corder`` lists every
    brick grouped by ``bcol``, column c's run being
    ``corder[colptr[c] : colptr[c+1]]``, and ``longest`` is the longest run
    (``DBCSR_matrix._brick_colorder``); the plain version takes each brick
    by its ``bcol``. On CUDA: sdata (B, 8, 128), u and v float32,
    brow/bcol/corder (B,) and colptr (nb + 1,) int32, all contiguous on one
    device, d ≥ 1. d % 4 == 0 with u, v and sdata on 16 bytes takes the
    Hopper kernel (``csrc/sddmm_sm90.cu``, 3xTF32 on the tensor cores),
    every other d ``csrc/spmm.cu``'s FP32 kernel. A rerun gives the same
    bits. CPU tensors take the plain version."""
    return _brick_sddmm(sdata, brow, bcol, corder, colptr, longest, u, v, sm90=True)


def _brick_sddmm_spmm_cu(sdata, brow, bcol, corder, colptr, longest: int, u, v) -> torch.Tensor:
    """``brick_sddmm`` with the Hopper kernel shut off: a call on CUDA
    launches ``csrc/spmm.cu``'s FP32 kernel on any d, so that
    ``chip_smoke.py`` and the ``cuda`` tests can hold the two kernels
    against each other on the same inputs."""
    return _brick_sddmm(sdata, brow, bcol, corder, colptr, longest, u, v, sm90=False)


def _brick_sddmm(sdata, brow, bcol, corder, colptr, longest: int, u, v, sm90: bool) -> torch.Tensor:
    global SDDMM_LAUNCHES, SDDMM_SM90_LAUNCHES
    if sdata.device.type == "cpu" and u.device.type == "cpu" and v.device.type == "cpu":
        return brick_sddmm_plain(sdata, brow, bcol, u, v)
    dev = _cuda_device(sdata, u, v)
    B = sdata.shape[0]
    if u.ndim != 2 or v.ndim != 2 or u.shape[1] != v.shape[1]:
        raise ValueError(f"u and v must be (m, d) and (n, d), got {tuple(u.shape)} and {tuple(v.shape)}")
    (m, d), n = u.shape, v.shape[0]
    nb = colptr.shape[0] - 1
    _check("sdata", sdata, dev, torch.float32, (B, BR, BC))
    _check("brow", brow, dev, torch.int32, (B,))
    _check("bcol", bcol, dev, torch.int32, (B,))
    _check("corder", corder, dev, torch.int32, (B,))
    _check("colptr", colptr, dev, torch.int32, (nb + 1,))
    _check("u", u, dev, torch.float32, (m, d))
    _check("v", v, dev, torch.float32, (n, d))
    if d < 1 or B < 1 or nb < 1 or not 1 <= longest <= B:
        raise ValueError(f"K8 takes d ≥ 1 and a run of 1 to B bricks, got d={d}, B={B}, longest={longest}")
    hopper = sm90 and sddmm_sm90_serviceable(d, m, (u.data_ptr(), v.data_ptr(), sdata.data_ptr()))
    lib = _lib_sm90() if hopper else _lib()
    out = torch.empty_like(sdata)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if hopper:
        rc = lib.heat_brick_sddmm_sm90(
            sdata.data_ptr(), brow.data_ptr(), bcol.data_ptr(), corder.data_ptr(), u.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, m, n, d, dev.index, stream,
        )
    else:
        rc = lib.heat_brick_sddmm_f32(
            sdata.data_ptr(), brow.data_ptr(), corder.data_ptr(), colptr.data_ptr(), u.data_ptr(), v.data_ptr(),
            out.data_ptr(), nb, longest, m, n, d, dev.index, stream,
        )
    _raise_on(lib, rc, "brick_sddmm kernel (sddmm_sm90) launch" if hopper else "brick_sddmm kernel launch")
    SDDMM_LAUNCHES += 1
    if hopper:
        SDDMM_SM90_LAUNCHES += 1
    return out
