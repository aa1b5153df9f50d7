"""The relayout copies of the packed pivot: kernels K5 (pack) and K6
(unpack), their plain versions and launch counts (port of
``heat_tpu.kernels.relayout``).

* ``pack_rows(x, rows, c_in, c_out, p)``: flat ``(rows·c_in,)`` → grouped
  ``(p, rows·c_out/p)``: every ``c_in``-element row is right-padded with
  zeros to ``c_out`` and each of the ``p`` column blocks is gathered
  contiguous (the send layout of a split-0 → split-1 all-to-all).
  Kernel K5 (``csrc/relayout.cu``) replaces the Pallas TPU kernel
  ``heat_tpu/kernels/relayout.py::_pack_call``.
* ``unpack_rows(x, rows, c_in, c_out, p)``: the inverse, grouped
  ``(p, rows·c_in/p)`` → flat ``(rows·c_out,)`` with the pad tail of
  every row dropped. Kernel K6 replaces ``_unpack_call``.

Each is a permutation plus a zero pad: kernel and plain version agree bit
for bit for every dtype. The wrappers run the plain version only when the
tensor lies on the CPU; a CUDA tensor launches the kernel or raises. Each
launch adds one to ``PACK_LAUNCHES`` or ``UNPACK_LAUNCHES`` (under a lock:
the executor's emulated ranks call from threads). ``heat_tpu``'s
``HEAT_TPU_RELAYOUT_KERNEL`` modes and its autotune have no counterpart.

``lane_fill`` and ``PACK_FILL_THRESHOLD`` are ``heat_tpu``'s lane terms
(the fraction of a TPU vector register's 128 lanes a buffer fills), which
the planner keeps so that it chooses as ``heat_tpu`` does.
"""

from __future__ import annotations

import ctypes
import threading

import torch

__all__ = [
    "LANES",
    "PACK_FILL_THRESHOLD",
    "PACK_LAUNCHES",
    "UNPACK_LAUNCHES",
    "lane_fill",
    "pack_rows",
    "pack_rows_plain",
    "unpack_rows",
    "unpack_rows_plain",
]

#: lanes of a TPU vector register (f32): the minor-dim quantum of the lane
#: cost term (heat_tpu relayout.py:87)
LANES = 128

#: a stage takes the packed form only when its buffer fills less than this
#: fraction of the lanes (heat_tpu relayout.py:91)
PACK_FILL_THRESHOLD = 0.5

#: launches of K5 since the count was last set to 0
PACK_LAUNCHES = 0
#: launches of K6 since the count was last set to 0
UNPACK_LAUNCHES = 0

_count_lock = threading.Lock()
_WORD_BYTES = (1, 2, 4, 8, 16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def lane_fill(minor: int) -> float:
    """Fraction of the 128 lanes a buffer with minor dimension ``minor``
    fills once tiled to the lane quantum (heat_tpu relayout.py:122)."""
    minor = int(minor)
    if minor <= 0:
        return 1.0
    padded = -(-minor // LANES) * LANES
    return minor / padded


def _check_pack(c_in: int, c_out: int, p: int) -> None:
    if c_out % p or c_out < c_in:
        raise ValueError(f"pack_rows: need p | c_out and c_out >= c_in, got {c_in}->{c_out} over p={p}")


def _check_unpack(c_in: int, c_out: int, p: int) -> None:
    if c_in % p or c_out > c_in:
        raise ValueError(f"unpack_rows: need p | c_in and c_out <= c_in, got {c_in}->{c_out} over p={p}")


# --------------------------------------------------------------------- #
# plain versions (heat_tpu's XLA formulations, relayout.py:137 and :145) #
# --------------------------------------------------------------------- #
def pack_rows_plain(x: torch.Tensor, rows: int, c_in: int, c_out: int, p: int) -> torch.Tensor:
    """K5's function with torch ops (pad, view, permute, copy)."""
    _check_pack(c_in, c_out, p)
    cpp = c_out // p
    xb = x.reshape(rows, c_in)
    if c_out != c_in:
        xb = torch.cat([xb, xb.new_zeros((rows, c_out - c_in))], dim=1)
    return xb.reshape(rows, p, cpp).permute(1, 0, 2).reshape(p, rows * cpp)


def unpack_rows_plain(x: torch.Tensor, rows: int, c_in: int, c_out: int, p: int) -> torch.Tensor:
    """K6's function with torch ops."""
    _check_unpack(c_in, c_out, p)
    cpp = c_in // p
    xb = x.reshape(p, rows, cpp).permute(1, 0, 2).reshape(rows, c_in)
    if c_out != c_in:
        xb = xb[:, :c_out]
    return xb.reshape(rows * c_out)


# --------------------------------------------------------------------- #
# the kernels' wrappers                                                 #
# --------------------------------------------------------------------- #
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("relayout")
        for fn in (lib.heat_relayout_pack, lib.heat_relayout_unpack):
            fn.argtypes = [_P, _P, _LL, _LL, _LL, _LL, _I, _I, _P]
            fn.restype = _I
        lib.heat_relayout_error_string.argtypes = [_I]
        lib.heat_relayout_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(name: str, x: torch.Tensor, out: torch.Tensor, rows: int, c_in: int, c_out: int, p: int) -> None:
    """Check ``x`` and ``out`` and run kernel ``name`` ("pack" or
    "unpack") from ``x`` into ``out``; raises on a refused launch."""
    global PACK_LAUNCHES, UNPACK_LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA relayout kernels need CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}_rows: the input must be contiguous")
    es = x.element_size()
    if es not in _WORD_BYTES:
        raise ValueError(f"{name}_rows: elements of {es} bytes are not served")
    if out.numel() == 0:
        return  # nothing to write: no launch
    lib = _lib()
    if x.data_ptr() % es:
        raise ValueError(f"{name}_rows: the input at {x.data_ptr():#x} is not aligned to its {es}-byte elements")
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = lib.heat_relayout_pack if name == "pack" else lib.heat_relayout_unpack
    rc = fn(x.data_ptr(), out.data_ptr(), rows, c_in, c_out, p, es, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"{name}_rows kernel launch failed: CUDA error {rc} ({lib.heat_relayout_error_string(rc).decode()})")
    with _count_lock:
        if name == "pack":
            PACK_LAUNCHES += 1
        else:
            UNPACK_LAUNCHES += 1


def pack_rows(x: torch.Tensor, rows: int, c_in: int, c_out: int, p: int) -> torch.Tensor:
    """Flat ``(rows·c_in,)`` → grouped ``(p, rows·c_out/p)`` (kernel K5 on
    CUDA): every row right-padded with zeros to ``c_out``, the ``p``
    column blocks of ``c_out/p`` columns contiguous. ``p | c_out``,
    ``c_out ≥ c_in``; any dtype, bit for bit. CPU tensors take the plain
    version."""
    _check_pack(c_in, c_out, p)
    if x.numel() != rows * c_in:
        raise ValueError(f"pack_rows: {x.numel()} elements are not {rows} rows of {c_in}")
    if x.device.type == "cpu":
        return pack_rows_plain(x, rows, c_in, c_out, p)
    out = torch.empty((p, rows * (c_out // p)), dtype=x.dtype, device=x.device)
    _launch("pack", x, out, rows, c_in, c_out, p)
    return out


def unpack_rows(x: torch.Tensor, rows: int, c_in: int, c_out: int, p: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows` (kernel K6 on CUDA): grouped
    ``(p, rows·c_in/p)`` → flat ``(rows·c_out,)`` with the pad tail of
    every row dropped (``p | c_in``, ``c_out ≤ c_in``). CPU tensors take
    the plain version."""
    _check_unpack(c_in, c_out, p)
    if x.numel() != rows * c_in:
        raise ValueError(f"unpack_rows: {x.numel()} elements are not {rows} rows of {c_in}")
    if x.device.type == "cpu":
        return unpack_rows_plain(x, rows, c_in, c_out, p)
    out = torch.empty((rows * c_out,), dtype=x.dtype, device=x.device)
    _launch("unpack", x, out, rows, c_in, c_out, p)
    return out
