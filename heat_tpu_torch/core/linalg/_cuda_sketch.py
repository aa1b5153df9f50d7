"""Fused sketch streams of the hSVD: hand-written CUDA kernels and their
plain PyTorch versions.

``sketch_with_norm`` (kernel K1, ``csrc/sketch.cu``) computes ``w = g @ a``
and ``‖a‖²_F`` from one read of ``a``; it replaces the Pallas TPU kernel
``heat_tpu/core/linalg/_pallas_sketch.py::_fused_call``.
``dual_sketch_with_norm`` (kernel K2) adds the column sketch
``y = a @ omega`` to the same read; it replaces ``_pallas_sketch.py::
_dual_call``. Which of K2's two kernels a call takes is decided up front
(``dual_sketch_sm90_serviceable``): n % 4 == 0 with ``a`` on 16 bytes
takes the Hopper kernel ``csrc/sketch_sm90.cu`` (3xTF32 ``wgmma``,
TMA-fed, warp-specialised); other shapes take ``csrc/sketch.cu``'s FP32
kernel, as K1 always does. The sources note what bounds each kernel on an
H100 and how the design meets it.

Each wrapper runs its plain version only when the tensors lie on the CPU.
A CUDA tensor launches a kernel or raises; there is no fallback from one
kernel to another or to the plain version. Each launch adds one to
``SKETCH_LAUNCHES`` / ``DUAL_LAUNCHES``, and a launch of K2's Hopper
kernel also to ``DUAL_SM90_LAUNCHES``.

The plain versions (``*_plain``) compute the same function with torch ops in
the tile order of ``svdtools._pass1_tiles`` / ``_pass2_tiles`` /
``_oneview_tiles``. They are the oracle; the CPU tests and ``chip_smoke.py``
use them.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "DUAL_LAUNCHES",
    "DUAL_SM90_LAUNCHES",
    "SKETCH_LAUNCHES",
    "dual_sketch_serviceable",
    "dual_sketch_sm90_serviceable",
    "dual_sketch_with_norm",
    "dual_sketch_with_norm_plain",
    "sketch_serviceable",
    "sketch_with_norm",
    "sketch_with_norm_plain",
]

#: launches of K1 / K2 (either kernel) since the count was last set to 0
SKETCH_LAUNCHES = 0
DUAL_LAUNCHES = 0
#: launches of K2's Hopper kernel (``csrc/sketch_sm90.cu``) since the count was last set to 0
DUAL_SM90_LAUNCHES = 0

# Hopper bounds, in place of the TPU's VMEM bound: each thread keeps the
# l row-sketch accumulators of its column in registers beside its share of
# the A tile, which caps l at 32 (K1) and 64 (K2) for two 256-thread blocks
# per SM; K2's omega slice (256 columns x k̂) lives in shared memory, k̂ ≤ 32.
SKETCH_MAX_L = 32
DUAL_MAX_L = 64
DUAL_MAX_K = 32

# blocks to aim for per SM (two resident, two waves)
_BLOCKS_PER_SM = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


# --------------------------------------------------------------------- #
# plain versions                                                        #
# --------------------------------------------------------------------- #
def sketch_with_norm_plain(g: torch.Tensor, a: torch.Tensor):
    """``(g @ a, ‖a‖²_F)`` with torch ops: ``w`` in the 512-column tiles of
    ``svdtools._pass1_tiles``, the norm as the running carry over the
    512-row tiles of ``svdtools._pass2_tiles``."""
    from .svdtools import _PASS_TILE, _pass1_tiles, _real_zero, _sumsq

    norm = _real_zero(a)
    for k in range(0, a.shape[0], _PASS_TILE):
        norm = norm + _sumsq(a[k : k + _PASS_TILE])
    return _pass1_tiles(g, a), norm


def dual_sketch_with_norm_plain(g: torch.Tensor, omega: torch.Tensor, a: torch.Tensor):
    """``(g @ a, a @ omega, ‖a‖²_F)`` with torch ops: the one-view stream
    ``svdtools._oneview_tiles`` from zero carries."""
    from .svdtools import _oneview_tiles, _real_zero

    y0 = torch.zeros((a.shape[0], omega.shape[1]), dtype=a.dtype, device=a.device)
    return _oneview_tiles(g, omega, a, y0, _real_zero(a))


# --------------------------------------------------------------------- #
# dispatch predicates                                                   #
# --------------------------------------------------------------------- #
def _kernel_operand(a: torch.Tensor) -> bool:
    return a.is_cuda and a.dtype == torch.float32 and a.ndim == 2 and a.numel() > 0


def sketch_serviceable(l: int, a: torch.Tensor) -> bool:
    """Whether ``sketch_with_norm`` runs kernel K1 for a row sketch of
    ``l`` rows over ``a``: a non-empty float32 matrix on CUDA, l ≤ 32."""
    return _kernel_operand(a) and 1 <= l <= SKETCH_MAX_L


def dual_sketch_serviceable(l_total: int, k_hat: int, a: torch.Tensor) -> bool:
    """Whether ``dual_sketch_with_norm`` runs kernel K2: a non-empty
    float32 matrix on CUDA, ℓ ≤ 64 row-sketch rows, k̂ ≤ 32 columns. Ragged
    m and n are masked inside the kernel, so there is no divisibility gate."""
    return (
        _kernel_operand(a) and 1 <= l_total <= DUAL_MAX_L and 1 <= k_hat <= DUAL_MAX_K
    )


def dual_sketch_sm90_serviceable(l_total: int, k_hat: int, a: torch.Tensor) -> bool:
    """Whether ``dual_sketch_with_norm`` takes K2's Hopper kernel
    (``csrc/sketch_sm90.cu``): what ``dual_sketch_serviceable`` admits,
    with n a multiple of 4 and ``a`` on 16 bytes (the rules of TMA's tensor
    maps). Other shapes take ``csrc/sketch.cu``'s kernel."""
    return dual_sketch_serviceable(l_total, k_hat, a) and a.shape[1] % 4 == 0 and a.data_ptr() % 16 == 0


# --------------------------------------------------------------------- #
# kernel wrappers                                                       #
# --------------------------------------------------------------------- #
_LIB = None
_LIB_SM90 = None


def _lib():
    global _LIB
    if _LIB is None:
        from ...kernels import _build

        lib = _build.load("sketch")
        lib.heat_sketch_with_norm_f32.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _LL, _LL, _I, _LL, _I, _P
        ]
        lib.heat_sketch_with_norm_f32.restype = _I
        lib.heat_dual_sketch_with_norm_f32.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _LL, _I, _P
        ]
        lib.heat_dual_sketch_with_norm_f32.restype = _I
        lib.heat_sketch_error_string.argtypes = [_I]
        lib.heat_sketch_error_string.restype = ctypes.c_char_p
        lib.heat_sketch_block_cols.restype = _I
        lib.heat_sketch_tile_rows.restype = _I
        _LIB = lib
    return _LIB


def _lib_sm90():
    global _LIB_SM90
    if _LIB_SM90 is None:
        from ...kernels import _build

        lib = _build.load("sketch_sm90")
        lib.heat_dual_sketch_sm90.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _LL, _I, _P
        ]
        lib.heat_dual_sketch_sm90.restype = _I
        lib.heat_sketch_error_string.argtypes = [_I]
        lib.heat_sketch_error_string.restype = ctypes.c_char_p
        for f in ("heat_dual_sketch_sm90_block_cols", "heat_dual_sketch_sm90_band_rows"):
            getattr(lib, f).restype = _I
        lib.heat_dual_sketch_sm90_k_rows.argtypes = [_I]
        lib.heat_dual_sketch_sm90_k_rows.restype = _I
        _LIB_SM90 = lib
    return _LIB_SM90


def _check_operand(name: str, x: torch.Tensor, device: torch.device, ndim: int = 2) -> None:
    if x.device != device:
        raise ValueError(f"{name} lies on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA sketch kernels take float32, {name} is {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")


def _check_a(a: torch.Tensor) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA sketch kernels need CUDA tensors, got {a.device}")
    _check_operand("a", a, a.device)
    if a.numel() == 0:
        raise ValueError(f"a must be non-empty, got shape {tuple(a.shape)}")


def _geometry(lib, a: torch.Tensor):
    """(column blocks, row splits, rows per split) for the grid."""
    m, n = a.shape
    bn, tm = lib.heat_sketch_block_cols(), lib.heat_sketch_tile_rows()
    cblocks = -(-n // bn)
    tiles = -(-m // tm)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits = max(1, min(tiles, -(-_BLOCKS_PER_SM * sms // cblocks)))
    rows = -(-tiles // splits) * tm
    return cblocks, -(-m // rows), rows


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.heat_sketch_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def sketch_with_norm(g: torch.Tensor, a: torch.Tensor):
    """``(g @ a, ‖a‖²_F)`` in one read of ``a`` (kernel K1 on CUDA).

    ``g``: (l, m) with l ≤ 32, ``a``: (m, n), both float32 and contiguous on
    one CUDA device. Returns ``w`` (l, n) and the norm as a 0-d tensor. CPU
    tensors take the plain version."""
    global SKETCH_LAUNCHES
    if a.device.type == "cpu" and g.device.type == "cpu":
        return sketch_with_norm_plain(g, a)
    _check_a(a)
    _check_operand("g", g, a.device)
    l, m = g.shape
    n = a.shape[1]
    if m != a.shape[0] or not 1 <= l <= SKETCH_MAX_L:
        raise ValueError(f"g must be (l ≤ {SKETCH_MAX_L}, {a.shape[0]}), got {tuple(g.shape)}")
    lib = _lib()
    cblocks, splits, rows = _geometry(lib, a)
    w = torch.empty((l, n), dtype=torch.float32, device=a.device)
    norm = torch.empty((), dtype=torch.float32, device=a.device)
    wpart = torch.empty((splits, l, n), dtype=torch.float32, device=a.device)
    npart = torch.empty((splits * cblocks,), dtype=torch.float64, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.heat_sketch_with_norm_f32(
        g.data_ptr(), a.data_ptr(), w.data_ptr(), norm.data_ptr(), wpart.data_ptr(),
        npart.data_ptr(), l, m, n, splits, rows, a.device.index, stream,
    )
    _raise_on(lib, rc, "sketch_with_norm")
    SKETCH_LAUNCHES += 1
    return w, norm


def _geometry_sm90(lib, a: torch.Tensor):
    """(column blocks, row splits, rows per split) for the Hopper kernel's
    grid: blocks of 512 columns, and as many row splits as fill the card's
    SMs in one wave (one block an SM), each a whole number of 64-row bands."""
    m, n = a.shape
    bc, band = lib.heat_dual_sketch_sm90_block_cols(), lib.heat_dual_sketch_sm90_band_rows()
    cblocks = -(-n // bc)
    bands = -(-m // band)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits = max(1, min(bands, sms // cblocks))
    rows = -(-bands // splits) * band
    return cblocks, -(-m // rows), rows


def dual_sketch_with_norm(g: torch.Tensor, omega: torch.Tensor, a: torch.Tensor):
    """``(g @ a, a @ omega, ‖a‖²_F)`` in one read of ``a`` (kernel K2 on
    CUDA).

    ``g``: (ℓ, m) with ℓ ≤ 64, ``omega``: (n, k̂) with k̂ ≤ 32, ``a``: (m, n),
    all float32 and contiguous on one CUDA device. n % 4 == 0 with ``a`` on
    16 bytes takes the Hopper kernel (``csrc/sketch_sm90.cu``, 3xTF32 on the
    tensor cores), other shapes ``csrc/sketch.cu``'s FP32 kernel. A rerun
    gives the same bits. CPU tensors take the plain version."""
    return _dual_sketch_with_norm(g, omega, a, sm90=True)


def _dual_sketch_with_norm_sketch_cu(g: torch.Tensor, omega: torch.Tensor, a: torch.Tensor):
    """``dual_sketch_with_norm`` with the Hopper kernel shut off: a call on
    CUDA launches ``csrc/sketch.cu``'s FP32 kernel on any shape, so that
    ``chip_smoke.py`` and the ``cuda`` tests can hold the two kernels
    against each other on the same inputs."""
    return _dual_sketch_with_norm(g, omega, a, sm90=False)


def _dual_sketch_with_norm(g: torch.Tensor, omega: torch.Tensor, a: torch.Tensor, sm90: bool):
    global DUAL_LAUNCHES, DUAL_SM90_LAUNCHES
    if a.device.type == "cpu" and g.device.type == "cpu" and omega.device.type == "cpu":
        return dual_sketch_with_norm_plain(g, omega, a)
    _check_a(a)
    _check_operand("g", g, a.device)
    _check_operand("omega", omega, a.device)
    l, m = g.shape
    n, k = omega.shape
    if m != a.shape[0] or not 1 <= l <= DUAL_MAX_L:
        raise ValueError(f"g must be (ℓ ≤ {DUAL_MAX_L}, {a.shape[0]}), got {tuple(g.shape)}")
    if n != a.shape[1] or not 1 <= k <= DUAL_MAX_K:
        raise ValueError(f"omega must be ({a.shape[1]}, k̂ ≤ {DUAL_MAX_K}), got {tuple(omega.shape)}")
    hopper = sm90 and dual_sketch_sm90_serviceable(l, k, a)
    lib = _lib_sm90() if hopper else _lib()
    dev = a.device
    w = torch.empty((l, n), dtype=torch.float32, device=dev)
    y = torch.empty((m, k), dtype=torch.float32, device=dev)
    norm = torch.empty((), dtype=torch.float32, device=dev)
    cblocks, splits, rows = (_geometry_sm90 if hopper else _geometry)(lib, a)
    wpart = torch.empty((splits, l, n), dtype=torch.float32, device=dev)
    ypart = torch.empty((cblocks, m, k), dtype=torch.float32, device=dev)
    npart = torch.empty((splits * cblocks,), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts = (wpart.data_ptr(), ypart.data_ptr(), npart.data_ptr())
    outs = (g.data_ptr(), omega.data_ptr(), a.data_ptr(), w.data_ptr(), y.data_ptr(), norm.data_ptr())
    if hopper:  # and g's and omega's TF32 halves
        gh = torch.empty((2, 64, -(-m // 4) * 4), dtype=torch.int32, device=dev)
        oh = torch.empty((2, lib.heat_dual_sketch_sm90_k_rows(k), -(-n // 8) * 8), dtype=torch.int32, device=dev)
        rc = lib.heat_dual_sketch_sm90(
            *outs, gh.data_ptr(), oh.data_ptr(), *parts, l, k, m, n, splits, rows, dev.index, stream
        )
    else:
        rc = lib.heat_dual_sketch_with_norm_f32(*outs, *parts, l, k, m, n, splits, rows, dev.index, stream)
    _raise_on(lib, rc, "dual_sketch_with_norm (sketch_sm90)" if hopper else "dual_sketch_with_norm")
    DUAL_LAUNCHES += 1
    if hopper:
        DUAL_SM90_LAUNCHES += 1
    return w, y, norm
