"""Fused assignment pass of a Lloyd iteration: a hand-written CUDA kernel
and its plain PyTorch version.

``fused_assign`` (kernel K3, ``csrc/kmeans_assign.cu``) computes, from one
read of ``x``, what a KMeans step needs: the cluster sums
``onehotᵀ · x`` (k, d), the counts (k,) and the inertia (the summed
minimum squared distance), with squared distances from the quadratic
expansion clamped at 0 and first-index argmin labels. It replaces the
Pallas TPU kernel ``heat_tpu/cluster/_pallas.py::_make_kernel`` behind
``fused_assign_program``. The source notes what bounds it on an H100 and
how the design meets it.

The wrapper runs its plain version only when the tensors lie on the CPU.
A CUDA tensor launches the kernel or raises; there is no fallback. Each
launch adds one to ``ASSIGN_LAUNCHES``. Callers choose between the kernel
and the plain version up front with ``assign_serviceable``.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "ASSIGN_LAUNCHES",
    "ASSIGN_MAX_D",
    "ASSIGN_MAX_K",
    "assign_serviceable",
    "fused_assign",
    "fused_assign_plain",
]

#: launches of K3 since the count was last set to 0
ASSIGN_LAUNCHES = 0

# Hopper bounds of the design (csrc/kmeans_assign.cu): each accumulating
# thread holds at most 64 register accumulators, so k ≤ 64; a block's 128
# threads cover the padded tile row [x | pad | 1 | min d²] at one column
# each when k > 32, so d ≤ 124. Shared memory then stays under 102 KB.
ASSIGN_MAX_K = 64
ASSIGN_MAX_D = 124

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def fused_assign_plain(x: torch.Tensor, centers: torch.Tensor):
    """``(sums (k, d), counts (k,), inertia ())`` with torch ops, in the
    dtype of ``x``: the quadratic expansion
    ``‖x‖² + ‖c‖² − 2 x·cᵀ`` clamped at 0, first-index argmin labels,
    one-hot sums and counts, and the summed minimum — the function of
    ``heat_tpu``'s fused assignment kernel and of the jnp Lloyd step."""
    k = centers.shape[0]
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=1, keepdim=True).T
    d2 = torch.clamp_min(x2 + c2 - 2.0 * (x @ centers.T), 0.0)
    labels = torch.argmin(d2, dim=1)
    onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
    sums = onehot.T @ x
    counts = torch.sum(onehot, dim=0)
    inertia = torch.sum(torch.gather(d2, 1, labels[:, None]))
    return sums, counts, inertia


def assign_serviceable(n: int, d: int, k: int, x: torch.Tensor) -> bool:
    """Whether ``fused_assign`` runs kernel K3 for ``n`` rows of width ``d``
    against ``k`` centers: a float32 matrix on CUDA, 1 ≤ k ≤ 64 and
    1 ≤ d ≤ 124. Ragged n is masked inside the kernel."""
    return (
        x.is_cuda
        and x.dtype == torch.float32
        and n >= 1
        and 1 <= d <= ASSIGN_MAX_D
        and 1 <= k <= ASSIGN_MAX_K
    )


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..kernels import _build

        lib = _build.load("kmeans_assign")
        lib.heat_kmeans_assign_grid.argtypes = [_LL, _I, _I, _I, ctypes.POINTER(_I)]
        lib.heat_kmeans_assign_grid.restype = _I
        lib.heat_kmeans_assign_f32.argtypes = [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]
        lib.heat_kmeans_assign_f32.restype = _I
        lib.heat_kmeans_assign_error_string.argtypes = [_I]
        lib.heat_kmeans_assign_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"the CUDA assignment kernel takes float32, {name} is {t.dtype}")
    if t.ndim != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.heat_kmeans_assign_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def fused_assign(x: torch.Tensor, centers: torch.Tensor):
    """Cluster sums, counts and inertia of ``x`` against ``centers`` in one
    read of ``x`` (kernel K3 on CUDA).

    ``x``: (n, d), ``centers``: (k, d), float32 and contiguous on one CUDA
    device, with k ≤ 64 and d ≤ 124. Returns ``sums`` (k, d), ``counts``
    (k,) and ``inertia`` as a 0-d tensor, all float32; a rerun on the same
    inputs gives the same bits. CPU tensors take the plain version."""
    global ASSIGN_LAUNCHES
    if x.device.type == "cpu" and centers.device.type == "cpu":
        return fused_assign_plain(x, centers)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA assignment kernel needs CUDA tensors, got {x.device}")
    dev = x.device
    _check("x", x, dev)
    _check("centers", centers, dev)
    n, d = x.shape
    k = centers.shape[0]
    if centers.shape[1] != d:
        raise ValueError(f"centers must be (k, {d}), got {tuple(centers.shape)}")
    if n < 1 or not 1 <= d <= ASSIGN_MAX_D or not 1 <= k <= ASSIGN_MAX_K:
        raise ValueError(
            f"the CUDA assignment kernel takes n ≥ 1, d ≤ {ASSIGN_MAX_D} and k ≤ {ASSIGN_MAX_K}, "
            f"got n={n}, d={d}, k={k}"
        )
    lib = _lib()
    grid = _I(0)
    _raise_on(lib, lib.heat_kmeans_assign_grid(n, d, k, dev.index, ctypes.byref(grid)), "K3 grid query")
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    inertia = torch.empty((), dtype=torch.float32, device=dev)
    part = torch.empty((grid.value, k * d + 2 * k), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.heat_kmeans_assign_f32(
        x.data_ptr(), centers.data_ptr(), sums.data_ptr(), counts.data_ptr(), inertia.data_ptr(),
        part.data_ptr(), n, d, k, grid.value, dev.index, stream,
    )
    _raise_on(lib, rc, "fused_assign kernel launch")
    ASSIGN_LAUNCHES += 1
    return sums, counts, inertia
