"""Local LAPACK-style helpers (port of ``heat_tpu.core.linalg._lapack``).

``heat_tpu``'s ``svd_x32_scope`` (``_lapack.py:28``) works around a TPU
compiler fault for 32-bit SVDs traced in x64 mode. It has no counterpart
here: ``torch.linalg.svd`` runs in the operand's own precision on the CPU
and on the GPU. Likewise ``heat_tpu``'s ``complex_planar.py`` serves
backends without complex numbers; the port uses torch's native complex
types.
"""

from __future__ import annotations

import torch

__all__ = ["accurate_eigh", "accurate_eigvalsh", "accurate_svd", "accurate_svdvals", "safe_svd", "safe_svdvals"]


def safe_svd(a: torch.Tensor, full_matrices: bool = False):
    """``(u, s, vh)`` of ``a``."""
    return torch.linalg.svd(a, full_matrices=full_matrices)


def safe_svdvals(a: torch.Tensor) -> torch.Tensor:
    """Singular values only."""
    return torch.linalg.svdvals(a)


def _driver(a: torch.Tensor):
    # on a card torch's default SVD driver is cuSOLVER's Jacobi (gesvdj),
    # which stops at about 2e-4 of σ_max in float32 (65536 x 1024 on an
    # H100); the QR iteration (gesvd) keeps 1e-5
    return "gesvd" if a.is_cuda else None


def accurate_svd(a: torch.Tensor):
    """``(u, s, vh)`` of ``a`` in reduced form, by the QR iteration on a
    card (the SVD that ``ht.linalg.svd`` hands its small factor)."""
    return torch.linalg.svd(a, full_matrices=False, driver=_driver(a))


def accurate_svdvals(a: torch.Tensor) -> torch.Tensor:
    """Singular values only, as :func:`accurate_svd` computes them."""
    return torch.linalg.svdvals(a, driver=_driver(a))


# on a card torch's symmetric eigensolver takes cuSOLVER's Jacobi (syevj)
# up to this order and syevd above it; in float32 the Jacobi stops at
# 9e-5 (order 266) to 1.9e-4 (order 512) of ‖A‖ (H100), in float64 at 1e-14
_JACOBI_MAX_N = 512
_WIDE = {torch.float32: torch.float64, torch.complex64: torch.complex128}


def accurate_eigh(a: torch.Tensor, UPLO: str = "L"):
    """``torch.linalg.eigh(a, UPLO)``, taken in double precision on a card
    where torch would run its Jacobi solver on a float32 or complex64
    matrix; the results in ``a``'s types."""
    if a.is_cuda and a.dtype in _WIDE and a.shape[-1] <= _JACOBI_MAX_N:
        w, v = torch.linalg.eigh(a.to(_WIDE[a.dtype]), UPLO=UPLO)
        return w.to(a.real.dtype if a.is_complex() else a.dtype), v.to(a.dtype)
    return torch.linalg.eigh(a, UPLO=UPLO)


def accurate_eigvalsh(a: torch.Tensor) -> torch.Tensor:
    """The eigenvalues of :func:`accurate_eigh`."""
    if a.is_cuda and a.dtype in _WIDE and a.shape[-1] <= _JACOBI_MAX_N:
        w = torch.linalg.eigvalsh(a.to(_WIDE[a.dtype]))
        return w.to(a.real.dtype if a.is_complex() else a.dtype)
    return torch.linalg.eigvalsh(a)
