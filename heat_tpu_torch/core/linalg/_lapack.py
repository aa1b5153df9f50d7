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

__all__ = ["safe_svd", "safe_svdvals"]


def safe_svd(a: torch.Tensor, full_matrices: bool = False):
    """``(u, s, vh)`` of ``a``."""
    return torch.linalg.svd(a, full_matrices=full_matrices)


def safe_svdvals(a: torch.Tensor) -> torch.Tensor:
    """Singular values only."""
    return torch.linalg.svdvals(a)
