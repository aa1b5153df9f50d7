"""Spectral embedding: the brick-sparse Laplacian fed to the Lanczos solver.

Port of ``heat_tpu.graph.spectral``. The symmetrically normalized (or the
simple) graph Laplacian is never densified: each Lanczos step's
matrix-vector product is

    L_sym v  =  v − D^{-1/2} (A (D^{-1/2} v))      (L v = D v − A v)

with ``A @ x`` the sparse engine's ``matmul`` on the DBCSR bricks, so one
brick SpMM (kernel K7 on a card, k = 1) a step; ``heat_tpu`` evaluates the
same product as an einsum and segment sum over its bricks. The degrees
come from one more product, ``A @ 1``. The loop is the port's Lanczos
(``core/linalg/solver.py::_lanczos_operator``), from ``heat_tpu``'s start
vector (``numpy.random.default_rng(0x5BED)``'s normal, normalized on the
host); the (m, m) tridiagonal's eigenproblem runs in float64 NumPy on the
host, and the embedding ``V @ W_k`` stays on the device.

Across ranks a split operand keeps its slab on each rank: a Lanczos step
gathers the vector's chunks (one all-gather), runs K7 once on the rank's
slab and all-reduces its inner products (``_lanczos_steps`` over chunks),
and the embedding is split 0. A replicated operand gives every rank the
whole embedding.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core import _threefry, types
from ..core.dndarray import DNDarray
from ..sparse.dbcsr_matrix import DBCSR_matrix, to_dbcsr

__all__ = ["spectral_embedding"]

_V0_SEED = 0x5BED  # heat_tpu's default_rng seed of the start vector


def spectral_embedding(
    A: Union[DBCSR_matrix, "object"],
    k: int,
    m: Optional[int] = None,
    normalized: bool = True,
) -> Tuple[np.ndarray, DNDarray]:
    """Smallest-``k`` spectral coordinates of a symmetric graph.

    ``A`` is a symmetric adjacency (``DBCSR_matrix`` or anything
    :func:`~heat_tpu_torch.sparse.to_dbcsr` accepts); ``m`` is the Lanczos
    subspace size (default ``min(n, max(2k + 1, 20))``). Returns
    ``(eigenvalues, embedding)``: the ``k`` Ritz values closest to the
    bottom of the Laplacian spectrum (float32) and the (n, k) coordinate
    matrix, split like ``A``. A float32 operand on a card launches K7
    1 + m times (on each rank, on its slab, across ranks).
    """
    from ..core.linalg import solver as _solver

    if not isinstance(A, DBCSR_matrix):
        A = to_dbcsr(A)
    n_rows, n_cols = A.shape
    if n_rows != n_cols:
        raise ValueError(f"adjacency must be square, got {A.shape}")
    n = n_rows
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    m = int(min(n, max(2 * k + 1, 20)) if m is None else m)
    if not k <= m <= n:
        raise ValueError(f"need k <= m <= n, got m={m}")

    Af = A if A.dtype == types.float32 else A.astype(types.float32)
    dev = Af.device.torch_device
    comm = Af.comm
    across = Af.is_distributed()
    r0, r1 = Af._row_block
    counts = comm.lshape_map((n,), 0)[:, 0] if across else None

    def whole(v):
        return comm.allgather(v, 0, counts) if across else v

    # degrees from one product; the Laplacian then never materializes
    deg = (Af @ torch.ones(n, dtype=torch.float32, device=dev)).larray
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if normalized:
        dvec = torch.where(deg > 0, 1.0 / torch.sqrt(torch.clamp_min(deg, 1e-30)), zero)

        def matvec(v):
            return v - (Af @ whole(v * dvec)).larray * dvec  # L_sym v = v - D^-1/2 A D^-1/2 v
    else:
        dvec = deg

        def matvec(v):
            return dvec * v - (Af @ whole(v)).larray  # L v = D v - A v

    rng = np.random.default_rng(_V0_SEED)
    v0 = rng.standard_normal(n).astype(np.float32)
    v0 = torch.from_numpy(v0 / np.linalg.norm(v0)).to(dev)
    if across:
        def inner(x, y, conj=False):
            return comm.allreduce(x @ y)

        chunk = _threefry.Chunk.of((n,), 0, comm)
        V, alpha, beta = _solver._lanczos_steps(matvec, inner, v0[r0:r1].contiguous(), m, n, chunk, comm)
    else:
        V, alpha, beta = _solver._lanczos_operator(matvec, n, m, v0, torch.float32)

    a = alpha.cpu().numpy().astype(np.float64)
    b = beta.cpu().numpy().astype(np.float64)
    T = np.diag(a) + np.diag(b[1:], 1) + np.diag(b[1:], -1)
    evals, evecs = np.linalg.eigh(T)  # ascending: smallest first
    W = torch.from_numpy(evecs[:, :k].astype(np.float32)).to(dev)
    emb = V @ W
    split = 0 if Af.split == 0 else None
    return evals[:k].astype(np.float32), DNDarray(emb, (n, k), types.float32, split, Af.device, Af.comm)
