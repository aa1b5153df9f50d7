"""PageRank as an SpMV fixpoint on the sparse engine.

Port of ``heat_tpu.graph.pagerank``. The power iteration over the
column-stochastic transition operator

    r  <-  alpha * (M @ r  +  dangling_mass / n)  +  (1 - alpha) / n

with ``M = Aᵀ D_out⁻¹``. The transition matrix is built once on the host
with scipy, as ``heat_tpu`` builds it, and lands on the device as a
``DBCSR_matrix``; each iteration is one brick SpMM (kernel K7 on a card,
k = 1). In the fixpoint ``r``, the dangling mass and the l1 delta stay on
the device, and the host reads one scalar per iteration, the delta that
decides convergence. The float32 arithmetic is ``heat_tpu``'s: the
teleport scalar ``(alpha * mass + (1 - alpha)) / n`` is formed in float64
from the float32 mass and cast to float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..core import factories, types
from ..core.communication import Communication
from ..core.devices import Device
from ..core.dndarray import DNDarray
from ..sparse.dbcsr_matrix import DBCSR_matrix, sparse_dbcsr_matrix
from ..sparse.dcsr_matrix import DCSR_matrix
from ..sparse.factories import _to_scipy_csr

__all__ = ["PageRankResult", "pagerank"]


class PageRankResult(NamedTuple):
    """Outcome of a PageRank fixpoint run."""

    ranks: DNDarray          # (n,), sums to 1
    iterations: int          # SpMV sweeps taken
    converged: bool          # l1 delta fell under tol before max_iter
    delta: float             # final l1 step size


def _adjacency_to_scipy(A):
    """Adjacency (A[i, j] != 0 is an edge i -> j) as host scipy CSR."""
    if isinstance(A, DBCSR_matrix):
        return A._to_scipy_bsr().tocsr()[: A.shape[0], : A.shape[1]]
    return _to_scipy_csr(A)


def _transition(csr, dtype_np):
    """Column-stochastic M = Aᵀ D_out⁻¹ plus the dangling mask.

    Rows of A with no out-edges (dangling nodes) have no column in M;
    their rank mass teleports uniformly, handled in the iteration, so M
    keeps the graph's sparsity exactly."""
    import scipy.sparse as sp

    n = csr.shape[0]
    outdeg = np.asarray(csr.sum(axis=1)).ravel()
    dangling = outdeg == 0
    inv = np.where(dangling, 0.0, 1.0 / np.where(dangling, 1.0, outdeg))
    M = (sp.diags(inv) @ csr).T.tocsr().astype(dtype_np)
    return M, dangling.astype(dtype_np), n


def _operator(A, split, device, comm):
    """The host build: the adjacency to scipy, the transition matrix and
    its DBCSR landing on the device. Returns (M, dangling mask tensor)."""
    csr = _adjacency_to_scipy(A)
    if csr.shape[0] != csr.shape[1]:
        raise ValueError(f"adjacency must be square, got {csr.shape}")
    M_host, dangling, _ = _transition(csr, np.float32)
    M = sparse_dbcsr_matrix(M_host, dtype=types.float32, split=split, device=device, comm=comm)
    return M, torch.from_numpy(dangling).to(M.device.torch_device)


def _fixpoint(M: DBCSR_matrix, dangling: torch.Tensor, alpha: float, tol: float, max_iter: int):
    """The power iteration on the device; returns (r, iterations, delta)
    with r not yet normalized."""
    n = M.shape[0]
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dangling.device)
    alpha32 = torch.tensor(alpha, dtype=torch.float32, device=r.device)
    delta = float("inf")
    it = 0
    for it in range(1, max_iter + 1):
        mass = torch.dot(dangling, r)  # dangling rank teleports uniformly
        teleport = ((alpha * mass.double() + (1.0 - alpha)) / n).float()
        r_new = (M @ r).larray * alpha32 + teleport
        step = torch.sum(torch.abs(r_new - r))
        r = r_new
        delta = float(step)  # the one host read of the iteration
        if delta < tol:
            break
    return r, it, delta


def pagerank(
    A: Union[DBCSR_matrix, DCSR_matrix, DNDarray, "object"],
    alpha: float = 0.85,
    tol: float = 1e-8,
    max_iter: int = 200,
    split: Optional[int] = 0,
    device: Optional[Device] = None,
    comm: Optional[Communication] = None,
) -> PageRankResult:
    """PageRank of a directed graph given its adjacency structure.

    ``A[i, j] != 0`` is an edge ``i -> j`` (weights count as edge
    multiplicity); ``A`` may be a DBCSR_matrix, a DCSR_matrix, a DNDarray,
    a scipy sparse matrix or a dense array-like. The transition matrix is
    built once on the host, lands on ``device`` as a ``DBCSR_matrix``, and
    the fixpoint runs one brick SpMM per iteration. ``alpha`` is the
    damping factor, ``tol`` the l1 convergence threshold on the rank delta.
    """
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    M, dangling = _operator(A, split, device, comm)
    r, it, delta = _fixpoint(M, dangling, alpha, tol, max_iter)
    ranks = factories.array(r / r.sum(), dtype=types.float32, split=split, device=M.device, comm=M.comm)
    return PageRankResult(ranks, it, delta < tol, delta)
