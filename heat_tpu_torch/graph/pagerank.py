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

Across ranks (``split=0``, the default) every rank builds on the host only
the rows of the transition matrix that its slab covers, from the columns
of the adjacency with those indices and the out-degrees of every node, and
lands them on its device as its slab. A step is K7 once on the
rank's slab against the whole ``r`` and one all-gather of the new rows;
the dangling mass and the l1 delta are then computed on the whole vectors
on every rank (n floats, far less than the product), so that no
all-reduce is needed and every rank repeats world size 1's bits and
iteration count; the host still reads one scalar a step.

``pagerank_stream`` runs the same fixpoint from an edge list in host
memory, streamed through the card in windows each step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..core import factories, types
from ..core.communication import Communication, sanitize_comm
from ..core.devices import Device, sanitize_device
from ..core.dndarray import DNDarray
from ..sparse.dbcsr_matrix import DBCSR_matrix
from ..sparse.dcsr_matrix import DCSR_matrix
from ..sparse.factories import _to_scipy_csr

__all__ = ["PageRankResult", "pagerank", "pagerank_stream"]


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


def _transition(csr, dtype_np, cols=None):
    """Column-stochastic M = Aᵀ D_out⁻¹ plus the dangling mask; with
    ``cols = (lo, hi)`` only M's rows [lo, hi), from A's columns [lo, hi).

    Rows of A with no out-edges (dangling nodes) have no column in M;
    their rank mass teleports uniformly, handled in the iteration, so M
    keeps the graph's sparsity exactly. Each entry is A[j, i] / outdeg[j]
    in float64, cast to ``dtype_np``, whichever rows are built."""
    import scipy.sparse as sp

    n = csr.shape[0]
    outdeg = np.asarray(csr.sum(axis=1)).ravel()
    dangling = outdeg == 0
    inv = np.where(dangling, 0.0, 1.0 / np.where(dangling, 1.0, outdeg))
    block = csr if cols in (None, (0, n)) else csr[:, cols[0] : cols[1]]
    M = (sp.diags(inv) @ block).T.tocsr().astype(dtype_np)
    return M, dangling.astype(dtype_np), n


def _operator(A, split, device, comm):
    """The host build: the adjacency to scipy, then the rows of the
    transition matrix that this rank's slab covers (every row where it is
    not split across ranks) and their DBCSR landing on the device; the
    whole matrix is never transposed or blocked across ranks. Returns (M,
    the dangling mask of all rows)."""
    from ..sparse.dbcsr_matrix import _band_rows, _from_band

    csr = _adjacency_to_scipy(A)
    if csr.shape[0] != csr.shape[1]:
        raise ValueError(f"adjacency must be square, got {csr.shape}")
    device, comm = sanitize_device(device), sanitize_comm(comm)
    band, dangling, n = _transition(csr, np.float32, _band_rows(csr.shape[0], split, comm))
    M = _from_band(band, (n, n), types.float32, split, device, comm)
    return M, torch.from_numpy(dangling).to(M.device.torch_device)


def _fixpoint(M: DBCSR_matrix, dangling: torch.Tensor, alpha: float, tol: float, max_iter: int):
    """The power iteration on the device; returns (r, iterations, delta)
    with r, whole on every rank, not yet normalized.

    Across ranks a step multiplies the rank's slab by the whole ``r`` and
    all-gathers the new rows (one all-gather); the mass, the delta and the
    test then run on the whole vectors on every rank, in the operations and
    order of world size 1, so that every rank takes the same steps with the
    same bits as one rank does."""
    n = M.shape[0]
    comm = M.comm
    counts = comm.lshape_map((n,), 0)[:, 0] if M.is_distributed() else None
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dangling.device)
    alpha32 = torch.tensor(alpha, dtype=torch.float32, device=r.device)
    delta = float("inf")
    it = 0
    for it in range(1, max_iter + 1):
        mass = torch.dot(dangling, r)  # dangling rank teleports uniformly
        teleport = ((alpha * mass.double() + (1.0 - alpha)) / n).float()
        r_new = (M @ r).larray * alpha32 + teleport
        if counts is not None:
            r_new = comm.allgather(r_new, 0, counts)
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
    Across ranks ``split=0`` gives each rank its rows of the transition
    matrix and of the ranks; ``split=None`` runs the whole iteration on
    every rank.
    """
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    M, dangling = _operator(A, split, device, comm)
    r, it, delta = _fixpoint(M, dangling, alpha, tol, max_iter)
    ranks = factories.array(r / r.sum(), dtype=types.float32, split=split, device=M.device, comm=M.comm)
    return PageRankResult(ranks, it, delta < tol, delta)


def pagerank_stream(edges, n: int, alpha: float = 0.85, tol: float = 1e-8, max_iter: int = 200,
                    slab: Optional[int] = None) -> PageRankResult:
    """PageRank from an edge list in host memory that never lands on the
    card whole (``heat_tpu`` pagerank.py:135).

    ``edges`` is an (E, 2) int32 ``redistribution.staging.HostArray`` (or
    an array, wrapped) of ``(src, dst)`` pairs; a repeated pair counts as
    multiplicity, as in :func:`pagerank`. One streamed pass of row windows
    counts the out-degrees (``bincount`` of each window's sources on the
    card); each power step streams the edges again and sums
    ``r[src] / outdeg[src]`` into ``dst`` (``index_add_``, in float64, then
    rounded to float32 as ``heat_tpu``'s float32 sum is). The staged plan
    is proven to fit the card first. ``r``, the dangling mass and the delta
    stay on the card; the host reads the delta once a step. Every rank
    streams the whole list and holds the same ranks (split None)."""
    from ..core.communication import get_comm
    from ..core.devices import get_device
    from ..redistribution import staging

    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    if not isinstance(edges, staging.HostArray):
        edges = staging.HostArray(np.ascontiguousarray(edges, np.int32))
    if edges.shape[1] != 2:
        raise ValueError(f"edges must be (E, 2) (src, dst), got {edges.shape}")
    n = int(n)
    sched = staging.prove_fits(staging.plan_staged_passes(
        edges.shape, edges.dtype, [{"tag": "outdeg", "axis": 0}, {"tag": "power", "axis": 0}],
        out_bytes=3 * n * 4 + (1 << 20), slab=slab,
    ))
    wins = staging.window_extents(edges.shape, edges.dtype.itemsize, 0, int(sched.staging["slab_bytes"]))
    device = get_device()
    dev = device.torch_device
    outdeg = torch.zeros(n, dtype=torch.float32, device=dev)

    def count(k, win, ext):
        outdeg.add_(torch.bincount(win[:, 0].to(torch.int64), minlength=n).to(torch.float32))

    staging.stream_windows(edges, 0, wins, count, dev)
    dangling = (outdeg == 0).to(torch.float32)
    inv = torch.where(outdeg == 0, 0.0, 1.0 / torch.clamp_min(outdeg, 1e-30))
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    delta = float("inf")
    it = 0
    for it in range(1, max_iter + 1):
        w = (r * inv).double()
        # float64 sums: a card's index_add_ adds in no fixed order, and float32
        # sums would differ a rounding a step, more than tol, so never settle
        acc = torch.zeros(n, dtype=torch.float64, device=dev)

        def power(k, win, ext):
            idx = win.to(torch.int64)
            acc.index_add_(0, idx[:, 1], w[idx[:, 0]])

        staging.stream_windows(edges, 0, wins, power, dev)
        mass = torch.dot(dangling, r)
        r_new = acc.float() * alpha + ((alpha * mass.double() + (1.0 - alpha)) / n).float()
        step = torch.sum(torch.abs(r_new - r))
        r = r_new
        delta = float(step)  # the one host read of the step
        if delta < tol:
            break
    ranks = DNDarray(r / r.sum(), (n,), types.float32, None, device, get_comm())
    return PageRankResult(ranks, it, delta < tol, delta)
