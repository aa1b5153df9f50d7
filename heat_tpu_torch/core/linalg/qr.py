"""Distributed QR decomposition (port of ``heat_tpu.core.linalg.qr``).

Heat reference: heat/core/linalg/qr.py (``qr`` :17, tiled CAQR). A tall
split-0 matrix runs TSQR, as in ``heat_tpu`` (``_tsqr_fn``, qr.py:102):

    local QR of the shard  →  all-gather of the (k, n) R factors
    →  merge QR of the stack  →  Q = Q_local · Q2[rank]

Q comes out split 0 and R replicated. From 16 ranks up, the merge is a
two-level tree (``_tsqr_group_size``): the R factors are gathered within
groups of s ranks, each group merges, the group factors are gathered
across groups and merged once more, so that each rank receives
(s + p/s)·k·n values instead of p·k·n. At a two-tier topology
(``HEAT_TPU_TOPOLOGY``) the groups are the nodes (s = C), from any world
width, so only the node factors cross nodes. Under
``HEAT_TPU_REDIST_OVERLAP=1`` each gather runs as a ring of ``permute``
hops (``kernels.cmatmul.ring_all_gather``), whose stack equals the
all-gather's element for element: Q and R are the same bits.

Each rank's k is min(⌈m/p⌉, n), as on ``heat_tpu``'s padded blocks: a
short or empty last shard contributes its R padded with zero rows, which
leave the merged R unchanged. A split-1 or whole matrix is gathered and
factored on every rank; Q and R take ``heat_tpu``'s splits (qr.py:270-297).
"""

from __future__ import annotations

import collections
import warnings
import numpy as np
import torch

from .. import types
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from .basics import _from_whole, _whole

__all__ = ["qr"]

QR = collections.namedtuple("QR", "Q, R")

#: single-level below this many ranks, two-level tree from it up (``heat_tpu`` qr.py:95)
_TSQR_TWO_LEVEL_MIN_P = 16


def _tsqr_group_size(p: int) -> int:
    """Group width of the two-level merge: the largest divisor of p not
    exceeding √p (1 when p is prime: single-level)."""
    best = 1
    s = 2
    while s * s <= p:
        if p % s == 0:
            best = s
        s += 1
    return best


def _tsqr_grouping(p: int, topo=None) -> int:
    """Level-1 group width ``s`` of the TSQR merge (1: flat): the nodes'
    width at a tiered topology ``(S, C)``, else ``heat_tpu``'s √p divisor
    from 16 ranks up (qr.py:65)."""
    if topo is not None:
        S, C = topo
        if S > 1 and C > 1 and S * C == p:
            return C
    return _tsqr_group_size(p) if p >= _TSQR_TWO_LEVEL_MIN_P else 1


def _stack_qr(comm, r: torch.Tensor, group, ring=None):
    """(Q2, R) of the rows of every member's ``r`` stacked in rank order:
    one all-gather over ``group`` (None for the world), or with ``ring =
    (size, pos, perm)`` the ring of ``kernels.cmatmul.ring_all_gather``."""
    if ring is None:
        rs = comm.allgather(r, 0, group=group)
    else:
        from ...kernels import cmatmul

        with cmatmul.stamp_scope("tsqr"):
            rs = cmatmul.ring_all_gather(r, comm, *ring).reshape(-1, r.shape[-1])
    return torch.linalg.qr(rs, mode="reduced")


def _tsqr_local(comm, a: torch.Tensor, block_rows: int, calc_q: bool, s: int = 1):
    """TSQR of the matrix whose shard on this rank is ``a`` (rank r holds
    rows r·block_rows onwards, at most block_rows of them). ``s`` > 1 runs
    the two-level tree with groups of ``s`` consecutive ranks (s must
    divide the world size). Returns (Q's shard | None, R)."""
    from ...kernels import cmatmul

    p, rank = comm.size, comm.rank
    ring = cmatmul.ring_enabled()
    n = a.shape[1]
    k = min(block_rows, n)
    q1, r1 = torch.linalg.qr(a, mode="reduced")
    if r1.shape[0] < k:  # a short shard: zero R rows, no Q columns
        r1 = torch.cat([r1, r1.new_zeros((k - r1.shape[0], n))])
    kr = q1.shape[1]
    if s <= 1:
        q2, r = _stack_qr(comm, r1, None, (p, rank, cmatmul.grouped_ring_perm(1, p)) if ring else None)
        if not calc_q:
            return None, r
        return q1 @ q2[rank * k : rank * k + kr], r
    if p % s:
        raise ValueError(f"TSQR group width {s} does not divide the world size {p}")
    g, j = divmod(rank, s)
    within, across = comm.subgroups(p // s, s)
    G = p // s
    # level 1: the s members of this group; level 2: every group's factor
    q2, r_g = _stack_qr(comm, r1, within, (s, j, cmatmul.grouped_ring_perm(G, s)) if ring else None)
    k2 = q2.shape[1]
    q3, r = _stack_qr(comm, r_g, across, (G, g, cmatmul.grouped_ring_perm(G, s, across=True)) if ring else None)
    if not calc_q:
        return None, r
    return q1 @ (q2[j * k : j * k + kr] @ q3[g * k2 : (g + 1) * k2]), r


def _topology(comm):
    """``(S, C)`` of the communicator's tiered topology, or None."""
    t = comm.topology
    return (t.n_slices, t.chips_per_slice) if t.tiered else None


def qr(a: DNDarray, tiles_per_proc: int = 1, calc_q: bool = True, overwrite_a: bool = False) -> QR:
    """QR decomposition of a 2-D DNDarray (reference: qr.py:17).

    Returns ``QR(Q, R)`` with Q orthonormal and R upper-triangular
    (``QR(None, R)`` when ``calc_q=False``). A tall (m ≥ n, n ≤ 4096)
    split-0 matrix across ranks runs TSQR; other matrices are factored
    whole. ``tiles_per_proc`` is accepted for API parity and warns when
    it is not 1."""
    sanitize_in(a)
    if a.ndim != 2:
        raise ValueError(f"qr requires a 2-dimensional array, got {a.ndim}")
    if not isinstance(calc_q, bool):
        raise TypeError(f"calc_q must be a bool, got {type(calc_q)}")
    if not isinstance(tiles_per_proc, (int, np.integer)) or isinstance(tiles_per_proc, bool):
        raise TypeError(f"tiles_per_proc must be an int, got {type(tiles_per_proc)}")
    if tiles_per_proc != 1:
        warnings.warn(
            "tiles_per_proc is accepted for reference-API parity but has no effect: TSQR replaces tiled CAQR",
            UserWarning,
            stacklevel=2,
        )
    if not isinstance(overwrite_a, bool):
        raise TypeError(f"overwrite_a must be a bool, got {type(overwrite_a)}")

    dtype = types.float32 if types.heat_type_is_exact(a.dtype) or a.dtype is types.bool else a.dtype
    tt = dtype.torch_type()
    m, n = a.shape
    comm = a.comm

    if a.split == 0 and comm.is_distributed() and m >= n and n <= 4096:
        block = -(-m // comm.size)
        q_loc, r = _tsqr_local(comm, a._balanced_larray().to(tt), block, calc_q,
                               _tsqr_grouping(comm.size, _topology(comm)))
        r_arr = DNDarray(r, tuple(r.shape), dtype, None, a.device, comm)
        if not calc_q:
            return QR(None, r_arr)
        return QR(DNDarray(q_loc, (m, int(q_loc.shape[1])), dtype, 0, a.device, comm), r_arr)

    arr = _whole(a).to(tt)
    r_split = 1 if a.split == 1 else None
    if not calc_q:
        return QR(None, _from_whole(torch.linalg.qr(arr, mode="r")[1], r_split, a))
    q, r = torch.linalg.qr(arr, mode="reduced")
    return QR(_from_whole(q, a.split, a), _from_whole(r, r_split, a))


DNDarray.qr = qr
