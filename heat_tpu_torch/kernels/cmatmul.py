"""The rings of the linalg collectives, as point-to-point hops (port of
``heat_tpu.kernels.cmatmul``).

``heat_tpu`` decomposes a gathered or reduced operand into a ring of
``ppermute`` hops and consumes each block as it lands. The port runs the
same rings over the communicator's ``permute`` (one ``batch_isend_irecv``
a hop, counted as a ``collective-permute``):

- ``ring_all_gather``: the ``(size,) + x.shape`` stack of an all-gather in
  ``size − 1`` hops, each landed block placed in its member's slot, so the
  stack equals the all-gather's element for element (the TSQR merge's
  gathers, flat and both levels of the two-level tree, the panel columns
  of the blocked factorizations);
- ``ring_bcast``: the root's block around the ring in ``size − 1`` hops,
  each rank adopting it at its ring distance (the blocked LU's and the
  solves' panel broadcasts), exact for any payload;
- ``ring_matmul_reduce``: ``C = Σ_q A_q B_q`` as a reduce-scatter ring of
  partial block products (each output chunk summed in one fixed order on
  one rank) and a ring gather of the reduced chunks: 2(p − 1) hops, the
  same bits on every rank.

``ring_enabled()`` is True only under ``HEAT_TPU_REDIST_OVERLAP=1``: under
``auto`` the linalg paths keep their barrier collectives on every device,
as ``heat_tpu`` does off the TPU, since a ring can only pay where its hops
run asynchronously beside the compute (ROADMAP.md Queue 1, items 16–17).
The rings run under the profiler scope ``cmatmul_ring_<tag>``
(``stamp_scope``).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

__all__ = [
    "grouped_ring_perm",
    "ring_all_gather",
    "ring_bcast",
    "ring_enabled",
    "ring_matmul_reduce",
    "stamp_scope",
]


def grouped_ring_perm(n_groups: int, group_size: int, across: bool = False) -> List[Tuple[int, int]]:
    """The whole +1 ring permutation of a grouped gather, every rank once a
    source and once a target: within each of ``n_groups`` groups of
    ``group_size`` consecutive ranks, or (``across=True``) across the
    groups among the ranks of one place. ``grouped_ring_perm(1, p)`` is the
    flat ring."""
    if across:
        return [(g * group_size + j, ((g + 1) % n_groups) * group_size + j)
                for g in range(n_groups) for j in range(group_size)]
    return [(g * group_size + j, g * group_size + (j + 1) % group_size)
            for g in range(n_groups) for j in range(group_size)]


def ring_enabled() -> bool:
    """Do the linalg paths run their rings? Only under
    ``HEAT_TPU_REDIST_OVERLAP=1`` (module docstring)."""
    from ..redistribution import planner

    return planner.overlap_mode() == "1"


def stamp_scope(tag: str):
    """The profiler scope ``cmatmul_ring_<tag>`` a ring runs under."""
    return torch.profiler.record_function(f"cmatmul_ring_{tag}")


def ring_all_gather(x: torch.Tensor, comm, size: int, pos: int, perm) -> torch.Tensor:
    """The ``(size,) + x.shape`` stack of every member's ``x`` in member
    order, in ``size − 1`` hops of ``perm`` (the +1 ring of this rank's
    group, global ranks): after d hops a rank holds the block of the member
    d places behind it, and puts it in slot ``(pos − d) mod size``."""
    out = x.new_empty((size,) + tuple(x.shape))
    out[pos] = x
    cur = x.contiguous()
    for d in range(1, size):
        cur = comm.permute(cur, perm)
        out[(pos - d) % size] = cur
    return out


def ring_bcast(x: torch.Tensor, comm, size: int, root: int, perm) -> torch.Tensor:
    """The ``root``'s ``x`` on every rank of the flat ring, in ``size − 1``
    hops: each rank sends what it holds (zeros until the payload reaches
    it) and adopts the block that lands at its ring distance from
    ``root``."""
    if size <= 1:
        return x
    rel = (comm.rank - int(root)) % size
    v = x.contiguous() if rel == 0 else torch.zeros_like(x)
    for d in range(1, size):
        recv = comm.permute(v, perm)
        if rel == d:
            v = recv
    return v


def ring_matmul_reduce(a_loc: torch.Tensor, b_loc: torch.Tensor, comm, p: int,
                       mm: Callable = torch.matmul) -> torch.Tensor:
    """``Σ_q A_q B_q`` of the ranks' contraction blocks ``a_loc`` (m, k_q)
    and ``b_loc`` (k_q, n), replicated as ``(pad(m, p), n)``: at step t rank
    r adds its partial product of row chunk ``(r + 1 − t) mod p`` to the
    accumulator it received, so rank r ends with chunk ``(r + 2) mod p``
    summed once in ring order; a ring gather assembles the chunks."""
    m, n = a_loc.shape[0], b_loc.shape[1]
    mc = -(-m // p)
    if mc * p != m:
        a_loc = torch.cat([a_loc, a_loc.new_zeros((mc * p - m, a_loc.shape[1]))])
    if p <= 1:
        return mm(a_loc, b_loc)
    r = comm.rank
    perm = grouped_ring_perm(1, p)

    def partial(j):
        return mm(a_loc[j * mc : (j + 1) * mc], b_loc)

    acc = partial((r + 1) % p)
    for t in range(1, p):
        acc = comm.permute(acc.contiguous(), perm) + partial((r + 1 - t) % p)
    stacked = ring_all_gather(acc, comm, p, (r + 2) % p, perm)
    return stacked.reshape(mc * p, n)
