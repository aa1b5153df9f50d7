"""Pairwise distance computations.

Port of ``heat_tpu.spatial.distance`` (Heat reference:
heat/spatial/distance.py, ``cdist`` :135, ``rbf`` :158, ``manhattan``
:185). ``cdist`` and ``rbf`` come in the direct form (differences, then
squares) and the quadratic-expansion form (‖x‖² + ‖y‖² − 2x·yᵀ, clamped at
0), as in ``heat_tpu``. The direct and Manhattan forms go through
``torch.cdist`` (the direct one with ``donot_use_mm_for_euclid_dist``), so
no (n, m, d) temporary is built: the output is the largest tensor. XLA
fuses that reduction in ``heat_tpu``; eager torch would not.

Operands split across ranks: the output's split follows ``heat_tpu``'s
rule (0 if X is split 0, else 1 if Y is split 0, else None). An operand
split along its feature axis is gathered first. X split 0 against a whole
Y, and a whole X against Y split 0, are local to each rank. X split 0
against Y split 0, or against itself (``Y=None``), brings Y's rows to every
rank: ``ring=False`` gathers them once; ``ring=True`` runs ``heat_tpu``'s
ring (``core/parallel.py`` ``ring_pairwise``): Y's blocks, padded to the
largest shard, pass around the ring with ``ring_exchange``, p − 1 hops for
p ranks. Against itself it is the half ring: p//2 + 1 blocks are computed,
and each of the others is the transpose of a block its owner computed,
one more exchange each. Rank r's row block then holds block (r, c)
computed iff (c − r) mod p < p//2 + 1. The blocks are sliced to each
shard's rows before they are computed, so the pads never reach the output
(``rbf``'s exp(0) = 1 included).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in

__all__ = ["cdist", "manhattan", "rbf"]


def _prepare(X: DNDarray, Y: Optional[DNDarray]):
    """Validate operands and resolve the compute dtype: float64 if either
    operand is float64, else float32 (reference distance.py:35)."""
    sanitize_in(X)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-dimensional, got {X.ndim}")
    promoted = types.float32 if not types.heat_type_is_inexact(X.dtype) else X.dtype
    if Y is not None:
        sanitize_in(Y)
        if Y.ndim != 2:
            raise ValueError(f"Y must be 2-dimensional, got {Y.ndim}")
        if X.shape[1] != Y.shape[1]:
            raise ValueError(
                f"X and Y must have the same feature dimension, got {X.shape[1]} != {Y.shape[1]}"
            )
        if types.heat_type_is_inexact(Y.dtype):
            promoted = types.promote_types(promoted, Y.dtype)
    if promoted is not types.float64:
        promoted = types.float32
    return promoted


# Each form writes one (n, m) tensor and works on it in place, so that the
# output is the only (n, m) buffer a call holds.
def _sq_expanded(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    y2 = torch.sum(y * y, dim=1, keepdim=True).T
    return (x2 + y2).addmm_(x, y.T, alpha=-2.0).clamp_min_(0.0)


def _direct(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.cdist(x, y, compute_mode="donot_use_mm_for_euclid_dist")


_FORMS = {
    "euclidean": lambda x, y: _sq_expanded(x, y).sqrt_(),
    "sqeuclidean": _sq_expanded,
    "euclidean_direct": _direct,
    "sqeuclidean_direct": lambda x, y: _direct(x, y).square_(),
    "manhattan": lambda x, y: torch.cdist(x, y, p=1),
}


def _rows(t: DNDarray, dtype) -> torch.Tensor:
    return t.larray.to(dtype.torch_type())


def _ring(comm, x: torch.Tensor, y: torch.Tensor, counts, form: Callable, symmetric: bool) -> torch.Tensor:
    """This rank's rows of ``form`` against every rank's rows of Y (this
    rank's ``y``, rank q's ``counts[q]`` rows) through the ring, or the half
    ring with the transposed fill when Y is X (``symmetric``)."""
    p, r = comm.size, comm.rank
    starts = [sum(counts[:q]) for q in range(p)]
    width = max(counts)
    out = torch.empty((x.shape[0], sum(counts)), dtype=x.dtype, device=x.device)
    buf = y.new_zeros((width, y.shape[1]))
    buf[: y.shape[0]] = y
    steps = p // 2 + 1 if symmetric else p
    for t in range(steps):
        src = (r + t) % p
        out[:, starts[src] : starts[src] + counts[src]] = form(x, buf[: counts[src]])
        if t < steps - 1:
            buf = comm.ring_exchange(buf, dst=(r - 1) % p, src=(r + 1) % p)
    for s in range(steps, p):
        # rank r lacks column block r + s; rank r + s computed its
        # transpose, and rank r − s lacks the transpose of this rank's
        # block r − s
        give, take = (r - s) % p, (r + s) % p
        send = out.new_zeros((width, width))
        send[: counts[give], : counts[r]] = out[:, starts[give] : starts[give] + counts[give]].T
        got = comm.ring_exchange(send, dst=give, src=take)
        out[:, starts[take] : starts[take] + counts[take]] = got[: counts[r], : counts[take]]
    return out


def _pairwise(X: DNDarray, Y: Optional[DNDarray], form: str, ring: bool, post=None) -> DNDarray:
    """``form`` of X's rows against Y's (X's own with ``Y=None``), then
    ``post`` elementwise, as a DNDarray split by ``heat_tpu``'s rule."""
    dtype = _prepare(X, Y)
    split = 0 if X.split == 0 else (1 if (Y is not None and Y.split == 0) else None)
    comm = X.comm
    fn = _FORMS[form]
    X = X.resplit(None) if X.is_distributed() and X.split != 0 else X
    if Y is not None and Y.is_distributed() and Y.split != 0:
        Y = Y.resplit(None)
    x = _rows(X, dtype)
    lmap = None
    if X.is_distributed():
        other = X if Y is None else Y
        if other.is_distributed():
            counts = [int(c) for c in other.counts_displs()[0]]
            y = x if Y is None else _rows(Y, dtype).to(x.device)
            if ring:
                result = _ring(comm, x, y, counts, fn, symmetric=Y is None)
            else:
                result = fn(x, comm.allgather(y, 0, counts))
        else:
            result = fn(x, _rows(Y, dtype).to(x.device))
        lmap = X.lshape_map
        lmap[:, 1] = result.shape[1]
    elif Y is not None and Y.is_distributed():
        result = fn(x, _rows(Y, dtype).to(x.device))
        lmap = Y.lshape_map[:, ::-1].copy()
        lmap[:, 0] = result.shape[0]
    else:
        result = fn(x, x if Y is None else _rows(Y, dtype).to(x.device))
    if post is not None:
        result = post(result)
    gshape = (X.shape[0], X.shape[0] if Y is None else Y.shape[0])
    return DNDarray(result, gshape, dtype, split, X.device, comm, lmap)


def cdist(
    X: DNDarray,
    Y: Optional[DNDarray] = None,
    quadratic_expansion: bool = False,
    ring: bool = False,
) -> DNDarray:
    """Pairwise Euclidean distances (reference: distance.py:135). ``Y=None``
    means X against itself. ``ring=True`` brings a split Y to the ranks
    through the ring instead of one all-gather (module docstring); the
    values are the same."""
    return _pairwise(X, Y, "euclidean" if quadratic_expansion else "euclidean_direct", ring)


def manhattan(
    X: DNDarray, Y: Optional[DNDarray] = None, expand: bool = False, ring: bool = False
) -> DNDarray:
    """Pairwise L1 distances (reference: distance.py:185). ``expand`` is
    accepted for the reference's signature; both forms compute the same
    sums."""
    return _pairwise(X, Y, "manhattan", ring)


def rbf(
    X: DNDarray,
    Y: Optional[DNDarray] = None,
    sigma: float = 1.0,
    quadratic_expansion: bool = False,
    ring: bool = False,
) -> DNDarray:
    """RBF kernel exp(−d²/(2σ²)) (reference: distance.py:158)."""
    form = "sqeuclidean" if quadratic_expansion else "sqeuclidean_direct"
    return _pairwise(X, Y, form, ring, post=lambda d2: d2.div_(-2.0 * sigma * sigma).exp_())
