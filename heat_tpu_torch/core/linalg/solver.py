"""Iterative solvers (port of ``heat_tpu.core.linalg.solver``; Heat
reference: heat/core/linalg/solver.py, ``cg`` :14, ``lanczos`` :67).

``heat_tpu`` runs each solver as one XLA program with the stop test on the
device. The port iterates in Python, as the Heat reference does: a split A
(split 1 is resplit to 0) keeps each rank's rows, a matrix-vector product
is the rows times the whole vector (one all-gather of the vector's chunks)
and each inner product the local sum and one ``allreduce``, so every rank
reads the same value for a decision. One host read a step decides it
(``factorizations.HOST_READS``): ``cg``'s ``rsold`` test and ``lanczos``'s
breakdown test, which draws the restart direction only on a breakdown.

``ht.linalg.solve`` (:mod:`.factorizations`) is the direct solver of a
dense system; ``cg`` is the iterative one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _threefry, types
from ..dndarray import DNDarray
from ...kernels import threefry
from . import basics
from .basics import _from_whole, _local, _whole
from .factorizations import _host_read, _real_dtype, _shard

__all__ = ["cg", "lanczos"]

_CG_TOL = 1e-10
_LANCZOS_TOL = 1e-10  # breakdown: the new direction's norm below it
_RESTART_SEED = 0x1A2C05  # heat_tpu's jax.random.key(0x1A2C05) of the restart directions


def _whole_inner(x, y, conj=False):
    """x·y (xᴴy with ``conj``) of two whole vectors."""
    return (x.conj() if conj else x) @ y


def _operator(A: DNDarray, tt: torch.dtype, n: int):
    """(matvec, inner, local) of A's rows: across ranks a split A's rows
    (split 0), a vector's chunk in the chunk geometry, ``matvec`` one
    all-gather and ``inner`` (x·y, or xᴴy when ``conj``) one ``allreduce``;
    otherwise the whole A and whole vectors."""
    comm = A.comm
    if comm.is_distributed() and A.split is not None:
        a_loc = _shard(A if A.split == 0 else A.resplit(0), tt)
        counts = comm.lshape_map((n,), 0)[:, 0]

        def matvec(v):
            return a_loc @ comm.allgather(v, 0, counts)

        def inner(x, y, conj=False):
            return comm.allreduce((x.conj() if conj else x) @ y)

        return matvec, inner, lambda v: _local(v, 0).to(tt)
    a_all = _whole(A).to(tt)
    return (lambda v: a_all @ v), _whole_inner, lambda v: _whole(v).to(tt)


def cg(A: DNDarray, b: DNDarray, x0: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Conjugate gradients for a symmetric positive-definite ``A x = b``
    (reference solver.py:14; ``heat_tpu`` solver.py:72): at most n steps,
    stopping once ``rsold = rᵀr`` falls below 1e-10² (in float32 it runs
    all n steps, as ``heat_tpu``'s does). Across ranks each step is one
    all-gather (``A p``) and two ``allreduce``\\ s (``pᵀAp``, ``rᵀr``).
    The result has b's split."""
    if not isinstance(A, DNDarray) or not isinstance(b, DNDarray) or not isinstance(x0, DNDarray):
        raise TypeError(f"A, b, x0 need to be DNDarrays, got {type(A)}, {type(b)}, {type(x0)}")
    if A.ndim != 2:
        raise RuntimeError("A needs to be a 2D matrix")
    if b.ndim != 1:
        raise RuntimeError("b needs to be a 1D vector")
    if x0.ndim != 1:
        raise RuntimeError("c needs to be a 1D vector")
    dtype = types.promote_types(types.promote_types(A.dtype, b.dtype), types.promote_types(x0.dtype, types.float32))
    tt = dtype.torch_type()
    n = int(b.shape[0])
    matvec, inner, vector = _operator(A, tt, n)
    x = vector(x0)
    r = vector(b) - matvec(x)
    p = r
    rsold = inner(r, r)
    eps = torch.tensor(_CG_TOL, dtype=tt, device=x.device) ** 2
    it = 0
    while it < n and _host_read(rsold >= eps):
        ap = matvec(p)
        alpha = rsold / inner(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rsnew = inner(r, r)
        p = r + (rsnew / rsold) * p
        rsold = rsnew
        it += 1
    if A.comm.is_distributed() and A.split is not None:
        result = DNDarray(x, (n,), dtype, 0, b.device, b.comm)
        if b.split != 0:
            result = result.resplit(b.split)
    else:
        result = _from_whole(x, b.split, b)
    if out is not None:
        out.larray = result.larray
        return out
    return result


def _restart(key, i: int, n: int, tt: torch.dtype, chunk, device) -> torch.Tensor:
    """``jax.random.normal(fold_in(key, i), (n,), tt)``'s part ``chunk``: a
    complex type's two parts from ``split`` of the key, over √2."""
    key = _threefry.fold_in(key, i)
    if not tt.is_complex:
        return threefry.draw("normal", key, chunk, tt, device, (0.0, 1.0))
    rt = _real_dtype(tt)
    re, im = (threefry.draw("normal", k, chunk, rt, device, (0.0, 1.0)) for k in _threefry.split(key))
    return torch.complex(re, im) / 2.0 ** 0.5


def _lanczos_steps(matvec, inner, v: torch.Tensor, m: int, n: int, chunk, comm=None):
    """The Lanczos loop from the unit vector ``v``: ``(V, alpha, beta)``,
    V's columns the basis (this rank's rows of it across ranks), alpha and
    beta T's diagonal and off-diagonal (beta[0] unused). Each step applies
    ``matvec``, orthogonalizes the new vector against every column so far
    (masked full reorthogonalization; the projections all-reduced over
    ``comm`` when the vectors are chunks), and on a breakdown (the new
    direction's norm below 1e-10, one host read a step) restarts from
    ``normal(fold_in(key(0x1A2C05), i))``'s part ``chunk``."""
    tt = v.dtype
    V = v.new_zeros((v.shape[0], m))
    V[:, 0] = v
    w = matvec(v)
    a0 = inner(v, w, conj=True)
    w = w - a0 * v
    alpha = torch.zeros(m, dtype=tt, device=v.device)
    beta = torch.zeros(m, dtype=tt, device=v.device)
    alpha[0] = a0
    key = _threefry.seed_key(_RESTART_SEED)
    for i in range(1, m):
        b_i = torch.sqrt(torch.real(inner(w, w, conj=True)))
        if _host_read(b_i < _LANCZOS_TOL):
            vi = _restart(key, i, n, tt, chunk, v.device)
        else:
            vi = w / b_i.to(tt)
        proj = V.conj().T @ vi
        if comm is not None:
            proj = comm.allreduce(proj)
        proj[i:] = 0
        vi = vi - V @ proj
        vi = vi / torch.sqrt(torch.real(inner(vi, vi, conj=True))).to(tt)
        V[:, i] = vi
        w = matvec(vi)
        a_i = inner(vi, w, conj=True)
        w = w - a_i * vi - b_i.to(tt) * V[:, i - 1]
        alpha[i] = a_i
        beta[i] = b_i
    return V, alpha, beta


def _lanczos_operator(matvec, n: int, m: int, v0: torch.Tensor, dtype: torch.dtype):
    """Lanczos on an operator given by its product with a whole vector,
    ``matvec(v) -> A v`` (``heat_tpu``'s ``_lanczos_program(...,
    matvec)``, solver.py:102): ``(V, alpha, beta)`` of ``_lanczos_steps``
    from the unit vector ``v0`` in ``dtype``. ``graph.spectral_embedding``
    passes its brick-sparse Laplacian this way."""
    return _lanczos_steps(matvec, _whole_inner, v0.to(dtype), int(m), int(n), _threefry.Chunk.whole((int(n),)))


def lanczos(
    A: DNDarray,
    m: int,
    v0: Optional[DNDarray] = None,
    V_out: Optional[DNDarray] = None,
    T_out: Optional[DNDarray] = None,
) -> Tuple[DNDarray, DNDarray]:
    """Lanczos tridiagonalization of a symmetric (Hermitian) matrix: ``(V,
    T)`` with ``A ≈ V T Vᴴ`` after m steps (reference solver.py:67;
    ``heat_tpu`` solver.py:174). Each step orthogonalizes the new vector
    against every column so far (masked full reorthogonalization); on a
    breakdown (the new direction's norm below 1e-10) it restarts from
    ``normal(fold_in(key(0x1A2C05), i))``. T is built on the device. Across
    ranks a step is one all-gather of a vector's chunks and four
    ``allreduce``\\ s, V split 0."""
    if not isinstance(A, DNDarray):
        raise TypeError(f"A needs to be a DNDarray, got {type(A)}")
    if not isinstance(m, (int, float)) and not hasattr(m, "__index__"):
        raise TypeError(f"m must be int, got {type(m)}")
    m = int(m)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise RuntimeError("A needs to be a square matrix")
    n = int(A.shape[0])
    dtype = A.dtype if types.heat_type_is_inexact(A.dtype) else types.float32
    tt = dtype.torch_type()
    comm = A.comm
    if v0 is None:
        from .. import random as _random

        vr = _random.rand(n, split=A.split, device=A.device, comm=comm).astype(dtype)
        v0 = vr / basics.norm(vr)
    else:
        if v0.split != A.split:
            v0 = v0.resplit(A.split)
        v0 = v0.astype(dtype)
    across = comm.is_distributed() and A.split is not None
    matvec, inner, vector = _operator(A, tt, n)
    chunk = _threefry.Chunk.of((n,), 0, comm) if across else _threefry.Chunk.whole((n,))
    V, alpha, beta = _lanczos_steps(matvec, inner, vector(v0), m, n, chunk, comm if across else None)
    T_arr = torch.diag(alpha) + torch.diag(beta[1:], 1) + torch.diag(beta[1:], -1)
    if across:
        V_dnd = DNDarray(V, (n, m), dtype, 0, A.device, comm)
    else:
        V_dnd = _from_whole(V, A.split if A.split in (0, None) else 0, A)
    T = DNDarray(T_arr, (m, m), dtype, None, A.device, comm)
    if V_out is not None:
        V_out.larray = V_dnd.larray
        V_dnd = V_out
    if T_out is not None:
        T_out.larray = T.larray
        T = T_out
    return V_dnd, T
