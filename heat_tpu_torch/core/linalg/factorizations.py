"""Dense factorizations across ranks (port of ``heat_tpu.core.linalg.factorizations``).

``heat_tpu`` runs each factorization as one ``shard_map`` program whose
movement is a ring of ``ppermute`` hops (``kernels/cmatmul.py``). The port
keeps its algorithms, block geometry and stop tests and issues the Heat
reference's explicit collectives instead, one a ring:

- :func:`polar`: scaled Newton–Schulz. One all-gather of each rank's
  Frobenius partial (summed in rank order), one ``allreduce`` of the local
  ``XᴴX`` a step, one ``allreduce`` for ``H = UᴴA``: 2 + the iteration
  count. The stop test ``‖XᴴX − I‖_F/√n ≤ tol`` reads the all-reduced Gram,
  the same on every rank, once a step on the host (``HOST_READS``).
- :func:`cholesky` / :func:`lu`: the blocked right-looking program on
  blocks of nb = ⌈n/p⌉ rows, each rank's block padded as ``heat_tpu``
  pads it (zero pad columns, ones on the pad diagonal: the padded matrix is
  diag(A, I)). Lap k all-gathers the nb × nb panel blocks (ranks above the
  panel send zeros), every rank factors the diagonal block alike, solves
  its own L block and updates its trailing columns. LU pivots within the
  panel's block of rows and broadcasts the pivoted U panel row from rank k
  on every lap but the last: p all-gathers (and p − 1 broadcasts).
- the block solves against those factors: one broadcast a lap of the
  forward sweep; Cholesky's backward sweep one all-gather of the partial
  products a lap (summed in stack order), LU's one broadcast: 2(p − 1).
- :func:`eigh`: spectral divide and conquer. The median of the global
  diagonal (one all-gather of n values) shifts A, :func:`polar` gives
  ``S = sign(A − μI)``, the projectors ``(I ∓ S)/2`` split the spectrum (their
  rank is the all-reduced trace, read on the host), TSQR of Gaussian range
  probes (``heat_tpu``'s Threefry draws, kernel R1 on a card) gives each
  side's basis, ``QᴴAQ`` is one ``allreduce``; sub-problems of order ≥
  ``_EIGH_RESPLIT_MIN_N`` recurse split 0.

No operand is gathered: an operand split 1 is resplit to 0 by the planner,
and one with an uneven map is read in the chunk geometry
(``_balanced_larray``, one ``redistribute_``). At world size 1, and for an
operand that is not split, the calls are ``torch.linalg``'s (LAPACK on the
CPU, cuSOLVER on a card). ``_factorization_plan`` keeps ``heat_tpu``'s
pre-declared ring schedules, whose ``plan_id``\\ s equal ``heat_tpu``'s.
A host-resident ``HostArray`` of right-hand sides streams through the card
in column windows (``_solve_host_rhs``). ``solve_endpoint`` (a serving
endpoint) is not ported (ROADMAP.md Queue 1, item 13).
"""

from __future__ import annotations

import collections
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _threefry, types
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from ...kernels import threefry
from . import basics
from ._lapack import accurate_eigh
from .basics import _from_whole, _local, _out, _whole

__all__ = [
    "Eigh",
    "LU",
    "Polar",
    "cholesky",
    "eigh",
    "golden_factorization_plans",
    "lu",
    "polar",
    "solve",
]

Polar = collections.namedtuple("Polar", "U, H")
Eigh = collections.namedtuple("Eigh", "eigenvalues, eigenvectors")
LU = collections.namedtuple("LU", "perm, L, U")

# eigh's recursion resplits sub-operands at or above this order (tests
# shrink it, in both packages alike, to recurse at small sizes)
_EIGH_RESPLIT_MIN_N = 512
_EIGH_MAX_DEPTH = 16

_POLAR_MAXITER = 64

_PROBE_SEED = 0xE16  # heat_tpu's jax.random.key(0xE16) of the range probes

#: host reads of a loop's stop test or a projector's rank since the count
#: was last set to 0 (every rank reads the same replicated value)
HOST_READS = 0
#: Newton–Schulz steps of the last :func:`polar`
POLAR_ITERATIONS = 0


def _host_read(t: torch.Tensor):
    """``t.item()``, counted in ``HOST_READS``."""
    global HOST_READS
    HOST_READS += 1
    return t.item()


def _ct(x: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose of the last two axes."""
    return x.mT.conj().resolve_conj()


def _ct_dnd(a: DNDarray) -> DNDarray:
    """Conjugate transpose of a 2-D DNDarray, the split axis remapped."""
    t = basics.transpose(a)
    lmap = t.lshape_map if t.split is not None else None
    return DNDarray(t.larray.conj().resolve_conj(), t.gshape, t.dtype, t.split, t.device, t.comm, lmap)


def _solver_dtype(a: DNDarray):
    return types.float32 if types.heat_type_is_exact(a.dtype) or a.dtype is types.bool else a.dtype


def _real_dtype(tt: torch.dtype) -> torch.dtype:
    return {torch.complex64: torch.float32, torch.complex128: torch.float64}.get(tt, tt)


def _real_eps(tt: torch.dtype) -> float:
    return float(torch.finfo(_real_dtype(tt)).eps)


def _shard(a: DNDarray, tt: torch.dtype) -> torch.Tensor:
    """This rank's rows of ``a`` (split 0) in the chunk geometry, as ``tt``."""
    return a._balanced_larray().to(tt)


# ---------------------------------------------------------------------- #
# plans: heat_tpu's pre-declared ring schedules                          #
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=256)
def _factorization_plan(kind: str, gshape: Tuple[int, ...], dtype: str, p: int, budget: Optional[int] = None):
    """``heat_tpu``'s :class:`Schedule` of a factorization's ring program
    (factorizations.py:122): ``polar`` 5(p − 1) hops, ``cholesky`` p(p − 1),
    ``lu`` (2p − 1)(p − 1), ``solve-chol``/``solve-lu`` 2(p − 1)². The
    port issues one collective where a ring has p − 1 hops (module
    docstring); the plan is kept for its ``plan_id``."""
    from ...redistribution import planner as _planner
    from ...redistribution.schedule import Schedule, Step
    from ...redistribution.spec import RedistSpec

    if budget is None:
        budget = _planner.budget_bytes()
    spec = RedistSpec.normalize(gshape, dtype, 0, 0, p)
    t = np.dtype(dtype).itemsize
    steps = []

    def hop(payload, detail, chunk):
        steps.append(Step("ppermute", bytes_moved=int(payload), peak_bytes=2 * int(payload), detail=detail,
                          chunk=chunk))

    if kind == "polar":
        m, n = gshape
        mc = -(-n // p)
        rt = np.dtype(dtype).itemsize // (2 if np.dtype(dtype).kind == "c" else 1)
        for d in range(p - 1):
            hop(rt, "frobenius-norm partial ring", d)
        for d in range(p - 1):
            hop(mc * n * t, "newton-schulz gram reduce-scatter ring (while body; HLO census counts once)", d)
        for d in range(p - 1):
            hop(mc * n * t, "newton-schulz gram chunk gather ring (while body)", d)
        for d in range(p - 1):
            hop(mc * n * t, "hermitian factor H=U^H A reduce-scatter ring", d)
        for d in range(p - 1):
            hop(mc * n * t, "hermitian factor H chunk gather ring", d)
        notes = (f"newton-schulz polar ({m}x{n}): every iteration reships the gram ring payload; the schedule "
                 f"prices the static program (while-body collectives once), maxiter={_POLAR_MAXITER}")
    elif kind == "cholesky":
        n = gshape[0]
        nb = -(-n // p)
        for k in range(p):
            for d in range(p - 1):
                hop(nb * nb * t, f"panel column gather ring (lap {k})", k)
        notes = (f"blocked right-looking cholesky ({n}x{n}, nb={nb}): panel column assembled by gather ring, "
                 f"trailing update local MXU under the hops")
    elif kind == "lu":
        n = gshape[0]
        nb = -(-n // p)
        n_pad = nb * p
        for k in range(p):
            for d in range(p - 1):
                hop(nb * nb * t, f"panel column gather ring (lap {k})", k)
        for k in range(p - 1):
            trail = n_pad - (k + 1) * nb
            for d in range(p - 1):
                hop(nb * trail * t, f"pivoted U panel row bcast ring (lap {k})", k)
        notes = (f"blocked right-looking LU ({n}x{n}, nb={nb}): block-local partial pivoting; U panel row "
                 f"broadcast around the ring, trailing update local MXU under the hops")
    elif kind in ("solve-chol", "solve-lu"):
        n, nrhs = gshape
        nb = -(-n // p)
        for k in range(p - 1):
            for d in range(p - 1):
                hop(nb * nrhs * t, f"forward-sweep block ring (lap {k})", k)
        for k in range(p - 1):
            for d in range(p - 1):
                hop(nb * nrhs * t, f"backward-sweep block ring (lap {k})", k)
        notes = (f"block triangular solve ({n}x{n}, nrhs={nrhs}, nb={nb}, {kind.split('-')[1]} factors): "
                 f"broadcast/gather ring per non-terminal lap of each sweep")
    else:
        raise ValueError(f"unknown factorization plan kind {kind!r}")
    return Schedule(spec, f"factorization-{kind}", steps, budget, notes=notes)


def golden_factorization_plans():
    """Named plans at pinned shapes and budget (``heat_tpu``'s fixture of
    the same name): their ``plan_id``\\ s are ``heat_tpu``'s."""
    from ...redistribution import planner as _planner

    b = _planner.DEFAULT_BUDGET_MB << 20
    return [
        ("polar_f32_65536x1024_p8", _factorization_plan("polar", (65536, 1024), "float32", 8, budget=b)),
        ("cholesky_f32_8192_p8", _factorization_plan("cholesky", (8192, 8192), "float32", 8, budget=b)),
        ("lu_f32_8192_p8", _factorization_plan("lu", (8192, 8192), "float32", 8, budget=b)),
        ("solve_chol_f32_8192x256_p8", _factorization_plan("solve-chol", (8192, 256), "float32", 8, budget=b)),
        ("solve_lu_f32_8192x256_p8", _factorization_plan("solve-lu", (8192, 256), "float32", 8, budget=b)),
    ]


# ---------------------------------------------------------------------- #
# Newton–Schulz polar                                                    #
# ---------------------------------------------------------------------- #
def _newton_schulz(x: torch.Tensor, gram, n: int, maxiter: int, tol: float) -> torch.Tensor:
    """``X ← X(1.5 I − 0.5 G)``, ``G = gram(X)``, while fewer than
    ``maxiter`` steps ran and ``‖G − I‖_F/√n > tol``: the error is that of
    the iterate before the update (``heat_tpu``'s one-step lag), in the
    real type, one host read a step."""
    global POLAR_ITERATIONS
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    rt = _real_dtype(x.dtype)
    limit = torch.tensor(tol, dtype=rt, device=x.device)
    it, go = 0, True
    while it < maxiter and go:
        g = gram(x)
        err = (torch.linalg.matrix_norm(g - eye) / math.sqrt(n)).to(rt)
        x = x @ (1.5 * eye - 0.5 * g)
        it += 1
        go = bool(_host_read(err > limit))
    POLAR_ITERATIONS = it
    return x


def _polar_local(a: torch.Tensor, maxiter: int, tol: float):
    """(U, H) of a whole operand (``heat_tpu``'s ``_polar_local_program``)."""
    rt = _real_dtype(a.dtype)
    nrm = torch.linalg.norm(a).to(rt)
    x0 = a / torch.clamp_min(nrm, torch.finfo(rt).tiny).to(a.dtype)
    u = _newton_schulz(x0, lambda x: _ct(x) @ x, a.shape[1], maxiter, tol)
    h = _ct(u) @ a
    return u, 0.5 * (h + _ct(h))


def _polar_split0(comm, a_loc: torch.Tensor, n: int, maxiter: int, tol: float):
    """(U's rows, H) of a split-0 operand whose rows here are ``a_loc``
    (``heat_tpu``'s ``_polar_program``): 2 + the iteration count
    collectives, H replicated."""
    rt = _real_dtype(a_loc.dtype)
    part = torch.sum(torch.real(a_loc.conj() * a_loc)).to(rt)
    nrm = torch.sqrt(torch.sum(comm.allgather(part.reshape(1))))
    x0 = a_loc / torch.clamp_min(nrm, torch.finfo(rt).tiny).to(a_loc.dtype)
    u_loc = _newton_schulz(x0, lambda x: comm.allreduce(_ct(x) @ x), n, maxiter, tol)
    h = comm.allreduce(_ct(u_loc) @ a_loc)
    return u_loc, 0.5 * (h + _ct(h))


def polar(a: DNDarray, side: str = "right", maxiter: int = _POLAR_MAXITER, tol: Optional[float] = None) -> Polar:
    """Polar decomposition ``A = U H`` (``side="right"``, m ≥ n) or ``A = H U``
    (``side="left"``, m ≤ n) by the scaled Newton–Schulz iteration: U with
    orthonormal columns (rows), H Hermitian positive semi-definite and
    replicated (``heat_tpu`` factorizations.py:355).

    A split-0 operand across ranks runs ``_polar_split0``: one all-gather of
    the ranks' Frobenius partials, one ``allreduce`` of ``XᴴX`` a step and
    one for ``H``; split 1 is resplit to 0 first. The iteration stops when
    ``‖XᴴX − I‖_F/√n ≤ tol`` (default 50·eps of the real type) or after
    ``maxiter`` steps."""
    sanitize_in(a)
    if a.ndim != 2:
        raise ValueError(f"polar requires a 2-dimensional array, got {a.ndim}")
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    m, n = (int(s) for s in a.shape)
    if side == "left":
        if m > n:
            raise ValueError(f"side='left' requires m <= n, got {a.shape}; use side='right'")
        u1, h1 = polar(_ct_dnd(a), side="right", maxiter=maxiter, tol=tol)
        return Polar(_ct_dnd(u1), h1)
    if m < n:
        raise ValueError(f"side='right' requires m >= n, got {a.shape}; use side='left'")
    dtype = _solver_dtype(a)
    tt = dtype.torch_type()
    if tol is None:
        tol = 50.0 * _real_eps(tt)
    if a.split == 1:
        a = a.resplit(0)
    comm = a.comm
    if a.split == 0 and comm.is_distributed():
        u_loc, h = _polar_split0(comm, _shard(a, tt), n, int(maxiter), float(tol))
        return Polar(_out(u_loc, (m, n), 0, a), _out(h, (n, n), None, a))
    u, h = _polar_local(a.larray.to(tt), int(maxiter), float(tol))
    return Polar(_from_whole(u, a.split, a), _from_whole(h, None, a))


# ---------------------------------------------------------------------- #
# blocked right-looking Cholesky / LU                                    #
# ---------------------------------------------------------------------- #
def _padded_block(t: torch.Tensor, i: int, nb: int, n: int, n_pad: int, seed: bool = True) -> torch.Tensor:
    """Rank i's rows ``t`` as an (nb, n_pad) block: zero pad rows and
    columns and, with ``seed``, ones on the pad diagonal (``heat_tpu``'s
    ``_pad_seed_diag``, factorizations.py:420: the padded matrix is
    diag(A, I), whose factors are diag(L, I) and diag(U, I))."""
    w = t.new_zeros((nb, n_pad))
    w[: t.shape[0], : t.shape[1]] = t
    if seed:
        for r in range(max(i * nb, n), min((i + 1) * nb, n_pad)):
            w[r - i * nb, r] = 1
    return w


def _lapack_permutation(lu: torch.Tensor, pivots: torch.Tensor):
    """``(perm, parity)`` of ``torch.linalg.lu_factor``'s 1-based LAPACK
    ``pivots``: ``a[perm] = L U`` (the permutation ``lax.linalg.lu``
    returns) and the int32 sign of the row swaps. On the device, no host
    read."""
    n = pivots.shape[-1]
    p_mat, _, _ = torch.lu_unpack(lu, pivots, unpack_data=False)
    perm = torch.argmax(p_mat.real if p_mat.is_complex() else p_mat, dim=-2)
    swaps = pivots != torch.arange(1, n + 1, dtype=pivots.dtype, device=pivots.device)
    parity = torch.prod(torch.where(swaps, -1, 1).to(torch.int32)).to(torch.int32)
    return perm, parity


def _blocked_cholesky(comm, a_loc: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's rows of L (``heat_tpu``'s ``chol_kernel``,
    factorizations.py:458): one all-gather of the panel blocks a lap."""
    p, i = comm.size, comm.rank
    nb = -(-n // p)
    w = _padded_block(a_loc, i, nb, n, nb * p)
    lout = torch.zeros_like(w)
    zero = w.new_zeros((nb, nb))
    for k in range(p):
        blk = slice(k * nb, (k + 1) * nb)
        col = comm.allgather(w[:, blk] if i >= k else zero)
        lkk = torch.linalg.cholesky(col[blk])
        # the whole block column in one solve: X·L_kkᴴ = S (rows above the
        # panel are zero by the gather gate)
        lcol = torch.linalg.solve_triangular(_ct(lkk), col, upper=True, left=False)
        my_l = lkk if i == k else lcol[i * nb : (i + 1) * nb]
        lout[:, blk] = my_l
        if k + 1 < p:
            w[:, (k + 1) * nb :] -= my_l @ _ct(lcol[(k + 1) * nb :])
    return lout[: a_loc.shape[0], :n]


def _blocked_lu(comm, a_loc: torch.Tensor, n: int):
    """This rank's rows of (L, U, perm), the replicated sign and the
    replicated count of zero pivots (``heat_tpu``'s ``lu_kernel``,
    factorizations.py:484): pivots within the panel's block of rows; one
    all-gather a lap, one broadcast of the pivoted U panel row from rank k
    on every lap but the last. A zero pivot does not raise: every rank
    factors the same gathered panel, so every rank counts it alike."""
    p, i = comm.size, comm.rank
    nb = -(-n // p)
    w = _padded_block(a_loc, i, nb, n, nb * p)
    lout, uout = torch.zeros_like(w), torch.zeros_like(w)
    zero = w.new_zeros((nb, nb))
    eye = torch.eye(nb, dtype=w.dtype, device=w.device)
    perm_loc = torch.arange(nb, device=w.device)
    sign = torch.ones((), dtype=torch.int32, device=w.device)
    singular = torch.zeros((), dtype=torch.int32, device=w.device)
    for k in range(p):
        blk = slice(k * nb, (k + 1) * nb)
        col = comm.allgather(w[:, blk] if i >= k else zero)
        lu_pk, piv, info = torch.linalg.lu_factor_ex(col[blk])
        singular = singular + (info != 0).to(torch.int32)
        pk, parity = _lapack_permutation(lu_pk, piv)
        lkk = torch.tril(lu_pk, -1) + eye
        ukk = torch.triu(lu_pk)
        sign = sign * parity
        if i == k:  # the panel's rank permutes its rows, written L columns and provenance
            w, lout, perm_loc = w[pk], lout[pk], perm_loc[pk]
        sz = col.clone()
        sz[blk] = 0
        lcol = torch.linalg.solve_triangular(ukk, sz, upper=True, left=False)
        lcol[blk] = lkk
        my_l = lcol[i * nb : (i + 1) * nb]
        lout[:, blk] = my_l
        if i == k:
            uout[:, blk] = ukk
        if k + 1 < p:
            trail = slice((k + 1) * nb, None)
            cand_u = (torch.linalg.solve_triangular(lkk, w[:, trail], upper=False, unitriangular=True) if i == k
                      else w.new_zeros(w[:, trail].shape))
            urow = comm.bcast(cand_u, root=k)
            if i == k:
                uout[:, trail] = cand_u
            w[:, trail] -= my_l @ urow
    rows = a_loc.shape[0]
    return lout[:rows, :n], uout[:rows, :n], (i * nb + perm_loc)[:rows], sign, singular


def _check_square(a: DNDarray, what: str) -> None:
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"{what} requires a square 2-D matrix, got {a.shape}")


def cholesky(a: DNDarray) -> DNDarray:
    """Cholesky factor L (lower triangular, A = L Lᴴ) of a Hermitian
    positive-definite matrix (``heat_tpu`` factorizations.py:573).

    Split 0 or 1 across ranks runs the blocked right-looking program (p
    all-gathers of nb × nb panel blocks, L split 0); otherwise
    ``torch.linalg.cholesky``. Only the lower triangle of A is read."""
    sanitize_in(a)
    _check_square(a, "ht.linalg.cholesky")
    dtype = _solver_dtype(a)
    tt = dtype.torch_type()
    if a.split == 1:
        a = a.resplit(0)
    comm = a.comm
    n = int(a.shape[0])
    if a.split == 0 and comm.is_distributed():
        return _out(_blocked_cholesky(comm, _shard(a, tt), n), (n, n), 0, a)
    return _from_whole(torch.linalg.cholesky(a.larray.to(tt)), a.split, a)


def _lu_factor(a: DNDarray):
    """``(perm, L, U, sign)`` with ``A[perm] = L U`` and ``sign`` the
    replicated int32 parity of the row swaps (``heat_tpu``'s form): the
    first four of :func:`_lu_factor_ex`."""
    return _lu_factor_ex(a)[:4]


def _lu_factor_ex(a: DNDarray):
    """``(perm, L, U, sign, singular)`` with ``A[perm] = L U``, ``sign``
    the replicated int32 parity of the row swaps and ``singular`` a
    replicated int32 tensor, nonzero where a pivot was zero (the factors
    are returned all the same, as ``lax.linalg.lu`` returns them): the form
    :func:`lu`, :func:`solve` and ``inv``/``det`` share. Across ranks the
    pivoting is within each rank's ⌈n/p⌉ rows."""
    sanitize_in(a)
    _check_square(a, "ht.linalg.lu")
    dtype = _solver_dtype(a)
    tt = dtype.torch_type()
    if a.split == 1:
        a = a.resplit(0)
    comm = a.comm
    n = int(a.shape[0])
    if a.split == 0 and comm.is_distributed():
        l_loc, u_loc, perm_loc, sign, singular = _blocked_lu(comm, _shard(a, tt), n)
        return (_out(perm_loc.to(torch.int32), (n,), 0, a), _out(l_loc, (n, n), 0, a),
                _out(u_loc, (n, n), 0, a), sign, singular)
    lu_p, piv, info = torch.linalg.lu_factor_ex(a.larray.to(tt))
    perm, sign = _lapack_permutation(lu_p, piv)
    l_arr = torch.tril(lu_p, -1) + torch.eye(n, dtype=tt, device=lu_p.device)
    return (_from_whole(perm.to(torch.int32), a.split, a), _from_whole(l_arr, a.split, a),
            _from_whole(torch.triu(lu_p), a.split, a), sign, info)


def _refuse_singular(singular: torch.Tensor, what: str) -> None:
    """Raise torch's ``LinAlgError`` where the LU met a zero pivot (one host
    read; ``singular`` is the same on every rank, so every rank raises)."""
    if int(singular):
        raise torch.linalg.LinAlgError(f"{what}: the LU factorization met a zero pivot; the matrix is singular "
                                       "(under pivoting within each rank's rows)")


def lu(a: DNDarray) -> LU:
    """LU factorization with partial pivoting: ``LU(perm, L, U)`` with
    ``A[perm] = L @ U`` (L unit lower, U upper triangular; ``heat_tpu``
    factorizations.py:647). Across ranks the pivot search stays within
    each rank's block of rows, so no pivot row crosses ranks (element
    growth can exceed the bound of global pivoting); ``perm`` is the row
    provenance: row r of L @ U is row ``perm[r]`` of A."""
    perm, l_arr, u_arr, _ = _lu_factor(a)
    return LU(perm, l_arr, u_arr)


# ---------------------------------------------------------------------- #
# block triangular solves                                                #
# ---------------------------------------------------------------------- #
def _bcast_sweep(comm, acc: torch.Tensor, big: torch.Tensor, diag: torch.Tensor, laps, upper: bool,
                 unit: bool = False) -> torch.Tensor:
    """One block substitution in the order of ``laps``: the lap's owner
    solves its block against ``diag`` and broadcasts it (but on the last
    lap), and every rank takes ``big``'s block column times it off ``acc``.
    Returns this rank's solved block."""
    i, nb = comm.rank, diag.shape[0]
    out = torch.zeros_like(acc)
    for j, k in enumerate(laps):
        cand = (torch.linalg.solve_triangular(diag, acc, upper=upper, unitriangular=unit) if i == k
                else torch.zeros_like(acc))
        if i == k:
            out = cand
        if j + 1 < len(laps):
            acc = acc - big[:, k * nb : (k + 1) * nb] @ comm.bcast(cand, root=k)
    return out


def _blocked_solve(comm, kind: str, n: int, b_loc: torch.Tensor, l_loc: torch.Tensor,
                   u_loc: Optional[torch.Tensor] = None, perm_loc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's rows of x against split-0 factors (``heat_tpu``'s
    ``_blocked_solve_program``, factorizations.py:665): the forward sweep
    broadcasts the solved block from rank k a lap; the backward sweep
    all-gathers the partial products a lap (Cholesky's ``Lᴴx = y``, summed
    in stack order) or broadcasts the solved block (LU's ``Ux = y``).
    Only the owner of a lap's block solves it."""
    p, i = comm.size, comm.rank
    nb = -(-n // p)
    n_pad = nb * p
    rows, nrhs = b_loc.shape
    own = slice(i * nb, (i + 1) * nb)
    b_pad = torch.cat([b_loc, b_loc.new_zeros((nb - rows, nrhs))])
    if kind == "chol":
        big_l = _padded_block(l_loc, i, nb, n, n_pad)
        diag = big_l[:, own]
        yout = _bcast_sweep(comm, b_pad, big_l, diag, range(p), upper=False)
        xout = torch.zeros_like(yout)
        for k in range(p - 1, -1, -1):
            ssum = torch.zeros_like(yout)
            if k + 1 < p:
                contrib = _ct(big_l[:, k * nb : (k + 1) * nb]) @ xout if i > k else torch.zeros_like(yout)
                ssum = torch.sum(comm.allgather(contrib[None]), dim=0)
            if i == k:
                xout = torch.linalg.solve_triangular(_ct(diag), yout - ssum, upper=True)
        return xout[:rows]
    big_l = _padded_block(l_loc, i, nb, n, n_pad, seed=False)
    big_u = _padded_block(u_loc, i, nb, n, n_pad)
    # the block-local row permutation applied to b; pad slots clamp to row 0
    # (their rows never reach a real row: the factors' pad columns are zero)
    perm = torch.cat([perm_loc.to(torch.int64), perm_loc.new_zeros(nb - rows, dtype=torch.int64)])
    acc = b_pad[torch.clamp(perm - i * nb, 0, nb - 1)]
    yout = _bcast_sweep(comm, acc, big_l, big_l[:, own], range(p), upper=False, unit=True)
    return _bcast_sweep(comm, yout, big_u, big_u[:, own], range(p - 1, -1, -1), upper=True)[:rows]


def _apply_factor_local(kind: str, b: torch.Tensor, l_arr: torch.Tensor, u_arr=None, perm=None) -> torch.Tensor:
    """The two triangular solves against whole factors (``heat_tpu``
    factorizations.py:787)."""
    if kind == "chol":
        y = torch.linalg.solve_triangular(l_arr, b, upper=False)
        return torch.linalg.solve_triangular(_ct(l_arr), y, upper=True)
    y = torch.linalg.solve_triangular(l_arr, b[perm], upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(u_arr, y, upper=True)


def _solve_factored(kind: str, b: DNDarray, l_arr: DNDarray, u_arr: Optional[DNDarray] = None,
                    pvec: Optional[DNDarray] = None) -> DNDarray:
    """The block triangular solve against factors split 0 (``heat_tpu``
    factorizations.py:798); ``b`` 1-D or 2-D, split anywhere (resplit to
    0); the result split 0."""
    comm = l_arr.comm
    n = int(l_arr.shape[0])
    tt = l_arr.dtype.torch_type()
    b0 = b if b.split == 0 else b.resplit(0)
    b_loc = _shard(b0, tt)
    vec = b0.ndim == 1
    if vec:
        b_loc = b_loc[:, None]
    u_loc = None if u_arr is None else _local(u_arr, 0).to(tt)
    perm_loc = None if pvec is None else _local(pvec, 0)
    x_loc = _blocked_solve(comm, kind, n, b_loc, _local(l_arr, 0).to(tt), u_loc, perm_loc)
    if vec:
        return _out(x_loc[:, 0], (n,), 0, b)
    return _out(x_loc, (n, int(b_loc.shape[1])), 0, b)


def solve(a: DNDarray, b, assume_a: str = "gen") -> DNDarray:
    """Solve ``A x = b`` for a square A (``heat_tpu`` factorizations.py:828):
    ``assume_a="gen"`` through :func:`lu`, ``"pos"`` through
    :func:`cholesky`. ``b`` is a vector or a matrix of right-hand sides,
    split anywhere. Across ranks, with A or b split, the blocked factors
    and the block solves run with no gather of A (a whole A is taken split
    0, each rank its rows), and x comes out split 0; otherwise
    ``torch.linalg``'s solves. A host-resident ``HostArray`` of right-hand
    sides streams through the card in column windows against factors
    taken once (``_solve_host_rhs``) and gives a ``HostArray`` of
    solutions."""
    from ...redistribution import staging

    if isinstance(b, staging.HostArray):
        return _solve_host_rhs(a, b, assume_a)
    sanitize_in(a)
    sanitize_in(b)
    _check_square(a, "ht.linalg.solve")
    if assume_a not in ("gen", "pos"):
        raise ValueError(f"assume_a must be 'gen' or 'pos', got {assume_a!r}")
    n = int(a.shape[0])
    if b.ndim not in (1, 2) or int(b.shape[0]) != n:
        raise ValueError(f"b must be (n,) or (n, nrhs) with n={n}, got {b.shape}")
    comm = a.comm
    if comm.is_distributed() and (a.split is not None or b.split is not None):
        if a.split is None:
            a = _from_whole(a.larray, 0, a)
        if assume_a == "pos":
            return _solve_factored("chol", b, cholesky(a))
        pvec, l_arr, u_arr, _sign, singular = _lu_factor_ex(a)
        _refuse_singular(singular, "ht.linalg.solve")
        return _solve_factored("lu", b, l_arr, u_arr, pvec)
    tt = _solver_dtype(a).torch_type()
    arr_a, arr_b = a.larray.to(tt), b.larray.to(tt)
    if assume_a == "pos":
        c = torch.linalg.cholesky(arr_a)
        res = _apply_factor_local("chol", arr_b if b.ndim == 2 else arr_b[:, None], c)
        res = res if b.ndim == 2 else res[:, 0]
    else:
        res = torch.linalg.solve(arr_a, arr_b)
    return _from_whole(res, b.split if b.split is not None else a.split, a)


def _solve_host_rhs(a: DNDarray, b, assume_a: str = "gen"):
    """``solve`` against a ``HostArray`` of right-hand sides (``heat_tpu``
    factorizations.py:1027): A is factored once (the blocked LU or
    Cholesky across ranks, else torch's), then column windows of b stream
    through the card, each solved against the factors and written back to
    a host array; returns a ``HostArray`` of the solutions, the same on
    every rank. Under ``HEAT_TPU_OOC=0`` b is materialized and solved
    whole."""
    from ...redistribution import staging
    from ..devices import get_device

    sanitize_in(a)
    _check_square(a, "ht.linalg.solve")
    if assume_a not in ("gen", "pos"):
        raise ValueError(f"assume_a must be 'gen' or 'pos', got {assume_a!r}")
    n = int(a.shape[0])
    if len(b.shape) != 2 or int(b.shape[0]) != n:
        raise ValueError(f"HostArray b must be (n, nrhs) with n={n}, got {b.shape}")
    comm = a.comm
    if not staging.ooc_engaged(b.nbytes, host_resident=True):
        return solve(a, staging.materialize(b, what="solve rhs"), assume_a=assume_a)
    tt = _solver_dtype(a).torch_type()
    distributed = comm.is_distributed() and a.split is not None
    if assume_a == "pos":
        kind = "chol"
        if distributed:
            l_arr, u_arr, pvec = cholesky(a), None, None
        else:
            l_loc, u_loc, perm_loc = torch.linalg.cholesky(a.larray.to(tt)), None, None
    else:
        kind = "lu"
        if distributed:
            pvec, l_arr, u_arr, _sign, singular = _lu_factor_ex(a)
        else:
            lu_p, piv, singular = torch.linalg.lu_factor_ex(a.larray.to(tt))
            perm_loc = _lapack_permutation(lu_p, piv)[0]
            l_loc = torch.tril(lu_p, -1) + torch.eye(n, dtype=tt, device=lu_p.device)
            u_loc = torch.triu(lu_p)
        _refuse_singular(singular, "ht.linalg.solve")
    nrhs = int(b.shape[1])
    np_dtype = torch.empty((), dtype=tt).numpy().dtype
    sched = staging.plan_staged_passes((n, nrhs), np_dtype, [{"tag": "solve", "axis": 1, "writeback": True}],
                                       out_bytes=0, mesh_size=comm.size)
    wins = staging.window_extents((n, nrhs), np_dtype.itemsize, 1, int(sched.staging["slab_bytes"]))
    out = np.empty((n, nrhs), np_dtype)

    def consume(k, win, ext):
        w = win.to(tt)
        if distributed:
            x = _solve_factored(kind, DNDarray(w, tuple(w.shape), types.canonical_heat_type(tt), None, a.device, comm),
                                l_arr, u_arr, pvec)
            out[:, ext[0] : ext[1]] = x.numpy()
        else:
            out[:, ext[0] : ext[1]] = _apply_factor_local(kind, w, l_loc, u_loc, perm_loc).cpu().numpy()

    staging.stream_windows(b, 1, wins, consume, get_device().torch_device)
    return staging.HostArray(out)


# ---------------------------------------------------------------------- #
# symmetric eigensolver: polar-based spectral divide and conquer         #
# ---------------------------------------------------------------------- #
def _range_probe(n: int, k: int, depth: int, branch: int, tt: torch.dtype, device) -> torch.Tensor:
    """``heat_tpu``'s Gaussian range probe (factorizations.py:895): ``normal``
    of ``fold_in`` of ``key(0xE16)`` by (n, k, depth, branch), (n, k) in the
    real type, with an imaginary part from ``fold_in(key, 7)`` for a
    complex type; R1 on a card, the same on every rank."""
    key = _threefry.seed_key(_PROBE_SEED)
    for t in (n, k, depth, branch):
        key = _threefry.fold_in(key, t)
    rt = _real_dtype(tt)
    chunk = _threefry.Chunk.whole((n, k))
    om = threefry.draw("normal", key, chunk, rt, device, (0.0, 1.0))
    if tt.is_complex:
        om = torch.complex(om, threefry.draw("normal", _threefry.fold_in(key, 7), chunk, rt, device, (0.0, 1.0)))
    return om.to(tt)


def _rows_of_eye(comm, n: int, tt: torch.dtype, device) -> torch.Tensor:
    """This rank's rows of the n × n identity (chunk geometry)."""
    start, (rows, _), _ = comm.chunk((n, n), 0)
    eye = torch.zeros((rows, n), dtype=tt, device=device)
    eye[torch.arange(rows, device=device), torch.arange(start, start + rows, device=device)] = 1
    return eye


def _median(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the middle value, or the mean of the two middle ones."""
    s = torch.sort(v).values
    h = s.shape[0] // 2
    return s[h] if s.shape[0] % 2 else 0.5 * s[h - 1] + 0.5 * s[h]


def _eigh_local(a: DNDarray):
    w, v = accurate_eigh(_whole(a))
    return w, _from_whole(v, a.split, a)


def _ring_xhy(x: DNDarray, y: DNDarray) -> torch.Tensor:
    """Replicated ``XᴴY`` of two split-0 operands: the local product of the
    rows and one ``allreduce``."""
    tt = x.dtype.torch_type()
    return x.comm.allreduce(_ct(x._balanced_larray().to(tt)) @ y._balanced_larray().to(tt))


def _eigh_branch(a: DNDarray, proj: DNDarray, k: int, depth: int, branch: int):
    """One side of the spectral split (``heat_tpu`` factorizations.py:932):
    the basis by TSQR of the projector's range probes (one refinement),
    ``QᴴAQ``, then recursion (order ≥ ``_EIGH_RESPLIT_MIN_N``) or a local
    ``eigh``."""
    from .qr import qr as _qr

    tt = a.dtype.torch_type()
    n = int(a.shape[0])
    om = _out(_range_probe(n, k, depth, branch, tt, a.larray.device), (n, k), None, a)
    q = _qr(basics.matmul(proj, om), calc_q=True).Q
    q = _qr(basics.matmul(proj, q), calc_q=True).Q
    a_sub = _ring_xhy(q, basics.matmul(a, q))
    sub_l = 0.5 * (a_sub + _ct(a_sub))
    if k >= _EIGH_RESPLIT_MIN_N and a.comm.is_distributed():
        w, v = _eigh_dc(_from_whole(sub_l, 0, a), depth + 1)
        return w, basics.matmul(q, v)
    w, v = accurate_eigh(sub_l)
    return w, basics.matmul(q, _out(v, v.shape, None, a))


def _eigh_dc(a: DNDarray, depth: int):
    """Spectral divide and conquer on a Hermitian split-0 operand
    (``heat_tpu`` factorizations.py:959): shift by the median of the
    diagonal, ``S = sign(A − μI)`` by :func:`polar`, split the spectrum by
    the projectors ``(I ∓ S)/2``, solve each side in its subspace, merge
    in sorted order. Degenerate splits, orders below 4 and depth
    ``_EIGH_MAX_DEPTH`` take the local ``eigh`` of the gathered operand."""
    comm = a.comm
    n = int(a.shape[0])
    if not comm.is_distributed() or a.split != 0 or n < 4 or depth >= _EIGH_MAX_DEPTH:
        return _eigh_local(a)
    tt = a.dtype.torch_type()
    a_loc = a._balanced_larray()
    start, (rows, _), _ = comm.chunk((n, n), 0)
    diag = comm.allgather(torch.real(torch.diagonal(a_loc, offset=start)), 0, comm.lshape_map((n, n), 0)[:, 0])
    mu = _median(diag).to(tt)
    eye = _rows_of_eye(comm, n, tt, a_loc.device)
    s_u, _ = polar(_out(a_loc - mu * eye, (n, n), 0, a))
    s_loc = s_u.larray
    proj_lo = 0.5 * (eye - s_loc)
    k = int(np.round(_host_read(comm.allreduce(torch.real(torch.diagonal(proj_lo, offset=start).sum())))))
    if k <= 0 or k >= n:  # the spectrum clustered at the shift
        return _eigh_local(a)
    w1, u1 = _eigh_branch(a, _out(proj_lo, (n, n), 0, a), k, depth, 0)
    w2, u2 = _eigh_branch(a, _out(0.5 * (eye + s_loc), (n, n), 0, a), n - k, depth, 1)
    w_all = torch.cat([w1, w2])
    order = torch.argsort(w_all, stable=True)
    v_loc = torch.cat([u1._balanced_larray(), u2._balanced_larray()], dim=1)[:, order]
    return w_all[order], _out(v_loc, (n, n), 0, a)


def eigh(a: DNDarray, UPLO: str = "L") -> Eigh:
    """Eigendecomposition of a Hermitian matrix: ``Eigh(eigenvalues,
    eigenvectors)``, eigenvalues ascending and replicated, eigenvectors
    split 0 across ranks (``heat_tpu`` factorizations.py:990).

    Across ranks: the Hermitian fill ``tril(A) + tril(A, −1)ᴴ`` (one resplit
    of the strict triangle's transpose), then ``_eigh_dc``; otherwise
    ``torch.linalg.eigh`` (``_lapack.accurate_eigh``: in double precision
    where a card would take its Jacobi solver). Only the ``UPLO`` triangle
    of A is read."""
    sanitize_in(a)
    _check_square(a, "ht.linalg.eigh")
    if UPLO not in ("L", "U"):
        raise ValueError(f"UPLO must be 'L' or 'U', got {UPLO!r}")
    dtype = _solver_dtype(a)
    tt = dtype.torch_type()
    if a.split == 1:
        a = a.resplit(0)
    comm = a.comm
    if a.split == 0 and comm.is_distributed():
        n = int(a.shape[0])
        a0 = _out(_shard(a, tt), a.shape, 0, a)
        tri, off = (basics.tril, -1) if UPLO == "L" else (basics.triu, 1)
        other = _ct_dnd(tri(a0, off)).resplit(0)
        herm = _out(tri(a0).larray + other.larray, (n, n), 0, a)
        w, v = _eigh_dc(herm, 0)
        return Eigh(_out(w, w.shape, None, a), v)
    w, v = accurate_eigh(a.larray.to(tt), UPLO=UPLO)
    return Eigh(_from_whole(w, None, a), _from_whole(v, a.split, a))
