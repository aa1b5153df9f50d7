"""Hierarchical SVD, the north-star operation.

Port of ``heat_tpu.core.linalg.svdtools`` (``_hsvd_impl`` :969; Heat
reference: heat/core/linalg/svdtools.py, ``hsvd_rank`` :31, ``hsvd_rtol``
:124, ``hsvd`` :259).

One device (world size 1, or an unsplit operand): a small rank budget
runs a randomized sketch, the 2-pass HMT range finder
(``_sketched_uds_both`` then ``_projection_tail``) or with
``single_pass=True`` Tropp's one-view sketch (``_one_view_uds_both`` then
``_one_view_tail``); otherwise a full SVD. Both factors come out of the
same passes.

Across ranks (a split operand, ``heat_tpu`` svdtools.py:1086-1185):

1. level 0: every rank reduces its column block of A (of Aᵀ for a split-0
   operand: its row shard S is a column block of Aᵀ) to ``B_r = U_r·Σ_r``
   (m × rloc) with a sketch or a full SVD, and the block's discarded
   energy and ‖·‖²_F (``_level0``). The widths come from the global shape
   and the world size (``_level0_params``), so every rank takes one route;
2. the merge: B = [B_1 ∥ … ∥ B_p], split 1, is resplit to rows and
   factored by TSQR (``qr``); the SVD of the small R gives σ and
   U = Q·U_R (``_merge_svd``);
3. truncation and the error estimate from the ``allreduce``d level-0 sums;
4. the other factor, ``A·V/σ`` or ``Aᴴ·U/σ`` (``_postprocess_v``),
   re-orthonormalized by Cholesky-QR with the Gram ``allreduce``d.

The streaming reads of A go through the hand-written CUDA kernels of
``_cuda_sketch`` where their predicates hold (float32 on CUDA, widths in
range); everywhere else, and on the CPU, through the fixed-grain tiled
torch streams ``_pass1_tiles`` / ``_pass2_tiles`` / ``_oneview_tiles``.
A host-resident operand (``redistribution.staging.HostArray``) takes the
rank-budget sketch window by window (``_staged_sketch_rank``): column
windows through pass 1 (K1 a window on a card) and row windows through
pass 2 with the norm carried, or column windows through the one-view
stream (K2 a window) with its carries, the draws those of the in-memory
route. ``HEAT_TPU_OOC=1`` routes an in-memory operand the same way.

On a split-0 operand the 2-pass sketch runs with the passes' roles
swapped on S (``_sketched_uds_swapped``), so that K1 takes pass 2 in its
own form and no copy of Sᵀ is made; the one-view sketch copies Sᵀ once a
rank, since K2 caps the column sketch at k̂ ≤ 32 (``DUAL_MAX_K``). The
small products (Gram matrices, the projection ``z = A·Q``) are torch
matmuls in the operand's full precision: torch's default
``allow_tf32=False`` keeps float32 products in FP32, as ``heat_tpu``'s
``precision="highest"`` does.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch

from .. import _threefry, types
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from ...kernels import threefry
from . import _cuda_sketch
from ._lapack import safe_svd
from .basics import _whole, matmul, transpose
from .qr import qr

__all__ = ["hsvd", "hsvd_rank", "hsvd_rtol"]


_SKETCH_OVERSAMPLE = 10
#: tile grain of the torch streams (``heat_tpu``'s ``_PASS_TILE``): pass 1
#: walks 512-column tiles, pass 2 512-row tiles, the one-view stream
#: 512-column tiles; arrays smaller than one tile take one product
_PASS_TILE = 512
_ONEVIEW_GAP = 9  # k̂ = keep + GAP column-sketch oversample (Tropp one-view)
_ONEVIEW_ERRQ = 10  # extra Ψ rows reserved for the unbiased error estimator
_SKETCH_SEED = 0x5BD  # heat_tpu's jax.random.key(0x5BD) of the 2-pass sketch
_ONEVIEW_SEED = 0x5BD1  # and split(key(0x5BD1)) of the one-view operators


def _sumsq(blk: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.real(blk * torch.conj(blk)))


def _real_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=a.real.dtype if a.is_complex() else a.dtype, device=a.device)


def _pass1_tiles(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Pass 1 of the 2-pass sketch, ``w = g @ a``, in 512-column tiles."""
    n = a.shape[1]
    T = _PASS_TILE
    if n < T:
        return g @ a
    return torch.cat([g @ a[:, k : k + T] for k in range(0, n, T)], dim=1)


def _pass2_tiles(a: torch.Tensor, qw: torch.Tensor, norm_in: Optional[torch.Tensor]):
    """Pass 2, ``z = a @ qw`` in 512-row tiles, with ``‖a‖²_F`` folded into
    the same stream as a running carry when ``norm_in`` is given."""
    m = a.shape[0]
    T = _PASS_TILE
    if m < T:
        return a @ qw, (None if norm_in is None else norm_in + _sumsq(a))
    zs = []
    acc = norm_in
    for k in range(0, m, T):
        blk = a[k : k + T]
        zs.append(blk @ qw)
        if acc is not None:
            acc = acc + _sumsq(blk)
    return torch.cat(zs, dim=0), acc


def _oneview_tiles(g, omega, a, y_in, norm_in):
    """The one-view stream, ``w = g @ a``, ``y += a @ omega`` and
    ``norm += ‖a‖²``, in 512-column tiles with (y, norm) carries."""
    n = a.shape[1]
    T = _PASS_TILE
    if n < T:
        return g @ a, y_in + a @ omega, norm_in + _sumsq(a)
    ws = []
    y, acc = y_in, norm_in
    for k in range(0, n, T):
        blk = a[:, k : k + T]
        ws.append(g @ blk)
        y = y + blk @ omega[k : k + T]
        acc = acc + _sumsq(blk)
    return torch.cat(ws, dim=1), y, acc


def _needs_exact_spectrum(rtol: Optional[float]) -> bool:
    """Below rtol=1e-3 the sketch cannot capture the spectrum the rank
    selection needs (σ near √ε·σ_max in float32), so the full SVD runs."""
    return rtol is not None and float(rtol) < 1e-3


def _warn_merge_knobs(maxmergedim, no_of_merges) -> None:
    """The reference's merge-tree knobs (svdtools.py:346-445) have no
    effect here; non-default values warn."""
    if maxmergedim is not None or (no_of_merges is not None and no_of_merges != 2):
        warnings.warn(
            "maxmergedim/no_of_merges are accepted for reference-API parity "
            "but have no effect: the TSQR merge replaces the reference's "
            "Send/Recv merge tree",
            UserWarning,
            stacklevel=3,
        )


def _gram_orthonormalize(z: torch.Tensor) -> torch.Tensor:
    """Orthonormalize the columns of a tall-skinny ``z`` by two rounds of
    Gram eigen-orthonormalization (z ← z·V·Λ^{-1/2}); cannot fail on
    rank-deficient sketches, unlike Cholesky-QR."""
    info = torch.finfo(z.real.dtype if z.is_complex() else z.dtype)
    for _ in range(2):
        gram = torch.conj(z).T @ z
        lam, v = torch.linalg.eigh(gram)  # ascending
        # relative floor for rank deficiency plus an absolute one, so an
        # all-zero block propagates zeros instead of 0·inf = NaN
        lam = torch.clamp(torch.maximum(lam, info.eps * torch.max(lam) * z.shape[0]), min=info.tiny)
        z = (z @ v) * torch.rsqrt(lam)
    return z


def _cholqr2_refine(v: torch.Tensor, comm=None) -> torch.Tensor:
    """Re-orthonormalize a near-orthonormal ``v`` by two rounds of
    Cholesky-QR; the correction R ≈ I keeps each column paired with its
    σ. The tiny ridge keeps exact-zero columns at zero instead of NaN.
    With ``comm``, ``v`` is this rank's row block of a matrix split 0, and
    each round's (r, r) Gram is the ``allreduce``d sum of the blocks'."""
    eps = torch.finfo(v.real.dtype if v.is_complex() else v.dtype).eps
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    for _ in range(2):
        g = torch.conj(v).T @ v
        if comm is not None:
            g = comm.allreduce(g)
        g = g + eps * eye
        r = torch.linalg.cholesky(g)  # lower: g = r r^H
        v = torch.conj(torch.linalg.solve_triangular(r, torch.conj(v).T, upper=False)).T
    return v.resolve_conj().contiguous()


def _inv_sigma(s: torch.Tensor, n: int) -> torch.Tensor:
    """1/σ of the descending ``s`` from the eigenvalues of an n × n Gram,
    and 0 where σ² lies within that eigen-solver's rounding (n·eps·σ²_max)
    of zero: such a column is truncation noise and stays zero, as
    ``heat_tpu`` keeps a σ = 0 column at zero, instead of rounding blown up
    into a direction that leaves Cholesky-QR's Gram singular."""
    eps = torch.finfo(s.dtype).eps
    return torch.where(s * s > n * eps * torch.max(s * s), 1.0 / s, 0.0) if s.numel() else s


def _normal(key, shape, like: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal(key, shape, like.dtype)`` on ``like``'s device
    (kernel R1 on a card); a complex dtype takes ``normal``'s two subkeys
    for the real and imaginary parts and divides by √2."""
    chunk = _threefry.Chunk.whole(shape)
    if like.dtype.is_complex:
        real = torch.float32 if like.dtype == torch.complex64 else torch.float64
        k_re, k_im = _threefry.split(key)
        re, im = (threefry.draw("normal", k, chunk, real, like.device, (0.0, 1.0)) for k in (k_re, k_im))
        return torch.complex(re, im) / math.sqrt(2.0)
    return threefry.draw("normal", key, chunk, like.dtype, like.device, (0.0, 1.0))


def _sketched_uds_both(a, keep: int, sketch_l: int, want: str = "left", g=None):
    """Randomized truncated SVD in two streaming passes over ``a``
    (``heat_tpu`` svdtools.py:280): ``w = g·a`` (pass 1, with ``‖a‖²`` in the
    same read where kernel K1 serves it), ``Q = orth(wᴴ)``, ``z = a·Q``
    (pass 2, with ``‖a‖²`` folded in otherwise), then ``_projection_tail``.

    ``g`` (sketch_l, m) defaults to ``heat_tpu``'s draw from
    ``key(0x5BD)`` (svdtools.py:308); tests may pass another operator.
    Returns (u|None, v|None, s, err_sq, norm_sq)."""
    if g is None:
        g = _sketch_operator(sketch_l, a.shape[0], a)
    if _cuda_sketch.sketch_serviceable(sketch_l, a):
        w, norm_sq = _cuda_sketch.sketch_with_norm(g, a)  # pass 1 + norm in one read
        qw = _gram_orthonormalize(torch.conj(w).T)
        z, _ = _pass2_tiles(a, qw, None)
    else:
        w = _pass1_tiles(g, a)
        qw = _gram_orthonormalize(torch.conj(w).T)
        z, norm_sq = _pass2_tiles(a, qw, _real_zero(a))
    return _projection_tail(z, qw, norm_sq, keep, want)


def _sketch_operator(sketch_l: int, m: int, like: torch.Tensor) -> torch.Tensor:
    """The 2-pass row sketch g (sketch_l, m): ``jax.random.normal(key(0x5BD),
    (sketch_l, m))`` in ``like``'s dtype on its device, the same draw on
    every rank (``heat_tpu`` svdtools.py:308-309)."""
    return _normal(_threefry.seed_key(_SKETCH_SEED), (sketch_l, m), like)


def _sketched_uds_swapped(s_loc, keep: int, sketch_l: int, want: str = "left", g=None):
    """``_sketched_uds_both`` of the block ``a = s_locᵀ`` (m × n_blk)
    without forming it: pass 1, ``w = g·Sᵀ = (S·gᵀ)ᵀ``, is the tall-skinny
    stream over S's 512-row tiles; pass 2, ``z = Sᵀ·qw = (qwᵀ·S)ᵀ``, is
    kernel K1's own form ``sketch_with_norm(qwᵀ, S)``, which takes ‖S‖²_F
    in the same read. Where K1 does not serve, the norm rides pass 1's
    stream and pass 2 is ``_pass1_tiles(qwᵀ, S)``."""
    m = s_loc.shape[1]
    if g is None:
        g = _sketch_operator(sketch_l, m, s_loc)
    if _cuda_sketch.sketch_serviceable(sketch_l, s_loc):
        w_t, _ = _pass2_tiles(s_loc, g.T, None)  # pass 1: (n_blk, l)
        qw = _gram_orthonormalize(torch.conj(w_t))
        z_t, norm_sq = _cuda_sketch.sketch_with_norm(qw.T.contiguous(), s_loc)  # pass 2 + norm in one read
    else:
        w_t, norm_sq = _pass2_tiles(s_loc, g.T, _real_zero(s_loc))
        qw = _gram_orthonormalize(torch.conj(w_t))
        z_t = _pass1_tiles(qw.T, s_loc)
    return _projection_tail(z_t.T, qw, norm_sq, keep, want)


def _projection_tail(z, qw, norm_sq, keep: int, want: str):
    """Everything after the passes of ``_sketched_uds_both``: Gram-eigh of
    the projection, factor assembly and the exact a-posteriori error
    ``‖A‖² − ‖z‖²`` (``heat_tpu`` svdtools.py:333)."""
    gram = torch.conj(z).T @ z
    lam, u_z = torch.linalg.eigh(gram)  # ascending
    lam = torch.clamp(lam.flip(0), min=0.0)[:keep]  # descending energies σ²
    u_z = u_z.flip(1)[:, :keep]
    s = torch.sqrt(lam)
    u = v = None
    if want in ("left", "both"):
        u = _cholqr2_refine((z @ u_z) * _inv_sigma(s, z.shape[1]))
    if want in ("right", "both"):
        v = qw @ u_z
    err_sq = torch.clamp(norm_sq - torch.sum(lam), min=0.0)
    return u, v, s, err_sq, norm_sq


def _one_view_params(keep: int, cap: int, a: Optional[torch.Tensor] = None):
    """(k̂, ℓ) for the one-view sketch, or None when it should not run:
    the matrix is too small for the sketch (4·(ℓ+q) > cap), or ``a`` lies
    on CUDA and kernel K2 cannot serve the signature. Its torch stream
    would then read A three times, worse than the 2-pass default, so
    ``single_pass`` reverts to 2-pass, as ``heat_tpu`` does on a TPU
    (svdtools.py:365)."""
    k_hat = keep + _ONEVIEW_GAP
    l_row = 2 * k_hat + 1
    if 4 * (l_row + _ONEVIEW_ERRQ) > cap:
        return None
    if a is not None and a.is_cuda:
        if not _cuda_sketch.dual_sketch_serviceable(l_row + _ONEVIEW_ERRQ, k_hat, a):
            return None
    return k_hat, l_row


def _one_view_uds_both(a, keep: int, k_hat: int, sketch_l: int, want: str = "left", g=None, omega=None):
    """One-view (single-pass) randomized truncated SVD (Tropp et al.;
    ``heat_tpu`` svdtools.py:387): ``Y = A·Ω``, ``W = Ψ·A`` and ``‖A‖²`` from
    one read of A (kernel K2 where it serves), then ``_one_view_tail``.

    ``g`` (sketch_l + 10, m) and ``omega`` (n, k̂) default to ``heat_tpu``'s
    draws from ``split(key(0x5BD1))`` (svdtools.py:417-420). The stream is
    partitionable, so the (n, k̂) draw of a short last shard is the first n
    rows of the draw of ``heat_tpu``'s padded block, whose other rows meet
    its zero columns. Tests may pass other operators. Returns (u|None,
    v|None, s, err_sq, norm_sq)."""
    m, n = a.shape
    if g is None or omega is None:
        kg, ko = _threefry.split(_threefry.seed_key(_ONEVIEW_SEED))
        g = _normal(kg, (sketch_l + _ONEVIEW_ERRQ, m), a)
        omega = _normal(ko, (n, k_hat), a)
    if _cuda_sketch.dual_sketch_serviceable(g.shape[0], k_hat, a):
        w_full, y, norm_sq = _cuda_sketch.dual_sketch_with_norm(g, omega, a)
    else:
        y0 = torch.zeros((m, k_hat), dtype=a.dtype, device=a.device)
        w_full, y, norm_sq = _oneview_tiles(g, omega, a, y0, _real_zero(a))
    return _one_view_tail(w_full, y, norm_sq, g, keep, sketch_l, want)


def _one_view_tail(w_full, y, norm_sq, g, keep: int, sketch_l: int, want: str):
    """Everything after the one-view stream (``heat_tpu`` svdtools.py:438):
    Q from the column sketch, B = (ΨQ)⁺W through QR and a triangular solve,
    Gram-eigh, factor assembly, and the unbiased error estimate from the
    held-out rows of Ψ."""
    w, w_err = w_full[:sketch_l], w_full[sketch_l:]
    g_err = g[sketch_l:]
    q = _gram_orthonormalize(y)  # (m, k̂)
    qq, rr = torch.linalg.qr(g[:sketch_l] @ q)  # ΨQ (ℓ, k̂)
    b = torch.linalg.solve_triangular(rr, torch.conj(qq).T @ w, upper=True)  # (k̂, n)
    lam, u_b = torch.linalg.eigh(b @ torch.conj(b).T)
    lam = torch.clamp(lam.flip(0), min=0.0)[:keep]
    u_b = u_b.flip(1)[:, :keep]
    s = torch.sqrt(lam)
    u = v = None
    if want in ("left", "both"):
        u = _cholqr2_refine(q @ u_b)
    if want in ("right", "both"):
        v = _cholqr2_refine((torch.conj(b).T @ u_b) * _inv_sigma(s, b.shape[0]))
    # Ψ₂A − (Ψ₂Q)B with the kept-rank reconstruction
    b_keep = torch.conj(u_b).T @ b  # (keep, n)
    resid = w_err - ((g_err @ q) @ u_b) @ b_keep
    err_sq = _sumsq(resid) / _ONEVIEW_ERRQ
    return u, v, s, err_sq, norm_sq


def _truncate_with_err(res, r_final: int):
    """Truncate the sketch factors to ``r_final`` and fold the relative
    a-posteriori error."""
    u, v, s, err_sq, norm_sq = res
    err = torch.sqrt(err_sq + torch.sum(s[r_final:] ** 2)) / torch.clamp(
        torch.sqrt(norm_sq), min=1e-30
    )
    return (
        u[:, :r_final] if u is not None else None,
        v[:, :r_final] if v is not None else None,
        s[:r_final],
        err,
    )


def _err_scalar(val, A: DNDarray) -> DNDarray:
    """The relative-error estimate as a 0-d DNDarray on A's device (the
    reference returns a DNDarray too, svdtools.py:449). A tensor keeps its
    dtype; a host float is float64, as in ``heat_tpu``'s cpu/gpu world."""
    if isinstance(val, torch.Tensor):
        t = val.to(A.larray.device)
    else:
        t = torch.tensor(float(val), dtype=torch.float64, device=A.larray.device)
    return DNDarray(t, (), types.canonical_heat_type(t.dtype), None, A.device, A.comm)


def _choose_rank(
    s: np.ndarray,
    maxrank: Optional[int],
    rtol: Optional[float],
    a_norm: float,
    prior_err_sq: float,
    cap: int,
) -> int:
    """Final truncation rank: the static budget and/or the smallest rank
    whose discarded energy keeps the total error below rtol·‖A‖."""
    s = np.asarray(s, dtype=np.float64)
    k = min(len(s), cap)
    if rtol is None:
        return max(1, min(maxrank, k))
    budget_sq = (rtol * a_norm) ** 2 - prior_err_sq
    tail = np.cumsum((s[::-1] ** 2))[::-1]  # tail[i] = sum_{j>=i} s_j^2
    r = k
    for i in range(k, 0, -1):
        discard = tail[i] if i < len(s) else 0.0
        if discard <= max(budget_sq, 0.0):
            r = i
        else:
            break
    if maxrank is not None:
        r = min(r, maxrank)
    return max(1, r)


def hsvd_rank(
    A: DNDarray,
    maxrank: int,
    compute_sv: bool = False,
    maxmergedim: Optional[int] = None,
    safetyshift: int = 5,
    silent: bool = True,
    single_pass: bool = False,
):
    """Truncated hierarchical SVD with a fixed rank budget (reference:
    svdtools.py:31). Returns ``(U, sigma, V, rel_error_estimate)`` when
    ``compute_sv=True`` else ``(U, rel_error_estimate)``; the error is a
    0-d DNDarray.

    ``single_pass=True`` selects the one-view sketch: both sketches from a
    single read of A (kernel K2 on CUDA). Its approximation constant is
    larger than the 2-pass bound and its error estimate is approximate; it
    is exact for matrices of rank ≤ maxrank + safetyshift.

    ``A`` may be a ``redistribution.staging.HostArray``, an operand in host
    memory that need not fit the card: the sketch then streams its windows
    through the card (``_hsvd_rank_host``), and the factors come back whole
    on every rank (split None)."""
    from ...redistribution import staging

    if isinstance(A, staging.HostArray):
        if not isinstance(maxrank, (int, np.integer)) or maxrank < 1:
            raise ValueError(f"maxrank must be a positive integer, got {maxrank}")
        _warn_merge_knobs(maxmergedim, None)
        return _hsvd_rank_host(A, int(maxrank), compute_sv, int(safetyshift), bool(single_pass))
    sanitize_in(A)
    if A.ndim != 2:
        raise ValueError(f"hsvd requires a 2-dimensional array, got {A.ndim}")
    if not isinstance(maxrank, (int, np.integer)) or maxrank < 1:
        raise ValueError(f"maxrank must be a positive integer, got {maxrank}")
    if maxmergedim is not None and maxmergedim < 2 * (maxrank + safetyshift) + 1:
        raise ValueError(
            "maxmergedim too small for maxrank+safetyshift (reference constraint, svdtools.py)"
        )
    _warn_merge_knobs(maxmergedim, None)
    return _hsvd_impl(
        A,
        maxrank=int(maxrank),
        rtol=None,
        safetyshift=int(safetyshift),
        compute_sv=compute_sv,
        single_pass=bool(single_pass),
    )


def hsvd_rtol(
    A: DNDarray,
    rtol: float,
    compute_sv: bool = False,
    maxrank: Optional[int] = None,
    maxmergedim: Optional[int] = None,
    no_of_merges: Optional[int] = None,
    silent: bool = True,
    safetyshift: int = 5,
):
    """Hierarchical SVD truncated to a relative error tolerance (reference:
    svdtools.py:124): ‖A − UΣVᴴ‖_F ≤ rtol·‖A‖_F (upper-bound estimate)."""
    sanitize_in(A)
    if A.ndim != 2:
        raise ValueError(f"hsvd requires a 2-dimensional array, got {A.ndim}")
    if rtol <= 0:
        raise ValueError(f"rtol must be positive, got {rtol}")
    _warn_merge_knobs(maxmergedim, no_of_merges)
    return _hsvd_impl(
        A,
        maxrank=int(maxrank) if maxrank is not None else None,
        rtol=float(rtol),
        safetyshift=int(safetyshift),
        compute_sv=compute_sv,
    )


def hsvd(
    A: DNDarray,
    maxrank: Optional[int] = None,
    maxmergedim: Optional[int] = None,
    rtol: Optional[float] = None,
    safetyshift: int = 0,
    no_of_merges: Optional[int] = 2,
    compute_sv: bool = False,
    silent: bool = True,
    warnings_off: bool = False,
):
    """General hierarchical SVD entry point (reference: svdtools.py:259)."""
    sanitize_in(A)
    if maxrank is None and rtol is None:
        raise ValueError("at least one of maxrank and rtol must be given")
    _warn_merge_knobs(maxmergedim, no_of_merges)
    return _hsvd_impl(
        A,
        maxrank=int(maxrank) if maxrank is not None else None,
        rtol=rtol,
        safetyshift=int(safetyshift),
        compute_sv=compute_sv,
    )


def _hsvd_impl(
    A: DNDarray,
    maxrank: Optional[int],
    rtol: Optional[float],
    safetyshift: int,
    compute_sv: bool,
    single_pass: bool = False,
):
    dtype = types.float32 if types.heat_type_is_exact(A.dtype) else A.dtype
    if A.is_distributed():
        return _hsvd_distributed(A, dtype, maxrank, rtol, safetyshift, compute_sv, single_pass)
    arr = A.larray.to(dtype.torch_type()).contiguous()
    m, n = A.shape
    full_rank_cap = min(m, n)

    def wrap(t, shape):
        return DNDarray(t, shape, dtype, None, A.device, A.comm)

    budget = (maxrank + safetyshift) if maxrank is not None else None
    sketch_l = None
    if budget is not None and not _needs_exact_spectrum(rtol):
        l = min(budget + _SKETCH_OVERSAMPLE, full_rank_cap)
        if 4 * l <= full_rank_cap:
            sketch_l = l
    want = "both" if compute_sv else "left"
    if sketch_l is not None and rtol is None:
        # rank budget: the rank is static, truncation and error stay on device
        keep = min(budget, full_rank_cap)
        r_final = max(1, min(maxrank, keep))
        ov = _one_view_params(keep, full_rank_cap, arr) if single_pass else None
        from ...redistribution import staging

        if staging.ooc_mode() == "1":
            # HEAT_TPU_OOC=1: the in-memory operand through the staged windows
            host = staging.HostArray(arr.cpu().numpy())
            res = _staged_sketch_rank(host, keep, sketch_l, want, ov, arr.dtype, arr.device)
        elif ov is not None:
            res = _one_view_uds_both(arr, keep, ov[0], ov[1], want)
        else:
            res = _sketched_uds_both(arr, keep, sketch_l, want)
        u_t, v_t, s_t, err_t = _truncate_with_err(res, r_final)
        err = _err_scalar(err_t, A)
    elif sketch_l is not None:
        # tolerance mode: the rank is chosen on the host from the sketched spectrum
        keep = min(budget, full_rank_cap)
        u_f, v_f, s_f, err0_sq, norm_sq = _sketched_uds_both(arr, keep, sketch_l, want)
        s_host = s_f.cpu().numpy()
        a_norm = float(np.sqrt(max(float(norm_sq), 0.0)))
        r_final = _choose_rank(s_host, maxrank, rtol, a_norm, float(err0_sq), full_rank_cap)
        err = _err_scalar(
            float(np.sqrt(float(err0_sq) + np.sum(s_host[r_final:].astype(np.float64) ** 2)))
            / max(a_norm, 1e-30),
            A,
        )
        u_t = u_f[:, :r_final]
        v_t = v_f[:, :r_final] if v_f is not None else None
        s_t = s_f[:r_final]
    else:
        # full SVD: both sides come out of the one call
        u, s, vh = safe_svd(arr, full_matrices=False)
        s_host = s.cpu().numpy().astype(np.float64)
        a_norm = float(np.sqrt(np.sum(s_host**2)))
        r_final = _choose_rank(s_host, maxrank, rtol, a_norm, 0.0, full_rank_cap)
        u_t, v_t, s_t = u[:, :r_final], vh[:r_final].T, s[:r_final]
        err = _err_scalar(float(np.sqrt(np.sum(s_host[r_final:] ** 2))) / max(a_norm, 1e-30), A)

    U = wrap(u_t, (m, r_final))
    if not compute_sv:
        return U, err
    sigma = DNDarray(s_t, (int(s_t.shape[0]),), types.canonical_heat_type(s_t.dtype), None, A.device, A.comm)
    return U, sigma, wrap(v_t, (n, r_final)), err


# --------------------------------------------------------------------- #
# out of core                                                           #
# --------------------------------------------------------------------- #
def _staged_sketch_rank(host, keep: int, sketch_l: int, want: str, one_view, tt: torch.dtype, device):
    """The rank-budget sketch of a host-resident operand, window by window
    (``heat_tpu`` svdtools.py:586), as ``(u|None, v|None, s, err_sq,
    norm_sq)`` on ``device``. The plan (``host-staging``) is proven to fit
    the card before a byte moves.

    2-pass: column windows through pass 1 (K1 on each window where it
    serves, else ``_pass1_tiles``), then ``Q = orth(wᴴ)`` and row windows
    through ``_pass2_tiles`` with ‖A‖² carried. One-view (``one_view`` =
    (k̂, ℓ)): column windows through the one-view stream (K2 on each window
    where it serves, else ``_oneview_tiles``) with y and ‖A‖² carried. The
    draws are the in-memory route's (``_SKETCH_SEED``, ``_ONEVIEW_SEED``).
    Windows are whole 512-wide tiles but the last, so on the CPU the
    result is the in-memory route's bit for bit."""
    from ...redistribution import staging

    m, n = host.shape
    like = torch.empty((m, 1), dtype=tt, device=device)
    item = like.element_size()
    passes = ([{"tag": "dual-sketch", "axis": 1}] if one_view is not None
              else [{"tag": "sketch", "axis": 1}, {"tag": "project", "axis": 0}])
    # held on the card across the loops: the sketch operators and products
    l_rows = (one_view[1] + _ONEVIEW_ERRQ) if one_view is not None else sketch_l
    width = one_view[0] if one_view is not None else sketch_l
    out_bytes = item * (l_rows * n + l_rows * m + 2 * n * width + 2 * m * width)
    np_dtype = torch.empty((), dtype=tt).numpy().dtype
    sched = staging.prove_fits(staging.plan_staged_passes((m, n), np_dtype, passes, out_bytes=out_bytes))
    slab = int(sched.staging["slab_bytes"])

    if one_view is not None:
        k_hat, l_row = one_view
        kg, ko = _threefry.split(_threefry.seed_key(_ONEVIEW_SEED))
        g = _normal(kg, (l_row + _ONEVIEW_ERRQ, m), like)
        omega = _normal(ko, (n, k_hat), like)
        chunks = []
        carry = [torch.zeros((m, k_hat), dtype=tt, device=device), _real_zero(like)]

        def consume(k, win, ext):
            a, om = win.to(tt), omega[ext[0] : ext[1]]
            if _cuda_sketch.dual_sketch_serviceable(g.shape[0], k_hat, a):
                w_k, y_k, norm_k = _cuda_sketch.dual_sketch_with_norm(g, om, a)
                carry[0], carry[1] = carry[0] + y_k, carry[1] + norm_k
            else:
                w_k, carry[0], carry[1] = _oneview_tiles(g, om, a, carry[0], carry[1])
            chunks.append(w_k)

        staging.stream_windows(host, 1, staging.window_extents((m, n), item, 1, slab), consume, device)
        return _one_view_tail(torch.cat(chunks, dim=1), carry[0], carry[1], g, keep, l_row, want)

    g = _sketch_operator(sketch_l, m, like)
    chunks = []

    def consume1(k, win, ext):
        a = win.to(tt)
        if _cuda_sketch.sketch_serviceable(sketch_l, a):
            chunks.append(_cuda_sketch.sketch_with_norm(g, a)[0])
        else:
            chunks.append(_pass1_tiles(g, a))

    staging.stream_windows(host, 1, staging.window_extents((m, n), item, 1, slab), consume1, device)
    qw = _gram_orthonormalize(torch.conj(torch.cat(chunks, dim=1)).T)
    zs = []
    norm = [_real_zero(like)]

    def consume2(k, win, ext):
        z_k, norm[0] = _pass2_tiles(win.to(tt), qw, norm[0])
        zs.append(z_k)

    staging.stream_windows(host, 0, staging.window_extents((m, n), item, 0, slab), consume2, device)
    return _projection_tail(torch.cat(zs, dim=0), qw, norm[0], keep, want)


def _hsvd_rank_host(host, maxrank: int, compute_sv: bool, safetyshift: int, single_pass: bool):
    """``hsvd_rank`` of a ``HostArray`` (``heat_tpu`` svdtools.py:682):
    staged when the gate allows it and the budget admits the sketch; under
    ``HEAT_TPU_OOC=0``, or for a budget that needs the full SVD, the
    operand is materialized whole where it fits the card (else
    ``MemoryError``) and takes the in-memory route. Every rank streams its
    own ``HostArray`` (the same data) and holds the same factors, split
    None."""
    from ...redistribution import staging
    from ..communication import get_comm
    from ..devices import get_device

    m, n = host.shape
    heat_dt = types.canonical_heat_type(host.dtype)
    if types.heat_type_is_exact(heat_dt):
        heat_dt = types.float32
    cap = min(m, n)
    budget = maxrank + safetyshift
    sketch_l = min(budget + _SKETCH_OVERSAMPLE, cap)
    admissible = 4 * sketch_l <= cap
    if not staging.ooc_engaged(host.nbytes, host_resident=True) or not admissible:
        what = "hsvd_rank" if admissible else "hsvd_rank (sketch-inadmissible rank budget needs the full SVD)"
        arr = staging.materialize(host, what=what).astype(heat_dt)
        return hsvd_rank(arr, maxrank, compute_sv=compute_sv, safetyshift=safetyshift, single_pass=single_pass)
    device = get_device()
    comm = get_comm()
    tt = heat_dt.torch_type()
    keep = min(budget, cap)
    r_final = max(1, min(maxrank, keep))
    like = torch.empty((m, 1), dtype=tt, device=device.torch_device)
    ov = _one_view_params(keep, cap, like) if single_pass else None
    res = _staged_sketch_rank(host, keep, sketch_l, "both" if compute_sv else "left", ov, tt, device.torch_device)
    u_t, v_t, s_t, err_t = _truncate_with_err(res, r_final)

    def wrap(t, shape):
        return DNDarray(t, shape, types.canonical_heat_type(t.dtype), None, device, comm)

    U, err = wrap(u_t, (m, r_final)), wrap(err_t, ())
    if not compute_sv:
        return U, err
    return U, wrap(s_t, (int(s_t.shape[0]),)), wrap(v_t, (n, r_final)), err


# --------------------------------------------------------------------- #
# across ranks                                                          #
# --------------------------------------------------------------------- #
def _level0_params(m: int, n: int, p: int, maxrank: Optional[int], safetyshift: int, rtol: Optional[float],
                   single_pass: bool, like: Optional[torch.Tensor] = None):
    """(rloc, lcols, sketch_l, one_view) of the level-0 blocks of an m x n
    operand (oriented: its n columns split over p ranks), from the global
    shape and p alone, as ``heat_tpu`` takes them from its padded blocks
    (svdtools.py:1088-1106): every block counts lcols = ⌈n/p⌉ columns, so a
    short last shard takes the route of the others. ``like`` gives the
    dtype and device for K2's predicate (``_one_view_params``)."""
    lcols = -(-n // p)
    rloc = min(m, lcols)
    if maxrank is not None:
        rloc = min(rloc, maxrank + safetyshift)
    sketch_l = None
    if maxrank is not None and not _needs_exact_spectrum(rtol):
        lmin = min(m, lcols)
        l = min(rloc + _SKETCH_OVERSAMPLE, lmin)
        if 4 * l <= lmin:
            sketch_l = l
    one_view = None
    if single_pass and sketch_l is not None:
        probe = None if like is None else torch.empty((1, 1), dtype=like.dtype, device=like.device)
        one_view = _one_view_params(min(rloc, lcols), min(m, lcols), probe)
    return rloc, lcols, sketch_l, one_view


def _level0(s_loc: torch.Tensor, transposed: bool, rloc: int, lcols: int, sketch_l, one_view, g=None, omega=None):
    """Level 0 on this rank (``heat_tpu``'s ``_local_svd_fn`` kernel,
    svdtools.py:754-779): ``B_r = u·s`` (m x rloc, zero columns past the
    kept rank), the block's discarded energy and its ‖·‖²_F. The block is
    ``s_locᵀ`` when ``transposed`` (the shard of a split-0 operand), else
    ``s_loc``. An empty shard is ``heat_tpu``'s all-zero pad block."""
    m, ncols = (s_loc.shape[1], s_loc.shape[0]) if transposed else tuple(s_loc.shape)
    zero = _real_zero(s_loc)
    if ncols == 0:
        return torch.zeros((m, rloc), dtype=s_loc.dtype, device=s_loc.device), zero, zero
    if sketch_l is not None:
        keep = min(rloc, m, lcols)
        if one_view is not None:
            # K2 cannot take the swapped roles (k̂ would be ℓ + 10 > DUAL_MAX_K): Sᵀ is copied once
            a_blk = s_loc.T.contiguous() if transposed else s_loc
            u, _, s, err_sq, norm_sq = _one_view_uds_both(a_blk, keep, *one_view, "left", g=g, omega=omega)
        elif transposed:
            u, _, s, err_sq, norm_sq = _sketched_uds_swapped(s_loc, keep, sketch_l, "left", g=g)
        else:
            u, _, s, err_sq, norm_sq = _sketched_uds_both(s_loc, keep, sketch_l, "left", g=g)
        b = u * s
    else:
        u, s, _ = safe_svd(s_loc.T if transposed else s_loc, full_matrices=False)
        keep = min(rloc, s.shape[0])
        b = u[:, :keep] * s[:keep]
        err_sq, norm_sq = torch.sum(s[keep:] ** 2), torch.sum(s * s)
    if b.shape[1] < rloc:
        b = torch.cat([b, b.new_zeros((m, rloc - b.shape[1]))], dim=1)
    return b.contiguous(), err_sq, norm_sq


def _merge_svd(B: DNDarray):
    """SVD of the stacked level-0 factors B (m x K, split 1): resplit to
    rows, TSQR, and the SVD of the small (K, K) R, so U = Q·U_R split 0
    (``heat_tpu`` svdtools.py:818). A short-fat B (m < K) is gathered.
    The small SVD's factors are broadcast from rank 0, so that σ and U_R
    are the same bits on every rank. Returns (U, σ)."""
    comm = B.comm
    m, K = B.shape
    if m >= K:
        q, r = qr(B.resplit(0))
        u_r, s, _ = safe_svd(r.larray, full_matrices=False)
        u_r, s = comm.bcast(u_r.contiguous()), comm.bcast(s.contiguous())
        return DNDarray(q.larray @ u_r, (m, int(u_r.shape[1])), q.dtype, 0, B.device, comm), s
    u, s, _ = safe_svd(_whole(B), full_matrices=False)
    u, s = comm.bcast(u.contiguous()), comm.bcast(s.contiguous())
    rows = comm.chunk((m, int(u.shape[1])), 0)[2]
    return DNDarray(u[rows].contiguous(), tuple(u.shape), B.dtype, 0, B.device, comm), s


def _hsvd_distributed(A: DNDarray, dtype, maxrank, rtol, safetyshift: int, compute_sv: bool, single_pass: bool):
    """``_hsvd_impl`` for an operand split across ranks (``heat_tpu``
    svdtools.py:1086-1185): U and V come out split 0."""
    comm = A.comm
    p = comm.size
    transposed = A.split == 0
    m, n = (A.shape[1], A.shape[0]) if transposed else A.shape
    full_rank_cap = min(m, n)
    s_loc = A._balanced_larray().to(dtype.torch_type()).contiguous()
    rloc, lcols, sketch_l, one_view = _level0_params(m, n, p, maxrank, safetyshift, rtol, single_pass, s_loc)
    b, err_sq, norm_sq = _level0(s_loc, transposed, rloc, lcols, sketch_l, one_view)
    sums = comm.allreduce(torch.stack([err_sq, norm_sq]))
    U_merged, s_all = _merge_svd(DNDarray(b, (m, p * rloc), dtype, 1, A.device, comm))
    if rtol is None:
        r_final = max(1, min(maxrank, min(int(s_all.shape[0]), full_rank_cap)))
        err = _err_scalar(
            torch.sqrt(sums[0] + torch.sum(s_all[r_final:] ** 2)) / torch.clamp(torch.sqrt(sums[1]), min=1e-30), A
        )
    else:
        s_host = s_all.cpu().numpy()
        level_err_sq, nrm_sq = (float(x) for x in sums.cpu())
        a_norm = float(np.sqrt(max(nrm_sq, 0.0)))
        r_final = _choose_rank(s_host, maxrank, rtol, a_norm, level_err_sq, full_rank_cap)
        merge_err_sq = float(np.sum(s_host[r_final:] ** 2))
        err = _err_scalar(float(np.sqrt(level_err_sq + merge_err_sq)) / max(a_norm, 1e-30), A)
    u_arr = DNDarray(U_merged.larray[:, :r_final].contiguous(), (m, r_final), dtype, 0, A.device, comm)
    s_t = s_all[:r_final]
    sigma = DNDarray(s_t, (r_final,), types.canonical_heat_type(s_t.dtype), None, A.device, comm)
    if transposed:
        # the left factors of Aᵀ are conj(V) (Aᵀ = conj(V) Σ Uᵀ): complex inputs conjugate on the relabel
        v_of_a = DNDarray(torch.conj(u_arr.larray).resolve_conj(), u_arr.shape, dtype, 0, A.device, comm)
        U = _postprocess_v(A, v_of_a, sigma, left=True)
        return (U, sigma, v_of_a, err) if compute_sv else (U, err)
    if not compute_sv:
        return u_arr, err
    return u_arr, sigma, _postprocess_v(A, u_arr, sigma, left=False), err


def _postprocess_v(A: DNDarray, factor: DNDarray, sigma: DNDarray, left: bool) -> DNDarray:
    """The complementary factor (``heat_tpu`` svdtools.py:1188):
    ``U = A·V/σ`` (``left``) or ``V = Aᴴ·U/σ``, then two rounds of
    Cholesky-QR. The product is split 0, so each round's Gram is the
    ``allreduce``d sum of the ranks' row blocks: without it each rank would
    orthonormalize its own block alone."""
    if left:
        prod = matmul(A, factor)
    else:
        at = transpose(A)
        if types.heat_type_is_complexfloating(A.dtype):
            at = DNDarray(torch.conj(at.larray).resolve_conj(), at.shape, at.dtype, at.split, at.device, at.comm)
        prod = matmul(at, factor)
    s = sigma.larray
    scaled = prod.larray * torch.where(s > 0, 1.0 / s, 0.0)
    scaled = _cholqr2_refine(scaled, prod.comm if prod.is_distributed() else None)
    return DNDarray(scaled, prod.shape, prod.dtype, prod.split, prod.device, prod.comm)
