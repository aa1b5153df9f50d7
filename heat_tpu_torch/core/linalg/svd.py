"""Full SVD (port of ``heat_tpu.core.linalg.svd``).

``svd`` composes the factorizations of this package (``heat_tpu`` svd.py:123):

- ``method="qr"``: a split-0 operand across ranks runs TSQR (``qr.py``: the
  local QR, one all-gather of the R factors, the merge), the SVD of the
  small replicated R, and ``U = Q·U_R`` on each rank's rows. Only the R
  stack moves.
- ``method="polar"``: :func:`~.factorizations.polar` (``A = U_p H``, one
  ``allreduce`` a Newton–Schulz step), then ``eigh`` of the replicated
  ``H = V Σ Vᴴ``, and ``U = U_p V`` on each rank's rows.
- ``method="auto"``: qr while n ≤ ``_TSQR_MAX_N`` (4096), polar past it.

``compute_uv=False`` never forms U or V: the qr route stops at R's singular
values; the polar route takes the square roots of the eigenvalues of the
Gram ``AᴴA`` (one ``allreduce``), which square the condition number. A wide
split-1 operand runs ``svd(Aᵀ)``; another split-1 operand is resplit to 0
by the planner. A whole operand, and any at world size 1, runs the same
two routes on the whole tensor (a wide one through its conjugate
transpose), where ``heat_tpu`` calls XLA's SVD: torch's default SVD on a
card (cuSOLVER's Jacobi) misses ``heat_tpu``'s tolerance, and R's SVD is
the QR iteration (``_lapack.accurate_svd``), H's eigh ``_lapack.accurate_eigh``.

Tolerance (``heat_tpu``'s documented one): for well-conditioned float32
operands the singular values match a float64 SVD to rtol 1e-4 and
``‖A − U Σ Vᴴ‖_F/‖A‖_F ≤ 1e-4``; singular vectors agree up to a phase a
column. ``full_matrices=True`` raises :class:`FullMatricesNotSupported`.
A host-resident ``HostArray`` operand gives its values from one staged
pass of row windows that sums the Gram matrix on the card
(``_svd_host``); its factors are ``hsvd_rank``'s.
"""

from __future__ import annotations

import collections

import torch

from .. import types
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from ._lapack import accurate_eigh, accurate_eigvalsh, accurate_svd, accurate_svdvals

__all__ = ["FullMatricesNotSupported", "svd"]

SVD = collections.namedtuple("SVD", "U, S, Vh")

# the TSQR merge gate (qr.py): past this column count svd takes the polar route
_TSQR_MAX_N = 4096

_METHODS = ("auto", "qr", "polar")


class FullMatricesNotSupported(NotImplementedError):
    """``svd(full_matrices=True)``: the full orthonormal basis is a dense
    m × m (or n × n) replicated factor, which no schedule for a split
    operand can hold. By what the caller needs:

    - rank-truncated factors: ``ht.linalg.hsvd_rank`` / ``ht.linalg.hsvd_rtol``;
    - the column space's spectrum: ``ht.linalg.eigh`` of the Gram or
      covariance matrix;
    - the reduced factors: ``full_matrices=False``.
    """


def _values_dnd(s: torch.Tensor, dtype, ref: DNDarray) -> DNDarray:
    return DNDarray(s, (int(s.shape[0]),), dtype, None, ref.device, ref.comm)


def _gram_svdvals_arr(g: torch.Tensor, tt: torch.dtype) -> torch.Tensor:
    """Descending singular values from a replicated Gram matrix."""
    w = accurate_eigvalsh(g)  # ascending
    return torch.sqrt(torch.clamp(w.flip(0), min=0)).to(tt)


def _host_svdvals(host, tt: torch.dtype) -> torch.Tensor:
    """Descending singular values of a host-resident operand from one
    staged pass of row windows that sums the Gram matrix ``AᴴA`` on the
    card (``heat_tpu`` svd.py:94); the operand never lands whole."""
    from ...redistribution import staging
    from ..devices import get_device

    m, n = (int(s) for s in host.shape)
    device = get_device().torch_device
    acc = torch.zeros((n, n), dtype=tt, device=device)
    item = acc.element_size()
    sched = staging.plan_staged_passes((m, n), torch.empty((), dtype=tt).numpy().dtype, [{"tag": "gram", "axis": 0}],
                                       out_bytes=n * n * item)
    staging.prove_fits(sched)

    def consume(k, win, ext):
        w = win.to(tt)
        acc.add_(w.conj().T @ w)

    staging.stream_windows(host, 0, staging.window_extents((m, n), item, 0, int(sched.staging["slab_bytes"])),
                           consume, device)
    return _gram_svdvals_arr(acc, tt)


def _svd_host(host, full_matrices: bool, compute_uv: bool, method: str):
    """``svd`` of a ``HostArray`` (``heat_tpu`` svd.py:272): the values from
    the staged Gram pass (``_host_svdvals``), whole on every rank; under
    ``HEAT_TPU_OOC=0`` the operand is materialized where it fits. Factors
    of a staged operand take ``hsvd_rank``/``hsvd_rtol``; asking ``svd``
    for them raises."""
    from ...redistribution import staging
    from ..communication import get_comm
    from ..devices import get_device

    dtype = types.canonical_heat_type(host.dtype)
    if types.heat_type_is_exact(dtype):
        dtype = types.float32
    if compute_uv and full_matrices:
        raise FullMatricesNotSupported(
            "svd(full_matrices=True) on a host-resident operand: use full_matrices=False, or "
            "ht.linalg.hsvd_rank/hsvd_rtol for rank-truncated factors"
        )
    if not staging.ooc_engaged(host.nbytes, host_resident=True):
        return svd(staging.materialize(host, what="svd operand"), compute_uv=compute_uv, method=method)
    if compute_uv:
        raise NotImplementedError(
            "svd(compute_uv=True) of a host-resident operand needs a multi-pass factor stream — use "
            "ht.linalg.hsvd_rank/hsvd_rtol (staged 2-pass hierarchical SVD) for out-of-core factors, or "
            "compute_uv=False for the staged values-only Gram pass"
        )
    s = _host_svdvals(host, dtype.torch_type())
    return DNDarray(s, (int(s.shape[0]),), dtype, None, get_device(), get_comm())


def _from_polar(u_p: torch.Tensor, h: torch.Tensor):
    """``(U's rows, σ, Vh)`` from the polar factors (rows of U_p, the
    replicated H): ``H = V Σ Vᴴ`` by eigh, descending, ``U = U_p V``
    (``heat_tpu`` svd.py:247)."""
    from .factorizations import _ct

    w, v = accurate_eigh(h)  # ascending
    v_desc = v.flip(1)
    return u_p @ v_desc, torch.clamp(w.flip(0), min=0).to(u_p.dtype), _ct(v_desc)


def _svd_whole(a: torch.Tensor, use_qr: bool, compute_uv: bool):
    """The SVD of a whole tensor by the route's algorithm: ``(u, s, vh)``,
    or ``s`` without ``compute_uv``."""
    from .factorizations import _POLAR_MAXITER, _ct, _polar_local, _real_eps

    m, n = a.shape
    if m < n:
        out = _svd_whole(_ct(a), use_qr, compute_uv)
        return out if not compute_uv else (_ct(out[2]), out[1], _ct(out[0]))
    if not compute_uv:
        if use_qr:
            return accurate_svdvals(torch.linalg.qr(a, mode="r")[1])
        return _gram_svdvals_arr(_ct(a) @ a, a.dtype)
    if use_qr:
        q, r = torch.linalg.qr(a)
        u_r, s, vh = accurate_svd(r)
        return q @ u_r, s, vh
    return _from_polar(*_polar_local(a, _POLAR_MAXITER, 50.0 * _real_eps(a.dtype)))


def svd(A, full_matrices: bool = False, compute_uv: bool = True, method: str = "auto"):
    """Singular value decomposition ``A = U·diag(S)·Vh`` in reduced form
    (``heat_tpu`` svd.py:123): ``SVD(U, S, Vh)``, or the descending values
    only with ``compute_uv=False``. ``method`` picks the route: ``"qr"``
    (TSQR across ranks, and the SVD of R), ``"polar"`` (Newton–Schulz and
    eigh of H) or ``"auto"`` (qr while n ≤ 4096). Across ranks U comes out
    split 0, S and Vh replicated; a whole operand's factors keep
    ``heat_tpu``'s splits (U split 0 for a split-0 operand, Vh split 1 for a
    split-1 one)."""
    from . import basics
    from .qr import qr as _qr

    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    from ...redistribution import staging

    if isinstance(A, staging.HostArray):
        return _svd_host(A, full_matrices, compute_uv, method)
    sanitize_in(A)
    if A.ndim != 2:
        raise ValueError(f"svd requires a 2-dimensional array, got {A.ndim}")
    dtype = types.float32 if types.heat_type_is_exact(A.dtype) or A.dtype is types.bool else A.dtype
    tt = dtype.torch_type()
    m, n = (int(s) for s in A.shape)
    comm = A.comm
    split_dist = A.split is not None and comm.is_distributed()
    use_qr = method == "qr" or (method == "auto" and n <= _TSQR_MAX_N)
    if compute_uv and full_matrices:
        raise FullMatricesNotSupported(
            "svd(full_matrices=True): the full orthonormal basis is a dense replicated "
            f"({m}, {m}) factor no schedule for a split operand can hold; use full_matrices=False for "
            "the reduced factors, ht.linalg.hsvd_rank/hsvd_rtol for rank-truncated ones, or "
            "ht.linalg.eigh on the Gram matrix for the spectrum"
        )
    if split_dist and A.split == 1 and n > m:  # wide: svd(Aᵀ), the factors swapped
        out = svd(basics.transpose(A), full_matrices=False, compute_uv=compute_uv, method=method)
        return out if not compute_uv else SVD(basics.transpose(out[2]), out[1], basics.transpose(out[0]))
    if not split_dist or m < n:
        res = _svd_whole(basics._whole(A).to(tt), use_qr, compute_uv)
        if not compute_uv:
            return _values_dnd(res, dtype, A)
        u, s, vh = res
        return SVD(basics._from_whole(u, 0 if A.split == 0 else None, A), _values_dnd(s, dtype, A),
                   basics._from_whole(vh, 1 if A.split == 1 else None, A))
    a0 = A if A.split == 0 else A.resplit(0)
    a0 = a0 if a0.dtype is dtype else a0.astype(dtype)
    if not compute_uv:
        if use_qr:
            return _values_dnd(accurate_svdvals(_qr(a0, calc_q=False).R.larray), dtype, A)
        from .factorizations import _ring_xhy

        return _values_dnd(_gram_svdvals_arr(_ring_xhy(a0, a0), tt), dtype, A)
    if use_qr:
        q, r = _qr(a0, calc_q=True)
        u_r, s, vh = accurate_svd(r.larray)
        u_loc = q._balanced_larray() @ u_r
    else:
        from .factorizations import polar

        u_p, h = polar(a0)
        u_loc, s, vh = _from_polar(u_p.larray, h.larray)
    U = DNDarray(u_loc, (m, int(u_loc.shape[1])), dtype, 0, A.device, comm)
    return SVD(U, _values_dnd(s, dtype, A), DNDarray(vh, tuple(vh.shape), dtype, None, A.device, comm))
