"""Statistical operations (port of ``heat_tpu.core.statistics``; Heat
reference: heat/core/statistics.py).

``heat_tpu`` hands every function here the whole logical array and lets
XLA place the collectives. The port states its schedule over the shards:

- ``max``/``min`` reduce each shard and combine the ranks' partials with
  one ``allgather`` (so that a NaN on any rank wins, as in ``jnp.max``);
- ``argmax``/``argmin`` over the split axis: each rank sends its local
  winner and its global index, and every rank picks from one all-gather,
  ties to the lowest global index and a NaN winning, the first NaN among
  NaNs (``jnp.argmax``'s order; the reference's value∥index MPI op);
- ``mean``, ``var``, ``std``, ``skew`` and ``kurtosis``: sums of the shard
  and one ``allreduce`` a moment, the mean first (two passes, as
  ``jnp.var`` centers);
- ``percentile``/``median`` along the split axis sort the values across
  ranks without gathering them (``core/parallel.py::distributed_sort``,
  values only; K4 sorts each rank's block on a card) and fetch only the
  bracketing elements from their owners, in one small all-gather; along
  another axis each shard sorts its lanes alone (``kernels.sort.sorted_lanes``,
  K4 on a card, lanes longer than 4096 as one segment of (lane, value)
  pairs), never through ``torch.quantile``, which refuses inputs over 2^24
  elements;
- ``bincount``, ``histc`` and ``histogram`` count each shard and add the
  counts with one ``allreduce`` (the range from one more where it is not
  given); ``bucketize`` and ``digitize`` are elementwise and keep the
  split; ``cov`` gathers its (small) operand.

Result types are ``heat_tpu``'s: integers and bools take float32 in the
moments and percentiles, float16 and bfloat16 accumulate in float32 and
come back in their own type, the variance of complex values is real, an
unbiased ``skew`` is float64 (numpy's ``sqrt`` of the count is float64).
"""

from __future__ import annotations

import builtins
from typing import Optional

import numpy as np
import torch

from . import _operations
from . import types
from .dndarray import DNDarray
from .sanitation import sanitize_in
from .stride_tricks import sanitize_axis

__all__ = [
    "argmax",
    "argmin",
    "average",
    "bincount",
    "bucketize",
    "cov",
    "digitize",
    "histc",
    "histogram",
    "kurtosis",
    "max",
    "maximum",
    "mean",
    "median",
    "min",
    "minimum",
    "percentile",
    "skew",
    "std",
    "var",
]

_INTERPOLATIONS = ("linear", "lower", "higher", "midpoint", "nearest")


def _axes(x: DNDarray, axis):
    """The reduced axes as a tuple (every axis for None)."""
    if axis is None:
        return tuple(range(x.ndim))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _count(x: DNDarray, axis) -> int:
    """Number of elements reduced over ``axis``."""
    return int(np.prod([x.gshape[a] for a in _axes(x, axis)], dtype=np.int64))


def _replicated(t: torch.Tensor, ref: DNDarray) -> DNDarray:
    """A DNDarray of ``t``, the same whole tensor on every rank."""
    return DNDarray(t, tuple(t.shape), types.canonical_heat_type(t.dtype), None, ref.device, ref.comm)


def _float_of(x: DNDarray) -> torch.dtype:
    """The type ``heat_tpu`` computes the moments of ``x`` in: float32 for
    bools and integers."""
    tt = x.larray.dtype
    return tt if (tt.is_floating_point or tt.is_complex) else torch.float32


def _accumulator(tt: torch.dtype) -> torch.dtype:
    return torch.float32 if tt in (torch.float16, torch.bfloat16) else tt


# --------------------------------------------------------------------- #
# extremes                                                              #
# --------------------------------------------------------------------- #
def _least(tt: torch.dtype, largest: bool):
    """The value that loses every comparison of a max (``largest``) or min."""
    if tt == torch.bool:
        return not largest
    if tt.is_floating_point:
        return -float("inf") if largest else float("inf")
    info = torch.iinfo(tt)
    return info.min if largest else info.max


def _reduce_shape(t: torch.Tensor, axes, keepdims: bool):
    return [1 if i in axes else s for i, s in enumerate(t.shape)] if keepdims else [
        s for i, s in enumerate(t.shape) if i not in axes]


def _extreme(t: torch.Tensor, axes, keepdims: bool, largest: bool) -> torch.Tensor:
    """max or min of a shard over ``axes`` (NaN propagates; complex values
    by real part, then imaginary part); an empty shard gives the value
    that loses."""
    if t.is_complex():
        re = _extreme(t.real, axes, True, largest)
        im = torch.where(t.real == re, t.imag, torch.tensor(_least(t.real.dtype, largest), dtype=t.real.dtype))
        res = torch.complex(re, _extreme(im, axes, True, largest))
        return res if keepdims else res.reshape(_reduce_shape(t, axes, False))
    if any(t.shape[a] == 0 for a in axes):
        return torch.full(_reduce_shape(t, axes, keepdims), _least(t.dtype, largest), dtype=t.dtype, device=t.device)
    fn = torch.amax if largest else torch.amin
    return fn(t, dim=axes, keepdim=keepdims)


def _gathered_extreme(largest: bool):
    def combine(comm, t: torch.Tensor) -> torch.Tensor:
        return _extreme(comm.allgather(t.unsqueeze(0), 0), (0,), False, largest)

    return combine


def max(x: DNDarray, axis=None, out=None, keepdims=None) -> DNDarray:
    """Maximum along ``axis`` (reference: statistics.py max); NaN wins."""
    if x.size == 0 and (axis is None or any(x.gshape[a] == 0 for a in _axes(x, sanitize_axis(x.shape, axis)))):
        raise ValueError("zero-size array to reduction operation max which has no identity")
    return _operations.__reduce_op(lambda t, axes, k: _extreme(t, axes, k, True), x, axis=axis, out=out,
                                   keepdims=builtins.bool(keepdims), combine=_gathered_extreme(True))


def min(x: DNDarray, axis=None, out=None, keepdims=None) -> DNDarray:
    """Minimum along ``axis``; NaN wins."""
    if x.size == 0 and (axis is None or any(x.gshape[a] == 0 for a in _axes(x, sanitize_axis(x.shape, axis)))):
        raise ValueError("zero-size array to reduction operation min which has no identity")
    return _operations.__reduce_op(lambda t, axes, k: _extreme(t, axes, k, False), x, axis=axis, out=out,
                                   keepdims=builtins.bool(keepdims), combine=_gathered_extreme(False))


def _elementwise_extreme(largest: bool):
    """``jnp.maximum``/``minimum`` of two operands: NaN propagates; complex
    values by real part, then imaginary part."""

    def op(a, b):
        a, b = _operations.operands(a, b)
        dt = a.dtype
        if dt.is_complex:
            gt = (a.real > b.real) | ((a.real == b.real) & (a.imag > b.imag))
            lt = (a.real < b.real) | ((a.real == b.real) & (a.imag < b.imag))
            return torch.where(gt if largest else lt, a, b)
        if dt == torch.bool:
            return torch.logical_or(a, b) if largest else torch.logical_and(a, b)
        return torch.maximum(a, b) if largest else torch.minimum(a, b)

    return op


def maximum(x1, x2, out=None) -> DNDarray:
    """Elementwise maximum (reference: statistics.py maximum)."""
    return _operations.__binary_op(_elementwise_extreme(True), x1, x2, out)


def minimum(x1, x2, out=None) -> DNDarray:
    """Elementwise minimum."""
    return _operations.__binary_op(_elementwise_extreme(False), x1, x2, out)


# --------------------------------------------------------------------- #
# argmax / argmin                                                       #
# --------------------------------------------------------------------- #
def _first_winner(t: torch.Tensor, dim: int, largest: bool):
    """(value, index) of the first extreme along ``dim`` of a non-empty
    ``t``: a NaN wins, the first NaN among NaNs, else the first of the
    tied extremes (``jnp.argmax``'s order). ATen's argmax/argmin take the
    first of tied extremes and some NaN of a lane that holds one, in one
    pass; a lane whose winner is NaN then takes its first NaN."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    idx = (torch.argmax if largest else torch.argmin)(t, dim=dim)
    value = torch.gather(t, dim, idx.unsqueeze(dim)).squeeze(dim)
    if t.is_floating_point():
        nan = torch.isnan(value)
        if builtins.bool(nan.any()):
            idx = torch.where(nan, torch.argmax(torch.isnan(t).to(torch.uint8), dim=dim), idx)
    return value, idx


def _beats(v: torch.Tensor, best: torch.Tensor, largest: bool) -> torch.Tensor:
    """Where a later candidate ``v`` takes the place of ``best``: strictly
    better, or a NaN where ``best`` is not (a tie keeps the earlier)."""
    better = v > best if largest else v < best
    if v.is_floating_point():
        better = (better & ~torch.isnan(best)) | (torch.isnan(v) & ~torch.isnan(best))
    return better


def _arg(x: DNDarray, axis, out, keepdims: bool, largest: bool) -> DNDarray:
    sanitize_in(x)
    if x.larray.is_complex():
        raise TypeError(f"{'argmax' if largest else 'argmin'} does not accept dtype {x.dtype.__name__}")
    axis = sanitize_axis(x.shape, axis)
    if x.size == 0 or (axis is not None and x.gshape[axis] == 0):
        raise ValueError("attempt to get argmax of an empty sequence")
    t = x.larray
    comm = x.comm
    across = x.is_distributed() and (axis is None or axis == x.split)
    if axis is None:
        flat_shape = (x.size,)
        dim = 0
        local = t.reshape(-1)
    else:
        dim, local = axis, t
    if local.shape[dim]:
        value, idx = _first_winner(local, dim, largest)
    else:
        shape = [s for i, s in enumerate(local.shape) if i != dim]
        value = torch.zeros(shape, dtype=local.dtype if local.dtype != torch.bool else torch.uint8, device=t.device)
        idx = torch.zeros(shape, dtype=torch.int64, device=t.device)
    idx = idx.to(torch.int64)
    if across:
        counts, displs = x.counts_displs()
        if axis is None:  # a flat index of the shard into the global array
            lshape = t.shape
            multi = np.unravel_index(idx.cpu().numpy(), lshape) if t.numel() else (np.zeros(0),) * t.ndim
            multi = [int(m) + (displs[comm.rank] if i == x.split else 0) for i, m in enumerate(multi)]
            idx = torch.tensor(int(np.ravel_multi_index(multi, x.gshape)) if t.numel() else 0, device=t.device)
        else:
            idx = idx + displs[comm.rank]
        # one all-gather of each rank's (winners, their indices, whether it holds rows) as bytes
        held = torch.tensor([[builtins.bool(local.shape[dim])]], dtype=torch.uint8, device=t.device)
        parts = [value.reshape(1, -1).contiguous(), idx.reshape(1, -1).contiguous()]
        row = torch.cat([p.view(torch.uint8).reshape(1, -1) for p in parts] + [held], dim=1)
        every = comm.allgather(row, 0)
        width = parts[0].numel() * parts[0].element_size()
        values = every[:, :width].contiguous().view(value.dtype).reshape((comm.size,) + tuple(value.shape))
        indices = every[:, width:-1].contiguous().view(torch.int64).reshape((comm.size,) + tuple(idx.shape))
        helds = every[:, -1].tolist()
        first = helds.index(1)
        best_v, best_i = values[first], indices[first]
        for q in range(first + 1, comm.size):
            if helds[q]:
                take = _beats(values[q], best_v, largest)
                best_v = torch.where(take, values[q], best_v)
                best_i = torch.where(take, indices[q], best_i)
        idx = best_i
    if axis is None:
        split, gshape = None, ((1,) * x.ndim if keepdims else ())
        idx = idx.reshape(gshape)
        lmap = None
    else:
        if keepdims:
            idx = idx.unsqueeze(axis)
        gshape = tuple(1 if i == axis else s for i, s in enumerate(x.gshape)) if keepdims else tuple(
            s for i, s in enumerate(x.gshape) if i != axis)
        split = _operations._output_split(x.split, (axis,), False, keepdims)
        lmap = None
        if split is not None:
            lmap = x.lshape_map
            lmap = lmap.copy() if keepdims else np.delete(lmap, [axis], axis=1)
            if keepdims:
                lmap[:, axis] = 1
    res = DNDarray(idx, gshape, types.int64, split, x.device, comm, lmap)
    if out is not None:
        return _operations._store(out, res)
    return res


def argmax(x: DNDarray, axis: Optional[int] = None, out=None, **kwargs) -> DNDarray:
    """Indices of the maximum values (int64): the first of tied maxima, a
    NaN before any number, the first NaN among NaNs (reference:
    statistics.py argmax, an MPI value∥index op; here one all-gather of
    each rank's winner over the split axis)."""
    return _arg(x, axis, out, builtins.bool(kwargs.get("keepdims", False)), True)


def argmin(x: DNDarray, axis: Optional[int] = None, out=None, **kwargs) -> DNDarray:
    """Indices of the minimum values (int64), ordered as ``argmax``'s."""
    return _arg(x, axis, out, builtins.bool(kwargs.get("keepdims", False)), False)


# --------------------------------------------------------------------- #
# moments                                                               #
# --------------------------------------------------------------------- #
def _mean(x: DNDarray, axis, keepdims: bool, tt: torch.dtype) -> DNDarray:
    """The mean over ``axis`` in ``tt`` (its sum in ``tt``'s accumulator,
    one ``allreduce`` over the split axis)."""
    n = _count(x, axis)
    acc = _accumulator(tt)

    def partial(t, axes, k):
        return torch.sum(t.to(acc), dim=axes, keepdim=k)

    return _operations.__reduce_op(partial, x, axis=axis, keepdims=keepdims, finish=lambda s: (s / n).to(tt))


def mean(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Arithmetic mean (reference: statistics.py:892): the shard's sum and
    one ``allreduce`` when the split axis is reduced."""
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    return _mean(x, axis, builtins.bool(keepdims), _float_of(x))


def _centered_moment(x: DNDarray, axis, power: int, mu: DNDarray) -> DNDarray:
    """mean((x − mu)^power) over ``axis`` (mu kept along the reduced axes,
    so that this rank's part of it meets this rank's shard), as
    ``heat_tpu``'s ``__moments`` takes it for skew and kurtosis."""
    n = _count(x, axis)
    tt = mu.larray.dtype
    acc = _accumulator(tt)
    m = mu.larray.to(acc)

    def partial(t, axes, k):
        return torch.sum((t.to(acc) - m) ** power, dim=axes, keepdim=k)

    return _operations.__reduce_op(partial, x, axis=axis, finish=lambda s: (s / n).to(tt))


def var(x: DNDarray, axis=None, ddof: int = 0, **kwargs) -> DNDarray:
    """Variance (reference: statistics.py:1851): the mean first (one
    ``allreduce``), then the mean of the squared deviations (one more);
    real for complex values."""
    sanitize_in(x)
    if not isinstance(ddof, int):
        raise ValueError(f"ddof must be integer, is {type(ddof)}")
    if ddof < 0:
        raise ValueError(f"Expected ddof >= 0, got {ddof}")
    bessel = kwargs.get("bessel", None)
    if bessel is not None:
        ddof = 1 if bessel else 0
    axis = sanitize_axis(x.shape, axis)
    return _variance(x, axis, builtins.bool(kwargs.get("keepdims", False)), ddof)


def _variance(x: DNDarray, axis, keepdims: bool, ddof: int) -> DNDarray:
    """Σ |x − mean|² / (n − ddof) over ``axis``, in one pass over each
    shard: its mean and Σ |x − its mean|² (``torch.var_mean``), merged
    over the ranks from one all-gather when the split axis is reduced
    (Chan, Golub and LeVeque's pairwise update; the reference's Welford
    merge, statistics.py:1224). Real for complex values."""
    tt = _float_of(x)
    acc = _accumulator(tt)
    out_tt = tt.to_real() if tt.is_complex else tt
    n = _count(x, axis)

    def partial(t, axes, k):
        t = t.to(acc)
        cnt = int(np.prod([t.shape[a] for a in axes], dtype=np.int64))
        if cnt and axes:
            var, mu = torch.var_mean(t, dim=axes, correction=0, keepdim=True)
        else:
            mu = torch.zeros([1 if i in axes else e for i, e in enumerate(t.shape)], dtype=t.dtype,
                             device=t.device) if not cnt else t.clone()
            var = mu.real.abs() * 0
        packed = torch.stack([mu, (var * cnt).to(mu.dtype)])
        return packed if k else packed.squeeze(tuple(a + 1 for a in axes))

    def merge(comm, packed):
        every = comm.allgather(packed.unsqueeze(0).contiguous(), 0)  # (p, 2, ...)
        counts = [int(np.prod([c[a] for a in _axes(x, axis)], dtype=np.int64)) for c in x.lshape_map]
        shape = (len(counts),) + (1,) * (every.ndim - 2)
        cnt = torch.tensor(counts, dtype=torch.float64, device=every.device).reshape(shape).to(every.real.dtype)
        mus, m2s = every[:, 0], every[:, 1].real
        mu = (mus * cnt).sum(0) / builtins.max(builtins.sum(counts), 1)
        m2 = (m2s + cnt * (mus - mu).abs() ** 2).sum(0)
        return torch.stack([mu, m2.to(mu.dtype)])

    def finish(packed):
        return (packed[1].real / builtins.max(n - ddof, 0)).to(out_tt)

    return _operations.__reduce_op(partial, x, axis=axis, keepdims=keepdims, combine=merge, finish=finish)


def std(x: DNDarray, axis=None, ddof: int = 0, **kwargs) -> DNDarray:
    """Standard deviation: the square root of ``var``."""
    from . import exponential

    return exponential.sqrt(var(x, axis, ddof, **kwargs))


def skew(x: DNDarray, axis: Optional[int] = None, unbiased: bool = True) -> DNDarray:
    """Sample skewness m3 / m2^1.5, times sqrt(n(n − 1)) / (n − 2) when
    ``unbiased`` (reference: statistics.py skew)."""
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    n = _count(x, axis)
    mu = _mean(x, axis, True, _float_of(x))
    m2 = _centered_moment(x, axis, 2, mu).larray
    m3 = _centered_moment(x, axis, 3, mu)
    g1 = m3.larray / m2.to(m3.larray.dtype) ** 1.5
    if unbiased:  # numpy's float64 sqrt makes the result float64
        g1 = g1.to(torch.complex128 if g1.is_complex() else torch.float64) * (np.sqrt(n * (n - 1)) / (n - 2))
    return DNDarray(g1, m3.gshape, types.canonical_heat_type(g1.dtype), m3.split, m3.device, m3.comm,
                    m3.lshape_map if m3.split is not None else None)


def kurtosis(x: DNDarray, axis: Optional[int] = None, unbiased: bool = True, Fischer: bool = True) -> DNDarray:
    """Kurtosis m4 / m2², bias-corrected when ``unbiased``, less 3 under
    Fisher's definition (reference: statistics.py kurtosis)."""
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    n = _count(x, axis)
    mu = _mean(x, axis, True, _float_of(x))
    m2 = _centered_moment(x, axis, 2, mu).larray
    m4 = _centered_moment(x, axis, 4, mu)
    g2 = m4.larray / m2.to(m4.larray.dtype) ** 2
    if unbiased:
        result = ((n - 1) / ((n - 2) * (n - 3))) * ((n + 1) * g2 - 3 * (n - 1))
        if not Fischer:
            result = result + 3
    else:
        result = g2 - 3 if Fischer else g2
    return DNDarray(result, m4.gshape, m4.dtype, m4.split, m4.device, m4.comm,
                    m4.lshape_map if m4.split is not None else None)


def average(x: DNDarray, axis=None, weights: Optional[DNDarray] = None, returned: bool = False):
    """Weighted average Σ x·w / Σ w over ``axis`` (reference: statistics.py
    average). 1-D weights along ``axis`` broadcast against ``x`` (taken
    whole: each rank slices the rows it needs)."""
    from . import arithmetics

    sanitize_in(x)
    if weights is None:
        result = mean(x, axis)
        if returned:
            n = _count(x, sanitize_axis(x.shape, axis))
            wsum = torch.full(result.lshape, float(n), dtype=result.larray.dtype, device=result.larray.device)
            return result, DNDarray(wsum, result.gshape, result.dtype, result.split, result.device, result.comm,
                                    result.lshape_map if result.split is not None else None)
        return result
    sanitize_in(weights)
    axis_s = sanitize_axis(x.shape, axis)
    arr = x if _float_of(x) == x.larray.dtype else x.astype(types.float32)
    w = weights
    if w.ndim != arr.ndim and axis_s is not None and isinstance(axis_s, int):
        if w.shape != (x.shape[axis_s],):
            raise ValueError("Length of weights not compatible with specified axis.")
        shape = [1] * arr.ndim
        shape[axis_s] = w.shape[0]
        w = _replicated(_operations._whole(w).reshape(shape), x)
    ones = _operations.__local_op(torch.ones_like, arr, no_cast=True)
    wsum = arithmetics.sum(arithmetics.mul(w, ones), axis=axis_s)
    from .logical import any as _any

    if builtins.bool(_any(wsum == 0).larray.item()):
        raise ZeroDivisionError("Weights sum to zero, can't be normalized")
    result = arithmetics.div(arithmetics.sum(arithmetics.mul(arr, w), axis=axis_s), wsum)
    if returned:
        return result, wsum.astype(wsum.dtype)
    return result


# --------------------------------------------------------------------- #
# percentiles                                                           #
# --------------------------------------------------------------------- #
def _host_q(q) -> np.ndarray:
    """``q`` as a float64 host array (a DNDarray or tensor is read once)."""
    if isinstance(q, DNDarray):
        q = q.numpy()
    elif isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    return np.asarray(q, dtype=np.float64)


def _lane_quantiles(s: torch.Tensor, qv: np.ndarray, dim: int, method: str) -> torch.Tensor:
    """``jnp.quantile`` of lanes already sorted along ``dim`` (NaN last), q
    along a new leading axis: positions q·(n − 1) in float64, linear
    interpolation in float64 then rounded to the lanes' type, ``nearest``
    the lower element up to half way; a lane holding a NaN gives NaN."""
    n = s.shape[dim]
    pos = torch.tensor(qv / 100.0, dtype=torch.float64) * (n - 1)
    low = torch.floor(pos).clamp(0, n - 1)
    high = torch.ceil(pos).clamp(0, n - 1)
    hw = pos - low
    lw = 1.0 - hw
    lo_v = torch.index_select(s, dim, low.to(torch.int64).to(s.device)).movedim(dim, 0)
    hi_v = torch.index_select(s, dim, high.to(torch.int64).to(s.device)).movedim(dim, 0)
    shape = (len(qv),) + (1,) * (lo_v.ndim - 1)
    if method == "linear":
        res = (lo_v.double() * lw.reshape(shape).to(s.device) + hi_v.double() * hw.reshape(shape).to(s.device)).to(
            s.dtype)
    elif method == "lower":
        res = lo_v
    elif method == "higher":
        res = hi_v
    elif method == "nearest":
        res = torch.where((hw <= 0.5).reshape(shape).to(s.device), lo_v, hi_v)
    else:
        res = (lo_v + hi_v) * 0.5
    if s.is_floating_point() and n:
        last = s.narrow(dim, n - 1, 1).movedim(dim, 0)
        res = torch.where(torch.isnan(last), torch.tensor(float("nan"), dtype=res.dtype, device=res.device), res)
    return res


def _split_quantiles(x: DNDarray, qv: np.ndarray, axis: int, method: str) -> torch.Tensor:
    """``heat_tpu``'s percentile along the split axis across ranks
    (statistics.py:387-431): the values sorted by ``distributed_sort``
    (values only), then the elements at the bracketing positions, and
    the last (a NaN there makes the lane NaN), fetched from their owners
    in one all-gather; linear interpolation in the values' type."""
    from . import _padding, parallel
    from ..kernels import sort as _ksort

    comm = x.comm
    p, r = comm.size, comm.rank
    n = x.gshape[axis]
    block = -(-n // p)
    t = x.larray
    padded = _padding.pad_to(x._balanced_larray(), axis, block, _ksort.sentinel(t.dtype))
    sv = parallel.distributed_sort(padded, comm, axis, with_indices=False)
    if types.heat_type_is_exact(x.dtype):
        sv = sv.to(torch.float32)
    pos = qv / 100.0 * (n - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    near = np.rint(pos).astype(np.int64)
    wanted = np.unique(np.concatenate([lo, hi, near, [n - 1]]))
    owner = wanted // block
    mine = torch.tensor(np.where(owner == r, wanted - r * block, 0), dtype=torch.int64, device=t.device)
    rows = torch.index_select(sv, axis, mine).movedim(axis, 0).contiguous()
    everyone = comm.allgather(rows.unsqueeze(0), 0)  # (p, len(wanted), lanes...)
    fetched = everyone[torch.tensor(owner, device=t.device), torch.arange(len(wanted), device=t.device)]
    at = {int(k): i for i, k in enumerate(wanted)}

    def take(ks):
        return fetched[torch.tensor([at[int(k)] for k in ks], device=t.device)]

    vlo, vhi = take(lo), take(hi)
    if method == "lower":
        res = vlo
    elif method == "higher":
        res = vhi
    elif method == "midpoint":
        res = (vlo + vhi) / 2
    elif method == "nearest":
        res = take(near)
    else:
        frac = torch.tensor(pos - lo, device=t.device).to(vlo.dtype).reshape((len(qv),) + (1,) * (vlo.ndim - 1))
        res = vlo + frac * (vhi - vlo)
    if res.is_floating_point():
        last = take([n - 1])
        res = torch.where(torch.isnan(last), torch.tensor(float("nan"), dtype=res.dtype, device=res.device), res)
    return res


def percentile(
    x: DNDarray,
    q,
    axis: Optional[int] = None,
    out=None,
    interpolation: str = "linear",
    keepdims: bool = False,
) -> DNDarray:
    """The q-th percentiles along ``axis`` (reference: statistics.py:1407;
    ``heat_tpu`` :355), for every interpolation of ``jnp.percentile``.
    ``q`` is a host value (a number or a sequence; a DNDarray is read).
    The q axis comes first where ``q`` is a sequence.

    Along the split axis across ranks, the values are sorted by
    ``distributed_sort`` without gathering them and only the bracketing
    elements are fetched (``heat_tpu``'s interpolation there: linear in
    the values' type, ``nearest`` rounding half to even); along another
    axis each rank sorts its lanes (``kernels.sort.sorted_lanes``: K4 on a
    card for float32/int32)."""
    from ..kernels import sort as _ksort

    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    if interpolation not in _INTERPOLATIONS:
        raise ValueError(f"unknown interpolation {interpolation}")
    q_host = _host_q(q)
    scalar_q = q_host.ndim == 0
    qv = np.atleast_1d(q_host)
    if np.any(qv < 0.0) or np.any(qv > 100.0):
        raise ValueError("percentiles must be in the range [0, 100]")
    if x.larray.is_complex():
        raise ValueError("quantile does not support complex input, as the operation is poorly defined.")
    eff_axis = 0 if axis is None and x.ndim == 1 else axis
    comm = x.comm
    split = None
    if eff_axis is not None and x.split == eff_axis and x.is_distributed():
        res = _split_quantiles(x, qv, eff_axis, interpolation)
        if scalar_q:
            res = res[0]
        if keepdims:
            res = res.unsqueeze((axis if axis is not None else 0) + (0 if scalar_q else 1))
    else:
        t = x.larray
        if eff_axis is None:  # every axis: the flattened array, whole
            t = _operations._whole(x).reshape(-1)
            dim = 0
        else:
            dim = eff_axis
        if not (t.is_floating_point()):
            t = t.to(torch.float32)
        s = _ksort.sorted_lanes(t, axis=dim)
        res = _lane_quantiles(s, qv, dim, interpolation)
        if keepdims:
            res = res.unsqueeze(1 + dim) if eff_axis is not None else res.reshape((len(qv),) + (1,) * x.ndim)
        if scalar_q:
            res = res[0]
            if eff_axis is not None and x.split is not None and x.split != eff_axis:
                split = x.split if keepdims else x.split - (x.split > eff_axis)
        elif eff_axis is not None and x.is_distributed():  # a q axis first: the result goes whole
            at = 1 + (x.split if keepdims else x.split - (x.split > eff_axis))
            res = comm.allgather(res.contiguous(), at, x.lshape_map[:, x.split])
    if split is not None and x.is_distributed():
        lmap = x.lshape_map
        if not keepdims:
            lmap = np.delete(lmap, [eff_axis], axis=1)
        else:
            lmap[:, eff_axis] = 1
        gshape = list(res.shape)
        gshape[split] = int(lmap[:, split].sum())
        ret = DNDarray(res, tuple(gshape), types.canonical_heat_type(res.dtype), split, x.device, comm, lmap)
    else:
        ret = DNDarray(res, tuple(res.shape), types.canonical_heat_type(res.dtype), split, x.device, comm)
    if out is not None:
        return _operations._store(out, ret)
    return ret


def median(x: DNDarray, axis: Optional[int] = None, keepdims: bool = False) -> DNDarray:
    """The median: the 50th percentile (reference: statistics.py:1018;
    ``heat_tpu`` :338)."""
    return percentile(x, 50.0, axis=axis, keepdims=keepdims)


# --------------------------------------------------------------------- #
# counts and bins                                                       #
# --------------------------------------------------------------------- #
def _range_of(x: DNDarray, tt: torch.dtype):
    """(min, max) of every element of ``x`` as Python floats (one
    all-gather of each rank's pair)."""
    t = x.larray.to(tt)
    if t.numel():
        pair = torch.stack([t.min(), t.max()]).double()
    else:
        pair = torch.tensor([float("inf"), -float("inf")], dtype=torch.float64, device=t.device)
    if x.is_distributed():
        every = x.comm.allgather(pair.unsqueeze(0), 0)
        pair = torch.stack([every[:, 0].min(), every[:, 1].max()])
    return float(pair[0]), float(pair[1])


def _summed(x: DNDarray, t: torch.Tensor) -> torch.Tensor:
    """``t`` added over the ranks where ``x`` is distributed."""
    return x.comm.allreduce(t) if x.is_distributed() else t


def _weights_of(x: DNDarray, weights) -> Optional[torch.Tensor]:
    """The part of ``weights`` (shaped like ``x``) that meets this rank's
    shard of ``x``."""
    if weights is None:
        return None
    if not isinstance(weights, DNDarray):
        weights = _operations._as_dndarray(weights, x)
    counts = displs = None
    if x.is_distributed():
        counts, displs = x.counts_displs()
    return _operations._local_operand(weights, x.ndim, x.split, counts, displs)


def bincount(x: DNDarray, weights: Optional[DNDarray] = None, minlength: int = 0) -> DNDarray:
    """Occurrences of each non-negative integer (reference: statistics.py
    bincount): each rank counts its shard and one ``allreduce`` adds the
    counts; the length comes from the global maximum."""
    sanitize_in(x)
    if x.ndim != 1:
        raise ValueError("bincount expects a 1-d array")
    t = x.larray
    if t.is_floating_point() or t.is_complex():
        raise TypeError(f"x argument to bincount must have an integer type, got {x.dtype.__name__}")
    lo, hi = _range_of(x, torch.int64) if x.size else (0, -1)
    if x.size and lo < 0:
        raise ValueError("bincount requires non-negative input values")
    length = builtins.max(int(hi) + 1, minlength)
    w = _weights_of(x, weights)
    counts = torch.bincount(t.to(torch.int64), weights=w, minlength=length)
    if w is None:
        counts = counts.to(torch.int64)
    return _replicated(_summed(x, counts), x)


def bucketize(input: DNDarray, boundaries, out_int32: bool = False, right: bool = False, out=None) -> DNDarray:
    """Index of the bucket of each element among the sorted ``boundaries``
    (torch semantics; reference: statistics.py bucketize); elementwise,
    the split kept."""
    sanitize_in(input)
    b = _operations._whole(boundaries) if isinstance(boundaries, DNDarray) else torch.as_tensor(
        np.asarray(boundaries), device=input.larray.device)
    tt = types.promote_types(input.dtype, types.canonical_heat_type(b.dtype)).torch_type()
    idx = torch.bucketize(input.larray.to(tt), b.to(tt), out_int32=out_int32, right=right)
    res = DNDarray(idx, input.gshape, types.canonical_heat_type(idx.dtype), input.split, input.device, input.comm,
                   input.lshape_map if input.split is not None else None)
    if out is not None:
        return _operations._store(out, res)
    return res


def digitize(x: DNDarray, bins, right: bool = False) -> DNDarray:
    """Index of the bin of each value (numpy semantics, increasing or
    decreasing ``bins``; reference: statistics.py digitize); elementwise,
    the split kept."""
    sanitize_in(x)
    b = _operations._whole(bins) if isinstance(bins, DNDarray) else torch.as_tensor(np.asarray(bins),
                                                                                     device=x.larray.device)
    tt = types.promote_types(x.dtype, types.canonical_heat_type(b.dtype)).torch_type()
    t, b = x.larray.to(tt), b.to(tt)
    if b.numel() > 1 and bool(b[-1] < b[0]):
        idx = b.numel() - torch.searchsorted(b.flip(0), t.contiguous(), right=not right)
    else:
        idx = torch.searchsorted(b, t.contiguous(), right=not right)
    idx = idx.to(torch.int64)
    return DNDarray(idx, x.gshape, types.int64, x.split, x.device, x.comm,
                    x.lshape_map if x.split is not None else None)


def _linspace(lo: float, hi: float, num: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``jnp.linspace``'s points in ``dtype``: lo·(1 − s) + hi·s with s =
    i/(num − 1) in ``dtype``, the last point ``hi`` itself."""
    lo_t = torch.tensor(lo, dtype=dtype, device=device)
    hi_t = torch.tensor(hi, dtype=dtype, device=device)
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) / div
    return torch.cat([lo_t * (1 - step) + hi_t * step, hi_t.reshape(1)])


def _histogram_counts(t: torch.Tensor, edges: torch.Tensor, w: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """``jnp.histogram``'s counts of a shard: bin i holds edges[i] ≤ v <
    edges[i + 1], the last bin its right edge too; values outside (and
    NaN) count nowhere."""
    t = t.reshape(-1)
    idx = torch.searchsorted(edges, t.to(edges.dtype).contiguous(), right=True)
    idx = torch.where(t.to(edges.dtype) == edges[-1], torch.tensor(len(edges) - 1, device=t.device), idx)
    keep = (idx >= 1) & (idx <= len(edges) - 1)
    weights = torch.ones_like(t, dtype=dtype) if w is None else w.reshape(-1).to(dtype)
    counts = torch.zeros(len(edges) - 1, dtype=dtype, device=t.device)
    return counts.index_add_(0, (idx[keep] - 1), weights[keep])


def histc(input: DNDarray, bins: int = 100, min: float = 0.0, max: float = 0.0, out=None) -> DNDarray:
    """Histogram of equal-width bins over [min, max] (torch semantics;
    reference: statistics.py histc); min = max = 0 takes the data's range
    (one all-gather), the counts are added over the ranks (one
    ``allreduce``)."""
    sanitize_in(input)
    t = input.larray
    tt = t.dtype
    if types.heat_type_is_exact(input.dtype):
        tt = torch.float32
    if t.is_complex():
        raise TypeError("float() argument must be a string or a real number, not 'complex'")
    lo, hi = builtins.float(min), builtins.float(max)
    if lo == 0.0 and hi == 0.0:
        lo, hi = _range_of(input, torch.float64) if input.size else (0.0, 0.0)
    if lo == hi:
        lo, hi = lo - 1e-6, hi + 1e-6
    comp = tt if tt.is_floating_point else torch.float32
    edges = _linspace(lo, hi, bins + 1, comp, t.device)
    counts = _histogram_counts(t.to(comp), edges, None, comp)
    res = _replicated(_summed(input, counts).to(tt), input)
    if out is not None:
        return _operations._store(out, res)
    return res


def histogram(a: DNDarray, bins: int = 10, range=None, normed=None, weights=None, density=None):
    """NumPy-style histogram: (hist, bin_edges) (reference: statistics.py
    histogram, ``normed`` refused as at statistics.py:716); the range from
    the data (one all-gather) unless given, the counts added over the
    ranks (one ``allreduce``)."""
    from . import arithmetics

    if normed is not None:
        raise NotImplementedError("'normed' is not supported")
    sanitize_in(a)
    t = a.larray
    w = _weights_of(a, weights)
    tt = t.dtype  # the data (and weights) as jnp promotes them: joined, then inexact
    if w is not None:
        tt = types.promote_types(types.canonical_heat_type(tt), types.canonical_heat_type(w.dtype)).torch_type()
    tt = arithmetics.inexact(tt)
    if isinstance(bins, (int, np.integer)):
        if range is None:
            lo, hi = _range_of(a, torch.float64) if a.size else (0.0, 1.0)
            if lo == hi:
                lo, hi = lo - 0.5, hi + 0.5
        else:
            lo, hi = builtins.float(range[0]), builtins.float(range[1])
        edges = _linspace(lo, hi, int(bins) + 1, tt, t.device)
    else:
        edges = torch.as_tensor(np.asarray(bins), device=t.device).to(tt)
    counts = _summed(a, _histogram_counts(t, edges, w, tt))
    if density:
        widths = (edges[1:] - edges[:-1]).to(counts.dtype)
        counts = counts / counts.sum() / widths
    return _replicated(counts, a), _replicated(edges, a)


def cov(m: DNDarray, y: Optional[DNDarray] = None, rowvar: bool = True, bias: bool = False,
        ddof: Optional[int] = None) -> DNDarray:
    """Covariance matrix estimate (numpy's ``cov``; reference:
    statistics.py cov), of the gathered operands, replicated; computed in
    float64 for float64 operands and float32 otherwise (complex operands
    lose their imaginary part, as in ``heat_tpu``)."""
    sanitize_in(m)
    if ddof is not None and not isinstance(ddof, int):
        raise TypeError("ddof must be integer")
    tt = torch.float64 if m.dtype is types.float64 else torch.float32

    def rows(a: DNDarray) -> torch.Tensor:
        t = _operations._whole(a)
        t = (t.real if t.is_complex() else t).to(tt)
        t = t.reshape(1, -1) if t.ndim == 1 else t
        return t if rowvar or t.shape[0] == 1 and a.ndim == 1 else t.T

    X = rows(m)
    if y is not None:
        sanitize_in(y)
        X = torch.cat([X, rows(y)], dim=0)
    if ddof is None:
        ddof = 0 if bias else 1
    n = X.shape[1]
    Xc = X - X.mean(dim=1, keepdim=True)
    c = Xc @ Xc.T / builtins.max(n - ddof, 0)
    if c.shape == (1, 1):
        c = c.reshape(())
    return _replicated(c, m)


DNDarray.argmax = argmax
DNDarray.argmin = argmin
DNDarray.average = average
DNDarray.max = max
DNDarray.min = min
DNDarray.mean = mean
DNDarray.median = median
DNDarray.percentile = percentile
DNDarray.std = std
DNDarray.var = var
DNDarray.kurtosis = kurtosis
DNDarray.skew = skew
