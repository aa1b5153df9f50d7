"""Feature scaling transformers.

Port of ``heat_tpu.preprocessing.preprocessing`` (Heat reference:
heat/preprocessing/preprocessing.py, ``StandardScaler`` :49,
``MinMaxScaler`` :158, ``Normalizer`` :284, ``MaxAbsScaler`` :358,
``RobustScaler`` :444).

Every statistic is a reduction over the sample axis through the port's
``statistics``: ``mean``/``var`` (one all-reduce a moment over a split-0
operand), ``min``/``max`` (one all-gather of the ranks' partials) and
``percentile`` (along the split axis ``parallel.distributed_sort``, else
each rank sorts its lanes; K4 on a card either way). ``RobustScaler``
takes its median and both quantiles from one sort. Attributes that
``heat_tpu`` keeps as raw arrays (``scale_``, ``min_``, ``iqr_``, ...) are
whole tensors on every rank here. A transform is local: each rank scales
its own shard, a split-1 shard by its own columns' statistics; the
``Normalizer``'s row norms over a split-1 operand take one all-reduce.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import factories, rounding, statistics, types
from ..core._operations import _whole
from ..core.base import BaseEstimator, TransformMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in

__all__ = ["StandardScaler", "MinMaxScaler", "Normalizer", "MaxAbsScaler", "RobustScaler"]


def _float_of(x: DNDarray) -> torch.dtype:
    """The type a transform computes in: x's own, float32 for integers and
    bools."""
    return x.larray.dtype if types.heat_type_is_inexact(x.dtype) else torch.float32


def _like(x: DNDarray, arr: torch.Tensor) -> DNDarray:
    """``arr`` (this rank's shard of a result shaped like ``x``) as a
    DNDarray of ``x``'s split and map."""
    return DNDarray(arr, x.gshape, types.canonical_heat_type(arr.dtype), x.split, x.device, x.comm,
                    x.lshape_map if x.is_distributed() else None)


def _cols(stat: torch.Tensor, x: DNDarray) -> torch.Tensor:
    """The whole per-feature ``stat`` for this rank's columns of ``x``: all
    of it, or the columns of a split-1 shard."""
    stat = stat.to(x.larray.device)
    if not (x.is_distributed() and x.split == 1):
        return stat
    counts = x.lshape_map[:, 1]
    start = int(counts[: x.comm.rank].sum())
    return stat[start : start + int(counts[x.comm.rank])]


def _stat(d: DNDarray, x: DNDarray) -> torch.Tensor:
    """A per-feature statistic kept as a DNDarray, for this rank's columns."""
    return _cols(_whole(d), x)


def _nonzero(t: torch.Tensor) -> torch.Tensor:
    """``where(t > 0, t, 1.0)`` in ``jnp``'s promotion of the weak 1.0
    (with ``heat_tpu``'s 64-bit types, integers give float64)."""
    return torch.where(t > 0, t, torch.ones((), dtype=t.dtype if t.is_floating_point() else torch.float64))


def _against(stat: torch.Tensor, t: torch.Tensor, weak: bool) -> torch.Tensor:
    """``stat`` as an operand beside ``t``: a statistic fitted on integers
    is ``jnp``-weakly typed in ``heat_tpu`` (the float64 of ``_nonzero``),
    so a floating ``t`` keeps its own type."""
    return stat.to(t.dtype) if weak and t.is_floating_point() else stat


class StandardScaler(BaseEstimator, TransformMixin):
    """Standardize features to zero mean and unit variance (reference:
    preprocessing.py:49)."""

    def __init__(self, copy: bool = True, with_mean: bool = True, with_std: bool = True):
        self.copy = copy
        self.with_mean = with_mean
        self.with_std = with_std
        self.mean_ = None
        self.var_ = None

    def fit(self, x: DNDarray, sample_weight=None) -> "StandardScaler":
        sanitize_in(x)
        self.mean_ = statistics.mean(x, axis=0) if self.with_mean or self.with_std else None
        if self.with_std:
            self.var_ = statistics.var(x, axis=0)
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        sanitize_in(x)
        arr = x.larray.to(_float_of(x))
        if self.with_mean and self.mean_ is not None:
            arr = arr - _stat(self.mean_, x)
        if self.with_std and self.var_ is not None:
            arr = arr / _nonzero(torch.sqrt(_stat(self.var_, x)))
        return _like(x, arr)

    def inverse_transform(self, y: DNDarray) -> DNDarray:
        sanitize_in(y)
        arr = y.larray
        if self.with_std and self.var_ is not None:
            arr = arr * _nonzero(torch.sqrt(_stat(self.var_, y)))
        if self.with_mean and self.mean_ is not None:
            arr = arr + _stat(self.mean_, y)
        return _like(y, arr)


class MinMaxScaler(BaseEstimator, TransformMixin):
    """Scale features to a given range (reference: preprocessing.py:158)."""

    def __init__(self, feature_range: Tuple[float, float] = (0.0, 1.0), copy: bool = True, clip: bool = False):
        if feature_range[0] >= feature_range[1]:
            raise ValueError(f"minimum of feature_range must be smaller than maximum, got {feature_range}")
        self.feature_range = feature_range
        self.copy = copy
        self.clip = clip
        self.data_min_ = None
        self.data_max_ = None
        self.data_range_ = None
        self.min_ = None
        self.scale_ = None

    def fit(self, x: DNDarray) -> "MinMaxScaler":
        sanitize_in(x)
        self.data_min_ = statistics.min(x, axis=0)
        self.data_max_ = statistics.max(x, axis=0)
        lo_data = _whole(self.data_min_)
        rng = _nonzero(_whole(self.data_max_) - lo_data)
        lo, hi = self.feature_range
        self.scale_ = (hi - lo) / rng
        self.min_ = lo - lo_data * self.scale_
        self.data_range_ = rng
        self._weak = not x.larray.is_floating_point()
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        sanitize_in(x)
        arr = x.larray.to(self.scale_.dtype) * _cols(self.scale_, x) + _cols(self.min_, x)
        if self.clip:
            arr = torch.clamp(arr, self.feature_range[0], self.feature_range[1])
        return _like(x, arr)

    def inverse_transform(self, y: DNDarray) -> DNDarray:
        sanitize_in(y)
        t = y.larray
        return _like(y, (t - _against(_cols(self.min_, y), t, self._weak)) / _against(_cols(self.scale_, y), t, self._weak))


class Normalizer(BaseEstimator, TransformMixin):
    """Normalize samples to unit norm (reference: preprocessing.py:284).
    Each rank scales its rows; a split-1 operand's row norms take one
    all-reduce of each rank's partial sums (or maxima)."""

    def __init__(self, norm: str = "l2", copy: bool = True):
        if norm not in ("l1", "l2", "max"):
            raise NotImplementedError(f"unsupported norm {norm}")
        self.norm = norm
        self.copy = copy

    def fit(self, x: DNDarray) -> "Normalizer":
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        sanitize_in(x)
        arr = x.larray.to(_float_of(x))
        across = x.is_distributed() and x.split == 1
        if self.norm == "max":
            part = torch.amax(torch.abs(arr), dim=1, keepdim=True) if arr.shape[1] else arr.new_zeros((arr.shape[0], 1))
            norms = x.comm.allreduce(part, "max") if across else part
        else:
            part = torch.sum(arr * arr if self.norm == "l2" else torch.abs(arr), dim=1, keepdim=True)
            norms = x.comm.allreduce(part) if across else part
            if self.norm == "l2":
                norms = torch.sqrt(norms)
        return _like(x, arr / _nonzero(norms))


class MaxAbsScaler(BaseEstimator, TransformMixin):
    """Scale by the per-feature maximum absolute value (reference:
    preprocessing.py:358)."""

    def __init__(self, copy: bool = True):
        self.copy = copy
        self.max_abs_ = None
        self.scale_ = None

    def fit(self, x: DNDarray) -> "MaxAbsScaler":
        sanitize_in(x)
        self.max_abs_ = _whole(statistics.max(rounding.abs(x), axis=0))
        self.scale_ = _nonzero(self.max_abs_)
        self._weak = not x.larray.is_floating_point()
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        sanitize_in(x)
        arr = x.larray.to(_float_of(x))
        return _like(x, arr / _against(_cols(self.scale_, x), arr, self._weak))

    def inverse_transform(self, y: DNDarray) -> DNDarray:
        sanitize_in(y)
        return _like(y, y.larray * _against(_cols(self.scale_, y), y.larray, self._weak))


class RobustScaler(BaseEstimator, TransformMixin):
    """Scale by median and IQR (reference: preprocessing.py:444). The
    median and both quantiles come from one ``percentile`` call, so one
    sort (the distributed sort along a split axis 0)."""

    def __init__(
        self,
        quantile_range: Tuple[float, float] = (25.0, 75.0),
        copy: bool = True,
        with_centering: bool = True,
        with_scaling: bool = True,
        unit_variance: bool = False,
    ):
        q_min, q_max = quantile_range
        if not 0 <= q_min <= q_max <= 100:
            raise ValueError(f"invalid quantile range {quantile_range}")
        if unit_variance:
            raise NotImplementedError("unit_variance rescaling is not yet supported (reference parity)")
        self.quantile_range = quantile_range
        self.copy = copy
        self.with_centering = with_centering
        self.with_scaling = with_scaling
        self.unit_variance = unit_variance
        self.center_ = None
        self.iqr_ = None

    def fit(self, x: DNDarray) -> "RobustScaler":
        sanitize_in(x)
        if not (self.with_centering or self.with_scaling):
            return self
        q = _whole(statistics.percentile(x, [50.0, *self.quantile_range], axis=0))
        if self.with_centering:
            # the split ``median(x, axis=0)`` gives: the features' split of a split-1 x
            self.center_ = factories.array(q[0], split=0 if x.split == 1 else None, device=x.device, comm=x.comm)
        if self.with_scaling:
            self.iqr_ = _nonzero(q[2] - q[1])
        return self

    def transform(self, x: DNDarray) -> DNDarray:
        sanitize_in(x)
        arr = x.larray.to(_float_of(x))
        if self.with_centering and self.center_ is not None:
            arr = arr - _stat(self.center_, x)
        if self.with_scaling and self.iqr_ is not None:
            arr = arr / _cols(self.iqr_, x)
        return _like(x, arr)

    def inverse_transform(self, y: DNDarray) -> DNDarray:
        sanitize_in(y)
        arr = y.larray
        if self.with_scaling and self.iqr_ is not None:
            arr = arr * _cols(self.iqr_, y)
        if self.with_centering and self.center_ is not None:
            arr = arr + _stat(self.center_, y)
        return _like(y, arr)
