"""Gaussian naive Bayes.

Port of ``heat_tpu.naive_bayes.gaussianNB`` (Heat reference:
heat/naive_bayes/gaussianNB.py, ``GaussianNB`` :25, the streaming merge of
``partial_fit`` :127-381, ``logsumexp`` :398).

A fit reads each rank's rows once, in blocks of ``_BLOCK`` rows: the
class counts, sums and square sums (``onehotᵀ · x``, ``onehotᵀ · x²``)
and the features' sums and square sums, accumulated in float64 so that
the one-pass variance ``E[x²] − E[x]²`` keeps float32's precision over
millions of rows. Across ranks one all-reduce carries all of them; the
classes are the distinct labels of every rank (two all-gathers), and
``epsilon_`` comes from the merged variance of the features. The
streaming merge of ``partial_fit`` is ``heat_tpu``'s (Chan, Golub and
LeVeque), with the stored variance's epsilon floor stripped first.

The joint log-likelihood keeps ``heat_tpu``'s arithmetic,
``−½ Σ_f (x − θ)² / var`` per class, but never builds its (n, C, F)
broadcast: it runs class by class over blocks of rows, so a prediction
holds one (block, F) temporary beside the (n, C) result. Predictions are
local to each rank's rows.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core import types
from ..core._operations import _whole
from ..core._samples import aligned, classes as _distinct, rows, summed
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in

__all__ = ["GaussianNB"]

# rows a block: a (block, F) temporary in float64 while fitting, in the
# model's type while predicting
_BLOCK = 1 << 20


def _batch_stats(arr: torch.Tensor, labels: torch.Tensor, cls: torch.Tensor, w: Optional[torch.Tensor]):
    """This rank's (counts (C,), sums (C, F), squares (C, F), feature sums
    (F,), feature squares (F,)) in float64: the class statistics weighted
    by ``w``, the feature statistics of every row unweighted."""
    f64 = torch.float64
    n, f = arr.shape
    k = cls.numel()
    dev = arr.device
    counts = torch.zeros(k, dtype=f64, device=dev)
    sums, squares = (torch.zeros((k, f), dtype=f64, device=dev) for _ in range(2))
    tot, tot2 = (torch.zeros(f, dtype=f64, device=dev) for _ in range(2))
    for s in range(0, n, _BLOCK):
        a = arr[s : s + _BLOCK].to(f64)
        onehot = (labels[s : s + _BLOCK, None] == cls[None, :]).to(f64)
        if w is not None:
            onehot *= w[s : s + _BLOCK, None].to(f64)
        a2 = a * a
        counts += onehot.sum(0)
        sums += onehot.T @ a
        squares += onehot.T @ a2
        tot += a.sum(0)
        tot2 += a2.sum(0)
    return counts, sums, squares, tot, tot2


def _host(v) -> torch.Tensor:
    """A DNDarray, tensor or array-like as a whole tensor."""
    if isinstance(v, DNDarray):
        return _whole(v)
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


class GaussianNB(BaseEstimator, ClassificationMixin):
    """Gaussian naive Bayes classifier (reference: gaussianNB.py:25)."""

    def __init__(self, priors=None, var_smoothing: float = 1e-9):
        self.priors = priors
        self.var_smoothing = var_smoothing
        self.classes_ = None
        self.theta_ = None
        self.var_ = None
        self.class_count_ = None
        self.class_prior_ = None
        self.epsilon_ = None
        self._epsilon_prev = 0.0

    def fit(self, x: DNDarray, y: DNDarray, sample_weight: Optional[DNDarray] = None) -> "GaussianNB":
        """Fit from scratch (reference: gaussianNB.py fit → partial_fit)."""
        self.classes_ = None
        self.theta_ = None
        self.var_ = None
        self._epsilon_prev = 0.0
        return self.partial_fit(x, y, classes=None, sample_weight=sample_weight)

    def partial_fit(
        self,
        x: DNDarray,
        y: DNDarray,
        classes: Optional[DNDarray] = None,
        sample_weight: Optional[DNDarray] = None,
    ) -> "GaussianNB":
        """Incremental fit on a batch (reference: gaussianNB.py:127-381)."""
        sanitize_in(x)
        sanitize_in(y)
        if x.ndim != 2:
            raise ValueError(f"expected x to be 2-dimensional, got {x.ndim}")
        x, arr = rows(x)
        tt = torch.float64 if x.dtype is types.float64 else torch.float32
        arr = arr.to(tt)
        dev = arr.device
        labels = aligned(y, x).reshape(-1).to(dev)
        w = None if sample_weight is None else aligned(sample_weight, x).reshape(-1).to(dev)
        if classes is not None:
            cls = _host(classes).to(dev)
        elif self.classes_ is not None:
            cls = _host(self.classes_).to(dev)
        else:
            cls = _distinct(y).to(dev)
        k = int(cls.shape[0])
        stats = _batch_stats(arr, labels, cls, w)
        if x.is_distributed():
            flat = summed(x, torch.cat([s.reshape(-1) for s in stats]))
            stats = [f.reshape(s.shape) for f, s in zip(flat.split([s.numel() for s in stats]), stats)]
        counts, sums, squares, tot, tot2 = stats
        n = x.gshape[0]
        # variance floor from the data spread (reference: epsilon_)
        spread = tot2 / max(n, 1) - (tot / max(n, 1)) ** 2
        self.epsilon_ = float(self.var_smoothing * spread.max()) if spread.numel() else 0.0
        c = torch.clamp_min(counts[:, None], 1e-30)
        means = sums / c
        variances = squares / c - means**2

        if self.theta_ is None or self.classes_ is None:
            new_theta, new_var, new_counts = means, variances, counts
        else:
            # streaming merge of old and batch statistics (reference
            # _update_mean_variance); the stored var_ holds the previous
            # epsilon floor: strip it before merging (reference
            # gaussianNB.py:326/371)
            old_counts = _host(self.class_count_).to(device=dev, dtype=torch.float64)
            old_theta = _host(self.theta_).to(device=dev, dtype=torch.float64)
            old_var = _host(self.var_).to(device=dev, dtype=torch.float64) - self._epsilon_prev
            total = old_counts + counts
            t = torch.clamp_min(total[:, None], 1e-30)
            new_theta = (old_theta * old_counts[:, None] + means * counts[:, None]) / t
            both = (old_counts[:, None] > 0) & (counts[:, None] > 0)
            correction = torch.where(both, old_counts[:, None] * counts[:, None] / t * (old_theta - means) ** 2, 0.0)
            new_var = (old_var * old_counts[:, None] + variances * counts[:, None] + correction) / t
            new_counts = total

        def whole(t: torch.Tensor) -> DNDarray:
            return DNDarray(t, tuple(t.shape), types.canonical_heat_type(t.dtype), None, x.device, x.comm)

        self.classes_ = whole(cls)
        self.class_count_ = whole(new_counts.to(tt))
        self.theta_ = whole(new_theta.to(tt))
        self.var_ = whole((new_var + self.epsilon_).to(tt))
        self._epsilon_prev = self.epsilon_
        if self.priors is not None:
            priors = _host(self.priors).to(dev)
            if priors.shape[0] != k:
                raise ValueError("Number of priors must match number of classes.")
            if not np.isclose(float(torch.sum(priors)), 1.0):
                raise ValueError("The sum of the priors should be 1.")
            if bool(torch.any(priors < 0)):
                raise ValueError("Priors must be non-negative.")
            self.class_prior_ = whole(priors)
        else:
            prior = new_counts / torch.clamp_min(torch.sum(new_counts), 1e-30)
            self.class_prior_ = whole(prior.to(tt))
        return self

    def _joint_log_likelihood(self, arr: torch.Tensor) -> torch.Tensor:
        """Unnormalized posterior log-probabilities (n, C) of the rows
        ``arr`` (reference: gaussianNB.py:~390), class by class over blocks
        of rows."""
        theta = self.theta_.larray
        var = self.var_.larray
        arr = arr.to(device=theta.device, dtype=theta.dtype)
        prior = torch.log(torch.clamp_min(self.class_prior_.larray, 1e-30))
        n_ij = -0.5 * torch.sum(torch.log(2.0 * math.pi * var), dim=1)  # (C,)
        ll = torch.empty((arr.shape[0], theta.shape[0]), dtype=theta.dtype, device=theta.device)
        for s in range(0, arr.shape[0], _BLOCK):
            blk = arr[s : s + _BLOCK]
            for c in range(theta.shape[0]):
                d = blk - theta[c]
                d.square_().div_(var[c])
                ll[s : s + _BLOCK, c] = n_ij[c] - 0.5 * torch.sum(d, dim=1)
        return ll + prior[None, :]

    def _rows_result(self, x: DNDarray, t: torch.Tensor) -> DNDarray:
        """``t``, a result for this rank's rows of ``x``, split 0 when ``x``
        is split."""
        split = 0 if x.split is not None else None
        gshape = (x.gshape[0],) + tuple(t.shape[1:])
        lmap = None
        if x.is_distributed():
            lmap = np.zeros((x.comm.size, t.ndim), dtype=np.int64)
            lmap[:, 0] = x.lshape_map[:, 0]
            lmap[:, 1:] = t.shape[1:]
        return DNDarray(t, gshape, types.canonical_heat_type(t.dtype), split, x.device, x.comm, lmap)

    def predict(self, x: DNDarray) -> DNDarray:
        """Most probable class per sample."""
        sanitize_in(x)
        if self.theta_ is None:
            raise RuntimeError("fit needs to be called before predict")
        x, arr = rows(x)
        winners = torch.argmax(self._joint_log_likelihood(arr), dim=1)
        return self._rows_result(x, self.classes_.larray[winners])

    def logsumexp(self, a, axis=None, b=None, keepdims=False, return_sign=False):
        """log(sum(b * exp(a))) computed stably (reference gaussianNB.py:398,
        adapted from scikit-learn). Returns (out, sign) when
        ``return_sign=True``. A DNDarray reduced along its split axis
        across ranks is gathered first."""
        ref = a if isinstance(a, DNDarray) else None
        arr = a.larray if ref is not None else torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        ndim = arr.ndim
        axes = tuple(range(ndim)) if axis is None else ((axis,) if isinstance(axis, int) else tuple(axis))
        axes = tuple(ax % ndim for ax in axes) if ndim else ()
        split = None if ref is None else ref.split
        gather = ref is not None and ref.is_distributed() and split in axes
        if gather:
            arr = _whole(ref)
        bw = None
        if b is not None:
            bw = (_whole(b) if gather else b.larray) if isinstance(b, DNDarray) else torch.as_tensor(np.asarray(b))
            bw = bw.to(arr.device)
        if not arr.is_floating_point():
            arr = arr.to(torch.float32)
        m = torch.amax(arr, dim=axes, keepdim=True) if axes else arr
        m = torch.where(torch.isfinite(m), m, torch.zeros((), dtype=m.dtype))
        e = torch.exp(arr - m)
        s = torch.sum(e if bw is None else bw * e, dim=axes, keepdim=True) if axes else (e if bw is None else bw * e)
        sign = torch.sign(s)
        out = torch.log(torch.abs(s) if return_sign else s) + m
        if not keepdims and axes:
            out, sign = out.squeeze(axes), sign.squeeze(axes)

        def wrap(v: torch.Tensor):
            if ref is None:
                return v
            sp = None if split is None or split in axes else (split if keepdims else split - sum(1 for ax in axes if ax < split))
            if sp is None or not ref.is_distributed():
                return DNDarray(v, tuple(v.shape), types.canonical_heat_type(v.dtype), sp, ref.device, ref.comm)
            lmap = np.delete(ref.lshape_map, list(axes), axis=1) if not keepdims else ref.lshape_map.copy()
            if keepdims:
                lmap[:, list(axes)] = 1
            gshape = list(v.shape)
            gshape[sp] = int(lmap[:, sp].sum())
            return DNDarray(v, tuple(gshape), types.canonical_heat_type(v.dtype), sp, ref.device, ref.comm, lmap)

        if return_sign:
            return wrap(out), wrap(sign)
        return wrap(out)

    def predict_log_proba(self, x: DNDarray) -> DNDarray:
        """Normalized class log-probabilities (reference logsumexp at
        gaussianNB.py:398)."""
        sanitize_in(x)
        x, arr = rows(x)
        jll = self._joint_log_likelihood(arr)
        return self._rows_result(x, jll - torch.logsumexp(jll, dim=1, keepdim=True))

    def predict_proba(self, x: DNDarray) -> DNDarray:
        """Class probabilities."""
        lp = self.predict_log_proba(x)
        return DNDarray(torch.exp(lp.larray), lp.gshape, lp.dtype, lp.split, lp.device, lp.comm,
                        lp.lshape_map if lp.is_distributed() else None)
