"""Lasso regression.

Port of ``heat_tpu.regression.lasso`` (Heat reference:
heat/regression/lasso.py, ``Lasso`` :15, the coordinate-descent fit
:121-172).

``heat_tpu`` runs cyclic coordinate descent on X with an intercept column,
``rho_j = mean(X_j · (y − Xθ + X_j θ_j))``, one pass over X a coordinate.
The port computes the same iterates from the Gram form: one pass over X
gives ``G = XᵀX / n`` and ``c = Xᵀy / n`` (accumulated in float64, in
blocks of rows), and then ``rho_j = c_j − (Gθ)_j + G_jj θ_j`` on the small
(m × m) G on the device, which is the same value in real arithmetic.
Across ranks each rank sums its rows and one all-reduce carries G, c and
the row count. The sweeps run in float64; the stop test
``max|θ_new − θ| < tol`` is one host read a sweep. θ comes back in the
data's type.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import factories, types
from ..core._samples import aligned, rows, summed
from ..core.base import BaseEstimator, RegressionMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in

__all__ = ["Lasso"]

# rows a block of the Gram's one pass (a (block, m) float64 temporary)
_BLOCK = 1 << 20
#: host reads of the last fit's stop tests (one a sweep)
HOST_READS = 0


def _gram(arr: torch.Tensor, yarr: torch.Tensor) -> torch.Tensor:
    """This rank's ``[XᵀX | Xᵀy]`` (m × (m + 1)) in float64, X = [1 | arr]."""
    n, f = arr.shape
    out = torch.zeros((f + 1, f + 2), dtype=torch.float64, device=arr.device)
    for s in range(0, n, _BLOCK):
        a = arr[s : s + _BLOCK].to(torch.float64)
        blk = torch.cat([torch.ones((a.shape[0], 1), dtype=a.dtype, device=a.device), a,
                         yarr[s : s + _BLOCK, None].to(torch.float64)], dim=1)
        out += blk[:, : f + 1].T @ blk
    return out


def _sweeps(G: torch.Tensor, c: torch.Tensor, lam: float, tol: float, max_iter: int):
    """Cyclic coordinate descent on the Gram form from θ = 0: ``(θ,
    sweeps)``; coordinate 0, the intercept, is not penalized."""
    global HOST_READS
    m = G.shape[0]
    theta = torch.zeros(m, dtype=G.dtype, device=G.device)
    diag = torch.clamp_min(torch.diagonal(G), 1e-30)
    it, diff = 0, float("inf")
    while it < max_iter and diff >= tol:
        old = theta.clone()
        for j in range(m):
            rho = c[j] - G[j] @ theta + G[j, j] * theta[j]
            if j == 0:
                theta[0] = rho / diag[0]
            else:
                theta[j] = (torch.sign(rho) * torch.clamp_min(torch.abs(rho) - lam, 0.0)) / diag[j]
        it += 1
        HOST_READS += 1
        diff = float(torch.max(torch.abs(theta - old)))
    return theta, it


class Lasso(BaseEstimator, RegressionMixin):
    """L1-regularized least squares via cyclic coordinate descent
    (reference: lasso.py:15). ``theta`` includes the intercept (feature 0,
    unpenalized), matching the reference."""

    def __init__(self, lam: Optional[float] = 0.1, max_iter: Optional[int] = 100, tol: Optional[float] = 1e-6):
        self.__lam = lam
        self.max_iter = max_iter
        self.tol = tol
        self.__theta = None
        self.n_iter = None

    @property
    def lam(self) -> float:
        return self.__lam

    @lam.setter
    def lam(self, arg: float):
        self.__lam = arg

    @property
    def coef_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[1:]

    @property
    def intercept_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[0]

    @property
    def theta(self):
        return self.__theta

    def soft_threshold(self, rho):
        """Soft-threshold operator (reference: lasso.py soft_threshold)."""
        lam = self.__lam
        if isinstance(rho, DNDarray):
            val = rho.larray
            zero = torch.zeros((), dtype=val.dtype, device=val.device)
            out = torch.where(val < -lam, val + lam, torch.where(val > lam, val - lam, zero))
            return DNDarray(out, rho.shape, rho.dtype, rho.split, rho.device, rho.comm,
                            rho.lshape_map if rho.is_distributed() else None)
        if rho < -lam:
            return rho + lam
        if rho > lam:
            return rho - lam
        return 0.0

    def rmse(self, gt: DNDarray, yest: DNDarray) -> float:
        """Root mean squared error (reference: lasso.py rmse), over every
        rank's rows."""
        gt, g = rows(gt)
        diff = g.reshape(-1) - aligned(yest, gt).reshape(-1).to(g.device)
        total = summed(gt, torch.sum(diff.to(torch.float64) ** 2))
        return float(torch.sqrt(total / max(gt.gshape[0], 1)))

    def fit(self, x: DNDarray, y: DNDarray) -> "Lasso":
        """Coordinate-descent fit (reference: lasso.py:121-172): one pass
        over X for the Gram, one all-reduce across ranks, then the sweeps."""
        sanitize_in(x)
        sanitize_in(y)
        if x.ndim != 2:
            raise ValueError(f"x needs to be 2-dimensional, got {x.ndim}")
        if y.ndim > 2 or (y.ndim == 2 and y.shape[1] != 1):
            raise ValueError(f"y needs to be 1-D or (n, 1), got {y.shape}")
        x, arr = rows(x)
        tt = torch.float64 if x.dtype is types.float64 else torch.float32
        yarr = aligned(y, x).reshape(-1).to(arr.device)
        # mean-scale statistics: the reference thresholds the per-sample
        # mean correlation against lam (reference lasso.py:121-172), so lam
        # is sample-size independent
        gc = summed(x, _gram(arr.to(tt), yarr.to(tt))) / max(x.gshape[0], 1)
        theta, self.n_iter = _sweeps(gc[:, :-1], gc[:, -1], float(self.__lam), float(self.tol), int(self.max_iter))
        self.__theta = factories.array(theta.to(tt).reshape(-1, 1), device=x.device, comm=x.comm)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Linear prediction with intercept (reference: lasso.py predict),
        each rank its rows."""
        sanitize_in(x)
        if self.__theta is None:
            raise RuntimeError("fit needs to be called before predict")
        x, arr = rows(x)
        theta = self.__theta.larray.reshape(-1)
        yest = arr.to(theta.dtype) @ theta[1:] + theta[0]
        split = 0 if x.split is not None else None
        lmap = x.lshape_map[:, :1] if x.is_distributed() else None
        return DNDarray(yest, (x.gshape[0],), types.canonical_heat_type(yest.dtype), split, x.device, x.comm, lmap)
