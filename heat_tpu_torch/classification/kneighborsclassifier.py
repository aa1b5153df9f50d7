"""K-nearest-neighbors classifier.

Port of ``heat_tpu.classification.kneighborsclassifier`` (Heat reference:
heat/classification/kneighborsclassifier.py, ``KNeighborsClassifier`` :18:
fit stores the data; predict is cdist, top-k and a one-hot vote, :45-131).

The vote takes the k nearest training rows by (distance, training index),
as ``jax.lax.top_k(-dist, k)`` breaks ties toward the lower index; only
the set matters to the counts. Per block of queries: the k-th smallest
distance ``t`` (``torch.topk``, whose order among ties is not promised,
gives the value only), every row below ``t``, and the rows at ``t`` in
index order until k are taken; the vote is that mask times the one-hot
labels. ``argmax`` over the counts takes the first maximum, as in
``heat_tpu``. The default metric is the direct form (``torch.cdist``
without the product form), as ``heat_tpu``'s fused program computes it.

Across ranks each rank's queries need every training row: the training
rows and their one-hot labels are gathered once (two all-gathers, as
``cdist`` gathers a split Y), so a tie resolves by global index at every
world size. Predictions are local to each rank's queries.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import types
from ..core._operations import _whole
from ..core._samples import classes as _distinct, rows
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from ..spatial import distance

__all__ = ["KNeighborsClassifier"]

# queries a block of the vote: a few (block, n_train) temporaries
_QUERY_BLOCK = 2048


def _vote(dist: torch.Tensor, y_onehot: torch.Tensor, k: int) -> torch.Tensor:
    """Vote counts (n_query, C) of the k nearest rows of each query by
    (distance, index) of the (n_query, n_train) ``dist``."""
    kth = torch.topk(dist, k, dim=1, largest=False).values[:, -1:]
    below = dist < kth
    at = dist == kth
    room = k - below.sum(dim=1, keepdim=True)
    taken = below | (at & (torch.cumsum(at, dim=1) <= room))
    return taken.to(y_onehot.dtype) @ y_onehot


class KNeighborsClassifier(BaseEstimator, ClassificationMixin):
    """Classification by majority vote of the k nearest neighbors
    (reference: kneighborsclassifier.py:18)."""

    def __init__(self, n_neighbors: int = 5, effective_metric_: Optional[Callable] = None):
        self.n_neighbors = n_neighbors
        self.effective_metric_ = effective_metric_ if effective_metric_ is not None else distance.cdist
        self.x = None
        self.y = None
        self._classes = None

    @staticmethod
    def one_hot_encoding(x: DNDarray) -> DNDarray:
        """One-hot-encode an integer label vector (reference:
        kneighborsclassifier.py:45; class count = max(x) + 1 over every
        rank), float32, split 0 when ``x`` is split."""
        sanitize_in(x)
        t = x.larray.reshape(-1)
        top = torch.amax(t) if t.numel() else torch.tensor(-1, dtype=t.dtype, device=t.device)
        if x.is_distributed():
            top = x.comm.allreduce(top.reshape(1), "max")[0]
        onehot = (t[:, None] == torch.arange(int(top) + 1, device=t.device)[None, :]).to(torch.float32)
        split = None if x.split is None else 0
        lmap = None
        if x.is_distributed():
            lmap = np.stack([x.lshape_map[:, x.split], np.full(x.comm.size, onehot.shape[1])], axis=1)
        return DNDarray(onehot, (x.gshape[0] if x.ndim else 1, onehot.shape[1]), types.float32, split, x.device,
                        x.comm, lmap)

    def fit(self, x: DNDarray, y: DNDarray) -> "KNeighborsClassifier":
        """Store training data and labels (reference:
        kneighborsclassifier.py fit). ``y`` may be 1-D labels or one-hot."""
        sanitize_in(x)
        sanitize_in(y)
        if y.ndim == 1:
            classes = _distinct(y)
            self._classes = classes
            onehot = (y.larray[:, None] == classes[None, :].to(y.larray.device)).to(torch.float32)
            lmap = None
            if y.is_distributed():
                lmap = np.stack([y.lshape_map[:, 0], np.full(y.comm.size, onehot.shape[1])], axis=1)
            self.y = DNDarray(onehot, (y.gshape[0], onehot.shape[1]), types.float32, y.split, y.device, y.comm, lmap)
        elif y.ndim == 2:
            self._classes = torch.arange(y.shape[1], device=y.larray.device)
            self.y = y
        else:
            raise ValueError(f"labels must be 1- or 2-dimensional, got {y.ndim}")
        self.x = x
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Majority vote over the k nearest training points (reference:
        kneighborsclassifier.py predict), each rank its queries against
        every training row."""
        sanitize_in(x)
        if self.x is None:
            raise RuntimeError("fit needs to be called before predict")
        x, xq = rows(x)
        y_onehot = _whole(self.y).to(device=xq.device, dtype=torch.float32)
        k = self.n_neighbors
        if self.effective_metric_ is distance.cdist:
            tt = distance._prepare(x, self.x).torch_type()
            xt = _whole(self.x).to(device=xq.device, dtype=tt)
            xq = xq.to(tt)
            block = lambda s: distance._direct(xq[s : s + _QUERY_BLOCK], xt)  # noqa: E731
        else:
            dist = self.effective_metric_(x, self.x)
            mine = 0 if x.is_distributed() else None  # this rank's queries: its rows, or all of them
            d = dist.resplit(mine).larray if dist.is_distributed() and dist.split != mine else dist.larray
            block = lambda s: d[s : s + _QUERY_BLOCK]  # noqa: E731
        votes = y_onehot.new_zeros((0, y_onehot.shape[1]))
        if xq.shape[0]:
            votes = torch.cat([_vote(block(s), y_onehot, k) for s in range(0, xq.shape[0], _QUERY_BLOCK)])
        labels = self._classes.to(votes.device)[torch.argmax(votes, dim=1)]
        split = 0 if x.split is not None else None
        lmap = x.lshape_map[:, :1] if x.is_distributed() else None
        return DNDarray(labels, (x.gshape[0],), types.canonical_heat_type(labels.dtype), split, x.device, x.comm, lmap)
