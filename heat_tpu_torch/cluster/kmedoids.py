"""K-Medoids clustering.

Port of ``heat_tpu.cluster.kmedoids`` (Heat reference:
heat/cluster/kmedoids.py): Lloyd-style iterations where each new center
is the cluster member closest, in L1, to the cluster's coordinate-wise
median.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ._kcluster import _KCluster, _Rows, _cluster_medians, _l1_assign, _nearest_members

__all__ = ["KMedoids"]


def _medoid_step(arr: torch.Tensor, centers: torch.Tensor, rows=None):
    """One K-Medoids iteration: ``(arr, centers) -> (new_centers, shift²)``
    (``heat_tpu`` kmedoids.py:26), over every rank's rows with ``rows``:
    L1 labels, each cluster's exact median (``_cluster_medians``; an empty
    cluster's is its center), then the member nearest to it in L1
    (``_nearest_members``). An empty cluster keeps its center."""
    rows = _Rows(None, [arr.shape[0]]) if rows is None else rows
    labels = _l1_assign(arr, centers)
    med, sizes = _cluster_medians(arr, labels, centers.shape[0], rows)
    med = torch.where(sizes[:, None] > 0, med, centers)
    new_centers = torch.where(sizes[:, None] > 0, _nearest_members(arr, labels, med, rows), centers)
    shift = torch.sum((new_centers - centers) ** 2)
    return new_centers, shift


class KMedoids(_KCluster):
    """K-Medoids: centers are actual data points; Manhattan metric
    throughout (reference: kmedoids.py:48)."""

    _assignment_metric = "manhattan"

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        random_state: Optional[int] = None,
    ):
        if isinstance(init, str) and init == "kmedoids++":
            init = "probability_based"
        super().__init__(
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=0.0,
            random_state=random_state,
        )

    def fit(self, x: DNDarray) -> "KMedoids":
        """Seeding, the convergence loop and the final assignment (see
        ``_KCluster._fit_fused``)."""
        return self._fit_fused(x, _medoid_step, returns_inertia=False)
