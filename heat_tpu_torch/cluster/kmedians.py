"""K-Medians clustering.

Port of ``heat_tpu.cluster.kmedians`` (Heat reference:
heat/cluster/kmedians.py): Lloyd-style iterations where the centroid
update is the per-cluster coordinate-wise median, with L1 assignment.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ._kcluster import _KCluster, _Rows, _cluster_medians, _l1_assign

__all__ = ["KMedians"]


def _median_step(arr: torch.Tensor, centers: torch.Tensor, rows=None):
    """One K-Medians iteration: ``(arr, centers) -> (new_centers, shift²)``
    (``heat_tpu`` kmedians.py:26), over every rank's rows with ``rows``:
    L1 labels of this rank's rows, then each cluster's exact median
    (``_cluster_medians``). An empty cluster keeps its center."""
    rows = _Rows(None, [arr.shape[0]]) if rows is None else rows
    med, sizes = _cluster_medians(arr, _l1_assign(arr, centers), centers.shape[0], rows)
    new_centers = torch.where(sizes[:, None] > 0, med, centers)
    shift = torch.sum((new_centers - centers) ** 2)
    return new_centers, shift


class KMedians(_KCluster):
    """K-Medians: cluster centers are coordinate-wise medians; assignment
    and functional value use the Manhattan metric (reference:
    kmedians.py:49)."""

    _assignment_metric = "manhattan"

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
    ):
        if isinstance(init, str) and init == "kmedians++":
            init = "probability_based"
        super().__init__(
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
        )

    def fit(self, x: DNDarray) -> "KMedians":
        """Seeding, the convergence loop and the final assignment (see
        ``_KCluster._fit_fused``)."""
        return self._fit_fused(x, _median_step, returns_inertia=False)
