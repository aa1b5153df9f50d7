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
from ._kcluster import _KCluster, _l1_assign, _masked_median

__all__ = ["KMedoids"]


def _medoid_step(arr: torch.Tensor, centers: torch.Tensor):
    """One K-Medoids iteration: ``(arr, centers) -> (new_centers, shift²)``
    (``heat_tpu`` kmedoids.py:26). L1 distances are taken one center at a
    time; an empty cluster keeps its center."""
    labels = _l1_assign(arr, centers)
    inf = torch.tensor(float("inf"), dtype=arr.dtype, device=arr.device)
    rows = []
    for i in range(centers.shape[0]):
        mask = labels == i
        med, cnt = _masked_median(arr, mask)
        med = torch.where(cnt > 0, med, centers[i])
        dist_to_med = torch.where(mask, torch.sum(torch.abs(arr - med), dim=1), inf)
        rows.append(torch.where(cnt > 0, arr[torch.argmin(dist_to_med)], centers[i]))
    new_centers = torch.stack(rows)
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
