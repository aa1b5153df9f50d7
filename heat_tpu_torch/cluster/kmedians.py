"""K-Medians clustering.

Port of ``heat_tpu.cluster.kmedians`` (Heat reference:
heat/cluster/kmedians.py): Lloyd-style iterations where the centroid
update is the per-cluster coordinate-wise median, with L1 assignment.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ._kcluster import _KCluster, _l1_assign, _masked_median

__all__ = ["KMedians"]


def _median_step(arr: torch.Tensor, centers: torch.Tensor):
    """One K-Medians iteration: ``(arr, centers) -> (new_centers, shift²)``
    (``heat_tpu`` kmedians.py:26). L1 distances are taken one center at a
    time; an empty cluster keeps its center."""
    labels = _l1_assign(arr, centers)
    rows = []
    for i in range(centers.shape[0]):
        med, cnt = _masked_median(arr, labels == i)
        rows.append(torch.where(cnt > 0, med, centers[i]))
    new_centers = torch.stack(rows)
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
