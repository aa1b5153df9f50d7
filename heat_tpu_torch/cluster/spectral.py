"""Spectral clustering.

Port of ``heat_tpu.cluster.spectral`` (Heat reference:
heat/cluster/spectral.py, ``Spectral``). The pipeline: the RBF or
Euclidean similarity in the product form (``spatial.distance``'s
``quadratic_expansion=True``), the normalized symmetric
``graph.Laplacian``, ``linalg.lanczos`` with ``n_lanczos`` steps (its
start vector drawn from the global stream, R1 on a card), the float64
eigenproblem of the small tridiagonal T on the host, the embedding
``V @ W`` on each rank's rows, then ``KMeans`` (k-means++ from the global
stream, K3 a Lloyd step on a card) on its first ``n_clusters`` columns.
The two draws come in ``heat_tpu``'s order, so that after the same
``seed`` the embeddings agree to rounding. An operand split along axis 0
keeps each rank's rows throughout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from ..graph import Laplacian
from ..spatial import distance
from .kmeans import KMeans

__all__ = ["Spectral"]


class Spectral(BaseEstimator, ClusteringMixin):
    """Spectral clustering on the graph Laplacian eigenspace (reference:
    spectral.py:16)."""

    def __init__(
        self,
        n_clusters: Optional[int] = None,
        gamma: float = 1.0,
        metric: str = "rbf",
        laplacian: str = "fully_connected",
        threshold: float = 1.0,
        boundary: str = "upper",
        n_lanczos: int = 300,
        assign_labels: str = "kmeans",
        **params,
    ):
        self.n_clusters = n_clusters
        self.gamma = gamma
        self.metric = metric
        self.laplacian = laplacian
        self.threshold = threshold
        self.boundary = boundary
        self.n_lanczos = n_lanczos
        self.assign_labels = assign_labels

        if metric == "rbf":
            sig = np.sqrt(1.0 / (2.0 * gamma))
            sim = lambda x: distance.rbf(x, sigma=sig, quadratic_expansion=True)  # noqa: E731
        elif metric == "euclidean":
            sim = lambda x: distance.cdist(x, quadratic_expansion=True)  # noqa: E731
        else:
            raise NotImplementedError("Other kernels currently not supported")

        if laplacian == "eNeighbour":
            self._laplacian = Laplacian(
                sim, definition="norm_sym", mode="eNeighbour", threshold_key=boundary, threshold_value=threshold
            )
        elif laplacian == "fully_connected":
            self._laplacian = Laplacian(sim, definition="norm_sym", mode="fully_connected")
        else:
            raise NotImplementedError("Other approaches currently not supported")

        if assign_labels == "kmeans":
            kmeans_params = params.get("params", {"n_clusters": n_clusters, "init": "kmeans++"})
            if n_clusters is not None:
                kmeans_params["n_clusters"] = n_clusters
            self._cluster = KMeans(**kmeans_params)
        else:
            raise NotImplementedError("Other Label Assignment Algorithms are currently not available")

        self._labels = None

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    def _spectral_embedding(self, x: DNDarray):
        """Ritz values of the Laplacian and the embedding ``V @ W`` (rows
        like ``x``'s), from ``lanczos`` (reference: spectral.py:~120)."""
        from ..core import linalg

        L = self._laplacian.construct(x)
        m = min(self.n_lanczos, x.shape[0])
        V, T = linalg.lanczos(L, m)
        # eig of the small tridiagonal on the host, in float64 (the
        # reference takes torch.linalg.eig on every rank)
        eval_, evec = np.linalg.eigh(np.asarray(T.numpy(), dtype=np.float64))
        order = np.argsort(eval_)
        eval_, evec = eval_[order], evec[:, order]
        v = V.larray
        emb = v @ torch.from_numpy(evec).to(device=v.device, dtype=v.dtype)
        lmap = None
        if V.is_distributed():
            lmap = V.lshape_map.copy()
        embedding = DNDarray(emb, (x.shape[0], m), V.dtype, 0 if x.split is not None else None, x.device, x.comm,
                             lmap)
        return eval_, embedding

    def fit(self, x: DNDarray) -> "Spectral":
        """Embed and cluster (reference: spectral.py:~160)."""
        sanitize_in(x)
        if x.split is not None and x.split != 0:
            raise NotImplementedError("Not implemented for other splitting-axes")
        eval_, embedding = self._spectral_embedding(x)

        if self.n_clusters is None:
            # eigengap heuristic (reference: spectral.py selects by gap)
            self.n_clusters = int(np.argmax(np.diff(eval_))) + 1
            self._cluster.n_clusters = self.n_clusters

        self._cluster.fit(embedding[:, : self.n_clusters])
        self._labels = self._cluster.labels_
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Labels for the fitted data (the embedding is transductive: the
        reference's predict re-embeds the training graph)."""
        sanitize_in(x)
        if self._labels is None:
            raise RuntimeError("fit needs to be called before predict")
        return self._labels
