"""K-Means clustering.

Port of ``heat_tpu.cluster.kmeans`` (Heat reference:
heat/cluster/kmeans.py, ``KMeans``; Lloyd update at kmeans.py:74-100).

A Lloyd step needs the cluster sums, the counts and the inertia. On the
TPU, XLA fuses ``heat_tpu``'s jnp step into one read of X per iteration.
Eager PyTorch does not fuse: the same ops read X three times and write and
re-read an (n, k) distance matrix and an (n, k) one-hot. So on a CUDA
float32 operand within the kernel's bounds the port's steps call kernel
K3 (``_cuda_assign.fused_assign``), which computes exactly those three
from one read of X. Otherwise the same function runs as torch ops
(``fused_assign_plain``), decided up front by ``assign_serviceable``.

``partial_fit`` is the streaming form (running-mean updates per batch).
A host-resident ``HostArray`` streams through the card in row windows,
one ``partial_fit`` update a window (K3 once a window on a card), for
``partial_fit`` and for ``fit`` alike (``_partial_fit_stream``).
Checkpointed fits (``ckpt=``) are not ported (ROADMAP.md Queue 1, item
13).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from . import _cuda_assign
from ._kcluster import _KCluster

__all__ = ["KMeans"]


def _assign(arr: torch.Tensor, centers: torch.Tensor):
    """(sums, counts, inertia) of ``arr`` against ``centers``: kernel K3
    where it serves the operand, else the torch form."""
    n, d = arr.shape
    if _cuda_assign.assign_serviceable(n, d, centers.shape[0], arr):
        return _cuda_assign.fused_assign(arr, centers.contiguous())
    return _cuda_assign.fused_assign_plain(arr, centers)


def _summed(comm, dtype: torch.dtype, *parts: torch.Tensor):
    """``parts`` summed over the ranks in one all-reduce of one packed
    float64 buffer (``heat_tpu`` issues one all-reduce a step, independent
    of k), in ``dtype`` and their own shapes, the same bits on every rank."""
    flat = comm.allreduce(torch.cat([p.reshape(-1) for p in parts]).to(torch.float64)).to(dtype)
    return [f.reshape(p.shape) for f, p in zip(flat.split([p.numel() for p in parts]), parts)]


def _assign_across(arr: torch.Tensor, centers: torch.Tensor, comm=None):
    """``_assign`` of this rank's rows, with ``comm`` summed over the ranks
    (``_summed``, k·d + k + 1 values); a rank without rows adds zeros and
    launches nothing. Returns sums, counts and inertia in ``arr``'s dtype."""
    k, d = centers.shape
    if comm is not None and not arr.shape[0]:
        zeros = arr.new_zeros(k * d + k + 1)
        sums, counts, inertia = zeros[: k * d].reshape(k, d), zeros[k * d : -1], zeros[-1]
    else:
        sums, counts, inertia = _assign(arr, centers)
    if comm is None:
        return sums.to(arr.dtype), counts.to(arr.dtype), inertia.to(arr.dtype)
    return _summed(comm, arr.dtype, sums, counts, inertia)


def _lloyd_step(arr: torch.Tensor, centers: torch.Tensor, rows=None):
    """One Lloyd iteration: ``(arr, centers) -> (new_centers, shift²,
    inertia)`` (``heat_tpu`` kmeans.py:40), over every rank's rows with
    ``rows`` (a ``_kcluster._Rows``). Empty clusters keep their center."""
    sums, counts, inertia = _assign_across(arr, centers, None if rows is None else rows.comm)
    new_centers = torch.where(
        counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1), centers
    )
    shift = torch.sum((new_centers - centers) ** 2)
    return new_centers, shift, inertia


def _partial_fit_step(arr: torch.Tensor, centers: torch.Tensor, counts: torch.Tensor, comm=None):
    """One streaming minibatch update: ``(arr, centers, counts) ->
    (new_centers, new_counts, inertia)`` (``heat_tpu`` kmeans.py:92), the
    batch's sums and counts over every rank's rows with ``comm``. Every
    center is the mean of all samples ever assigned to it; counts and the
    mix run in float32 whatever the data's dtype."""
    sums, bcounts, inertia = _assign_across(arr, centers, comm)
    new_counts = counts + bcounts.to(torch.float32)
    c32 = centers.to(torch.float32)
    new_centers = torch.where(
        new_counts[:, None] > 0,
        (c32 * counts[:, None] + sums.to(torch.float32)) / torch.clamp_min(new_counts[:, None], 1),
        c32,
    ).to(arr.dtype)
    return new_centers, new_counts, inertia


class KMeans(_KCluster):
    """K-Means with Lloyd's algorithm (reference: kmeans.py:17).

    Parameters follow the reference: n_clusters, init
    ('random' | 'probability_based'/'kmeans++' | DNDarray), max_iter, tol,
    random_state. An operand split along axis 0 is fitted across the ranks,
    K3 on each rank's rows; every rank ends with the same centers.
    """

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
    ):
        if isinstance(init, str) and init == "kmeans++":
            init = "probability_based"
        super().__init__(
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
        )
        # streaming state (partial_fit): samples-per-center running counts,
        # None until the first batch initializes the centers
        self._partial_counts = None

    def _update_centroids(self, x: DNDarray, matching_centroids: DNDarray) -> DNDarray:
        """Masked-mean centroid update for given labels (reference:
        kmeans.py:74-100), over every rank's rows (the labels split like
        ``x``'s rows); ``fit`` uses the fused step."""
        x, arr, rows = self._operand(x)
        labels = matching_centroids.larray.to(device=arr.device, dtype=torch.int64)
        onehot = torch.nn.functional.one_hot(labels, self.n_clusters).to(arr.dtype)
        sums = onehot.T @ arr
        counts = torch.sum(onehot, dim=0)
        if rows.comm is not None:
            sums, counts = _summed(rows.comm, arr.dtype, sums, counts)
        centers = self._cluster_centers.larray
        new_centers = torch.where(
            counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1), centers
        )
        return self._replicated(new_centers, x)

    def fit(self, x: DNDarray, ckpt=None) -> "KMeans":
        """Run Lloyd iterations to convergence (reference: kmeans.py:102):
        seeding, the loop and the final assignment (see
        ``_KCluster._fit_fused``). A ``HostArray`` is fitted afresh by one
        epoch of ``partial_fit`` windows (``heat_tpu`` kmeans.py:218), or
        materialized and fitted whole under ``HEAT_TPU_OOC=0``."""
        from ..redistribution import staging

        if ckpt is not None:
            raise NotImplementedError(
                "KMeans.fit(ckpt=): checkpointed fits are not ported (ROADMAP.md Queue 1, item 13)"
            )
        if isinstance(x, staging.HostArray):
            if not staging.ooc_engaged(x.nbytes, host_resident=True):
                return self._fit_fused(staging.materialize(x, what="KMeans.fit"), _lloyd_step, returns_inertia=True)
            self._cluster_centers = self._partial_counts = None
            return self._partial_fit_stream(x)
        return self._fit_fused(x, _lloyd_step, returns_inertia=True)

    def partial_fit(self, x: DNDarray) -> "KMeans":
        """Incremental fit on one batch (sklearn MiniBatchKMeans-style): the
        first call initializes the centers from the batch with the
        configured ``init``, every call folds the batch into the per-center
        running means. ``inertia_`` reports the last batch's value. A
        ``HostArray`` streams its row windows, one update a window
        (materialized, one update, under ``HEAT_TPU_OOC=0``)."""
        from ..redistribution import staging

        if isinstance(x, staging.HostArray):
            if not staging.ooc_engaged(x.nbytes, host_resident=True):
                return self._partial_fit_batch(staging.materialize(x, what="KMeans.partial_fit"))
            return self._partial_fit_stream(x)
        return self._partial_fit_batch(x)

    def _partial_fit_stream(self, host) -> "KMeans":
        """One epoch of ``partial_fit`` updates over the row windows of a
        host-resident operand (``heat_tpu`` kmeans.py:296), planned as a
        ``host-staging`` plan proven to fit the card, each window one
        ``_partial_fit_batch`` of a whole (split None) window on every
        rank."""
        from ..core.communication import get_comm
        from ..core.devices import get_device
        from ..redistribution import staging

        sched = staging.prove_fits(staging.plan_staged_passes(
            host.shape, host.dtype, [{"tag": "partial-fit", "axis": 0}],
            out_bytes=self.n_clusters * host.shape[1] * 8 + (1 << 20),
        ))
        wins = staging.window_extents(host.shape, host.dtype.itemsize, 0, int(sched.staging["slab_bytes"]))
        device, comm = get_device(), get_comm()

        def consume(k, win, ext):
            batch = DNDarray(win, tuple(win.shape), types.canonical_heat_type(win.dtype), None, device, comm)
            self._partial_fit_batch(batch)

        staging.stream_windows(host, 0, wins, consume, device.torch_device)
        return self

    def _partial_fit_batch(self, x: DNDarray) -> "KMeans":
        sanitize_in(x)
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2-dimensional, got {x.ndim}")
        x, arr, rows = self._operand(x)
        if self._cluster_centers is None:
            self._init_centers(x, arr, rows)
        if self._partial_counts is None:
            # a fresh stream, also after fit(): it refines the fitted
            # centers from count zero
            self._partial_counts = torch.zeros(
                (self.n_clusters,), dtype=torch.float32, device=arr.device
            )
        centers = self._cluster_centers.larray.to(device=arr.device, dtype=arr.dtype)
        centers, self._partial_counts, self._inertia = _partial_fit_step(
            arr, centers, self._partial_counts, rows.comm
        )
        self._cluster_centers = self._replicated(centers, x)
        return self
