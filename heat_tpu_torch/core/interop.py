"""Carrying state from ``heat_tpu`` into the port.

``heat_tpu`` holds its arrays as sharded ``jax.Array``s; what carries
across is their logical value, taken with ``DNDarray.numpy()``, with its
split and dtype. The same goes for operators ``heat_tpu`` draws itself,
such as the hSVD sketch operators ``g`` and ``Ω`` (``svdtools.py:308`` and
``:417``): the port's own draws come from ``torch.Generator``s and differ,
so a caller that needs identical factors hands the drawn values across
and passes them to ``svdtools._sketched_uds_both(..., g=)`` /
``_one_view_uds_both(..., g=, omega=)``.

A fitted k-clustering estimator carries across as its state
(``kcluster_from_numpy``); ``predict`` and ``partial_fit`` then continue
from the same centers.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .dndarray import DNDarray
from .factories import array

__all__ = ["from_numpy_state", "kcluster_from_numpy"]


def from_numpy_state(
    values: Mapping[str, np.ndarray],
    split: Union[None, int, Mapping[str, Optional[int]]] = None,
    device=None,
) -> Dict[str, DNDarray]:
    """One DNDarray per entry of ``values``, with the entry's dtype (no
    64→32-bit narrowing) on ``device``.

    ``split`` is one split axis for every entry, or a mapping from entry
    name to its split axis (entries it does not name get None)."""
    out = {}
    for name, value in values.items():
        value = np.asarray(value)
        axis = split.get(name) if isinstance(split, Mapping) else split
        out[name] = array(value, dtype=value.dtype, split=axis, device=device)
    return out


def kcluster_from_numpy(cls, state: Mapping[str, np.ndarray], **params):
    """A fitted ``cls`` (``ht.cluster.KMeans``, ``KMedians`` or
    ``KMedoids``) built with ``params`` from the state of a ``heat_tpu``
    estimator, taken as numpy: ``cluster_centers_``, plus
    ``_partial_counts`` for a KMeans stream, and ``labels_``, ``n_iter_``
    and ``inertia_`` where present. Arrays keep their dtype and go to the
    default device; the labels come back as int64 with split None."""
    est = cls(**params)
    centers = array(np.asarray(state["cluster_centers_"]), split=None)
    est._cluster_centers = centers
    if state.get("_partial_counts") is not None:
        est._partial_counts = torch.tensor(
            np.asarray(state["_partial_counts"], dtype=np.float32), device=centers.larray.device
        )
    if state.get("labels_") is not None:
        est._labels = array(np.asarray(state["labels_"], dtype=np.int64), split=None)
    if state.get("n_iter_") is not None:
        est._n_iter = int(state["n_iter_"])
    if state.get("inertia_") is not None:
        est._inertia = float(state["inertia_"])
    return est
