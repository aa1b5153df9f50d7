"""Carrying state from ``heat_tpu`` into the port.

``heat_tpu`` holds its arrays as sharded ``jax.Array``s; what carries
across is their logical value, taken with ``DNDarray.numpy()``, with its
split and dtype. ``from_numpy`` gives this rank its chunk of such a global
array: rank r holds exactly the shard ``heat_tpu`` places on device r.

Random draws need nothing carried: the port draws ``heat_tpu``'s Threefry
stream, so the same seed gives the same values (the hSVD sketch operators
``g`` and ``Ω`` of ``svdtools.py:308`` and ``:417`` included), and
``ht.random.set_state(heat_tpu.random.get_state())`` continues
``heat_tpu``'s global stream where it stands.

A fitted k-clustering estimator carries across as its state
(``kcluster_from_numpy``), its private stream ``rng_state`` included;
``predict`` and ``partial_fit`` then continue from the same centers, and
its next init draws what ``heat_tpu``'s would.

A sparse matrix carries across as its components: a DCSR matrix as its
CSR arrays (``dcsr_from_numpy``), a DBCSR matrix as its physical brick
slabs (``dbcsr_from_numpy``), which are reassembled from ``heat_tpu``'s
per-device slabs into the one slab of world size 1.

A module of ``ht.nn`` takes a ``heat_tpu`` parameter dict (the result of
``init``, taken as numpy) with ``nn_params_from_numpy``: the port's modules
carry the same parameter names and layouts.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .dndarray import DNDarray
from .factories import array

__all__ = [
    "dbcsr_from_numpy",
    "dcsr_from_numpy",
    "from_numpy",
    "from_numpy_state",
    "kcluster_from_numpy",
    "nn_params_from_numpy",
]


def from_numpy(value: np.ndarray, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """The DNDarray of a ``heat_tpu`` array taken as a global numpy array
    (``DNDarray.numpy()``) with its ``split``: this rank keeps its chunk,
    in the array's own dtype (no 64→32-bit narrowing)."""
    value = np.asarray(value)
    return array(value, dtype=value.dtype, split=split, device=device, comm=comm)


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
        axis = split.get(name) if isinstance(split, Mapping) else split
        out[name] = from_numpy(value, split=axis, device=device)
    return out


def kcluster_from_numpy(cls, state: Mapping[str, np.ndarray], **params):
    """A fitted ``cls`` (``ht.cluster.KMeans``, ``KMedians`` or
    ``KMedoids``) built with ``params`` from the state of a ``heat_tpu``
    estimator, taken as numpy: ``cluster_centers_``, plus
    ``_partial_counts`` for a KMeans stream, and ``labels_``, ``n_iter_``,
    ``inertia_`` and ``rng_state`` (the private stream's state tuple) where
    present. Arrays keep their dtype and go to the
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
    if state.get("rng_state") is not None:
        est.rng_state = state["rng_state"]
    return est


def dcsr_from_numpy(indptr, indices, data, shape, split: Optional[int] = 0, device=None):
    """A ``DCSR_matrix`` of ``shape`` from global CSR components taken as
    numpy (``heat_tpu``'s ``indptr``, ``indices`` and ``data``), on
    ``device``. The values keep their numpy dtype; bfloat16 values come
    as float32 and are cast back with ``astype``."""
    from ..sparse.factories import _from_components
    from .communication import sanitize_comm
    from .devices import sanitize_device

    device = sanitize_device(device)
    data = torch.from_numpy(np.array(data))
    return _from_components(np.array(indptr), np.array(indices), data, tuple(shape), split, device,
                            sanitize_comm(None))


def dbcsr_from_numpy(components: Mapping[str, object], device=None):
    """A ``DBCSR_matrix`` from ``heat_tpu``'s physical DBCSR components
    taken as numpy: ``bdata``, ``bcol``, ``brow``, ``bmask``, ``slab_meta``,
    ``gnnz``, ``nbricks``, ``gshape`` and ``dtype`` (a type name or numpy
    dtype; bfloat16 bricks may come as float32), and ``split`` where given
    (default 0 for a layout of several slabs, else None).

    A layout of p > 1 slabs (``heat_tpu`` split 0 on its mesh) keeps each
    brick once, from the first slab that covers its row (the ownership
    order of ``heat_tpu``'s ``_to_scipy_bsr``), and is laid out again as
    the one slab of world size 1. ``bmask`` is derived anew for that slab."""
    from ..sparse.dbcsr_matrix import _bricks_from_slabs, _from_bricks
    from . import types
    from .communication import sanitize_comm
    from .devices import sanitize_device

    slab_meta = tuple(tuple(int(v) for v in t) for t in components["slab_meta"])
    bdata = np.asarray(components["bdata"])
    if bdata.dtype.name == "bfloat16":  # numpy holds it only through an extension type
        bdata = bdata.astype(np.float32)
    bdata, bcol, brow = _bricks_from_slabs(
        bdata, np.asarray(components["bcol"], np.int32), np.asarray(components["brow"], np.int32), slab_meta
    )
    if bcol.shape[0] != int(components["nbricks"]):
        raise ValueError(
            f"the slabs hold {bcol.shape[0]} distinct bricks, the components say nbricks={components['nbricks']}"
        )
    split = components.get("split", 0 if len(slab_meta) > 1 else None)
    return _from_bricks(
        bdata, bcol, brow, int(components["gnnz"]), tuple(components["gshape"]),
        types.canonical_heat_type(components["dtype"]), split, sanitize_device(device), sanitize_comm(None),
    )


def nn_params_from_numpy(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a ``heat_tpu`` parameter tree (``init``'s result, each value
    taken as numpy; bfloat16 may come as float32) into ``module``, an
    ``ht.nn`` module with the same parameter names and shapes: a dict for
    one module (``Conv2d``'s ``weight`` OIHW and ``bias`` included), a
    tuple of per-module dicts for a ``Sequential`` (``{}`` for a module
    without parameters). Each value takes the parameter's dtype and
    device. The tree must name exactly the module's parameters. Returns
    the module."""
    if isinstance(params, (tuple, list)):
        children = list(module.children())
        if len(children) != len(params):
            raise KeyError(f"{len(params)} parameter dicts for a module of {len(children)} modules")
        for child, sub in zip(children, params):
            nn_params_from_numpy(child, sub)
        return module
    own = dict(module.named_parameters())
    if set(own) != set(params):
        raise KeyError(f"parameters {sorted(params)} do not match the module's {sorted(own)}")
    with torch.no_grad():
        for name, value in params.items():
            value = np.asarray(value)
            if value.dtype.name == "bfloat16":  # numpy holds it only through an extension type
                value = value.astype(np.float32)
            p = own[name]
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name} has shape {value.shape}, the module's {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(value, order="C")).to(device=p.device, dtype=p.dtype))
    return module
