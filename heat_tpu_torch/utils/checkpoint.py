"""Checkpoint and resume of training state (port of
``heat_tpu.utils.checkpoint``).

``heat_tpu`` wraps orbax, which imports JAX, so the port writes its own
format with numpy and torch, and the two packages cannot read each other's
checkpoints. A checkpoint is a directory:

- ``tree.json``: the tree, with nested dicts, lists and tuples and plain
  scalars (int, float, bool, str, None) written inline, and a record in
  place of every array leaf;
- ``arrays/<leaf>.r<q>.npy``: rank q's shard of a DNDarray (its rows along
  the split axis, as it holds them), written by that rank, nothing
  gathered; a DNDarray that is not split is written once, by rank 0;
- ``leaves/<leaf>.npy``: a torch tensor or numpy array, written by rank 0.

Each array is stored in its own bytes: bfloat16 as its 16-bit words, so
that every dtype comes back bit for bit. ``load_checkpoint`` rebinds every
DNDarray to the current communicator at any world size: each rank reads
(memory-mapped) only the rows of its chunk from the shards that hold them,
so a checkpoint written at 4 ranks loads at 1, and one written at 1 loads
at 4, with the same bits. Rank 0 writes ``tree.json`` last, after a
barrier, so a directory with it is whole.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from ..core import types
from ..core.communication import sanitize_comm
from ..core.devices import sanitize_device
from ..core.dndarray import DNDarray

__all__ = ["save_checkpoint", "load_checkpoint"]

_DND_KEY = "__heat_dndarray__"
_TENSOR_KEY = "__tensor__"
_NDARRAY_KEY = "__ndarray__"
_ITEMS_KEY = "__items__"
_RESERVED = (_DND_KEY, "__tuple__", _TENSOR_KEY, _NDARRAY_KEY, _ITEMS_KEY)


def _stored(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as numpy: bfloat16 as its int16 words."""
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _restored(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class _Writer:
    """Encodes a tree into JSON records, writing the array leaves."""

    def __init__(self, path: str, comm):
        self.path, self.comm, self.count = path, comm, 0

    def leaf(self) -> str:
        self.count += 1
        return f"leaf{self.count}"

    def encode(self, obj):
        if isinstance(obj, dict):
            if any(k in obj for k in _RESERVED if isinstance(k, str)):
                raise ValueError(f"dict keys {', '.join(map(repr, _RESERVED))} are reserved by the checkpoint encoding")
            if all(isinstance(k, str) for k in obj):
                return {k: self.encode(v) for k, v in obj.items()}
            if not all(isinstance(k, (str, int, float, bool)) or k is None for k in obj):
                raise TypeError("checkpoint dict keys must be str, int, float, bool or None")
            return {_ITEMS_KEY: [[k, self.encode(v)] for k, v in obj.items()]}
        if isinstance(obj, (list, tuple)):
            enc = [self.encode(v) for v in obj]
            return enc if isinstance(obj, list) else {"__tuple__": enc}
        if isinstance(obj, DNDarray):
            return self.dndarray(obj)
        if isinstance(obj, torch.Tensor):
            name = self.leaf()
            if self.comm.rank == 0:
                np.save(os.path.join(self.path, "leaves", name + ".npy"), _stored(obj))
            return {_TENSOR_KEY: name, "dtype": _dtype_name(obj), "device": obj.device.type}
        if isinstance(obj, (np.ndarray, np.generic)):
            name = self.leaf()
            if self.comm.rank == 0:
                np.save(os.path.join(self.path, "leaves", name + ".npy"), np.asarray(obj), allow_pickle=False)
            return {_NDARRAY_KEY: name, "scalar": isinstance(obj, np.generic)}
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return obj
        raise TypeError(f"cannot checkpoint a {type(obj).__name__}")

    def dndarray(self, x: DNDarray) -> dict:
        name = self.leaf()
        split = x.split if x.is_distributed() else None
        if split is not None or self.comm.rank == 0:
            q = self.comm.rank if split is not None else 0
            np.save(os.path.join(self.path, "arrays", f"{name}.r{q}.npy"), _stored(x.larray))
        counts = [int(c) for c in x.lshape_map[:, split]] if split is not None else [0]
        return {_DND_KEY: name, "gshape": list(x.gshape), "split": -1 if x.split is None else int(x.split),
                "stored_split": -1 if split is None else int(split), "counts": counts,
                "dtype": x.dtype.__name__}


def save_checkpoint(path: str, tree: Any, overwrite: bool = True) -> None:
    """Write a tree of DNDarrays, tensors, numpy arrays and scalars (nested
    dicts, lists and tuples) to the directory ``path``. Every rank calls
    it; each writes its own shards, rank 0 the rest. ``overwrite=False``
    refuses an existing directory."""
    comm = sanitize_comm(None)
    path = os.path.abspath(path)
    if comm.rank == 0:
        if os.path.exists(path):
            if not overwrite:
                raise FileExistsError(f"checkpoint {path} exists (overwrite=False)")
            shutil.rmtree(path)
        os.makedirs(os.path.join(path, "arrays"))
        os.makedirs(os.path.join(path, "leaves"))
    comm.barrier()
    writer = _Writer(path, comm)
    encoded = writer.encode(tree)
    comm.barrier()  # every shard is on disk
    if comm.rank == 0:
        with open(os.path.join(path, "tree.json"), "w") as f:
            json.dump({"format": "heat_tpu_torch checkpoint 1", "tree": encoded}, f)
    comm.barrier()


def _read_rows(path: str, name: str, rec: dict, comm, device) -> DNDarray:
    """A stored DNDarray on ``comm``: this rank's chunk along its split,
    read from the shards that hold it (the whole array where it is not
    split)."""
    gshape = tuple(int(s) for s in rec["gshape"])
    split = None if int(rec["split"]) < 0 else int(rec["split"])
    stored = int(rec["stored_split"])
    if stored < 0:  # one file, the whole array
        whole = np.load(os.path.join(path, "arrays", f"{name}.r0.npy"), mmap_mode="r")
        local = whole[comm.chunk(gshape, split)[2]]
    else:
        start, lshape, _ = comm.chunk(gshape, stored)
        stop = start + lshape[stored]
        edges = np.concatenate([[0], np.cumsum(rec["counts"])]).astype(np.int64)
        parts = []
        for q in range(len(rec["counts"])):
            lo, hi = max(start, int(edges[q])), min(stop, int(edges[q + 1]))
            if hi > lo:
                shard = np.load(os.path.join(path, "arrays", f"{name}.r{q}.npy"), mmap_mode="r")
                parts.append(shard[tuple(slice(lo - int(edges[q]), hi - int(edges[q])) if a == stored
                                         else slice(None) for a in range(len(gshape)))])
        local = np.concatenate(parts, axis=stored) if parts else np.zeros(lshape, dtype=_np_of(rec["dtype"]))
    t = _restored(np.array(local), rec["dtype"]).to(device.torch_device)
    return DNDarray(t, gshape, getattr(types, rec["dtype"]), split, device, comm)


def _np_of(dtype: str) -> np.dtype:
    """The numpy dtype a stored array of heat type ``dtype`` has on disk."""
    if dtype == "bfloat16":
        return np.dtype(np.int16)
    return np.dtype(torch.empty((), dtype=getattr(types, dtype).torch_type()).numpy().dtype)


def _decode(obj, path: str, comm, device):
    if isinstance(obj, dict):
        if _DND_KEY in obj:
            return _read_rows(path, obj[_DND_KEY], obj, comm, device)
        if _TENSOR_KEY in obj:
            t = _restored(np.load(os.path.join(path, "leaves", obj[_TENSOR_KEY] + ".npy")), obj["dtype"])
            return t.to(device.torch_device) if obj["device"] != "cpu" else t
        if _NDARRAY_KEY in obj:
            a = np.load(os.path.join(path, "leaves", obj[_NDARRAY_KEY] + ".npy"), allow_pickle=False)
            return a[()] if obj["scalar"] else a
        if _ITEMS_KEY in obj:
            return {k: _decode(v, path, comm, device) for k, v in obj[_ITEMS_KEY]}
        if "__tuple__" in obj and len(obj) == 1:
            return tuple(_decode(v, path, comm, device) for v in obj["__tuple__"])
        return {k: _decode(v, path, comm, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, path, comm, device) for v in obj]
    return obj


def load_checkpoint(path: str, comm=None, device=None) -> Any:
    """Read a tree written by ``save_checkpoint``. DNDarrays rebind to
    ``comm`` (default: the world) on ``device`` with their recorded split,
    each rank reading the rows of its chunk; tensors that were on a card
    come back on ``device``'s, the rest on the CPU."""
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    path = os.path.abspath(path)
    with open(os.path.join(path, "tree.json")) as f:
        stored = json.load(f)
    return _decode(stored["tree"], path, comm, device)
