"""Array creation functions.

Port of ``heat_tpu.core.factories`` (Heat reference: heat/core/factories.py,
``arange`` at :41, ``array`` at :149, ``eye`` at :618, ``zeros`` at
:1405). Each factory builds its tensor directly on the target device. A
split array holds on each rank only its chunk (``comm.chunk``), and its
global values do not depend on the world size.
"""

from __future__ import annotations

from typing import Any, Optional, Type, Union

import numpy as np
import torch

from . import types
from .communication import Communication, sanitize_comm
from .devices import Device, sanitize_device
from .dndarray import DNDarray, _gather_lshapes
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = ["arange", "array", "eye", "zeros"]


def _wrap(data: torch.Tensor, dtype, split, device: Device, comm) -> DNDarray:
    """A DNDarray of the GLOBAL tensor ``data``, of which this rank keeps
    its chunk."""
    gshape = tuple(int(s) for s in data.shape)
    split = sanitize_axis(gshape, split)
    if split is not None and comm.is_distributed():
        _, _, slices = comm.chunk(gshape, split)
        data = data[slices].clone()
    return DNDarray(data, gshape, dtype, split, device, comm)


def _from_shards(data: torch.Tensor, dtype, split, device: Device, comm) -> DNDarray:
    """A DNDarray of which ``data`` is this rank's shard along ``split``;
    the global shape and the map of shard shapes come from all ranks."""
    split = sanitize_axis(tuple(data.shape), split)
    if split is None or not comm.is_distributed():
        return DNDarray(data, tuple(data.shape), dtype, split, device, comm)
    lmap = _gather_lshapes(comm, data)
    gshape = [int(s) for s in lmap[0]]
    gshape[split] = int(lmap[:, split].sum())
    return DNDarray(data, tuple(gshape), dtype, split, device, comm, lmap)


def arange(
    *args,
    dtype: Optional[Type[types.datatype]] = None,
    split: Optional[int] = None,
    device: Optional[Union[str, Device]] = None,
    comm: Optional[Communication] = None,
) -> DNDarray:
    """Evenly spaced values in [start, stop) (reference: factories.py:41;
    ``heat_tpu`` :147). Integer inputs default to int32, floats to
    float32; the values are ``i * step + start``, computed in 64 bits and
    then cast, as ``heat_tpu`` computes them. A split array computes only
    this rank's chunk."""
    num_args = len(args)
    if num_args == 0 or num_args > 3:
        raise TypeError(f"function takes 1 to 3 positional arguments, got {num_args}")
    start, stop, step = 0, args[0], 1
    if num_args >= 2:
        start, stop = args[0], args[1]
    if num_args == 3:
        step = args[2]
    if step == 0:
        raise ValueError("step must not be zero")
    all_ints = all(isinstance(a, (int, np.integer)) for a in (start, stop, step))
    if dtype is None:
        dtype = types.int32 if all_ints else types.float32
    dtype = types.canonical_heat_type(dtype)
    num = max(0, int(np.ceil((stop - start) / step)))
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    split = sanitize_axis((num,), split)
    offset, (count,), _ = comm.chunk((num,), split)
    wide = torch.int64 if types.heat_type_is_exact(dtype) else torch.float64
    data = torch.arange(offset, offset + count, dtype=wide, device=device.torch_device) * step + start
    return DNDarray(data.to(dtype.torch_type()), (num,), dtype, split, device, comm)


def array(
    obj: Any,
    dtype: Optional[Type[types.datatype]] = None,
    copy: Optional[bool] = None,
    ndmin: int = 0,
    order: str = "C",
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device: Optional[Union[str, Device]] = None,
    comm: Optional[Communication] = None,
) -> DNDarray:
    """Create a DNDarray from array-like data (reference: factories.py:149).

    ``split=`` distributes global data along that axis: each rank keeps
    its chunk. ``is_split=`` declares the data to be this rank's shard of
    an array split along that axis; the global shape is gathered from all
    ranks. A DNDarray keeps its split (and is resplit to ``split=``)."""
    if order not in ("C", "F"):
        raise ValueError(f"invalid order {order}")
    if split is not None and is_split is not None:
        raise ValueError(
            f"split and is_split are mutually exclusive, got split={split}, is_split={is_split}"
        )
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    if isinstance(obj, DNDarray) and is_split is None:
        data = obj.larray.to(device=device.torch_device)
        dtype = obj.dtype if dtype is None else types.canonical_heat_type(dtype)
        data = data.to(dtype.torch_type())
        if copy and data is obj.larray:
            data = data.clone()
        out = DNDarray(data, obj.gshape, dtype, obj.split, device, obj.comm, obj.lshape_map)
        if out.ndim < ndmin:
            out = out.reshape((1,) * (ndmin - out.ndim) + out.gshape)
        return out if split is None or split == obj.split else out.resplit(split)
    if isinstance(obj, DNDarray):
        obj = obj.larray
    # infer the heat type before numpy widens Python scalars to 64 bits
    if dtype is None:
        try:
            dtype = types.heat_type_of(obj)
        except TypeError:
            dtype = None
    else:
        dtype = types.canonical_heat_type(dtype)
    if isinstance(obj, torch.Tensor):
        data = obj.to(device=device.torch_device)
    else:
        np_data = np.asarray(obj)
        if np_data.dtype == object:
            raise TypeError(f"cannot create a DNDarray from {type(obj)}")
        # a copy: the DNDarray never aliases the caller's numpy buffer
        data = _tensor_of(np.array(np_data, order="C")).to(device.torch_device)
    if dtype is None:
        dtype = types.canonical_heat_type(data.dtype)
    data = data.to(dtype.torch_type())
    if copy and data is obj:
        data = data.clone()
    if data.ndim < ndmin:
        data = data.reshape((1,) * (ndmin - data.ndim) + tuple(data.shape))
    if is_split is not None:
        return _from_shards(data, dtype, is_split, device, comm)
    return _wrap(data, dtype, split, device, comm)


def _tensor_of(np_data: np.ndarray) -> torch.Tensor:
    """``torch.from_numpy``, which refuses bfloat16 (an extension type
    numpy holds through ``ml_dtypes``): its bits go across as uint16 and
    are viewed as torch.bfloat16, value for value."""
    if np_data.dtype.name == "bfloat16":
        return torch.from_numpy(np_data.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np_data)


def eye(shape, dtype=types.float32, split=None, device=None, comm=None, order: str = "C") -> DNDarray:
    """2-D array with ones on the diagonal (reference: factories.py:618)."""
    if order not in ("C", "F"):
        raise ValueError(f"order must be 'C' or 'F', got {order!r}")
    if isinstance(shape, (int, np.integer)):
        rows = cols = int(shape)
    else:
        shape = tuple(shape)
        rows, cols = (int(shape[0]), int(shape[0])) if len(shape) == 1 else (int(shape[0]), int(shape[1]))
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    split = sanitize_axis((rows, cols), split)
    offset, lshape, _ = comm.chunk((rows, cols), split)
    data = torch.zeros(lshape, dtype=dtype.torch_type(), device=device.torch_device)
    # global diagonal entries (i, i) that fall in this rank's chunk
    lo, hi = (offset, offset + lshape[split]) if split is not None else (0, min(rows, cols))
    idx = torch.arange(lo, max(lo, min(hi, rows, cols)), device=data.device)
    at = [idx, idx]
    if split is not None:
        at[split] = idx - offset
    data[at[0], at[1]] = 1
    return DNDarray(data, (rows, cols), dtype, split, device, comm)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Array of zeros (reference: factories.py:1405)."""
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    gshape = sanitize_shape(shape)
    split = sanitize_axis(gshape, split)
    _, lshape, _ = comm.chunk(gshape, split)
    data = torch.zeros(lshape, dtype=dtype.torch_type(), device=device.torch_device)
    return DNDarray(data, gshape, dtype, split, device, comm)
