"""Array creation functions.

Port of ``heat_tpu.core.factories`` (Heat reference: heat/core/factories.py,
``arange`` at :41, ``array`` at :149, ``eye`` at :618, ``zeros`` at
:1405). Each factory builds its tensor directly on the target device.
"""

from __future__ import annotations

from typing import Any, Optional, Type, Union

import numpy as np
import torch

from . import types
from .communication import Communication, sanitize_comm
from .devices import Device, sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = ["arange", "array", "eye", "zeros"]


def _wrap(data: torch.Tensor, dtype, split, device: Device, comm) -> DNDarray:
    split = sanitize_axis(tuple(data.shape), split)
    return DNDarray(data, tuple(data.shape), dtype, split, device, comm)


def arange(
    *args,
    dtype: Optional[Type[types.datatype]] = None,
    split: Optional[int] = None,
    device: Optional[Union[str, Device]] = None,
    comm: Optional[Communication] = None,
) -> DNDarray:
    """Evenly spaced values in [start, stop) (reference: factories.py:41).
    Integer inputs default to int32, floats to float32; the values are
    ``i * step + start``, computed in 64 bits and then cast, as
    ``heat_tpu`` computes them."""
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
    wide = torch.int64 if types.heat_type_is_exact(dtype) else torch.float64
    data = torch.arange(num, dtype=wide, device=device.torch_device) * step + start
    return _wrap(data.to(dtype.torch_type()), dtype, split, device, sanitize_comm(comm))


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

    ``split=`` labels global data as distributed along that axis;
    ``is_split=`` declares the data to be this process's shard, which at
    world size 1 is the whole array."""
    if order not in ("C", "F"):
        raise ValueError(f"invalid order {order}")
    if split is not None and is_split is not None:
        raise ValueError(
            f"split and is_split are mutually exclusive, got split={split}, is_split={is_split}"
        )
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    if isinstance(obj, DNDarray):
        if split is None and is_split is None:
            split = obj.split
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
        data = torch.from_numpy(np.array(np_data, order="C")).to(device.torch_device)
    if dtype is None:
        dtype = types.canonical_heat_type(data.dtype)
    data = data.to(dtype.torch_type())
    if copy and data is obj:
        data = data.clone()
    if data.ndim < ndmin:
        data = data.reshape((1,) * (ndmin - data.ndim) + tuple(data.shape))
    return _wrap(data, dtype, split if is_split is None else is_split, device, comm)


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
    data = torch.eye(rows, cols, dtype=dtype.torch_type(), device=device.torch_device)
    return _wrap(data, dtype, split, device, sanitize_comm(comm))


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Array of zeros (reference: factories.py:1405)."""
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    data = torch.zeros(sanitize_shape(shape), dtype=dtype.torch_type(), device=device.torch_device)
    return _wrap(data, dtype, split, device, sanitize_comm(comm))
