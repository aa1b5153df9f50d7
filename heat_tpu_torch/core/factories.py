"""Array creation functions.

Port of ``heat_tpu.core.factories`` (Heat reference: heat/core/factories.py,
``arange`` at :41, ``array`` at :149, ``eye`` at :618, ``full`` at :971,
``linspace`` at :1078, ``meshgrid`` at :1225, ``ones`` at :1308,
``zeros`` at :1405). Each factory builds its tensor directly on the target
device. A split array holds on each rank only its chunk (``comm.chunk``),
which the rank makes alone, and its global values do not depend on the
world size.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Type, Union

import numpy as np
import torch

from . import types
from .communication import Communication, sanitize_comm
from .devices import Device, sanitize_device
from ._operations import _whole
from .dndarray import DNDarray, _gather_lshapes
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "arange",
    "array",
    "asarray",
    "empty",
    "empty_like",
    "eye",
    "from_partition_dict",
    "from_partitioned",
    "full",
    "full_like",
    "linspace",
    "logspace",
    "meshgrid",
    "ones",
    "ones_like",
    "zeros",
    "zeros_like",
]


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


def _create(make: Callable, shape, dtype, split, device, comm) -> DNDarray:
    """A DNDarray of ``shape`` whose chunk ``make(lshape, torch dtype,
    torch device)`` builds on this rank."""
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    gshape = sanitize_shape(shape)
    split = sanitize_axis(gshape, split)
    _, lshape, _ = comm.chunk(gshape, split)
    return DNDarray(make(lshape, dtype.torch_type(), device.torch_device), gshape, dtype, split, device, comm)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Array of zeros (reference: factories.py:1405)."""
    return _create(lambda s, t, d: torch.zeros(s, dtype=t, device=d), shape, dtype, split, device, comm)


def ones(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Array of ones (reference: factories.py:1308; ``heat_tpu`` :465)."""
    return _create(lambda s, t, d: torch.ones(s, dtype=t, device=d), shape, dtype, split, device, comm)


def empty(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Array of unset values (reference: factories.py:520; ``heat_tpu``
    :306)."""
    return _create(lambda s, t, d: torch.empty(s, dtype=t, device=d), shape, dtype, split, device, comm)


def full(shape, fill_value, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Array filled with ``fill_value`` (reference: factories.py:971;
    ``heat_tpu`` :356), of the fill value's heat type by default (a Python
    float gives float32, an int int32)."""
    if dtype is None:
        dtype = types.heat_type_of(fill_value)
    value = fill_value if isinstance(fill_value, (bool, int, float, complex)) else np.asarray(fill_value).item()
    return _create(lambda s, t, d: torch.full(s, value, dtype=t, device=d), shape, dtype, split, device, comm)


def _like(a, factory: Callable, dtype, split, device, comm, *args) -> DNDarray:
    """``factory`` with ``a``'s shape, and its type, split, device and
    communicator where not given (reference: factories.py:751)."""
    shape = tuple(a.shape) if hasattr(a, "shape") else tuple(np.shape(a))
    if dtype is None:
        try:
            dtype = types.heat_type_of(a)
        except TypeError:
            dtype = types.float32
    split = getattr(a, "split", None) if split is None else split
    device = getattr(a, "device", None) if device is None else device
    comm = getattr(a, "comm", None) if comm is None else comm
    return factory(shape, *args, dtype=dtype, split=split, device=device, comm=comm)


def zeros_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Zeros of ``a``'s shape (``heat_tpu`` factories.py:480)."""
    return _like(a, zeros, dtype, split, device, comm)


def ones_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Ones of ``a``'s shape (``heat_tpu`` factories.py:469)."""
    return _like(a, ones, dtype, split, device, comm)


def empty_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Unset values of ``a``'s shape (``heat_tpu`` factories.py:317)."""
    return _like(a, empty, dtype, split, device, comm)


def full_like(a, fill_value, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """``fill_value`` in ``a``'s shape, of ``a``'s type by default
    (``heat_tpu`` factories.py:369)."""
    if dtype is None:
        dtype = a.dtype if isinstance(a, DNDarray) else types.heat_type_of(a)
    return _like(a, full, dtype, split, device, comm, fill_value)


def asarray(obj, dtype=None, copy=None, order="C", is_split=None, device=None) -> DNDarray:
    """``obj`` as a DNDarray, itself where it is one of the type asked
    (reference: factories.py:461; ``heat_tpu`` :290)."""
    if isinstance(obj, DNDarray) and copy is not True:
        if dtype is None or obj.dtype == types.canonical_heat_type(dtype):
            return obj
    return array(obj, dtype=dtype, copy=copy, is_split=is_split, device=device)


def linspace(start, stop, num: int = 50, endpoint: bool = True, retstep: bool = False, dtype=None, split=None,
             device=None, comm=None):
    """``num`` evenly spaced samples over [start, stop] (reference:
    factories.py:1078; ``heat_tpu`` :384). ``heat_tpu``'s formula: sample i
    is ``i · δ + start`` in float64 (one ``add`` with ``alpha=δ``, written
    in the output's type in the same pass), δ = (stop − start) / (num − 1)
    (or / num without the endpoint), the last one ``stop`` exactly, cast to
    ``dtype`` (float32 by default). Each rank computes its chunk."""
    num = int(num)
    if num <= 0:
        raise ValueError(f"number of samples expected to be positive, got {num}")
    start, stop = float(start), float(stop)
    div = (num - 1) if endpoint else num
    delta = (stop - start) / div if div > 0 else 0.0

    def make(lshape, tt, dev):
        offset = comm_.chunk((num,), split_)[0]
        i = torch.arange(offset, offset + lshape[0], dtype=torch.float64, device=dev)
        first = torch.tensor(start, dtype=torch.float64, device=dev)
        if tt.is_floating_point or tt.is_complex:
            values = torch.add(first, i, alpha=delta, out=torch.empty(lshape, dtype=tt, device=dev))
        else:
            values = torch.add(first, i, alpha=delta).to(tt)
        if endpoint and num > 1 and offset + lshape[0] == num:
            values[-1] = stop
        return values

    comm_ = sanitize_comm(comm)
    split_ = sanitize_axis((num,), split)
    result = _create(make, (num,), types.float32 if dtype is None else dtype, split_, device, comm_)
    if retstep:
        return result, (float("nan") if num == 1 else (stop - start) / div)
    return result


def logspace(start, stop, num: int = 50, endpoint: bool = True, base: float = 10.0, dtype=None, split=None,
             device=None, comm=None) -> DNDarray:
    """``base ** linspace(start, stop, num)`` (reference: factories.py:1162;
    ``heat_tpu`` :418): the power in float32, then cast to ``dtype``."""
    y = linspace(start, stop, num=num, endpoint=endpoint, split=split, device=device, comm=comm)
    result = DNDarray(torch.pow(base, y.larray), y.gshape, y.dtype, y.split, y.device, y.comm)
    return result if dtype is None else result.astype(types.canonical_heat_type(dtype))


def meshgrid(*arrays, indexing: str = "xy") -> List[DNDarray]:
    """Coordinate matrices from coordinate vectors (reference:
    factories.py:1225; ``heat_tpu`` :437). Where an input is split, every
    output is split along that input's axis (with ``xy`` the first two
    swap), and each rank builds its chunk from that input's own part and
    the other inputs whole."""
    if indexing not in ("xy", "ij"):
        raise ValueError(f"indexing must be 'xy' or 'ij', got {indexing}")
    if not arrays:
        return []
    arrs = [asarray(a) for a in arrays]
    at = next((i for i, a in enumerate(arrs) if a.split is not None), None)
    n = len(arrs)
    dims = list(range(n))
    if indexing == "xy" and n >= 2:
        dims[0], dims[1] = 1, 0
    shape = [0] * n
    for i, a in enumerate(arrs):
        shape[dims[i]] = a.size
    split = None if at is None else dims[at]
    comm = arrs[0].comm
    parts = [a._balanced_larray() if i == at and comm.is_distributed() else _whole(a) for i, a in enumerate(arrs)]
    lshape = list(shape)
    if split is not None:
        lshape[split] = parts[at].numel()
    out = []
    for i, (a, part) in enumerate(zip(arrs, parts)):
        view = [1] * n
        view[dims[i]] = -1
        local = part.reshape(-1).reshape(view).expand(lshape).contiguous()
        out.append(DNDarray(local, tuple(shape), a.dtype, split, arrs[0].device, comm))
    return out


def from_partitioned(x, comm: Optional[Communication] = None) -> DNDarray:
    """A DNDarray from an object with the ``__partitioned__`` interface
    (reference: factories.py:821; ``heat_tpu`` :493)."""
    parted = getattr(x, "__partitioned__", None)
    if parted is None:
        raise AttributeError("object does not expose __partitioned__")
    return from_partition_dict(parted() if callable(parted) else parted, comm)


def from_partition_dict(parted: dict, comm: Optional[Communication] = None) -> DNDarray:
    """A DNDarray from a partition dict (reference: factories.py:866;
    ``heat_tpu`` :504). Where every partition carries its data (a
    single-controller dict, as ``heat_tpu`` makes), the parts are put
    together in one tensor of their type, on the device of the first part
    where it is a tensor, and split along the tiled axis; else each rank
    declares the parts it holds (its ``locals``) as its shard."""
    comm = sanitize_comm(comm)
    gshape = tuple(int(s) for s in parted["shape"])
    tiling = tuple(int(t) for t in parted["partition_tiling"])
    tiled = [i for i, t in enumerate(tiling) if t > 1]
    if len(tiled) > 1:
        raise RuntimeError(f"only one split axis supported, found tiling {tiling}")
    split = tiled[0] if tiled else None
    get = parted.get("get", lambda v: v)
    parts = sorted(parted["partitions"].items())
    if all(part["data"] is not None for _, part in parts):
        whole = None
        for _, part in parts:
            data = _part_tensor(get(part["data"]))
            if whole is None:
                whole = torch.empty(gshape, dtype=data.dtype, device=data.device)
            at = tuple(slice(st, st + sh) for st, sh in zip(part["start"], data.shape))
            whole[at] = data
        return array(whole, split=split, comm=comm, copy=False, device="gpu" if whole.is_cuda else None)
    mine = [get(part["data"]) for _, part in parts if part["data"] is not None]
    local = torch.cat([torch.as_tensor(m) for m in mine], dim=split or 0)
    return array(local, is_split=split, comm=comm, device="gpu" if local.is_cuda else "cpu")


def _part_tensor(data) -> torch.Tensor:
    """A partition's data as a tensor of its own type (bfloat16 included),
    where it lies."""
    if isinstance(data, torch.Tensor):
        return data.detach()
    return _tensor_of(np.array(np.asarray(data), order="C"))

