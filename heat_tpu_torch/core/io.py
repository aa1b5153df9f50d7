"""Parallel I/O: CSV, HDF5 and netCDF.

Port of ``heat_tpu.core.io`` (Heat reference: heat/core/io.py, ``load``
:1082-1133, ``load_hdf5`` :57, ``save_hdf5`` :166, ``load_csv`` :722,
``save_csv`` :948). ``heat_tpu``, one controller, reads one slab a device
and stitches them; the port reads as the Heat reference does, each rank
only its own part:

- HDF5 and netCDF: each rank reads the hyperslab of its ``comm.chunk``;
- CSV split 0 across ranks: each rank scans one byte range of the file for
  line starts, all-gathers share the counts and every 256th line's
  offset, and each rank reads the byte span of its rows; no rank holds the
  whole file. Split None and 1 parse the whole file on every rank, as
  ``heat_tpu`` and the reference do.

Writes go in rank order, nothing gathered: rank 0 creates the file (or
the dataset with the global shape) and writes its rows, then each later
rank opens it for appending (``r+`` for HDF5 and netCDF) and writes its
own, one barrier after each rank's turn. A CSV is written in
``np.savetxt``'s bytes with ``heat_tpu``'s ``fmt`` and header, so that the
two packages write the same file. bfloat16 is stored as float32.
``load_hdf5``/``save_hdf5`` exist where ``h5py`` imports, and
``load_netcdf``/``save_netcdf`` where ``netCDF4`` does.
"""

from __future__ import annotations

import io as _io
import os
from typing import Optional

import numpy as np
import torch

from . import types
from .communication import sanitize_comm
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = ["load", "load_csv", "save", "save_csv", "supports_hdf5", "supports_netcdf"]

try:
    import h5py

    __HDF5 = True
except ImportError:
    __HDF5 = False

try:
    import netCDF4

    __NETCDF = True
except ImportError:
    __NETCDF = False


def supports_hdf5() -> bool:
    """True if HDF5 I/O is available (reference: io.py supports_hdf5)."""
    return __HDF5


def supports_netcdf() -> bool:
    """True if netCDF I/O is available (reference: io.py supports_netcdf)."""
    return __NETCDF


def _np_storage_dtype(dtype) -> np.dtype:
    """On-disk numpy dtype for a heat type: bfloat16 has no HDF5, netCDF or
    CSV representation and is stored as float32 (exact)."""
    if dtype is types.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(torch.empty((), dtype=dtype.torch_type()).numpy().dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    """A shard on the host in its storage dtype (bfloat16 as float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _local_array(block: np.ndarray, gshape, dtype, split, device, comm) -> DNDarray:
    """A DNDarray from this rank's block of the chunk geometry (the whole
    array for ``split`` None)."""
    t = torch.from_numpy(np.ascontiguousarray(block)).to(device=device.torch_device, dtype=dtype.torch_type())
    return DNDarray(t, tuple(int(s) for s in gshape), dtype, split, device, comm)


def _read_hyperslabs(read, gshape, dtype, split, device, comm) -> DNDarray:
    """Each rank reads the hyperslab of its chunk with ``read(slices)``."""
    device, comm = sanitize_device(device), sanitize_comm(comm)
    gshape = tuple(int(s) for s in gshape)
    split = sanitize_axis(gshape, split)
    _, _, slices = comm.chunk(gshape, split)
    block = np.asarray(read(slices), dtype=_np_storage_dtype(dtype))
    return _local_array(block, gshape, dtype, split, device, comm)


def _in_rank_order(comm, write) -> None:
    """``write(first)`` on each rank in turn, ``first`` True on rank 0, one
    barrier after each turn."""
    for q in range(comm.size):
        if q == comm.rank:
            write(q == 0)
        comm.barrier()


def _rows_to_write(data: DNDarray):
    """(this rank's block as host numpy in its storage dtype or None, the
    slices it covers): every rank its shard of a split array, rank 0 the
    whole of one that is not split."""
    if data.is_distributed():
        _, displs = data.counts_displs()
        start = displs[data.comm.rank]
        sl = tuple(slice(start, start + n) if i == data.split else slice(0, n)
                   for i, n in enumerate(data.lshape))
        return _host(data.larray), sl
    if data.comm.rank == 0:
        return _host(data.larray), tuple(slice(0, n) for n in data.shape)
    return None, None


if __HDF5:
    __all__.extend(["load_hdf5", "save_hdf5"])

    def load_hdf5(
        path: str,
        dataset: str,
        dtype=types.float32,
        load_fraction: float = 1.0,
        split: Optional[int] = None,
        device=None,
        comm=None,
    ) -> DNDarray:
        """Load a dataset from an HDF5 file (reference: io.py:57): each rank
        opens the file read-only and reads the hyperslab of its chunk.
        ``load_fraction`` < 1 keeps that share of the split axis."""
        if not isinstance(path, str):
            raise TypeError(f"path must be str, got {type(path)}")
        if not isinstance(dataset, str):
            raise TypeError(f"dataset must be str, got {type(dataset)}")
        dtype = types.canonical_heat_type(dtype)
        with h5py.File(path, "r") as handle:
            ds = handle[dataset]
            gshape = list(ds.shape)
            if load_fraction < 1.0 and split is not None:
                gshape[split] = int(gshape[split] * load_fraction)
            return _read_hyperslabs(lambda sl: ds[sl], gshape, dtype, split, device, comm)

    def save_hdf5(data: DNDarray, path: str, dataset: str, mode: str = "w", **kwargs) -> None:
        """Save a DNDarray to HDF5 (reference: io.py:166) in rank order:
        rank 0 opens the file with ``mode``, creates the dataset of the
        global shape and writes its hyperslab; each later rank opens it
        ``r+`` and writes its own. Each handle closes before the next
        rank's turn."""
        if not isinstance(data, DNDarray):
            raise TypeError(f"data must be a DNDarray, got {type(data)}")
        if not isinstance(path, str):
            raise TypeError(f"path must be str, got {type(path)}")
        np_dtype = kwargs.pop("dtype", _np_storage_dtype(data.dtype))  # h5py casts on write
        block, sl = _rows_to_write(data)

        def write(first: bool) -> None:
            with h5py.File(path, mode if first else "r+") as handle:
                if first:
                    ds = handle.create_dataset(dataset, shape=data.shape, dtype=np_dtype, **kwargs)
                else:
                    ds = handle[dataset]
                if block is not None and block.size:
                    ds[sl] = block

        _in_rank_order(data.comm, write)


if __NETCDF:
    __all__.extend(["load_netcdf", "save_netcdf"])

    def load_netcdf(path, variable, dtype=types.float32, split=None, device=None, comm=None, **kwargs):
        """Load a variable from a netCDF file (reference: io.py:283): each
        rank reads the hyperslab of its chunk."""
        with netCDF4.Dataset(path, "r") as handle:
            var = handle.variables[variable]
            return _read_hyperslabs(lambda sl: np.asarray(var[sl]), tuple(var.shape),
                                    types.canonical_heat_type(dtype), split, device, comm)

    def save_netcdf(data, path, variable, mode="w", dimension_names=None, is_unlimited=False, **kwargs):
        """Save a DNDarray to netCDF (reference: io.py:366) in rank order:
        rank 0 opens the file with ``mode`` and creates the dimensions and
        the variable, each later rank opens it ``r+``; each writes its
        hyperslab."""
        if mode not in ("w", "a", "r+"):
            raise ValueError(f"mode must be one of 'w', 'a', 'r+', got {mode!r}")
        if not isinstance(data, DNDarray):
            raise TypeError(f"data must be a DNDarray, got {type(data)}")
        if dimension_names is None:
            dims = [f"{variable}_dim{i}" for i in range(data.ndim)]
        elif isinstance(dimension_names, str):
            dims = [dimension_names]
        else:
            dims = list(dimension_names)
        if len(dims) != data.ndim:
            raise ValueError(f"{len(dims)} dimension names given for {data.ndim} dimensions")
        block, sl = _rows_to_write(data)

        def write(first: bool) -> None:
            with netCDF4.Dataset(path, mode if first else "r+") as handle:
                for i, name in enumerate(dims):
                    if name not in handle.dimensions:
                        handle.createDimension(name, None if is_unlimited else data.shape[i])
                if variable in handle.variables:
                    var = handle.variables[variable]
                else:
                    var = handle.createVariable(variable, _np_storage_dtype(data.dtype), tuple(dims), **kwargs)
                if block is not None and block.size:
                    var[sl] = block

        _in_rank_order(data.comm, write)


_CSV_ANCHOR_STRIDE = 256  # one recorded line-start offset per 256 lines


def _parse_csv(raw: bytes, sep: str, np_dtype, encoding: str, header_lines: int = 0) -> np.ndarray:
    """The rows of CSV text as a 2-D array: NumPy's C parser (``loadtxt``,
    the values ``genfromtxt`` gives, several times faster); text it
    refuses (a missing field) goes through ``genfromtxt``, as ``heat_tpu``
    reads every file. One row or one column stays 2-D."""
    try:
        return np.loadtxt(_io.BytesIO(raw), delimiter=sep, dtype=np_dtype, encoding=encoding,
                          skiprows=header_lines, ndmin=2)
    except ValueError:
        data = np.genfromtxt(_io.BytesIO(raw), delimiter=sep, skip_header=header_lines, dtype=np_dtype,
                             encoding=encoding)
    if data.ndim < 2:
        # genfromtxt flattens single-column and single-row text alike;
        # the first data line's separators tell them apart
        lines = raw.decode(encoding).splitlines()[header_lines:]
        first = lines[0].strip() if lines else ""
        data = data.reshape(1, -1) if first.count(sep) else data.reshape(-1, 1)
    return data


def _csv_data_start(path: str, header_lines: int) -> int:
    """Byte offset of the first data row (after ``header_lines`` lines)."""
    off = 0
    with open(path, "rb") as fh:
        for _ in range(max(header_lines, 0)):
            line = fh.readline()
            if not line:
                break
            off += len(line)
    return off


def _csv_scan_range(path: str, start: int, stop: int, data_start: int, file_size: int):
    """Scan bytes [start, stop) of the file for line starts: (the lines this
    range owns, the offset of every ``_CSV_ANCHOR_STRIDE``-th of them). A
    line belongs to the range holding the newline before it; the first
    data row to the range that starts at ``data_start``."""
    count = 0
    anchors = []
    if start == data_start and data_start < file_size:
        anchors.append(data_start)
        count = 1
    with open(path, "rb") as fh:
        fh.seek(start)
        pos, remaining = start, stop - start
        while remaining > 0:
            buf = fh.read(min(1 << 22, remaining))
            if not buf:
                break
            idx = buf.find(b"\n")
            while idx >= 0:
                line_start = pos + idx + 1
                if line_start < file_size:  # a trailing newline starts no row
                    if count % _CSV_ANCHOR_STRIDE == 0:
                        anchors.append(line_start)
                    count += 1
                idx = buf.find(b"\n", idx + 1)
            pos += len(buf)
            remaining -= len(buf)
    return count, anchors


def _load_csv_split0(path: str, header_lines: int, sep: str, dtype, encoding: str, device, comm) -> DNDarray:
    """Split-0 CSV across ranks by byte ranges (reference io.py:807-900):
    rank r scans the r-th of ``size`` equal byte ranges of the data for
    line starts; two all-gathers share every rank's count and anchors; then
    each rank reads the byte span of the rows of its chunk and parses it.
    Rows must be non-empty and of one width."""
    device, comm = sanitize_device(device), sanitize_comm(comm)
    file_size = os.path.getsize(path)
    data_start = _csv_data_start(path, header_lines)
    p, me = comm.size, comm.rank
    span = file_size - data_start
    count, anchors = _csv_scan_range(path, data_start + me * span // p, data_start + (me + 1) * span // p,
                                     data_start, file_size)
    dev = device.torch_device
    sizes = comm.allgather(torch.tensor([[count, len(anchors)]], dtype=torch.int64, device=dev)).cpu().numpy()
    mine = torch.full((1, max(int(sizes[:, 1].max()), 1)), -1, dtype=torch.int64, device=dev)
    mine[0, : len(anchors)] = torch.tensor(anchors, dtype=torch.int64)
    offsets = comm.allgather(mine).cpu().numpy()
    cum = np.concatenate([[0], np.cumsum(sizes[:, 0])])
    n_rows = int(cum[-1])
    with open(path, "rb") as fh:
        fh.seek(data_start)
        first = fh.readline().decode(encoding)
    n_cols = first.rstrip("\r\n").count(sep) + 1 if first.strip() else 1

    def locate(row: int) -> int:
        """Byte offset of data row ``row``'s line start."""
        if row >= n_rows:
            return file_size
        q = int(np.searchsorted(cum, row, side="right") - 1)
        j = row - int(cum[q])
        a = j // _CSV_ANCHOR_STRIDE
        off = int(offsets[q, a])
        with open(path, "rb") as fh:
            fh.seek(off)
            for _ in range(j - a * _CSV_ANCHOR_STRIDE):
                fh.readline()
            return fh.tell()

    r0, (rows, _), _ = comm.chunk((n_rows, n_cols), 0)
    np_dtype = _np_storage_dtype(dtype)
    if rows:
        b0, b1 = locate(r0), locate(r0 + rows)
        with open(path, "rb") as fh:
            fh.seek(b0)
            raw = fh.read(b1 - b0)
        block = _parse_csv(raw, sep, np_dtype, encoding).reshape(rows, n_cols)
    else:
        block = np.zeros((0, n_cols), dtype=np_dtype)
    return _local_array(block, (n_rows, n_cols), dtype, 0, device, comm)


def load_csv(
    path: str,
    header_lines: int = 0,
    sep: str = ",",
    dtype=types.float32,
    encoding: str = "utf-8",
    split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """Load a CSV file (reference: io.py:722). Split 0 across ranks reads
    each rank's byte range (``_load_csv_split0``); otherwise every rank
    parses the whole file, as ``heat_tpu`` does."""
    if not isinstance(path, str):
        raise TypeError(f"path must be str, got {type(path)}")
    if split not in (None, 0, 1):
        raise ValueError(f"split must be in [None, 0, 1], but is {split}")
    dtype = types.canonical_heat_type(dtype)
    comm = sanitize_comm(comm)
    if split == 0 and comm.is_distributed():
        return _load_csv_split0(path, header_lines, sep, dtype, encoding, device, comm)
    with open(path, "rb") as fh:
        data = _parse_csv(fh.read(), sep, _np_storage_dtype(dtype), encoding, header_lines)
    from . import factories

    return factories.array(data, dtype=dtype, split=split, device=device, comm=comm)


def save_csv(
    data: DNDarray,
    path: str,
    header_lines=None,
    sep: str = ",",
    decimals: int = -1,
    **kwargs,
) -> None:
    """Save a DNDarray to CSV (reference: io.py:948) in ``np.savetxt``'s
    bytes, rows in rank order: rank 0 writes the header and its rows, each
    later rank appends its own. A split-1 array is resplit to 0 first (a
    CSV appends rows); rank 0 writes one that is not split."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, got {type(data)}")
    fmt = f"%.{decimals}f" if decimals >= 0 else "%s"
    header = "\n".join(header_lines) if header_lines else ""
    if data.is_distributed() and data.split != 0:
        data = data.resplit(0)
    block, _ = _rows_to_write(data)

    def write(first: bool) -> None:
        with open(path, "wb" if first else "ab") as fh:
            if first and header:
                fh.write((header + "\n").encode("latin1"))
            if block is not None and (block.size or block.ndim == 1 or first):
                rows = block.reshape(-1, 1) if block.ndim == 1 else block
                np.savetxt(fh, rows, delimiter=sep, fmt=fmt, comments="")

    _in_rank_order(data.comm, write)


def load(path: str, *args, **kwargs) -> DNDarray:
    """Load by file extension (reference: io.py:1082-1133)."""
    if not isinstance(path, str):
        raise TypeError(f"path must be str, got {type(path)}")
    ext = os.path.splitext(path)[-1].lower().strip()
    if ext in (".h5", ".hdf5"):
        if not __HDF5:
            raise RuntimeError(f"hdf5 is required for file extension {ext}")
        return load_hdf5(path, *args, **kwargs)
    if ext in (".nc", ".nc4", ".netcdf"):
        if not __NETCDF:
            raise RuntimeError(f"netcdf is required for file extension {ext}")
        return load_netcdf(path, *args, **kwargs)
    if ext == ".csv":
        return load_csv(path, *args, **kwargs)
    raise ValueError(f"unsupported file extension {ext}")


def save(data: DNDarray, path: str, *args, **kwargs) -> None:
    """Save by file extension (reference: io.py:~1050)."""
    if not isinstance(path, str):
        raise TypeError(f"path must be str, got {type(path)}")
    ext = os.path.splitext(path)[-1].lower().strip()
    if ext in (".h5", ".hdf5"):
        if not __HDF5:
            raise RuntimeError(f"hdf5 is required for file extension {ext}")
        return save_hdf5(data, path, *args, **kwargs)
    if ext in (".nc", ".nc4", ".netcdf"):
        if not __NETCDF:
            raise RuntimeError(f"netcdf is required for file extension {ext}")
        return save_netcdf(data, path, *args, **kwargs)
    if ext == ".csv":
        return save_csv(data, path, *args, **kwargs)
    raise ValueError(f"unsupported file extension {ext}")
