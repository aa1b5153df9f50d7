"""Array manipulations: ``reshape`` and ``resplit`` across ranks, ``flip``,
``moveaxis`` and the sort family.

Port of part of ``heat_tpu.core.manipulations`` (Heat reference:
heat/core/manipulations.py, ``reshape`` at :1994, ``sort`` at :2428,
``unique`` at :3202, ``resplit`` at :3479, ``topk`` at :3981).
``reshape(..., new_split=)`` and ``resplit`` go through the
redistribution planner and executor (``heat_tpu_torch.redistribution``).
``sort``, ``unique`` and ``topk`` run on the local sort engine of
``heat_tpu_torch.kernels.sort``, whose radix pair-sort kernel K4 serves
float32 and int32 on CUDA; along the split axis of an array over more than
one rank they run the programs of ``heat_tpu_torch.core.parallel`` (the
columnsort or odd-even network, K4 sorting each rank's blocks, and
candidate all-gathers for ``topk`` and ``unique``). ``flip`` of the split
axis moves rows between ranks in one all-to-all.

They agree with ``heat_tpu``: indices exactly; values under ``lax.sort``'s
comparator (values that pass through the key transform come back as +0.0
and the quiet NaN); ``unique`` collapses every NaN and ±0 as ``jnp.unique``
does, keeping the first of each group in input order; ``topk`` orders by
IEEE totalOrder, as ``lax.top_k`` does, lower index first among ties.
Across ranks they follow ``heat_tpu``'s distributed branches: a descending
sort is the flip of the ascending one (NaNs first, ties in descending
index order); ``topk`` returns its result whole on every rank; a flat
``unique`` returns a 1-D inverse split 0, and ``unique(axis=)`` returns
canonical values (+0.0, the quiet NaN), as ``heat_tpu``'s rows
formulation does.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import _padding, parallel, types
from .dndarray import DNDarray
from .sanitation import sanitize_in
from .stride_tricks import sanitize_axis, sanitize_shape
from ..kernels import sort as _ksort

__all__ = ["flip", "moveaxis", "reshape", "resplit", "sort", "topk", "unique"]


def _wrap(result: torch.Tensor, split: Optional[int], ref: DNDarray, dtype=None) -> DNDarray:
    """An output DNDarray of this rank's ``result``, placed like ``ref``;
    across ranks its global shape is gathered from all of them."""
    from .factories import _from_shards

    if split is not None and result.ndim > 0:
        split = split % result.ndim
    else:
        split = None
    dtype = dtype if dtype is not None else types.canonical_heat_type(result.dtype)
    return _from_shards(result, dtype, split, ref.device, ref.comm)


def _chunk_of(whole: torch.Tensor, split: Optional[int], ref: DNDarray, dtype=None) -> DNDarray:
    """An output DNDarray of the global tensor ``whole``, which every rank
    holds; each keeps its chunk along ``split``."""
    from .factories import _wrap as _keep_chunk

    dtype = dtype if dtype is not None else types.canonical_heat_type(whole.dtype)
    return _keep_chunk(whole, dtype, split, ref.device, ref.comm)


def _normalize_reshape_args(a: DNDarray, shape, new_split):
    """Shape, -1 and ``new_split`` resolution shared by :func:`reshape` and
    ``ht.redistribution.explain(reshape=...)`` (heat_tpu
    manipulations.py:400)."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    shape = list(shape)
    neg = [i for i, s in enumerate(shape) if s == -1]
    if len(neg) > 1:
        raise ValueError("can only specify one unknown dimension")
    if neg:
        known = int(np.prod([s for s in shape if s != -1])) if len(shape) > 1 else 1
        if known == 0 or a.size % known != 0:
            raise ValueError(f"cannot reshape array of size {a.size} into shape {tuple(shape)}")
        shape[neg[0]] = a.size // known
    shape = sanitize_shape(tuple(shape))
    if int(np.prod(shape)) != a.size:
        raise ValueError(f"cannot reshape array of size {a.size} into shape {tuple(shape)}")
    if new_split is None:
        new_split = a.split
        if new_split is not None and new_split >= len(shape):
            # fewer output dims than the old split axis: clamp to the last
            new_split = len(shape) - 1
    return shape, sanitize_axis(shape, new_split)


def reshape(a: DNDarray, *shape, **kwargs) -> DNDarray:
    """Reshape without changing data (reference: manipulations.py:1994;
    heat_tpu :428). ``new_split=`` (default: the input's split, clamped to
    the new rank) places the result; across ranks the move is planned and
    run by ``heat_tpu_torch.redistribution`` (split-0 pivot, packed pivot
    with kernels K5/K6, or the explicit gather), and
    ``ht.redistribution.explain(a, reshape=shape, new_split=...)`` shows
    the plan."""
    sanitize_in(a)
    new_split = kwargs.pop("new_split", None)
    if kwargs:
        raise TypeError(f"reshape got unexpected keyword arguments {list(kwargs)}")
    shape, new_split = _normalize_reshape_args(a, shape, new_split)
    if len(shape) == 0:
        new_split = None
    if a.comm.is_distributed() and (a.split is not None or new_split is not None):
        from ..redistribution import executor

        local = executor.reshape_local(a.comm, a._balanced_larray(), a.gshape, a.split, shape, new_split)
    else:
        local = a.larray.reshape(shape)
    return DNDarray(local, shape, a.dtype, new_split, a.device, a.comm)


def resplit(arr: DNDarray, axis: Optional[int] = None) -> DNDarray:
    """Out-of-place resplit (reference: manipulations.py:3479)."""
    sanitize_in(arr)
    return arr.resplit(axis)


def flip(a: DNDarray, axis: Optional[Union[int, Tuple[int, ...]]] = None) -> DNDarray:
    """Reverse element order along axis (reference: manipulations.py flip;
    ``heat_tpu`` :260). Across ranks a flip of the split axis is one
    all-to-all: global row g goes to n − 1 − g."""
    sanitize_in(a)
    axis = sanitize_axis(a.shape, axis)
    dims = tuple(range(a.ndim)) if axis is None else (axis if isinstance(axis, tuple) else (axis,))
    if a.split in dims and a.is_distributed():
        local = _flip_split(a, torch.flip(a._balanced_larray(), dims))
        return DNDarray(local, a.gshape, a.dtype, a.split, a.device, a.comm)
    return _wrap(torch.flip(a.larray, dims), a.split, a, dtype=a.dtype)


def _flip_split(a: DNDarray, local: torch.Tensor) -> torch.Tensor:
    """Move this rank's rows, flipped in place (``local``), to the ranks that
    own their mirrored positions along the split axis."""
    comm, split, n = a.comm, a.split, a.gshape[a.split]
    counts, displs, _ = comm.counts_displs_shape(a.gshape, split)

    def overlap(lo: int, hi: int, q: int) -> int:
        return max(0, min(hi, displs[q] + counts[q]) - max(lo, displs[q]))

    def mirrored(q: int):  # where rank q's rows land, ascending
        return n - displs[q] - counts[q], n - displs[q]

    r = comm.rank
    send = [overlap(*mirrored(r), q) for q in range(comm.size)]
    recv = [overlap(*mirrored(q), r) for q in range(comm.size)]
    got = comm.alltoall(local.movedim(split, 0).contiguous(), send, recv)
    # the higher a source rank, the lower its rows land
    return torch.cat(torch.split(got, recv)[::-1]).movedim(0, split).contiguous()


def moveaxis(x: DNDarray, source, destination) -> DNDarray:
    """Move axes to new positions (reference: manipulations.py moveaxis)."""
    sanitize_in(x)
    if isinstance(source, int):
        source = (source,)
    if isinstance(destination, int):
        destination = (destination,)
    source = [sanitize_axis(x.shape, s) for s in source]
    destination = [sanitize_axis(x.shape, d) for d in destination]
    if len(source) != len(destination):
        raise ValueError("source and destination must have the same number of elements")
    perm = [n for n in range(x.ndim) if n not in source]
    for dest, src in sorted(zip(destination, source)):
        perm.insert(dest, src)
    split = None if x.split is None else perm.index(x.split)
    return _wrap(x.larray.permute(perm).contiguous(), split, x, dtype=x.dtype)


def sort(a: DNDarray, axis: int = -1, descending: bool = False, out=None):
    """Sort along an axis; returns (values, indices), the indices the
    stable argsort as int64 (reference: manipulations.py:2428; ``heat_tpu``
    :560).

    ``descending`` keeps ties in input order and puts NaNs first. On CUDA,
    float32 and int32 sort through kernel K4 when the axis is the only one,
    or its rows hold at most ``SEG_MAX`` elements; values coming back
    through the key transform are +0.0 for −0.0 and the quiet NaN for any
    NaN. Complex values sort lexicographically in (real, imag).

    Along the split axis across ranks it runs ``parallel.distributed_sort``
    on each rank's block, padded to ⌈n/p⌉ rows with the dtype's sentinel
    (columnsort where Leighton's bound admits it, else the odd-even
    network), and a descending sort is that result flipped, so that ties
    come in descending index order; complex values are gathered and
    argsorted, as ``heat_tpu`` does."""
    sanitize_in(a)
    axis = sanitize_axis(a.shape, axis)
    if axis is None:
        axis = a.ndim - 1
    if a.split == axis and a.is_distributed() and a.size > 0:
        vals, idx = _sort_split(a, axis, descending)
    else:
        values, indices = _ksort.local_sort(a.larray, axis=axis, descending=descending)
        vals = _wrap(values, a.split, a, dtype=a.dtype)
        idx = _wrap(indices.to(types.index_torch_type()), a.split, a)
    if out is not None:
        out.larray = vals.larray
        return out, idx
    return vals, idx


def _sort_split(a: DNDarray, axis: int, descending: bool):
    """``sort`` along the split axis of an array over more than one rank
    (``heat_tpu`` manipulations.py:580-597)."""
    comm = a.comm
    if a.larray.is_complex():
        values, indices = _ksort.local_sort(a.resplit(None).larray, axis=axis, descending=descending)
        return _chunk_of(values, axis, a, a.dtype), _chunk_of(indices, axis, a)
    block = -(-a.gshape[axis] // comm.size)
    padded = _padding.pad_to(a._balanced_larray(), axis, block, _ksort.sentinel(a.larray.dtype))
    sv, si = parallel.distributed_sort(padded, comm, axis)
    mine = comm.chunk(a.gshape, axis)[1][axis]
    vals = DNDarray(_padding.trim_to(sv, axis, mine).contiguous(), a.gshape, a.dtype, axis, a.device, comm)
    idx = DNDarray(_padding.trim_to(si, axis, mine).contiguous(), a.gshape, types.canonical_heat_type(si.dtype),
                   axis, a.device, comm)
    if descending:
        vals, idx = flip(vals, axis), flip(idx, axis)
    return vals, idx


def _losing(dtype: torch.dtype, largest: bool):
    """The value a pad holds in a distributed ``topk``: the dtype's least
    (``largest``) or greatest, as ``heat_tpu``'s ``_resolve_neutral``
    gives it."""
    if dtype.is_floating_point:
        return -float("inf") if largest else float("inf")
    if dtype == torch.bool:
        return not largest
    info = torch.iinfo(dtype)
    return info.min if largest else info.max


def topk(a: DNDarray, k: int, dim: int = -1, largest: bool = True, sorted: bool = True, out=None):
    """The k largest (or smallest) elements along ``dim``; returns (values,
    indices) (reference: manipulations.py:3981).

    The order is IEEE totalOrder, that of ``lax.top_k``: +0.0 above −0.0, a
    NaN with its sign bit set below −inf, and the lower index first among
    ties; ``largest=False`` is the ascending order. The result is sorted
    whatever ``sorted`` says, as in ``heat_tpu``. One stable sort of the
    totalOrder key gives it (K4's fused entry for float32 and int32 on
    CUDA, which writes only the indices); the values are gathered from the
    input, bit for bit.

    Along the split axis across ranks it runs ``parallel.distributed_topk``
    on each rank's block padded to ⌈n/p⌉ with the losing value (−inf or
    +inf, the integer extremes), and returns the result whole on every
    rank (split None), as ``heat_tpu`` does."""
    sanitize_in(a)
    dim = sanitize_axis(a.shape, dim)
    if a.ndim == 0:
        raise ValueError("topk needs an array of at least one dimension")
    n = a.shape[dim]
    if not 0 <= k <= n:
        raise ValueError(f"k must lie in [0, {n}] along axis {dim} of shape {a.shape}, got k={k}")
    if a.larray.is_complex():
        raise TypeError("topk of a complex array: complex has no order")
    if a.split == dim and a.is_distributed():
        block = -(-n // a.comm.size)
        padded = _padding.pad_to(a._balanced_larray(), dim, block, _losing(a.larray.dtype, largest))
        values, indices = parallel.distributed_topk(padded, a.comm, dim, k, largest)
        gshape = tuple(k if i == dim else s for i, s in enumerate(a.gshape))
        vals = DNDarray(values, gshape, a.dtype, None, a.device, a.comm)
        idx = DNDarray(indices, gshape, types.canonical_heat_type(indices.dtype), None, a.device, a.comm)
    else:
        x = a.larray.movedim(dim, -1).contiguous()
        order = _ksort.argsort(x, total=True, descending=largest).narrow(-1, 0, k).contiguous()
        values = x.gather(-1, order).movedim(-1, dim).contiguous()
        indices = order.movedim(-1, dim).contiguous().to(types.index_torch_type())
        vals = _wrap(values, a.split, a, dtype=a.dtype)
        idx = _wrap(indices, a.split, a)
    if out is not None:
        if not isinstance(out, tuple) or len(out) != 2:
            raise TypeError("out must be a (values, indices) tuple of DNDarrays")
        out[0].larray = vals.larray
        out[1].larray = idx.larray
        return out
    return vals, idx


def unique(a: DNDarray, sorted: bool = False, return_inverse: bool = False, axis: Optional[int] = None):
    """Unique elements, or unique slices along ``axis`` (reference:
    manipulations.py:3202), sorted, as ``jnp.unique`` gives them.

    Elements (and slices) are grouped on their sort keys, so every NaN is
    one value and ±0 another, and each group is represented by its first
    member in input order (``[-0., 0.]`` gives ``-0.``). The inverse has
    the input's shape, or the length of ``axis``. Slices sort
    lexicographically by one stable sort per column, last column first
    (K4 for float32 and int32 columns on CUDA).

    A split array over more than one rank takes ``heat_tpu``'s distributed
    branches (manipulations.py:813-949): each rank dedups its own items,
    and only the candidates are all-gathered and merged
    (``parallel.distributed_unique``). The values come back split 0; the
    flat inverse is 1-D, of length ``a.size``, split 0. Slices come back as
    the canonical values of ``heat_tpu``'s rows formulation; slices of
    more than 256 elements or of a dtype without a sortable transform are
    gathered, and their inverse is whole on every rank."""
    sanitize_in(a)
    if axis is not None:
        axis = sanitize_axis(a.shape, axis)
        if a.ndim == 1:
            axis = None  # 1-D slices are the elements
    if a.is_distributed() and 0 not in a.gshape:
        return _unique_split(a, axis, return_inverse)
    x = a.larray
    if axis is None:
        flat = x.reshape(-1)
        if flat.numel() == 0:
            values = flat
            inverse = torch.zeros(x.shape, dtype=types.index_torch_type(), device=x.device)
        else:
            values, inverse = parallel.sorted_dedup(flat)
            inverse = inverse.reshape(x.shape)
    else:
        moved = x.movedim(axis, 0).contiguous()
        if moved.numel() == 0:
            # jnp.unique keeps one empty slice of an axis that has any
            values = moved[:1]
            inverse = torch.zeros(moved.shape[0], dtype=types.index_torch_type(), device=x.device)
        else:
            values, inverse = parallel.sorted_dedup(moved)
        values = values.movedim(0, axis).contiguous()
    vals = _wrap(values, 0 if a.split is not None else None, a, dtype=a.dtype)
    if return_inverse:
        return vals, _wrap(inverse, None, a)
    return vals


def _unique_split(a: DNDarray, axis: Optional[int], return_inverse: bool):
    """``unique`` of a split array over more than one rank."""
    comm = a.comm
    if axis is None:
        arr = a if a.split == 0 else a.resplit(0)
        values, inverse = parallel.distributed_unique(arr._balanced_larray().reshape(-1), comm)
        vals = _chunk_of(values, 0, a, a.dtype)
        if not return_inverse:
            return vals
        # this rank's elements are a run of the flattened array: move them to its chunks
        lmap = np.prod(comm.lshape_map(arr.gshape, 0), axis=1, keepdims=True)
        inv = DNDarray(inverse, (a.size,), types.canonical_heat_type(inverse.dtype), 0, a.device, comm, lmap)
        inv.balance_()
        return vals, inv
    width = int(np.prod([s for i, s in enumerate(a.gshape) if i != axis]))
    dtype = a.larray.dtype
    if width > 256 or not (_ksort.transformable(dtype) or dtype == torch.bool):
        # heat_tpu's jnp.unique of the whole array (manipulations.py:940-949)
        vals, inv = unique(a.resplit(None), return_inverse=True, axis=axis)
        vals = _chunk_of(vals.larray, 0, a, a.dtype)
        return (vals, inv) if return_inverse else vals
    arr = a if axis == 0 else moveaxis(a, axis, 0)
    if arr.split != 0:
        arr = arr.resplit(0)
    values, inverse = parallel.distributed_unique(arr._balanced_larray(), comm)
    if dtype != torch.bool:  # the rows formulation compares the transformed words
        values = _ksort.from_sortable(_ksort.to_sortable(values), dtype)
    vals = _chunk_of(values.movedim(0, axis).contiguous(), 0, a, a.dtype)
    if not return_inverse:
        return vals
    inv = DNDarray(inverse, (arr.gshape[0],), types.canonical_heat_type(inverse.dtype), 0, a.device, comm)
    return vals, inv


# method attachment (reference attaches these on DNDarray)
DNDarray.reshape = lambda self, *shape, **kwargs: reshape(self, *shape, **kwargs)
DNDarray.flip = flip
DNDarray.moveaxis = moveaxis
DNDarray.sort = sort
DNDarray.topk = topk
DNDarray.unique = unique
