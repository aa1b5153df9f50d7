"""Array manipulations: ``reshape`` and ``resplit`` across ranks, and the
local sort family.

Port of part of ``heat_tpu.core.manipulations`` (Heat reference:
heat/core/manipulations.py, ``reshape`` at :1994, ``sort`` at :2428,
``unique`` at :3202, ``resplit`` at :3479, ``topk`` at :3981).
``reshape(..., new_split=)`` and ``resplit`` go through the
redistribution planner and executor (``heat_tpu_torch.redistribution``).
``sort``, ``unique`` and ``topk`` are the single-device branches, with the
helpers they use (``flip``, ``moveaxis``); all three run on the local sort
engine of ``heat_tpu_torch.kernels.sort``, whose radix pair-sort kernel K4
serves float32 and int32 on CUDA.

They agree with ``heat_tpu``: indices exactly; values under ``lax.sort``'s
comparator (values that pass through the key transform come back as +0.0
and the quiet NaN); ``unique`` collapses every NaN and ±0 as ``jnp.unique``
does, keeping the first of each group in input order; ``topk`` orders by
IEEE totalOrder, as ``lax.top_k`` does, lower index first among ties.

The distributed sorts (along the split axis of an array over more than one
rank) wait for the distributed sort programs (ROADMAP.md Queue 1, item 4).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import types
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


def _refuse_distributed(a: DNDarray, what: str, item: int = 4) -> None:
    if a.split is not None and a.comm.is_distributed():
        raise NotImplementedError(f"distributed {what} along the split axis: see ROADMAP.md Queue 1, item {item}")


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
    """Reverse element order along axis (reference: manipulations.py flip).
    A flip of the split axis across ranks moves shards between ranks and
    waits for ROADMAP.md Queue 1, item 9."""
    sanitize_in(a)
    axis = sanitize_axis(a.shape, axis)
    dims = tuple(range(a.ndim)) if axis is None else (axis if isinstance(axis, tuple) else (axis,))
    if a.split in dims:
        _refuse_distributed(a, "flip", item=9)
    return _wrap(torch.flip(a.larray, dims), a.split, a, dtype=a.dtype)


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
    stable argsort as int64 (reference: manipulations.py:2428).

    ``descending`` keeps ties in input order and puts NaNs first. On CUDA,
    float32 and int32 sort through kernel K4 when the axis is the only one,
    or its rows hold at most ``SEG_MAX`` elements; values coming back
    through the key transform are +0.0 for −0.0 and the quiet NaN for any
    NaN. Complex values sort lexicographically in (real, imag)."""
    sanitize_in(a)
    axis = sanitize_axis(a.shape, axis)
    if axis is None:
        axis = a.ndim - 1
    if a.split == axis:
        _refuse_distributed(a, "sort")
    values, indices = _ksort.local_sort(a.larray, axis=axis, descending=descending)
    vals = _wrap(values, a.split, a, dtype=a.dtype)
    idx = _wrap(indices.to(types.index_torch_type()), a.split, a)
    if out is not None:
        out.larray = vals.larray
        return out, idx
    return vals, idx


def topk(a: DNDarray, k: int, dim: int = -1, largest: bool = True, sorted: bool = True, out=None):
    """The k largest (or smallest) elements along ``dim``; returns (values,
    indices) (reference: manipulations.py:3981).

    The order is IEEE totalOrder, that of ``lax.top_k``: +0.0 above −0.0, a
    NaN with its sign bit set below −inf, and the lower index first among
    ties; ``largest=False`` is the ascending order. The result is sorted
    whatever ``sorted`` says, as in ``heat_tpu``. One stable sort of the
    totalOrder key gives it (K4's fused entry for float32 and int32 on
    CUDA, which writes only the indices); the values are gathered from the
    input, bit for bit."""
    sanitize_in(a)
    dim = sanitize_axis(a.shape, dim)
    if a.ndim == 0:
        raise ValueError("topk needs an array of at least one dimension")
    if a.split == dim:
        _refuse_distributed(a, "topk")
    n = a.shape[dim]
    if not 0 <= k <= n:
        raise ValueError(f"k must lie in [0, {n}] along axis {dim} of shape {a.shape}, got k={k}")
    if a.larray.is_complex():
        raise TypeError("topk of a complex array: complex has no order")
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


def _nan_canonical(t: torch.Tensor) -> torch.Tensor:
    """Complex values with a NaN in either part become nan+0j, as
    ``jnp.unique`` makes them before it sorts."""
    if not t.is_complex():
        return t
    return torch.where(torch.isnan(t), torch.full_like(t, complex(float("nan"), 0.0)), t)


def _columns_of(t: torch.Tensor):
    """Real columns of a 1-D tensor, most significant first: itself, or
    (real, imag) for complex."""
    if t.is_complex():
        return [t.real.contiguous(), t.imag.contiguous()]
    return [t]


def _lex_sort(cols):
    """Stable lexicographic argsort of rows whose columns are the 1-D real
    ``cols`` (most significant first), by their sort keys: one stable sort
    per column, the last column first, carrying the row permutation (the
    first of them K4's fused entry for float32 and int32 on CUDA). Returns
    the permutation and the columns' keys in its order."""
    perm = None
    for col in reversed(cols):
        if perm is None:
            last, perm = _ksort.sort_with_key(col)
        else:
            last, perm = _ksort.sort_keys(_ksort.sort_key(col[perm]), perm)
    return perm, [last] + [_ksort.sort_key(col[perm]) for col in cols[1:]]


def _groups(sorted_keys, n: int, device) -> torch.Tensor:
    """True where a run of equal keys begins."""
    start = torch.ones(n, dtype=torch.bool, device=device)
    if n > 1:
        differ = torch.zeros(n - 1, dtype=torch.bool, device=device)
        for key in sorted_keys:
            differ |= key[1:] != key[:-1]
        start[1:] = differ
    return start


def _unique_sorted(items: torch.Tensor, cols):
    """Unique items (rows of ``items`` along dim 0) by the keys of their
    columns: the first of each group in input order, and each item's
    group."""
    n = items.shape[0]
    perm, sorted_keys = _lex_sort(cols)
    start = _groups(sorted_keys, n, items.device)
    inverse = torch.empty(n, dtype=types.index_torch_type(), device=items.device)
    inverse[perm] = torch.cumsum(start, 0) - 1
    return items[perm[start]], inverse


def unique(a: DNDarray, sorted: bool = False, return_inverse: bool = False, axis: Optional[int] = None):
    """Unique elements, or unique slices along ``axis`` (reference:
    manipulations.py:3202), sorted, as ``jnp.unique`` gives them.

    Elements (and slices) are grouped on their sort keys, so every NaN is
    one value and ±0 another, and each group is represented by its first
    member in input order (``[-0., 0.]`` gives ``-0.``). The inverse has
    the input's shape, or the length of ``axis``. Slices sort
    lexicographically by one stable sort per column, last column first
    (K4 for float32 and int32 columns on CUDA)."""
    sanitize_in(a)
    if axis is not None:
        axis = sanitize_axis(a.shape, axis)
        if a.ndim == 1:
            axis = None  # 1-D slices are the elements
    if 0 not in a.gshape:
        _refuse_distributed(a, "unique")
    x = a.larray
    if axis is None:
        flat = _nan_canonical(x.reshape(-1))
        if flat.numel() == 0:
            values = flat
            inverse = torch.zeros(x.shape, dtype=types.index_torch_type(), device=x.device)
        else:
            values, inverse = _unique_sorted(flat, _columns_of(flat))
            inverse = inverse.reshape(x.shape)
    else:
        moved = _nan_canonical(x.movedim(axis, 0).contiguous())
        n = moved.shape[0]
        if moved.numel() == 0:
            # jnp.unique keeps one empty slice of an axis that has any
            values = moved[:1]
            inverse = torch.zeros(n, dtype=types.index_torch_type(), device=x.device)
        else:
            rows = moved.reshape(n, -1)
            cols = [c for j in range(rows.shape[1]) for c in _columns_of(rows[:, j].contiguous())]
            values, inverse = _unique_sorted(moved, cols)
        values = values.movedim(0, axis).contiguous()
    vals = _wrap(values, 0 if a.split is not None else None, a, dtype=a.dtype)
    if return_inverse:
        return vals, _wrap(inverse, None, a)
    return vals


# method attachment (reference attaches these on DNDarray)
DNDarray.reshape = lambda self, *shape, **kwargs: reshape(self, *shape, **kwargs)
DNDarray.flip = flip
DNDarray.moveaxis = moveaxis
DNDarray.sort = sort
DNDarray.topk = topk
DNDarray.unique = unique
