"""Array manipulations across ranks (port of ``heat_tpu.core.manipulations``;
Heat reference: heat/core/manipulations.py, ``concatenate`` at :390,
``pad`` at :1328, ``reshape`` at :1994, ``roll`` at :2156, ``sort`` at
:2428, ``unique`` at :3202, ``resplit`` at :3479, ``topk`` at :3981).

Every function takes this rank's shard and keeps ``heat_tpu``'s values,
heat type, global shape and split. The layouts are the Heat reference's:

- a result whose rows stay with their owner keeps them where they fall
  (``squeeze``, ``expand_dims``, ``swapaxes``, ``flatten`` of a split-0
  operand, the splits, ``pad``, ``roll``, ``repeat`` along the split axis,
  ``diag``, ``diagonal`` and every join off the split axis), so its
  ``lshape_map`` may be uneven;
- rows that change owner move once, in one all-to-all with the counts of
  the overlap of each source and target range (``concatenate`` along the
  split axis, ``roll`` and ``tile`` along it, ``flip``), and the result of
  a join or a tile along the split axis comes in the chunk geometry of its
  shape;
- an operand split along another axis is resplit through the planner
  (``redistribution/``) to the result's split, a replicated operand is
  sliced to each rank's rows, and operands of one split but different maps
  of shard shapes are brought to one map by ``redistribute_``.

``reshape(..., new_split=)`` and ``resplit`` go through the redistribution
planner and executor (``heat_tpu_torch.redistribution``). ``sort``,
``unique`` and ``topk`` run on the local sort engine of
``heat_tpu_torch.kernels.sort``, whose radix pair-sort kernel K4 serves
float32 and int32 on CUDA; along the split axis of an array over more than
one rank they run the programs of ``heat_tpu_torch.core.parallel`` (the
columnsort or odd-even network, K4 sorting each rank's blocks, and
candidate all-gathers for ``topk`` and ``unique``).

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

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import _padding, parallel, types
from .dndarray import DNDarray
from .sanitation import sanitize_in, sanitize_sequence
from .stride_tricks import broadcast_shapes, sanitize_axis, sanitize_shape
from ..kernels import sort as _ksort

__all__ = [
    "balance",
    "broadcast_arrays",
    "broadcast_to",
    "collect",
    "column_stack",
    "concatenate",
    "diag",
    "diagonal",
    "dsplit",
    "expand_dims",
    "flatten",
    "flip",
    "fliplr",
    "flipud",
    "hsplit",
    "hstack",
    "moveaxis",
    "pad",
    "ravel",
    "redistribute",
    "repeat",
    "reshape",
    "resplit",
    "roll",
    "rot90",
    "row_stack",
    "shape",
    "sort",
    "split",
    "squeeze",
    "stack",
    "swapaxes",
    "tile",
    "topk",
    "unique",
    "vsplit",
    "vstack",
]


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
    all-to-all: each rank's rows, reversed, land at their mirrored rows, in
    the chunk geometry; a flip of other axes keeps the map (no collective)."""
    sanitize_in(a)
    axis = sanitize_axis(a.shape, axis)
    dims = tuple(range(a.ndim)) if axis is None else (axis if isinstance(axis, tuple) else (axis,))
    if a.split in dims and a.is_distributed():
        split, n = a.split, a.gshape[a.split]
        counts = a.lshape_map[:, split]
        st = _starts(counts)
        pieces = [[(n - int(st[q + 1]), 0, 0, int(counts[q]))] if counts[q] else [] for q in range(a.comm.size)]
        local = _land(a.comm, [torch.flip(a.larray, dims)], split, pieces, a.comm.lshape_map(a.gshape, split)[:, split])
        return DNDarray(local, a.gshape, a.dtype, split, a.device, a.comm)
    counts = a.lshape_map[:, a.split] if a.split is not None else None
    return _dnd(torch.flip(a.larray, dims), a.gshape, a.dtype, a.split, a, counts)


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


# --------------------------------------------------------------------- #
# rows across ranks: layouts every rank knows                           #
# --------------------------------------------------------------------- #
def _starts(counts) -> np.ndarray:
    """Global start of each rank's rows, and the end: (size + 1,)."""
    return np.concatenate([[0], np.cumsum(np.asarray(counts, dtype=np.int64))]).astype(np.int64)


def _dnd(local: torch.Tensor, gshape, dtype, split: Optional[int], ref: DNDarray, counts=None) -> DNDarray:
    """A DNDarray of this rank's ``local`` whose shards along ``split`` have
    the extents ``counts`` (which every rank knows; None: the chunk
    geometry), so no collective learns the map. The map must hold this
    rank's shard and add up to the global extent, at every world size."""
    lmap = None
    if split is not None:
        if counts is None:
            lmap = ref.comm.lshape_map(gshape, split)
        else:
            lmap = np.tile(np.array(gshape, dtype=np.int64), (ref.comm.size, 1))
            lmap[:, split] = np.asarray(counts, dtype=np.int64)
        if tuple(lmap[ref.comm.rank]) != tuple(local.shape) or int(lmap[:, split].sum()) != int(gshape[split]):
            raise RuntimeError(f"shard map {lmap[:, split].tolist()} does not hold this rank's shard "
                               f"{tuple(local.shape)} of {tuple(gshape)} split {split}")
    return DNDarray(local, tuple(int(s) for s in gshape), dtype, split, ref.device, ref.comm, lmap)


def _cut(pieces, lo: int, hi: int):
    """The parts inside global rows [lo, hi) of ``pieces`` (dst, operand,
    src, n: n rows of an operand from its local row src, landing at global
    row dst), in global order."""
    out = []
    for dst, i, src, n in pieces:
        a, b = max(dst, lo), min(dst + n, hi)
        if a < b:
            out.append((a, i, src + a - dst, b - a))
    return sorted(out)


def _land(comm, operands, axis: int, pieces, counts) -> torch.Tensor:
    """Move rows along ``axis`` so that each rank ends with its rows of the
    result laid out by ``counts``, in global order: one all-to-all with the
    counts of the overlap of each source piece and target range.
    ``operands`` are this rank's tensors (of one dtype and one shape off
    ``axis``), ``pieces[q]`` rank q's (dst, operand, src, n), which every
    rank knows; a rank puts what it receives in global order."""
    p, r = comm.size, comm.rank
    bounds = _starts(counts)
    moved = [t.movedim(axis, 0) for t in operands]
    parts, send_counts = [], []
    for q in range(p):
        mine = _cut(pieces[r], bounds[q], bounds[q + 1])
        parts += [moved[i][s : s + n] for _, i, s, n in mine]
        send_counts.append(sum(n for *_, n in mine))
    send = torch.cat(parts) if parts else moved[0][:0]
    arrivals, recv_counts, at = [], [], 0
    for q in range(p):
        theirs = _cut(pieces[q], bounds[r], bounds[r + 1])
        for dst, _, _, n in theirs:
            arrivals.append((dst, at, n))
            at += n
        recv_counts.append(sum(n for *_, n in theirs))
    got = comm.alltoall(send.contiguous(), send_counts, recv_counts)
    order = sorted(arrivals)
    if order != arrivals:
        got = torch.cat([got[s : s + n] for _, s, n in order])
    return got.movedim(0, axis).contiguous()


def _rows_of(x: DNDarray, split: int, counts) -> torch.Tensor:
    """This rank's rows of ``x`` along ``split`` in the map of extents
    ``counts``: its own shard, moved there by ``redistribute_`` where its
    map differs; a slice where ``x`` is whole on every rank."""
    from ._operations import _rows

    if x.split == split and x.is_distributed():
        return _rows(x, split, counts)
    st = _starts(counts)
    r = x.comm.rank
    return x.larray.narrow(split, int(st[r]), int(counts[r]))


def _owner_bcast(x: DNDarray) -> torch.Tensor:
    """``x``'s global tensor on every rank where its split axis has extent 1
    (one rank holds it): one broadcast from that rank."""
    owner = int(np.argmax(x.lshape_map[:, x.split]))
    buf = x.larray if x.comm.rank == owner else x.larray.new_empty(x.gshape)
    return x.comm.bcast(buf.contiguous(), root=owner)


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy with its own memory."""
    return t.clone(memory_format=torch.contiguous_format)


# --------------------------------------------------------------------- #
# shape-only functions                                                  #
# --------------------------------------------------------------------- #
def shape(a: DNDarray) -> Tuple[int, ...]:
    """The global shape (``heat_tpu`` manipulations.py:508)."""
    sanitize_in(a)
    return a.gshape


def squeeze(x: DNDarray, axis: Optional[Union[int, Tuple[int, ...]]] = None) -> DNDarray:
    """Remove axes of extent 1 (``heat_tpu`` manipulations.py:638): a view
    of each shard, the split moving with its axis. Squeezing the split axis
    (extent 1, so one rank holds it) gives split None: its owner
    broadcasts it (one broadcast)."""
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    if axis is None:
        axes = tuple(i for i, s in enumerate(x.shape) if s == 1)
    else:
        axes = (axis,) if isinstance(axis, int) else axis
        for ax in axes:
            if x.shape[ax] != 1:
                raise ValueError(f"Dimension along axis {ax} is not 1 for shape {x.shape}")
    keep = [i for i in range(x.ndim) if i not in axes]
    gshape = tuple(x.gshape[i] for i in keep)
    split = x.split
    if split is not None and split in axes:
        whole = _owner_bcast(x) if x.is_distributed() else x.larray
        return DNDarray(whole.reshape(gshape), gshape, x.dtype, None, x.device, x.comm)
    local = x.larray.reshape(tuple(x.lshape[i] for i in keep))
    if split is None:
        return DNDarray(local, gshape, x.dtype, None, x.device, x.comm)
    split -= sum(1 for ax in axes if ax < split)
    return _dnd(local, gshape, x.dtype, split, x, x.lshape_map[:, x.split])


def expand_dims(a: DNDarray, axis: int) -> DNDarray:
    """Insert an axis of extent 1 (``heat_tpu`` manipulations.py:232): a
    view of each shard; the split moves with its axis."""
    sanitize_in(a)
    axis = sanitize_axis(tuple(a.shape) + (1,), axis)
    gshape = a.gshape[:axis] + (1,) + a.gshape[axis:]
    split = a.split
    if split is None:
        return DNDarray(a.larray.unsqueeze(axis), gshape, a.dtype, None, a.device, a.comm)
    counts = a.lshape_map[:, split]
    if axis <= split:
        split += 1
    return _dnd(a.larray.unsqueeze(axis), gshape, a.dtype, split, a, counts)


def swapaxes(x: DNDarray, axis1: int, axis2: int) -> DNDarray:
    """Interchange two axes (``heat_tpu`` manipulations.py:701): each shard
    copied in the new order; the split moves with its axis, no rows move."""
    sanitize_in(x)
    axis1 = sanitize_axis(x.shape, axis1)
    axis2 = sanitize_axis(x.shape, axis2)
    perm = list(range(x.ndim))
    perm[axis1], perm[axis2] = perm[axis2], perm[axis1]
    gshape = tuple(x.gshape[i] for i in perm)
    local = _own(x.larray.transpose(axis1, axis2))
    if x.split is None:
        return DNDarray(local, gshape, x.dtype, None, x.device, x.comm)
    return _dnd(local, gshape, x.dtype, perm.index(x.split), x, x.lshape_map[:, x.split])


def broadcast_to(x: DNDarray, shape: Tuple[int, ...]) -> DNDarray:
    """Broadcast to ``shape`` (``heat_tpu`` manipulations.py:116): the split
    shifts by the new leading axes. Each shard is broadcast where it is; a
    split axis of extent 1 that is broadcast is sent by its owner (one
    broadcast) and each rank takes its chunk of the result."""
    sanitize_in(x)
    shape = sanitize_shape(shape)
    lead = len(shape) - x.ndim
    if lead < 0:
        raise ValueError(f"Cannot broadcast to shape with fewer dimensions: arr_shape={x.shape} shape={shape}")
    if any(s != t and s != 1 for s, t in zip(x.gshape, shape[lead:])):
        raise ValueError(f"Incompatible shapes for broadcasting: {x.shape} and requested shape {shape}")
    if x.split is None or not x.is_distributed():
        split = None if x.split is None else x.split + lead
        return DNDarray(_own(torch.broadcast_to(x.larray, shape)), shape, x.dtype, split, x.device, x.comm)
    split = x.split + lead
    if x.gshape[x.split] == shape[split]:
        counts = x.lshape_map[:, x.split]
        local_shape = list(shape)
        local_shape[split] = x.lshape[x.split]
        return _dnd(_own(torch.broadcast_to(x.larray, local_shape)), shape, x.dtype, split, x, counts)
    local_shape = x.comm.chunk(shape, split)[1]
    return _dnd(_own(torch.broadcast_to(_owner_bcast(x), local_shape)), shape, x.dtype, split, x)


def broadcast_arrays(*arrays: DNDarray) -> List[DNDarray]:
    """Broadcast arrays against each other (``heat_tpu``
    manipulations.py:105)."""
    if not arrays:
        return []
    for a in arrays:
        sanitize_in(a)
    target = broadcast_shapes(*[a.shape for a in arrays]) if len(arrays) > 1 else arrays[0].shape
    return [broadcast_to(a, target) for a in arrays]


def flatten(a: DNDarray) -> DNDarray:
    """Collapse into one dimension (``heat_tpu`` manipulations.py:247), split
    0 if ``a`` is split. A split-0 operand flattens each shard where it is
    (a view where the shard is contiguous, as torch.flatten gives it in the
    Heat reference); any other split is first resplit to 0."""
    sanitize_in(a)
    if not a.is_distributed():
        split = None if a.split is None else 0
        return DNDarray(a.larray.reshape(-1), (a.size,), a.dtype, split, a.device, a.comm)
    b = a if a.split == 0 else a.resplit(0)
    rest = int(np.prod(a.gshape[1:], dtype=np.int64))
    return _dnd(b.larray.reshape(-1), (a.size,), a.dtype, 0, a, b.lshape_map[:, 0] * rest)


def ravel(a: DNDarray) -> DNDarray:
    """Flatten, a view where possible (``heat_tpu`` manipulations.py:350)."""
    return flatten(a)


# --------------------------------------------------------------------- #
# joins                                                                 #
# --------------------------------------------------------------------- #
def _promoted(arrays):
    out = arrays[0].dtype
    for a in arrays[1:]:
        out = types.promote_types(out, a.dtype)
    return out


def _concat(arrays: List[DNDarray], axis: int, split: Optional[int], dtype) -> DNDarray:
    """The operands (of one rank and one shape off ``axis``) joined along
    ``axis`` as an array of ``dtype`` split ``split``."""
    ref = arrays[0]
    comm = ref.comm
    tt = dtype.torch_type()
    gshape = list(ref.gshape)
    gshape[axis] = sum(a.gshape[axis] for a in arrays)
    if split is None or not comm.is_distributed():
        parts = [(a.resplit(None) if a.is_distributed() else a).larray.to(tt) for a in arrays]
        return DNDarray(torch.cat(parts, axis), tuple(gshape), dtype, split, ref.device, comm)
    arrays = [a.resplit(split) if a.is_distributed() and a.split != split else a for a in arrays]
    if axis != split:
        counts = next((a.lshape_map[:, split] for a in arrays if a.split == split),
                      comm.lshape_map(gshape, split)[:, split])
        local = torch.cat([_rows_of(a, split, counts).to(tt) for a in arrays], axis)
        return _dnd(local, gshape, dtype, split, ref, counts)
    # along the split axis: the result in the chunk geometry of its shape
    r = comm.rank
    pieces = [[] for _ in range(comm.size)]
    operands, off = [], 0
    for i, a in enumerate(arrays):
        if a.split == split:
            counts, local = a.lshape_map[:, split], a.larray
        else:  # whole on every rank: each rank sends its chunk of it
            counts = comm.lshape_map(a.gshape, split)[:, split]
            local = a.larray.narrow(split, int(_starts(counts)[r]), int(counts[r]))
        st = _starts(counts)
        for q in range(comm.size):
            if counts[q]:
                pieces[q].append((off + int(st[q]), i, 0, int(counts[q])))
        operands.append(local.to(tt))
        off += a.gshape[axis]
    local = _land(comm, operands, split, pieces, comm.lshape_map(gshape, split)[:, split])
    return _dnd(local, gshape, dtype, split, ref)


def _check_joinable(arrays, axis: int) -> None:
    """``jnp.concatenate``'s checks: one rank, equal extents off ``axis``."""
    ref = arrays[0]
    if ref.ndim == 0:
        raise ValueError("Zero-dimensional arrays cannot be concatenated.")
    if any(a.ndim != ref.ndim for a in arrays):
        raise TypeError(f"Cannot concatenate arrays with different numbers of dimensions: got "
                        f"{', '.join(str(a.shape) for a in arrays)}.")
    for a in arrays:
        if any(s != t for d, (s, t) in enumerate(zip(a.gshape, ref.gshape)) if d != axis):
            raise TypeError(f"Cannot concatenate arrays with shapes that differ in dimensions other than the one "
                            f"being concatenated: concatenating along dimension {axis} for shapes "
                            f"{', '.join(str(b.shape) for b in arrays)}.")


def concatenate(arrays: Sequence[DNDarray], axis: int = 0) -> DNDarray:
    """Join arrays along an existing axis (``heat_tpu`` manipulations.py:165;
    reference :390). The result type is promoted; the result is split like
    the first split operand, and the others are resplit (planner) to that
    split or, if whole, sliced to each rank's rows. Off the split axis each
    rank joins its rows locally (rows where the first split operand holds
    them; an operand of another map is moved there by ``redistribute_``).
    Along the split axis the result comes in the chunk geometry of its
    shape from one all-to-all with overlap counts."""
    arrays = sanitize_sequence(arrays)
    if len(arrays) < 1:
        raise ValueError("need at least one array to concatenate")
    for a in arrays:
        sanitize_in(a)
    axis = sanitize_axis(arrays[0].shape, axis)
    _check_joinable(arrays, axis)
    split = next((a.split for a in arrays if a.split is not None), None)
    return _concat(arrays, axis, split, _promoted(arrays))


def stack(arrays: Sequence[DNDarray], axis: int = 0, out: Optional[DNDarray] = None) -> DNDarray:
    """Join arrays of one shape along a new axis (``heat_tpu``
    manipulations.py:665): the first operand's split, moved past the new
    axis; each rank stacks its rows (the others aligned as in
    ``concatenate``). Where the first operand is whole, so is the result.
    ``out`` takes the result in its own split."""
    arrays = sanitize_sequence(arrays)
    if len(arrays) < 2:
        raise ValueError(f"stack expects at least 2 arrays, got {len(arrays)}")
    for a in arrays:
        sanitize_in(a)
    ref = arrays[0]
    for a in arrays[1:]:
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"all input arrays must have the same shape, got {a.shape} != {ref.shape}")
    axis = sanitize_axis(tuple(ref.shape) + (1,), axis)
    split = ref.split
    if split is not None and axis <= split:
        split += 1
    ret = _concat([expand_dims(a, axis) for a in arrays], axis, split, _promoted(arrays))
    if out is None:
        return ret
    target = out.split if out.split is not None and out.split < ret.ndim else None
    out.larray = (ret if ret.split == target else ret.resplit(target)).larray
    return out


def hstack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Join along axis 1, or 0 for 1-D arrays (``heat_tpu``
    manipulations.py:291)."""
    arrays = sanitize_sequence(arrays)
    return concatenate(arrays, axis=0 if arrays[0].ndim == 1 else 1)


def vstack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Join along axis 0, 1-D arrays as rows (``heat_tpu``
    manipulations.py:957)."""
    arrays = sanitize_sequence(arrays)
    arrays = [a if a.ndim > 1 else reshape(a, (1, a.shape[0]) if a.ndim == 1 else (1,)) for a in arrays]
    return concatenate(arrays, axis=0)


def row_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """``vstack`` (``heat_tpu`` manipulations.py:503)."""
    return vstack(arrays)


def _column(a: DNDarray) -> DNDarray:
    """A 0-d or 1-D array as one column, (n, 1): each shard where it is."""
    if a.ndim == 0:
        return DNDarray(a.larray.reshape(1, 1), (1, 1), a.dtype, None, a.device, a.comm)
    if a.split is None:
        return DNDarray(a.larray.reshape(-1, 1), (a.gshape[0], 1), a.dtype, None, a.device, a.comm)
    return _dnd(a.larray.reshape(-1, 1), (a.gshape[0], 1), a.dtype, 0, a, a.lshape_map[:, 0])


def column_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Stack 1-D arrays as columns beside 2-D ones (``heat_tpu``
    manipulations.py:136): split like the first array (0 for a split 1-D
    one), the others aligned as in ``concatenate``."""
    arrays = sanitize_sequence(arrays)
    for a in arrays:
        sanitize_in(a)
    ref = arrays[0]
    split = ref.split if ref.ndim >= 2 else (0 if ref.split is not None else None)
    cols = [a if a.ndim >= 2 else _column(a) for a in arrays]
    _check_joinable(cols, 1)
    return _concat(cols, 1, split, _promoted(arrays))


# --------------------------------------------------------------------- #
# splits                                                                #
# --------------------------------------------------------------------- #
def _slab(x: DNDarray, axis: int, lo: int, hi: int) -> DNDarray:
    """Rows [lo, hi) of ``x`` along ``axis``: a view of each shard; along
    the split axis each rank keeps its rows in the range."""
    gshape = list(x.gshape)
    gshape[axis] = hi - lo
    if x.split is None:
        return DNDarray(x.larray.narrow(axis, lo, hi - lo), tuple(gshape), x.dtype, None, x.device, x.comm)
    counts = x.lshape_map[:, x.split]
    if axis != x.split or not x.is_distributed():
        local = x.larray.narrow(axis, lo, hi - lo)
        return _dnd(local, gshape, x.dtype, x.split, x, counts if axis != x.split else None)
    st = _starts(counts)
    r = x.comm.rank
    a, b = (int(np.clip(v, st[r], st[r + 1])) for v in (lo, hi))
    inside = [int(np.clip(hi, st[q], st[q + 1]) - np.clip(lo, st[q], st[q + 1])) for q in range(x.comm.size)]
    return _dnd(x.larray.narrow(axis, a - int(st[r]), b - a), gshape, x.dtype, x.split, x, inside)


def split(x: DNDarray, indices_or_sections, axis: int = 0) -> List[DNDarray]:
    """Split into sub-arrays along ``axis`` (``heat_tpu``
    manipulations.py:621): an int gives equal sections (it must divide the
    extent), a sequence the indices between them (nondecreasing, within the
    extent, as ``jnp.split`` requires). Each piece is a view of the shards;
    along the split axis each piece keeps its rows where they fall, with no
    collective."""
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    n = x.gshape[axis]
    if isinstance(indices_or_sections, DNDarray):
        indices_or_sections = indices_or_sections.numpy()
    if isinstance(indices_or_sections, (list, tuple, np.ndarray)):
        bounds = [0] + [int(i) for i in np.asarray(indices_or_sections).ravel()] + [n]
        sizes = np.diff(bounds)
        if (sizes < 0).any():
            raise ValueError(f"Sizes passed to split must be nonnegative, got {sizes.tolist()}")
    else:
        k = int(indices_or_sections)
        if n % k != 0:
            raise ValueError("array split does not result in an equal division")
        bounds = [i * (n // k) for i in range(k + 1)]
    return [_slab(x, axis, lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]


def hsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """Split along axis 1, or 0 for 1-D arrays (``heat_tpu``
    manipulations.py:284)."""
    return split(x, indices_or_sections, axis=0 if x.ndim < 2 else 1)


def vsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """Split along axis 0 (``heat_tpu`` manipulations.py:952)."""
    return split(x, indices_or_sections, axis=0)


def dsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """Split along axis 2 (``heat_tpu`` manipulations.py:227)."""
    return split(x, indices_or_sections, axis=2)


# --------------------------------------------------------------------- #
# moves along the split axis                                            #
# --------------------------------------------------------------------- #
def _pad_widths(ndim: int, pad_width):
    """``heat_tpu``'s reading of ``pad_width`` (manipulations.py:327-345):
    one (before, after) pair an axis."""
    if isinstance(pad_width, int):
        widths = [(pad_width, pad_width)] * ndim
    else:
        pw = list(pad_width)
        if len(pw) and isinstance(pw[0], int):
            if len(pw) == 1:
                widths = [(pw[0], pw[0])] * ndim
            elif len(pw) == 2 and ndim == 1:
                widths = [tuple(pw)]
            else:
                raise ValueError(f"invalid pad_width {pad_width}")
        else:
            widths = [tuple(p) if not isinstance(p, int) else (p, p) for p in pw]
            if len(widths) == 1:
                widths = widths * ndim
            elif len(widths) < ndim:  # the trailing axes
                widths = [(0, 0)] * (ndim - len(widths)) + widths
    widths = [tuple(int(v) for v in w) for w in widths]
    if len(widths) != ndim or any(len(w) != 2 for w in widths):
        raise ValueError(f"pad_width {pad_width} does not give one (before, after) pair for each of {ndim} axes")
    if any(v < 0 for w in widths for v in w):
        raise ValueError("index can't contain negative values")
    return widths


def _value_pairs(values, ndim: int):
    """``constant_values`` as one (before, after) pair an axis, NumPy's
    ``_as_pairs``: a scalar, a pair, or a pair an axis."""
    arr = np.asarray(values, dtype=object)
    if arr.size == 1:
        v = arr.reshape(-1)[0]
        return [(v, v)] * ndim
    return [tuple(p) for p in np.broadcast_to(arr, (ndim, 2))]


def _scalar(value, dtype: torch.dtype) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``dtype``, cast as a NumPy array of
    that type casts it (2.7 into an integer type is 2)."""
    return torch.as_tensor(np.asarray(value)).to(dtype)


def pad(array: DNDarray, pad_width, mode: str = "constant", constant_values=0) -> DNDarray:
    """Pad with a constant (``heat_tpu`` manipulations.py:317; reference
    :1328; the only mode ``heat_tpu`` takes). ``pad_width`` reads as in
    ``heat_tpu``; ``constant_values`` as in ``np.pad``, a corner holding
    the later axis's value. Each rank writes its padded shard in one
    pass. Along the split axis the rows before the data go to the first
    rank that holds rows and the rows after it to the last such rank (rank
    0 where none does); no collective."""
    sanitize_in(array)
    if mode not in ("constant",):
        raise NotImplementedError(f"pad mode {mode!r} not supported (reference supports constant)")
    widths = _pad_widths(array.ndim, pad_width)
    values = _value_pairs(constant_values, array.ndim)
    t, split, r = array.larray, array.split, array.comm.rank
    counts = array.lshape_map[:, split].copy() if split is not None else None
    local = list(widths)
    if split is not None:  # at every world size, so the map holds the padded rows
        held = np.flatnonzero(counts)
        first, last = (int(held[0]), int(held[-1])) if held.size else (0, 0)
        before, after = widths[split]
        counts[first] += before
        counts[last] += after
        local[split] = (before if r == first else 0, after if r == last else 0)
    out = t.new_empty([s + b + a for s, (b, a) in zip(t.shape, local)])
    for ax, ((before, after), (v_before, v_after)) in enumerate(zip(local, values)):
        if before:  # over the whole extent of every other axis: a later axis overwrites the corners
            out.narrow(ax, 0, before).fill_(_scalar(v_before, t.dtype))
        if after:
            out.narrow(ax, out.shape[ax] - after, after).fill_(_scalar(v_after, t.dtype))
    out[tuple(slice(b, b + s) for (b, _), s in zip(local, t.shape))] = t
    gshape = tuple(s + b + a for s, (b, a) in zip(array.gshape, widths))
    return _dnd(out, gshape, array.dtype, split, array, counts)


def _roll_rows(x: DNDarray, t: torch.Tensor, shift: int) -> torch.Tensor:
    """This rank's rows after rolling ``t`` (``x``'s shard) by ``shift``
    along the split axis, in ``x``'s layout: one all-to-all."""
    n, split = x.gshape[x.split], x.split
    shift = shift % n if n else 0
    if shift == 0:
        return t
    counts = x.lshape_map[:, split]
    st = _starts(counts)
    pieces = []
    for q in range(x.comm.size):
        c, d = int(counts[q]), int((st[q] + shift) % n)
        head = min(c, n - d)
        pieces.append([(d, 0, 0, head)] + ([(0, 0, head, c - head)] if c > head else []) if c else [])
    return _land(x.comm, [t], split, pieces, counts)


def roll(x: DNDarray, shift, axis=None) -> DNDarray:
    """Roll elements along axes (``heat_tpu`` manipulations.py:472; reference
    :2156). Shifts and axes broadcast against each other and add up per
    axis, as in ``np.roll``. Off the split axis each shard rolls alone;
    along it the rows move in one all-to-all and the result keeps the
    input's layout. ``axis=None`` rolls the flattened array (a split-0
    operand flattens where it is; another split is resplit to 0 and back)."""
    sanitize_in(x)
    if axis is None:
        total = int(np.sum(np.asarray(shift)))
        if not x.is_distributed():
            return DNDarray(torch.roll(x.larray, total), x.gshape, x.dtype, x.split, x.device, x.comm)
        b = x if x.split == 0 else x.resplit(0)
        flat = flatten(b)
        local = _roll_rows(flat, _own(flat.larray), total).reshape(b.lshape)
        out = _dnd(local, b.gshape, x.dtype, 0, x, b.lshape_map[:, 0])
        return out if x.split == 0 else out.resplit(x.split)
    shifts = {}
    for sh, ax in np.broadcast(np.asarray(shift), np.asarray(axis)):
        ax = sanitize_axis(x.shape, int(ax))
        shifts[ax] = shifts.get(ax, 0) + int(sh)
    split = x.split if x.is_distributed() else None
    dims = [ax for ax in shifts if ax != split]
    t = torch.roll(x.larray, [shifts[ax] for ax in dims], dims) if dims else _own(x.larray)
    if split in shifts:
        t = _roll_rows(x, t, shifts[split])
    counts = x.lshape_map[:, x.split] if x.split is not None else None
    return _dnd(t, x.gshape, x.dtype, x.split, x, counts)


def _repeats_of(repeats, x: DNDarray, axis: int, along: bool):
    """``repeats`` for this rank's rows along ``axis`` (an int, or an int64
    tensor of one count a row) and, ``along`` the split axis, every rank's
    extent of the result along it (None where a collective must learn
    them)."""
    n = x.gshape[axis]
    counts = x.lshape_map[:, axis] if along else None
    if isinstance(repeats, DNDarray):
        if repeats.size == 1:
            repeats = repeats.item()
        elif along and repeats.is_distributed() and repeats.ndim == 1 and repeats.gshape[0] == n:
            return _rows_of(repeats, 0, counts).to(torch.int64), None  # the counts aligned to the rows
        else:
            repeats = repeats.resplit(None).larray if repeats.is_distributed() else repeats.larray
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.cpu().numpy()
    reps = np.asarray(repeats)
    if reps.size == 1:
        k = int(reps.reshape(-1)[0])
        if k < 0:
            raise TypeError(f"repeat counts must be nonnegative, got {k}")
        return k, None if counts is None else counts * k
    if reps.ndim != 1 or reps.shape[0] != n:
        raise ValueError(f"operands could not be broadcast together: repeats {reps.shape} against ({n},)")
    reps = reps.astype(np.int64)
    if (reps < 0).any():
        raise TypeError("repeat counts must be nonnegative")
    if not along:
        return torch.as_tensor(reps, device=x.larray.device), None
    st = _starts(counts)
    r = x.comm.rank
    totals = np.array([reps[st[q]: st[q + 1]].sum() for q in range(x.comm.size)], dtype=np.int64)
    return torch.as_tensor(reps[st[r]: st[r + 1]], device=x.larray.device), totals


def repeat(a, repeats, axis: Optional[int] = None) -> DNDarray:
    """Repeat elements along ``axis`` (``heat_tpu`` manipulations.py:365):
    ``repeats`` an int or one count an element. Each rank repeats its own
    rows, so along the split axis the rows stay where they fall (no
    collective, but one all-gather of the shard shapes where a split
    ``repeats`` is aligned to the rows). ``axis=None`` flattens first
    (split 0 if ``a`` is split)."""
    from . import factories
    from .factories import _from_shards

    if not isinstance(a, DNDarray):
        a = factories.array(a)
    if axis is None:
        x, axis = flatten(a), 0
    else:
        x, axis = a, sanitize_axis(a.shape, axis)
    along = x.is_distributed() and axis == x.split
    reps, totals = _repeats_of(repeats, x, axis, along)
    local = torch.repeat_interleave(x.larray, reps, dim=axis)
    if along and totals is None:
        return _from_shards(local, x.dtype, x.split, x.device, x.comm)
    gshape = list(x.gshape)
    if along:
        gshape[axis] = int(totals.sum())
    else:
        gshape[axis] = gshape[axis] * reps if isinstance(reps, int) else int(reps.sum())
    if not x.is_distributed():
        return DNDarray(local, tuple(gshape), x.dtype, x.split, x.device, x.comm)
    return _dnd(local, gshape, x.dtype, x.split, x, totals if along else x.lshape_map[:, x.split])


def tile(x: DNDarray, reps) -> DNDarray:
    """Repeat the whole array ``reps`` times along each axis (``heat_tpu``
    manipulations.py:712), ``reps`` padded with leading ones or ``x`` with
    leading axes, as ``np.tile`` does; the split shifts by the new axes.
    Off the split axis each shard tiles alone; along it the copies land in
    the chunk geometry of the result by one all-to-all."""
    sanitize_in(x)
    if isinstance(reps, DNDarray):
        reps = reps.numpy().tolist()
    reps = [int(r) for r in (reps if isinstance(reps, (list, tuple, np.ndarray)) else [reps])]
    if any(r < 0 for r in reps):
        raise ValueError(f"negative dimensions are not allowed, got reps {reps}")
    ndim = max(x.ndim, len(reps))
    reps = [1] * (ndim - len(reps)) + reps
    y = x
    while y.ndim < ndim:
        y = expand_dims(y, 0)
    along = y.split if y.is_distributed() else None
    t = y.larray.repeat([1 if d == along else k for d, k in enumerate(reps)]) if ndim else _own(y.larray)
    gshape = [s * k for s, k in zip(y.gshape, reps)]
    if along is None or reps[along] == 1:
        counts = y.lshape_map[:, y.split] if along is not None else None
        return _dnd(t, gshape, x.dtype, y.split, x, counts)
    counts, n = y.lshape_map[:, along], y.gshape[along]
    st = _starts(counts)
    pieces = [[(j * n + int(st[q]), 0, 0, int(counts[q])) for j in range(reps[along]) if counts[q]]
              for q in range(x.comm.size)]
    local = _land(x.comm, [t], along, pieces, x.comm.lshape_map(gshape, along)[:, along])
    return _dnd(local, gshape, x.dtype, along, x)


def fliplr(a: DNDarray) -> DNDarray:
    """Flip along axis 1 (``heat_tpu`` manipulations.py:272)."""
    if a.ndim < 2:
        raise IndexError("expected at least 2-dimensional input")
    return flip(a, 1)


def flipud(a: DNDarray) -> DNDarray:
    """Flip along axis 0 (``heat_tpu`` manipulations.py:279)."""
    return flip(a, 0)


def rot90(m: DNDarray, k: int = 1, axes: Sequence[int] = (0, 1)) -> DNDarray:
    """Rotate by 90° k times in the plane of ``axes`` (``heat_tpu``
    manipulations.py:484), composed as ``np.rot90`` composes it from
    ``flip`` (one all-to-all where it flips the split axis) and
    ``swapaxes`` (none)."""
    sanitize_in(m)
    axes = tuple(axes)
    if len(axes) != 2 or axes[0] == axes[1]:
        raise ValueError("len(axes) must be 2 with distinct elements")
    a0, a1 = sanitize_axis(m.shape, axes)
    k %= 4
    if k == 0:
        return m.copy()
    if k == 2:
        return flip(m, (a0, a1))
    if k == 1:
        return swapaxes(flip(m, a1), a0, a1)
    return flip(swapaxes(m, a0, a1), a1)


def _diagonal_length(rows: int, cols: int, offset: int) -> int:
    """Entries on the ``offset`` diagonal of a rows x cols plane."""
    return max(0, min(rows, cols - offset) if offset >= 0 else min(rows + offset, cols))


def diagonal(a: DNDarray, offset: int = 0, dim1: int = 0, dim2: int = 1) -> DNDarray:
    """The diagonal in the plane (dim1, dim2), as the last axis (``heat_tpu``
    manipulations.py:210). Each rank takes the diagonal entries in its own
    rows (or columns): a split along the plane becomes the last axis, with
    the entries where they fall; no collective."""
    sanitize_in(a)
    if a.ndim < 2:
        raise ValueError("diagonal requires at least 2 dimensions")
    d1, d2 = sanitize_axis(a.shape, dim1), sanitize_axis(a.shape, dim2)
    if d1 == d2:
        raise TypeError(f"diagonal: dim1 and dim2 are both axis {d1}")
    rest = [i for i in range(a.ndim) if i not in (d1, d2)]
    n = _diagonal_length(a.gshape[d1], a.gshape[d2], offset)
    gshape = tuple(a.gshape[i] for i in rest) + (n,)
    split = a.split
    if split is None:
        return DNDarray(_own(torch.diagonal(a.larray, offset, d1, d2)), gshape, a.dtype, None, a.device, a.comm)
    if split not in (d1, d2):
        local = _own(torch.diagonal(a.larray, offset, d1, d2))
        return _dnd(local, gshape, a.dtype, rest.index(split), a, a.lshape_map[:, split])
    counts = a.lshape_map[:, split]
    # rank q's block starts at row (or column) st[q]: its entries lie on
    # its own diagonal offset + st[q] (or offset − st[q])
    sign = 1 if split == d1 else -1
    st = _starts(counts)
    lengths = []
    for q in range(a.comm.size):
        rows, cols = (int(counts[q]), a.gshape[d2]) if split == d1 else (a.gshape[d1], int(counts[q]))
        lengths.append(_diagonal_length(rows, cols, offset + sign * int(st[q])))
    local = _own(torch.diagonal(a.larray, offset + sign * int(st[a.comm.rank]), d1, d2))
    return _dnd(local, gshape, a.dtype, len(gshape) - 1, a, lengths)


def diag(a: DNDarray, offset: int = 0) -> DNDarray:
    """The diagonal of a 2-D array, or a 2-D array with the 1-D ``a`` on its
    ``offset`` diagonal (``heat_tpu`` manipulations.py:200). Built from a
    split 1-D array, each rank writes the rows of its entries, with the
    |offset| rows of zeros beside them on the first (offset < 0) or last
    rank that holds entries; no collective."""
    sanitize_in(a)
    if a.ndim != 1:
        return diagonal(a, offset=offset)
    n = a.gshape[0]
    N = n + abs(offset)
    if not a.is_distributed():
        return DNDarray(torch.diag(a.larray, offset), (N, N), a.dtype, a.split, a.device, a.comm)
    counts = a.lshape_map[:, 0].copy()
    st = _starts(counts)
    held = np.flatnonzero(counts)
    r = a.comm.rank
    edge = (int(held[0]) if offset < 0 else int(held[-1])) if held.size else 0
    v = a.larray
    rows = torch.zeros((v.shape[0], N), dtype=v.dtype, device=v.device)
    j = torch.arange(v.shape[0], device=v.device)
    rows[j, j + int(st[r]) + max(offset, 0)] = v
    extra = torch.zeros((abs(offset) if r == edge else 0, N), dtype=v.dtype, device=v.device)
    rows = torch.cat([extra, rows] if offset < 0 else [rows, extra])
    counts[edge] += abs(offset)
    return _dnd(rows, (N, N), a.dtype, 0, a, counts)


# --------------------------------------------------------------------- #
# layout                                                                #
# --------------------------------------------------------------------- #
def balance(array: DNDarray, copy: bool = False) -> DNDarray:
    """Move the shards to the chunk geometry (``heat_tpu``
    manipulations.py:94; reference ``balance``): ``array`` itself, balanced
    in place, or (``copy``) a balanced copy."""
    sanitize_in(array)
    out = array.copy() if copy else array
    out.balance_()
    return out


def redistribute(arr: DNDarray, lshape_map=None, target_map=None) -> DNDarray:
    """A copy of ``arr`` with its shards moved to ``target_map``
    (``heat_tpu`` manipulations.py:356; ``DNDarray.redistribute_``)."""
    sanitize_in(arr)
    out = arr.copy()
    out.redistribute_(lshape_map=lshape_map, target_map=target_map)
    return out


def collect(arr: DNDarray, target_rank: int = 0) -> DNDarray:
    """A copy of ``arr`` with every row on ``target_rank`` (``heat_tpu``
    manipulations.py:127; ``DNDarray.collect_``)."""
    sanitize_in(arr)
    out = arr.copy()
    out.collect_(target_rank)
    return out


# method attachment (reference attaches these on DNDarray)
DNDarray.reshape = lambda self, *shape, **kwargs: reshape(self, *shape, **kwargs)
DNDarray.flip = flip
DNDarray.moveaxis = moveaxis
DNDarray.sort = sort
DNDarray.topk = topk
DNDarray.unique = unique
DNDarray.concatenate = lambda self, others, axis=0: concatenate([self] + list(others), axis)
DNDarray.tile = tile
DNDarray.repeat = repeat
DNDarray.swapaxes = swapaxes
DNDarray.broadcast_to = broadcast_to
DNDarray.flatten = flatten
DNDarray.ravel = ravel
DNDarray.squeeze = lambda self, axis=None: squeeze(self, axis)
DNDarray.expand_dims = expand_dims
