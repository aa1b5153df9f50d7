"""Indexing keys of the DNDarray, and its item get and set across ranks.

Port of the key handling of ``heat_tpu.core.dndarray`` (``__process_key``
:743-807, ``__getitem__`` :809-892, ``__normalize_basic_key`` :894-948,
whose edge cases :func:`parse` keeps, ``__setitem__`` :950-1046) and of the mask compaction of
``heat_tpu.core.parallel`` (``compact_select`` :710, ``distributed_nonzero``
:767). ``heat_tpu`` indexes its one global array with ``jnp`` and re-shards
the result; here every rank works on its own shard:

- a key is parsed once, under NumPy's rules, into one :class:`_Entry` an
  axis (ints, slices with any step, ``None``, ``Ellipsis``, integer and
  boolean arrays, lists and DNDarrays, a bool scalar), and the output
  split follows ``heat_tpu``'s walk over the key (:func:`output_split`);
- a slice of the split axis is sliced by each rank from its own rows, no
  bytes move, and the rows stay where they fall (a negative step sends
  each rank's rows to its mirror rank in one all-to-all);
- an integer of the split axis is taken by its owner, which broadcasts
  the selected sub-array;
- integer arrays on the split axis: each rank selects the rows of the
  keys it owns, the rows travel in one all-gather (every rank knows the
  counts from the key), and each rank puts them into key order;
- a boolean mask over leading axes selects on each rank's rows, the
  counts travel in one small all-gather and the result goes to even
  split-0 chunks in one all-to-all (``redistribute_``).

Results never share memory with the operand. Assignments write each
rank's part of the key into its own shard, in place, as the Heat
reference does. Out-of-range advanced keys raise ``IndexError``, as NumPy
does; ``heat_tpu`` clamps them in a read and drops them in a write
(``jnp``'s modes).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import types
from ._operations import _rows, _whole

__all__ = []


class _Entry:
    """One item of a parsed key. ``kind`` is ``"int"`` (``value``),
    ``"slice"`` (``start``, ``step``, ``count``: the positions ``start +
    j·step``, j < count), ``"none"`` (a new axis) or ``"adv"`` (``index``:
    an int64 tensor of positions, or, with ``value`` "scalar", a bool
    scalar's index into the new axis it makes). ``dim`` is the input axis
    it consumes."""

    __slots__ = ("kind", "dim", "value", "start", "step", "count", "index")

    def __init__(self, kind, dim=None, value=0, start=0, step=1, count=0, index=None):
        self.kind, self.dim, self.value = kind, dim, value
        self.start, self.step, self.count, self.index = start, step, count, index

    def replace(self, **kw) -> "_Entry":
        new = _Entry(self.kind, self.dim, self.value, self.start, self.step, self.count, self.index)
        for k, v in kw.items():
            setattr(new, k, v)
        return new


# --------------------------------------------------------------------- #
# heat_tpu's rules                                                      #
# --------------------------------------------------------------------- #
class _Advanced:
    """What ``heat_tpu``'s walk sees of an array key: its ndim and whether
    it is boolean."""

    def __init__(self, ndim: int, is_bool: bool):
        self.ndim, self.is_bool = ndim, is_bool


def _walk_item(k):
    from .dndarray import DNDarray

    if isinstance(k, DNDarray):
        return _Advanced(k.ndim, k.dtype is types.bool)
    if isinstance(k, torch.Tensor):
        return _Advanced(k.ndim, k.dtype == torch.bool)
    if isinstance(k, (list, np.ndarray)):
        a = np.asarray(k)
        return _Advanced(a.ndim, a.dtype == np.bool_)
    return k


def output_split(key, ndim: int, split: Optional[int]) -> Optional[int]:
    """The output split of ``x[key]`` by ``heat_tpu``'s walk
    (``__process_key``, dndarray.py:743-807): a slice of the split axis
    keeps it (renumbered), an integer or array on it drops it. The caller
    then drops a split past the result's axes or of extent 0 (:885-889)."""
    keys = key if isinstance(key, tuple) else (key,)
    keys = tuple(_walk_item(k) for k in keys)
    if split is None:
        return None
    n_explicit = sum(1 for k in keys if k is not None and k is not Ellipsis)
    expanded = []
    for k in keys:
        if k is Ellipsis:
            expanded.extend([slice(None)] * (ndim - n_explicit))
        else:
            expanded.append(k)
    while len([k for k in expanded if k is not None]) < ndim:
        expanded.append(slice(None))
    out_split, in_dim, out_dim = None, 0, 0
    for k in expanded:
        if k is None:
            out_dim += 1
            continue
        if isinstance(k, (int, np.integer)) or (getattr(k, "ndim", 1) == 0 and not isinstance(k, slice)):
            if in_dim == split:
                out_split = None
            in_dim += 1
            continue
        if isinstance(k, slice):
            if in_dim == split:
                out_split = out_dim
            in_dim += 1
            out_dim += 1
            continue
        if in_dim == split:
            out_split = None
        in_dim += getattr(k, "ndim", 1) if getattr(k, "is_bool", False) else 1
        out_dim += 1
    return out_split


def _kept_split(split: Optional[int], shape) -> Optional[int]:
    """``heat_tpu``'s last check (dndarray.py:885-889): a split past the
    result's axes, or of extent 0, is dropped."""
    if split is not None and split < len(shape) and shape[split] >= 1:
        return split
    return None


def _checked_int(k: int, dim: int, n: int) -> int:
    if k < 0:
        k += n
    if not 0 <= k < n:
        raise IndexError(f"index {k if k >= 0 else k - n} is out of bounds for axis {dim} with size {n}")
    return k


# --------------------------------------------------------------------- #
# parsing under NumPy's rules                                           #
# --------------------------------------------------------------------- #
def _as_index(k, device, whole) -> torch.Tensor:
    """An array-like key as a tensor on ``device``: a DNDarray through
    ``whole``, lists and numpy arrays as they are (an empty list as
    int64)."""
    from .dndarray import DNDarray

    if isinstance(k, DNDarray):
        t = whole(k)
    elif isinstance(k, torch.Tensor):
        t = k
    else:
        a = np.asarray(k)
        if a.size == 0 and a.dtype.kind not in "biu":
            a = a.astype(np.int64)
        if a.dtype.kind not in "biu":
            raise IndexError("arrays used as indices must be of integer (or boolean) type")
        t = torch.from_numpy(np.array(a, order="C"))
    if t.dtype != torch.bool and (t.dtype.is_floating_point or t.dtype.is_complex):
        raise IndexError("arrays used as indices must be of integer (or boolean) type")
    return t.to(device)


def parse(key, shape, device, whole) -> Tuple[List[_Entry], Tuple[int, ...]]:
    """``key`` against an array of ``shape`` as one entry an item (boolean
    arrays become one integer array an axis, ints become integer arrays
    where any array is present), and the broadcast shape of the advanced
    block (() without arrays). DNDarray keys are read through
    ``whole``."""
    from .dndarray import DNDarray

    items = key if isinstance(key, tuple) else (key,)
    entries: List = []
    for k in items:
        if k is None:
            entries.append(_Entry("none"))
        elif k is Ellipsis:
            if any(e is Ellipsis for e in entries):
                raise IndexError("an index can only have a single ellipsis ('...')")
            entries.append(Ellipsis)
        elif isinstance(k, (bool, np.bool_)):
            entries.append(_bool_scalar(bool(k), device))
        elif isinstance(k, (int, np.integer)):
            entries.append(_Entry("int", value=int(k)))
        elif isinstance(k, slice):
            entries.append(_Entry("slice", value=k))
        elif isinstance(k, (DNDarray, torch.Tensor, np.ndarray, list, tuple)):
            t = _as_index(k, device, whole)
            if t.dtype == torch.bool and t.ndim == 0:
                entries.append(_bool_scalar(bool(t.item()), device))
            elif t.dtype == torch.bool:
                nz = torch.nonzero(t)
                entries.extend(_Entry("adv", index=nz[:, j], value=("bool", t.shape, j)) for j in range(t.ndim))
            else:
                entries.append(_Entry("adv", index=t.to(torch.int64)))
        else:
            raise IndexError(
                "only integers, slices (`:`), ellipsis (`...`), numpy.newaxis (`None`) and integer or boolean "
                f"arrays are valid indices, got {type(k).__name__}"
            )
    ndim = len(shape)
    consumed = sum(1 for e in entries if e is not Ellipsis and e.kind != "none" and not _is_bool_scalar(e))
    if consumed > ndim:
        raise IndexError(f"too many indices for array: array is {ndim}-dimensional, but {consumed} were indexed")
    fill = [_Entry("slice", value=slice(None)) for _ in range(ndim - consumed)]
    at = next((i for i, e in enumerate(entries) if e is Ellipsis), len(entries))
    entries = entries + fill if at == len(entries) else entries[:at] + fill + entries[at + 1:]
    dim = 0
    for e in entries:
        if e.kind == "none" or _is_bool_scalar(e):
            continue
        n = shape[dim]
        e.dim = dim
        if e.kind == "int":
            e.value = _checked_int(e.value, dim, n)
        elif e.kind == "slice":
            start, stop, step = e.value.indices(n)
            e.start, e.step, e.count = start, step, len(range(start, stop, step))
        elif isinstance(e.value, tuple):  # one axis of a boolean array
            _, mshape, j = e.value
            if mshape[j] != n:
                raise IndexError(f"boolean index did not match indexed array along axis {dim}; size of axis is "
                                 f"{n} but size of corresponding boolean axis is {mshape[j]}")
        else:
            bad = (e.index < -n) | (e.index >= n)
            if e.index.numel() and bool(bad.any()):
                first = int(e.index[bad].reshape(-1)[0])
                raise IndexError(f"index {first} is out of bounds for axis {dim} with size {n}")
            e.index = torch.where(e.index < 0, e.index + n, e.index)
        dim += 1
    if not any(e.kind == "adv" for e in entries):
        return entries, ()
    for i, e in enumerate(entries):
        if e.kind == "int":
            entries[i] = _Entry("adv", dim=e.dim, index=torch.tensor(e.value, dtype=torch.int64, device=device))
    try:
        block = tuple(torch.broadcast_shapes(*(e.index.shape for e in entries if e.kind == "adv")))
    except RuntimeError:
        shapes = " ".join(str(tuple(e.index.shape)) for e in entries if e.kind == "adv")
        raise IndexError(f"shape mismatch: indexing arrays could not be broadcast together with shapes {shapes}")
    return entries, block


def _bool_scalar(value: bool, device) -> _Entry:
    """A bool scalar: a new axis of extent 1, indexed by [0] (True) or by
    nothing (False)."""
    return _Entry("adv", value="scalar", index=torch.zeros(int(value), dtype=torch.int64, device=device))


def _is_bool_scalar(e) -> bool:
    return e is not Ellipsis and e.kind == "adv" and e.value == "scalar"


# --------------------------------------------------------------------- #
# the result's axes                                                     #
# --------------------------------------------------------------------- #
def _layout(entries, block) -> Tuple[List[tuple], int]:
    """The result's axes in order, ``("none", i)``, ``("slice", i)`` or
    ``("block", j)``, and the position of the advanced block: where the
    first array stands if the arrays (ints among them) are adjacent, else
    in front (NumPy's rule)."""
    adv = [i for i, e in enumerate(entries) if e.kind == "adv"]
    adjacent = bool(adv) and adv == list(range(adv[0], adv[-1] + 1))
    out: List[tuple] = []
    bpos = 0
    if adv and not adjacent:
        out += [("block", j) for j in range(len(block))]
    for i, e in enumerate(entries):
        if e.kind in ("none", "slice"):
            out.append((e.kind, i))
        elif e.kind == "adv" and adjacent and i == adv[0]:
            bpos = len(out)
            out += [("block", j) for j in range(len(block))]
    return out, bpos


def _shape(entries, block, out) -> Tuple[int, ...]:
    return tuple(1 if kind == "none" else entries[i].count if kind == "slice" else block[i] for kind, i in out)


def _flips(entries, out) -> List[int]:
    return [p for p, (kind, i) in enumerate(out) if kind == "slice" and entries[i].step < 0 and entries[i].count > 1]


def _positive(e: _Entry) -> slice:
    """The positions of a slice entry as a slice of positive step (the
    reversal of a negative step is the caller's)."""
    if e.count == 0:
        return slice(0, 0)
    if e.step > 0:
        return slice(e.start, e.start + (e.count - 1) * e.step + 1, e.step)
    first = e.start + (e.count - 1) * e.step
    return slice(first, e.start + 1, -e.step)


def _basic_view(t: torch.Tensor, entries) -> torch.Tensor:
    """A view of ``t`` under the key's slices (positive steps), ints and
    new axes; the axes of arrays stay whole."""
    key = []
    for e in entries:
        if e.kind == "slice":
            key.append(_positive(e))
        elif e.kind == "int":
            key.append(e.value)
        elif e.kind == "none" or _is_bool_scalar(e):
            key.append(None)
        else:
            key.append(slice(None))
    return t[tuple(key)]


def _flat_key(entries, block) -> tuple:
    """The key of the arrays on :func:`_basic_view`'s result: each array
    broadcast to the block and flattened, other axes whole."""
    return tuple(e.index.broadcast_to(block).reshape(-1) if e.kind == "adv" else slice(None) for e in entries)


def local_get(t: torch.Tensor, entries, block) -> torch.Tensor:
    """``t[key]`` under NumPy's rules, as a new tensor."""
    adv = any(e.kind == "adv" for e in entries)
    out, bpos = _layout(entries, block)
    y = _basic_view(t, entries)
    flips = _flips(entries, out)
    if adv:
        y = y[_flat_key(entries, block)]
        y = y.reshape(tuple(y.shape[:bpos]) + tuple(block) + tuple(y.shape[bpos + 1:]))
    elif not flips:
        y = y.clone(memory_format=torch.contiguous_format)
    return torch.flip(y, flips) if flips else y


def _fit(value: torch.Tensor, shape) -> torch.Tensor:
    """``value`` broadcast to ``shape`` as NumPy assigns it (leading axes
    of extent 1 dropped)."""
    while value.ndim > len(shape) and value.shape[0] == 1:
        value = value[0]
    try:
        return value.broadcast_to(tuple(shape))
    except RuntimeError:
        raise ValueError(f"could not broadcast input array from shape {tuple(value.shape)} into shape {tuple(shape)}")


def local_set(t: torch.Tensor, entries, block, value: torch.Tensor) -> None:
    """``t[key] = value`` under NumPy's rules, in place."""
    adv = any(e.kind == "adv" for e in entries)
    out, bpos = _layout(entries, block)
    view = _basic_view(t, entries)
    shape = _shape(entries, block, out)
    v = _fit(value, shape)
    flips = _flips(entries, out)
    if flips:
        v = torch.flip(v, flips)
    if adv:
        m = int(np.prod(block, dtype=np.int64))
        v = v.reshape(tuple(shape[:bpos]) + (m,) + tuple(shape[bpos + len(block):]))
        view[_flat_key(entries, block)] = v
    else:
        view.copy_(v)


# --------------------------------------------------------------------- #
# helpers across ranks                                                  #
# --------------------------------------------------------------------- #
def _offsets(counts) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _slice_part(e: _Entry, lo: int, hi: int) -> Tuple[int, int]:
    """The range [j0, j1) of a slice entry's positions that fall in the
    rows [lo, hi)."""
    if e.count == 0 or hi <= lo:
        return 0, 0
    s = e.step
    if s > 0:
        j0 = -(-(lo - e.start) // s)
        j1 = -(-(hi - e.start) // s)
    else:
        j0 = -(-(e.start - (hi - 1)) // -s)
        j1 = (e.start - lo) // -s + 1
    j0, j1 = min(max(j0, 0), e.count), min(max(j1, 0), e.count)
    return j0, max(j0, j1)


def _local_slice(e: _Entry, j0: int, j1: int, lo: int) -> _Entry:
    return e.replace(start=e.start + j0 * e.step - lo if j1 > j0 else 0, count=j1 - j0)


def _owners(index: torch.Tensor, counts) -> torch.Tensor:
    """The rank that owns each (normalized) position along the split axis."""
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int64, device=index.device)
    return torch.searchsorted(ends, index, right=True)


def _split_entry(entries, split: int) -> int:
    return next(i for i, e in enumerate(entries) if e.kind != "none" and e.dim == split)


def _mask_part(mask, s: int, counts, comm) -> torch.Tensor:
    """This rank's part of ``mask`` (a DNDarray, or a tensor whole on every
    rank) along axis ``s``, in the map ``counts`` of the indexed array."""
    from .dndarray import DNDarray

    if isinstance(mask, DNDarray) and mask.is_distributed():
        return _rows(mask if mask.split == s else mask.resplit(s), s, counts)
    whole = _whole(mask) if isinstance(mask, DNDarray) else mask
    off = _offsets(counts)
    return whole.narrow(s, int(off[comm.rank]), int(counts[comm.rank]))


def compact(x, local: torch.Tensor, trailing) -> "DNDarray":
    """A split-0 DNDarray of each rank's selected rows ``local`` in rank
    order, moved to even chunks: one all-gather of the counts and one
    all-to-all (``parallel.compact_select``'s schedule)."""
    from .dndarray import DNDarray

    comm = x.comm
    counts = comm.allgather(torch.tensor([local.shape[0]], dtype=torch.int64, device=local.device)).cpu().numpy()
    gshape = (int(counts.sum()),) + tuple(trailing)
    lmap = np.tile(np.array(gshape, dtype=np.int64), (comm.size, 1))
    lmap[:, 0] = counts
    out = DNDarray(local, gshape, types.canonical_heat_type(local.dtype), 0, x.device, comm, lmap)
    out.balance_()
    return out


# --------------------------------------------------------------------- #
# get                                                                   #
# --------------------------------------------------------------------- #
def getitem(x, key):
    """``x[key]`` (``heat_tpu`` dndarray.py:809-892)."""
    from .dndarray import DNDarray

    if isinstance(key, DNDarray) and key.dtype is types.bool:
        if key.ndim == 0:
            res = getitem(x, bool(key.item()))
            return res if x.split is None or res.ndim == 0 else res.resplit(0)
        return _mask_get(x, key)
    out_split = output_split(key, x.ndim, x.split)
    entries, block = parse(key, x.gshape, x.larray.device, _whole)
    out, bpos = _layout(entries, block)
    shape = _shape(entries, block, out)
    if not x.is_distributed():
        res = local_get(x.larray, entries, block)
        return DNDarray(res, shape, x.dtype, _kept_split(out_split, shape), x.device, x.comm)
    es = _split_entry(entries, x.split)
    kind = entries[es].kind
    if kind == "slice":
        res = _get_split_slice(x, entries, block, es, out, shape)
    elif kind == "int":
        res = _get_split_int(x, entries, block, es, shape)
    else:
        res = _get_split_adv(x, entries, block, es, bpos, shape)
    final = _kept_split(out_split, shape)
    return res if res.split == final else res.resplit(final)


def _get_split_slice(x, entries, block, es, out, shape):
    """A slice of the split axis: each rank slices its own rows."""
    from .dndarray import DNDarray

    comm, e = x.comm, entries[es]
    counts = x.lshape_map[:, x.split]
    off = _offsets(counts)
    parts = [_slice_part(e, int(off[q]), int(off[q + 1])) for q in range(comm.size)]
    r = comm.rank
    local = list(entries)
    local[es] = _local_slice(e, *parts[r], int(off[r]))
    res = local_get(x.larray, local, block)
    p = out.index(("slice", es))
    got = [j1 - j0 for j0, j1 in parts]
    if e.step < 0 and e.count > 1:
        # the highest rows come first: rank q's block goes to rank p - 1 - q
        mirror = comm.size - 1 - r
        send = [got[r] if q == mirror else 0 for q in range(comm.size)]
        recv = [got[mirror] if q == mirror else 0 for q in range(comm.size)]
        res = comm.alltoall(res.movedim(p, 0).contiguous(), send, recv).movedim(0, p).contiguous()
        got = got[::-1]
    lmap = np.tile(np.array(shape, dtype=np.int64), (comm.size, 1))
    lmap[:, p] = got
    return DNDarray(res, shape, x.dtype, p, x.device, comm, lmap)


def _get_split_int(x, entries, block, es, shape):
    """An integer on the split axis: its owner broadcasts the selection."""
    from .dndarray import DNDarray

    comm, e = x.comm, entries[es]
    off = _offsets(x.lshape_map[:, x.split])
    owner = int(np.searchsorted(off[1:], e.value, side="right"))
    if comm.rank == owner:
        local = list(entries)
        local[es] = e.replace(value=e.value - int(off[owner]))
        res = local_get(x.larray, local, block).contiguous()
    else:
        res = torch.empty(shape, dtype=x.larray.dtype, device=x.larray.device)
    return DNDarray(comm.bcast(res, root=owner), shape, x.dtype, None, x.device, comm)


def _split_adv_parts(x, entries, block, es):
    """Each rank's share of an array key on the split axis: the owner of
    every flattened key, this rank's positions among them and its local
    entries."""
    comm = x.comm
    counts = x.lshape_map[:, x.split]
    off = _offsets(counts)
    flat = entries[es].index.broadcast_to(block).reshape(-1)
    owner = _owners(flat, counts)
    m_q = torch.bincount(owner, minlength=comm.size).cpu().numpy()
    mine = torch.nonzero(owner == comm.rank).reshape(-1)
    local = []
    for i, e in enumerate(entries):
        if e.kind == "adv":
            idx = e.index.broadcast_to(block).reshape(-1)[mine]
            local.append(e.replace(index=idx - int(off[comm.rank]) if i == es else idx))
        else:
            local.append(e)
    return owner, m_q, local


def _get_split_adv(x, entries, block, es, bpos, shape):
    """Integer arrays on the split axis: each rank selects the rows it
    owns; one all-gather; every rank puts them into key order."""
    from .dndarray import DNDarray

    comm = x.comm
    owner, m_q, local = _split_adv_parts(x, entries, block, es)
    mine = local_get(x.larray, local, (int(m_q[comm.rank]),))
    gathered = comm.allgather(mine.movedim(bpos, 0).contiguous(), 0, m_q)
    order = torch.argsort(owner, stable=True)
    whole = torch.empty_like(gathered)
    whole[order] = gathered
    whole = whole.reshape(tuple(block) + tuple(whole.shape[1:]))
    whole = whole.movedim(tuple(range(len(block))), tuple(range(bpos, bpos + len(block))))
    return DNDarray(whole.contiguous(), shape, x.dtype, None, x.device, comm)


def _mask_get(x, mask):
    """A boolean DNDarray over ``x``'s leading axes (``heat_tpu``
    :822-863): split 0 across ranks, by ``compact``."""
    from .dndarray import DNDarray

    k = mask.ndim
    if tuple(mask.gshape) != tuple(x.gshape[:k]):
        raise IndexError(f"boolean index of shape {mask.gshape} does not match the indexed array's {x.gshape}")
    if not x.is_distributed():
        res = x.larray[_whole(mask)]
        split = 0 if x.split is not None and res.ndim > 0 else None
        return DNDarray(res, tuple(res.shape), x.dtype, split, x.device, x.comm)
    a = x if x.split == 0 else x.resplit(0)
    sel = a.larray[_mask_part(mask, 0, a.lshape_map[:, 0], a.comm)]
    return compact(a, sel, x.gshape[k:])


# --------------------------------------------------------------------- #
# set                                                                   #
# --------------------------------------------------------------------- #
def _value_of(value, x):
    """A non-DNDarray value as a tensor of ``x``'s type on its device."""
    if not isinstance(value, torch.Tensor):
        from .factories import _tensor_of

        a = np.asarray(value)
        if a.dtype == object:
            raise TypeError(f"cannot assign {type(value).__name__} to a DNDarray")
        value = _tensor_of(np.array(a, order="C"))
    return value.to(device=x.larray.device, dtype=x.larray.dtype)


def _whole_value(value, x) -> torch.Tensor:
    from .dndarray import DNDarray

    if isinstance(value, DNDarray):
        return _whole(value).to(dtype=x.larray.dtype)
    return _value_of(value, x)


def _value_part(value, x, shape, p: int, j0: int, c: int, counts=None) -> torch.Tensor:
    """This rank's part [j0, j0 + c) along result axis ``p`` of ``value``
    broadcast to ``shape``. A DNDarray value split along that axis at its
    full extent is moved to the map ``counts`` (when given) instead of
    gathered."""
    from .dndarray import DNDarray

    if isinstance(value, DNDarray) and counts is not None and value.is_distributed():
        dim = value.split
        if dim + len(shape) - value.ndim == p and value.gshape[dim] == shape[p]:
            part = _rows(value, dim, counts).to(dtype=x.larray.dtype)
            local = list(shape)
            local[p] = c
            return _fit(part, local)
    v = _fit(_whole_value(value, x), shape)
    return v.narrow(p, j0, c)


def setitem(x, key, value) -> None:
    """``x[key] = value`` (``heat_tpu`` dndarray.py:950-1046): each rank
    writes the part of the key that falls in its rows, in place; the value
    is cast to ``x``'s type (:969)."""
    from .dndarray import DNDarray

    if isinstance(key, DNDarray) and key.dtype is types.bool and key.ndim > 0:
        return _mask_set(x, key, value)
    if isinstance(key, DNDarray) and key.dtype is types.bool:
        key = bool(key.item())
    entries, block = parse(key, x.gshape, x.larray.device, _whole)
    out, bpos = _layout(entries, block)
    shape = _shape(entries, block, out)
    if not x.is_distributed():
        return local_set(x.larray, entries, block, _whole_value(value, x))
    comm = x.comm
    es = _split_entry(entries, x.split)
    e = entries[es]
    off = _offsets(x.lshape_map[:, x.split])
    r = comm.rank
    if e.kind == "slice":
        parts = [_slice_part(e, int(off[q]), int(off[q + 1])) for q in range(comm.size)]
        j0, j1 = parts[r]
        p = out.index(("slice", es))
        counts = [b - a for a, b in parts] if e.step > 0 else None
        v = _value_part(value, x, shape, p, j0, j1 - j0, counts)
        local = list(entries)
        local[es] = _local_slice(e, j0, j1, int(off[r]))
        return local_set(x.larray, local, block, v)
    v = _fit(_whole_value(value, x), shape)
    if e.kind == "int":
        owner = int(np.searchsorted(off[1:], e.value, side="right"))
        if r == owner:
            local = list(entries)
            local[es] = e.replace(value=e.value - int(off[owner]))
            local_set(x.larray, local, block, v)
        return None
    owner, m_q, local = _split_adv_parts(x, entries, block, es)
    m = int(np.prod(block, dtype=np.int64))
    flat = v.reshape(tuple(shape[:bpos]) + (m,) + tuple(shape[bpos + len(block):]))
    mine = torch.nonzero(owner == r).reshape(-1)
    return local_set(x.larray, local, (int(m_q[r]),), flat.index_select(bpos, mine))


def _mask_set(x, mask, value) -> None:
    """``x[mask] = value`` for a boolean DNDarray over leading axes, each
    rank on its own rows. A value that does not vary along the selection
    fills them in place, with no collective; a value array is consumed in
    mask order (:func:`_consumed`)."""
    from .dndarray import DNDarray

    k = mask.ndim
    if tuple(mask.gshape) != tuple(x.gshape[:k]):
        raise IndexError(f"boolean index of shape {mask.gshape} does not match the indexed array's {x.gshape}")
    trailing = tuple(x.gshape[k:])
    if not isinstance(value, DNDarray):
        value = _value_of(value, x)
    vshape = list(value.gshape if isinstance(value, DNDarray) else value.shape)
    while len(vshape) > 1 + len(trailing) and vshape[0] == 1:
        vshape.pop(0)
    varies = len(vshape) == 1 + len(trailing) and vshape[0] != 1
    comm, s = x.comm, x.split
    rows_here = x.is_distributed() and s < k  # the mask's rows meet this rank's
    m = _mask_part(mask, s, x.lshape_map[:, s], comm) if rows_here else _whole(mask)
    if x.is_distributed() and s >= k:  # the split axis is among the value's trailing axes
        counts = x.lshape_map[:, s]
        full = ((int(m.sum()),) if varies else ()) + trailing
        v = _value_part(value, x, full, s - k + int(varies), int(counts[: comm.rank].sum()), int(counts[comm.rank]),
                        counts)
    elif not varies:
        v = _fit(_whole_value(value, x), trailing)
    elif rows_here:
        v = _consumed(x, m, value, trailing)
    else:
        v = _fit(_whole_value(value, x), (int(m.sum()),) + trailing)
    if not varies and k == x.ndim:
        x.larray.masked_fill_(m, v)
    else:
        x.larray[m] = v
    return None


def _consumed(x, m_local: torch.Tensor, value, trailing) -> torch.Tensor:
    """The entries of a value array that this rank's selected positions
    take, in mask order: one all-gather of the ranks' counts a leading
    index before the split axis; each rank's entries start at the
    exclusive scan of those counts (at split 0, of the ranks' counts). A
    split-0 value of the selection's length is moved there, not
    gathered."""
    from .dndarray import DNDarray

    comm, s = x.comm, x.split
    lead = int(np.prod(x.gshape[:s], dtype=np.int64))
    m2 = m_local.reshape(lead, -1)
    cnt = m2.sum(1)
    every = comm.allgather(cnt.reshape(1, lead), 0)  # (p, lead): every rank's count a leading index
    total = every.sum(0)
    n_sel = int(total.sum())
    if (isinstance(value, DNDarray) and s == 0 and value.is_distributed() and value.split == 0
            and value.gshape[0] == n_sel):
        return _fit(_rows(value, 0, every[:, 0].cpu().numpy()).to(x.larray.dtype), (int(cnt.sum()),) + trailing)
    v = _fit(_whole_value(value, x), (n_sel,) + trailing)
    a = torch.nonzero(m2)[:, 0]
    base = torch.cumsum(total, 0) - total + every[: comm.rank].sum(0)
    within = torch.arange(a.numel(), device=a.device) - (torch.cumsum(cnt, 0) - cnt)[a]
    return v[base[a] + within]
