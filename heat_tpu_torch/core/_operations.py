"""Generic operation machinery (port of ``heat_tpu.core._operations``;
Heat reference: heat/core/_operations.py): the elementwise binary op
(``__binary_op``, ``heat_tpu`` :256), the local op (``__local_op``, :447),
the cumulative op (``__cum_op``, :400) and the reduction (``__reduce_op``,
:521).

Each runs on this rank's shard. ``heat_tpu`` runs one compiled program on
the padded global array and lets XLA place the collectives; here the
schedule is explicit:

- a binary op broadcasts its operands (NumPy rules, scalars on either
  side) and takes the output split of the dominant operand (the first
  one that is split, ``heat_tpu`` :311-329); an operand split elsewhere is
  resplit to it, a whole operand is sliced to this rank's rows (no bytes
  move), and operands of one split but different maps of shard shapes
  are brought to one map with ``redistribute_``. The result's shards
  follow that map;
- a local op maps each shard alone;
- a cumulative op along the split axis adds to the local cumulation an
  exclusive scan of the ranks' last rows, from one ``allgather`` of one
  row a rank (the reference's ``Exscan``);
- a reduction over the split axis combines the ranks' partials with one
  ``allreduce`` (reference :466-471).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from . import types
from .dndarray import DNDarray
from .sanitation import sanitize_in
from .stride_tricks import broadcast_shape, sanitize_axis

__all__ = []

_PYTHON_SCALARS = (bool, int, float, complex)


def operands(a, b):
    """The two operands of a binary op as tensors of one type: a Python
    number (the op's other operand gives the type) becomes a 0-d tensor on
    the CPU, which ATen takes as a scalar beside a tensor on any device."""
    dt = a.dtype if isinstance(a, torch.Tensor) else b.dtype
    return tuple(x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=dt) for x in (a, b))


def _kind(tt: torch.dtype):
    """The Python type of a number that takes part in an op on ``tt``."""
    if tt == torch.bool:
        return bool
    if tt.is_complex:
        return complex
    return float if tt.is_floating_point else int


def _output_split(split: Optional[int], axes: Tuple[int, ...], reduce_all: bool, keepdims: bool) -> Optional[int]:
    if split is None or reduce_all or split in axes:
        return None
    if keepdims:
        return split
    return split - sum(1 for a in axes if a < split)


def _whole(x: DNDarray) -> torch.Tensor:
    """``x``'s global tensor on every rank (one all-gather where ``x`` is
    distributed)."""
    if not x.is_distributed():
        return x.larray
    return x.comm.allgather(x.larray, x.split, x.lshape_map[:, x.split])


def _as_dndarray(x, ref: DNDarray) -> DNDarray:
    """An array-like operand (numpy array or scalar, tensor) as a whole
    DNDarray on ``ref``'s device and communicator."""
    from . import factories

    return factories.array(x, device=ref.device, comm=ref.comm)


def _twin(x: DNDarray, array: torch.Tensor) -> DNDarray:
    """A DNDarray of ``x``'s metadata over ``array`` (a shard of ``x``'s
    shape), so that redistributing it leaves ``x`` as it is."""
    return DNDarray(array, x.gshape, x.dtype, x.split, x.device, x.comm, x.lshape_map)


def _rows(x: DNDarray, dim: int, counts) -> torch.Tensor:
    """This rank's part of ``x`` (split along ``dim``) in the map of shard
    extents ``counts`` along ``dim``."""
    if np.array_equal(x.lshape_map[:, dim], counts):
        return x.larray
    twin = _twin(x, x.larray)
    target = twin.lshape_map
    target[:, dim] = counts
    twin.redistribute_(target_map=target)
    return twin.larray


def _local_operand(x: DNDarray, out_ndim: int, split: Optional[int], counts, displs) -> torch.Tensor:
    """The part of operand ``x`` that meets this rank's shard of the output
    (split ``split``, extents ``counts`` from ``displs``): its own shard
    where it is split there, else a slice of the whole array (a replicated
    operand costs no bytes), or the whole where its axis broadcasts."""
    if split is None or not x.comm.is_distributed():
        return _whole(x)
    dim = split - (out_ndim - x.ndim)
    if dim < 0 or x.gshape[dim] == 1:
        return _whole(x)
    if x.split == dim:
        return _rows(x, dim, counts)
    r = x.comm.rank
    return _whole(x).narrow(dim, int(displs[r]), int(counts[r]))


def _output_counts(operands, out_ndim: int, split: int, output_shape, comm):
    """The output's shard extents along ``split``: those of the first
    operand split there at full extent (so that it stays where it is),
    else the chunk geometry."""
    for x in operands:
        if isinstance(x, DNDarray) and x.split is not None and x.is_distributed():
            dim = x.split
            if dim + out_ndim - x.ndim == split and x.gshape[dim] == output_shape[split]:
                return x.lshape_map[:, dim].copy()
    return comm.lshape_map(output_shape, split)[:, split]


def _store(out: DNDarray, result: DNDarray) -> DNDarray:
    """``result`` into the buffer ``out``, which keeps its type, split and
    map of shard shapes (``heat_tpu`` :374-382)."""
    from .sanitation import sanitize_out

    sanitize_out(out, result.gshape)
    if out.split != result.split and result.comm.is_distributed():
        result = result.resplit(out.split)
    local = result.larray
    if out.split is not None and out.is_distributed():
        local = _rows(result, out.split, out.lshape_map[:, out.split])
    out._set_shard(local.to(out.dtype.torch_type()))
    return out


def __binary_op(
    operation: Callable,
    t1,
    t2,
    out: Optional[DNDarray] = None,
    where=None,
    fn_kwargs: Optional[dict] = None,
) -> DNDarray:
    """Generic elementwise binary operation (``heat_tpu`` :256; reference
    :22). ``operation(a, b, **fn_kwargs)`` gets this rank's operands cast
    to the promoted type (``types.result_type``; Python numbers stay Python
    numbers), broadcast against each other, and its result's dtype is the
    output's. ``where`` keeps the result where it is true and ``out``'s
    values (or zeros) elsewhere."""
    fn_kwargs = fn_kwargs or {}
    if not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray):
        raise TypeError(f"at least one operand must be a DNDarray, got {type(t1)}, {type(t2)}")
    ref = t1 if isinstance(t1, DNDarray) else t2
    promoted = types.result_type(t1, t2)
    tt = promoted.torch_type()
    if not isinstance(t1, (DNDarray, *_PYTHON_SCALARS)):
        t1 = _as_dndarray(t1, ref)
    if not isinstance(t2, (DNDarray, *_PYTHON_SCALARS)):
        t2 = _as_dndarray(t2, ref)
    shape1 = t1.gshape if isinstance(t1, DNDarray) else ()
    shape2 = t2.gshape if isinstance(t2, DNDarray) else ()
    output_shape = broadcast_shape(shape1, shape2)
    out_ndim = len(output_shape)

    def _split_in_output(t):
        if not isinstance(t, DNDarray) or t.split is None:
            return None
        return t.split + (out_ndim - t.ndim)

    s1, s2 = _split_in_output(t1), _split_in_output(t2)
    if s1 is not None and s2 is not None and s1 != s2:
        target = s1 - (out_ndim - t2.ndim)
        if target >= 0 and t2.comm.is_distributed():  # the reference redistributes the non-dominant operand
            t2 = t2.resplit(target)
        s2 = _split_in_output(t2)
    output_split = s1 if s1 is not None else s2
    # a broadcast axis of extent ≤ 1 cannot carry the split
    if output_split is not None and output_shape[output_split] <= 1:
        output_split = None

    comm = ref.comm
    counts = displs = lmap = None
    if output_split is not None and comm.is_distributed():
        counts = _output_counts((t1, t2), out_ndim, output_split, output_shape, comm)
        displs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        lmap = comm.lshape_map(output_shape, output_split)
        lmap[:, output_split] = counts

    def _local(t):
        if not isinstance(t, DNDarray):  # a weak Python number, of the promoted kind
            return _kind(tt)(t)
        return _local_operand(t, out_ndim, output_split, counts, displs).to(tt)

    result = operation(_local(t1), _local(t2), **fn_kwargs)
    if where is not None:
        if not isinstance(where, DNDarray):
            where = _as_dndarray(where, ref)
        w = _local_operand(where, out_ndim, output_split, counts, displs).to(torch.bool)
        if out is not None:
            base = _local_operand(out, out_ndim, output_split, counts, displs).to(result.dtype)
        else:
            base = torch.zeros((), dtype=result.dtype, device=result.device)
        result = torch.where(w, result, base)
    res = DNDarray(result, output_shape, types.canonical_heat_type(result.dtype), output_split, ref.device, comm,
                   lmap)
    if out is not None:
        return _store(out, res)
    return res


def __local_op(
    operation: Callable,
    x: DNDarray,
    out: Optional[DNDarray] = None,
    no_cast: bool = False,
    **kwargs,
) -> DNDarray:
    """Generic elementwise operation on each shard alone (``heat_tpu``
    :447; reference :305). Unless ``no_cast``, integer types are cast to
    float first (``promote_types(x.dtype, float32)``, :466-469)."""
    sanitize_in(x)
    t = x.larray
    if not no_cast and types.heat_type_is_exact(x.dtype):
        t = t.to(types.promote_types(x.dtype, types.float32).torch_type())
    result = operation(t, **kwargs)
    res = DNDarray(result, x.gshape, types.canonical_heat_type(result.dtype), x.split, x.device, x.comm,
                   x.lshape_map if x.split is not None else None)
    if out is not None:
        return _store(out, res)
    return res


# the combine of each cumulative op across ranks: (neutral, reduction of
# the ranks' last rows before this one, how that prefix enters)
_CUM_COMBINE = {
    torch.cumsum: (0, torch.sum, torch.add),
    torch.cumprod: (1, torch.prod, torch.mul),
}


def __cum_op(
    operation: Callable,
    x: DNDarray,
    axis: int,
    out: Optional[DNDarray] = None,
    dtype=None,
) -> DNDarray:
    """Generic cumulative op (``heat_tpu`` :400; reference :204):
    ``operation`` (``torch.cumsum`` or ``torch.cumprod``) on each shard,
    in ``dtype`` where given, else in ``jnp``'s result type (bool → int64,
    other types kept). Along the split axis each rank then combines its
    cumulation with the ranks' totals before it: one ``allgather`` of one
    row a rank (a rank with no rows sends the neutral row)."""
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    if axis is None:
        raise NotImplementedError("cumulative operation over flattened array: ravel first")
    if dtype is not None:
        tt = types.canonical_heat_type(dtype).torch_type()
    else:
        tt = torch.int64 if x.larray.dtype == torch.bool else x.larray.dtype
    result = operation(x.larray.to(tt), dim=axis, dtype=tt)
    if x.is_distributed() and axis == x.split:
        neutral, reduce, apply = _CUM_COMBINE[operation]
        if result.shape[axis]:
            last = result.narrow(axis, result.shape[axis] - 1, 1)
        else:
            shape = list(result.shape)
            shape[axis] = 1
            last = torch.full(shape, neutral, dtype=tt, device=result.device)
        lasts = x.comm.allgather(last.contiguous(), axis)
        prefix = reduce(lasts.narrow(axis, 0, x.comm.rank), dim=axis, keepdim=True, dtype=tt)
        result = apply(result, prefix)
    res = DNDarray(result, x.gshape, types.canonical_heat_type(result.dtype), x.split, x.device, x.comm,
                   x.lshape_map if x.split is not None else None)
    if out is not None:
        return _store(out, res)
    return res


def __reduce_op(
    partial_op: Callable[[torch.Tensor, Tuple[int, ...], bool], torch.Tensor],
    x: DNDarray,
    axis: Optional[Union[int, Tuple[int, ...]]] = None,
    out: Optional[DNDarray] = None,
    keepdims: bool = False,
    combine: Union[str, Callable] = "sum",
    finish: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> DNDarray:
    """Reduce ``x`` over ``axis`` (None: every axis) (``heat_tpu`` :521;
    reference :378). ``partial_op(t, axes, keepdims)`` reduces a shard;
    ``combine`` names the ``allreduce`` op that merges the ranks' partials
    (or is ``combine(comm, partial)``, which merges them);
    ``finish`` (if given) maps the merged result to the output (a cast
    back, say). The output's split follows ``heat_tpu``'s rules: None when
    the split axis is reduced (or every axis), else the split axis
    renumbered past the reduced axes, or kept where ``keepdims``."""
    sanitize_in(x)
    axis = sanitize_axis(x.shape, axis)
    reduce_all = axis is None
    axes = tuple(range(x.ndim)) if reduce_all else ((axis,) if isinstance(axis, int) else tuple(axis))
    split = x.split
    output_split = _output_split(split, axes, reduce_all, keepdims)
    result = partial_op(x.larray, axes, keepdims)
    if split is not None and split in axes and x.comm.is_distributed():
        result = combine(x.comm, result) if callable(combine) else x.comm.allreduce(result, combine)
    if finish is not None:
        result = finish(result)
    if keepdims:
        output_shape = tuple(1 if i in axes else s for i, s in enumerate(x.gshape))
    else:
        output_shape = tuple(s for i, s in enumerate(x.gshape) if i not in axes)
    lmap = None
    if output_split is not None:
        lmap = x.lshape_map
        lmap = lmap.copy() if keepdims else np.delete(lmap, list(axes), axis=1)
        if keepdims:
            lmap[:, list(axes)] = 1
    res = DNDarray(result, output_shape, types.canonical_heat_type(result.dtype), output_split, x.device, x.comm,
                   lmap)
    if out is not None:
        return _store(out, res)
    return res
