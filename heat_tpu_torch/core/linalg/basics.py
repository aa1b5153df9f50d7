"""Dense linear algebra basics (port of ``heat_tpu.core.linalg.basics``).

Heat reference: heat/core/linalg/basics.py (``matmul`` :421, ``dot``
:244, ``inv`` :310, ``det`` :158, the norms :1113-1389, ``outer`` :1390,
``trace`` :1641, ``transpose`` :2056, ``tril``/``triu`` :2126-2240).

``heat_tpu`` hands the global product to XLA and lets GSPMD insert the
collectives. The port runs one process a rank, so each function here
states its schedule over the shards. ``matmul`` keeps the reference's
rules for the result's split (a.split = 0 gives 0, else b.split = 1 gives
1, else replicated) and, of its two routes, takes the one that brings
fewer elements to a rank:

- a row block of a times the whole b (result split 0), or the whole a
  times a column block of b (split 1), each local once the operand that
  must be whole is whole: it is gathered (k·n elements for b, m·k for a),
  unless gathering the other operand and moving the m × n product moves
  less: the product is then formed whole and all-reduced (2·m·n), or
  formed as a column block and resplit to rows (m·n/p);
- a contraction block of a times the matching block of b (a.split = 1
  against b.split = 0, or one side split on the contraction axis against
  a whole other side): a local partial product and one ``allreduce``,
  replicated.

Under ``HEAT_TPU_REDIST_OVERLAP=1`` the contraction of a split-1 ``a``
against a split-0 ``b`` runs as ``heat_tpu``'s collective matmul
(``kernels.cmatmul.ring_matmul_reduce``: 2(p − 1) permutes, each output
chunk summed once in ring order, the same bits on every rank); under
``auto`` it keeps the all-reduce, as ``heat_tpu`` does off the TPU.
``precision=`` is accepted: float32 products run in full FP32
(torch's default ``allow_tf32=False``), as ``precision="highest"`` does.
``inv`` and ``det`` of a matrix split along its rows or columns of order
≥ ``_BLOCKED_MIN_N`` (512) factor it by the blocked LU of
``factorizations.py`` with no gather, as ``heat_tpu`` does; below that
order they gather the matrix first, as does ``matrix_norm`` over a split
axis. Operands of more than two dimensions with a split, and 1-D operands
of ``matmul``, are gathered too: the result is then chunked along its
split.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from .. import types
from .._operations import __reduce_op as _reduce_op, _whole
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from ..stride_tricks import sanitize_axis

__all__ = [
    "cross",
    "det",
    "dot",
    "inv",
    "matmul",
    "matrix_norm",
    "norm",
    "outer",
    "projection",
    "trace",
    "transpose",
    "tril",
    "triu",
    "vdot",
    "vecdot",
    "vector_norm",
]


# --------------------------------------------------------------------- #
# shards                                                                #
# --------------------------------------------------------------------- #
def _chunk(t: torch.Tensor, split: Optional[int], ref: DNDarray) -> torch.Tensor:
    """This rank's chunk along ``split`` of the global tensor ``t``."""
    if split is None or not ref.comm.is_distributed():
        return t
    return t[ref.comm.chunk(tuple(t.shape), split)[2]]


def _local(x: DNDarray, split: Optional[int]) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``split`` (chunk geometry): the
    shard itself where ``x`` is split there, a slice where ``x`` is whole,
    else ``x`` resplit."""
    if not x.comm.is_distributed() or x.split == split:
        return x._balanced_larray()
    if x.split is None:
        return _chunk(x.larray, split, x)
    return x.resplit(split).larray


def _out(local: torch.Tensor, gshape, split: Optional[int], ref: DNDarray) -> DNDarray:
    """A DNDarray of this rank's ``local`` in the chunk geometry."""
    gshape = tuple(int(s) for s in gshape)
    if split is not None and len(gshape) > 0:
        split = split % len(gshape)
    else:
        split = None
    return DNDarray(local, gshape, types.canonical_heat_type(local.dtype), split, ref.device, ref.comm)


def _from_whole(t: torch.Tensor, split: Optional[int], ref: DNDarray) -> DNDarray:
    """A DNDarray of the global tensor ``t``, of which this rank keeps its
    chunk along ``split``."""
    if split is not None and t.ndim > 0:
        split = split % t.ndim
    else:
        split = None
    return _out(_chunk(t, split, ref).clone() if split is not None and ref.comm.is_distributed() else t,
                t.shape, split, ref)


_NARROW = (torch.float16, torch.bfloat16)


def _float_of(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in float32 when ``dtype`` is an integer type (``heat_tpu``'s
    cast before a decomposition), or float16 or bfloat16 (LAPACK has no
    half precision: the decomposition runs in float32 and its result is
    cast back, :func:`_narrow_back`)."""
    if types.heat_type_is_exact(dtype) or dtype is types.bool or t.dtype in _NARROW:
        return t.to(torch.float32)
    return t


def _narrow_back(t: torch.Tensor, dtype) -> torch.Tensor:
    """A result computed in float32 cast back to a float16 or bfloat16
    operand's type."""
    return t.to(dtype.torch_type()) if dtype.torch_type() in _NARROW else t


def _refuse_narrow(dtype, what: str) -> None:
    """``heat_tpu``'s refusal of a float16 or bfloat16 decomposition
    (``jnp.linalg`` has none)."""
    if dtype.torch_type() in _NARROW:
        raise NotImplementedError(f"{what} of {dtype.__name__} is not implemented (heat_tpu refuses it too)")


def _sum(t: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``torch.sum`` that keeps the operand's dtype (torch widens integer
    sums to int64, XLA does not)."""
    dtype = t.dtype if t.dtype != torch.bool else torch.int64
    if dim is None:
        return torch.sum(t, dtype=dtype)
    return torch.sum(t, dim=dim, keepdim=keepdim, dtype=dtype)


def _wide_sum(t: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``jnp.sum``'s sum, as ``jnp.trace`` and ``heat_tpu``'s ``vecdot``
    take it: bools and signed integers in int64, float16 and bfloat16 in
    float32 and back; uint8 would give uint64, which is no heat type."""
    if t.dtype == torch.uint8:
        raise TypeError("a sum of uint8 is uint64 (jnp's type), which is not a heat type")
    acc = torch.float32 if t.dtype in _NARROW else (t.dtype if t.dtype.is_floating_point or t.dtype.is_complex
                                                     else torch.int64)
    out = torch.sum(t, dtype=acc) if dim is None else torch.sum(t, dim=dim, keepdim=keepdim, dtype=acc)
    return out.to(t.dtype) if t.dtype in _NARROW else out


def _bool_product(fn, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fn`` (a product with sums) of two operands; bools multiply as
    integers and come back as ``> 0`` (the bool product of ``jnp``: an OR
    of ANDs)."""
    if a.dtype != torch.bool:
        return fn(a, b)
    return fn(a.to(torch.int64), b.to(torch.int64)) > 0


# --------------------------------------------------------------------- #
# matmul                                                                #
# --------------------------------------------------------------------- #
def _matmul_split(a: DNDarray, b: DNDarray, out_ndim: int) -> Optional[int]:
    """``heat_tpu``'s split of the product (basics.py:299-309)."""
    if a.ndim >= 2 and a.split == a.ndim - 2:
        return out_ndim - 2
    if b.ndim >= 2 and b.split == b.ndim - 1:
        return out_ndim - 1
    if a.split is not None and a.ndim > 2 and a.split < a.ndim - 2:
        return a.split
    if b.split is not None and b.ndim > 2 and b.split < b.ndim - 2:
        return b.split
    return None


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul``; bools as integers (their counts of true terms)."""
    if a.dtype == torch.bool:
        return torch.matmul(a.to(torch.int64), b.to(torch.int64))
    return torch.matmul(a, b)


def _contraction_product(a_k: torch.Tensor, b_k: torch.Tensor, ref: DNDarray) -> torch.Tensor:
    """Σ over ranks of a's and b's matching contraction blocks: the local
    partial product and one ``allreduce``."""
    return ref.comm.allreduce(_mm(a_k, b_k))


def _matmul_2d(a: DNDarray, b: DNDarray, ta: torch.dtype, split: Optional[int]) -> torch.Tensor:
    """This rank's part of ``a @ b`` (2-D operands, at least one
    distributed) for the result split ``split``."""

    def loc(x: DNDarray, s):
        return _local(x, s).to(ta)

    m, k, n = a.shape[0], a.shape[1], b.shape[1]
    # elements a route brings to a rank: an operand's gather its size, an
    # allreduce of the product 2·m·n, a resplit of its column blocks m·n/p
    if split == 0:  # a.split == 0: a's row block times the whole b
        moved = 2 * m * n if b.split == 0 else m * n // a.comm.size
        if b.split is None or k * n <= m * k + moved:
            return _mm(loc(a, 0), _whole(b).to(ta))
        a_all = _whole(a).to(ta)  # gathering a moves less
        if b.split == 0:
            whole = _contraction_product(_chunk(a_all, 1, a), loc(b, 0), a)
            return _chunk(whole, 0, a)
        return _out(_mm(a_all, loc(b, 1)), (m, n), 1, a).resplit(0).larray
    if split == 1:  # b.split == 1: the whole a times b's column block
        if a.split is None or m * k <= k * n + 2 * m * n:
            return _mm(_whole(a).to(ta), loc(b, 1))
        b_all = _whole(b).to(ta)  # gathering b moves less (a.split == 1 here)
        whole = _contraction_product(loc(a, 1), _chunk(b_all, 0, a), a)
        return _chunk(whole, 1, a)
    # replicated: contraction blocks (a split 1 and/or b split 0), or whole
    if a.split == 1 and b.split == 0:
        from ...kernels import cmatmul

        if cmatmul.ring_enabled():
            with cmatmul.stamp_scope("matmul"):
                return cmatmul.ring_matmul_reduce(loc(a, 1), loc(b, 0), a.comm, a.comm.size, mm=_mm)[:m]
    if a.split == 1 or b.split == 0:
        return _contraction_product(loc(a, 1), loc(b, 0), a)
    return _mm(_whole(a).to(ta), _whole(b).to(ta))


def matmul(a: DNDarray, b: DNDarray, allow_resplit: bool = False, precision=None) -> DNDarray:
    """Matrix product of two DNDarrays (reference: basics.py:421).

    The result's split follows the reference's rules: a.split = 0 gives
    split 0, b.split = 1 gives split 1, a.split = 1 against b.split = 0 a
    replicated result (local partial product plus one ``allreduce``). The
    operand that must be whole is gathered unless gathering the other one
    and moving the product brings fewer elements to a rank. ``allow_resplit`` and ``precision`` are accepted for API parity;
    float32 products run in full FP32."""
    sanitize_in(a), sanitize_in(b)
    if a.ndim < 1 or b.ndim < 1:
        raise ValueError("matmul requires at least 1-dimensional operands")
    promoted = types.promote_types(a.dtype, b.dtype)
    ta = promoted.torch_type()
    out_shape = torch.broadcast_shapes(a.gshape[:-2], b.gshape[:-2]) if a.ndim > 2 or b.ndim > 2 else ()
    out_shape = tuple(out_shape) + tuple(a.gshape[-2:-1]) + tuple(b.gshape[-1:] if b.ndim > 1 else ())
    split = _matmul_split(a, b, len(out_shape))
    distributed = a.is_distributed() or b.is_distributed()
    if not distributed:
        local = _mm(a.larray.to(ta), b.larray.to(ta))
    elif a.ndim == 2 and b.ndim == 2:
        local = _matmul_2d(a, b, ta, split)
    else:
        local = _chunk(_mm(_whole(a).to(ta), _whole(b).to(ta)), split, a)
    if ta == torch.bool:  # the counts of true terms, as the bool product
        local = local > 0
    return _out(local, out_shape, split, a)


# --------------------------------------------------------------------- #
# products of vectors                                                   #
# --------------------------------------------------------------------- #
def _aligned(x1: DNDarray, x2: DNDarray, ta: torch.dtype):
    """(x1's shard, x2's matching shard, split) of two arrays of one
    shape: both in the chunk geometry along x1's split (or x2's where x1
    is whole). split is None where both are whole."""
    split = x1.split if x1.split is not None else x2.split
    if not (x1.is_distributed() or x2.is_distributed()):
        return x1.larray.to(ta), x2.larray.to(ta), None
    return _local(x1, split).to(ta), _local(x2, split).to(ta), split


def dot(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Dot product following numpy semantics (reference: basics.py:244):
    the inner product of two vectors (local products of matching shards
    and one ``allreduce``), or ``matmul`` of two matrices."""
    sanitize_in(a), sanitize_in(b)
    if a.ndim == 1 and b.ndim == 1:
        if a.shape != b.shape:
            raise ValueError(f"shapes {a.shape} and {b.shape} not aligned")
        ta = types.promote_types(a.dtype, b.dtype).torch_type()
        xa, xb, split = _aligned(a, b, ta)
        result = _sum(xa * xb)
        if split is not None:
            result = a.comm.allreduce(result)
        ret = _out(result > 0 if ta == torch.bool else result, (), None, a)
    elif a.ndim == 2 and b.ndim == 2:
        ret = matmul(a, b)
    else:
        raise NotImplementedError("ht.dot not implemented for given dimensions")
    if out is not None:
        out.larray = ret.larray
        return out
    return ret


def vdot(x1: DNDarray, x2: DNDarray) -> DNDarray:
    """Conjugated dot product of the flattened arrays (reference:
    basics.py vdot): the sum of conj(x1)·x2 over matching shards, then one
    ``allreduce``."""
    sanitize_in(x1), sanitize_in(x2)
    if x1.size != x2.size:
        raise ValueError(f"vdot needs arrays of one size, got {x1.shape} and {x2.shape}")
    ta = types.promote_types(x1.dtype, x2.dtype).torch_type()
    if x1.shape == x2.shape:
        a, b, split = _aligned(x1, x2, ta)
        result = _sum(torch.conj(a) * b)
        if split is not None:
            result = x1.comm.allreduce(result)
    else:
        result = _sum(torch.conj(_whole(x1).to(ta)).reshape(-1) * _whole(x2).to(ta).reshape(-1))
    if ta == torch.bool:  # the bool product: an OR of ANDs
        result = result > 0
    return _out(result.resolve_conj(), (), None, x1)


def vecdot(x1: DNDarray, x2: DNDarray, axis: Optional[int] = None, keepdims: bool = False) -> DNDarray:
    """Sum of conj(x1)·x2 along ``axis`` (default the last; reference:
    basics.py vecdot). Over the split axis the local sums are combined
    with one ``allreduce``."""
    sanitize_in(x1), sanitize_in(x2)
    if axis is None:
        axis = -1
    ta = types.promote_types(x1.dtype, x2.dtype).torch_type()
    out_shape = tuple(torch.broadcast_shapes(x1.gshape, x2.gshape))
    norm_axis = axis % max(len(out_shape), 1)
    split = x1.split if x1.split is not None else x2.split
    if split is not None:
        if split == norm_axis:
            split = None
        elif not keepdims and split > norm_axis:
            split -= 1
        if split is not None and split >= len(out_shape) - (0 if keepdims else 1):
            split = None
    res_shape = tuple(1 if i == norm_axis else s for i, s in enumerate(out_shape))
    if not keepdims:
        res_shape = tuple(s for i, s in enumerate(out_shape) if i != norm_axis)
    if x1.shape == x2.shape and (x1.is_distributed() or x2.is_distributed()):
        a, b, local_split = _aligned(x1, x2, ta)
        result = _wide_sum(torch.conj(a) * b, dim=axis, keepdim=keepdims)
        if local_split == norm_axis:
            result = x1.comm.allreduce(result)
        return _out(result.resolve_conj(), res_shape, split, x1)
    result = _wide_sum(torch.conj(_whole(x1).to(ta)) * _whole(x2).to(ta), dim=axis, keepdim=keepdims)
    return _from_whole(result.resolve_conj(), split, x1)


def outer(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None, split: Optional[int] = None) -> DNDarray:
    """Outer product of two vectors (reference: basics.py:1390). The
    result is split along 0 where either operand is split (or along
    ``split``); each rank forms its block from its chunk of one vector and
    the whole other one."""
    sanitize_in(a), sanitize_in(b)
    ta = types.promote_types(a.dtype, b.dtype).torch_type()
    if split is None:
        split = 0 if (a.split is not None or b.split is not None) else None
    x = (_local(a, 0) if split == 0 else _whole(a)).to(ta).reshape(-1)
    y = (_local(b, 0) if split == 1 else _whole(b)).to(ta).reshape(-1)
    ret = _out(torch.outer(x, y), (a.size, b.size), split, a)
    if out is not None:
        out.larray = ret.larray.to(out.dtype.torch_type())
        return out
    return ret


def _cross_local(x: torch.Tensor, y: torch.Tensor, axisa: int, axisb: int, axisc: int) -> torch.Tensor:
    """numpy's ``cross`` of torch tensors: vectors of 2 or 3 components
    (2 reads as z = 0)."""
    x, y = torch.movedim(x, axisa, -1), torch.movedim(y, axisb, -1)
    if x.shape[-1] not in (2, 3) or y.shape[-1] not in (2, 3):
        raise ValueError("incompatible dimensions for cross product (dimension must be 2 or 3)")
    if x.shape[-1] == 2 and y.shape[-1] == 2:
        return x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]

    def three(t):
        return t if t.shape[-1] == 3 else torch.cat([t, torch.zeros_like(t[..., :1])], dim=-1)

    x, y = torch.broadcast_tensors(three(x), three(y))
    c = torch.stack([x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1],
                     x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2],
                     x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]], dim=-1)
    return torch.movedim(c, -1, axisc)


def cross(a: DNDarray, b: DNDarray, axisa: int = -1, axisb: int = -1, axisc: int = -1, axis: int = -1) -> DNDarray:
    """Cross product of vectors of 2 or 3 components (reference: basics.py
    cross). 3-vectors of one shape and split, split off the vector axis,
    stay local; other operands are gathered. The result carries a's split
    (b's where a is whole), as in ``heat_tpu``."""
    sanitize_in(a), sanitize_in(b)
    ta = types.promote_types(a.dtype, b.dtype).torch_type()
    gshape = _cross_local(torch.empty(a.gshape, device="meta"), torch.empty(b.gshape, device="meta"),
                          axisa, axisb, axisc).shape
    split = a.split if a.split is not None else b.split
    if split is not None and split >= len(gshape):
        split = None
    vec = axisa % a.ndim
    local_ok = (
        a.gshape == b.gshape and a.split == b.split and a.shape[vec] == 3
        and vec == axisb % b.ndim == axisc % len(gshape) and split != vec
    )
    if local_ok or not (a.is_distributed() or b.is_distributed()):
        local = _cross_local(a._balanced_larray().to(ta), b._balanced_larray().to(ta), axisa, axisb, axisc)
        return _out(local, gshape, split, a)
    return _from_whole(_cross_local(_whole(a).to(ta), _whole(b).to(ta), axisa, axisb, axisc), split, a)


def projection(a: DNDarray, b: DNDarray) -> DNDarray:
    """Projection of vector a onto vector b (reference: basics.py)."""
    sanitize_in(a), sanitize_in(b)
    if a.ndim != 1 or b.ndim != 1:
        raise RuntimeError(f"projection requires 1-D vectors, got {a.ndim}, {b.ndim}")
    scale = dot(a, b).larray / dot(b, b).larray
    return _out(scale * b._balanced_larray(), b.gshape, b.split, b)


# --------------------------------------------------------------------- #
# square matrices                                                       #
# --------------------------------------------------------------------- #
def _square(a: DNDarray) -> None:
    sanitize_in(a)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected square matrix, got shape {a.shape}")


def _batch_local(a: DNDarray) -> bool:
    """Whether each rank holds whole matrices (split on a batch axis, or
    not distributed)."""
    return not a.is_distributed() or a.split < a.ndim - 2


# from this order up, a 2-D matrix split along its rows or columns runs
# inv/det through the blocked LU of factorizations.py (heat_tpu
# basics.py:130); below it the matrix is gathered
_BLOCKED_MIN_N = 512


def _blocked_linalg_eligible(a: DNDarray) -> bool:
    return a.ndim == 2 and a.split in (0, 1) and a.comm.is_distributed() and int(a.shape[0]) >= _BLOCKED_MIN_N


def inv(a: DNDarray) -> DNDarray:
    """Inverse of (batched) square matrices (reference: basics.py:310).
    A matrix split along its rows or columns of order ≥ ``_BLOCKED_MIN_N``
    is factored by the blocked LU and the identity (split 0) solved
    against the factors (``factorizations._solve_factored``), then resplit
    to the operand's split (``heat_tpu`` basics.py:208); a smaller one is
    gathered, inverted and chunked again."""
    _square(a)
    _refuse_narrow(a.dtype, "inv")
    if _blocked_linalg_eligible(a):
        from .. import factories
        from .factorizations import _lu_factor_ex, _refuse_singular, _solve_factored

        pvec, l_arr, u_arr, _sign, singular = _lu_factor_ex(a)
        _refuse_singular(singular, "ht.linalg.inv")
        rhs = factories.eye((int(a.shape[0]),) * 2, dtype=l_arr.dtype, split=0, device=a.device, comm=a.comm)
        x = _solve_factored("lu", rhs, l_arr, u_arr, pvec)
        return x if x.split == a.split else x.resplit(a.split)
    if _batch_local(a):
        return _out(torch.linalg.inv(_float_of(a._balanced_larray(), a.dtype)), a.gshape, a.split, a)
    return _from_whole(torch.linalg.inv(_float_of(_whole(a), a.dtype)), a.split, a)


def _blocked_det(a: DNDarray) -> torch.Tensor:
    """``sign · prod(diag(U))`` of the blocked LU: each rank's product of
    the diagonal entries in its rows, then one all-reduced product. Where
    the LU met a zero pivot (a singular matrix, or one whose panel block is
    singular under pivoting within each rank's rows) every rank gathers
    the matrix and takes ``torch.linalg.det`` of it (0 for a singular one;
    one host read)."""
    from .factorizations import _lu_factor_ex

    if a.dtype.torch_type() in _NARROW:
        a = a.astype(types.float32)
    _pvec, _l, u, sign, singular = _lu_factor_ex(a)
    if int(singular):
        return torch.linalg.det(_float_of(_whole(a), a.dtype))
    start = a.comm.chunk(u.gshape, 0)[0]
    part = torch.prod(torch.diagonal(u._balanced_larray(), offset=start))
    return sign.to(part.dtype) * a.comm.allreduce(part, "prod")


def det(a: DNDarray) -> DNDarray:
    """Determinant of (batched) square matrices (reference: basics.py:158).
    A matrix split along its rows or columns of order ≥ ``_BLOCKED_MIN_N``
    is factored by the blocked LU (``heat_tpu`` basics.py:158): one
    all-reduced product of the ranks' diagonal products times the sign; a
    smaller one is gathered first."""
    _square(a)
    split = a.split if a.split is not None and a.split < a.ndim - 2 else None
    if _blocked_linalg_eligible(a):
        return _out(_narrow_back(_blocked_det(a), a.dtype), (), None, a)
    if _batch_local(a):
        d = torch.linalg.det(_float_of(a._balanced_larray(), a.dtype))
        return _out(_narrow_back(d, a.dtype), a.gshape[:-2], split, a)
    return _out(_narrow_back(torch.linalg.det(_float_of(_whole(a), a.dtype)), a.dtype), a.gshape[:-2], None, a)


def trace(a: DNDarray, offset: int = 0, axis1: int = 0, axis2: int = 1, dtype=None, out=None) -> DNDarray:
    """Sum along diagonals (reference: basics.py:1641). Split along
    ``axis1`` or ``axis2``, each rank sums the part of the diagonal in its
    block and one ``allreduce`` adds the parts."""
    sanitize_in(a)
    if a.ndim < 2:
        raise ValueError("trace requires at least 2 dimensions")
    ax = sanitize_axis(a.shape, (axis1, axis2))
    t = a._balanced_larray()
    off = offset
    if a.is_distributed() and a.split in ax:
        start = a.comm.chunk(a.gshape, a.split)[0]
        off = offset + start if a.split == ax[0] else offset - start
    local = _wide_sum(torch.diagonal(t, offset=off, dim1=ax[0], dim2=ax[1]), dim=-1)
    split = a.split if a.split is not None and a.split not in ax else None
    if a.is_distributed() and a.split in ax:
        local = a.comm.allreduce(local)
    if split is not None:
        split = split - sum(1 for x in ax if x < split)
    if dtype is not None:
        local = local.to(types.canonical_heat_type(dtype).torch_type())
    ret = _out(local, tuple(s for i, s in enumerate(a.gshape) if i not in ax), split, a)
    if out is not None:
        out.larray = ret.larray
        return out
    return ret


def transpose(a: DNDarray, axes: Optional[List[int]] = None) -> DNDarray:
    """Permute the dimensions (reference: basics.py:2056): a local permute
    of each shard (a view of it, as numpy's transpose is) and the split
    moved with its axis."""
    sanitize_in(a)
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    else:
        axes = tuple(sanitize_axis(a.shape, int(ax)) for ax in axes)
        if sorted(axes) != list(range(a.ndim)):
            raise ValueError(f"axes do not match array dimensions, got {axes}")
    split = axes.index(a.split) if a.split is not None else None
    lmap = a.lshape_map[:, list(axes)] if a.split is not None else None
    return DNDarray(a.larray.permute(*axes), tuple(a.gshape[i] for i in axes), a.dtype, split, a.device, a.comm,
                    lmap)


def _tri(m: DNDarray, k: int, op) -> DNDarray:
    """``op`` (torch.tril or torch.triu) on the last two axes, each shard
    with its diagonal offset moved by where its block starts."""
    sanitize_in(m)
    if m.ndim == 1:  # the vector tiled into rows, split 0 where m is split
        n = m.shape[0]
        split = 0 if m.split is not None else None
        rows = m.comm.chunk((n, n), split)[1][0] if m.comm.is_distributed() else n
        start = m.comm.chunk((n, n), split)[0] if m.comm.is_distributed() else 0
        local = op(_whole(m).expand(rows, n), diagonal=k + start)
        return _out(local.contiguous(), (n, n), split, m)
    t = m._balanced_larray()
    shift = 0
    if m.is_distributed() and m.split >= m.ndim - 2:
        start = m.comm.chunk(m.gshape, m.split)[0]
        shift = start if m.split == m.ndim - 2 else -start
    return _out(op(t, diagonal=k + shift), m.gshape, m.split, m)


def tril(m: DNDarray, k: int = 0) -> DNDarray:
    """Lower triangle (reference: basics.py:2126)."""
    return _tri(m, k, torch.tril)


def triu(m: DNDarray, k: int = 0) -> DNDarray:
    """Upper triangle (reference: basics.py:2183)."""
    return _tri(m, k, torch.triu)


# --------------------------------------------------------------------- #
# norms                                                                 #
# --------------------------------------------------------------------- #
def _vector_norm_ops(ord_):
    """(partial over a shard, allreduce op, finish) of a vector norm."""
    inf = float("inf")

    def amax(t, axes, keep):
        return torch.amax(t.abs(), dim=axes, keepdim=keep) if t.numel() else _empty_reduce(t, axes, keep, 0.0)

    def amin(t, axes, keep):
        return torch.amin(t.abs(), dim=axes, keepdim=keep) if t.numel() else _empty_reduce(t, axes, keep, inf)

    if ord_ == inf:
        return amax, "max", None
    if ord_ == -inf:
        return amin, "min", None
    if ord_ == 0:
        return (lambda t, axes, keep: torch.sum((t != 0).to(t.abs().dtype), dim=axes, keepdim=keep)), "sum", None
    if ord_ == 2:
        return (lambda t, axes, keep: torch.sum(t.abs() ** 2, dim=axes, keepdim=keep)), "sum", torch.sqrt
    p = float(ord_)
    return (lambda t, axes, keep: torch.sum(t.abs() ** p, dim=axes, keepdim=keep)), "sum", (lambda s: s ** (1.0 / p))


def _empty_reduce(t: torch.Tensor, axes, keep: bool, fill: float) -> torch.Tensor:
    shape = [1 if i in axes else s for i, s in enumerate(t.shape)] if keep else [
        s for i, s in enumerate(t.shape) if i not in axes]
    return torch.full(shape, fill, dtype=t.abs().dtype, device=t.device)


def _bool_vector_norm(x: DNDarray, axis, keepdims: bool, ord) -> DNDarray:
    """``jnp.linalg.vector_norm`` of bools: the 2-norm in float64, the
    inf-norms as ``any``/``all``, order 0 refused, any other order the
    int64 count of true elements."""
    if ord == 0:
        raise ValueError("data type <class 'numpy.bool'> not inexact")
    inf = float("inf")
    if ord in (inf, -inf):
        def partial(t, axes, keep):
            fn = torch.amax if ord == inf else torch.amin
            return fn(t.to(torch.uint8), dim=axes, keepdim=keep)

        return _reduce_op(partial, x, axis=axis, keepdims=keepdims, combine="max" if ord == inf else "min",
                          finish=lambda s: s.to(torch.bool))
    count = _reduce_op(lambda t, axes, keep: torch.sum(t, dim=axes, keepdim=keep, dtype=torch.int64), x,
                       axis=axis, keepdims=keepdims)
    if ord != 2:
        return count
    return DNDarray(torch.sqrt(count.larray.to(torch.float64)), count.gshape, types.float64, count.split,
                    count.device, count.comm, count.lshape_map if count.split is not None else None)


def vector_norm(
    x: DNDarray,
    axis: Optional[Union[int, Tuple[int, ...]]] = None,
    keepdims: bool = False,
    ord: Union[int, float, None] = 2,
) -> DNDarray:
    """Vector norm over ``axis`` (every axis when None; reference:
    basics.py:1316). Over the split axis each rank reduces its shard and
    one ``allreduce`` combines the partials (a sum of powers, a max or a
    min)."""
    sanitize_in(x)
    ord = 2 if ord is None else ord
    src = x
    if types.heat_type_is_exact(x.dtype):
        src = x.astype(types.float32)
    elif x.dtype is types.bool:
        return _bool_vector_norm(x, axis, keepdims, ord)
    partial, combine, finish = _vector_norm_ops(ord)
    return _reduce_op(partial, src, axis=axis, keepdims=keepdims, combine=combine, finish=finish)


def matrix_norm(
    a: DNDarray,
    axis: Optional[Tuple[int, int]] = None,
    keepdims: bool = False,
    ord: Union[int, str, None] = None,
) -> DNDarray:
    """Matrix norm over the two axes ``axis`` (default the last two;
    reference: basics.py:1113). A split along one of them gathers the
    array first."""
    sanitize_in(a)
    if axis is None:
        if a.ndim < 2:
            raise ValueError("matrix_norm requires at least 2 dimensions")
        axis = (a.ndim - 2, a.ndim - 1)
    ax = sanitize_axis(a.shape, axis)
    if not isinstance(ax, tuple) or len(ax) != 2:
        raise ValueError("axis must be a 2-tuple")
    split = a.split if a.split is not None and a.split not in ax else None
    if split is not None and not keepdims:
        split = split - sum(1 for x in ax if x < split)
    if ord in (2, -2, "nuc"):
        _refuse_narrow(a.dtype, f"matrix_norm(ord={ord!r})")
    whole = a.is_distributed() and a.split in ax
    t = _float_of(_whole(a) if whole else a._balanced_larray(), a.dtype)
    result = _narrow_back(torch.linalg.matrix_norm(t, ord=ord if ord is not None else "fro", dim=ax,
                                                   keepdim=keepdims), a.dtype)
    gshape = tuple(1 if i in ax else s for i, s in enumerate(a.gshape)) if keepdims else tuple(
        s for i, s in enumerate(a.gshape) if i not in ax)
    return _out(result, gshape, split, a)


def norm(
    a: DNDarray,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
    ord: Union[int, float, str, None] = None,
    keepdim: bool = False,
    axis=None,
    keepdims=None,
) -> DNDarray:
    """Vector or matrix norm (reference: basics.py:1238), dispatched as
    ``heat_tpu`` does: no axis and no order is the 2-norm of every
    element."""
    sanitize_in(a)
    if axis is not None:
        dim = axis
    if keepdims is not None:
        keepdim = keepdims
    if dim is None and ord is None:
        return vector_norm(a, axis=None, keepdims=False)
    if isinstance(dim, tuple) and len(dim) == 2:
        return matrix_norm(a, axis=dim, keepdims=keepdim, ord=ord)
    if dim is None and a.ndim == 2 and ord is not None and ord not in (2, -2):
        return matrix_norm(a, keepdims=keepdim, ord=ord)
    return vector_norm(a, axis=dim, keepdims=keepdim, ord=2 if ord is None else ord)


DNDarray.transpose = transpose
DNDarray.T = property(lambda self: transpose(self, None))
DNDarray.__matmul__ = lambda self, other: matmul(self, other)
