"""Exact attention for long contexts (port of ``heat_tpu.nn.attention``).

``ring_attention`` computes ``softmax(scale · q kᵀ [causal mask]) v`` on
DNDarrays whose sequence axis (-2) may be split. ``heat_tpu`` shards that
axis over its mesh and circulates K/V around a ring; at world size 1, or
with an unsplit q, it runs the single-device program. The port does the
same:

* world size 1 or a whole q (``_single_device_attention``): one launch of
  kernel K9 (``kernels.attention.flash_attention``) for float32 and
  bfloat16 operands on a card, after gathering a split k or v onto every
  rank (``resplit(None)``) when the world has more ranks;
* q split across ranks (``_ring``): q stays in place, and k and v (split
  along the sequence axis first if they arrive whole) pass around the
  ring, packed into one buffer of ⌈S_kv/p⌉ rows a rank. At step t rank r
  holds the block of rank (r + t) mod p, which it passes to rank r − 1
  (``heat_tpu``'s ``perm = [((i + 1) % p, i)]``); the last rotation is
  skipped, so there are p − 1 hops. Each step runs K9 on the block's
  valid rows, and the steps' ``(o, lse)`` combine in float32
  (``combine_partials``). The causal mask is global (key j is visible to
  query i iff j ≤ i, in global positions), and ``_decompose`` serves a
  block at any offset with K9's top-left mask: a block wholly behind the
  queries is one unmasked call, one wholly ahead is skipped, and one that
  straddles them is an unmasked call and a causal one.

Both routes differentiate. At world size 1 the backward is
``kernels.attention.flash_attention_backward`` from the forward's saved
``(o, lse)``. The ring's backward (``_RingAttention``) is the forward ring
transposed: dQ stays with its rank, and the packed k/v buffer rotates as in
the forward with a dK/dV accumulator of the block's rows beside it, into
which each ``_decompose`` call of a step adds its share, computed from the
combined ``(o, lse)``; after the p − 1 hops one more hop carries each
accumulator home to the rank that owns the block (p collective-permutes). An
operand whose split differs from the route's is gathered (``_GatherRows``) or
cut to this rank's rows (``_ScatterRows``), each differentiable: a gradient
of a replicated tensor is whole on every rank, as under ``heat_tpu``'s single
controller.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..kernels import attention as katt

__all__ = ["ring_attention", "ring_self_attention"]


class _KernelAttention(torch.autograd.Function):
    """K9's forward under autograd, with ``flash_attention_backward`` from
    the saved ``(o, lse)`` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = katt.flash_attention(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return katt.flash_attention_backward(q, k, v, o, lse, do, ctx.causal, ctx.scale) + (None, None)


def _single_device_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale=None):
    """Attention on raw tensors (..., S, D), the one route behind
    ``ring_attention`` at world size 1 and ``scaled_dot_product_attention``
    on tensors (``heat_tpu``'s ``_single_device_attention``, ``:754``):
    non-inexact dtypes promote to float32 and all three operands take q's
    dtype; the default scale is 1/sqrt(D); leading dims broadcast.
    ``attention_serviceable`` decides up front: float32 and bfloat16 with
    head dims ≤ 256 go through ``flash_attention`` (K9 on a card, one
    launch), the rest through the plain version on any device."""
    dtype = q.dtype if (q.is_floating_point() or q.is_complex()) else torch.float32
    q, k, v = (t.to(dtype) for t in (q, k, v))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    lead = torch.broadcast_shapes(q.shape[:-2], k.shape[:-2], v.shape[:-2])
    q, k, v = (t.expand(lead + tuple(t.shape[-2:])) for t in (q, k, v))
    if not katt.attention_serviceable(dtype, q.shape[-1], v.shape[-1]):
        return katt.flash_attention_plain(q, k, v, bool(causal), float(scale))[0]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _KernelAttention.apply(q, k, v, bool(causal), float(scale))
    return katt.flash_attention(q, k, v, bool(causal), float(scale))[0]


def _decompose(bq: int, bk: int, delta: int, causal: bool):
    """The K9 calls that give a block of ``bq`` queries its attention over
    a block of ``bk`` keys whose global offset lies ``delta`` below the
    queries' (query i sees key j iff j ≤ i + delta when ``causal``), as
    ``(first query, first key, end key, causal)`` each: one unmasked call
    for a block wholly visible, none for a block wholly masked, else an
    unmasked call on the keys every query sees and a causal call whose
    top-left mask is exact on the rest. Queries before the first of a call
    see no key of it."""
    if bq == 0 or bk == 0 or (causal and delta <= -bq):
        return []
    if not causal or delta >= bk:
        return [(0, 0, bk, False)]
    if delta < 0:
        return [(-delta, 0, bk, True)]
    return ([(0, 0, delta, False)] if delta else []) + [(0, delta, min(delta + bq, bk), True)]


def _fold(acc, r0: int, o: torch.Tensor, lse: torch.Tensor):
    """``acc`` (o in the combine's dtype, lse over every query row; None
    before the first call) with the partial ``(o, lse)`` of rows ``r0:``
    folded in through ``combine_partials``. The first partial is taken
    as it is."""
    if acc is None and r0 == 0:
        return o.to(katt._compute_dtype(o.dtype)), lse
    if acc is None:
        lead, s_q = o.shape[:-2], r0 + o.shape[-2]
        acc_o = o.new_zeros(lead + (s_q, o.shape[-1]), dtype=katt._compute_dtype(o.dtype))
        acc_lse = lse.new_full(lead + (s_q,), -math.inf)
        acc_o[..., r0:, :], acc_lse[..., r0:] = o, lse
        return acc_o, acc_lse
    acc_o, acc_lse = acc
    acc_o[..., r0:, :], acc_lse[..., r0:] = katt.combine_partials(acc_o[..., r0:, :], acc_lse[..., r0:], o, lse)
    return acc_o, acc_lse


def _ring_forward(comm, ql, kl, vl, q_off: int, k_counts, k_offs, causal: bool, scale: float):
    """This rank's ``(o, lse)`` of the attention of its q rows ``ql`` (at
    global row ``q_off``) over k and v split along the sequence axis as
    ``k_counts``/``k_offs``, through the ring (module docstring); o in
    ``ql``'s dtype, lse in the combine's. ``attention_serviceable`` decides
    up front: K9 on every step, or the plain version on every step
    (float64, complex, heads wider than 256)."""
    p, r = comm.size, comm.rank
    d, d_v = kl.shape[-1], vl.shape[-1]
    # k and v rotate together: one buffer of the largest shard's rows
    buf = kl.new_zeros(kl.shape[:-2] + (max(k_counts), d + d_v))
    buf[..., : kl.shape[-2], :d] = kl
    buf[..., : kl.shape[-2], d:] = vl
    attend = katt.flash_attention if katt.attention_serviceable(ql.dtype, d, d_v) else katt.flash_attention_plain
    acc = None
    for t in range(p):
        src = (r + t) % p
        for r0, k0, k1, masked in _decompose(ql.shape[-2], k_counts[src], q_off - k_offs[src], causal):
            o, lse = attend(ql[..., r0:, :], buf[..., k0:k1, :d], buf[..., k0:k1, d:], masked, scale)
            acc = _fold(acc, r0, o, lse)
        if t < p - 1:
            buf = comm.ring_exchange(buf, dst=(r - 1) % p, src=(r + 1) % p)
    if acc is None:
        ct = katt._compute_dtype(ql.dtype)
        lse = torch.full(ql.shape[:-1], -math.inf, dtype=torch.empty((), dtype=ct).real.dtype, device=ql.device)
        return ql.new_zeros(ql.shape[:-1] + (d_v,)), lse
    return acc[0].to(ql.dtype), acc[1]


def _ring_backward(comm, ql, kl, vl, o, lse, do, q_off: int, k_counts, k_offs, causal: bool, scale: float):
    """``(dq, dk, dv)`` of this rank's shards for the gradient ``do`` of its
    rows of ``_ring_forward``'s o: the forward ring transposed (module
    docstring), every share from ``flash_attention_backward`` in the compute
    dtype, in which the buffer of k, v and the dK/dV accumulator travels."""
    p, r = comm.size, comm.rank
    d, d_v = kl.shape[-1], vl.shape[-1]
    ct = katt._compute_dtype(ql.dtype)
    buf = kl.new_zeros(kl.shape[:-2] + (max(k_counts), 2 * (d + d_v)), dtype=ct)
    buf[..., : kl.shape[-2], :d] = kl
    buf[..., : kl.shape[-2], d : d + d_v] = vl
    dq = torch.zeros(ql.shape, dtype=ct, device=ql.device)
    for t in range(p):
        src = (r + t) % p
        for r0, k0, k1, masked in _decompose(ql.shape[-2], k_counts[src], q_off - k_offs[src], causal):
            dq_c, dk_c, dv_c = katt.flash_attention_backward(
                ql[..., r0:, :], buf[..., k0:k1, :d], buf[..., k0:k1, d : d + d_v],
                o[..., r0:, :], lse[..., r0:], do[..., r0:, :], masked, scale,
            )
            dq[..., r0:, :] += dq_c
            buf[..., k0:k1, d + d_v : 2 * d + d_v] += dk_c
            buf[..., k0:k1, 2 * d + d_v :] += dv_c
        # p − 1 hops of the whole buffer, then one of the accumulator, home
        send = buf if t < p - 1 else buf[..., d + d_v :].contiguous()
        buf = comm.ring_exchange(send, dst=(r - 1) % p, src=(r + 1) % p)
    rows = kl.shape[-2]
    return dq.to(ql.dtype), buf[..., :rows, :d].to(kl.dtype), buf[..., :rows, d:].to(vl.dtype)


class _RingAttention(torch.autograd.Function):
    """``_ring_forward``'s o, with ``_ring_backward`` as its backward."""

    @staticmethod
    def forward(ctx, ql, kl, vl, comm, q_off, k_counts, k_offs, causal, scale):
        o, lse = _ring_forward(comm, ql, kl, vl, q_off, k_counts, k_offs, causal, scale)
        ctx.save_for_backward(ql, kl, vl, o, lse)
        ctx.args = (comm, q_off, k_counts, k_offs, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        comm, q_off, k_counts, k_offs, causal, scale = ctx.args
        ql, kl, vl, o, lse = ctx.saved_tensors
        grads = _ring_backward(comm, ql, kl, vl, o, lse, do, q_off, k_counts, k_offs, causal, scale)
        return grads + (None,) * 6


class _GatherRows(torch.autograd.Function):
    """The whole of a tensor split along ``axis`` as ``counts``, on every
    rank (one all-gather); the backward keeps this rank's rows of the
    gradient, which every rank holds whole."""

    @staticmethod
    def forward(ctx, t, comm, axis, counts):
        ctx.args = (comm.rank, axis, counts)
        return comm.allgather(t, axis, counts)

    @staticmethod
    def backward(ctx, g):
        rank, axis, counts = ctx.args
        return g.narrow(axis, sum(counts[:rank]), counts[rank]), None, None, None


class _ScatterRows(torch.autograd.Function):
    """This rank's rows along ``axis`` (as ``counts``) of a tensor whole on
    every rank; the backward gathers the rows' gradients into the whole
    one on every rank (one all-gather)."""

    @staticmethod
    def forward(ctx, t, comm, axis, counts):
        ctx.args = (comm, axis, counts)
        return t.narrow(axis, sum(counts[: comm.rank]), counts[comm.rank]).clone()

    @staticmethod
    def backward(ctx, g):
        comm, axis, counts = ctx.args
        return comm.allgather(g.contiguous(), axis, counts), None, None, None


def ring_attention(
    q: DNDarray,
    k: DNDarray,
    v: DNDarray,
    causal: bool = False,
    scale: Optional[float] = None,
) -> DNDarray:
    """Exact scaled-dot-product attention with the sequence axis (-2)
    split over the ranks (sequence parallelism for long contexts).

    ``q``/``k``/``v``: (..., S, D) DNDarrays, split along the S axis or
    not. The output has q's split and the global shape
    ``q.gshape[:-1] + (v.gshape[-1],)``. At world size 1, or with an
    unsplit q at any world size (``heat_tpu``'s rule, ``nn/attention.py:817``),
    this is one single-device attention on every rank, a split k or v
    gathered first. A split q across ranks runs the ring (module
    docstring), whole k or v cut to this rank's rows first. Every route
    differentiates (module docstring).
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, DNDarray):
            raise TypeError(f"{name} must be a DNDarray, got {type(t)}")
        if t.ndim < 2:
            raise ValueError(f"{name} needs at least (S, D) dims, got {t.ndim}")
    seq_axis = q.ndim - 2
    if q.split not in (None, seq_axis) or k.split not in (None, seq_axis) or v.split not in (None, seq_axis):
        raise ValueError(
            f"ring_attention shards the sequence axis ({seq_axis}); got splits "
            f"{q.split}/{k.split}/{v.split} — resplit the operands first"
        )
    if k.shape[:-1] != v.shape[:-1]:
        raise ValueError(f"k and v must agree on batch/sequence dims, got {k.shape} vs {v.shape}")
    if q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q and k head dims must agree, got {q.shape[-1]} vs {k.shape[-1]}")
    if q.gshape[:-2] != k.gshape[:-2]:
        raise ValueError(f"q and k batch dims must agree, got {q.gshape[:-2]} vs {k.gshape[:-2]}")
    out_gshape = q.gshape[:-1] + (v.gshape[-1],)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])

    comm = q.comm
    if q.is_distributed():
        dtype = q.larray.dtype if (q.larray.is_floating_point() or q.larray.is_complex()) else torch.float32
        split_kv = [t for t in (k, v) if t.split == seq_axis]
        counts = split_kv[0].counts_displs()[0] if split_kv else comm.counts_displs_shape(k.gshape, seq_axis)[0]
        kl, vl = (t.larray.to(dtype) if t.split == seq_axis
                  else _ScatterRows.apply(t.larray.to(dtype), comm, seq_axis, counts) for t in (k, v))
        offs = tuple(sum(counts[:i]) for i in range(comm.size))
        out = _RingAttention.apply(q.larray.to(dtype), kl, vl, comm, q.counts_displs()[1][comm.rank], counts, offs,
                                   bool(causal), float(scale))
        lmap = q.lshape_map
        lmap[:, -1] = out.shape[-1]
        return DNDarray(out, out_gshape, types.canonical_heat_type(out.dtype), seq_axis, q.device, comm, lmap)
    kl, vl = (t.larray if t.split is None or not comm.is_distributed()
              else _GatherRows.apply(t.larray, comm, seq_axis, t.counts_displs()[0]) for t in (k, v))
    out = _single_device_attention(q.larray, kl, vl, causal, scale)
    return DNDarray(out, out_gshape, types.canonical_heat_type(out.dtype), q.split, q.device, comm)


def ring_self_attention(x: DNDarray, causal: bool = False, scale: Optional[float] = None) -> DNDarray:
    """Self-attention convenience: q = k = v = x."""
    return ring_attention(x, x, x, causal=causal, scale=scale)
