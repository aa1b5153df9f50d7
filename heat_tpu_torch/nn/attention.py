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
  straddles them is an unmasked call and a causal one. The ring has no
  backward (ROADMAP.md Queue 1, item 19).
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
    """K9's forward under autograd. K9 has no backward kernel (``heat_tpu``
    differentiated its blocked program, never its kernels); the backward
    recomputes the attention with the plain version and differentiates
    that."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return katt.flash_attention(q, k, v, causal, scale)[0]

    @staticmethod
    def backward(ctx, grad):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = katt.flash_attention_plain(q, k, v, ctx.causal, ctx.scale)[0]
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
        return dq, dk, dv, None, None


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


def _ring(q: DNDarray, k: DNDarray, v: DNDarray, causal: bool, scale: float) -> torch.Tensor:
    """This rank's rows of the attention of q, k and v, each split along the
    sequence axis, through the ring (module docstring). ``attention_serviceable``
    decides up front: K9 on every step, or the plain version on every step
    (float64, complex, heads wider than 256)."""
    comm = q.comm
    p, r = comm.size, comm.rank
    dtype = q.larray.dtype if (q.larray.is_floating_point() or q.larray.is_complex()) else torch.float32
    ql, kl, vl = (t.larray.to(dtype) for t in (q, k, v))
    d, d_v = kl.shape[-1], vl.shape[-1]
    q_off = q.counts_displs()[1][r]
    k_counts, k_offs = k.counts_displs()
    # k and v rotate together: one buffer of the largest shard's rows
    buf = kl.new_zeros(kl.shape[:-2] + (max(k_counts), d + d_v))
    buf[..., : kl.shape[-2], :d] = kl
    buf[..., : kl.shape[-2], d:] = vl
    attend = katt.flash_attention if katt.attention_serviceable(dtype, d, d_v) else katt.flash_attention_plain
    acc = None
    for t in range(p):
        src = (r + t) % p
        for r0, k0, k1, masked in _decompose(ql.shape[-2], k_counts[src], q_off - k_offs[src], causal):
            o, lse = attend(ql[..., r0:, :], buf[..., k0:k1, :d], buf[..., k0:k1, d:], masked, scale)
            acc = _fold(acc, r0, o, lse)
        if t < p - 1:
            buf = comm.ring_exchange(buf, dst=(r - 1) % p, src=(r + 1) % p)
    if acc is None:
        return ql.new_zeros(ql.shape[:-1] + (d_v,))
    return acc[0].to(dtype)


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
    docstring); under autograd it raises ``NotImplementedError``.
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
        if torch.is_grad_enabled() and any(t.larray.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "the backward of ring_attention with q split across ranks (dK and dV rotated back): "
                "see ROADMAP.md Queue 1, item 19"
            )
        k, v = (t if t.split == seq_axis else t.resplit(seq_axis) for t in (k, v))
        out = _ring(q, k, v, bool(causal), float(scale))
        lmap = q.lshape_map
        lmap[:, -1] = out.shape[-1]
        return DNDarray(out, out_gshape, types.canonical_heat_type(out.dtype), seq_axis, q.device, comm, lmap)
    if comm.is_distributed():
        k, v = (t if t.split is None else t.resplit(None) for t in (k, v))  # q is whole on every rank: so are k and v
    out = _single_device_attention(q.larray, k.larray, v.larray, causal, scale)
    return DNDarray(out, out_gshape, types.canonical_heat_type(out.dtype), q.split, q.device, comm)


def ring_self_attention(x: DNDarray, causal: bool = False, scale: Optional[float] = None) -> DNDarray:
    """Self-attention convenience: q = k = v = x."""
    return ring_attention(x, x, x, causal=causal, scale=scale)
