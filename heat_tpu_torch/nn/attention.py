"""Exact attention for long contexts (port of ``heat_tpu.nn.attention``).

``ring_attention`` computes ``softmax(scale · q kᵀ [causal mask]) v`` on
DNDarrays whose sequence axis (-2) may be split. ``heat_tpu`` shards that
axis over its mesh and circulates K/V around a ring; at world size 1, or
with an unsplit q, it runs the single-device program. The port takes that
route in both cases (``_single_device_attention``): one launch of kernel K9
(``kernels.attention.flash_attention``) for float32 and bfloat16 operands
on a card, after gathering a split k or v onto every rank
(``resplit(None)``) when the world has more ranks. The distributed ring for
a split q (stationary Q, K/V rotated between ranks, K9's ``(o, lse)``
combined per step) is not ported yet (ROADMAP.md Queue 1, item 3).
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
    gathered first; a split q across ranks raises ``NotImplementedError``.
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
    if comm.is_distributed():
        if q.split is not None:
            raise NotImplementedError(
                "ring_attention with q split across ranks (K/V rotated between ranks, K9's (o, lse) combined "
                "per step) is not ported yet: see ROADMAP.md Queue 1, item 3"
            )
        k, v = k.resplit(None), v.resplit(None)  # q is whole on every rank: so are k and v then
    out = _single_device_attention(q.larray, k.larray, v.larray, causal, scale)
    return DNDarray(out, out_gshape, types.canonical_heat_type(out.dtype), q.split, q.device, comm)


def ring_self_attention(x: DNDarray, causal: bool = False, scale: Optional[float] = None) -> DNDarray:
    """Self-attention convenience: q = k = v = x."""
    return ring_attention(x, x, x, causal=causal, scale=scale)
