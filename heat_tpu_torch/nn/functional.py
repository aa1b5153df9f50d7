"""Functional neural-network ops (port of ``heat_tpu.nn.functional``).

The Heat reference's ``heat.nn.functional`` passes through to
``torch.nn.functional``; ``heat_tpu`` re-exports ``jax.nn`` under the torch
names. Here the activations are ``torch.nn.functional``'s own, and so is
every name this module does not define. ``linear`` keeps ``heat_tpu``'s
weight layout (in, out), and ``scaled_dot_product_attention`` runs the
port's attention (kernel K9 on a card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as _F

__all__ = [
    "elu",
    "gelu",
    "leaky_relu",
    "linear",
    "log_softmax",
    "one_hot",
    "relu",
    "scaled_dot_product_attention",
    "sigmoid",
    "softmax",
    "softplus",
    "tanh",
]

relu = _F.relu
gelu = _F.gelu
sigmoid = torch.sigmoid
tanh = torch.tanh
softmax = _F.softmax
log_softmax = _F.log_softmax
softplus = _F.softplus
leaky_relu = _F.leaky_relu
elu = _F.elu
one_hot = _F.one_hot


def scaled_dot_product_attention(query, key, value, attn_mask=None, is_causal=False, scale=None):
    """torch-parity ``scaled_dot_product_attention`` over the port's
    attention: DNDarray operands go through ``nn.attention.ring_attention``
    (raw tensors among them are lifted onto the DNDarray operand's
    communicator and device first, so the call takes one route); raw
    tensors go through the same single-device attention. ``attn_mask`` is
    not supported: use ``is_causal``."""
    from ..core import factories
    from ..core.dndarray import DNDarray
    from .attention import _single_device_attention, ring_attention

    if attn_mask is not None:
        raise NotImplementedError("attn_mask is not supported; use is_causal")
    ops = (query, key, value)
    if any(isinstance(t, DNDarray) for t in ops):
        ref = next(t for t in ops if isinstance(t, DNDarray))
        query, key, value = (
            t if isinstance(t, DNDarray) else factories.array(t, comm=ref.comm, device=ref.device) for t in ops
        )
        return ring_attention(query, key, value, causal=is_causal, scale=scale)
    return _single_device_attention(query, key, value, bool(is_causal), scale)


def linear(x, weight, bias=None):
    """y = x W (+ b) with the weight stored (in, out), as ``nn.Linear``."""
    y = x @ weight
    if bias is not None:
        y = y + bias
    return y


def __getattr__(name):
    """Every other name from ``torch.nn.functional`` (the Heat reference's
    own delegation)."""
    try:
        return getattr(_F, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.nn.functional' has no attribute '{name}'")
