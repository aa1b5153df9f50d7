"""Functional neural-network ops (port of ``heat_tpu.nn.functional``).

The Heat reference's ``heat.nn.functional`` passes through to
``torch.nn.functional``; ``heat_tpu`` re-exports ``jax.nn`` under the torch
names. Here the activations are ``torch.nn.functional``'s, with
``jax.nn``'s defaults where they differ (``gelu`` is the tanh form,
``one_hot`` gives floats), and every name this module does not define
is ``torch.nn.functional``'s. ``linear`` keeps ``heat_tpu``'s
weight layout (in, out), and ``scaled_dot_product_attention`` runs the
port's attention (kernel K9 on a card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as _F

__all__ = [
    "avg_pool2d",
    "dropout",
    "elu",
    "gelu",
    "leaky_relu",
    "linear",
    "log_softmax",
    "max_pool2d",
    "one_hot",
    "relu",
    "scaled_dot_product_attention",
    "sigmoid",
    "softmax",
    "softplus",
    "tanh",
]

relu = _F.relu
sigmoid = torch.sigmoid
tanh = torch.tanh
softmax = _F.softmax
log_softmax = _F.log_softmax
softplus = _F.softplus
leaky_relu = _F.leaky_relu
elu = _F.elu


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh form by default (``heat_tpu``'s
    ``gelu``), the exact erf form with ``approximate=False``."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def one_hot(x, num_classes: int, dtype=torch.float64, axis: int = -1) -> torch.Tensor:
    """``jax.nn.one_hot``: float64 (``jnp.float_`` under ``heat_tpu``'s
    x64 policy) ones where ``x`` equals the class index; an index outside
    [0, num_classes) gives a row of zeros."""
    x = torch.as_tensor(x)
    hot = (x[..., None] == torch.arange(int(num_classes), device=x.device)).to(dtype)
    return hot.movedim(-1, axis)


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


def max_pool2d(x, kernel_size, stride=None):
    """``heat_tpu``'s ``max_pool2d`` over NCHW (``nn.MaxPool2d``)."""
    from .modules import MaxPool2d

    return MaxPool2d(kernel_size, stride)(x)


def avg_pool2d(x, kernel_size, stride=None):
    """``heat_tpu``'s ``avg_pool2d`` over NCHW (``nn.AvgPool2d``)."""
    from .modules import AvgPool2d

    return AvgPool2d(kernel_size, stride)(x)


def dropout(x, p: float = 0.5, training: bool = True, key=None):
    """``heat_tpu``'s ``dropout`` with an explicit Threefry key
    (``nn.Dropout``; kernel R1 draws the mask on a card)."""
    from .modules import Dropout

    return Dropout(p).train(training)(x, key=key)


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
