"""Deep-learning layer of heat_tpu_torch (port of ``heat_tpu.nn``).

Long-context attention (``ring_attention``, ``ring_self_attention``,
``functional.scaled_dot_product_attention``) on kernel K9, and the modules
that build a transformer block around it (``Linear``,
``MultiheadAttention``, ``LayerNorm``, ``Embedding``). As in the Heat
reference (``heat/nn/__init__.py``), every other name comes from
``torch.nn``.
"""

from . import attention
from . import functional
from . import functional as F
from .attention import ring_attention, ring_self_attention
from .modules import Embedding, LayerNorm, Linear, MultiheadAttention

__all__ = [
    "Embedding",
    "F",
    "LayerNorm",
    "Linear",
    "MultiheadAttention",
    "functional",
    "ring_attention",
    "ring_self_attention",
]


def __getattr__(name):
    """Delegate unknown layer names to ``torch.nn`` (the Heat reference's
    fallback, ``nn/__init__.py:19-47``)."""
    import torch.nn as _nn

    try:
        return getattr(_nn, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.nn' has no attribute '{name}'")
