"""Deep-learning layer of heat_tpu_torch (port of ``heat_tpu.nn``).

Every name of ``heat_tpu.nn``: the layers and losses of ``modules.py``
(``torch.nn.Module``s drawn from ``heat_tpu``'s Threefry keys),
``DataParallel`` and ``DataParallelMultiGPU``, ``functional``, and the
long-context attention (``ring_attention``, ``ring_self_attention``,
``functional.scaled_dot_product_attention``) on kernel K9. As in the Heat
reference (``heat/nn/__init__.py``), every other name comes from
``torch.nn``.
"""

from . import attention
from . import functional
from . import functional as F
from .attention import ring_attention, ring_self_attention
from .data_parallel import DataParallel, DataParallelMultiGPU
from .modules import (
    AvgPool2d,
    Conv2d,
    CrossEntropyLoss,
    Dropout,
    Dropout2d,
    Embedding,
    Flatten,
    GELU,
    LayerNorm,
    Linear,
    LogSoftmax,
    MaxPool2d,
    Module,
    MSELoss,
    MultiheadAttention,
    NLLLoss,
    ReLU,
    Sequential,
    Sigmoid,
    Softmax,
    Tanh,
)

__all__ = [
    "Module",
    "Linear",
    "MultiheadAttention",
    "ReLU",
    "GELU",
    "Tanh",
    "Sigmoid",
    "LogSoftmax",
    "Softmax",
    "Flatten",
    "Dropout",
    "Dropout2d",
    "Conv2d",
    "MaxPool2d",
    "AvgPool2d",
    "LayerNorm",
    "Embedding",
    "Sequential",
    "MSELoss",
    "NLLLoss",
    "CrossEntropyLoss",
    "DataParallel",
    "DataParallelMultiGPU",
    "functional",
    "F",
    "ring_attention",
    "ring_self_attention",
]


def __getattr__(name):
    """Delegate the names ``heat_tpu.nn`` does not define to ``torch.nn``
    (the Heat reference's fallback, ``nn/__init__.py:19-47``)."""
    import torch.nn as _nn

    try:
        return getattr(_nn, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.nn' has no attribute '{name}'")
