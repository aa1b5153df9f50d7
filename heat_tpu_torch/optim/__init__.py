"""Optimizer layer of heat_tpu_torch (port of ``heat_tpu.optim``).

``DataParallelOptimizer`` and ``DASO`` over ``nn.DataParallel`` models,
the local optimizers ``SGD``, ``Adam`` and ``AdamW`` (optax's updates),
the schedulers of ``lr_scheduler`` and ``DetectMetricPlateau``. As
``heat_tpu`` falls through to optax, the names it does not define come
from ``torch.optim``.
"""

from .dp_optimizer import SGD, Adam, AdamW, DataParallelOptimizer, DASO, LocalOptimizer
from .utils import DetectMetricPlateau
from . import lr_scheduler
from . import utils

__all__ = [
    "SGD",
    "Adam",
    "AdamW",
    "LocalOptimizer",
    "DataParallelOptimizer",
    "DASO",
    "DetectMetricPlateau",
    "lr_scheduler",
    "utils",
]


def __getattr__(name):
    import torch.optim as _optim

    try:
        return getattr(_optim, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.optim' has no attribute '{name}'")
