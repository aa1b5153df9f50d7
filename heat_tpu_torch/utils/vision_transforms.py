"""Vision transforms (port of ``heat_tpu.utils.vision_transforms``).

The Heat reference delegates to ``torchvision.transforms``; ``heat_tpu``
serves the transforms its MNIST example uses (``ToTensor``, ``Normalize``,
``Compose``) as small numpy callables, and the port keeps them so, with
the same results; any other name raises ``AttributeError``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Compose", "Normalize", "ToTensor"]


class Compose:
    """Chain transforms (torchvision.transforms.Compose semantics)."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class ToTensor:
    """uint8 HWC/HW image(s) → float32 in [0, 1] (torchvision semantics;
    channel reordering is a no-op for MNIST's single channel)."""

    def __call__(self, x):
        x = np.asarray(x)
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        return x.astype(np.float32)


class Normalize:
    """(x - mean) / std per channel (torchvision.transforms.Normalize)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, x):
        return (np.asarray(x, dtype=np.float32) - self.mean) / self.std


def __getattr__(name):
    raise AttributeError(
        f"vision transform '{name}' is not implemented (the reference delegates to "
        f"torchvision, which is not available in this stack); available: {__all__}"
    )
