"""Device abstraction for heat_tpu_torch.

Port of ``heat_tpu.core.devices`` (Heat reference: heat/core/devices.py,
``Device`` at :17, ``get_device``/``sanitize_device``/``use_device`` at
:137-190). A ``Device`` names a platform and carries the ``torch.device``
its tensors live on.

The default device is the GPU: a factory or entry point called without
``device=`` puts its tensors on ``cuda``. Where CUDA is missing, asking for
the GPU's ``torch.device`` raises instead of carrying on on the CPU. The
CPU is used only when the caller asks for it (``use_device("cpu")`` or
``device="cpu"``), as the tests do.

Dtype policy: the port follows ``heat_tpu``'s cpu/gpu world
(``heat_tpu/core/devices.py:148``): native float64, int64 and complex.
``heat_tpu``'s x64 switch and its complex platform policy exist for the
TPU; they have no counterpart here.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

__all__ = ["Device", "cpu", "get_device", "gpu", "sanitize_device", "use_device", "use_x64"]


class Device:
    """A platform on which heat_tpu_torch arrays live.

    Parameters
    ----------
    device_type : str
        ``'cpu'`` or ``'gpu'``.
    device_id : int
        Index of the device of that platform.
    """

    def __init__(self, device_type: str, device_id: int = 0):
        self.__device_type = str(device_type)
        self.__device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return self.__device_type

    @property
    def device_id(self) -> int:
        return self.__device_id

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this device. Raises for the GPU when
        CUDA is not available: nothing falls back to the CPU."""
        if self.__device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self} needs CUDA, which is not available here; "
                "ask for the CPU explicitly with ht.use_device('cpu') or device='cpu'"
            )
        return torch.device("cuda", self.__device_id)

    def __repr__(self) -> str:
        return f"device({str(self)!r})"

    def __str__(self) -> str:
        return f"{self.__device_type}:{self.__device_id}"

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Device):
            return self.device_type == other.device_type and self.device_id == other.device_id
        if isinstance(other, str):
            try:
                return self == sanitize_device(other)
            except ValueError:
                return False
        return NotImplemented

    def __hash__(self):
        return hash(str(self))


cpu = Device("cpu", 0)
"""The CPU."""

gpu = Device("gpu", 0)
"""This process's CUDA device: the first, or the one ``init_distributed``
binds to its rank."""

_registry = {"cpu": cpu, "gpu": gpu, "cuda": gpu}
__default_device: Device = gpu


def get_device() -> Device:
    """The currently globally set default device (reference: devices.py:137)."""
    return __default_device


def sanitize_device(device: Optional[Union[str, Device, torch.device]]) -> Device:
    """Sanitize a device or device identifier (reference: devices.py:149).
    ``None`` gives the default device."""
    if device is None:
        return get_device()
    if isinstance(device, Device):
        return device
    if isinstance(device, torch.device):
        device = str(device)
    if isinstance(device, str):
        name, _, idx = device.strip().lower().partition(":")
        if name in _registry:
            if not idx:
                return _registry[name]
            try:
                index = int(idx)
            except ValueError:
                raise ValueError(f"unknown device {device}")
            base = _registry[name]
            return base if index == base.device_id else Device(base.device_type, index)
    raise ValueError(f"unknown device {device}")


def use_device(device: Optional[Union[str, Device]] = None) -> None:
    """Set the globally used default device (reference: devices.py:171)."""
    global __default_device
    __default_device = sanitize_device(device)


def _bind_gpu(index: int) -> None:
    """Point ``gpu`` at ``cuda:index``, in place, so that every reference
    to it (``ht.gpu``, the default device) follows: one card per rank."""
    Device.__init__(gpu, "gpu", index)


def use_x64(flag: Optional[bool] = None) -> bool:
    """``heat_tpu``'s 64-bit switch (devices.py:113), whose policy here is
    fixed on: float64, int64 and complex128 are native on a card and on the
    CPU. A query and ``use_x64(True)`` return True; ``use_x64(False)``,
    which in ``heat_tpu`` degrades 64-bit types to 32 bits on a TPU, raises
    ``ValueError``."""
    if flag is not None and not flag:
        raise ValueError("use_x64(False): heat_tpu_torch keeps native 64-bit types on every device")
    return True
