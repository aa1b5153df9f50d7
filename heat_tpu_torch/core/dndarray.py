"""The distributed n-dimensional array of heat_tpu_torch.

Port of ``heat_tpu.core.dndarray`` (Heat reference: heat/core/dndarray.py,
class ``DNDarray`` at :38). As in the Heat reference, a ``DNDarray`` wraps
the process-local ``torch.Tensor`` plus its global metadata: shape,
``split`` axis, heat type, device and communicator. At world size 1 the
local tensor is the whole array, so ``split`` is a label and ``resplit`` a
relabel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import types
from .communication import Communication
from .devices import Device
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray"]


class DNDarray:
    """Distributed n-dimensional array.

    Parameters
    ----------
    array : torch.Tensor
        The process-local data (the whole array at world size 1).
    gshape : tuple of int
        Global shape.
    dtype : datatype
        heat_tpu_torch type.
    split : int or None
        Axis the array is distributed along, or None.
    device : Device
        Platform the array resides on.
    comm : Communication
        Communicator.
    """

    def __init__(
        self,
        array: torch.Tensor,
        gshape: Tuple[int, ...],
        dtype: type,
        split: Optional[int],
        device: Device,
        comm: Communication,
    ):
        self.__array = array
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = types.canonical_heat_type(dtype)
        self.__split = split if split is None else int(split) % max(len(self.__gshape), 1)
        self.__device = device
        self.__comm = comm

    # ------------------------------------------------------------------ #
    # properties                                                         #
    # ------------------------------------------------------------------ #
    @property
    def comm(self) -> Communication:
        return self.__comm

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def dtype(self):
        return self.__dtype

    @property
    def gshape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def larray(self) -> torch.Tensor:
        """The process-local tensor (reference dndarray.py:139)."""
        return self.__array

    @larray.setter
    def larray(self, array: torch.Tensor) -> None:
        """Rebind the data to a LOGICAL tensor; shape and type follow it
        (reference dndarray.py:150)."""
        self.__array = array
        self.__gshape = tuple(int(s) for s in array.shape)
        self.__dtype = types.canonical_heat_type(array.dtype)
        if self.__split is not None and self.__split >= len(self.__gshape):
            self.__split = None

    @property
    def lshape(self) -> Tuple[int, ...]:
        """Shape of this process's shard (reference dndarray.py:295)."""
        _, lshape, _ = self.__comm.chunk(self.__gshape, self.__split)
        return lshape

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape)) if self.__gshape else 1

    @property
    def nbytes(self) -> int:
        """Total bytes of the global array (reference dndarray.py:176)."""
        return self.size * self.__array.element_size()

    # ------------------------------------------------------------------ #
    # conversions / data access                                          #
    # ------------------------------------------------------------------ #
    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """Cast to ``dtype`` (reference dndarray.py:456)."""
        dtype = types.canonical_heat_type(dtype)
        casted = self.__array.to(dtype.torch_type())
        if not copy:
            self.__array = casted
            self.__dtype = dtype
            return self
        if casted is self.__array:
            casted = casted.clone()
        return DNDarray(casted, self.__gshape, dtype, self.__split, self.__device, self.__comm)

    def numpy(self) -> np.ndarray:
        """The global array as numpy (reference dndarray.py:1168). bfloat16
        comes back as float32, which numpy can hold."""
        arr = self.__array.detach()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        return arr.cpu().numpy()

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)

    def item(self):
        """The single element as a Python scalar (reference dndarray.py:1143)."""
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to Python scalars")
        return self.__array.reshape(()).item()

    def __float__(self) -> float:
        return float(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.__gshape[0]

    # ------------------------------------------------------------------ #
    # distribution management                                            #
    # ------------------------------------------------------------------ #
    def is_distributed(self) -> bool:
        """True if the data live on more than one device (reference
        dndarray.py:480)."""
        return self.__split is not None and self.__comm.is_distributed()

    def resplit_(self, axis: Optional[int] = None) -> "DNDarray":
        """In-place redistribution along a new split axis (reference
        dndarray.py:1406). At world size 1 no data move: a relabel."""
        self.__split = self.__resplit_axis(axis)
        return self

    def resplit(self, axis: Optional[int] = None) -> "DNDarray":
        """Out-of-place resplit, sharing the data (reference
        manipulations.py:3479). At world size 1 a relabel."""
        axis = self.__resplit_axis(axis)
        return DNDarray(self.__array, self.__gshape, self.__dtype, axis, self.__device, self.__comm)

    def __resplit_axis(self, axis: Optional[int]) -> Optional[int]:
        axis = sanitize_axis(self.__gshape, axis)
        if axis != self.__split and self.__comm.is_distributed():
            raise NotImplementedError("resplit across ranks: see ROADMAP.md, Queue 1")
        return axis

    # ------------------------------------------------------------------ #
    # misc protocol                                                      #
    # ------------------------------------------------------------------ #
    def __repr__(self) -> str:
        body = (
            np.array2string(self.numpy(), separator=", ")
            if self.size <= 100
            else f"<{'x'.join(str(s) for s in self.__gshape)} values>"
        )
        return (
            f"DNDarray({body}, dtype=ht.{self.__dtype.__name__}, "
            f"device={self.__device}, split={self.__split})"
        )

    __str__ = __repr__
