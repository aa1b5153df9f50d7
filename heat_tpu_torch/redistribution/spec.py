"""Normalized redistribution problem statement, the planner's cache key
(a copy of ``heat_tpu.redistribution.spec``).

Every split change (``resplit``/``resplit_`` and the
``reshape(..., new_split=)`` repartition) is first normalized to one
:class:`RedistSpec`: global shape, dtype, source and destination split,
world size (``mesh_size``, ``heat_tpu``'s name for it) and, for the
reshape repartition, the target shape. The spec holds no values and no
communicator: two calls that ask for the same movement give the same
spec, and so the same plan.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from typing import Optional, Tuple

__all__ = ["RedistSpec"]


#: bytes of the types numpy names only through an extension package
_EXTRA_ITEMSIZE = {"bfloat16": 2}


def _dtype_name(dtype) -> str:
    """The numpy name of ``dtype``; ``"bfloat16"`` stays as it is."""
    if isinstance(dtype, str) and dtype in _EXTRA_ITEMSIZE:
        return dtype
    return np.dtype(dtype).name


def _prod(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


@dataclasses.dataclass(frozen=True)
class RedistSpec:
    """One redistribution problem, normalized and hashable.

    Attributes
    ----------
    gshape : global (logical) shape of the source array.
    dtype : canonical numpy dtype name of the physical array.
    src_split / dst_split : heat split axes (already modded into range),
        ``None`` for replicated.
    mesh_size : number of shards on the 1-D mesh axis.
    reshape_to : target global shape when the movement is a
        reshape-with-repartition (``dst_split`` then indexes this shape);
        ``None`` for a pure resplit.
    """

    gshape: Tuple[int, ...]
    dtype: str
    src_split: Optional[int]
    dst_split: Optional[int]
    mesh_size: int
    reshape_to: Optional[Tuple[int, ...]] = None

    # ------------------------------------------------------------------ #
    # construction                                                       #
    # ------------------------------------------------------------------ #
    @classmethod
    def normalize(
        cls,
        gshape,
        dtype,
        src_split: Optional[int],
        dst_split: Optional[int],
        mesh_size: int,
        reshape_to=None,
    ) -> "RedistSpec":
        """Build a spec with axes modded into range and types canonical."""
        gshape = tuple(int(s) for s in gshape)
        out_shape = None if reshape_to is None else tuple(int(s) for s in reshape_to)
        if out_shape is not None and _prod(out_shape) != _prod(gshape):
            raise ValueError(
                f"cannot redistribute-reshape {gshape} into {out_shape}: sizes differ"
            )
        ndim_src = max(len(gshape), 1)
        ndim_dst = max(len(out_shape if out_shape is not None else gshape), 1)
        if src_split is not None:
            src_split = int(src_split) % ndim_src
        if dst_split is not None:
            dst_split = int(dst_split) % ndim_dst
        return cls(
            gshape=gshape,
            dtype=_dtype_name(dtype),
            src_split=src_split,
            dst_split=dst_split,
            mesh_size=int(mesh_size),
            reshape_to=out_shape,
        )

    # ------------------------------------------------------------------ #
    # derived geometry                                                   #
    # ------------------------------------------------------------------ #
    @property
    def out_shape(self) -> Tuple[int, ...]:
        return self.reshape_to if self.reshape_to is not None else self.gshape

    @property
    def is_reshape(self) -> bool:
        return self.reshape_to is not None

    @property
    def itemsize(self) -> int:
        return _EXTRA_ITEMSIZE.get(self.dtype) or np.dtype(self.dtype).itemsize

    @property
    def size(self) -> int:
        return _prod(self.gshape)

    @property
    def logical_bytes(self) -> int:
        """Bytes of the whole logical array."""
        return self.size * self.itemsize

    @property
    def dst_shard_bytes(self) -> int:
        """Per-device bytes of one (padded) shard of the destination."""
        from ..core import _padding

        if self.dst_split is None or self.mesh_size <= 1:
            return self.logical_bytes
        phys = _padding.phys_shape(self.out_shape, self.dst_split, self.mesh_size)
        return _prod(phys) * self.itemsize // self.mesh_size

    @property
    def src_shard_bytes(self) -> int:
        """Per-device bytes of one (padded) shard of the SOURCE — with
        :attr:`dst_shard_bytes` the resident baseline a redistribution
        holds live on top of every step's transient (the liveness
        account ``Schedule.liveness`` exposes)."""
        from ..core import _padding

        if self.src_split is None or self.mesh_size <= 1:
            return self.logical_bytes
        phys = _padding.phys_shape(self.gshape, self.src_split, self.mesh_size)
        return _prod(phys) * self.itemsize // self.mesh_size

    def as_dict(self) -> dict:
        return {
            "gshape": list(self.gshape),
            "dtype": self.dtype,
            "src_split": self.src_split,
            "dst_split": self.dst_split,
            "mesh_size": self.mesh_size,
            "reshape_to": None if self.reshape_to is None else list(self.reshape_to),
        }

    def __repr__(self) -> str:
        move = f"split {self.src_split}->{self.dst_split}"
        shape = f"{self.gshape}"
        if self.is_reshape:
            shape += f"->{self.reshape_to}"
        return f"RedistSpec({shape} {self.dtype}, {move}, p={self.mesh_size})"
