"""Communicator of heat_tpu_torch, at world size 1.

Port of the single-device case of ``heat_tpu.core.communication``
(``MeshCommunication`` :290; Heat reference: heat/core/communication.py).
The port runs one process per device over ``torch.distributed``, like the
MPI ranks of the Heat reference. This slice serves world size 1 only: every
array lives whole on one device, ``split`` is a label, and the chunk
geometry is that of ``heat_tpu`` (ceil-division blocks, short or empty
tail), so it can be held against ``heat_tpu`` for any world size.

A process whose ``torch.distributed`` world has more than one rank gets a
``NotImplementedError``: multi-rank execution is ROADMAP.md Queue 1, item 5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "Communication",
    "MPI_WORLD",
    "TorchCommunication",
    "get_comm",
    "sanitize_comm",
    "use_comm",
]


class Communication:
    """Base class for communicators (reference: communication.py:83)."""

    @staticmethod
    def is_distributed() -> bool:
        raise NotImplementedError()

    def __init__(self) -> None:
        raise NotImplementedError()

    def chunk(self, shape, split) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        raise NotImplementedError()


def _world_size() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        size = torch.distributed.get_world_size()
        if size > 1:
            raise NotImplementedError(
                f"heat_tpu_torch runs at world size 1 so far; this process is one of "
                f"{size} torch.distributed ranks. Multi-rank execution (the distributed "
                "hsvd branch) is ROADMAP.md Queue 1, item 5."
            )
    return 1


class TorchCommunication(Communication):
    """World-size-1 communicator (counterpart of ``MeshCommunication``)."""

    def __init__(self) -> None:
        pass

    @property
    def size(self) -> int:
        """Number of ranks (1)."""
        return _world_size()

    @property
    def rank(self) -> int:
        """This process's rank (0)."""
        _world_size()
        return 0

    def is_distributed(self) -> bool:
        return self.size > 1

    def chunk(
        self, shape, split: Optional[int], rank: Optional[int] = None, w_size: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """The shard of ``shape`` along ``split`` owned by ``rank`` in a world
        of ``w_size`` ranks (default: this world). Ceil-division blocks, as
        ``heat_tpu`` places them. Returns (offset, local_shape, slices)."""
        shape = tuple(int(s) for s in shape)
        size = self.size if w_size is None else w_size
        if rank is None:
            rank = 0
        if split is None or size == 1:
            return 0, shape, tuple(slice(0, s) for s in shape)
        split = split % len(shape)
        n = shape[split]
        block = -(-n // size)
        start = min(rank * block, n)
        end = min(start + block, n)
        lshape = list(shape)
        lshape[split] = end - start
        slices = tuple(
            slice(start, end) if i == split else slice(0, s) for i, s in enumerate(shape)
        )
        return start, tuple(lshape), slices

    def counts_displs_shape(
        self, shape, split: int
    ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
        """Per-rank counts and displacements along ``split`` plus the local
        shape of rank 0 (reference: communication.py:215)."""
        shape = tuple(int(s) for s in shape)
        n = shape[split]
        size = self.size
        block = -(-n // size)
        counts = tuple(max(0, min(n - r * block, block)) for r in range(size))
        displs = tuple(min(r * block, n) for r in range(size))
        _, lshape, _ = self.chunk(shape, split)
        return counts, displs, lshape

    def __repr__(self) -> str:
        return "TorchCommunication(size=1)"


MPI_WORLD = TorchCommunication()
"""The world communicator."""

__default_comm: Communication = MPI_WORLD


def get_comm() -> Communication:
    """The globally set default communicator (reference: communication.py:2019)."""
    return __default_comm


def use_comm(comm: Optional[Communication] = None) -> None:
    """Set the globally used default communicator (reference: communication.py:2049)."""
    global __default_comm
    if comm is None:
        comm = MPI_WORLD
    if not isinstance(comm, Communication):
        raise TypeError(f"expected a Communication object, got {type(comm)}")
    __default_comm = comm


def sanitize_comm(comm: Optional[Communication]) -> Communication:
    """Sanitize a communicator or return the global default."""
    if comm is None:
        return get_comm()
    if not isinstance(comm, Communication):
        raise TypeError(f"expected a Communication object, got {type(comm)}")
    return comm
