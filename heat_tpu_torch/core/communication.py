"""Communicator of heat_tpu_torch over ``torch.distributed``.

Port of ``heat_tpu.core.communication`` (``MeshCommunication`` :290;
Heat reference: heat/core/communication.py). ``heat_tpu`` is one
controller over a mesh of devices; the port runs one process per device,
like the MPI ranks of the Heat reference. Rank and size come from the
``torch.distributed`` default group (NCCL on cards, gloo on the CPU); a
process that never joined one is a world of size 1. ``init_distributed``
joins it.

The chunk geometry is ``heat_tpu``'s for every world size: ceil-division
blocks along the split axis with a short or empty tail, so rank r holds
exactly the shard that ``heat_tpu`` places on device r.

The collectives are thin wrappers that count their calls in
``TorchCommunication.counts`` (the counterpart of ``heat_tpu``'s
collective census of a compiled program), keyed by the names of
``redistribution.schedule.COLLECTIVE_STEP_KINDS``. Every wrapper but
``allreduce`` moves bytes, never values: it sends a ``uint8`` view of its
tensor, so every dtype (bool, bfloat16, complex) crosses bit for bit,
whatever the backend supports.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Communication",
    "MPICommunication",
    "MPI_SELF",
    "MPI_WORLD",
    "TorchCommunication",
    "get_comm",
    "init_distributed",
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


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The contiguous flat ``uint8`` view of ``t`` (a copy where its
    elements are not adjacent; ``contiguous`` keeps the stride of a
    one-element view, such as the real part of a complex diagonal)."""
    flat = t.reshape(-1)
    if not flat.numel():  # an empty view may carry any stride
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    if flat.stride(0) != 1:
        flat = flat.new_empty(flat.shape).copy_(flat)
    return flat.view(torch.uint8)


def _from_bytes(buf: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return buf.view(dtype).reshape(tuple(shape))


class TorchCommunication(Communication):
    """The world communicator (counterpart of ``MeshCommunication``).

    ``counts`` maps a collective's name (``"all-to-all"``, ``"all-gather"``,
    ``"collective-permute"``, ``"all-reduce"``, ``"broadcast"``) to the
    calls issued since it was last cleared; ``staged_bytes`` the bytes
    ``ring_exchange`` and ``permute`` staged through host memory since it
    was last set to 0."""

    def __init__(self) -> None:
        self.counts: Dict[str, int] = {}
        self.staged_bytes = 0
        self._groups: Dict[Tuple[int, int], tuple] = {}

    @property
    def size(self) -> int:
        """Number of ranks."""
        return dist.get_world_size() if _joined() else 1

    @property
    def rank(self) -> int:
        """This process's rank."""
        return dist.get_rank() if _joined() else 0

    def is_distributed(self) -> bool:
        return self.size > 1

    # ------------------------------------------------------------------ #
    # chunk geometry                                                     #
    # ------------------------------------------------------------------ #
    def chunk(
        self, shape, split: Optional[int], rank: Optional[int] = None, w_size: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """The shard of ``shape`` along ``split`` owned by ``rank`` (default:
        this rank) in a world of ``w_size`` ranks (default: this world).
        Ceil-division blocks, as ``heat_tpu`` places them (reference
        :382). Returns (offset, local_shape, slices)."""
        shape = tuple(int(s) for s in shape)
        size = self.size if w_size is None else w_size
        if rank is None:
            rank = self.rank
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
        """Per-rank counts and displacements along ``split`` plus this
        rank's local shape (reference :414)."""
        shape = tuple(int(s) for s in shape)
        n = shape[split]
        size = self.size
        block = -(-n // size)
        counts = tuple(max(0, min(n - r * block, block)) for r in range(size))
        displs = tuple(min(r * block, n) for r in range(size))
        _, lshape, _ = self.chunk(shape, split)
        return counts, displs, lshape

    def lshape_map(self, gshape, split: Optional[int]) -> np.ndarray:
        """(size, ndim) array of every rank's shard shape under the chunk
        geometry (reference :429)."""
        gshape = tuple(int(s) for s in gshape)
        out = np.tile(np.array(gshape, dtype=np.int64), (self.size, 1))
        if split is not None and len(gshape) > 0:
            counts, _, _ = self.counts_displs_shape(gshape, split % len(gshape))
            out[:, split % len(gshape)] = np.array(counts, dtype=np.int64)
        return out

    # ------------------------------------------------------------------ #
    # collectives                                                        #
    # ------------------------------------------------------------------ #
    def _count(self, name: str) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1

    def allreduce(self, t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
        """Elementwise reduction of ``t`` over the ranks (``op`` one of
        ``sum``, ``max``, ``min``, ``prod``), or over the members of
        ``group`` (one of ``subgroups``); returns a new tensor."""
        out = t.clone().contiguous()
        if self.is_distributed():
            dist.all_reduce(out, op=getattr(dist.ReduceOp, {"prod": "PRODUCT"}.get(op, op.upper())), group=group)
        self._count("all-reduce")
        return out

    def subgroups(self, n_groups: int, width: int):
        """This rank's two process groups of a ``n_groups`` x ``width`` grid
        of the world: ``within`` (the ``width`` consecutive ranks of its
        row) and ``across`` (the ranks of its column, one a row). Every
        rank makes every group, in one order, on the first call for a
        grid; later calls reuse them."""
        key = (n_groups, width)
        if key not in self._groups:
            rows = [[g * width + j for j in range(width)] for g in range(n_groups)]
            cols = [[g * width + j for g in range(n_groups)] for j in range(width)]
            made_rows = [dist.new_group(r) for r in rows]
            made_cols = [dist.new_group(c) for c in cols]
            g, j = divmod(self.rank, width)
            self._groups[key] = (made_rows[g], made_cols[j])
        return self._groups[key]

    def allgather(
        self, t: torch.Tensor, axis: int = 0, counts: Optional[Sequence[int]] = None, group=None
    ) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``axis``, in rank order.
        Rank q's extent along ``axis`` is ``counts[q]`` (default: all equal
        to this rank's); the shards are padded to the largest extent for
        the one all-gather and trimmed after it. ``group`` (one of
        ``subgroups``) gathers over its members only."""
        p = self.size if group is None else dist.get_world_size(group)
        axis = axis % max(t.ndim, 1)
        counts = [int(t.shape[axis])] * p if counts is None else [int(c) for c in counts]
        width = max(counts)
        moved = t.movedim(axis, 0)
        if moved.shape[0] < width:
            pad = moved.new_zeros((width - moved.shape[0],) + tuple(moved.shape[1:]))
            moved = torch.cat([moved, pad])
        src = _as_bytes(moved)
        buf = torch.empty(p * src.numel(), dtype=torch.uint8, device=t.device)
        if p > 1:
            dist.all_gather_into_tensor(buf, src, group=group)
        else:
            buf.copy_(src)
        self._count("all-gather")
        blocks = _from_bytes(buf, t.dtype, (p, width) + tuple(moved.shape[1:]))
        whole = torch.cat([blocks[q, : counts[q]] for q in range(p)])
        return whole.movedim(0, axis)

    def alltoall(
        self,
        send: torch.Tensor,
        send_counts: Optional[Sequence[int]] = None,
        recv_counts: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """All-to-all along dim 0: the ``send_counts[q]`` rows that follow
        the ones before them go to rank q, and the result holds the rows
        from rank 0, then rank 1, ... (``recv_counts[q]`` from rank q).
        Without counts, dim 0 splits into ``size`` equal blocks."""
        p = self.size
        rows = tuple(send.shape[1:])
        row_bytes = int(np.prod(rows, dtype=np.int64)) * send.element_size()
        if send_counts is None:
            if send.shape[0] % p:
                raise ValueError(f"alltoall: dim 0 of {tuple(send.shape)} does not split into {p} blocks")
            send_counts = recv_counts = [send.shape[0] // p] * p
        src = _as_bytes(send)
        n_out = int(sum(recv_counts))
        buf = torch.empty(n_out * row_bytes, dtype=torch.uint8, device=send.device)
        if p > 1:
            dist.all_to_all_single(
                buf, src,
                output_split_sizes=[int(c) * row_bytes for c in recv_counts],
                input_split_sizes=[int(c) * row_bytes for c in send_counts],
            )
        else:
            buf.copy_(src)
        self._count("all-to-all")
        return _from_bytes(buf, send.dtype, (n_out,) + rows)

    def ring_exchange(self, send: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """One hop of a ring: ``send`` goes to rank ``dst`` while a tensor
        of the same shape arrives from rank ``src`` (one
        ``batch_isend_irecv``).

        Gloo's send and receive read and write host memory only: given a
        CUDA tensor they fail ("Bad address" from gloo's TCP transport,
        torch 2.11 on an H100), where its collectives take CUDA tensors.
        So under gloo a CUDA tensor is staged through pinned host buffers,
        and ``staged_bytes`` adds the bytes copied each way (sent plus
        received). NCCL exchanges the device tensors themselves."""
        return self._exchange(send, dst, src)

    def permute(self, send: torch.Tensor, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute``'s exchange: for each (src, dst) of ``pairs``,
        rank src's ``send`` goes to rank dst. Every rank calls it with the
        same pairs and a tensor of the same shape and dtype; a rank sends
        to at most one rank and receives from at most one, and one that
        receives nothing gets zeros (the ends of a shift that is not
        cyclic). Staged through host memory under gloo as
        :meth:`ring_exchange` is."""
        srcs, dsts = [int(s) for s, _ in pairs], [int(d) for _, d in pairs]
        if len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts) or not set(srcs + dsts) <= set(range(self.size)):
            raise ValueError(f"permute: {list(pairs)} is not a partial permutation of {self.size} ranks")
        me = self.rank
        dst = [d for s, d in zip(srcs, dsts) if s == me]
        src = [s for s, d in zip(srcs, dsts) if d == me]
        return self._exchange(send, dst[0] if dst else None, src[0] if src else None)

    def _exchange(self, send: torch.Tensor, dst: Optional[int], src: Optional[int]) -> torch.Tensor:
        """Send ``send`` to ``dst`` and receive a tensor like it from
        ``src`` (either may be None) in one ``batch_isend_irecv``; zeros
        where nothing arrives. Under gloo a CUDA tensor crosses the host
        only in the directions used. Counted as one collective-permute."""
        out = _as_bytes(send)
        buf = torch.zeros_like(out) if src is None else torch.empty_like(out)
        me = self.rank
        if self.is_distributed() and (dst, src) != (me, me):
            staged = out.is_cuda and dist.get_backend() == "gloo"
            wire_out, wire_in = out, buf
            if staged and dst is not None:
                wire_out = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
                wire_out.copy_(out)
            if staged and src is not None:
                wire_in = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
            ops = ([] if dst is None else [dist.P2POp(dist.isend, wire_out, dst)]) + (
                [] if src is None else [dist.P2POp(dist.irecv, wire_in, src)])
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            if staged:
                if src is not None:
                    buf.copy_(wire_in)
                self.staged_bytes += out.numel() * ((dst is not None) + (src is not None))
        elif src == me:
            buf.copy_(out)
        self._count("collective-permute")
        return _from_bytes(buf, send.dtype, send.shape)

    def bcast(self, t: torch.Tensor, root: int = 0) -> torch.Tensor:
        """``t`` of rank ``root`` on every rank (same shape and dtype on
        every rank); returns a new tensor."""
        buf = _as_bytes(t).clone()
        if self.is_distributed():
            dist.broadcast(buf, src=root)
        self._count("broadcast")
        return _from_bytes(buf, t.dtype, t.shape)

    def barrier(self) -> None:
        """Wait until every rank has reached this call (no data move, not
        counted in ``counts``); a no-op in a world of one rank."""
        if self.is_distributed():
            dist.barrier()

    def __repr__(self) -> str:
        return f"TorchCommunication(rank={self.rank}, size={self.size})"


MPI_WORLD = TorchCommunication()
"""The world communicator."""

MPICommunication = TorchCommunication
"""``heat_tpu``'s name of the communicator class (an alias there too)."""


class _SelfCommunication(TorchCommunication):
    """A communicator of this process alone, whatever the world (the analog
    of MPI_COMM_SELF): size 1, rank 0, every collective a local copy."""

    @property
    def size(self) -> int:
        return 1

    @property
    def rank(self) -> int:
        return 0

    def __repr__(self) -> str:
        return "TorchCommunication(self)"


MPI_SELF = _SelfCommunication()
"""The one-rank communicator (reference: communication.py:2013)."""

__default_comm: Communication = MPI_WORLD


def init_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> TorchCommunication:
    """Join the ``torch.distributed`` world and make it the default
    communicator (counterpart of ``heat_tpu``'s ``init_distributed``,
    :603). Call it once per process, before creating arrays.

    ``backend`` defaults to NCCL when the default device is the GPU and to
    gloo otherwise. For NCCL the default ``gpu`` device is bound to
    ``cuda:LOCAL_RANK`` (the variable ``torchrun`` sets; else the rank
    modulo the number of cards), so that every rank uses its own card.
    ``init_method``, ``world_size`` and ``rank`` go to
    ``torch.distributed.init_process_group``; left out, it reads them from
    the environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), as ``torchrun`` sets them."""
    from . import devices

    if backend is None:
        backend = "nccl" if devices.get_device().device_type == "gpu" else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: the NCCL backend needs CUDA")
        rank_now = rank if rank is not None else int(os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK", rank_now % torch.cuda.device_count()))
        devices._bind_gpu(local)
        torch.cuda.set_device(local)
    kwargs = {"init_method": init_method, "world_size": world_size, "rank": rank}
    dist.init_process_group(backend, **{k: v for k, v in kwargs.items() if v is not None})
    MPI_WORLD.counts.clear()
    MPI_WORLD.staged_bytes = 0
    MPI_WORLD._groups.clear()
    use_comm(MPI_WORLD)
    return MPI_WORLD


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
