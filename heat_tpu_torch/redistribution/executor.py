"""Schedule execution: the per-rank programs of each strategy (port of
``heat_tpu.redistribution.executor``).

``heat_tpu`` compiles a plan into one ``shard_map`` program over its mesh.
The port runs one process per rank, so each strategy is a per-rank body
``body(x, rank, p, exchange)``: ``x`` is this rank's shard, ``exchange``
the object whose collectives the body calls. The public path
(``resplit_local``, ``reshape_local``, under ``DNDarray.resplit`` and
``ht.reshape(..., new_split=)``) passes the communicator; ``LocalWorld``
passes an in-process stand-in that moves the blocks of ``p`` emulated
ranks between their tensors, so that all ranks' bodies run in one process
(on one card, or in the CPU tests). Either way the exchange offers

* ``alltoall(send)``: block q of ``send`` (dim 0, ``p`` equal blocks) goes
  to rank q; block q of the result came from rank q;
* ``allgather(t, axis)``: every rank's ``t`` concatenated along ``axis``;
* ``ring_exchange(send, dst, src)``: ``send`` to ``dst``, the same shape
  from ``src``,

and counts its calls by the names of ``schedule.COLLECTIVE_STEP_KINDS``,
which are held against the plan's ``collective_counts()``.

A body follows ``heat_tpu``'s physical layout (``core/_padding``): it pads
the shard to the per-rank block (``ceil(n / p)`` rows) on entry, runs
``heat_tpu``'s program on it, and trims the result to this rank's chunk of
the destination. The laps of a chunk group run in the sequential order
(issue lap k, place lap k); ``heat_tpu``'s pipelined issue order
(``_run_laps``, executor.py:132) launches the same collectives and is
ROADMAP.md Queue 1, item 16. The packed pivot's copies are kernels K6
(``unpack_rows``, a packed source) and K5 (``pack_rows``, a packed
target).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..core import _padding
from ..core.communication import MPI_WORLD
from ..kernels import relayout as _relayout
from . import planner as _planner
from .schedule import Schedule
from .spec import RedistSpec

__all__ = ["LocalWorld", "execute", "program", "reshape_local", "resplit_local"]

Body = Callable[[torch.Tensor, int, int, object], torch.Tensor]


def _a2a_chunks(sched: Schedule):
    """(before, after) all-to-all lap counts around the plan's ``reshape``
    step, from step kinds (heat_tpu executor.py:109)."""
    before = after = 0
    seen_reshape = False
    for st in sched.steps:
        if st.kind == "reshape":
            seen_reshape = True
        elif st.kind == "all_to_all":
            if seen_reshape:
                after += 1
            else:
                before += 1
    return max(before, 1), max(after, 1)


def _packed_flags(sched: Schedule):
    """(packed_in, packed_out) from the plan's unpack and pack steps around
    its ``reshape`` step (heat_tpu executor.py:378)."""
    seen_reshape = False
    packed_in = packed_out = False
    for st in sched.steps:
        if st.kind == "reshape":
            seen_reshape = True
        elif st.kind == "unpack" and not seen_reshape:
            packed_in = True
        elif st.kind == "pack" and seen_reshape:
            packed_out = True
    return packed_in, packed_out


def _count(n: int, p: int, rank: int) -> int:
    """Rank ``rank``'s chunk extent of n entries in a world of p."""
    return MPI_WORLD.chunk((n,), 0, rank=rank, w_size=p)[1][0]


def _chunk(t: torch.Tensor, axis: Optional[int], rank: int, p: int) -> torch.Tensor:
    """Rank ``rank``'s chunk of the whole tensor ``t`` along ``axis``."""
    if axis is None or p == 1:
        return t
    return t[MPI_WORLD.chunk(t.shape, axis, rank=rank, w_size=p)[2]].clone()


def _empty_chunk(spec: RedistSpec, rank: int, like: torch.Tensor) -> torch.Tensor:
    shape = list(spec.out_shape)
    if spec.dst_split is not None:
        shape[spec.dst_split] = _count(shape[spec.dst_split], spec.mesh_size, rank)
    return like.new_empty(shape)


# --------------------------------------------------------------------- #
# exchanges of heat_tpu's program bodies                                #
# --------------------------------------------------------------------- #
def _chunked_all_to_all(x, p: int, split_axis: int, concat_axis: int, C: int, exchange) -> torch.Tensor:
    """Tiled all-to-all of a physical block in C equal laps along the
    concat axis (heat_tpu executor.py:213): ``split_axis`` splits into p
    blocks, block q goes to rank q, and the received blocks are
    concatenated along ``concat_axis`` in rank order."""
    x2 = x.movedim(concat_axis, 0)
    s_ax = split_axis + 1 if split_axis < concat_axis else split_axis
    Bc = x2.shape[0]
    step = Bc // max(C, 1)
    Bs = x2.shape[s_ax] // p
    rest = tuple(x2.shape[1:s_ax]) + (Bs,) + tuple(x2.shape[s_ax + 1 :])
    out = x.new_empty((p, Bc) + rest)
    for c in range(max(C, 1)):
        chunk = x2[c * step : (c + 1) * step]
        send = chunk.unflatten(s_ax, (p, Bs)).movedim(s_ax, 0).contiguous()
        out[:, c * step : (c + 1) * step] = exchange.alltoall(send)
    return out.reshape((p * Bc,) + rest).movedim(0, concat_axis)


def _chunked_a2a_flat(x, p: int, C: int, exchange) -> torch.Tensor:
    """All-to-all of a (p, M) column-grouped flat buffer in C laps of
    columns (heat_tpu executor.py:394): row d goes to rank d, row q of the
    result came from rank q."""
    M = x.shape[1]
    step = M // max(C, 1)
    out = torch.empty_like(x)
    for c in range(max(C, 1)):
        out[:, c * step : (c + 1) * step] = exchange.alltoall(x[:, c * step : (c + 1) * step].contiguous())
    return out


def _ring_exchange(x, rank: int, p: int, split_axis: int, concat_axis: int, exchange) -> torch.Tensor:
    """The split move as p − 1 hops (heat_tpu executor.py:491): at
    distance d this rank sends the block bound for rank + d and places the
    one from rank − d."""
    Bs = x.shape[split_axis] // p
    Bc = x.shape[concat_axis]
    shape = list(x.shape)
    shape[split_axis], shape[concat_axis] = Bs, Bc * p
    out = x.new_empty(shape)
    out.narrow(concat_axis, rank * Bc, Bc).copy_(x.narrow(split_axis, rank * Bs, Bs))
    for d in range(1, p):
        blk = x.narrow(split_axis, ((rank + d) % p) * Bs, Bs).contiguous()
        recv = exchange.ring_exchange(blk, (rank + d) % p, (rank - d) % p)
        out.narrow(concat_axis, ((rank - d) % p) * Bc, Bc).copy_(recv)
    return out


# --------------------------------------------------------------------- #
# per-rank bodies, one per strategy                                     #
# --------------------------------------------------------------------- #
def _move_body(spec: RedistSpec, sched: Schedule) -> Body:
    """split i → split j by (chunked) all-to-all or the ring (heat_tpu
    ``_move_program``, :547)."""
    i, j = spec.src_split, spec.dst_split
    Ni, Nj = spec.gshape[i], spec.gshape[j]
    ring = sched.strategy == "ring"
    C = _a2a_chunks(sched)[0]

    def body(x, rank, p, exchange):
        y = _padding.pad_to(x, i, _padding.pad_extent(Ni, p) // p)
        y = _padding.pad_to(y, j, _padding.pad_extent(Nj, p))
        if ring:
            y = _ring_exchange(y, rank, p, split_axis=j, concat_axis=i, exchange=exchange)
        else:
            y = _chunked_all_to_all(y, p, split_axis=j, concat_axis=i, C=C, exchange=exchange)
        y = _padding.trim_to(y, i, Ni)
        return _padding.trim_to(y, j, _count(Nj, p, rank)).contiguous()

    return body


def _gather_body(spec: RedistSpec) -> Body:
    """replicate / gather-reshape (heat_tpu ``_gather_reshape_program``,
    :793): one all-gather of the padded blocks, drop the pad, reshape, and
    keep this rank's chunk of the destination."""
    s, t = spec.src_split, spec.dst_split

    def body(x, rank, p, exchange):
        block = _padding.pad_extent(spec.gshape[s], p) // p
        whole = exchange.allgather(_padding.pad_to(x, s, block), s)
        whole = _padding.trim_to(whole, s, spec.gshape[s]).reshape(spec.out_shape)
        return _chunk(whole, t, rank, p).contiguous()

    return body


def _pivot_body(spec: RedistSpec, sched: Schedule) -> Body:
    """Reshape through the split-0 pivot (heat_tpu ``_pivot_program``,
    :613): all-to-all to split 0, local row-major reshape, all-to-all out.
    Also the collective-free split-0 → split-0 reshape."""
    s, t = spec.src_split, spec.dst_split
    in_shape, out_shape = spec.gshape, spec.out_shape
    C1, C2 = _a2a_chunks(sched)

    def body(x, rank, p, exchange):
        y = x
        if s != 0:
            y = _padding.pad_to(y, s, _padding.pad_extent(in_shape[s], p) // p)
            y = _chunked_all_to_all(y, p, split_axis=0, concat_axis=s, C=C1, exchange=exchange)
            y = _padding.trim_to(y, s, in_shape[s])
        y = y.reshape((out_shape[0] // p,) + tuple(out_shape[1:]))
        if t != 0:
            y = _padding.pad_to(y, t, _padding.pad_extent(out_shape[t], p))
            y = _chunked_all_to_all(y, p, split_axis=t, concat_axis=0, C=C2, exchange=exchange)
            y = _padding.trim_to(y, t, _count(out_shape[t], p, rank))
        return y.contiguous()

    return body


def _packed_pivot_body(spec: RedistSpec, sched: Schedule) -> Body:
    """The packed pivot (heat_tpu ``_packed_pivot_program``, :707): a
    packed source arrives as (p, rows·cols/p) column blocks that K6
    unpacks; a packed target is packed by K5 before its all-to-alls."""
    s, t = spec.src_split, spec.dst_split
    (r0, c0), (r1, c1) = spec.gshape, spec.out_shape
    C1, C2 = _a2a_chunks(sched)
    packed_in, packed_out = _packed_flags(sched)

    def body(x, rank, p, exchange):
        c0p, c1p = _padding.pad_extent(c0, p), _padding.pad_extent(c1, p)
        R0, R1 = r0 // p, r1 // p
        cs0, cs1 = c0p // p, c1p // p
        if s == 1:
            xl = _padding.pad_to(x, 1, cs0)
            if packed_in:
                grouped = xl.contiguous().reshape(p, R0 * cs0)  # row block q is bound for rank q
                recv = _chunked_a2a_flat(grouped, p, C1, exchange)
                flat = _relayout.unpack_rows(recv, R0, c0p, c0, p)
            else:
                y = _chunked_all_to_all(xl, p, split_axis=0, concat_axis=1, C=C1, exchange=exchange)
                flat = _padding.trim_to(y, 1, c0).reshape(R0 * c0)
        else:  # split 0: the shard is a contiguous run of the flat order
            flat = x.reshape(-1)
        if t == 1:
            if packed_out:
                grouped = _relayout.pack_rows(flat, R1, c1, c1p, p)
                # rows arrive in global order
                y = _chunked_a2a_flat(grouped, p, C2, exchange).reshape(r1, cs1)
            else:
                y = _padding.pad_to(flat.reshape(R1, c1), 1, c1p)
                y = _chunked_all_to_all(y, p, split_axis=1, concat_axis=0, C=C2, exchange=exchange)
            return _padding.trim_to(y, 1, _count(c1, p, rank)).contiguous()
        return flat.reshape(R1, c1)

    return body


def program(spec: RedistSpec, sched: Optional[Schedule] = None) -> Body:
    """The per-rank body that carries out ``sched`` (default: the
    planner's plan of ``spec``) on a world of ``spec.mesh_size`` ranks."""
    sched = _planner.plan(spec) if sched is None else sched
    strategy = sched.strategy
    s, t = spec.src_split, spec.dst_split
    if strategy == "noop":
        return lambda x, rank, p, exchange: x
    if strategy == "local" or spec.size == 0:
        if spec.size == 0:
            return lambda x, rank, p, exchange: _empty_chunk(spec, rank, x)
        return lambda x, rank, p, exchange: x.reshape(spec.out_shape)
    if strategy == "slice" or (strategy == "local-reshape" and s is None):
        return lambda x, rank, p, exchange: _chunk(x.reshape(spec.out_shape), t, rank, p)
    if strategy in ("all-to-all", "chunked-all-to-all", "ring"):
        return _move_body(spec, sched)
    if strategy in ("replicate", "gather-reshape"):
        return _gather_body(spec)
    if strategy in ("split0-pivot", "local-reshape"):
        return _pivot_body(spec, sched)
    if strategy == "packed-pivot":
        return _packed_pivot_body(spec, sched)
    raise ValueError(f"unknown strategy {strategy!r} (plan {sched.plan_id})")


def execute(comm, local: torch.Tensor, spec: RedistSpec, sched: Optional[Schedule] = None) -> torch.Tensor:
    """Run the planned redistribution of this rank's shard ``local`` (in
    the chunk geometry of ``spec.src_split``) over ``comm``; returns this
    rank's shard of the destination."""
    if spec.mesh_size != comm.size:
        raise ValueError(f"execute: the spec is for {spec.mesh_size} ranks, the communicator has {comm.size}")
    return program(spec, sched)(local, comm.rank, comm.size, comm)


def _spec(local: torch.Tensor, gshape, src, dst, p: int, reshape_to=None) -> RedistSpec:
    dtype = str(local.dtype).replace("torch.", "")
    return RedistSpec.normalize(gshape, dtype, src, dst, p, reshape_to=reshape_to)


def resplit_local(comm, local: torch.Tensor, gshape, src: Optional[int], dst: Optional[int]) -> torch.Tensor:
    """Planner-routed split change of this rank's shard (the engine under
    ``DNDarray.resplit``; heat_tpu ``resplit_phys``, :1039)."""
    return execute(comm, local, _spec(local, gshape, src, dst, comm.size))


def reshape_local(comm, local: torch.Tensor, in_gshape, in_split, out_shape, out_split) -> torch.Tensor:
    """Planner-routed reshape with repartition of this rank's shard (the
    engine under ``ht.reshape(..., new_split=)``; heat_tpu
    ``reshape_phys``, :1054)."""
    spec = _spec(local, in_gshape, in_split, out_split, comm.size, reshape_to=tuple(out_shape))
    return execute(comm, local, spec)


# --------------------------------------------------------------------- #
# p ranks in one process                                                #
# --------------------------------------------------------------------- #
class _LocalExchange:
    """One emulated rank's side of a ``LocalWorld``."""

    def __init__(self, world: "LocalWorld", rank: int):
        self.world, self.rank = world, rank
        self.counts: Dict[str, int] = {}

    def _post(self, value):
        """Post ``value``, wait until every rank has posted, return all
        posts; the caller copies what it needs before ``_done``."""
        w = self.world
        w.slots[self.rank] = value
        w.barrier.wait()
        return w.slots

    def _done(self, name: str) -> None:
        self.world.barrier.wait()
        self.counts[name] = self.counts.get(name, 0) + 1

    def alltoall(self, send: torch.Tensor) -> torch.Tensor:
        posts = self._post(send)
        recv = torch.stack([posts[q][self.rank] for q in range(self.world.p)])
        self._done("all-to-all")
        return recv

    def allgather(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        posts = self._post(t)
        whole = torch.cat(list(posts), dim=axis)
        self._done("all-gather")
        return whole

    def ring_exchange(self, send: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        posts = self._post((send, dst))
        sent, to = posts[src]
        if to != self.rank:
            raise RuntimeError(f"ring_exchange: rank {src} sent to {to}, not to {self.rank}")
        recv = sent.clone()
        self._done("collective-permute")
        return recv


class LocalWorld:
    """``p`` ranks emulated in one process: ``run(body, shards)`` runs
    ``body(shards[r], r, p, exchange_r)`` for every rank r, each in its own
    thread, and returns the results in rank order. The exchange is a device
    copy between the ranks' tensors, not a collective of a communication
    library: results equal a real world's, times do not. ``counts[r]`` are
    rank r's collective counts of the last run."""

    def __init__(self, p: int):
        self.p = int(p)
        self.slots: List[object] = [None] * self.p
        self.barrier = threading.Barrier(self.p, timeout=600)
        self.counts: List[Dict[str, int]] = []

    def run(self, body: Body, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(shards) != self.p:
            raise ValueError(f"run: {len(shards)} shards for {self.p} ranks")
        self.barrier.reset()
        exchanges = [_LocalExchange(self, r) for r in range(self.p)]
        results: List[object] = [None] * self.p
        errors: List[BaseException] = []

        def rank_main(r: int) -> None:
            try:
                results[r] = body(shards[r], r, self.p, exchanges[r])
            except BaseException as e:  # noqa: BLE001 (re-raised below, after every thread ends)
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(self.p)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        self.counts = [e.counts for e in exchanges]
        if errors:
            first = next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)), errors[0])
            raise first
        return results
