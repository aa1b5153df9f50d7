"""Cost-modeled redistribution planning (port of
``heat_tpu.redistribution.planner``).

Every :class:`~.spec.RedistSpec` is decomposed into a bounded-footprint
:class:`~.schedule.Schedule` chosen by an explicit cost model over
candidate strategies (arXiv:2112.01075):

==================  ====================================================
strategy            when / what
==================  ====================================================
``noop``            same split, same shape: nothing moves
``local``           world size 1 (and zero-size arrays): local copy
``slice``           replicated → split: every rank slices its shard
``replicate``       split → replicated: one all-gather
``all-to-all``      split i → j in one all-to-all
``chunked-all-to-all``  the same move in C budget-sized laps
``ring``            p − 1 point-to-point hops, one neighbour block in
                    flight per hop: the smallest footprint
``split0-pivot``    reshape with repartition through a split-0
                    intermediate: all-to-all in, local row-major
                    reshape, all-to-all out
``packed-pivot``    the same pivot with its narrow-minor stages on
                    packed buffers (``kernels.relayout``: K5 packs, K6
                    unpacks)
``local-reshape``   reshape whose blocks stay put: no collective
``gather-reshape``  fallback when divisibility rules the pivot out:
                    gather → reshape → slice
==================  ====================================================

Cost: a collective costs ``ALPHA_BYTES + bytes_moved``, a local copy its
``bytes_copied``, both divided by the step's lane fill (the fraction of a
TPU vector register's 128 lanes its buffer fills). The lane term is a TPU
notion; the port keeps it so that it plans exactly as ``heat_tpu`` does,
and its plans serialize byte for byte as ``heat_tpu``'s (same
``plan_id``). Among candidates whose per-step transient peak fits the
budget (``HEAT_TPU_REDIST_BUDGET_MB``, default 256, read by both packages)
the cheapest wins; when none fits, the smallest peak.

Left out, each raising ``NotImplementedError``: the wire codec (``quant``
other than ``"0"``, ``heat_tpu.kernels.quant``, ROADMAP.md Queue 1 item
12), two-tier topologies and lattice calibration (item 12). Host staging
plans come from ``staging.plan_staged_passes``.
"""

from __future__ import annotations

import os
import threading

from typing import Dict, List, Optional, Tuple

from ..kernels import relayout as _relayout
from .schedule import Schedule, Step
from .spec import RedistSpec

__all__ = [
    "ALPHA_BYTES",
    "DEFAULT_BUDGET_MB",
    "budget_bytes",
    "clear_plan_cache",
    "explain",
    "golden_specs",
    "plan",
    "planner_enabled",
]

#: per-collective launch latency in byte-equivalents (heat_tpu's constant)
ALPHA_BYTES = 1 << 20

DEFAULT_BUDGET_MB = 256
_BUDGET_ENV = "HEAT_TPU_REDIST_BUDGET_MB"

#: pipelinable exchanges are chunked into laps of about this size even
#: when the budget alone would not require it
OVERLAP_GRAIN_BYTES = 32 << 20
_OVERLAP_MAX_LAPS = 4

_plan_lock = threading.Lock()
_plan_cache: Dict[Tuple[RedistSpec, int], Schedule] = {}
_PLAN_CACHE_MAX = 4096


def budget_bytes() -> int:
    """Per-rank peak-memory budget for redistribution transients
    (``HEAT_TPU_REDIST_BUDGET_MB``, default 256 MiB)."""
    raw = os.environ.get(_BUDGET_ENV, "")
    try:
        mb = int(raw) if raw.strip() else DEFAULT_BUDGET_MB
    except ValueError:
        mb = DEFAULT_BUDGET_MB
    return max(1, mb) << 20


def _refuse_unported(quant, topology) -> None:
    """Raise for the planner options this port leaves out."""
    env_quant = os.environ.get("HEAT_TPU_WIRE_QUANT", "auto").strip().lower()
    if quant not in (None, "0", "off") or env_quant in ("1", "on", "true", "force", "yes", "int8", "bf16"):
        raise NotImplementedError(
            "the wire codec (heat_tpu.kernels.quant) is not ported: ROADMAP.md Queue 1, item 12; plan with quant='0'"
        )
    topo = os.environ.get("HEAT_TPU_TOPOLOGY", "") if topology is None else topology
    flat = topo in ("", "auto", "flat") or (isinstance(topo, str) and topo.lower().startswith("1x"))
    if not flat and not (isinstance(topo, tuple) and int(topo[0]) <= 1):
        raise NotImplementedError(
            f"two-tier topologies ({topo!r}) are not ported: ROADMAP.md Queue 1, item 12"
        )
    if os.environ.get("HEAT_TPU_LATTICE_PROFILE"):
        raise NotImplementedError("lattice calibration is not ported: ROADMAP.md Queue 1, item 12")


# --------------------------------------------------------------------- #
# geometry helpers                                                      #
# --------------------------------------------------------------------- #
def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _pad_extent(n: int, p: int) -> int:
    from ..core import _padding

    return _padding.pad_extent(int(n), int(p))


def _divisor_chunks(extent: int, needed: int) -> int:
    """Smallest chunk count >= ``needed`` that divides ``extent``."""
    extent = max(int(extent), 1)
    needed = min(max(1, int(needed)), extent)
    for c in range(needed, extent + 1):
        if extent % c == 0:
            return c
    return extent


def _local_move_bytes(spec: RedistSpec) -> int:
    """Per-rank bytes of the doubly padded block a split i → j move
    exchanges."""
    p = spec.mesh_size
    shape = list(spec.gshape)
    shape[spec.src_split] = _pad_extent(shape[spec.src_split], p)
    shape[spec.dst_split] = _pad_extent(shape[spec.dst_split], p)
    return _prod(shape) // p * spec.itemsize


def _fill(minor: int) -> float:
    return _relayout.lane_fill(minor)


def _shard_minor(shape, split: Optional[int], p: int) -> int:
    """Minor-dim extent of the local shard of (shape, split)."""
    if not shape:
        return 1
    loc = [int(v) for v in shape]
    if split is not None:
        loc[split] = _pad_extent(loc[split], p) // p
    return max(loc[-1], 1)


def _exchange_fill(shape, i: int, j: int, p: int) -> float:
    """Worst lane fill among the buffers a split i <-> j exchange touches."""

    def minor_of(split):
        loc = [int(v) for v in shape]
        loc[i] = _pad_extent(loc[i], p)
        loc[j] = _pad_extent(loc[j], p)
        loc[split] //= p
        return max(loc[-1], 1)

    return min(_fill(minor_of(i)), _fill(minor_of(j)))


# --------------------------------------------------------------------- #
# overlap (pipelining) model                                            #
# --------------------------------------------------------------------- #
def _overlap_laps(L: int) -> int:
    L = int(L)
    if L < 2 * OVERLAP_GRAIN_BYTES:
        return 1
    return min(_OVERLAP_MAX_LAPS, L // OVERLAP_GRAIN_BYTES)


def _lap_count(extent: int, L: int, budget: int) -> int:
    """Chunk count of a pipelinable exchange over ``extent``: the larger of
    the budget requirement and the overlap grain, rounded to a divisor of
    ``extent``; the overlap ask is dropped where it would explode."""
    need_budget = -(-2 * L // budget)
    c_budget = _divisor_chunks(extent, need_budget)
    want = max(need_budget, _overlap_laps(L))
    if want <= need_budget:
        return c_budget
    c = _divisor_chunks(extent, want)
    if c > 4 * _OVERLAP_MAX_LAPS:
        return c_budget
    return c


def _overlap_group(tag: str, laps: int, wire_bytes: int, copy_bytes: int) -> Optional[dict]:
    """Critical-path model of one chunk group at depth 2:
    ``w + (laps - 1) * max(w, c) + c`` with w, c the per-lap wire and copy
    bytes; None when nothing pipelines or nothing is gained."""
    laps = int(laps)
    wire_bytes, copy_bytes = int(wire_bytes), int(copy_bytes)
    if laps < 2:
        return None
    w, c = wire_bytes // laps, copy_bytes // laps
    cp = w + (laps - 1) * max(w, c) + c
    seq = wire_bytes + copy_bytes
    if cp >= seq:
        return None
    return {
        "tag": tag,
        "laps": laps,
        "wire_bytes": wire_bytes,
        "copy_bytes": copy_bytes,
        "sequential_bytes": seq,
        "critical_path_bytes": int(cp),
    }


def _overlap_annotation(groups: List[Optional[dict]]) -> Optional[dict]:
    groups = [g for g in groups if g]
    if not groups:
        return None
    seq = sum(g["sequential_bytes"] for g in groups)
    cp = sum(g["critical_path_bytes"] for g in groups)
    return {
        "depth": 2,
        "groups": groups,
        "sequential_bytes": int(seq),
        "critical_path_bytes": int(cp),
        "model_speedup": round(seq / cp, 4),
    }


# --------------------------------------------------------------------- #
# candidate builders                                                    #
# --------------------------------------------------------------------- #
def _a2a_chunk_steps(
    L: int,
    p: int,
    C: int,
    what: str,
    pad_step: Optional[Step],
    tail_slice: Optional[Step],
    lane_fill: float = 1.0,
    pipe: Optional[str] = None,
) -> List[Step]:
    """C laps of slice → all-to-all, then the scatter reassembly."""
    steps: List[Step] = []
    if pad_step is not None:
        steps.append(pad_step)
    crossing = L * (p - 1) // p  # the diagonal block stays home
    if C <= 1:
        steps.append(Step("all_to_all", bytes_moved=crossing, peak_bytes=2 * L, detail=what, lane_fill=lane_fill))
    else:
        for c in range(C):
            steps.append(
                Step("slice", peak_bytes=L // C, detail=f"chunk {c}/{C} of {what}", chunk=c, overlap=pipe)
            )
            steps.append(
                Step(
                    "all_to_all", bytes_moved=crossing // C, peak_bytes=2 * L // C, detail=what, chunk=c,
                    lane_fill=lane_fill, overlap=pipe,
                )
            )
        steps.append(Step("concat", peak_bytes=0, detail="scatter chunks into dst shard", overlap=pipe))
    if tail_slice is not None:
        steps.append(tail_slice)
    return steps


def _a2a_group(tag: str, L: int, p: int, C: int, lane_fill: float) -> Optional[dict]:
    fill = max(float(lane_fill), 1e-9)
    crossing = L * (p - 1) // p
    return _overlap_group(tag, C, int(crossing / fill), int(L / fill))


def _resplit_candidates(spec: RedistSpec, budget: int) -> List[Schedule]:
    """split i → split j candidates: (chunked) all-to-all and the ring."""
    p = spec.mesh_size
    i, j = spec.src_split, spec.dst_split
    L = _local_move_bytes(spec)
    Nj, Njp = spec.gshape[j], _pad_extent(spec.gshape[j], p)
    Ni, Nip = spec.gshape[i], _pad_extent(spec.gshape[i], p)
    pad_step = Step("pad", peak_bytes=L, detail=f"pad axis {j} {Nj}->{Njp} (local)") if Njp != Nj else None
    tail = Step("slice", peak_bytes=L, detail=f"drop axis {i} pad {Nip}->{Ni} (local)") if Nip != Ni else None
    concat_extent = Nip // p
    C = _lap_count(concat_extent, L, budget)

    what = f"split {i}->{j}"
    fill = _exchange_fill(spec.gshape, i, j, p)
    a2a = Schedule(
        spec,
        "all-to-all" if C <= 1 else "chunked-all-to-all",
        _a2a_chunk_steps(L, p, C, what, pad_step, tail, lane_fill=fill, pipe="pipe0"),
        budget,
        notes=f"C={C} chunks over local axis-{i} extent {concat_extent}" if C > 1 else "",
        overlap=_overlap_annotation([_a2a_group("pipe0", L, p, C, fill)]) if C > 1 else None,
    )

    ring_steps: List[Step] = []
    if pad_step is not None:
        ring_steps.append(pad_step)
    blk = L // p
    for d in range(1, p):
        ring_steps.append(
            Step(
                "ppermute", bytes_moved=blk, peak_bytes=2 * blk, detail=f"hop distance {d}: neighbor block of {what}",
                lane_fill=fill, overlap="ring0" if p > 2 else None,
            )
        )
    if tail is not None:
        ring_steps.append(tail)
    ring_group = (
        _overlap_group(
            "ring0", p - 1, int(blk * (p - 1) / max(fill, 1e-9)), int(blk * (p - 1) / max(fill, 1e-9))
        )
        if p > 2
        else None
    )
    ring = Schedule(
        spec, "ring", ring_steps, budget,
        notes="p-1 ppermute hops, one neighbor block in flight per step",
        overlap=_overlap_annotation([ring_group]),
    )
    return [a2a, ring]


def _pivot_valid(spec: RedistSpec) -> bool:
    """The split-0 pivot needs the leading extents to divide the world
    size on both sides (then the middle reshape is local)."""
    p = spec.mesh_size
    in0 = spec.gshape[0] if spec.gshape else 0
    out0 = spec.out_shape[0] if spec.out_shape else 0
    return len(spec.gshape) >= 1 and len(spec.out_shape) >= 1 and in0 > 0 and out0 > 0 and in0 % p == 0 and out0 % p == 0


def _pivot_schedule(spec: RedistSpec, budget: int) -> Schedule:
    """The split-0 pivot."""
    p = spec.mesh_size
    s, t = spec.src_split, spec.dst_split
    item = spec.itemsize
    steps: List[Step] = []
    groups: List[Optional[dict]] = []
    shard = spec.size // p * item

    def stage(L, C, what, fill, pipe):
        groups.append(_a2a_group(pipe, L, p, C, fill) if C > 1 else None)
        return _a2a_chunk_steps(L, p, C, what, None, None, lane_fill=fill, pipe=pipe)

    n_coll = 0
    if s is not None and s != 0:
        L1 = _prod([_pad_extent(d, p) if ax == s else d for ax, d in enumerate(spec.gshape)]) // p * item
        C1 = _lap_count(_pad_extent(spec.gshape[s], p) // p, L1, budget)
        fill_in = _exchange_fill(spec.gshape, s, 0, p)
        steps += stage(L1, C1, f"split {s}->0 (pivot in)", fill_in, "pipe0")
        n_coll += C1
        if _pad_extent(spec.gshape[s], p) != spec.gshape[s]:
            steps.append(Step("slice", peak_bytes=shard, detail=f"drop axis {s} pad (local)"))
    steps.append(
        Step(
            "reshape",
            peak_bytes=shard,
            bytes_copied=shard,
            lane_fill=min(
                _fill(spec.gshape[-1] if spec.gshape else 1),
                _fill(spec.out_shape[-1] if spec.out_shape else 1),
            ),
            detail="local row-major reshape at full minor-dim width",
        )
    )
    if t is not None and t != 0:
        out_t, out_tp = spec.out_shape[t], _pad_extent(spec.out_shape[t], p)
        L2 = _prod([_pad_extent(d, p) if ax == t else d for ax, d in enumerate(spec.out_shape)]) // p * item
        if out_tp != out_t:
            pad_minor = out_tp if t == len(spec.out_shape) - 1 else spec.out_shape[-1]
            steps.append(
                Step(
                    "pad", peak_bytes=L2, bytes_copied=L2, lane_fill=_fill(pad_minor),
                    detail=f"pad axis {t} {out_t}->{out_tp} (local)",
                )
            )
        C2 = _lap_count(spec.out_shape[0] // p, L2, budget)
        fill_out = _exchange_fill(spec.out_shape, 0, t, p)
        steps += stage(L2, C2, f"split 0->{t} (pivot out)", fill_out, "pipe1")
        n_coll += C2
    return Schedule(
        spec,
        "split0-pivot" if n_coll else "local-reshape",
        steps,
        budget,
        notes="minor-dim packing: heavy copies run on the split-0 layout",
        overlap=_overlap_annotation(groups),
    )


def _packed_sides(spec: RedistSpec) -> Tuple[bool, bool]:
    """(packed_in, packed_out): which pivot stages take the packed form:
    2-D pivots whose shard minor dim fills less than
    ``kernels.relayout.PACK_FILL_THRESHOLD`` of the lanes."""
    p = spec.mesh_size
    if not spec.is_reshape or len(spec.gshape) != 2 or len(spec.out_shape) != 2 or not _pivot_valid(spec):
        return False, False
    thr = _relayout.PACK_FILL_THRESHOLD
    s, t = spec.src_split, spec.dst_split
    packed_in = s == 1 and _fill(_pad_extent(spec.gshape[1], p) // p) < thr
    packed_out = t == 1 and _fill(_pad_extent(spec.out_shape[1], p) // p) < thr
    return packed_in, packed_out


def _packed_pivot_schedule(spec: RedistSpec, budget: int) -> Schedule:
    """The split-0 pivot with its narrow-minor stages on packed buffers:
    the all-to-alls exchange (p, rows·cols/p) column-grouped flat buffers;
    K6 unpacks a packed source, K5 packs a packed target. Same collectives
    as the direct pivot."""
    p = spec.mesh_size
    item = spec.itemsize
    s, t = spec.src_split, spec.dst_split
    (r0, c0), (r1, c1) = spec.gshape, spec.out_shape
    c0p, c1p = _pad_extent(c0, p), _pad_extent(c1, p)
    R0, R1 = r0 // p, r1 // p
    shard = spec.size // p * item
    packed_in, packed_out = _packed_sides(spec)
    steps: List[Step] = []
    groups: List[Optional[dict]] = []

    def stage(L, C, what, fill, pipe):
        groups.append(_a2a_group(pipe, L, p, C, fill) if C > 1 else None)
        return _a2a_chunk_steps(L, p, C, what, None, None, lane_fill=fill, pipe=pipe)

    if s == 1:
        L1 = r0 * c0p // p * item
        C1 = _lap_count(c0p // p, L1, budget)
        if packed_in:
            steps += stage(L1, C1, "split 1->0 (packed pivot in)", 1.0, "pipe0")
            steps.append(
                Step(
                    "unpack", bytes_copied=R0 * c0 * item, peak_bytes=R0 * c0p * item, lane_fill=1.0,
                    detail=f"lane-unpack: ungroup {p} col-blocks, drop row pad {c0p}->{c0} (kernel-served flat copy)",
                )
            )
        else:
            fill_in = _exchange_fill(spec.gshape, 1, 0, p)
            steps += stage(L1, C1, f"split {s}->0 (pivot in)", fill_in, "pipe0")
            if c0p != c0:
                steps.append(Step("slice", peak_bytes=shard, detail="drop axis 1 pad (local)"))
    steps.append(
        Step(
            "reshape", peak_bytes=shard, lane_fill=1.0,
            detail="flat row-major view of the contiguous split-0 block (no narrow materialization)",
        )
    )
    if t == 1:
        L2 = r1 * c1p // p * item
        C2 = _lap_count(R1, L2, budget)
        if packed_out:
            steps.append(
                Step(
                    "pack", bytes_copied=R1 * c1p * item, peak_bytes=R1 * c1p * item, lane_fill=1.0,
                    detail=f"lane-pack rows {c1}->{c1p} + group {p} col-blocks for all-to-all (kernel-served flat copy)",
                )
            )
            steps += stage(L2, C2, "split 0->1 (packed pivot out)", 1.0, "pipe1")
            steps.append(
                Step(
                    "unpack", bytes_copied=R1 * c1p * item, peak_bytes=R1 * c1p * item, lane_fill=_fill(c1p // p),
                    detail=(
                        f"materialize dst shard ({r1}, {c1p // p}) — the single "
                        "lane-amplified write the requested layout costs"
                    ),
                )
            )
        else:
            if c1p != c1:
                steps.append(
                    Step(
                        "pad", peak_bytes=L2, bytes_copied=L2, lane_fill=_fill(c1p),
                        detail=f"pad axis 1 {c1}->{c1p} (local)",
                    )
                )
            fill_out = _exchange_fill(spec.out_shape, 0, 1, p)
            steps += stage(L2, C2, f"split 0->{t} (pivot out)", fill_out, "pipe1")
    return Schedule(
        spec,
        "packed-pivot",
        steps,
        budget,
        notes=(
            "lane-packing pivot: collectives and heavy copies run on packed "
            "full-lane buffers (HEAT_TPU_RELAYOUT_KERNEL gates the tiled-copy kernel)"
        ),
        overlap=_overlap_annotation(groups),
    )


def _gather_reshape_schedule(spec: RedistSpec, budget: int) -> Schedule:
    p = spec.mesh_size
    logical = spec.logical_bytes
    steps = [
        Step(
            "all_gather",
            bytes_moved=logical * (p - 1) // p,
            peak_bytes=logical,
            lane_fill=_fill(_shard_minor(spec.gshape, spec.src_split, p)),
            detail="replicate the full operand (fallback: pivot divisibility failed)"
            if spec.is_reshape
            else "explicit replicate",
        )
    ]
    if spec.is_reshape:
        steps.append(
            Step(
                "reshape",
                peak_bytes=logical,
                bytes_copied=logical,
                lane_fill=min(
                    _fill(spec.gshape[-1] if spec.gshape else 1),
                    _fill(spec.out_shape[-1] if spec.out_shape else 1),
                ),
                detail="replicated reshape",
            )
        )
    if spec.dst_split is not None:
        steps.append(
            Step(
                "slice",
                peak_bytes=spec.dst_shard_bytes,
                bytes_copied=spec.dst_shard_bytes,
                lane_fill=_fill(_shard_minor(spec.out_shape, spec.dst_split, p)),
                detail=f"slice dst shard (split {spec.dst_split})",
            )
        )
    return Schedule(
        spec,
        "gather-reshape" if spec.is_reshape else "replicate",
        steps,
        budget,
        notes="full all-gather — the only strategy that materializes the logical array",
    )


def _cost(s: Schedule) -> int:
    """Byte-equivalent cost: ALPHA per collective plus every step's
    lane-amplified traffic."""
    return sum((ALPHA_BYTES if st.is_collective else 0) + st.effective_bytes for st in s.steps)


def _select(candidates: List[Schedule]) -> Schedule:
    feasible = [c for c in candidates if c.within_budget]
    if feasible:
        return min(feasible, key=_cost)
    best = min(candidates, key=lambda c: c.peak_bytes)
    notes = (best.notes + "; " if best.notes else "") + (
        f"over budget: peak {best.peak_bytes} B > {best.budget_bytes} B "
        "(smallest-footprint candidate chosen)"
    )
    return Schedule(best.spec, best.strategy, best.steps, best.budget_bytes, notes=notes, overlap=best.overlap)


# --------------------------------------------------------------------- #
# the planner                                                           #
# --------------------------------------------------------------------- #
def _build(spec: RedistSpec, budget: int) -> Schedule:
    p = spec.mesh_size

    if spec.is_reshape:
        if spec.gshape == spec.reshape_to and spec.src_split == spec.dst_split:
            return Schedule(spec, "noop", [], budget)
        if p <= 1 or spec.size == 0:
            return Schedule(
                spec, "local", [Step("reshape", peak_bytes=spec.logical_bytes, detail="single-shard reshape")], budget
            )
        if spec.src_split is None:
            steps = [Step("reshape", peak_bytes=spec.logical_bytes, detail="replicated reshape")]
            if spec.dst_split is not None:
                steps.append(
                    Step("slice", peak_bytes=spec.dst_shard_bytes, detail=f"slice dst shard (split {spec.dst_split})")
                )
            return Schedule(spec, "local-reshape", steps, budget)
        if spec.dst_split is None:
            return _gather_reshape_schedule(spec, budget)
        candidates = []
        if _pivot_valid(spec):
            candidates.append(_pivot_schedule(spec, budget))
            if any(_packed_sides(spec)):
                candidates.append(_packed_pivot_schedule(spec, budget))
        candidates.append(_gather_reshape_schedule(spec, budget))
        return _select(candidates)

    # pure resplit
    if spec.src_split == spec.dst_split:
        return Schedule(spec, "noop", [], budget)
    if p <= 1 or spec.size == 0:
        return Schedule(spec, "local", [], budget)
    if spec.src_split is None:
        return Schedule(
            spec, "slice",
            [Step("slice", peak_bytes=spec.dst_shard_bytes, detail=f"local shard slice (split {spec.dst_split})")],
            budget,
        )
    if spec.dst_split is None:
        return _gather_reshape_schedule(spec, budget)
    return _select(_resplit_candidates(spec, budget))


def plan(spec: RedistSpec, budget: Optional[int] = None, quant: Optional[str] = None, topology=None) -> Schedule:
    """Plan ``spec`` under ``budget`` bytes (default: the env knob), as
    ``heat_tpu``'s planner plans it with ``quant="0"`` and
    ``topology="flat"``; other ``quant`` or ``topology`` values raise
    ``NotImplementedError``. Plans are cached per (spec, budget)."""
    _refuse_unported(quant, topology)
    b = budget_bytes() if budget is None else int(budget)
    key = (spec, b)
    with _plan_lock:
        cached = _plan_cache.get(key)
    if cached is not None:
        return cached
    sched = _build(spec, b)
    with _plan_lock:
        if len(_plan_cache) >= _PLAN_CACHE_MAX:
            _plan_cache.pop(next(iter(_plan_cache)))
        _plan_cache[key] = sched
    return sched


def clear_plan_cache() -> int:
    """Drop every cached plan; returns how many there were (``heat_tpu``
    planner.py:357)."""
    with _plan_lock:
        n = len(_plan_cache)
        _plan_cache.clear()
    return n


def planner_enabled() -> bool:
    """``heat_tpu``'s routing switch (planner.py:195), whose
    ``HEAT_TPU_REDIST_PLANNER=0`` restores its unplanned relayout; the port
    has no unplanned route, so every split change is planned: True."""
    return True


def explain(arr, axis=None, *, reshape=None, new_split=None, topology=None) -> Schedule:
    """The plan that ``arr.resplit(axis)`` (or, with ``reshape=``,
    ``ht.reshape(arr, reshape, new_split=...)``) runs, without running
    it (``heat_tpu`` planner.py:1563)."""
    from ..core.dndarray import DNDarray
    from ..core.stride_tricks import sanitize_axis

    if not isinstance(arr, DNDarray):
        raise TypeError(f"explain expects a DNDarray, got {type(arr)}")
    dtype = str(arr.larray.dtype).replace("torch.", "")
    if reshape is not None:
        from ..core.manipulations import _normalize_reshape_args

        shape, new_split = _normalize_reshape_args(
            arr, (tuple(reshape),) if isinstance(reshape, (tuple, list)) else (reshape,), new_split
        )
        spec = RedistSpec.normalize(arr.gshape, dtype, arr.split, new_split, arr.comm.size, reshape_to=shape)
    else:
        axis = sanitize_axis(arr.gshape, axis)
        spec = RedistSpec.normalize(arr.gshape, dtype, arr.split, axis, arr.comm.size)
    return plan(spec, topology=topology)


# --------------------------------------------------------------------- #
# golden matrix (heat_tpu's, planner.py:1621)                            #
# --------------------------------------------------------------------- #
def golden_specs() -> List[Tuple[str, RedistSpec]]:
    """The (name, spec) matrix of ``heat_tpu``'s golden plans."""
    S = RedistSpec.normalize
    return [
        ("noop_same_split", S((64, 48), "float32", 1, 1, 8)),
        ("resplit_0_to_1_p8", S((64, 48), "float32", 0, 1, 8)),
        ("resplit_1_to_0_p8", S((64, 48), "float32", 1, 0, 8)),
        ("resplit_0_to_1_int32_p4", S((64, 48), "int32", 0, 1, 4)),
        ("resplit_uneven_p8", S((63, 48), "float32", 0, 1, 8)),
        ("resplit_3d_1_to_2_p8", S((16, 24, 40), "float32", 1, 2, 8)),
        ("replicate_p8", S((64, 48), "float32", 0, None, 8)),
        ("slice_from_replicated_p8", S((64, 48), "float32", None, 1, 8)),
        ("mesh1_resplit", S((64, 48), "float32", 0, 1, 1)),
        ("resplit_chunked_2gb_p8", S((32768, 16384), "float32", 0, 1, 8)),
        ("resplit_ring_8gb_p8", S((131072, 16384), "float32", 0, 1, 8)),
        ("reshape_pivot_p8", S((40960, 40), "float32", 1, 1, 8, reshape_to=(20480, 80))),
        ("reshape_split0_local_p8", S((64, 48), "float32", 0, 0, 8, reshape_to=(32, 96))),
        ("reshape_gather_fallback_p8", S((1000, 26), "float32", 1, 1, 8, reshape_to=(26, 1000))),
        ("reshape_split1_1gb_p8", S((1000, 250000), "float32", 1, 1, 8, reshape_to=(10_000_000, 25))),
        ("reshape_packed_rev_p8", S((10_000_000, 25), "float32", 1, 1, 8, reshape_to=(1000, 250000))),
        ("reshape_lane_1gb_p8", S((65536, 4096), "float32", 1, 1, 8, reshape_to=(131072, 2048))),
        ("resplit_1gb_p16", S((1000, 250000), "float32", 0, 1, 16)),
        ("reshape_split1_1gb_p16", S((16000, 15625), "float32", 1, 1, 16, reshape_to=(10_000_000, 25))),
    ]
