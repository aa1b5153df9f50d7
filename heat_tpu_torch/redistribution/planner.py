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

Wire codec: after selection, the winner's admissible collective groups
are wrapped in ``quantize``/``dequantize`` steps (``kernels.quant``: int8
with a float32 scale a 1024-element tile, about 0.251 of the bytes, or the
bf16 cast at 0.5) under ``HEAT_TPU_WIRE_QUANT`` or ``quant=``. Running the
pass after ``_select`` keeps the strategy and the collectives the same with
the codec on or off. Admissible: float32 transient exchanges of at least
``QUANT_MIN_WIRE_BYTES`` full-width; everything else ships exact. Under
``auto`` the gate resolves to no codec on every device the port runs on.

Two-tier topology (``HEAT_TPU_TOPOLOGY``, ``core.communication.Topology``):
every candidate is priced per tier. A flat collective whose group spans
nodes rides ``dcn`` (``tier="dcn"``, each byte priced
``tiers.penalty("dcn")`` ``ici`` bytes), and the ``hierarchical-a2a``
strategy splits each all-to-all into one within the node (``ici``,
``L·(C−1)/C``) and one across nodes of rows packed by node (``dcn``,
``L·(S−1)/S``). In a hierarchical plan the codec takes only the ``dcn``
exchanges. ``HEAT_TPU_LATTICE_PROFILE`` re-prices the edges and stamps the
profile's ``calibration`` into every plan.

Plans are cached per (spec, budget, codec, topology, profile). Host staging
plans come from ``staging.plan_staged_passes``.
"""

from __future__ import annotations

import threading

from typing import Dict, List, Optional, Tuple

from ..core import gates as _gates
from ..kernels import relayout as _relayout
from .schedule import Schedule, Step
from .spec import RedistSpec

__all__ = [
    "ALPHA_BYTES",
    "DEFAULT_BUDGET_MB",
    "OVERLAP_ENV",
    "QUANT_MIN_WIRE_BYTES",
    "WIRE_QUANT_ENV",
    "budget_bytes",
    "clear_plan_cache",
    "explain",
    "golden_specs",
    "overlap_mode",
    "plan",
    "planner_enabled",
    "quant_tolerance",
    "resolve_topology",
    "tier_time_model",
    "wire_quant_gate",
    "wire_quant_mode",
]

#: per-collective launch latency in byte-equivalents (heat_tpu's constant)
ALPHA_BYTES = 1 << 20

DEFAULT_BUDGET_MB = 256
_BUDGET_ENV = "HEAT_TPU_REDIST_BUDGET_MB"
_ENABLE_ENV = "HEAT_TPU_REDIST_PLANNER"
OVERLAP_ENV = "HEAT_TPU_REDIST_OVERLAP"
WIRE_QUANT_ENV = "HEAT_TPU_WIRE_QUANT"

#: a collective group takes the codec only from this many full-width bytes
#: on (smaller exchanges are latency-bound and stay exact)
QUANT_MIN_WIRE_BYTES = 2 << 20

#: the strategies whose collectives ship transient payloads, the codec's
#: domain (replicate and gather-reshape materialize the values)
_QUANT_STRATEGIES = (
    "all-to-all", "chunked-all-to-all", "ring", "split0-pivot", "packed-pivot", "hierarchical-a2a",
)

#: pipelinable exchanges are chunked into laps of about this size even
#: when the budget alone would not require it
OVERLAP_GRAIN_BYTES = 32 << 20
_OVERLAP_MAX_LAPS = 4

_plan_lock = threading.Lock()
_plan_cache: Dict[tuple, Schedule] = {}
_PLAN_CACHE_MAX = 4096


def budget_bytes() -> int:
    """Per-rank peak-memory budget for redistribution transients
    (``HEAT_TPU_REDIST_BUDGET_MB``, default 256 MiB)."""
    raw = _gates.get(_BUDGET_ENV, "") or ""
    try:
        mb = int(raw) if raw.strip() else DEFAULT_BUDGET_MB
    except ValueError:
        mb = DEFAULT_BUDGET_MB
    return max(1, mb) << 20


def overlap_mode() -> str:
    """``HEAT_TPU_REDIST_OVERLAP`` resolved to ``"0"``, ``"1"`` or
    ``"auto"``. ``1`` runs the linalg paths' rings (``kernels.cmatmul``);
    ``0`` and ``auto`` their barrier collectives. The executor issues its
    laps in the sequential order under every value (the pipelined order is
    ROADMAP.md Queue 1, item 16)."""
    v = (_gates.get(OVERLAP_ENV, "auto") or "").strip().lower()
    if v in ("0", "off", "false", "no"):
        return "0"
    if v in ("1", "on", "true", "force", "yes"):
        return "1"
    return "auto"


def wire_quant_mode() -> str:
    """``HEAT_TPU_WIRE_QUANT`` resolved to ``"0"``, ``"1"`` (int8),
    ``"bf16"`` or ``"auto"``."""
    v = (_gates.get(WIRE_QUANT_ENV, "auto") or "").strip().lower()
    if v in ("0", "off", "false", "no"):
        return "0"
    if v in ("1", "on", "true", "force", "yes", "int8"):
        return "1"
    if v == "bf16":
        return "bf16"
    return "auto"


def wire_quant_gate() -> Optional[str]:
    """The codec the gate resolves to (``"int8"``, ``"bf16"``) or None. Under
    ``auto`` None on every device the port runs on, as ``heat_tpu``
    resolves it off the TPU: the exact wire stays the default."""
    m = wire_quant_mode()
    if m == "1":
        return "int8"
    if m == "bf16":
        return "bf16"
    return None


def quant_tolerance(mode: Optional[str]) -> float:
    """The bound a plan quantized under ``mode`` declares (its ``quant.tol``):
    ``kernels.quant.tolerance(mode)``, 0.0 for None."""
    if mode is None:
        return 0.0
    from ..kernels import quant as _quant

    return float(_quant.tolerance(mode))


def _dcn_penalty() -> int:
    from ..core import tiers

    return tiers.penalty("dcn")


def resolve_topology(mesh_size: int, override=None) -> Optional[Tuple[int, int]]:
    """``(n_slices, chips_per_slice)`` of the tiered topology of a world of
    ``mesh_size`` ranks, None when flat. ``override``: None reads
    ``HEAT_TPU_TOPOLOGY``, ``"flat"`` forces flat, an ``"SxC"`` string, a
    ``Topology`` or an ``(S, C)`` tuple forces that factorization (flat
    when the product is not ``mesh_size``)."""
    if isinstance(override, tuple):
        S, C = int(override[0]), int(override[1])
        return (S, C) if S > 1 and S * C == int(mesh_size) else None
    from ..core import communication as _comm

    t = _comm.topology_for(mesh_size, override)
    return (t.n_slices, t.chips_per_slice) if t.tiered else None


def _topo_annotation(topo: Tuple[int, int]) -> dict:
    return {"n_slices": int(topo[0]), "chips_per_slice": int(topo[1]), "dcn_penalty": _dcn_penalty()}


def tier_time_model(sched: Schedule, edges: Optional[dict] = None) -> dict:
    """Seconds a rank's payload of ``sched`` takes on each edge it rides, at
    ``core.tiers``' rates (or ``edges``: ``{edge: bytes/s}`` or
    ``{edge: {"bps": ...}}``): ``ici``, ``dcn`` and, for a staged plan,
    ``pcie``. A model, not a measurement."""
    from ..core import tiers

    def _time(nbytes: int, edge: str) -> float:
        if edges and edge in edges:
            rec = edges[edge]
            bps = float(rec["bps"] if isinstance(rec, dict) else rec)
            if bps > 0:
                return max(int(nbytes), 0) / bps
        return tiers.transfer_time(nbytes, edge)

    tb = sched.tier_bytes()
    ici_s, dcn_s = _time(tb["ici"], "ici"), _time(tb["dcn"], "dcn")
    out = {"ici_bytes": tb["ici"], "dcn_bytes": tb["dcn"], "ici_s": ici_s, "dcn_s": dcn_s, "total_s": ici_s + dcn_s}
    if tb.get("pcie"):
        pcie_s = _time(tb["pcie"], "pcie")
        out.update(pcie_bytes=tb["pcie"], pcie_s=pcie_s, total_s=ici_s + dcn_s + pcie_s)
    return out


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


# --------------------------------------------------------------------- #
# two-tier topology: tier classification and the hierarchical all-to-all #
# --------------------------------------------------------------------- #
def _tier_group(tag: str, laps: int, ici_bytes: int, dcn_bytes: int, copy_bytes: int) -> Optional[dict]:
    """Critical-path model of one chunk group at a tiered topology: a lap
    costs ``max(ici, dcn·penalty, copy)`` with the first wire legs and last
    copy exposed; ``wire_bytes`` in ``ici`` byte-equivalents."""
    laps = int(laps)
    if laps < 2:
        return None
    pen = _dcn_penalty()
    ici_bytes, dcn_bytes, copy_bytes = int(ici_bytes), int(dcn_bytes), int(copy_bytes)
    wi, wd, c = ici_bytes // laps, dcn_bytes * pen // laps, copy_bytes // laps
    cp = wi + wd + c + (laps - 1) * max(wi, wd, c)
    wire_eq = ici_bytes + dcn_bytes * pen
    seq = wire_eq + copy_bytes
    if cp >= seq:
        return None
    return {
        "tag": tag,
        "laps": laps,
        "wire_bytes": int(wire_eq),
        "copy_bytes": copy_bytes,
        "ici_bytes": ici_bytes,
        "dcn_bytes": dcn_bytes,
        "dcn_penalty": pen,
        "sequential_bytes": int(seq),
        "critical_path_bytes": int(cp),
    }


def _hier_a2a_group(tag: str, L: int, topo: Tuple[int, int], laps: int, lane_fill: float) -> Optional[dict]:
    """Tier group of a ``laps``-lap hierarchical all-to-all of ``L`` bytes a
    rank: ``L·(C−1)/C`` on ``ici``, ``L·(S−1)/S`` on ``dcn``, ``L`` copied."""
    S, C = topo
    fill = max(float(lane_fill), 1e-9)
    return _tier_group(tag, laps, int(L * (C - 1) // C / fill), int(L * (S - 1) // S / fill), int(L / fill))


def _with_tier(st: Step, tier: str) -> Step:
    return Step(st.kind, bytes_moved=st.bytes_moved, peak_bytes=st.peak_bytes, detail=st.detail, chunk=st.chunk,
                bytes_copied=st.bytes_copied, lane_fill=st.lane_fill, overlap=st.overlap, tier=tier)


def _tier_flat(sched: Schedule, topo: Optional[Tuple[int, int]]) -> Schedule:
    """A flat candidate at a tiered topology: its groups span the nodes,
    so every collective rides ``dcn`` and the plan carries the topology."""
    if topo is None or not any(st.is_collective for st in sched.steps):
        return sched
    steps = [_with_tier(st, "dcn") if st.is_collective else st for st in sched.steps]
    overlap = sched.overlap
    if overlap:
        overlap = _overlap_annotation(
            [_tier_group(g["tag"], g["laps"], 0, g["wire_bytes"], g["copy_bytes"]) for g in overlap["groups"]]
        )
    return Schedule(sched.spec, sched.strategy, steps, sched.budget_bytes, notes=sched.notes, overlap=overlap,
                    quant=sched.quant, topology=_topo_annotation(topo))


def _hier_chunk_steps(
    L: int,
    topo: Tuple[int, int],
    K: int,
    what: str,
    pad_step: Optional[Step],
    tail_slice: Optional[Step],
    lane_fill: float = 1.0,
    pipe: Optional[str] = None,
) -> List[Step]:
    """K laps of slice → all-to-all within the node (``ici``) → all-to-all
    across nodes of rows packed by node (``dcn``), then the scatter:
    2·K all-to-alls."""
    S, C = topo
    steps: List[Step] = []
    if pad_step is not None:
        steps.append(pad_step)
    ici_cross = L * (C - 1) // C
    dcn_cross = L * (S - 1) // S
    pipe = pipe if K > 1 else None

    def lap(chunk: Optional[int], l_bytes: int):
        out = []
        if chunk is not None:
            out.append(Step("slice", peak_bytes=l_bytes, detail=f"chunk {chunk}/{K} of {what}", chunk=chunk,
                            overlap=pipe))
        out.append(Step("all_to_all", bytes_moved=ici_cross // max(K, 1), peak_bytes=2 * l_bytes,
                        detail=f"intra-slice pivot of {what} (chip subgroups)", chunk=chunk, lane_fill=lane_fill,
                        overlap=pipe, tier="ici"))
        out.append(Step("all_to_all", bytes_moved=dcn_cross // max(K, 1), peak_bytes=2 * l_bytes,
                        detail=f"inter-slice exchange of {what} (pre-packed per-slice rows — minimum DCN bytes)",
                        chunk=chunk, lane_fill=lane_fill, overlap=pipe, tier="dcn"))
        return out

    if K <= 1:
        steps += lap(None, L)
    else:
        for c in range(K):
            steps += lap(c, L // K)
        steps.append(Step("concat", peak_bytes=0, detail="scatter chunks into dst shard", overlap=pipe))
    if tail_slice is not None:
        steps.append(tail_slice)
    return steps


def _resplit_candidates(spec: RedistSpec, budget: int, topo: Optional[Tuple[int, int]] = None) -> List[Schedule]:
    """split i → split j candidates: (chunked) all-to-all and the ring; at a
    tiered topology those two priced on ``dcn`` and the hierarchical
    all-to-all."""
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
    if topo is None:
        return [a2a, ring]
    hier = Schedule(
        spec, "hierarchical-a2a", _hier_chunk_steps(L, topo, C, what, pad_step, tail, lane_fill=fill, pipe="pipe0"),
        budget,
        notes=(
            f"two-tier decomposition at {topo[0]}x{topo[1]}: intra-slice pivot (ICI carries the volume) + "
            "inter-slice exchange of pre-packed per-slice rows (minimum DCN bytes)" + (f"; C={C} chunks" if C > 1 else "")
        ),
        overlap=_overlap_annotation([_hier_a2a_group("pipe0", L, topo, C, fill)]),
        topology=_topo_annotation(topo),
    )
    return [_tier_flat(a2a, topo), _tier_flat(ring, topo), hier]


def _pivot_valid(spec: RedistSpec) -> bool:
    """The split-0 pivot needs the leading extents to divide the world
    size on both sides (then the middle reshape is local)."""
    p = spec.mesh_size
    in0 = spec.gshape[0] if spec.gshape else 0
    out0 = spec.out_shape[0] if spec.out_shape else 0
    return len(spec.gshape) >= 1 and len(spec.out_shape) >= 1 and in0 > 0 and out0 > 0 and in0 % p == 0 and out0 % p == 0


def _pivot_schedule(spec: RedistSpec, budget: int, topo: Optional[Tuple[int, int]] = None) -> Schedule:
    """The split-0 pivot; with ``topo`` its hierarchical variant (each stage
    split across the tiers, strategy ``hierarchical-a2a``)."""
    p = spec.mesh_size
    s, t = spec.src_split, spec.dst_split
    item = spec.itemsize
    steps: List[Step] = []
    groups: List[Optional[dict]] = []
    shard = spec.size // p * item

    def stage(L, C, what, fill, pipe):
        if topo is None:
            groups.append(_a2a_group(pipe, L, p, C, fill) if C > 1 else None)
            return _a2a_chunk_steps(L, p, C, what, None, None, lane_fill=fill, pipe=pipe)
        groups.append(_hier_a2a_group(pipe, L, topo, C, fill))
        return _hier_chunk_steps(L, topo, C, what, None, None, lane_fill=fill, pipe=pipe)

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
    strategy = ("hierarchical-a2a" if topo is not None else "split0-pivot") if n_coll else "local-reshape"
    return Schedule(
        spec,
        strategy,
        steps,
        budget,
        notes="minor-dim packing: heavy copies run on the split-0 layout"
        + (f"; two-tier pivot stages at {topo[0]}x{topo[1]}" if topo is not None and n_coll else ""),
        overlap=_overlap_annotation(groups),
        topology=_topo_annotation(topo) if topo is not None and n_coll else None,
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


def _packed_pivot_schedule(spec: RedistSpec, budget: int, topo: Optional[Tuple[int, int]] = None) -> Schedule:
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
        if topo is None:
            groups.append(_a2a_group(pipe, L, p, C, fill) if C > 1 else None)
            return _a2a_chunk_steps(L, p, C, what, None, None, lane_fill=fill, pipe=pipe)
        groups.append(_hier_a2a_group(pipe, L, topo, C, fill))
        return _hier_chunk_steps(L, topo, C, what, None, None, lane_fill=fill, pipe=pipe)

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
        "hierarchical-a2a" if topo is not None else "packed-pivot",
        steps,
        budget,
        notes=(
            "lane-packing pivot: collectives and heavy copies run on packed "
            "full-lane buffers (HEAT_TPU_RELAYOUT_KERNEL gates the tiled-copy kernel)"
        ) + (f"; two-tier pivot stages at {topo[0]}x{topo[1]}" if topo is not None else ""),
        overlap=_overlap_annotation(groups),
        topology=_topo_annotation(topo) if topo is not None else None,
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
    lane-amplified traffic, a ``dcn`` step's at ``tiers.penalty("dcn")``
    per byte."""
    pen = _dcn_penalty() if s.topology else 1
    total = 0
    for st in s.steps:
        eff = st.effective_bytes
        if st.tier == "dcn":
            eff *= pen
        total += (ALPHA_BYTES if st.is_collective else 0) + eff
    return total


def _select(candidates: List[Schedule]) -> Schedule:
    feasible = [c for c in candidates if c.within_budget]
    if feasible:
        return min(feasible, key=_cost)
    best = min(candidates, key=lambda c: c.peak_bytes)
    notes = (best.notes + "; " if best.notes else "") + (
        f"over budget: peak {best.peak_bytes} B > {best.budget_bytes} B "
        "(smallest-footprint candidate chosen)"
    )
    return Schedule(best.spec, best.strategy, best.steps, best.budget_bytes, notes=notes, overlap=best.overlap,
                    topology=best.topology)


# --------------------------------------------------------------------- #
# the wire codec's pass over a selected plan                            #
# --------------------------------------------------------------------- #
def _quantize_schedule(sched: Schedule, mode: Optional[str]) -> Schedule:
    """Wrap the admissible collective groups of a selected plan in
    ``quantize``/``dequantize`` steps and scale their ``bytes_moved`` to
    the encoded bytes (``heat_tpu``'s ``_quantize_schedule``): float32
    payloads of transient-exchange strategies, groups of at least
    ``QUANT_MIN_WIRE_BYTES`` full-width; in a hierarchical plan only the
    ``dcn`` exchanges. The overlap groups are priced again on the encoded
    bytes."""
    if mode is None:
        return sched
    spec = sched.spec
    if spec.dtype != "float32" or sched.strategy not in _QUANT_STRATEGIES:
        return sched
    from ..kernels import quant as _quant

    p = spec.mesh_size
    item = spec.itemsize
    hier = sched.strategy == "hierarchical-a2a"
    # the rows each exchange encodes apart: one a destination (node)
    n_dest = int(sched.topology["n_slices"]) if hier else p
    groups: Dict[str, List[int]] = {}
    for idx, st in enumerate(sched.steps):
        if not st.is_collective or (hier and st.tier != "dcn"):
            continue
        groups.setdefault(st.overlap if st.overlap is not None else f"_solo{idx}", []).append(idx)
    sent_of: Dict[int, int] = {}
    for idxs in groups.values():
        if sum(sched.steps[i].bytes_moved for i in idxs) < QUANT_MIN_WIRE_BYTES:
            continue
        for i in idxs:
            st = sched.steps[i]
            if st.kind == "ppermute":
                sent_of[i] = _quant.wire_bytes(st.bytes_moved // item, mode)
            else:
                blk_elems = st.bytes_moved // (n_dest - 1) // item
                sent_of[i] = (n_dest - 1) * _quant.wire_bytes(blk_elems, mode)
    if not sent_of:
        return sched

    raw_total = sched.bytes_moved
    new_steps: List[Step] = []
    for i, st in enumerate(sched.steps):
        if i not in sent_of:
            new_steps.append(st)
            continue
        sent, raw = sent_of[i], st.bytes_moved
        if st.kind == "ppermute":
            full_local, enc_write = raw, sent
        else:  # the resident diagonal block included
            full_local, enc_write = raw * n_dest // (n_dest - 1), sent * n_dest // (n_dest - 1)
        new_steps.append(Step(
            "quantize", bytes_copied=enc_write, peak_bytes=enc_write,
            detail=(f"{mode}-encode wire blocks ({_quant.TILE}-elem tile scales): {raw} B -> {sent} B on the wire "
                    f"(saved {raw - sent} B)"),
            chunk=st.chunk, overlap=st.overlap,
        ))
        new_steps.append(Step(st.kind, bytes_moved=sent, peak_bytes=st.peak_bytes, detail=st.detail + f" [{mode} wire]",
                              chunk=st.chunk, lane_fill=1.0, overlap=st.overlap, tier=st.tier))
        new_steps.append(Step(
            "dequantize", bytes_copied=0 if st.overlap else full_local, peak_bytes=0 if st.overlap else full_local,
            detail=f"{mode}-decode received blocks" + (
                " (full-width write rides the group's reassembly copy)" if st.overlap
                else f" ({full_local} B full-width write)"),
            chunk=st.chunk, overlap=st.overlap,
        ))

    new_overlap = sched.overlap
    if sched.overlap:
        rebuilt = []
        for g in sched.overlap["groups"]:
            idxs = [i for i in groups.get(g["tag"], []) if i in sent_of]
            if not idxs:
                rebuilt.append(g)
                continue
            wire_new = sum(sent_of[i] for i in idxs)
            if "ici_bytes" in g:
                rebuilt.append(_tier_group(g["tag"], g["laps"], g["ici_bytes"], wire_new, g["copy_bytes"]))
            else:
                rebuilt.append(_overlap_group(g["tag"], g["laps"], wire_new, g["copy_bytes"]))
        new_overlap = _overlap_annotation(rebuilt)

    sent_total = raw_total - sum(sched.steps[i].bytes_moved for i in sent_of) + sum(sent_of.values())
    ann = {
        "mode": mode,
        "tol": _quant.tolerance(mode),
        "bytes_raw": int(raw_total),
        "bytes_sent": int(sent_total),
        "ratio": round(sent_total / raw_total, 4) if raw_total else 1.0,
        "min_group_bytes": QUANT_MIN_WIRE_BYTES,
    }
    notes = sched.notes + ("; " if sched.notes else "") + (
        f"{mode} wire codec on {len(sent_of)} collective step(s) (kernels.quant, tol {ann['tol']})"
    )
    return Schedule(spec, sched.strategy, new_steps, sched.budget_bytes, notes=notes, overlap=new_overlap, quant=ann,
                    topology=sched.topology)


# --------------------------------------------------------------------- #
# the planner                                                           #
# --------------------------------------------------------------------- #
def _build(spec: RedistSpec, budget: int, topo: Optional[Tuple[int, int]] = None) -> Schedule:
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
            return _tier_flat(_gather_reshape_schedule(spec, budget), topo)
        candidates = []
        if _pivot_valid(spec):
            candidates.append(_tier_flat(_pivot_schedule(spec, budget), topo))
            if any(_packed_sides(spec)):
                candidates.append(_tier_flat(_packed_pivot_schedule(spec, budget), topo))
            if topo is not None:
                candidates.append(_pivot_schedule(spec, budget, topo=topo))
                if any(_packed_sides(spec)):
                    candidates.append(_packed_pivot_schedule(spec, budget, topo=topo))
        candidates.append(_tier_flat(_gather_reshape_schedule(spec, budget), topo))
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
        return _tier_flat(_gather_reshape_schedule(spec, budget), topo)
    return _select(_resplit_candidates(spec, budget, topo))


def plan(spec: RedistSpec, budget: Optional[int] = None, quant: Optional[str] = None, topology=None) -> Schedule:
    """Plan ``spec`` under ``budget`` bytes (default: the env knob), as
    ``heat_tpu``'s planner plans it. ``quant``: ``"0"`` the exact wire,
    ``"int8"``/``"bf16"`` that codec where admissible, None the
    ``HEAT_TPU_WIRE_QUANT`` gate. ``topology``: None the
    ``HEAT_TPU_TOPOLOGY`` gate, ``"flat"``, ``"SxC"``, a ``Topology`` or an
    ``(S, C)`` tuple. Plans are cached per (spec, budget, codec, topology,
    lattice profile)."""
    b = budget_bytes() if budget is None else int(budget)
    if quant is None:
        qmode = wire_quant_gate()
    elif quant in ("0", "off"):
        qmode = None
    else:
        from ..kernels.quant import MODES

        if quant not in MODES:
            raise ValueError(f"plan: unknown wire codec {quant!r}")
        qmode = quant
    topo = resolve_topology(spec.mesh_size, topology)
    from ..core import tiers

    cal = tiers.profile_annotation()
    key = (spec, b, qmode or "0", topo, cal["profile_id"] if cal else None)
    with _plan_lock:
        cached = _plan_cache.get(key)
    if cached is not None:
        return cached
    sched = _quantize_schedule(_build(spec, b, topo), qmode)
    if cal is not None:
        sched = Schedule(sched.spec, sched.strategy, sched.steps, sched.budget_bytes, notes=sched.notes,
                         overlap=sched.overlap, quant=sched.quant, topology=sched.topology, staging=sched.staging,
                         calibration=cal)
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
    has no unplanned route, so every split change is planned: True
    whatever the gate says."""
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
