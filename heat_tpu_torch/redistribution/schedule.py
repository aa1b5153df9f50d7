"""Schedule IR: the inspectable plan of one redistribution (port of
``heat_tpu.redistribution.schedule``).

A :class:`Schedule` is a strategy name plus an ordered list of
:class:`Step`\\ s (slice → collective → concat), each carrying

- ``bytes_moved``: the per-rank payload the step ships to other ranks
  (0 for local copy steps), and
- ``peak_bytes``: the per-rank transient buffer the step needs on top of
  the resident source and destination shards.

``Schedule.collective_counts()`` is the census of collectives the
executor must issue; the communicator's ``counts`` are held against it.
Steps of a chunk group carry an ``overlap`` tag and the schedule a
modeled critical-path account of the groups (depth-2 pipelining of laps);
the port's executor issues the laps in sequential order, which launches
the same collectives (the pipelined order is ROADMAP.md Queue 1, item 16).

Under the wire codec (``kernels.quant``) the planner wraps a plan's
admissible collectives in ``quantize``/``dequantize`` steps, scales their
``bytes_moved`` to the encoded bytes and adds the ``quant`` annotation
({mode, tol, bytes_raw, bytes_sent, ratio, min_group_bytes}). At a
two-tier topology every collective step carries its ``tier`` (``"ici"``
within a node, ``"dcn"`` across) and the plan the ``topology`` annotation
({n_slices, chips_per_slice, dcn_penalty}); a plan priced under a measured
lattice profile carries ``calibration`` ({profile_id, edges}). Out-of-core
staging plans (``redistribution.staging``) carry ``stage_in``/``stage_out``
steps on the ``pcie`` tier and the ``staging`` annotation. ``topology``,
``staging`` and ``calibration`` are conditional keys: a plan without them
serializes without them.

Plans serialize canonically (``canonical_json``) and byte for byte as
``heat_tpu`` serializes the same plan, so the ``plan_id`` (the hash of that
serialization) is ``heat_tpu``'s.
"""

from __future__ import annotations

import hashlib
import json

from typing import Any, Dict, List, Optional, Tuple

from .spec import RedistSpec

__all__ = ["COLLECTIVE_STEP_KINDS", "STAGING_STEP_KINDS", "Schedule", "Step"]

# step kind -> the collective it issues (and the communicator counts under
# that name). Every other kind is a local copy or view.
COLLECTIVE_STEP_KINDS: Dict[str, str] = {
    "all_to_all": "all-to-all",
    "all_gather": "all-gather",
    "ppermute": "collective-permute",
}

# ``pack``/``unpack`` are the relayout copies of kernels.relayout (K5, K6);
# ``quantize``/``dequantize`` the wire codec's copies (kernels.quant, Q1)
_LOCAL_STEP_KINDS = ("slice", "pad", "reshape", "concat", "pack", "unpack", "quantize", "dequantize")

# the out-of-core staging transfers: one window of a host-resident operand
# copied to the card or its result copied back, over the ``pcie`` tier; no
# collective
STAGING_STEP_KINDS = ("stage_in", "stage_out")


class Step:
    """One schedule step.

    Attributes
    ----------
    kind : ``all_to_all`` | ``all_gather`` | ``ppermute`` | ``slice`` |
        ``pad`` | ``reshape`` | ``concat`` | ``pack`` | ``unpack`` |
        ``quantize`` | ``dequantize`` | ``stage_in`` | ``stage_out``.
    bytes_moved : per-rank payload sent to other ranks, or over the host
        to card edge for the staging steps (0 for local steps).
    bytes_copied : per-rank bytes a local relayout copy writes.
    peak_bytes : per-rank transient buffer bytes of this step.
    lane_fill : fraction of the 128 lanes of a TPU vector register that
        the step's buffer fills (``kernels.relayout.lane_fill``), the cost
        term the planner keeps so that its choices are ``heat_tpu``'s.
    detail : what the step does.
    chunk : chunk index when the step is one lap of a chunked exchange.
    overlap : pipeline-group tag of a lap of a chunk group, else None.
    tier : ``"ici"`` or ``"dcn"`` on a collective of a plan at a two-tier
        topology (its group within a node or across nodes), ``"pcie"`` on
        the staging steps (and only there), else None (then the key is left
        out of the serialization).
    """

    __slots__ = ("kind", "bytes_moved", "bytes_copied", "peak_bytes", "lane_fill", "detail", "chunk", "overlap",
                 "tier")

    def __init__(
        self,
        kind: str,
        bytes_moved: int = 0,
        peak_bytes: int = 0,
        detail: str = "",
        chunk: Optional[int] = None,
        bytes_copied: int = 0,
        lane_fill: float = 1.0,
        overlap: Optional[str] = None,
        tier: Optional[str] = None,
    ):
        if kind not in COLLECTIVE_STEP_KINDS and kind not in _LOCAL_STEP_KINDS and kind not in STAGING_STEP_KINDS:
            raise ValueError(f"unknown step kind {kind!r}")
        if tier not in (None, "ici", "dcn", "pcie"):
            raise ValueError(f"unknown tier {tier!r} (expected 'ici', 'dcn', 'pcie' or None)")
        if (tier == "pcie") != (kind in STAGING_STEP_KINDS):
            raise ValueError(f"tier 'pcie' is the staging steps' and theirs alone (got {kind!r} on {tier!r})")
        self.kind = kind
        self.bytes_moved = int(bytes_moved)
        self.bytes_copied = int(bytes_copied)
        self.peak_bytes = int(peak_bytes)
        self.lane_fill = float(lane_fill)
        self.detail = detail
        self.chunk = chunk
        self.overlap = overlap
        self.tier = tier

    @property
    def is_collective(self) -> bool:
        return self.kind in COLLECTIVE_STEP_KINDS

    @property
    def effective_bytes(self) -> int:
        """Lane-amplified traffic the cost model charges this step:
        (payload + local copy writes) / lane_fill."""
        return int((self.bytes_moved + self.bytes_copied) / max(self.lane_fill, 1e-9))

    def as_dict(self) -> Dict[str, Any]:
        d = {
            "kind": self.kind,
            "bytes_moved": self.bytes_moved,
            "bytes_copied": self.bytes_copied,
            "peak_bytes": self.peak_bytes,
            "lane_fill": self.lane_fill,
            "detail": self.detail,
            "chunk": self.chunk,
            "overlap": self.overlap,
        }
        if self.tier is not None:
            d["tier"] = self.tier
        return d

    def __repr__(self) -> str:
        c = f"[{self.chunk}]" if self.chunk is not None else ""
        t = f", tier={self.tier}" if self.tier else ""
        return f"Step({self.kind}{c}, moved={self.bytes_moved}, peak={self.peak_bytes}{t})"


class Schedule:
    """An ordered redistribution plan for one :class:`RedistSpec`.

    ``overlap`` (optional) is the pipelining annotation of the plan's
    chunk groups::

        {"depth": 2,
         "groups": [{"tag": "pipe0", "laps": C, "wire_bytes": ..., "copy_bytes": ...,
                     "sequential_bytes": ..., "critical_path_bytes": ...}, ...],
         "sequential_bytes": ..., "critical_path_bytes": ..., "model_speedup": ...}

    It is cost model, not movement: the collectives are the same either
    way.

    ``staging`` (optional) is the out-of-core annotation of a
    ``host-staging`` plan (``redistribution.staging.plan_staged_passes``):
    its passes and windows, the slab, the bytes held on the card across
    the loop (``resident_bytes``) and on the host, and the modeled times.
    """

    def __init__(
        self,
        spec: RedistSpec,
        strategy: str,
        steps: List[Step],
        budget_bytes: int,
        notes: str = "",
        overlap: Optional[Dict[str, Any]] = None,
        quant: Optional[Dict[str, Any]] = None,
        topology: Optional[Dict[str, Any]] = None,
        staging: Optional[Dict[str, Any]] = None,
        calibration: Optional[Dict[str, Any]] = None,
    ):
        self.spec = spec
        self.strategy = strategy
        self.steps: List[Step] = list(steps)
        self.budget_bytes = int(budget_bytes)
        self.notes = notes
        self.overlap = overlap
        self.quant = quant
        self.topology = topology
        self.staging = staging
        self.calibration = calibration
        self.plan_id = hashlib.sha1(self.canonical_json(with_plan_id=False).encode()).hexdigest()[:12]

    # ------------------------------------------------------------------ #
    # accounting                                                         #
    # ------------------------------------------------------------------ #
    @property
    def peak_bytes(self) -> int:
        """Max per-rank transient footprint over all steps."""
        return max((s.peak_bytes for s in self.steps), default=0)

    @property
    def bytes_moved(self) -> int:
        """Total per-rank payload sent to other ranks."""
        return sum(s.bytes_moved for s in self.steps)

    @property
    def bytes_copied(self) -> int:
        """Total per-rank local relayout copy writes."""
        return sum(s.bytes_copied for s in self.steps)

    @property
    def effective_bytes(self) -> int:
        """Lane-amplified traffic of the whole plan, the volume term of the
        planner's cost model."""
        return sum(s.effective_bytes for s in self.steps)

    @property
    def resident_bytes(self) -> int:
        """Per-rank bytes resident for the whole plan: the source and
        destination shards, or for a staged plan the outputs held on the
        card across the window loop (the operand itself lives on the
        host)."""
        if self.staging is not None:
            return int(self.staging["resident_bytes"])
        return int(self.spec.src_shard_bytes) + int(self.spec.dst_shard_bytes)

    @property
    def liveness_peak_bytes(self) -> int:
        """``resident_bytes`` plus the largest transient, the card memory
        that ``staging.prove_fits`` holds under ``tiers.capacity("hbm")``."""
        return self.resident_bytes + self.peak_bytes

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    @property
    def n_collectives(self) -> int:
        return sum(1 for s in self.steps if s.is_collective)

    @property
    def within_budget(self) -> bool:
        return self.peak_bytes <= self.budget_bytes

    @property
    def overlap_depth(self) -> int:
        """2 when the plan carries an overlap annotation, else 1."""
        return int(self.overlap["depth"]) if self.overlap else 1

    @property
    def wire_bytes_sent(self) -> int:
        """Per-rank bytes that cross to other ranks (encoded under the
        codec)."""
        return self.bytes_moved

    @property
    def wire_bytes_raw(self) -> int:
        """Per-rank full-width bytes of the same movement."""
        return int(self.quant["bytes_raw"]) if self.quant else self.bytes_moved

    @property
    def topo_key(self) -> Optional[Tuple[int, int]]:
        """``(n_slices, chips_per_slice)`` of a tiered plan, None when flat."""
        if not self.topology:
            return None
        return (int(self.topology["n_slices"]), int(self.topology["chips_per_slice"]))

    def tier_bytes(self) -> Dict[str, int]:
        """``{"ici": B, "dcn": B}`` of the collectives' payload (a flat plan's
        is all ``ici``), with ``"pcie"`` for a staged plan's transfers."""
        out = {"ici": 0, "dcn": 0}
        for s in self.steps:
            if s.is_collective:
                out[s.tier or "ici"] += s.bytes_moved
            elif s.kind in STAGING_STEP_KINDS:
                out["pcie"] = out.get("pcie", 0) + s.bytes_moved
        return out

    def collective_counts(self) -> Dict[str, int]:
        """{collective name: count} the executor must issue, directly
        comparable with the communicator's ``counts``."""
        out: Dict[str, int] = {}
        for s in self.steps:
            if s.is_collective:
                op = COLLECTIVE_STEP_KINDS[s.kind]
                out[op] = out.get(op, 0) + 1
        return out

    # ------------------------------------------------------------------ #
    # serialization                                                      #
    # ------------------------------------------------------------------ #
    def as_dict(self, with_plan_id: bool = True) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "spec": self.spec.as_dict(),
            "strategy": self.strategy,
            "budget_bytes": self.budget_bytes,
            "steps": [s.as_dict() for s in self.steps],
            "peak_bytes": self.peak_bytes,
            "bytes_moved": self.bytes_moved,
            "bytes_copied": self.bytes_copied,
            "collective_counts": self.collective_counts(),
            "within_budget": self.within_budget,
            "notes": self.notes,
            "overlap": self.overlap,
            "quant": self.quant,
        }
        if self.topology is not None:
            d["topology"] = self.topology
        if self.staging is not None:
            d["staging"] = self.staging
        if self.calibration is not None:
            d["calibration"] = self.calibration
        if with_plan_id:
            d["plan_id"] = self.plan_id
        return d

    def canonical_json(self, with_plan_id: bool = True) -> str:
        """Deterministic serialization, byte for byte ``heat_tpu``'s for
        the same (spec, budget, codec, topology, profile)."""
        return json.dumps(self.as_dict(with_plan_id=with_plan_id), sort_keys=True, separators=(",", ":"))

    def describe(self) -> str:
        """One line per step with its movement and copy accounting and
        pipeline tag, plus the overlap annotation's modeled critical path:
        what ``ht.redistribution.explain(...)`` shows when printed
        (``heat_tpu``'s rendering)."""
        groups = {g["tag"]: g for g in (self.overlap or {}).get("groups", [])}
        lines = [
            f"plan {self.plan_id}  strategy={self.strategy}  "
            f"depth={self.overlap_depth}  {self.spec!r}"
        ]
        for k, s in enumerate(self.steps):
            chunk = f"[{s.chunk}]" if s.chunk is not None else ""
            pipe = f"  pipe={s.overlap}" if s.overlap else ""
            g = groups.get(s.overlap)
            if g and s.is_collective and "ici_bytes" in g:
                wi = g["ici_bytes"] // g["laps"]
                wd = g["dcn_bytes"] * g["dcn_penalty"] // g["laps"]
                c = g["copy_bytes"] // g["laps"]
                model = f"  model=max(ici {wi}, dcn {wd}, copy {c})={max(wi, wd, c)} B-eq"
            elif g and s.is_collective:
                w = g["wire_bytes"] // g["laps"]
                c = g["copy_bytes"] // g["laps"]
                model = f"  model=max(wire {w}, copy {c})={max(w, c)} B"
            else:
                model = f"  model={s.effective_bytes} B"
            tier = f"  tier={s.tier}" if s.tier else ""
            lines.append(
                f"  [{k:2d}] {s.kind}{chunk}  moved={s.bytes_moved}  "
                f"copied={s.bytes_copied}  peak={s.peak_bytes}{tier}{pipe}{model}"
                + (f"  -- {s.detail}" if s.detail else "")
            )
        if self.overlap:
            o = self.overlap
            lines.append(
                f"  overlap: depth={o['depth']} groups={len(o['groups'])} "
                f"critical_path={o['critical_path_bytes']} B vs "
                f"sequential={o['sequential_bytes']} B "
                f"(model_speedup={o['model_speedup']}x)"
            )
        else:
            lines.append("  overlap: none (sequential schedule)")
        if self.quant:
            q = self.quant
            lines.append(
                f"  quant: {q['mode']} wire codec  raw={q['bytes_raw']} B -> sent={q['bytes_sent']} B "
                f"(saved {q['bytes_raw'] - q['bytes_sent']} B, ratio {q['ratio']}, tol {q['tol']})"
            )
        else:
            lines.append("  quant: none (full-width wire)")
        if self.topology:
            t, tb = self.topology, self.tier_bytes()
            lines.append(
                f"  topology: {t['n_slices']}x{t['chips_per_slice']} two-tier  ici={tb['ici']} B  dcn={tb['dcn']} B "
                f"(dcn priced {t['dcn_penalty']}x — time-eq {tb['ici'] + tb['dcn'] * t['dcn_penalty']} B)"
            )
        if self.staging:
            sg, model = self.staging, self.staging["model"]
            passes = ", ".join(f"{p['tag']}(axis {p['axis']}: {p['n_windows']}w" + ("+wb" if p.get("writeback") else "")
                               + ")" for p in sg["passes"])
            lines.append(
                f"  staging: depth={sg['depth']} [{passes}]  {sg['n_windows']} window(s) x <= {sg['window_bytes']} B "
                f"over pcie  slab={sg['slab_bytes']} B  hbm-resident={sg['resident_bytes']} B  "
                f"host-resident={sg['host_bytes']} B  model: pcie {model['pcie_s']}s / critical path "
                f"{model['critical_path_s']}s ({model['bound_gbps']} GB/s)"
            )
        if self.calibration:
            c = self.calibration
            edges = "  ".join(f"{e}={c['edges'][e] / 1e9:.2f}GB/s" for e in sorted(c["edges"]))
            lines.append(f"  calibration: profile {c['profile_id']}  {edges}")
        if self.notes:
            lines.append(f"  notes: {self.notes}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        kinds = [s.kind + (f"[{s.chunk}]" if s.chunk is not None else "") for s in self.steps]
        ov = f", overlap=depth{self.overlap_depth}" if self.overlap else ""
        qt = f", quant={self.quant['mode']}" if self.quant else ""
        tp = f", topo={self.topology['n_slices']}x{self.topology['chips_per_slice']}" if self.topology else ""
        return (
            f"Schedule({self.strategy}, plan={self.plan_id}, {self.spec!r}, "
            f"steps={kinds}, peak={self.peak_bytes}B/{self.budget_bytes}B{ov}{qt}{tp})"
        )
