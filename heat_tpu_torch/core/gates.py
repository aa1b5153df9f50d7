"""The registry of the ``HEAT_TPU_*`` environment gates the port reads (port
of ``heat_tpu.core.gates``).

Every gate is declared once, as a :class:`GateSpec` (name, legal values,
default, whether its value changes the plans the library builds, which
cache layers key on it), with ``heat_tpu``'s names, defaults and values, so
one environment drives both packages alike. :func:`get` is the one place
the port reads a gate from ``os.environ``; the subsystem accessors
(``planner.wire_quant_mode``, ``staging.ooc_mode``, ``tiers.capacity``,
...) parse its raw string as ``heat_tpu``'s do.

Declared here are the gates the port reads. ``HEAT_TPU_HBM_BYTES`` and
``HEAT_TPU_HOST_BYTES`` have no fixed default in the port: unset, a tier's
capacity is what the machine has (``core.tiers.capacity``). The AOT
fingerprint (``aot_fingerprint``, ``affecting_programs``) describes
compiled XLA programs and waits for ``ht.jit`` (ROADMAP.md Queue 1, item
12 (b)).

Kept for parity with ``heat_tpu`` and read by nothing in the port yet but
its tests: ``GateSpec.scopes`` (its ``program``/``aot`` values name
compiled programs the port does not have), ``key_params``, ``accessors``,
``affects_programs``, :func:`program_gate_roster` and :func:`scope_gates`.
Their consumer would be item 12 (b)'s program key; if that item does not
use them, they go.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

__all__ = [
    "GATES",
    "GateSpec",
    "PREFIX",
    "SCOPES",
    "declare",
    "get",
    "is_set",
    "program_gate_roster",
    "scope_gates",
    "snapshot",
]

PREFIX = "HEAT_TPU_"

#: the accepted spellings of the boolean values, as the accessors parse them
_FALSY_SPELLINGS = ("0", "off", "false", "no")
_TRUTHY_SPELLINGS = ("1", "on", "true", "force", "yes")

#: the cache layers a gate can be key material for: ``plan`` (the planner's
#: plan cache and ``plan_id``), ``program`` (a compiled program's key) and
#: ``aot`` (a stored program's key)
SCOPES = ("plan", "program", "aot")


class GateSpec:
    """One declared environment gate: ``name``, the raw ``default`` its
    accessor applies when it is unset (None where the machine decides),
    the legal resolved ``values`` (None for free-form gates), ``kind``
    (``mode``, ``int``, ``bytes`` or ``path``), whether the value changes
    the plans the library builds (``affects_programs``), the cache layers
    that key on it (``scopes``), the parameter names its resolved value
    travels under (``key_params``), the functions that read it
    (``accessors``) and a one-line ``help``."""

    __slots__ = ("name", "default", "values", "kind", "affects_programs", "scopes", "key_params", "accessors",
                 "help")

    def __init__(self, name, default, values=None, kind="mode", affects_programs=True, scopes=(), key_params=(),
                 accessors=(), help=""):
        if not name.startswith(PREFIX):
            raise ValueError(f"gate name must start with {PREFIX!r}, got {name!r}")
        bad = set(scopes) - set(SCOPES)
        if bad:
            raise ValueError(f"unknown cache scopes {sorted(bad)} for {name}")
        self.name = name
        self.default = default
        self.values = tuple(values) if values is not None else None
        self.kind = kind
        self.affects_programs = bool(affects_programs)
        self.scopes = frozenset(scopes)
        self.key_params = tuple(key_params)
        self.accessors = tuple(accessors)
        self.help = help

    def recognizes(self, raw: Optional[str]) -> bool:
        """Does the raw spelling resolve to a legal value (the truthy and
        falsy families and the empty string included)? False means the
        accessor falls through to its default arm."""
        if self.values is None or raw is None:
            return True
        v = raw.strip().lower()
        if v == "" or v in self.values:
            return True
        if "0" in self.values and v in _FALSY_SPELLINGS:
            return True
        return "1" in self.values and v in _TRUTHY_SPELLINGS

    def __repr__(self) -> str:
        return (f"GateSpec({self.name}, default={self.default!r}, affects_programs={self.affects_programs}, "
                f"scopes={sorted(self.scopes)})")


GATES: Dict[str, GateSpec] = {}


def declare(spec: GateSpec) -> GateSpec:
    """Register a gate (a name declared again replaces its entry)."""
    GATES[spec.name] = spec
    return spec


declare(GateSpec(
    "HEAT_TPU_REDIST_PLANNER", default="1", values=("0", "1"), scopes=("program", "aot"),
    accessors=("planner_enabled",),
    help="planner routing; the port plans every split change, so only its value is reported",
))
declare(GateSpec(
    "HEAT_TPU_REDIST_BUDGET_MB", default=str(256), kind="int", scopes=("plan", "program", "aot"),
    key_params=("budget", "budget_bytes", "b"), accessors=("budget_bytes",),
    help="per-rank transient budget (MiB) the planner chunks under",
))
declare(GateSpec(
    "HEAT_TPU_REDIST_OVERLAP", default="auto", values=("0", "1", "auto"), scopes=("program", "aot"),
    key_params=("pipelined", "overlap"), accessors=("overlap_mode", "_overlap_active", "ring_enabled"),
    help="0 = the barrier collectives, 1 = the rings of kernels.cmatmul, auto = the barrier collectives "
         "(the pipelined lap order of the executor is ROADMAP.md Queue 1, item 16)",
))
declare(GateSpec(
    "HEAT_TPU_WIRE_QUANT", default="auto", values=("0", "1", "int8", "bf16", "auto"),
    scopes=("plan", "program", "aot"), key_params=("wire", "quant", "qmode", "codec", "mode"),
    accessors=("wire_quant_mode", "wire_quant_gate"),
    help="wire codec on transient exchanges: 0 = exact, 1 = int8, bf16 = the cast codec, auto = exact on "
         "every device the port runs on",
))
declare(GateSpec(
    "HEAT_TPU_TOPOLOGY", default="auto", values=None, kind="mode", scopes=("plan", "program", "aot"),
    key_params=("topo", "topology"), accessors=("topology_for", "resolve_topology"),
    help="two-tier topology: auto = a torchrun world's nodes (flat for one node), SxC = a simulated "
         "factorization of the world, flat",
))
declare(GateSpec(
    "HEAT_TPU_OOC", default="auto", values=("0", "1", "auto"), scopes=("plan", "aot"),
    key_params=("staged", "engaged"), accessors=("ooc_mode", "ooc_engaged"),
    help="out-of-core staging: 0 = never, 1 = always, auto = host-resident operands",
))
declare(GateSpec(
    "HEAT_TPU_OOC_SLAB_MB", default=str(256), kind="int", scopes=("plan", "aot"),
    key_params=("slab", "slab_bytes"), accessors=("slab_bytes",),
    help="card-memory slab (MiB) for the two staging windows in flight",
))
declare(GateSpec(
    "HEAT_TPU_HBM_BYTES", default=None, kind="bytes", scopes=("plan", "aot"),
    key_params=("hbm_bytes", "hbm_cap", "budget"), accessors=("capacity", "hbm_budget_bytes"),
    help="capacity of the card's memory tier; unset = the card's total memory (core.tiers)",
))
declare(GateSpec(
    "HEAT_TPU_HOST_BYTES", default=None, kind="bytes", scopes=("aot",),
    key_params=("host_bytes",), accessors=("capacity",),
    help="capacity of the host tier; unset = the host's physical memory (core.tiers)",
))
declare(GateSpec(
    "HEAT_TPU_LATTICE_PROFILE", default="", kind="path", scopes=("plan", "aot"),
    key_params=("profile_id", "calibration"), accessors=("active_profile", "profile_id"),
    help="a measured lattice-profile JSON: unset = core.tiers' rates; set = its measured edges price the "
         "plans and its profile_id goes into every plan_id; a bad profile is dropped",
))


def get(name: str, default: Optional[str] = None) -> Optional[str]:
    """The raw environment value of a declared gate (``os.environ.get(name,
    default)``); an undeclared name raises ``KeyError``."""
    if name not in GATES:
        raise KeyError(f"gates.get: {name!r} is not a declared gate; declare it in heat_tpu_torch/core/gates.py")
    return os.environ.get(name, default)


def is_set(name: str) -> bool:
    """Is the declared gate set in the environment?"""
    if name not in GATES:
        raise KeyError(f"gates.is_set: {name!r} is not a declared gate")
    return name in os.environ


def scope_gates(scope: str) -> Tuple[GateSpec, ...]:
    """The declared gates that are key material for ``scope``, by name."""
    if scope not in SCOPES:
        raise ValueError(f"unknown cache scope {scope!r} (one of {SCOPES})")
    return tuple(GATES[n] for n in sorted(GATES) if scope in GATES[n].scopes)


def program_gate_roster() -> str:
    """The sorted names of the declared gates whose value changes the
    plans, comma-joined."""
    return ",".join(n for n in sorted(GATES) if GATES[n].affects_programs)


def snapshot() -> Dict[str, Dict[str, object]]:
    """Every declared gate with its declaration and current raw value."""
    out = {}
    for name, spec in sorted(GATES.items()):
        raw = os.environ.get(name)
        out[name] = {
            "default": spec.default,
            "values": spec.values,
            "kind": spec.kind,
            "affects_programs": spec.affects_programs,
            "scopes": sorted(spec.scopes),
            "key_params": spec.key_params,
            "raw": raw,
            "set": name in os.environ,
            "recognized": spec.recognizes(raw),
            "help": spec.help,
        }
    return out
