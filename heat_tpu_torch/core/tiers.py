"""The memory-tier lattice: what a tier holds and what moving bytes across
an edge costs (port of ``heat_tpu.core.tiers``).

Memory tiers, nearest first: ``hbm`` (the card's memory) and ``host`` (the
host's RAM). Edges: ``hbm`` (the card's memory stream), ``pcie`` (host to
card), ``ici`` (card to card within a node), ``dcn`` (card to card across
nodes) and ``disk`` (host to a durable store).

- ``capacity(tier)``: the bytes of ``"hbm"`` or ``"host"``.
  ``HEAT_TPU_HBM_BYTES`` and ``HEAT_TPU_HOST_BYTES`` override them;
  otherwise ``"hbm"`` is the total memory of the current card
  (``torch.cuda.get_device_properties``), or the host's physical memory
  when the port runs on the CPU, and ``"host"`` the host's physical memory.
- ``bandwidth(edge)``, ``transfer_time(nbytes, edge)``,
  ``sparse_transfer_time``, ``penalty(edge)`` (an edge byte in ``ici``
  bytes, floored, at least 1), ``edge_between(a, b)``, ``describe()``.

The rates are an H100 SXM node's (NVIDIA H100 80GB HBM3 at its 700 W
limit). ``hbm``, ``ici`` and ``dcn`` are NVIDIA's specification figures,
not measurements: HBM3 at 3.35 TB/s; NVLink 4 at 900 GB/s a card, both
directions together, as ``ici``; one 400 Gb/s NDR InfiniBand port a card,
100 GB/s both directions together, as ``dcn``, so ``penalty("dcn")`` is 9.
``pcie`` and ``disk`` were measured by ``chip_smoke.py`` on that card: the
plain copy of one 128 MiB pinned buffer to the card, and a durable commit
(write, ``fsync``, rename) of a 256 MiB file on the card's host.

``HEAT_TPU_LATTICE_PROFILE`` names a measured lattice profile (the JSON
envelope ``heat_tpu.observability.calibration`` writes). Loaded and checked
here as ``heat_tpu`` loads it (the same digest, so one file gives both
packages the same ``profile_id``), its measured edges replace the rates
above, and the planner stamps its ``profile_annotation()`` into every plan.
A missing, unreadable, tampered or other-format profile is dropped (the
file is removed unless missing) and the rates above stand.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Tuple

from . import gates as _gates

__all__ = [
    "DCN_BPS",
    "DISK_BPS",
    "EDGES",
    "HBM_BPS",
    "HBM_ENV",
    "HOST_ENV",
    "ICI_BPS",
    "MEMORY_TIERS",
    "PCIE_BPS",
    "TIERS",
    "active_profile",
    "bandwidth",
    "capacity",
    "describe",
    "edge_between",
    "load_profile",
    "penalty",
    "profile_annotation",
    "profile_digest",
    "profile_id",
    "reload_profile",
    "sparse_transfer_time",
    "transfer_time",
]

#: every tier a byte lives on or crosses, nearest first (``ici``/``dcn``
#: carry bytes between the cards' memories; they hold nothing)
TIERS: Tuple[str, ...] = ("hbm", "host", "ici", "dcn")
#: the tiers with a capacity
MEMORY_TIERS: Tuple[str, ...] = ("hbm", "host")

#: H100 SXM HBM3 stream rate, bytes/s (specification)
HBM_BPS = 3.35e12
#: pinned host-to-card copy rate, bytes/s: 49.49 GB/s, the plain copy of
#: one 128 MiB pinned buffer in ``chip_smoke.py``'s out-of-core phase
#: (NVIDIA H100 80GB HBM3, 700 W power limit)
PCIE_BPS = 49.49e9
#: NVLink 4 per H100 SXM, both directions together, bytes/s (specification)
ICI_BPS = 900e9
#: one 400 Gb/s NDR InfiniBand port per card, both directions together,
#: bytes/s (specification)
DCN_BPS = 100e9
#: a durable commit (write, fsync, rename) of a 256 MiB file on the card's
#: host, bytes/s: 0.9209 GB/s, ``chip_smoke.py``'s wire phase (median of 3;
#: NVIDIA H100 80GB HBM3, 700 W power limit)
DISK_BPS = 0.9209e9

#: edge name -> (near tier, far tier, bytes/s); the names are what
#: ``Step.tier`` carries
EDGES: Dict[str, Tuple[str, str, float]] = {
    "hbm": ("hbm", "hbm", HBM_BPS),
    "pcie": ("hbm", "host", PCIE_BPS),
    "ici": ("hbm", "hbm", ICI_BPS),
    "dcn": ("hbm", "hbm", DCN_BPS),
    "disk": ("host", "disk", DISK_BPS),
}

HBM_ENV = "HEAT_TPU_HBM_BYTES"
HOST_ENV = "HEAT_TPU_HOST_BYTES"


def _host_ram() -> int:
    return int(os.sysconf("SC_PAGE_SIZE")) * int(os.sysconf("SC_PHYS_PAGES"))


def _card_memory() -> int:
    """Total memory of the current card, or the host's RAM when the port
    runs on the CPU."""
    from .devices import get_device

    device = get_device().torch_device
    if device.type == "cuda":
        import torch

        return int(torch.cuda.get_device_properties(device).total_memory)
    return _host_ram()


def capacity(tier: str) -> int:
    """Bytes of the memory tier ``"hbm"`` or ``"host"`` (module
    docstring); an override that does not parse as an integer is
    ignored."""
    if tier not in MEMORY_TIERS:
        raise ValueError(
            f"capacity: {tier!r} is not a memory tier (one of {MEMORY_TIERS}; the wire edges carry bytes)"
        )
    raw = (_gates.get(HBM_ENV if tier == "hbm" else HOST_ENV, "") or "").strip()
    try:
        return max(1, int(raw))
    except ValueError:
        return _card_memory() if tier == "hbm" else _host_ram()


# --------------------------------------------------------------------- #
# measured lattice profiles                                             #
# --------------------------------------------------------------------- #
#: the envelope format ``heat_tpu.observability.calibration`` writes
_FORMAT = 1

_profile_cache: Tuple[Optional[str], Optional[dict]] = (None, None)


def profile_digest(platform: str, topology: str, edges: Dict[str, Any]) -> str:
    """sha256 prefix of the canonical measurement content: format,
    platform, topology and the per-edge records (sorted keys, compact
    separators), as ``heat_tpu``'s ``calibration.profile_digest``."""
    content = {"format": _FORMAT, "platform": platform, "topology": topology, "edges": edges}
    blob = json.dumps(content, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _evict(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def load_profile(path: str) -> Optional[Dict[str, Any]]:
    """The checked profile envelope at ``path``, or None: a missing file,
    an unreadable one or one with an unknown edge or a rate not above 0,
    another format, or a digest that is not its ``profile_id`` (each but
    the first removed), as ``heat_tpu``'s ``calibration.load_profile``."""
    path = os.path.expanduser(str(path))
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError("not an object")
        edges = doc["edges"]
        if not isinstance(edges, dict) or not edges:
            raise ValueError("no edges")
        for name, rec in edges.items():
            if name not in EDGES:
                raise ValueError(f"unknown edge {name!r}")
            if not float(rec["bps"]) > 0:
                raise ValueError(f"edge {name!r} bps not positive")
        fmt = doc["format"]
        platform, topology = str(doc["platform"]), str(doc["topology"])
        pid = str(doc["profile_id"])
    except Exception:  # noqa: BLE001 (any unreadable profile is dropped, never an error)
        _evict(path)
        return None
    if fmt != _FORMAT or profile_digest(platform, topology, edges) != pid:
        _evict(path)
        return None
    return doc


def active_profile() -> Optional[dict]:
    """The profile that ``HEAT_TPU_LATTICE_PROFILE`` names, or None when
    the gate is unset or the profile was dropped; cached on the gate's raw
    value."""
    global _profile_cache
    raw = _gates.get("HEAT_TPU_LATTICE_PROFILE", "") or ""
    cached_raw, cached = _profile_cache
    if raw == cached_raw:
        return cached
    profile = load_profile(raw.strip()) if raw.strip() else None
    _profile_cache = (raw, profile)
    return profile


def reload_profile() -> Optional[dict]:
    """Drop the cached profile and read the gate again (a profile saved
    anew under the same path)."""
    global _profile_cache
    _profile_cache = (None, None)
    return active_profile()


def profile_id() -> Optional[str]:
    """The active profile's ``profile_id``, or None under the rates above."""
    profile = active_profile()
    return profile["profile_id"] if profile else None


def profile_annotation() -> Optional[dict]:
    """``{"profile_id", "edges": {edge: bytes/s}}`` of every edge under the
    active profile (measured or not), the ``calibration`` annotation of a
    plan priced under it; None under the rates above."""
    pid = profile_id()
    if pid is None:
        return None
    return {"profile_id": pid, "edges": {e: bandwidth(e) for e in sorted(EDGES)}}


# --------------------------------------------------------------------- #
# edge pricing                                                          #
# --------------------------------------------------------------------- #
def bandwidth(edge: str) -> float:
    """Bytes/s of ``edge``: the active profile's measured rate where it has
    one, else the rate above."""
    if edge not in EDGES:
        raise ValueError(f"bandwidth: unknown edge {edge!r} (one of {tuple(EDGES)})")
    profile = active_profile()
    if profile is not None:
        rec = profile["edges"].get(edge)
        if rec is not None and rec.get("bps"):
            return float(rec["bps"])
    return EDGES[edge][2]


def transfer_time(nbytes: int, edge: str) -> float:
    """Seconds to move ``nbytes`` over ``edge`` at its rate."""
    return max(int(nbytes), 0) / bandwidth(edge)


def sparse_transfer_time(nnz: int, itemsize: int, edge: str) -> float:
    """Seconds to move a sparse operand of ``nnz`` stored elements over
    ``edge``: each element's value and its int32 column index."""
    return transfer_time(max(int(nnz), 0) * (int(itemsize) + 4), edge)


def penalty(edge: str) -> int:
    """An ``edge`` byte's cost in ``ici`` bytes: ``bandwidth("ici") /
    bandwidth(edge)``, floored, at least 1 (9 for ``dcn`` at the rates
    above)."""
    return max(1, int(bandwidth("ici") / bandwidth(edge)))


def edge_between(a: str, b: str) -> Optional[str]:
    """The edge joining two adjacent memory tiers (``hbm``/``host`` ->
    ``"pcie"``), or None."""
    pair = {a, b}
    for name, (near, far, _) in EDGES.items():
        if near != far and {near, far} == pair:
            return name
    return None


def describe() -> str:
    """The lattice as text: capacities, edges, rates and penalties."""
    pid = profile_id()
    lines = [f"memory-tier lattice (hbm -> host; ici/dcn off hbm; {f'profile {pid}' if pid else 'rates'}):"]
    for tier in MEMORY_TIERS:
        lines.append(f"  {tier:>5}: capacity {capacity(tier)} B  ({HBM_ENV if tier == 'hbm' else HOST_ENV})")
    for name, (near, far, default_bps) in EDGES.items():
        bps = bandwidth(name)
        mark = "" if bps == default_bps else f"  [measured; rate {default_bps / 1e9:.1f}]"
        lines.append(f"  edge {name:>4}: {near}<->{far}  {bps / 1e9:.1f} GB/s  (penalty {penalty(name)}x vs ici){mark}")
    return "\n".join(lines)
