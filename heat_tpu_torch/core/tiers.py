"""The memory tiers that out-of-core staging reads (port of the part of
``heat_tpu.core.tiers`` that ``redistribution.staging`` uses).

Two functions:

- ``capacity(tier)``: the bytes a memory tier holds, ``"hbm"`` (the
  card's memory) or ``"host"`` (the host's RAM). ``HEAT_TPU_HBM_BYTES`` and
  ``HEAT_TPU_HOST_BYTES`` override them; otherwise ``"hbm"`` is the total
  memory of the current card (``torch.cuda.get_device_properties``), or
  the host's physical memory when the port runs on the CPU, and ``"host"``
  the host's physical memory.
- ``transfer_time(nbytes, edge)``: seconds to move ``nbytes`` over the
  ``"hbm"`` edge (the card's memory stream) or the ``"pcie"`` edge (host to
  card), at an H100's rates: HBM3 at 3.35 TB/s, and the pinned host-to-card
  copy rate that ``chip_smoke.py`` measures.

``heat_tpu``'s topologies, its wire edges (``ici``, ``dcn``), the lattice
profiles and their calibration are ROADMAP.md Queue 1, item 12.
"""

from __future__ import annotations

import os

__all__ = ["EDGES", "HBM_BPS", "HBM_ENV", "HOST_ENV", "PCIE_BPS", "bandwidth", "capacity", "transfer_time"]

#: H100 SXM HBM3 stream rate, bytes/s
HBM_BPS = 3.35e12
#: pinned host-to-card copy rate, bytes/s: 49.49 GB/s, the plain copy of
#: one 128 MiB pinned buffer in ``chip_smoke.py``'s out-of-core phase
#: (NVIDIA H100 80GB HBM3, 700 W power limit)
PCIE_BPS = 49.49e9
#: edge name -> bytes/s
EDGES = {"hbm": HBM_BPS, "pcie": PCIE_BPS}

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
    if tier not in ("hbm", "host"):
        raise ValueError(f"capacity: {tier!r} is not a memory tier (one of 'hbm', 'host')")
    raw = os.environ.get(HBM_ENV if tier == "hbm" else HOST_ENV, "").strip()
    try:
        return max(1, int(raw))
    except ValueError:
        return _card_memory() if tier == "hbm" else _host_ram()


def bandwidth(edge: str) -> float:
    """Bytes/s of the edge ``"hbm"`` or ``"pcie"``."""
    if edge not in EDGES:
        raise ValueError(f"bandwidth: unknown edge {edge!r} (one of {tuple(EDGES)})")
    return EDGES[edge]


def transfer_time(nbytes: int, edge: str) -> float:
    """Seconds to move ``nbytes`` over ``edge`` at its rate."""
    return max(int(nbytes), 0) / bandwidth(edge)
