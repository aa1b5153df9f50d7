"""Out-of-core staging: operands larger than the card's memory (port of
``heat_tpu.redistribution.staging``).

An operand that lives in host memory, or in an HDF5 dataset, is held by a
:class:`HostArray`. The algorithms that read their operand in passes
(``hsvd_rank``'s sketches, ``svd``'s values, ``solve``'s right-hand
sides, ``KMeans``, ``pagerank_stream``, the encoders' ``stream_transform``)
consume it one window at a time:

- :func:`window_extents` cuts an axis into windows whose extents are
  multiples of ``GRAIN`` (only the last is ragged), each at most half the
  slab, so that two windows fit in it at once;
- :func:`plan_staged_passes` builds the ``host-staging`` plan: a
  ``stage_in`` step (tier ``"pcie"``) for each window of each pass and a
  ``stage_out`` for a pass that writes its windows back, with the
  ``staging`` annotation and its modeled times (``core.tiers``); the
  steps, windows, bytes and passes are ``heat_tpu``'s;
- :func:`prove_fits` holds the plan's peak (the bytes kept on the card
  across the loop plus two windows) under ``tiers.capacity("hbm")`` before
  a byte moves, and the operand under ``tiers.capacity("host")``;
- :func:`stream_windows` runs the depth-2 loop (its docstring);
- :func:`materialize` lands a whole ``HostArray`` on the card, the escape
  hatch of ``HEAT_TPU_OOC=0``, and raises ``MemoryError`` when it cannot
  fit.

The gate ``HEAT_TPU_OOC``: ``0`` never stages (a ``HostArray`` is
materialized whole where it fits), ``1`` also stages device operands on
the routes that have a staged form (``hsvd_rank``), ``auto`` (the default)
stages ``HostArray`` operands only. ``HEAT_TPU_OOC_SLAB_MB`` sets the
slab (default 256 MiB, at most a quarter of ``capacity("hbm")``).

The windows of ``hsvd_rank`` replay the 512-wide tiles of the in-memory
streams with explicit carries, so on the CPU the staged factors are those
of the in-memory route, bit for bit.

Not here: ``heat_tpu``'s telemetry counters, tracing probes and the plan
registry for attribution (ROADMAP.md Queue 1, item 13), and the golden
staged plans of its plan checks (item 14).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import gates as _gates
from .schedule import Schedule, Step
from .spec import RedistSpec

__all__ = [
    "DEFAULT_SLAB_MB",
    "GRAIN",
    "HostArray",
    "OOC_ENV",
    "SLAB_ENV",
    "materialize",
    "ooc_engaged",
    "ooc_mode",
    "plan_staged_passes",
    "prove_fits",
    "slab_bytes",
    "stream_windows",
    "window_extents",
]

OOC_ENV = "HEAT_TPU_OOC"
SLAB_ENV = "HEAT_TPU_OOC_SLAB_MB"

#: default slab for the two windows in flight, MiB
DEFAULT_SLAB_MB = 256

#: window grain along (axis 0, axis 1): the 512-wide tiles of the hSVD
#: streams (``svdtools._PASS_TILE``), so that a window holds whole tiles
GRAIN = (512, 512)


# --------------------------------------------------------------------- #
# the gate                                                              #
# --------------------------------------------------------------------- #
def ooc_mode() -> str:
    """``HEAT_TPU_OOC`` resolved to ``"0"``, ``"1"`` or ``"auto"``."""
    v = (_gates.get(OOC_ENV, "auto") or "").strip().lower()
    if v in ("0", "off", "false", "no"):
        return "0"
    if v in ("1", "on", "true", "force", "yes"):
        return "1"
    return "auto"


def ooc_engaged(nbytes: int, host_resident: bool = False) -> bool:
    """Whether the gate stages an operand: always under ``1``, a
    host-resident one under ``auto``, never under ``0``. ``nbytes`` is
    ``heat_tpu``'s argument and decides nothing."""
    mode = ooc_mode()
    if mode == "0":
        return False
    return mode == "1" or bool(host_resident)


def slab_bytes(override: Optional[int] = None) -> int:
    """The slab for the two windows in flight: ``override`` bytes, else
    ``HEAT_TPU_OOC_SLAB_MB`` MiB (default 256), at least 1 MiB and at most a
    quarter of ``tiers.capacity("hbm")``."""
    from ..core import tiers

    if override is not None:
        return max(1, int(override))
    raw = (_gates.get(SLAB_ENV, "") or "").strip()
    try:
        mb = int(raw) if raw else DEFAULT_SLAB_MB
    except ValueError:
        mb = DEFAULT_SLAB_MB
    return max(1 << 20, min(max(1, mb) << 20, tiers.capacity("hbm") // 4))


# --------------------------------------------------------------------- #
# host-resident operands                                                #
# --------------------------------------------------------------------- #
class HostArray:
    """A 2-D operand in host memory (a C-contiguous numpy array) or in an
    HDF5 dataset (``from_hdf5``, read window by window), which the staged
    routes stream through the card instead of landing it whole."""

    def __init__(self, data: Any, dtype=None):
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data if dtype is None else data.astype(dtype, copy=False))
        elif dtype is not None and np.dtype(getattr(data, "dtype", dtype)) != np.dtype(dtype):
            raise TypeError(f"HostArray: a dtype override takes numpy data only (got {type(data).__name__})")
        shape = tuple(int(s) for s in data.shape)
        if len(shape) != 2:
            raise ValueError(f"HostArray serves 2-D operands, got shape {shape}")
        self._data = data
        self.shape = shape
        self.dtype = np.dtype(data.dtype)

    @classmethod
    def from_hdf5(cls, path: str, dataset: str) -> "HostArray":
        """The dataset ``dataset`` of the HDF5 file ``path``, read one window
        at a time."""
        import h5py

        return cls(h5py.File(path, "r")[dataset])

    @property
    def ndim(self) -> int:
        return 2

    @property
    def nbytes(self) -> int:
        return self.shape[0] * self.shape[1] * self.dtype.itemsize

    def window(self, axis: int, start: int, stop: int) -> np.ndarray:
        """Rows (``axis`` 0) or columns (``axis`` 1) ``start:stop`` as a host
        array: a view of numpy data, read from an HDF5 dataset."""
        sl = (slice(start, stop), slice(None)) if axis == 0 else (slice(None), slice(start, stop))
        return np.asarray(self._data[sl])

    def __repr__(self) -> str:
        return f"HostArray(shape={self.shape}, dtype={self.dtype.name}, tier=host)"


# --------------------------------------------------------------------- #
# window geometry                                                       #
# --------------------------------------------------------------------- #
def window_extents(shape, itemsize: int, axis: int, slab: int, grain: Optional[int] = None) -> List[Tuple[int, int]]:
    """``(start, stop)`` windows along ``axis``: widths a multiple of the
    grain (``GRAIN[axis]``), each window at most half of ``slab`` bytes,
    only the last ragged. Where one grain alone exceeds half the slab the
    windows are one grain wide, and ``prove_fits`` decides."""
    extent, other = int(shape[axis]), int(shape[1 - axis])
    g = int(GRAIN[axis] if grain is None else grain)
    per_window = max(1, (int(slab) // 2) // max(other * int(itemsize), 1))
    width = max(g, per_window // g * g)
    out: List[Tuple[int, int]] = []
    start = 0
    while start + width <= extent:
        out.append((start, start + width))
        start += width
    if start < extent or not out:
        out.append((start, extent))
    return out


def _win_bytes(shape, itemsize: int, axis: int, win: Tuple[int, int]) -> int:
    return (win[1] - win[0]) * int(shape[1 - axis]) * int(itemsize)


# --------------------------------------------------------------------- #
# the staged plan                                                       #
# --------------------------------------------------------------------- #
def plan_staged_passes(
    shape,
    dtype,
    passes: Sequence[Dict[str, Any]],
    *,
    slab: Optional[int] = None,
    out_bytes: int = 0,
    mesh_size: int = 1,
    hbm_bytes: Optional[int] = None,
) -> Schedule:
    """The ``host-staging`` plan of ``passes`` over a host-resident operand
    of ``shape`` and ``dtype`` (``heat_tpu`` staging.py:249): each pass
    ``{"tag", "axis", "writeback"?}`` gives one ``stage_in`` a window (its
    ``peak_bytes`` the window and the next one, in flight at depth 2) and a
    ``stage_out`` a window when it writes back. ``out_bytes`` is what stays
    on the card across the loop (the annotation's ``resident_bytes``).

    The annotation prices the streamed bytes at ``tiers.transfer_time``
    over ``pcie`` and over ``hbm``, and at depth 2 the critical path
    ``max(pcie, hbm) + min(pcie, hbm) / n``; its ``hbm_capacity_bytes``
    is ``hbm_bytes``, else ``tiers.capacity("hbm")``. These carry this
    card's numbers, so they and the ``plan_id`` differ from ``heat_tpu``'s;
    the steps, windows, bytes and passes are the same."""
    from ..core import tiers

    shape = tuple(int(s) for s in shape)
    if len(shape) != 2:
        raise ValueError(f"plan_staged_passes serves 2-D operands, got {shape}")
    dtype = np.dtype(dtype)
    slab_b = slab_bytes(slab)
    hbm_cap = tiers.capacity("hbm") if hbm_bytes is None else max(1, int(hbm_bytes))
    spec = RedistSpec.normalize(shape, dtype.name, None, None, int(mesh_size))
    steps: List[Step] = []
    pass_meta: List[Dict[str, Any]] = []
    pcie_total = max_window = 0
    for p in passes:
        axis = int(p["axis"])
        tag = str(p.get("tag", f"pass{len(pass_meta)}"))
        writeback = bool(p.get("writeback", False))
        wins = window_extents(shape, dtype.itemsize, axis, slab_b)
        wb = [_win_bytes(shape, dtype.itemsize, axis, w) for w in wins]
        max_window = max(max_window, max(wb))
        n = len(wins)
        for k, (w, b) in enumerate(zip(wins, wb)):
            occupancy = b + (wb[k + 1] if k + 1 < n else 0)
            steps.append(Step("stage_in", bytes_moved=b, peak_bytes=occupancy,
                              detail=f"{tag}: window {k}/{n} axis-{axis} [{w[0]}:{w[1]}) host->hbm (depth-2 prefetch)",
                              chunk=k, overlap=tag if n > 1 else None, tier="pcie"))
            if writeback:
                steps.append(Step("stage_out", bytes_moved=b, peak_bytes=occupancy,
                                  detail=f"{tag}: window {k}/{n} result hbm->host",
                                  chunk=k, overlap=tag if n > 1 else None, tier="pcie"))
            pcie_total += b * (2 if writeback else 1)
        pass_meta.append({"tag": tag, "axis": axis, "n_windows": n, "window_bytes": max(wb),
                          "pcie_bytes": sum(wb) * (2 if writeback else 1), "writeback": writeback})
    n_total = sum(pm["n_windows"] for pm in pass_meta)
    pcie_s = round(tiers.transfer_time(pcie_total, "pcie"), 9)
    hbm_s = round(tiers.transfer_time(pcie_total, "hbm"), 9)
    seq_s = pcie_s + hbm_s
    cp_s = max(pcie_s, hbm_s) + min(pcie_s, hbm_s) / max(n_total, 1)
    annotation = {
        "depth": 2,
        "grain": [int(GRAIN[0]), int(GRAIN[1])],
        "passes": pass_meta,
        "n_windows": n_total,
        "window_bytes": max_window,
        "slab_bytes": slab_b,
        "resident_bytes": int(out_bytes),
        "host_bytes": spec.logical_bytes,
        "hbm_capacity_bytes": hbm_cap,
        "model": {
            "pcie_s": pcie_s,
            "hbm_s": hbm_s,
            "sequential_s": round(seq_s, 9),
            "critical_path_s": round(cp_s, 9),
            "model_speedup": round(seq_s / cp_s, 4) if cp_s else 1.0,
            "bound_gbps": round(pcie_total / cp_s / 1e9, 3) if cp_s else 0.0,
        },
    }
    notes = (f"out-of-core staging: {len(pass_meta)} pass(es) over a {spec.logical_bytes} B host-resident operand "
             "through a depth-2 double-buffered HBM slab (HEAT_TPU_OOC)")
    return Schedule(spec, "host-staging", steps, slab_b, notes=notes, staging=annotation,
                    calibration=tiers.profile_annotation())


def prove_fits(sched: Schedule, hbm_bytes: Optional[int] = None) -> Schedule:
    """``sched`` if its peak (``liveness_peak_bytes``) fits
    ``tiers.capacity("hbm")`` (or ``hbm_bytes``) and its operand
    ``tiers.capacity("host")``; else ``MemoryError`` naming the numbers."""
    from ..core import tiers

    budget = tiers.capacity("hbm") if hbm_bytes is None else max(1, int(hbm_bytes))
    live = sched.liveness_peak_bytes
    if live > budget:
        raise MemoryError(
            f"staged plan {sched.plan_id} needs {live} B of HBM (resident {sched.resident_bytes} B + slab peak "
            f"{sched.peak_bytes} B) > capacity('hbm') = {budget} B — shrink {SLAB_ENV} or the working set"
        )
    if sched.staging and int(sched.staging["host_bytes"]) > tiers.capacity("host"):
        raise MemoryError(
            f"staged plan {sched.plan_id} keeps {sched.staging['host_bytes']} B on the host tier > "
            f"capacity('host') = {tiers.capacity('host')} B"
        )
    return sched


def materialize(host: HostArray, what: str = "operand"):
    """The whole of ``host`` as a DNDarray, split None, on the default
    device (``HEAT_TPU_OOC=0``'s escape hatch, and the route of what the
    staged streams do not serve); ``MemoryError`` when it exceeds
    ``tiers.capacity("hbm")``."""
    from ..core import factories, tiers

    if host.nbytes > tiers.capacity("hbm"):
        raise MemoryError(
            f"{what}: host-resident operand is {host.nbytes} B > tiers.capacity('hbm') = {tiers.capacity('hbm')} B "
            f"and staging is not engaged ({OOC_ENV}={ooc_mode()!r}) — the staged window stream is the only way to "
            "run it"
        )
    return factories.array(host.window(0, 0, host.shape[0]), split=None)


# --------------------------------------------------------------------- #
# the executor                                                          #
# --------------------------------------------------------------------- #
def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def stream_windows(
    host: HostArray,
    axis: int,
    windows: Sequence[Tuple[int, int]],
    consume: Callable[[int, torch.Tensor, Tuple[int, int]], None],
    device: Optional[torch.device] = None,
) -> None:
    """Call ``consume(k, window, (start, stop))`` for each of ``windows``
    along ``axis`` of ``host``, the window a tensor on ``device`` (default:
    the port's device).

    On the CPU each window is a ``torch.from_numpy`` view of the host data.
    On a card the loop is depth 2: two pinned host buffers; window k + 1
    is gathered into one of them while window k is consumed, and copied to
    the card with ``non_blocking=True`` on a side stream; the default
    stream waits on that copy's event before its ``consume``, and the
    window's memory is kept for the default stream (``record_stream``). A
    pinned buffer is refilled only after the copy that last read it has
    completed. ``consume`` should leave the host free (no reads of device
    values) so that the next window's host gather overlaps its work."""
    windows = list(windows)
    if not windows:
        return
    if device is None:
        from ..core.devices import get_device

        device = get_device().torch_device
    if device.type != "cuda":
        for k, win in enumerate(windows):
            consume(k, torch.from_numpy(host.window(axis, *win)), win)
        return
    tdtype = _torch_dtype(host.dtype)
    cap = max(_win_bytes(host.shape, host.dtype.itemsize, axis, w) for w in windows)
    pinned = [torch.empty(cap, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    copied: List[Optional[torch.cuda.Event]] = [None, None]
    side = torch.cuda.Stream(device)
    main = torch.cuda.current_stream(device)

    def stage_in(k: int):
        start, stop = windows[k]
        shape = (stop - start, host.shape[1]) if axis == 0 else (host.shape[0], stop - start)
        slot = k % 2
        if copied[slot] is not None:
            copied[slot].synchronize()  # the copy that last read this buffer is done
        buf = pinned[slot][: _win_bytes(host.shape, host.dtype.itemsize, axis, windows[k])].view(tdtype).view(shape)
        buf.copy_(torch.from_numpy(host.window(axis, start, stop)))  # the host gather, on torch's CPU threads
        with torch.cuda.stream(side):
            dev = torch.empty(shape, dtype=tdtype, device=device)
            dev.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        copied[slot] = event
        return dev, event

    nxt = stage_in(0)
    for k, win in enumerate(windows):
        cur, event = nxt
        main.wait_event(event)
        cur.record_stream(main)
        consume(k, cur, win)
        del cur
        if k + 1 < len(windows):
            nxt = stage_in(k + 1)
