"""Printing of DNDarrays across ranks.

Port of ``heat_tpu.core.printing`` (Heat reference: heat/core/printing.py,
``local_printing`` :30, ``global_printing`` :62, ``print0`` :100,
``set_printoptions`` :150). The print profile is torch's (threshold 1000,
edge items 3, precision 4), and the body is ``np.array2string``'s, as in
``heat_tpu``. Above the threshold only the edge items reach the host:
each rank takes its rows among the first and last ``edgeitems`` of the
split axis (and the edge items of every other axis), one all-gather puts
them together, and one repeated row stands for the elided middle of each
long axis, which NumPy's summary never shows.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_printoptions", "global_printing", "local_printing", "print0", "set_printoptions"]

# torch's print profile (reference printing.py:14-28, ``heat_tpu`` :21-27)
__PRINT_OPTIONS = {
    "precision": 4,
    "threshold": 1000,
    "edgeitems": 3,
    "linewidth": 120,
    "sci_mode": None,
}

LOCAL_PRINT = False


def get_printoptions() -> dict:
    """The current print options (reference: printing.py:44)."""
    return dict(__PRINT_OPTIONS)


def local_printing() -> None:
    """Print each rank's own shard (reference: printing.py:30)."""
    global LOCAL_PRINT
    LOCAL_PRINT = True


def global_printing() -> None:
    """Print the global array (the default; reference: printing.py:62)."""
    global LOCAL_PRINT
    LOCAL_PRINT = False


def print0(*args, **kwargs) -> None:
    """``print`` on rank 0 only (reference: printing.py:100)."""
    from .communication import get_comm

    if get_comm().rank == 0:
        print(*args, **kwargs)


def set_printoptions(precision=None, threshold=None, edgeitems=None, linewidth=None, profile=None,
                     sci_mode=None) -> None:
    """Configure printing (reference: printing.py:150; ``heat_tpu`` :64)."""
    if profile is not None:
        if profile == "default":
            __PRINT_OPTIONS.update(precision=4, threshold=1000, edgeitems=3, linewidth=120)
        elif profile == "short":
            __PRINT_OPTIONS.update(precision=2, threshold=1000, edgeitems=2, linewidth=120)
        elif profile == "full":
            __PRINT_OPTIONS.update(precision=4, threshold=float("inf"), edgeitems=3, linewidth=120)
        else:
            raise ValueError(f"unknown profile {profile}")
    if precision is not None:
        __PRINT_OPTIONS["precision"] = int(precision)
    if threshold is not None:
        __PRINT_OPTIONS["threshold"] = threshold
    if edgeitems is not None:
        __PRINT_OPTIONS["edgeitems"] = int(edgeitems)
    if linewidth is not None:
        __PRINT_OPTIONS["linewidth"] = int(linewidth)
    if sci_mode is not None:
        __PRINT_OPTIONS["sci_mode"] = bool(sci_mode)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().resolve_conj().resolve_neg()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def __str__(dndarray) -> str:
    """``DNDarray(<body>, dtype=ht.<type>, device=<device>, split=<split>)``
    (``heat_tpu`` printing.py:88): the whole array up to the threshold,
    else its edge items (:func:`_edge_block`), on every rank."""
    opts = __PRINT_OPTIONS
    summarized = False
    if LOCAL_PRINT:
        data = _host(dndarray.larray)
    elif dndarray.size > opts["threshold"] and dndarray.ndim > 0:
        data = _edge_block(dndarray, opts["edgeitems"])
        summarized = True
    else:
        data = dndarray.numpy()
    # a pre-sliced edge block must still render with ellipses
    threshold = 1 if summarized and data.size > 1 else opts["threshold"]
    with np.printoptions(
        precision=opts["precision"],
        threshold=threshold,
        edgeitems=opts["edgeitems"],
        linewidth=opts["linewidth"],
        suppress=not opts["sci_mode"] if opts["sci_mode"] is not None else True,
    ):
        body = np.array2string(data, separator=", ")
    return f"DNDarray({body}, dtype=ht.{dndarray.dtype.__name__}, device={dndarray.device}, split={dndarray.split})"


def _edge_rows(n: int, e: int) -> np.ndarray:
    """The positions NumPy's summary shows along an axis of extent n."""
    return np.r_[0:e, n - e:n] if n > 2 * e else np.arange(n)


def _edge_block(dndarray, e: int) -> np.ndarray:
    """The edge items of ``dndarray`` on the host. Each rank selects, from
    its own shard, the edge positions of every axis (along the split axis
    those in its rows); one all-gather joins the ranks' pieces in rank
    order. Each axis longer than 2e gets one copy of its e-th item in the
    middle, so that the block is longer than 2e there and NumPy summarizes
    it as it would the whole array."""
    e = max(e, 1)  # with no edge items NumPy shows only the ellipsis
    t = dndarray.larray
    split = dndarray.split if dndarray.is_distributed() else None
    if split is not None:
        extents = dndarray.lshape_map[:, split]
        starts = np.concatenate([[0], np.cumsum(extents)])
        edges = _edge_rows(dndarray.gshape[split], e)
        counts = [int(((edges >= a) & (edges < a + c)).sum()) for a, c in zip(starts, extents)]
        lo = int(starts[dndarray.comm.rank])
    for d, n in enumerate(dndarray.gshape):
        rows = _edge_rows(n, e)
        if d == split:
            rows = rows[(rows >= lo) & (rows < lo + t.shape[d])] - lo
        t = t.index_select(d, torch.as_tensor(rows, dtype=torch.int64, device=t.device))
    if split is not None:
        t = dndarray.comm.allgather(t.contiguous(), split, counts)
    block = _host(t)
    for d, n in enumerate(dndarray.gshape):
        if n > 2 * e:
            block = np.insert(block, e, np.take(block, e, axis=d), axis=d)
    return block
