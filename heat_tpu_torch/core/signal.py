"""Signal processing: the 1-D convolution across ranks (port of
``heat_tpu.core.signal``; Heat reference: heat/core/signal.py, ``convolve``).

Every mode is a valid convolution of the input extended by zeros, k − 1
rows in all for ``full``, k // 2 before and the rest after for ``same``
(``heat_tpu`` signal.py:91-93). Across ranks the extension lies on the
first and last ranks that hold rows (``manipulations.pad``); each rank then
fetches the k − 1 rows after its block from the ranks after it, one
``comm.permute`` a hop (more than one hop only where k − 1 exceeds the
next ranks' rows), and convolves its rows alone: output row g is computed
by the rank that holds extended row g, so the result keeps the input's
rows where they fall. The kernel ``v`` is short and whole on every rank.

The local convolution is ``torch.nn.functional.conv1d`` (a correlation, so
the kernel flipped) over rows of 2^23 outputs: ``heat_tpu`` calls
``jnp.convolve`` (XLA, no Pallas kernel) at ``Precision.HIGHEST``. On a
card it is cuDNN's, with its TF32 switch off around the call, so float32
runs in full FP32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import types
from .dndarray import DNDarray

__all__ = ["convolve"]


ROW = 1 << 23  # outputs a row of the batched convolution


def _valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The valid convolution of the 1-D ``x`` with the 1-D ``w``: one
    ``conv1d`` over rows of at most ``ROW`` outputs, each row a window of x
    with its k − 1 samples of overlap (cuDNN runs such a batch of rows
    faster than one long row, with the same sums)."""
    k = w.shape[0]
    n = x.shape[0] - k + 1
    if n <= 0:
        return x[:0]
    wf = w.flip(0).view(1, 1, -1)
    row = min(ROW, n)
    rows = -(-n // row)
    total = rows * row + k - 1
    ext = x if total == x.shape[0] else torch.nn.functional.pad(x, (0, total - x.shape[0]))
    windows = ext.unfold(0, row + k - 1, row).unsqueeze(1)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.nn.functional.conv1d(windows, wf).reshape(-1)[:n]
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _fetch_after(comm, x: torch.Tensor, counts, need) -> torch.Tensor:
    """The rows each rank needs after its block, ``need[q]`` for rank q
    (global rows [end_q, end_q + need[q])), from the ranks after it: one
    permute a hop, hop j carrying rank q + j's part to rank q."""
    from .manipulations import _starts

    p, r = comm.size, comm.rank
    st = _starts(counts)
    # the farthest hop any rank needs: to the rank that holds its last row
    last = [int(np.searchsorted(st, st[q + 1] + need[q] - 1, side="right")) - 1 - q if need[q] else 0
            for q in range(p)]
    got = []
    for j in range(1, max(last) + 1):
        hops = []  # (rank q + j, rank q, its first local row, rows): rank q + j's part of rank q's need
        for q in range(p - j):
            a, b = max(st[q + 1], st[q + j]), min(st[q + 1] + need[q], st[q + j + 1])
            if a < b:
                hops.append((q + j, q, int(a - st[q + j]), int(b - a)))
        if not hops:
            continue
        send = x.new_zeros(max(h[3] for h in hops))
        for src, _, first, n in hops:
            if src == r:
                send[:n] = x[first : first + n]
        recv = comm.permute(send, [(src, dst) for src, dst, _, _ in hops])
        got += [recv[:n] for _, dst, _, n in hops if dst == r]
    return torch.cat(got) if got else x[:0]


def convolve(a: DNDarray, v: DNDarray, mode: str = "full") -> DNDarray:
    """1-D convolution of ``a`` with ``v`` in mode ``full``, ``same`` or
    ``valid`` (``heat_tpu`` signal.py:59): the longer operand is the signal
    (``heat_tpu``'s swap, :74-75) and the result is split like it. Integer
    operands are computed in ``heat_tpu``'s compute type (the promoted
    type with float32) and rounded back; bools give float32. Across ranks:
    the zero extension on the end ranks, one permute a hop for the k − 1
    rows after each rank's block, and a local valid convolution; the
    result's rows stay where the signal's fall."""
    from . import factories
    from ._operations import _whole
    from .manipulations import _dnd, _starts, pad

    if not isinstance(a, DNDarray):
        a = factories.array(a)
    if not isinstance(v, DNDarray):
        v = factories.array(v, device=a.device, comm=a.comm)
    if a.ndim != 1 or v.ndim != 1:
        raise ValueError("only 1-dimensional input arrays are allowed")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unsupported mode {mode!r}, use full/same/valid")
    if mode == "same" and v.shape[0] % 2 == 0:
        raise ValueError("mode 'same' cannot be used with even-sized kernel")
    if a.shape[0] < v.shape[0]:
        a, v = v, a
    n, k = a.shape[0], v.shape[0]
    if k == 0:
        raise ValueError(f"convolve: inputs cannot be empty, got shapes ({n},) and ({k},).")
    promoted = types.promote_types(a.dtype, v.dtype)
    exact = types.heat_type_is_exact(promoted)
    compute = types.promote_types(promoted, types.float32) if exact or promoted is types.bool else promoted
    tt = compute.torch_type()
    left = {"full": k - 1, "same": k // 2, "valid": 0}[mode]
    right = {"full": k - 1, "same": k - 1 - k // 2, "valid": 0}[mode]
    out_len = n + left + right - (k - 1)
    w = _whole(v).to(device=a.larray.device, dtype=tt)
    counts = None
    if a.is_distributed():
        ext = pad(a.astype(compute), (left, right))
        ext_counts = ext.lshape_map[:, 0]
        st = _starts(ext_counts)
        counts = np.array([max(0, min(st[q + 1], out_len) - st[q]) for q in range(a.comm.size)], dtype=np.int64)
        need = [int(st[q] + counts[q] + k - 1 - st[q + 1]) if counts[q] else 0 for q in range(a.comm.size)]
        need = [max(0, m) for m in need]
        x = ext.larray
        x = torch.cat([x, _fetch_after(a.comm, x, ext_counts, need)])
        result = _valid(x[: int(counts[a.comm.rank]) + k - 1], w)
    else:
        x = torch.nn.functional.pad(a.larray.to(tt), (left, right))
        result = _valid(x, w)
    dtype = compute
    if exact:
        result = torch.round(result).to(promoted.torch_type())
        dtype = promoted
    return _dnd(result, (out_len,), dtype, a.split, a, counts)
