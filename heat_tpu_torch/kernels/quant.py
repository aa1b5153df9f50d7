"""The block codec of the wire: kernel pair Q1, its plain version, the
quantized all-reduces and the step models (port of
``heat_tpu.kernels.quant``).

Wire format of mode ``"int8"``: the flat float32 payload of each row is
tiled in blocks of ``TILE`` = 1024 elements; each tile carries one float32
scale, ``finite-absmax / 126`` (1 for a tile of zeros), stored as raw bytes
after the int8 payload. A finite value's code is ``rint(x / scale)``
clipped to ±126 (error at most ``scale / 2``, under ``tolerance("int8") =
2**-7`` of the tile's absmax); NaN is −128, +inf 127, −inf −127, so they
come back exactly; −0.0 comes back +0.0. ``wire_bytes(n)`` =
``pad1024(n) + 4·pad1024(n)/1024``, about 0.251 of the 4·n raw bytes.

Mode ``"bf16"`` is the round-to-nearest-even cast to bfloat16 sent as its
raw bytes (ratio 0.5, ``tolerance("bf16") = 2**-8`` of |x|): ATen's cast
viewed as int8, no kernel (on the CPU a NaN's word written as XLA writes
it).

``encode_blocks(x, mode)`` turns a ``(B, n)`` float32 tensor into its
``(B, wire_bytes(n))`` int8 wire rows, each decodable alone (the
executor's per-destination blocks); ``decode_blocks(w, n, mode)`` inverts
it. On a CUDA tensor the int8 mode launches Q1 (``csrc/quant.cu``: encode
and decode, one launch each a call) or raises; on a CPU tensor it runs the
plain version, ``heat_tpu``'s formulation in torch. Each launch adds one to
``ENCODE_LAUNCHES`` or ``DECODE_LAUNCHES``. Every call runs under the
profiler scope ``wire_codec_<mode>``.

``quantized_allreduce_sum(h, comm, mode)`` sums a flat float32 vector over
the ranks with encoded payloads: one all-to-all of the encoded blocks
(rank q sums the p partials of block q in float32), one all-gather of the
re-encoded reduced blocks; two encodes and four decodes. It returns the
sum and this rank's error-feedback residual (the encode error of its own
contribution plus, on the block it owns, that of the reduced block).
``hierarchical_allreduce_sum(h, comm, S, C, mode)`` is the two-tier form:
an all-to-all within the node in float32, an all-gather across the nodes
of the encoded node-reduced block, an all-gather within the node in
float32; its residual is the encode error of the block it shipped.

``dp_step_model`` and ``dp_step_model_2tier`` are ``heat_tpu``'s analytic
data-parallel step models, their default rates ``core.tiers``' ``ici`` and
``dcn``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

__all__ = [
    "DECODE_LAUNCHES",
    "ENCODE_LAUNCHES",
    "MODES",
    "TILE",
    "compose_tolerance",
    "decode_blocks",
    "decode_int8_plain",
    "dp_step_model",
    "dp_step_model_2tier",
    "encode_blocks",
    "encode_int8_plain",
    "hierarchical_allreduce_sum",
    "quantized_allreduce_sum",
    "tolerance",
    "wire_bytes",
    "wire_ratio",
]

#: elements a scale tile
TILE = 1024

#: the wire codecs
MODES = ("int8", "bf16")

#: Q1 launches since the counts were last set to 0
ENCODE_LAUNCHES = 0
DECODE_LAUNCHES = 0

_QMAX = 126
_NAN = -128
_PINF = 127
_NINF = -127

#: the bound of each mode: |x - decode(encode(x))| <= tol * absmax of the
#: tile (int8) or of |x| (bf16), for finite x
_TOL = {"int8": 2.0**-7, "bf16": 2.0**-8}

_count_lock = threading.Lock()


def _check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown wire codec {mode!r} (modes: {MODES})")
    return mode


def tolerance(mode: str) -> float:
    """The bound of ``mode`` relative to the governing absmax."""
    return _TOL[_check_mode(mode)]


def compose_tolerance(tols) -> float:
    """The bound of a payload element that crosses codec legs of tolerances
    ``tols``, to first order: their sum (0.0 for none)."""
    return float(sum(float(t) for t in tols))


def _pad_tiles(n: int) -> int:
    return -(-int(n) // TILE) * TILE


def wire_bytes(n_elems: int, mode: str) -> int:
    """Encoded bytes of ``n_elems`` float32 elements."""
    _check_mode(mode)
    n = int(n_elems)
    if n <= 0:
        return 0
    if mode == "bf16":
        return 2 * n
    npad = _pad_tiles(n)
    return npad + 4 * (npad // TILE)


def wire_ratio(n_elems: int, mode: str) -> float:
    """``wire_bytes / (4 · n_elems)`` (about 0.251 for int8, 0.5 for bf16)."""
    n = int(n_elems)
    if n <= 0:
        return 1.0
    return wire_bytes(n, mode) / (4.0 * n)


# --------------------------------------------------------------------- #
# the plain version                                                     #
# --------------------------------------------------------------------- #
def encode_int8_plain(x: torch.Tensor) -> torch.Tensor:
    """Q1's encode in torch ops, ``heat_tpu``'s ``_encode_int8``: (B, n)
    float32 -> (B, wire_bytes(n)) int8."""
    B, n = x.shape
    npad = _pad_tiles(n)
    nt = npad // TILE
    xp = torch.nn.functional.pad(x, (0, npad - n)) if npad != n else x
    xt = xp.reshape(B, nt, TILE)
    finite = torch.isfinite(xt)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    amax = torch.where(finite, xt.abs(), zero).amax(dim=-1)
    # a tensor divisor: ATen on a card multiplies by the reciprocal of a
    # Python scalar divisor, which is not IEEE division
    scale = torch.where(amax > 0, amax / torch.full_like(amax, _QMAX), torch.ones((), dtype=x.dtype, device=x.device))
    safe = torch.where(finite, xt, zero)
    q = torch.clamp(torch.round(safe / scale[..., None]), -_QMAX, _QMAX).to(torch.int8)
    q = torch.where(torch.isnan(xt), torch.tensor(_NAN, dtype=torch.int8, device=x.device), q)
    q = torch.where(xt == float("inf"), torch.tensor(_PINF, dtype=torch.int8, device=x.device), q)
    q = torch.where(xt == float("-inf"), torch.tensor(_NINF, dtype=torch.int8, device=x.device), q)
    sbytes = scale.contiguous().view(torch.int8).reshape(B, 4 * nt)
    return torch.cat([q.reshape(B, npad), sbytes], dim=1)


def decode_int8_plain(w: torch.Tensor, n: int) -> torch.Tensor:
    """Q1's decode in torch ops, ``heat_tpu``'s ``_decode_int8``."""
    B = w.shape[0]
    npad = _pad_tiles(n)
    nt = npad // TILE
    q = w[:, :npad].reshape(B, nt, TILE)
    scale = w[:, npad : npad + 4 * nt].contiguous().view(torch.float32).reshape(B, nt)
    vals = q.to(torch.float32) * scale[..., None]
    for code, value in ((_NAN, float("nan")), (_PINF, float("inf")), (_NINF, float("-inf"))):
        vals = torch.where(q == code, torch.tensor(value, device=w.device), vals)
    return vals.reshape(B, npad)[:, :n]


# --------------------------------------------------------------------- #
# the kernels' wrappers                                                 #
# --------------------------------------------------------------------- #
_LIB = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("quant")
        for fn in (lib.heat_quant_encode, lib.heat_quant_decode):
            fn.argtypes = [_P, _P, _LL, _LL, _I, _P]
            fn.restype = _I
        lib.heat_quant_error_string.argtypes = [_I]
        lib.heat_quant_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(encode: bool, src: torch.Tensor, out: torch.Tensor, rows: int, n: int) -> None:
    global ENCODE_LAUNCHES, DECODE_LAUNCHES
    if src.device.type != "cuda" or out.device != src.device:
        raise ValueError(f"Q1 needs CUDA tensors on one card, got {src.device} and {out.device}")
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError("Q1: both buffers must be contiguous")
    wire = out if encode else src
    if wire.data_ptr() % 4:
        raise ValueError(f"Q1: the wire buffer at {wire.data_ptr():#x} is not aligned to 4 bytes")
    if rows == 0 or n == 0:
        return  # nothing to write: no launch
    lib = _lib()
    dev = src.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = lib.heat_quant_encode if encode else lib.heat_quant_decode
    rc = fn(src.data_ptr(), out.data_ptr(), rows, n, dev.index, stream)
    if rc != 0:
        what = "encode" if encode else "decode"
        raise RuntimeError(f"Q1 {what} launch failed: CUDA error {rc} ({lib.heat_quant_error_string(rc).decode()})")
    with _count_lock:
        if encode:
            ENCODE_LAUNCHES += 1
        else:
            DECODE_LAUNCHES += 1


def encode_int8(x: torch.Tensor) -> torch.Tensor:
    """Q1's encode of a (B, n) float32 tensor: kernel on a CUDA tensor,
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return encode_int8_plain(x)
    B, n = x.shape
    out = torch.empty((B, wire_bytes(n, "int8")), dtype=torch.int8, device=x.device)
    _launch(True, x.contiguous(), out, B, n)
    return out


def decode_int8(w: torch.Tensor, n: int) -> torch.Tensor:
    """Q1's decode to (B, n) float32: kernel on a CUDA tensor, plain
    version on a CPU tensor."""
    if w.device.type == "cpu":
        return decode_int8_plain(w, n)
    out = torch.empty((w.shape[0], n), dtype=torch.float32, device=w.device)
    _launch(False, w.contiguous(), out, w.shape[0], n)
    return out


def _reject_non_float(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(
            f"wire codec encodes float32 payloads only, got {x.dtype}: integer, bool and wider float buffers "
            "stay exact on the wire"
        )


def _to_bf16_words(x: torch.Tensor) -> torch.Tensor:
    """The round-to-nearest-even bfloat16 words of ``x`` (int16): ATen's
    cast, one pass. On the CPU a NaN is written as XLA writes it (0x7fc0
    with the sign of x; ATen's vectorized cast writes 0xffff there), so
    that the CPU's wire bytes are ``heat_tpu``'s; on a card the cast alone
    (a NaN is 0x7fff there): NaN either way."""
    words = x.to(torch.bfloat16).contiguous().view(torch.int16)
    if x.device.type != "cpu":
        return words
    sign = torch.bitwise_and(x.contiguous().view(torch.int32) >> 16, -0x8000).to(torch.int16)
    return torch.where(torch.isnan(x), torch.bitwise_or(sign, 0x7FC0), words)


def encode_blocks(x: torch.Tensor, mode: str) -> torch.Tensor:
    """``(B, n)`` float32 -> ``(B, wire_bytes(n))`` int8 wire rows, each
    decodable alone."""
    _check_mode(mode)
    _reject_non_float(x)
    if x.ndim != 2:
        raise ValueError(f"encode_blocks expects (B, n), got {tuple(x.shape)}")
    with torch.profiler.record_function(f"wire_codec_{mode}"):
        if mode == "bf16":
            return _to_bf16_words(x).view(torch.int8).reshape(x.shape[0], 2 * x.shape[1])
        return encode_int8(x)


def decode_blocks(w: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    """Inverse of :func:`encode_blocks`: ``(B, wire_bytes(n))`` int8 ->
    ``(B, n)`` float32."""
    _check_mode(mode)
    n = int(n)
    with torch.profiler.record_function(f"wire_codec_{mode}"):
        if mode == "bf16":
            return w.contiguous().view(torch.bfloat16).reshape(w.shape[0], n).to(torch.float32)
        return decode_int8(w, n)


# --------------------------------------------------------------------- #
# the quantized all-reduces (the data-parallel gradient wire)           #
# --------------------------------------------------------------------- #
def quantized_allreduce_sum(h: torch.Tensor, comm, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum the flat float32 ``h`` over ``comm``'s ranks on encoded
    payloads: one all-to-all, one all-gather (module docstring). Returns
    (sum, this rank's error-feedback residual)."""
    _check_mode(mode)
    _reject_non_float(h)
    (n,) = h.shape
    p, rank = comm.size, comm.rank
    k = -(-n // p)
    npad = k * p
    blocks = torch.nn.functional.pad(h, (0, npad - n)).reshape(p, k)
    wire = encode_blocks(blocks, mode)
    resid = (blocks - decode_blocks(wire, k, mode)).reshape(npad)[:n]
    recv = comm.alltoall(wire)  # row q: block `rank` of rank q
    red = torch.sum(decode_blocks(recv, k, mode), dim=0)
    wire2 = encode_blocks(red[None], mode)
    red_hat = decode_blocks(wire2, k, mode)[0]
    gathered = comm.allgather(wire2, 0)
    out = decode_blocks(gathered, k, mode).reshape(npad)[:n]
    r2 = torch.zeros(npad, dtype=h.dtype, device=h.device)
    r2[rank * k : (rank + 1) * k] = red - red_hat
    return out, resid + r2[:n]


def hierarchical_allreduce_sum(h: torch.Tensor, comm, n_slices: int, chips_per_slice: int,
                               mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-tier quantized all-reduce at topology ``(n_slices,
    chips_per_slice)`` (module docstring): float32 within a node, the
    encoded node-reduced block across nodes. Returns (sum, this rank's
    error-feedback residual)."""
    _check_mode(mode)
    _reject_non_float(h)
    S, C = int(n_slices), int(chips_per_slice)
    if S * C != comm.size:
        raise ValueError(f"hierarchical_allreduce_sum: {S}x{C} is not a factorization of {comm.size} ranks")
    within, across = comm.tier_groups((S, C))
    (n,) = h.shape
    k = -(-n // C)
    npad = k * C
    blocks = torch.nn.functional.pad(h, (0, npad - n)).reshape(C, k)
    recv = comm.alltoall(blocks, group=within)  # row c: block (my place) of node-mate c
    red_s = torch.sum(recv, dim=0)
    wire = encode_blocks(red_s[None], mode)
    resid = red_s - decode_blocks(wire, k, mode)[0]
    gath = comm.allgather(wire, 0, group=across)
    red_g = torch.sum(decode_blocks(gath, k, mode), dim=0)
    full = comm.allgather(red_g[None], 0, group=within)
    out = full.reshape(npad)[:n]
    c_idx = comm.rank % C
    r = torch.zeros(npad, dtype=h.dtype, device=h.device)
    r[c_idx * k : (c_idx + 1) * k] = resid
    return out, r[:n]


# --------------------------------------------------------------------- #
# analytic data-parallel step models                                    #
# --------------------------------------------------------------------- #
def _ici_bps() -> float:
    from ..core import tiers

    return tiers.ICI_BPS


def _dcn_bps() -> float:
    from ..core import tiers

    return tiers.DCN_BPS


def dp_step_model(param_bytes: int, compute_s: float, p: int = 64, ici_bps: float = None,
                  mode: str = "int8") -> Dict[str, float]:
    """Modeled data-parallel step (``heat_tpu``'s ``dp_step_model``): the
    gradient all-reduce moves ``2·(p−1)/p·B`` bytes a card at ``ici_bps``
    (default ``tiers.ICI_BPS``), the step costs ``max(compute, wire)`` and
    the codec scales the wire term."""
    _check_mode(mode)
    ici_bps = _ici_bps() if ici_bps is None else ici_bps
    param_bytes = int(param_bytes)
    crossing = 2.0 * (p - 1) / p * param_bytes
    wire_raw = crossing / ici_bps
    ratio = wire_ratio(param_bytes // 4, mode)
    wire_q = wire_raw * ratio
    step_raw = max(float(compute_s), wire_raw)
    step_q = max(float(compute_s), wire_q)
    return {
        "param_bytes": param_bytes,
        "mesh": p,
        "mode": mode,
        "wire_ratio": round(ratio, 4),
        "wire_s_raw": wire_raw,
        "wire_s_quant": wire_q,
        "step_s_raw": step_raw,
        "step_s_quant": step_q,
        "model_speedup": round(step_raw / step_q, 3) if step_q > 0 else 1.0,
        "ici_bound": wire_raw > float(compute_s),
    }


def dp_step_model_2tier(param_bytes: int, compute_s: float, n_slices: int = 2, chips_per_slice: int = 8,
                        ici_bps: float = None, dcn_bps: float = None, mode: str = "int8") -> Dict[str, float]:
    """Modeled data-parallel step at two tiers (``heat_tpu``'s
    ``dp_step_model_2tier``): a flat float32 all-reduce priced at
    ``dcn_bps`` against the hierarchical one with the codec, whose only
    ``dcn`` traffic is ``(S−1)·wire_bytes(B/C)`` a card."""
    _check_mode(mode)
    ici_bps = _ici_bps() if ici_bps is None else ici_bps
    dcn_bps = _dcn_bps() if dcn_bps is None else dcn_bps
    S, C = int(n_slices), int(chips_per_slice)
    p = S * C
    param_bytes = int(param_bytes)
    wire_flat = 2.0 * (p - 1) / p * param_bytes / dcn_bps
    shard = param_bytes // C
    dcn_bytes = (S - 1) * wire_bytes(shard // 4, mode)
    ici_bytes = 2 * (C - 1) * param_bytes // C
    wire_hier = ici_bytes / ici_bps + dcn_bytes / dcn_bps
    step_flat = max(float(compute_s), wire_flat)
    step_hier = max(float(compute_s), wire_hier)
    return {
        "param_bytes": param_bytes,
        "mesh": p,
        "topology": f"{S}x{C}",
        "mode": mode,
        "dcn_bytes": int(dcn_bytes),
        "ici_bytes": int(ici_bytes),
        "wire_s_flat": wire_flat,
        "wire_s_hier": wire_hier,
        "step_s_flat": step_flat,
        "step_s_hier": step_hier,
        "model_speedup": round(step_flat / step_hier, 3) if step_hier > 0 else 1.0,
        "dcn_bound": wire_flat > float(compute_s),
    }
