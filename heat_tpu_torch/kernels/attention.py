"""Exact softmax attention: the flash-attention forward kernel K9, its
plain version, predicates and launch counts (port of the kernels behind
``heat_tpu.nn.attention``).

``flash_attention(q, k, v, causal, scale)`` returns ``(o, lse)``: the
normalized output ``softmax(scale · q kᵀ [causal mask]) v`` in q's dtype
and the float32 log-sum-exp of each query row's scaled scores. That is the
save-residuals form of ``heat_tpu``'s ring steps
(``_ring_step_kernels``, ``nn/attention.py:250``), from which results over
parts of K/V combine exactly (``combine_partials``). The causal mask is
top-left aligned (key j is valid for query i when j ≤ i, also when
S_q ≠ S_kv); a row with no valid key gives o = 0 and lse = −inf.

On a card K9 is hand-written CUDA C++ for ``sm_90a`` that replaces both TPU
kernels ``heat_tpu`` calls: JAX's Pallas flash kernel for float32
(``_pallas_attention_program``, ``:637``) and its splash kernel for
bfloat16 (``_build_splash_mha``, ``:537``). Which kernel a call takes is
decided up front from dtype, head dims and layout:

* bfloat16 with D = D_v ∈ {64, 128, 256} and float32 with D = D_v = 64,
  bases and (batch, head, row) strides on 16 bytes (``sm90_serviceable``;
  this includes the strided heads of ``MultiheadAttention``'s packed
  projection): the Hopper path, ``csrc/attention_sm90.cu``, TMA loads and
  ``wgmma`` products in warp-specialised blocks; float32 there runs each
  product as three TF32 products (3xTF32), which keeps float32 accuracy.
  Its launches also add one to ``ATTENTION_SM90_LAUNCHES``.
* every other bfloat16 shape (D = 8, 40/72, D ≠ D_v, a misaligned view):
  the ``mma.sync`` kernel of ``csrc/attention.cu``.
* every other float32 shape (D ≠ 64, D ≠ D_v, a misaligned view): the
  FP32 kernel of ``csrc/attention.cu`` on the CUDA cores.

The source of each notes what bounds it and how its design meets that.

The wrapper runs its plain version only when the tensors lie on the CPU. A
CUDA tensor launches a kernel or raises; there is no fallback from one
kernel to another or to the plain version. Each launch adds one to
``ATTENTION_LAUNCHES``. Callers choose up front with
``attention_serviceable``: float32 and bfloat16 with both head dims at most
256 take K9; float64, float16, complex and wider heads take
``flash_attention_plain`` on any device, as ``heat_tpu`` takes its blocked
program outside its kernels' gate.

``flash_attention_backward`` is the gradient from a forward's saved
``(o, lse)``: FlashAttention-2's backward in plain torch, one (S_q ×
``CHUNK``) tile of probabilities live at a time. It is plain torch on every
device, because ``heat_tpu`` has no backward kernel on this path: its
traced calls differentiate the blocked XLA programs, never the Pallas
kernels. A Hopper backward kernel is ROADMAP.md open work 11.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

__all__ = [
    "ATTENTION_LAUNCHES",
    "ATTENTION_SM90_LAUNCHES",
    "CHUNK",
    "D_MAX",
    "SM90_HEAD_DIMS",
    "attention_serviceable",
    "combine_partials",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_plain",
    "sm90_serviceable",
]

#: launches of K9 (any of its kernels) since the count was last set to 0
ATTENTION_LAUNCHES = 0
#: launches of K9's Hopper path (``csrc/attention_sm90.cu``) since the count was last set to 0
ATTENTION_SM90_LAUNCHES = 0

#: K/V chunk of the plain version (``heat_tpu``'s blocked program: 1024)
CHUNK = 1024
#: largest head dim (of q/k and of v) the kernel takes
D_MAX = 256
#: head dims (D = D_v) of the Hopper path, by dtype
SM90_HEAD_DIMS = {torch.bfloat16: (64, 128, 256), torch.float32: (64,)}

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


def attention_serviceable(dtype: torch.dtype, d_qk: int, d_v: int) -> bool:
    """Whether attention over operands of ``dtype`` with head dims ``d_qk``
    (q, k) and ``d_v`` (v) runs K9 on a card: float32 or bfloat16, both
    head dims from 1 to 256. Everything else takes the plain version."""
    return dtype in _KERNEL_DTYPES and 1 <= d_qk <= D_MAX and 1 <= d_v <= D_MAX


def sm90_serviceable(dtype: torch.dtype, d_qk: int, d_v: int, ptrs, strides) -> bool:
    """Whether K9 takes its Hopper path (``csrc/attention_sm90.cu``) for
    operands of ``dtype`` with head dims ``d_qk`` and ``d_v``, data pointers
    ``ptrs`` and (batch, head, row) element strides ``strides`` (one triple
    an operand, each with a contiguous last dim): bfloat16 at D = D_v ∈
    {64, 128, 256} or float32 at D = D_v = 64 (``SM90_HEAD_DIMS``), every
    base and stride on 16 bytes (the rule of TMA's tensor maps). Everything
    else that ``attention_serviceable`` admits takes ``csrc/attention.cu``."""
    if d_qk != d_v or d_qk not in SM90_HEAD_DIMS.get(dtype, ()):
        return False
    return all(p % 16 == 0 for p in ptrs) and all(st * dtype.itemsize % 16 == 0 for triple in strides for st in triple)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype in (torch.float32, torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim < 2 or k.ndim < 2 or v.ndim < 2:
        raise ValueError(f"q, k and v need at least (S, D) dims, got {q.ndim}, {k.ndim} and {v.ndim}")
    if q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q and k head dims must agree, got {q.shape[-1]} vs {k.shape[-1]}")
    if k.shape[:-1] != v.shape[:-1]:
        raise ValueError(f"k and v must agree on batch/sequence dims, got {tuple(k.shape)} vs {tuple(v.shape)}")
    if q.shape[:-2] != k.shape[:-2]:
        raise ValueError(f"q and k batch dims must agree, got {tuple(q.shape[:-2])} vs {tuple(k.shape[:-2])}")


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` with torch ops: the online softmax of ``heat_tpu``'s
    blocked program (``_online_softmax_update``, ``_blocked_attention_program``)
    over K/V chunks of ``CHUNK`` keys, which also keeps the log-sum-exp.

    q (..., S_q, D), k (..., S_kv, D), v (..., S_kv, D_v). float32,
    bfloat16 and float16 compute in float32, float64 and complex in their
    own dtype; o comes back in q's dtype, lse (..., S_q) in the compute
    dtype (its real counterpart for complex). The running max of a complex
    row is that of the scores' real parts: the max only keeps exp in
    range, and any shift gives the same softmax. Differentiable."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ct = _compute_dtype(q.dtype)
    rt = torch.empty((), dtype=ct).real.dtype
    qc, kc, vc = (t.to(ct) for t in (q, k, v))
    s_q, s_kv = q.shape[-2], k.shape[-2]
    lead = q.shape[:-2]
    o = torch.zeros(lead + (s_q, v.shape[-1]), dtype=ct, device=q.device)
    m = torch.full(lead + (s_q, 1), -math.inf, dtype=rt, device=q.device)
    l = torch.zeros(lead + (s_q, 1), dtype=ct, device=q.device)
    q_pos = torch.arange(s_q, device=q.device)[:, None]
    for c0 in range(0, s_kv, CHUNK):
        if causal and c0 > s_q - 1:
            break  # every later key lies above the diagonal of every row
        k_c, v_c = kc[..., c0 : c0 + CHUNK, :], vc[..., c0 : c0 + CHUNK, :]
        s = (qc @ k_c.transpose(-1, -2)) * scale
        if causal:
            k_pos = c0 + torch.arange(k_c.shape[-2], device=q.device)[None, :]
            s = s.masked_fill(k_pos > q_pos, -math.inf)
        m_new = torch.maximum(m, (s.real if s.is_complex() else s).amax(-1, keepdim=True))
        m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)  # an all-masked row so far
        p = torch.exp(s - m_use)
        corr = torch.exp(m - m_use)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + p @ v_c
        m = m_new
    live = l != 0
    o = torch.where(live, o / torch.where(live, l, torch.ones_like(l)), torch.zeros_like(o))
    lse = torch.where(live, m + torch.log(torch.where(live, l, torch.ones_like(l))), -math.inf)
    return o.to(q.dtype), lse[..., 0]


def combine_partials(o1, lse1, o2, lse2) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of attention over the union of two disjoint key sets
    from the two partial results: the ring's combine (``heat_tpu``
    ``nn/attention.py:418-425``), in float32 (in their own dtype for
    float64 and complex partials), with a pair of −inf rows giving o = 0
    and lse = −inf. o comes back in o1's dtype. ``nn.ring_attention``
    combines its ring steps with it."""
    lse = torch.logaddexp(lse1, lse2)
    dead = torch.isneginf(lse)
    a = torch.where(dead, 0.0, torch.exp(lse1 - lse))[..., None]
    b = torch.where(dead, 0.0, torch.exp(lse2 - lse))[..., None]
    ct = _compute_dtype(o1.dtype)
    o = o1.to(ct) * a + o2.to(ct) * b
    return o.to(o1.dtype), lse


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of attention over q, k and v for the output
    gradient ``do``, from the output ``o`` and log-sum-exp ``lse`` of the
    forward (FlashAttention-2's backward): with D = rowsum(dO ⊙ O), each
    key chunk of ``CHUNK`` gives P = exp(scale · q kᵀ − lse) under the
    top-left causal mask of ``flash_attention``, dV = Pᵀ dO,
    dS = P ⊙ (dO Vᵀ − D), dQ += scale · dS K and dK = scale · dSᵀ Q.

    ``o`` and ``lse`` may be those of attention over a larger key set that
    holds these keys (the ring's combined result): then the gradients are
    this key set's share of that attention's, which is how the ring's
    backward sums them. Complex operands take the conjugates of torch's
    convention. A row with lse = −inf sees no key and adds nothing.
    Computes in ``_compute_dtype`` (float32 for bfloat16); the gradients
    come back in the dtypes of q, k and v."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ct = _compute_dtype(q.dtype)
    qc, kc, vc, oc, doc = (t.to(ct) for t in (q, k, v, o, do))
    lse = lse.to(ct if lse.is_complex() else torch.empty((), dtype=ct).real.dtype)
    live = ~torch.isneginf(lse.real)[..., None]
    lse_use = torch.where(live, lse[..., None], torch.zeros_like(lse[..., None]))
    d_row = (doc * oc.conj()).sum(-1, keepdim=True)
    s_q, s_kv = q.shape[-2], k.shape[-2]
    dq = torch.zeros_like(qc)
    dk = torch.zeros_like(kc)
    dv = torch.zeros_like(vc)
    q_pos = torch.arange(s_q, device=q.device)[:, None]
    for c0 in range(0, s_kv, CHUNK):
        if causal and c0 > s_q - 1:
            break  # every later key lies above the diagonal of every row
        k_c, v_c = kc[..., c0 : c0 + CHUNK, :], vc[..., c0 : c0 + CHUNK, :]
        s = (qc @ k_c.transpose(-1, -2)) * scale
        keep = live
        if causal:
            k_pos = c0 + torch.arange(k_c.shape[-2], device=q.device)[None, :]
            keep = keep & (k_pos <= q_pos)
        p = torch.where(keep, torch.exp(s - lse_use), torch.zeros_like(s))
        ds = p.conj() * (doc @ v_c.transpose(-1, -2).conj() - d_row)
        dv[..., c0 : c0 + CHUNK, :] = p.transpose(-1, -2).conj() @ doc
        dq += (ds @ k_c.conj()) * scale
        dk[..., c0 : c0 + CHUNK, :] = (ds.transpose(-1, -2) @ qc.conj()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------- #
# the kernel's wrapper                                                  #
# --------------------------------------------------------------------- #
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("attention")
        lib.heat_flash_attention.argtypes = [
            _P, _P, _P, _P, _P,  # q, k, v, o, lse
            _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,  # (batch, head, row) strides of q, k, v
            _I, _I, _LL, _LL, _I, _I,  # B, H, S_q, S_kv, D_qk, D_v
            _F, _I, _I, _I, _I, _I, _I, _P,  # scale, causal, bf16, vec q/k/v, device, stream
        ]
        lib.heat_flash_attention.restype = _I
        lib.heat_attention_error_string.argtypes = [_I]
        lib.heat_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


_LIB_SM90 = None


def _lib_sm90():
    global _LIB_SM90
    if _LIB_SM90 is None:
        from . import _build

        lib = _build.load("attention_sm90")
        lib.heat_flash_attention_sm90.argtypes = [
            _P, _P, _P, _P, _P,  # q, k, v, o, lse
            _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,  # (batch, head, row) strides of q, k, v
            _I, _I, _LL, _LL, _I,  # B, H, S_q, S_kv, D
            _F, _I, _I, _I, _P,  # scale, causal, float32, device, stream
        ]
        lib.heat_flash_attention_sm90.restype = _I
        lib.heat_attention_sm90_error_string.argtypes = [_I]
        lib.heat_attention_sm90_error_string.restype = ctypes.c_char_p
        _LIB_SM90 = lib
    return _LIB_SM90


def _as_bhsd(t: torch.Tensor) -> torch.Tensor:
    """(..., S, D) → a (B, H, S, D) view (a copy only where the leading dims
    do not merge) whose last dim is contiguous."""
    lead = t.shape[:-2]
    h = lead[-1] if lead else 1
    t4 = t.reshape((-1, h) + tuple(t.shape[-2:]))
    return t4 if t4.stride(-1) == 1 else t4.contiguous()


def _strides(t4: torch.Tensor):
    """(batch, head, row) strides in elements, 0 along an extent of 1."""
    return tuple(st if n > 1 else 0 for n, st in zip(t4.shape[:3], t4.stride()[:3]))


def _vec(t4: torch.Tensor, strides) -> bool:
    """Whether every row of ``t4`` starts on 16 bytes and holds whole
    16-byte units: the kernel's vector loads."""
    es = t4.element_size()
    return t4.data_ptr() % 16 == 0 and all(s * es % 16 == 0 for s in strides) and t4.shape[-1] * es % 16 == 0


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of exact attention (kernel K9 on CUDA).

    q (..., S_q, D), k (..., S_kv, D), v (..., S_kv, D_v) with the same
    leading dims; o (..., S_q, D_v) in q's dtype, lse (..., S_q) float32.
    On CUDA: all three float32 or all bfloat16 on one device, 1 ≤ D,
    D_v ≤ 256, any S_q and S_kv. bfloat16 at D = D_v ∈ {64, 128, 256} and
    float32 at D = D_v = 64 with bases and strides on 16 bytes take the
    Hopper path (``csrc/attention_sm90.cu``), other bfloat16 shapes the
    ``mma.sync`` kernel and other float32 shapes the FP32 kernel
    (``csrc/attention.cu``). Strided
    views (such as the heads of a packed projection) are read in place when
    their leading dims merge into (batch, head) and their last dim is
    contiguous. S_q = 0 or S_kv = 0 gives the result without a launch. A
    rerun gives the same bits. CPU tensors take the plain version."""
    return _flash_attention(q, k, v, causal, scale, sm90=True)


def _flash_attention_attention_cu(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` with the Hopper path shut off: a call on CUDA
    launches a kernel of ``csrc/attention.cu`` on any shape (``mma.sync``
    for bfloat16, the FP32 kernel for float32), so that ``chip_smoke.py``
    and the ``cuda`` tests can hold the two routes against each other on
    the same inputs."""
    return _flash_attention(q, k, v, causal, scale, sm90=False)


def _flash_attention(q, k, v, causal, scale, sm90: bool):
    global ATTENTION_LAUNCHES, ATTENTION_SM90_LAUNCHES
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal, scale)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"K9 needs q, k and v on one CUDA device, got {q.device}, {k.device} and {v.device}")
    _check_shapes(q, k, v)
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K9 takes float32 or bfloat16 q, k and v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    d, d_v = q.shape[-1], v.shape[-1]
    if not attention_serviceable(q.dtype, d, d_v):
        raise ValueError(f"K9 takes head dims from 1 to {D_MAX}, got {d} and {d_v}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lead, s_q, s_kv = q.shape[:-2], q.shape[-2], k.shape[-2]
    o = torch.empty(lead + (s_q, d_v), dtype=q.dtype, device=dev)
    lse = torch.empty(lead + (s_q,), dtype=torch.float32, device=dev)
    if o.numel() == 0 or lse.numel() == 0 or s_kv == 0:
        o.zero_()
        lse.fill_(-math.inf)
        return o, lse
    q4, k4, v4 = (_as_bhsd(t) for t in (q, k, v))
    b, h = q4.shape[:2]
    if b * h >= 2**31 or max(s_q, s_kv) >= 2**31:
        raise ValueError(f"K9 takes fewer than 2^31 (batch, head) pairs and rows, got {b * h}, {s_q}, {s_kv}")
    sq, sk, sv = (_strides(t) for t in (q4, k4, v4))
    ptrs = (q4.data_ptr(), k4.data_ptr(), v4.data_ptr())
    hopper = sm90 and sm90_serviceable(q.dtype, d, d_v, ptrs, (sq, sk, sv))
    lib = _lib_sm90() if hopper else _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if hopper:
        rc = lib.heat_flash_attention_sm90(
            *ptrs, o.data_ptr(), lse.data_ptr(), *sq, *sk, *sv, b, h, s_q, s_kv, d,
            float(scale), int(bool(causal)), int(q.dtype == torch.float32), dev.index, stream,
        )
        error_string = lib.heat_attention_sm90_error_string
    else:
        rc = lib.heat_flash_attention(
            *ptrs, o.data_ptr(), lse.data_ptr(), *sq, *sk, *sv, b, h, s_q, s_kv, d, d_v,
            float(scale), int(bool(causal)), int(q.dtype == torch.bfloat16),
            int(_vec(q4, sq)), int(_vec(k4, sk)), int(_vec(v4, sv)), dev.index, stream,
        )
        error_string = lib.heat_attention_error_string
    if rc != 0:
        msg = error_string(rc).decode()
        which = "attention_sm90" if hopper else "attention"
        raise RuntimeError(f"flash_attention kernel ({which}) launch failed: error {rc} ({msg})")
    ATTENTION_LAUNCHES += 1
    if hopper:
        ATTENTION_SM90_LAUNCHES += 1
    return o, lse
