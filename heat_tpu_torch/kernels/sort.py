"""The local sort: key transforms, the radix pair-sort kernel K4 and its
plain version, and the engine under ``ht.sort``, ``ht.unique`` and
``ht.topk`` (port of ``heat_tpu.kernels.sort``).

Kernel K4 (``csrc/radix_sort.cu``) is a stable LSD radix-256 sort of
(u32 key, u32 payload) pairs in independent segments, lexicographic in
(key, payload). It replaces the Pallas TPU kernel
``heat_tpu/kernels/sort.py::_pallas_block_call``, which sorts 512-pair
blocks in VMEM and serves the TPU only as a base case. On Hopper the kernel
is the engine of the whole local sort: a group of warps per segment of at
most ``SEG_MAX`` pairs, or a one-sweep pass sequence with decoupled
look-back for one segment of any length below 2^31. The source notes what
bounds it and how the design meets that. Two entries reach it:
``pair_sort`` sorts u32 words (the plain contract), and ``fused_sort``
sorts float32 or int32 values with the key transforms in the kernel's
first and last passes (the function of ``fused_sort_plain``, the
composition of ``sort_key``, ``pair_sort_plain`` and ``from_sortable``).
``_pair_sort_pr3`` keeps K4's first design for timing beside the new one.

The wrappers run their plain versions only when the tensors lie on the
CPU. A CUDA tensor launches the kernel or raises; there is no fallback.
Each call that launches adds one to ``SORT_LAUNCHES``.

Dispatch is decided up front by shape and dtype (``sort_serviceable``):
float32 and int32 sort through ``fused_sort`` when the sort axis is the
only one, or its rows hold at most ``SEG_MAX`` elements; every other case
takes ``torch.sort(stable=True)`` on a signed int64 key, the counterpart
of the ``lax.sort`` that ``heat_tpu`` runs outside any Pallas kernel.
Where only the values are wanted (``sorted_lanes``, under
``percentile``), float32 and int32 rows longer than ``SEG_MAX`` sort as
one segment of (row, value) pairs through ``pair_sort`` instead. Every route gives ``lax.sort``'s stable order: −0.0 ties +0.0 and every
NaN sorts last, tied. Values that come back through the transform are
canonical in those two tie classes (+0.0, the quiet NaN), as on
``heat_tpu``'s kernel paths.

``block_sort`` is the local step of the distributed sort networks
(``heat_tpu_torch.core.parallel``): K4 sorts the (value, global index)
pairs of a block, or its values alone. ``_columnsort_local`` is the
columnsort schedule of those networks in one process.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = [
    "SEG_MAX",
    "SORT_LAUNCHES",
    "argsort",
    "block_sort",
    "from_sortable",
    "fused_sort",
    "fused_sort_plain",
    "local_sort",
    "pair_sort",
    "pair_sort_plain",
    "sentinel",
    "sort_key",
    "sort_keys",
    "sort_plan",
    "sort_serviceable",
    "sort_with_key",
    "sorted_lanes",
    "to_sortable",
    "transformable",
]

#: launches of K4 since the count was last set to 0
SORT_LAUNCHES = 0

#: longest segment that one thread block sorts in shared memory (regime a);
#: longer single segments take the multi-block passes (regime b)
SEG_MAX = 4096
# pairs of one regime-(b) tile: the histogram table has one column per tile
_TILE = 4096
_RADIX = 256

# dtypes whose u32 transform K4 sorts
_WORD_DTYPES = (torch.float32, torch.int32)
# K4's key transforms (csrc/radix_sort.cu, enum Mode)
_MODE_WORDS, _MODE_COMPARATOR, _MODE_TOTAL, _MODE_INT32 = 0, 1, 2, 3

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


# --------------------------------------------------------------------- #
# monotone bit transforms: dtype <-> radix-sortable unsigned words      #
# --------------------------------------------------------------------- #
_INT_OF_BITS = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}
_MANTISSA = {torch.float16: 10, torch.bfloat16: 7, torch.float32: 23, torch.float64: 52}
_SIGNED = (torch.int8, torch.int16, torch.int32, torch.int64)


def _bits(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size() * 8


def transformable(dtype: torch.dtype) -> bool:
    """True when ``to_sortable``/``from_sortable`` serve this dtype: the
    floating and integer dtypes, not bool or complex."""
    return dtype in _MANTISSA or dtype in _SIGNED or dtype == torch.uint8


def _float_consts(dtype: torch.dtype):
    bits = _bits(dtype)
    nmant = _MANTISSA[dtype]
    sign = -(1 << (bits - 1))                              # the sign bit, as a signed word
    exp_all = ((1 << (bits - 1 - nmant)) - 1) << nmant     # e.g. 0x7F800000
    qnan = exp_all | (1 << (nmant - 1))                    # the canonical quiet NaN
    return bits, sign, exp_all, qnan


def to_sortable(x: torch.Tensor) -> torch.Tensor:
    """The unsigned word of ``heat_tpu.kernels.sort.to_sortable``, bit for
    bit, held in the signed integer dtype of the same width (torch has no
    shifts or comparisons on uint32 on the CPU). Its UNSIGNED order is
    ``lax.sort``'s comparator order on ``x``.

    floats: non-negatives get the sign bit set, negatives are complemented,
    with the comparator's two tie classes collapsed: every NaN maps to
    all-ones (type-max) and −0.0 onto +0.0's word. Subnormals keep their
    strict IEEE order. Signed ints flip the sign bit; uint8 is the identity.
    """
    dt = x.dtype
    if not transformable(dt):
        raise TypeError(f"no sortable transform for {dt}")
    bits = _bits(dt)
    it = _INT_OF_BITS[bits]
    if dt == torch.uint8:
        return x.view(it)
    sign = -(1 << (bits - 1))
    if dt in _SIGNED:
        return x ^ sign
    _, sign, exp_all, _ = _float_consts(dt)
    s = x.view(it)
    isnan = (s & ~sign) > exp_all
    s = torch.where(s == sign, 0, s)  # -0.0 -> +0.0
    # negatives (top bit set) are complemented, non-negatives get the top bit
    return torch.where(isnan, -1, s ^ ((s >> (bits - 1)) | sign))


def from_sortable(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`to_sortable`: exact bit round-trip everywhere
    except the two collapsed tie classes, which come back as their
    canonical representative (+0.0; the quiet positive NaN)."""
    if not transformable(dtype):
        raise TypeError(f"no sortable transform for {dtype}")
    bits = _bits(dtype)
    it = _INT_OF_BITS[bits]
    u = u.view(it) if u.dtype != it and u.element_size() * 8 == bits else u.to(it)
    if dtype == torch.uint8:
        return u.view(torch.uint8)
    sign = -(1 << (bits - 1))
    if dtype in _SIGNED:
        return u ^ sign
    _, sign, _, qnan = _float_consts(dtype)
    # the original was negative iff the word's top bit is clear
    out = torch.where(u == -1, qnan, u ^ (~(u >> (bits - 1)) | sign))
    return out.view(dtype)


def _wide_key(x: torch.Tensor, total: bool) -> torch.Tensor:
    """int64 key whose SIGNED order is the sort order of ``x``: the
    comparator's (ties of ±0, every NaN last and tied) or, with ``total``,
    IEEE totalOrder (+0 above −0, a NaN with its sign bit below −inf, NaNs
    ordered by their bits)."""
    if x.dtype == torch.bool or x.dtype == torch.uint8 or x.dtype in _SIGNED:
        return x.to(torch.int64)
    if x.dtype not in _MANTISSA:
        raise TypeError(f"no sort key for {x.dtype}")
    bits, sign, exp_all, _ = _float_consts(x.dtype)
    s = x.view(_INT_OF_BITS[bits]).to(torch.int64)  # sign-extended bits
    mag = (1 << (bits - 1)) - 1
    if not total:
        isnan = (s & mag) > exp_all
        s = torch.where(s == sign, 0, s)
    key = torch.where(s < 0, s ^ mag, s)
    return key if total else torch.where(isnan, torch.iinfo(torch.int64).max, key)


def sort_key(x: torch.Tensor, total: bool = False) -> torch.Tensor:
    """The key whose ascending order is the sort order of the real array
    ``x``: int32 words holding u32 bit patterns for float32 and int32 (what
    K4 sorts), a signed int64 key for every other dtype. Without ``total``
    the order is ``lax.sort``'s comparator (``to_sortable``); with it,
    IEEE totalOrder, the order of ``lax.top_k``: the plain sign-flip
    bijection with nothing collapsed. ``~key`` reverses either order."""
    if x.dtype not in _WORD_DTYPES:
        return _wide_key(x, total)
    if not total or x.dtype == torch.int32:
        return to_sortable(x)
    s = x.view(torch.int32)
    return s ^ ((s >> 31) | -(1 << 31))


# --------------------------------------------------------------------- #
# K4: the pair sort, its plain version and its wrapper                  #
# --------------------------------------------------------------------- #
def _segments(keys: torch.Tensor, pays: Optional[torch.Tensor], seg_len: Optional[int], pay_bytes: int):
    """Validate a pair-sort call; returns (n_segments, seg_len)."""
    if keys.dtype != torch.int32:
        raise TypeError(f"the pair sort takes int32 words holding u32 bit patterns, keys are {keys.dtype}")
    if keys.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    if pays is not None:
        if pays.dtype != torch.int32:
            raise TypeError(f"payloads must be int32 words, got {pays.dtype}")
        if pays.shape != keys.shape:
            raise ValueError(f"payloads {tuple(pays.shape)} and keys {tuple(keys.shape)} differ in shape")
        if pays.device != keys.device:
            raise ValueError(f"payloads lie on {pays.device}, keys on {keys.device}")
    elif pay_bytes != 0:
        raise ValueError("pay_bytes orders by the payload: give one, or pay_bytes=0 for the position")
    if not 0 <= pay_bytes <= 4:
        raise ValueError(f"pay_bytes must lie in [0, 4], got {pay_bytes}")
    n = keys.shape[0]
    seg_len = n if seg_len is None else int(seg_len)
    if n == 0:
        return 0, max(seg_len, 1)
    if not 1 <= seg_len < 2**31 or n % seg_len:
        raise ValueError(f"seg_len {seg_len} must be in [1, 2^31) and divide {n}")
    return n // seg_len, seg_len


def _to_words(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 words with the same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


# the plain version's rank: blocks of at most this many pairs of a row,
# one-hot counted this many pairs at a time
_PLAIN_BLOCK = 4096
_PLAIN_CHUNK = 1 << 20


def _counting_pass(digit: torch.Tensor, k: torch.Tensor, p: torch.Tensor):
    """One stable counting-sort pass of each row of (k, p) by ``digit``
    in [0, 256): a bincount histogram, its exclusive cumsum, and the stable
    rank within the digit. The rank is a one-hot running count within
    blocks of the row, plus the counts of the row's earlier blocks."""
    rows, length = digit.shape
    dev = digit.device
    row_bins = torch.arange(rows, device=dev)[:, None] * _RADIX
    hist = torch.bincount((row_bins + digit).reshape(-1), minlength=rows * _RADIX).reshape(rows, _RADIX)
    dest = (torch.cumsum(hist, 1) - hist).gather(1, digit)
    blk = min(length, _PLAIN_BLOCK)
    nb = -(-length // blk)
    # pads carry digit 256, which no bin counts
    blocks = torch.full((rows, nb * blk), _RADIX, dtype=digit.dtype, device=dev)
    blocks[:, :length] = digit
    blocks = blocks.reshape(rows * nb, blk)
    clamped = blocks.clamp(max=_RADIX - 1)
    rank = torch.empty(blocks.shape, dtype=torch.int32, device=dev)
    counts = torch.empty((rows * nb, _RADIX), dtype=torch.int64, device=dev)
    bins = torch.arange(_RADIX, device=dev)[None, :, None]
    step = max(1, _PLAIN_CHUNK // blk)
    for b0 in range(0, rows * nb, step):
        d = blocks[b0 : b0 + step]
        # the running count of each digit along the block, in the innermost dim
        upto = torch.cumsum(d[:, None, :] == bins, dim=2, dtype=torch.int32)
        rank[b0 : b0 + step] = upto.gather(1, clamped[b0 : b0 + step, None, :])[:, 0, :] - 1
        counts[b0 : b0 + step] = upto[:, :, -1]
    counts = counts.reshape(rows, nb, _RADIX)
    earlier = (torch.cumsum(counts, 1) - counts).reshape(rows * nb, _RADIX)
    dest += (rank + earlier.gather(1, clamped)).reshape(rows, nb * blk)[:, :length]
    return torch.empty_like(k).scatter_(1, dest, k), torch.empty_like(p).scatter_(1, dest, p)


def pair_sort_plain(keys: torch.Tensor, pays: Optional[torch.Tensor] = None, seg_len: Optional[int] = None,
                    pay_bytes: int = 0):
    """K4's function with torch ops: in each segment of ``seg_len`` pairs,
    ``pay_bytes`` stable counting-sort passes over the payload's low bytes,
    then four over the key, on words held in int64. Returns the sorted
    keys and the payloads (the position within the segment when ``pays``
    is None), as int32 words."""
    n_seg, seg_len = _segments(keys, pays, seg_len, pay_bytes)
    if n_seg == 0:
        return keys.clone(), torch.empty_like(keys)
    k = (keys.to(torch.int64) & 0xFFFFFFFF).reshape(n_seg, seg_len)
    if pays is None:
        p = torch.arange(seg_len, device=keys.device).expand(n_seg, seg_len).contiguous()
    else:
        p = (pays.to(torch.int64) & 0xFFFFFFFF).reshape(n_seg, seg_len)
    for q in range(pay_bytes + 4):
        from_pay = q < pay_bytes
        shift = 8 * (q if from_pay else q - pay_bytes)
        k, p = _counting_pass(((p if from_pay else k) >> shift) & 255, k, p)
    return _to_words(k).reshape(-1), _to_words(p).reshape(-1)


def _from_total(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``sort_key(x, total=True)`` for float32 and int32 words:
    every bit pattern comes back as it was."""
    if dtype == torch.int32:
        return to_sortable(u)  # the sign flip is its own inverse
    return (u ^ (~(u >> 31) | -(1 << 31))).view(dtype)


def fused_sort_plain(x: torch.Tensor, seg_len: Optional[int] = None, total: bool = False,
                     descending: bool = False, out: Optional[str] = "values"):
    """K4's fused entry with torch ops: the composition that ``local_sort``
    ran before the transforms moved into the kernel. The key of the 1-D
    float32 or int32 ``x`` (``sort_key``: the comparator's order, or with
    ``total`` IEEE totalOrder), complemented when ``descending``, sorted
    stably in each segment of ``seg_len`` by ``pair_sort_plain``. Returns
    (first, indices): indices the int64 argsort within each segment; first
    the sorted values (``out="values"``, through the inverse transform,
    canonical +0.0 and quiet NaN in the comparator's tie classes), the
    sorted key words as int32 (``out="words"``), or None (``out=None``)."""
    _fused_args(x, out)
    key = sort_key(x, total)
    sk, sp = pair_sort_plain(~key if descending else key, seg_len=seg_len)
    idx = sp.to(torch.int64)
    if out is None:
        return None, idx
    if out == "words":
        return sk, idx
    u = ~sk if descending else sk
    return (_from_total(u, x.dtype) if total else from_sortable(u, x.dtype)), idx


def _fused_args(x: torch.Tensor, out: Optional[str]) -> None:
    if x.dtype not in _WORD_DTYPES:
        raise TypeError(f"the fused sort takes float32 or int32, got {x.dtype}")
    if x.ndim != 1:
        raise ValueError(f"the fused sort takes a 1-D tensor, got shape {tuple(x.shape)}")
    if out not in ("values", "words", None):
        raise ValueError(f"out must be 'values', 'words' or None, got {out!r}")


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("radix_sort")
        lib.heat_radix_seg_max.argtypes = []
        lib.heat_radix_seg_max.restype = _I
        for name in ("heat_radix_scratch_words", "heat_radix_scratch_words_pr3"):
            getattr(lib, name).argtypes = [_LL, _I]
            getattr(lib, name).restype = _LL
        lib.heat_radix_sort.argtypes = [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.heat_radix_sort.restype = _I
        lib.heat_radix_pair_sort_pr3.argtypes = [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P]
        lib.heat_radix_pair_sort_pr3.restype = _I
        lib.heat_radix_error_string.argtypes = [_I]
        lib.heat_radix_error_string.restype = ctypes.c_char_p
        if lib.heat_radix_seg_max() != SEG_MAX:
            raise RuntimeError(f"csrc/radix_sort.cu sorts segments of {lib.heat_radix_seg_max()}, not {SEG_MAX}")
        _LIB = lib
    return _LIB


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _refuse_long_segments(n_seg: int, seg_len: int) -> None:
    if seg_len > SEG_MAX and n_seg > 1:
        raise ValueError(f"segments longer than SEG_MAX={SEG_MAX} must be alone, got {n_seg} of {seg_len}")


def _check_cuda(tensors) -> None:
    for name, t in tensors:
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"the CUDA pair sort needs CUDA tensors, {name} lies on {t.device}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.heat_radix_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _launch(keys, pays, out_v, out_i, n_seg: int, seg_len: int, pay_bytes: int, mode: int, descending: bool,
            words: bool) -> None:
    """One call of K4's C entry on the current stream; counts the launch."""
    global SORT_LAUNCHES
    dev = keys.device
    lib = _lib()
    n_words = lib.heat_radix_scratch_words(n_seg, seg_len)
    scratch = torch.empty((n_words,), dtype=torch.int32, device=dev) if n_words else None
    rc = lib.heat_radix_sort(
        keys.data_ptr(), _ptr(pays), _ptr(out_v), out_i.data_ptr(), _ptr(scratch), n_seg, seg_len, pay_bytes,
        mode, int(descending), int(words), int(out_i.dtype == torch.int64), dev.index, _stream(dev),
    )
    _raise_on(lib, rc, "K4")
    SORT_LAUNCHES += 1


def pair_sort(keys: torch.Tensor, pays: Optional[torch.Tensor] = None, seg_len: Optional[int] = None,
              pay_bytes: int = 0):
    """Stable sort of (key, payload) pairs in each segment of ``seg_len``
    (kernel K4 on CUDA), lexicographic in (key, payload).

    ``keys`` and ``pays``: 1-D contiguous int32 tensors holding u32 bit
    patterns, ``seg_len`` divides their length (default: one segment).
    ``pay_bytes`` = 0 carries the payload and orders stably by key alone;
    1-4 also orders by that many low bytes of the payload. Without
    ``pays`` the payload is the position within the segment (the argsort).
    Segments longer than ``SEG_MAX`` must be alone, and shorter than 2^31.
    Returns the sorted keys and payloads as int32 words. CPU tensors take
    the plain version."""
    n_seg, seg_len = _segments(keys, pays, seg_len, pay_bytes)
    _refuse_long_segments(n_seg, seg_len)
    if keys.device.type == "cpu":
        return pair_sort_plain(keys, pays, seg_len, pay_bytes)
    _check_cuda((("keys", keys), ("pays", pays)))
    if n_seg == 0:
        return keys.clone(), torch.empty_like(keys)
    out_k, out_p = torch.empty_like(keys), torch.empty_like(keys)
    _launch(keys, pays, out_k, out_p, n_seg, seg_len, pay_bytes, _MODE_WORDS, False, True)
    return out_k, out_p


def fused_sort(x: torch.Tensor, seg_len: Optional[int] = None, total: bool = False, descending: bool = False,
               out: Optional[str] = "values"):
    """Stable sort of the 1-D float32 or int32 ``x`` in each segment of
    ``seg_len`` (default: one), K4 with the key transforms in its first and
    last passes: the function of :func:`fused_sort_plain`, bit for bit.
    The first pass turns the raw bits into the comparator's key (with
    ``total``, the totalOrder key; int32 takes the sign flip either way),
    complemented when ``descending``; the last writes the values through
    the inverse transform (``out="values"``), the key words
    (``out="words"``) or nothing (``out=None``), and the indices as int64.
    CPU tensors take the plain version; a CUDA tensor launches K4 or
    raises."""
    _fused_args(x, out)
    n_seg, seg_len = _segments(x.view(torch.int32), None, seg_len, 0)
    _refuse_long_segments(n_seg, seg_len)
    if x.device.type == "cpu":
        return fused_sort_plain(x, seg_len, total, descending, out)
    _check_cuda((("x", x),))
    idx = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    first = None
    if out is not None:
        first = torch.empty(x.shape, dtype=x.dtype if out == "values" else torch.int32, device=x.device)
    if n_seg == 0:
        return first, idx
    mode = _MODE_INT32 if x.dtype == torch.int32 else _MODE_TOTAL if total else _MODE_COMPARATOR
    _launch(x, None, first, idx, n_seg, seg_len, 0, mode, descending, out == "words")
    return first, idx


def _pair_sort_pr3(keys: torch.Tensor, pays: Optional[torch.Tensor] = None, seg_len: Optional[int] = None,
                   pay_bytes: int = 0):
    """:func:`pair_sort` through K4's first design (a block of 8 warps a
    segment; three launches a pass over one long segment), kept to time the
    old kernels beside the new ones. No entry point reaches it, and it adds
    nothing to ``SORT_LAUNCHES``."""
    n_seg, seg_len = _segments(keys, pays, seg_len, pay_bytes)
    _refuse_long_segments(n_seg, seg_len)
    if keys.device.type == "cpu":
        return pair_sort_plain(keys, pays, seg_len, pay_bytes)
    _check_cuda((("keys", keys), ("pays", pays)))
    out_k, out_p = torch.empty_like(keys), torch.empty_like(keys)
    if n_seg == 0:
        return out_k, out_p
    dev = keys.device
    lib = _lib()
    n_words = lib.heat_radix_scratch_words_pr3(n_seg, seg_len)
    scratch = torch.empty((n_words,), dtype=torch.int32, device=dev) if n_words else None
    rc = lib.heat_radix_pair_sort_pr3(
        keys.data_ptr(), _ptr(pays), out_k.data_ptr(), out_p.data_ptr(), _ptr(scratch), n_seg, seg_len, pay_bytes,
        dev.index, _stream(dev),
    )
    _raise_on(lib, rc, "K4's first design")
    return out_k, out_p


# --------------------------------------------------------------------- #
# dispatch                                                              #
# --------------------------------------------------------------------- #
def _words_serviceable(shape) -> bool:
    """K4 sorts int32 words of this shape along the last axis: one
    segment below 2^31, or rows of at most SEG_MAX."""
    if len(shape) == 0:
        return False
    n = int(shape[-1])
    numel = 1
    for s in shape:
        numel *= int(s)
    return numel > 0 and n < 2**31 and (numel == n or n <= SEG_MAX)


def sort_serviceable(shape, dtype: torch.dtype, axis: int = -1) -> bool:
    """Whether a sort of an array of this shape and dtype along ``axis``
    runs K4: float32 or int32, and, once the axis is moved last, either
    one segment below 2^31 elements or rows of at most ``SEG_MAX``."""
    if dtype not in _WORD_DTYPES or len(shape) == 0:
        return False
    shape = list(shape)
    shape.append(shape.pop(axis % len(shape)))
    return _words_serviceable(shape)


def sort_keys(key: torch.Tensor, pays: Optional[torch.Tensor] = None):
    """Stable ascending sort of ``key`` along its last axis, carrying
    ``pays`` (default: the position, as int64). ``key`` is what
    ``sort_key`` gives: int32 words take K4 when their shape is
    serviceable, and ``torch.sort(stable=True)`` on the words widened to
    int64 otherwise; int64 keys take ``torch.sort(stable=True)``. Payloads
    through K4 must lie in [0, 2^31). Returns (sorted key, payloads)."""
    key = key.contiguous()
    if key.dtype == torch.int32 and _words_serviceable(key.shape):
        n = key.shape[-1]
        p = None if pays is None else pays.to(torch.int32).contiguous().reshape(-1)
        sk, sp = pair_sort(key.reshape(-1), p, seg_len=n)
        sp = sp.reshape(key.shape)
        return sk.reshape(key.shape), sp.to(torch.int64 if pays is None else pays.dtype)
    wide = key.to(torch.int64) & 0xFFFFFFFF if key.dtype == torch.int32 else key
    _, idx = torch.sort(wide, dim=-1, stable=True)
    return key.gather(-1, idx), idx if pays is None else pays.gather(-1, idx)


def _fusable(x: torch.Tensor) -> bool:
    """``x`` (the sort axis last) sorts through K4's fused entry."""
    return x.dtype in _WORD_DTYPES and _words_serviceable(x.shape)


def local_sort(arr: torch.Tensor, axis: int = -1, descending: bool = False):
    """Values and stable argsort (int64) of ``arr`` along ``axis`` — the
    single-device engine under ``ht.sort``.

    The order is ``lax.sort``'s; ``descending`` sorts the complemented key
    in the same single pass, so ties keep their input order and NaNs come
    first. float32 and int32 of a ``sort_serviceable`` shape take K4's
    fused entry, which transforms the keys in its first pass and writes
    the values back through the inverse transform and the int64 indices in
    its last, with no elementwise kernel around it. Other dtypes gather
    their values by the argsort of their int64 key; complex sorts
    lexicographically in (real, imag) by two stable sorts, as
    ``jnp.argsort`` orders it."""
    if arr.ndim == 0:
        return arr.clone(), torch.zeros((), dtype=torch.int64, device=arr.device)
    axis %= arr.ndim
    x = arr.movedim(axis, -1).contiguous()
    if _fusable(x):
        values, idx = fused_sort(x.reshape(-1), seg_len=x.shape[-1], descending=descending)
        values, idx = values.reshape(x.shape), idx.reshape(x.shape)
    elif x.is_complex():
        idx = None
        for part in (x.imag, x.real):  # least significant first
            k = sort_key(part.contiguous())
            k = ~k if descending else k
            _, idx = sort_keys(k if idx is None else k.gather(-1, idx), idx)
        values = x.gather(-1, idx)
    else:
        key = sort_key(x)
        sk, idx = sort_keys(~key if descending else key)
        if key.dtype == torch.int32:
            values = from_sortable(~sk if descending else sk, x.dtype)
        else:
            values = x.gather(-1, idx)
    return values.movedim(-1, axis).contiguous(), idx.movedim(-1, axis).contiguous()


def sorted_lanes(arr: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``local_sort``'s values alone: ``arr`` sorted ascending along
    ``axis``. float32 and int32 lanes longer than ``SEG_MAX`` (which K4
    serves only alone) in an array of several lanes and fewer than 2^31
    elements sort as one segment of (lane, key word) pairs ordered by both
    (``pair_sort``, K4 on a card); the values come back through the
    inverse transform, as K4's fused entry gives them. The engine under
    ``percentile`` along an axis that is not split. (Packing the lane's
    bits beside the key word's high bits saves K4 two of its eight passes
    but costs more in the elementwise passes that pack and unpack.)"""
    if arr.ndim == 0:
        return arr.clone()
    axis %= arr.ndim
    x = arr.movedim(axis, -1).contiguous()
    n = x.shape[-1]
    if x.dtype in _WORD_DTYPES and n > SEG_MAX and x.numel() > n and x.numel() < 2**31:
        lane = torch.arange(x.numel() // n, dtype=torch.int32, device=x.device).repeat_interleave(n)
        _, words = pair_sort(lane, sort_key(x).reshape(-1), pay_bytes=4)
        del lane
        return from_sortable(words, x.dtype).reshape(x.shape).movedim(-1, axis)
    return local_sort(arr, axis)[0]


def argsort(x: torch.Tensor, total: bool = False, descending: bool = False) -> torch.Tensor:
    """Stable argsort (int64) of ``x`` along its last axis by its sort key
    (``sort_key(x, total)``), descending on the complemented key. float32
    and int32 of a serviceable shape take K4's fused entry and write only
    the indices; the engine under ``ht.topk``."""
    x = x.contiguous()
    if _fusable(x):
        _, idx = fused_sort(x.reshape(-1), seg_len=x.shape[-1], total=total, descending=descending, out=None)
        return idx.reshape(x.shape)
    key = sort_key(x, total)
    return sort_keys(~key if descending else key)[1]


def sort_with_key(x: torch.Tensor):
    """Stable ascending sort of ``x`` along its last axis by
    ``sort_key(x)``: the sorted keys and the int64 argsort. float32 and
    int32 of a serviceable shape take K4's fused entry, which writes the
    key words; the first sort under ``ht.unique``, which groups on keys."""
    x = x.contiguous()
    if _fusable(x):
        sk, idx = fused_sort(x.reshape(-1), seg_len=x.shape[-1], out="words")
        return sk.reshape(x.shape), idx.reshape(x.shape)
    return sort_keys(sort_key(x))


# --------------------------------------------------------------------- #
# the local step of the distributed networks                            #
# --------------------------------------------------------------------- #
def sentinel(dtype: torch.dtype):
    """The pad value that sorts after every value of ``dtype`` under the
    comparator, or ties the largest: NaN for floats, True for bool,
    type-max for integers (``heat_tpu`` manipulations.py:523)."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def block_sort(operands, dimension: int = 0, num_keys: int = 1, extent: Optional[int] = None):
    """``lax.sort``'s contract for the local steps of the distributed sort
    networks (``heat_tpu`` kernels/sort.py:672): ``operands`` are the
    values, or with ``num_keys=2`` the values and their int64 global
    indices, sorted along ``dimension`` (other dims are batch lanes) into
    the lexicographic order of (value under the comparator, index); every
    route is stable. With two keys the indices must lie in [0,
    ``extent``).

    float32 and int32 values of a shape K4 serves (one lane, or lanes of
    at most ``SEG_MAX``) take K4: values alone its fused entry, pairs its
    pair sort on (``sort_key(value)``, index) ordered by the index's low 2
    bytes when ``extent`` ≤ 2^16 and 4 below 2^31, as ``heat_tpu``'s
    ``_run_pair_path`` sizes it. Values that come back through the key
    transform are +0.0 for −0.0 and the quiet NaN for any NaN. Every other
    case takes ``torch.sort(stable=True)`` on the int64 key, after a stable
    sort by index where there is one. The route is decided by dtype, shape
    and ``extent``; a CUDA tensor that K4 should serve launches K4 or
    raises."""
    operands = tuple(operands)
    if num_keys not in (1, 2) or len(operands) != num_keys:
        raise ValueError(f"block_sort takes num_keys 1 or 2 and as many operands, got {num_keys} and {len(operands)}")
    if num_keys == 2 and extent is None:
        raise ValueError("block_sort with an index key needs the indices' extent")
    v = operands[0].movedim(dimension, -1).contiguous()
    idx = operands[1].movedim(dimension, -1).contiguous() if num_keys == 2 else None
    if v.numel() == 0:
        return tuple(t.clone() for t in operands)
    if _fusable(v) and (idx is None or extent <= 2**31):
        n = v.shape[-1]
        if idx is None:
            sv, _ = fused_sort(v.reshape(-1), seg_len=n)
            out = (sv.reshape(v.shape),)
        else:
            pay_bytes = 2 if extent - 1 <= 0xFFFF else 4
            sk, sp = pair_sort(sort_key(v).reshape(-1), idx.to(torch.int32).reshape(-1), n, pay_bytes)
            out = (from_sortable(sk, v.dtype).reshape(v.shape), sp.reshape(v.shape).to(idx.dtype))
    else:
        if idx is not None:
            order = torch.sort(idx, dim=-1, stable=True).indices
            v, idx = v.gather(-1, order), idx.gather(-1, order)
        order = torch.sort(_wide_key(v, False), dim=-1, stable=True).indices
        out = (v.gather(-1, order),) + (() if idx is None else (idx.gather(-1, order),))
    return tuple(t.movedim(-1, dimension).contiguous() for t in out)


def _columnsort_local(operands, num_keys: int, p: int, b: int, n: int):
    """Leighton's columnsort of the 1-D ``operands`` (values, and with
    ``num_keys=2`` their indices in [0, n)) in one process, as ``heat_tpu``
    kernels/sort.py:415 runs it: the schedule of the distributed
    columnsort (``core.parallel``) on a (p, b) matrix whose rows are the
    ranks' blocks, with the all-to-alls as transposes and the boundary
    windows as one batched sort of (p − 1, b). Sorted for any input when
    p | b and b ≥ 2(p − 1)². The p·b − n pads hold the dtype's
    ``sentinel`` and indices n, n + 1, ...; they sort after every real
    pair and are cut. Returns the sorted operands."""
    pad = p * b - n
    dev = operands[0].device
    padded = [torch.cat([operands[0], torch.full((pad,), sentinel(operands[0].dtype), dtype=operands[0].dtype,
                                                 device=dev)])]
    if num_keys == 2:
        padded.append(torch.cat([operands[1], torch.arange(n, p * b, dtype=operands[1].dtype, device=dev)]))
    padded = [t.reshape(p, b) for t in padded]

    def srt(ts):
        return list(block_sort(ts, 1, num_keys, extent=p * b))

    def deal(t):  # row c: [t[r, q·p + c] for r, then q]
        return t.reshape(p, b // p, p).permute(2, 0, 1).reshape(p, b)

    def undeal(t):  # row d, position q·p + r: t[r, d·(b/p) + q]
        return t.reshape(p, p, b // p).permute(1, 2, 0).reshape(p, b)

    ts = srt(padded)
    ts = srt([deal(t) for t in ts])
    ts = srt([undeal(t) for t in ts])
    h = b // 2
    tops = [t[:, : b - h] for t in ts]
    bots = [t[:, b - h :] for t in ts]
    mid = srt([torch.cat([bt[:-1], tp[1:]], dim=1) for bt, tp in zip(bots, tops)])
    out = []
    for tp, bt, md in zip(tops, bots, mid):
        up = torch.cat([tp[:1], md[:, h:]])
        dn = torch.cat([md[:, :h], bt[p - 1 :]])
        out.append(torch.cat([up, dn], dim=1).reshape(p * b)[:n])
    return tuple(out)


# --------------------------------------------------------------------- #
# pass-count model (PERF.md arithmetic)                                 #
# --------------------------------------------------------------------- #
def sort_plan(n: int, dtype: torch.dtype = torch.float32, seg_len: Optional[int] = None) -> dict:
    """Pass count and device-memory bytes of ``local_sort``'s K4 call on
    ``n`` elements of ``dtype`` in rows of ``seg_len`` (default: one row),
    and the floor of any sort that returns values and int64 indices: one
    read of the values and one write of values and indices.

    ``radix_a`` (rows of at most ``SEG_MAX``): one read of each value and
    one write of each value and index, every pass in shared memory: the
    floor. ``radix_b`` (one long row): the histogram launch reads the
    values (4 B a pair); pass 1 reads them and writes key and payload words
    (4 + 8), passes 2 and 3 read and write both (8 + 8), pass 4 reads both
    and writes the value and the int64 index (8 + 12): 68 B a pair, with a
    place of constant digit skipped on the card (not modelled). Besides,
    ``lookback_bytes``: each tile's 256 status words of 8 B, written twice
    and read at least once a pass. ``torch``: the library sort, not
    modelled."""
    seg_len = n if seg_len is None else seg_len
    floor = n * (2 * torch.empty((), dtype=dtype).element_size() + 8)
    shape = (n,) if seg_len == n else (n // seg_len, seg_len)
    if not sort_serviceable(shape, dtype):
        return {"path": "torch", "passes": None, "hbm_bytes": None, "floor_bytes": floor,
                "model": "torch.sort(stable=True): the library's radix sort, not modelled"}
    if seg_len <= SEG_MAX:
        return {"path": "radix_a", "passes": 4, "hbm_bytes": 16 * n, "floor_bytes": floor,
                "model": "one read of each value, one write of each value and int64 index; "
                         "all 8-bit passes in shared memory"}
    tiles = -(-n // _TILE)
    return {"path": "radix_b", "passes": 4, "tiles": tiles, "hbm_bytes": (4 + 12 + 16 + 16 + 20) * n,
            "lookback_bytes": 4 * 3 * 8 * _RADIX * tiles, "floor_bytes": floor,
            "model": "histogram read 4; pass 1 read 4, write 8; passes 2-3 read 8, write 8; "
                     "pass 4 read 8, write 4 + 8 B a pair"}
