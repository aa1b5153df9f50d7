"""The random stream's kernel R1, its plain version and launch counts.

``draw(mode, key, chunk, dtype, device, args)`` makes this rank's chunk of
one draw of ``heat_tpu``'s stream (``core/_threefry.py``): the Threefry-2x32
block of every element's global flat index and the mode's transform:

* ``"bits"``: ``random_bits`` of 8, 16, 32 or 64 bits (uint8, int16, int32
  or int64 holding the pattern; the 64-bit words are also ``split``'s key
  pairs);
* ``"uniform"``: ``jax.random.uniform`` in float16, bfloat16, float32 or
  float64, ``args = (minval, maxval)``;
* ``"normal"``: ``jax.random.normal(...) * std + mean``, ``args = (mean,
  std)``;
* ``"randint"``: ``jax.random.randint`` in int8, int16, int32, int64 or
  uint8, ``args = (low, high)``.

Kernel R1 (``csrc/threefry.cu``) computes it on a CUDA device, one launch a
draw, the output written once; it replaces no Pallas kernel (``heat_tpu``
draws through XLA's ``threefry2x32``). On the CPU the plain version runs
(``draw_plain``: the functions of ``core/_threefry.py`` on the chunk's flat
indices); on a CUDA device ``draw`` launches R1 or raises. Each launch adds
one to ``THREEFRY_LAUNCHES`` and appends its element count to
``THREEFRY_ELEMENTS``, which keeps the last 64; an empty chunk launches
nothing. ``shuffle`` is ``jax.random.permutation`` of n: rounds of R1's
32-bit words, each sorted with K4's ``pair_sort``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import threading

import torch

from ..core import _threefry as tf
from .sort import pair_sort

__all__ = ["BITS_DTYPES", "THREEFRY_ELEMENTS", "THREEFRY_LAUNCHES", "draw", "draw_plain",
           "normal_of_words", "plain_at", "shuffle"]

#: launches of R1 since the count was last set to 0
THREEFRY_LAUNCHES = 0
#: the element count of each of the last 64 of those launches, in order
THREEFRY_ELEMENTS: collections.deque = collections.deque(maxlen=64)

#: the tensor type that holds ``random_bits`` of each width
BITS_DTYPES = {8: torch.uint8, 16: torch.int16, 32: torch.int32, 64: torch.int64}

_MODES = {"bits": 0, "uniform": 1, "normal": 2, "randint": 3}
_FLOAT_CODES = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2, torch.float64: 3}
_INT_CODES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.int32: 3, torch.int64: 4}
_BIT_WIDTHS = {v: k for k, v in BITS_DTYPES.items()}

_count_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong


def _check(mode: str, dtype: torch.dtype) -> None:
    ok = {"bits": BITS_DTYPES.values(), "uniform": tf.FLOATS, "normal": tf.FLOATS, "randint": tf.INTS}
    if mode not in ok:
        raise ValueError(f"unknown draw mode {mode!r}")
    if dtype not in ok[mode]:
        raise ValueError(f"a {mode} draw does not make {dtype}")


# --------------------------------------------------------------------- #
# the plain version                                                     #
# --------------------------------------------------------------------- #
def plain_at(mode: str, key, idx: torch.Tensor, dtype: torch.dtype, args=()) -> torch.Tensor:
    """R1's function at the flat indices ``idx`` (int64, any shape), with
    torch ops on ``idx``'s device."""
    _check(mode, dtype)
    if mode == "bits":
        width = _BIT_WIDTHS[dtype]
        bits = tf.bits_plain(key, idx, width)
        if width == 16:
            bits = torch.where(bits >= 1 << 15, bits - (1 << 16), bits)
        elif width == 32:
            bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
        return bits.to(dtype)
    if mode == "uniform":
        return tf.uniform_plain(key, idx, dtype, *args)
    if mode == "normal":
        return tf.normal_plain(key, idx, dtype, *args)
    return tf.randint_plain(key, idx, *args, dtype)


def draw_plain(mode: str, key, chunk: "tf.Chunk", dtype: torch.dtype, device, args=()) -> torch.Tensor:
    """The chunk of the draw with torch ops (R1's oracle)."""
    return plain_at(mode, key, chunk.flat_index(torch.device(device)), dtype, args)


# --------------------------------------------------------------------- #
# the kernel's wrapper                                                  #
# --------------------------------------------------------------------- #
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("threefry")
        lib.heat_threefry_draw.argtypes = [_P, _I, _I, _U, _U, _U, _U, _LL, _LL, _LL, _LL, _LL,
                                           _ULL, _ULL, _ULL, _ULL, _ULL, _I, _I, _P]
        lib.heat_threefry_draw.restype = _I
        lib.heat_threefry_normal_of_words.argtypes = [_P, _P, _I, _LL, _ULL, _ULL, _ULL, _ULL, _ULL, _I, _I, _P]
        lib.heat_threefry_normal_of_words.restype = _I
        lib.heat_threefry_error_string.argtypes = [_I]
        lib.heat_threefry_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _pattern(t: torch.Tensor) -> int:
    """The bit pattern of a 0-d float tensor, as an unsigned int."""
    word = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return int(t.view(word)) % (1 << (8 * t.element_size()))


@functools.lru_cache(maxsize=256)
def _constants(mode: str, dtype: torch.dtype, args: tuple):
    """(code, a0..a4, flag) of a launch, made once per (mode, dtype, args):
    the transform's constants are 0-d tensors whose bit patterns are read
    on the host."""
    a = [0, 0, 0, 0, 0]
    flag = 0
    if mode == "bits":
        code = _BIT_WIDTHS[dtype]
    elif mode == "uniform":
        code = _FLOAT_CODES[dtype]
        lo, span = tf.uniform_params(dtype, *args)
        a[0], a[1] = _pattern(lo), _pattern(span)
    elif mode == "normal":
        code = _FLOAT_CODES[dtype]
        mean, std = args
        lo, span = tf.uniform_params(dtype, tf.normal_lo(dtype), 1.0)
        a = [_pattern(t) for t in (lo, span, *(tf.scalar(v, dtype) for v in (math.sqrt(2.0), std, mean)))]
        flag = int(mean != 0.0 or std != 1.0)
    else:
        code = _INT_CODES[dtype]
        nbits, span, mult, lo = tf.randint_params(*args, dtype)
        a[:3] = [span, mult, lo % (1 << 64)]
    return code, tuple(a), flag


def draw(mode: str, key, chunk: "tf.Chunk", dtype: torch.dtype, device, args=()) -> torch.Tensor:
    """This rank's chunk (local shape ``chunk.lshape``) of one draw on
    ``device``: R1 on a CUDA device (one launch, none for an empty chunk),
    the plain version on the CPU."""
    global THREEFRY_LAUNCHES
    _check(mode, dtype)
    device = torch.device(device)
    if device.type == "cpu":
        return draw_plain(mode, key, chunk, dtype, device, args)
    if device.type != "cuda":
        raise ValueError(f"kernel R1 needs a CUDA device, got {device}")
    out = torch.empty(chunk.lshape, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    code, a, flag = _constants(mode, dtype, tuple(args))
    j = (0, 0)
    if mode == "randint":
        key, j = tf.split(key)
    lib = _lib()
    outer, ext, start, length, inner = chunk.geometry()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = lib.heat_threefry_draw(out.data_ptr(), _MODES[mode], code, key[0], key[1], j[0], j[1],
                                outer, ext, start, length, inner, *a, flag, out.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"threefry {mode} kernel launch failed: CUDA error {rc} "
                           f"({lib.heat_threefry_error_string(rc).decode()})")
    with _count_lock:
        THREEFRY_LAUNCHES += 1
        THREEFRY_ELEMENTS.append(out.numel())
    return out


def normal_of_words(words: torch.Tensor, dtype: torch.dtype, args=(0.0, 1.0)) -> torch.Tensor:
    """R1's normal transform alone: the normal (``args = (mean, std)``) of
    each 32-bit word of ``words`` (int32) taken as a block's b1 ^ b2, in
    float16, bfloat16 or float32. On a CUDA tensor it launches the kernel's
    transform (no draw runs it, and it is not counted); on the CPU the plain
    version. It lets a check cover the transform's whole input domain."""
    if dtype not in (torch.float16, torch.bfloat16, torch.float32) or words.dtype != torch.int32:
        raise ValueError(f"normal_of_words takes int32 words to float16, bfloat16 or float32, not "
                         f"{words.dtype} to {dtype}")
    if words.device.type == "cpu":
        bits = words.long() & ((1 << tf.uniform_bits(dtype)) - 1)
        return tf.normal_of_bits(bits, dtype, *args)
    if words.device.type != "cuda":
        raise ValueError(f"kernel R1 needs a CUDA device, got {words.device}")
    words = words.contiguous()
    out = torch.empty(words.shape, dtype=dtype, device=words.device)
    code, a, flag = _constants("normal", dtype, tuple(args))
    lib = _lib()
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = lib.heat_threefry_normal_of_words(words.data_ptr(), out.data_ptr(), code, words.numel(), *a, flag,
                                           words.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"threefry normal transform launch failed: CUDA error {rc} "
                           f"({lib.heat_threefry_error_string(rc).decode()})")
    return out


def shuffle(key, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int64): ``_shuffle``'s rounds of
    a stable sort of the arrangement by fresh 32-bit keys, each K4's pair
    sort on (key word, index) on a card (its plain version on the CPU)."""
    n = int(n)
    if n >= 2**31:
        raise ValueError(f"a permutation of {n} elements exceeds the 32-bit indices of the pair sort")
    x = torch.arange(n, dtype=torch.int32, device=device)
    for _ in range(tf.shuffle_rounds(n)):
        key, sub = tf.split(key)
        words = draw("bits", sub, tf.Chunk.whole((n,)), torch.int32, device)
        _, x = pair_sort(words, x)
    return x.to(torch.int64)
