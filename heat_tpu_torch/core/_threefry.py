"""``heat_tpu``'s random stream: JAX's partitionable Threefry-2x32, in torch.

``heat_tpu`` draws every random number from JAX's Threefry-2x32 keys with
``jax_threefry_partitionable`` on (``heat_tpu/core/random.py:67-79``). This
module computes the same function, so that a seeded draw of the port gives
``heat_tpu``'s values:

* the key algebra on the host (``jax/_src/prng.py`` of jax 0.9.0):
  ``threefry_2x32`` (``:1092``, rounds at ``:876-905``), ``seed_key``
  (``threefry_seed``, ``:802-830``), ``fold_in`` (``:1168``) and ``split``
  (``_threefry_split_foldlike``, ``:1156``). A key is a pair of Python ints,
  the two uint32 words: every key derives from the host's (seed, counter)
  state, so the algebra costs a few microseconds and never reads the
  device;
* the partitionable ``random_bits`` (``:1184-1201``): the counter of an
  element is its global row-major flat index as (hi, lo) words
  (``iota_2x32_shape``, ``:989``), so any part of a draw is computed
  without the rest. 32 bits are ``bits1 ^ bits2``, 64 bits
  ``bits1 << 32 | bits2``, 8 and 16 the low bits of the xor;
* the transforms of ``jax/_src/random.py``: ``_uniform`` (``:435``; bf16
  takes 8 random bits), ``_normal_real`` (``:867``: √2·erf⁻¹ of a uniform on
  (nextafter(−1, 0), 1), erf⁻¹ XLA's polynomial, copied from
  ``jax/_src/pallas/utils.py:199-260``; for float16 and bfloat16 it is
  taken in float32 and rounded, then multiplied by √2),
  ``_randint`` (``:581``), ``_shuffle`` (``:700``) and ``choice(p=)``
  (``:806-808``). Where XLA fuses or widens a step on the CPU (the
  uniform's scale and shift, ``normal``'s std and mean), the plain
  functions round as it does (``_scale_shift``), so uniform, integer, bits
  and permutation draws equal ``heat_tpu``'s bit for bit; normals differ by
  a few ulp in float32 and float64, where XLA's own log1p and fused
  polynomial round otherwise.

A draw is made for a ``Chunk``: the global shape, the split axis and this
rank's extent along it, so that a rank computes only its own elements.
Arithmetic on uint32 words is done in int64 and masked.

The plain functions here (``*_plain``, on a tensor of flat indices) serve
tensors on the CPU and are the oracle of kernel R1
(``kernels/threefry.py``, ``csrc/threefry.cu``). A draw is made by
``kernels.threefry.draw`` (and ``shuffle``), which runs them for a CPU
device and launches R1 for a CUDA one, or raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Chunk",
    "Key",
    "fold_in",
    "seed_key",
    "split",
    "threefry_2x32",
]

#: a Threefry key: its two uint32 words
Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
INTS = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


# --------------------------------------------------------------------- #
# the key algebra                                                       #
# --------------------------------------------------------------------- #
def threefry_2x32(key: Key, x0, x1):
    """Threefry-2x32 (20 rounds, a key injection every 4) of the counter
    words ``(x0, x1)`` under ``key``: Python ints or int64 tensors holding
    uint32 values; returns the two output words in the same form."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def seed_key(seed: int) -> Key:
    """``jax.random.key(seed)``: the seed's high and low 32-bit words (a
    negative seed as its 64-bit two's complement, as under x64)."""
    s = int(seed) % 2**64
    return (s >> 32) & _M32, s & _M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data`` (its low 32
    bits): the block of the counter words (0, data)."""
    return threefry_2x32(key, 0, int(data) & _M32)


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split(key, num)``: key i is the block of counter i."""
    return [threefry_2x32(key, i >> 32, i & _M32) for i in range(int(num))]


# --------------------------------------------------------------------- #
# what part of a draw a rank makes                                      #
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class Chunk:
    """The elements of a draw of global shape ``gshape`` that this rank
    makes: along ``split`` the ``length`` entries from ``start`` (all of
    every other axis); ``split`` None is the whole draw."""

    gshape: Tuple[int, ...]
    split: Optional[int] = None
    start: int = 0
    length: int = 0

    @classmethod
    def whole(cls, shape) -> "Chunk":
        return cls(tuple(int(s) for s in shape))

    @classmethod
    def of(cls, shape, split: Optional[int], comm) -> "Chunk":
        """This rank's chunk of a draw split along ``split`` over ``comm``
        (the whole draw when it is not split or the world has one rank)."""
        shape = tuple(int(s) for s in shape)
        if split is None or not comm.is_distributed():
            return cls(shape)
        start, lshape, _ = comm.chunk(shape, split)
        return cls(shape, split, int(start), int(lshape[split]))

    @property
    def lshape(self) -> Tuple[int, ...]:
        if self.split is None:
            return self.gshape
        return self.gshape[: self.split] + (self.length,) + self.gshape[self.split + 1 :]

    @property
    def numel(self) -> int:
        return math.prod(self.lshape)

    def geometry(self) -> Tuple[int, int, int, int, int]:
        """(outer, global extent, start, length, inner): the flat index of
        local element (o, j, i) is ((o · extent + start + j) · inner + i)."""
        if self.split is None:
            n = math.prod(self.gshape)
            return 1, n, 0, n, 1
        s = self.split
        return (math.prod(self.gshape[:s]), self.gshape[s], self.start, self.length,
                math.prod(self.gshape[s + 1 :]))

    def flat_index(self, device) -> torch.Tensor:
        """The global flat index of every local element (int64, local shape)."""
        outer, ext, start, length, inner = self.geometry()
        kw = dict(dtype=torch.int64, device=device)
        idx = (torch.arange(outer, **kw)[:, None, None] * ext + start + torch.arange(length, **kw)[None, :, None]) \
            * inner + torch.arange(inner, **kw)[None, None, :]
        return idx.reshape(self.lshape)


# --------------------------------------------------------------------- #
# the plain versions, on flat indices                                   #
# --------------------------------------------------------------------- #
def bits_plain(key: Key, idx: torch.Tensor, width: int) -> torch.Tensor:
    """``random_bits(key, width)`` at the flat indices ``idx``, as int64
    holding the unsigned value (64 bits: the two's-complement pattern)."""
    b1, b2 = threefry_2x32(key, idx >> 32, idx & _M32)
    if width == 64:
        return (b1 << 32) | b2
    bits = b1 ^ b2
    return bits if width == 32 else bits & ((1 << width) - 1)


def _words_as(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 ``bits`` holding a pattern of ``dtype``'s width, as ``dtype``."""
    word = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[dtype.itemsize]
    if word is torch.int16:
        bits = torch.where(bits >= 1 << 15, bits - (1 << 16), bits)
    elif word is torch.int32:
        bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(word).view(dtype)


def scalar(value, dtype: torch.dtype) -> torch.Tensor:
    """``value`` converted to ``dtype`` (a 0-d CPU tensor)."""
    return torch.tensor(value, dtype=torch.float64).to(dtype)


def uniform_bits(dtype: torch.dtype) -> int:
    """The random bits ``_uniform`` takes for ``dtype``: 8 for bfloat16, else
    the dtype's width."""
    info = torch.finfo(dtype)
    return 8 if int(round(-math.log2(info.eps))) < 8 else info.bits


def _uniform_raw(key: Key, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``_uniform``'s floats in [0, 1): the mantissa bits of 1.x, minus 1."""
    return _raw_of_bits(bits_plain(key, idx, uniform_bits(dtype)), dtype)


def _raw_of_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``_uniform``'s floats in [0, 1) of its random ``bits`` (int64)."""
    info = torch.finfo(dtype)
    nbits, nmant = info.bits, int(round(-math.log2(info.eps)))
    rng_bits = uniform_bits(dtype)
    one = int(scalar(1.0, dtype).view({16: torch.int16, 32: torch.int32, 64: torch.int64}[nbits]))
    if nbits == 64:
        fbits = ((bits >> (rng_bits - nmant)) & ((1 << 52) - 1)) | one
    else:
        fbits = (bits >> (rng_bits - nmant)) | (one & ((1 << nbits) - 1))
    return _words_as(fbits, dtype) - scalar(1.0, dtype).to(bits.device)


def uniform_params(dtype: torch.dtype, minval: float, maxval: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(minval, maxval − minval) in ``dtype``, as ``_uniform`` forms them."""
    lo, hi = scalar(minval, dtype), scalar(maxval, dtype)
    return lo, hi - lo


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """(p, e) with p = fl(a·b) and a·b = p + e exactly (Dekker)."""
    def halves(x):
        t = 134217729.0 * x  # 2^27 + 1: Veltkamp's split
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once, as XLA fuses ``_uniform``'s multiply-add in
    float32 and float64 on the CPU: float32 through float64, which holds the
    product exactly; float64 through the error-free product and sum."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    p, e = _two_prod(a, b)
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def _scale_shift(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """``x · mul + add`` in x's dtype as ``heat_tpu``'s compiled draws take it
    on the CPU (the uniform's scale and shift, and ``normal``'s std and
    mean; measured against XLA): fused into one rounding for float32
    and float64, in float32 and then rounded for float16, and rounded after
    each operation for bfloat16."""
    if x.dtype in (torch.float32, torch.float64):
        return fma_plain(x, mul, add)
    if x.dtype == torch.float16:
        return (x.float() * mul.float() + add.float()).to(x.dtype)
    return x * mul + add


def uniform_plain(key: Key, idx: torch.Tensor, dtype: torch.dtype, minval: float = 0.0,
                  maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, ..., dtype, minval, maxval)`` at ``idx``."""
    lo, span = (t.to(idx.device) for t in uniform_params(dtype, minval, maxval))
    return torch.maximum(lo, _scale_shift(_uniform_raw(key, idx, dtype), span, lo))


# XLA's erf⁻¹ (jax/_src/pallas/utils.py:199-260)
_ERFINV32_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV32_GT5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_ERFINV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
    1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693, 1.6536545626831027356,
)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
    1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
    6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
    -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635,
)
_ERFINV64_GT16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977, 4.8499064014085844221,
)


def _c(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float64).to(dtype).to(device)


def erf_inv_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's erf⁻¹ of float32 or float64 ``x``, operation for operation."""
    dt, dev = x.dtype, x.device
    w = -torch.log1p(x * -x)
    if dt == torch.float32:
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        a, b = _c(_ERFINV32_LT5, dt, dev), _c(_ERFINV32_GT5, dt, dev)
        p = torch.where(lt, a[0], b[0])
        for i in range(1, 9):
            p = torch.where(lt, a[i], b[i]) + p * w
    else:
        lt625, lt16 = w < 6.25, w < 16.0
        a, b, c = _c(_ERFINV64_LT625, dt, dev), _c(_ERFINV64_LT16, dt, dev), _c(_ERFINV64_GT16, dt, dev)

        def coef(i):
            k = a[i]
            if i < 19:
                k = torch.where(lt625, k, b[i])
            if i < 17:
                k = torch.where(lt16, k, c[i])
            return k

        w = torch.where(lt625, w - 3.125, torch.sqrt(w) - torch.where(lt16, 3.25, 5.0).to(dt))
        p = coef(0)
        for i in range(1, 17):
            p = coef(i) + p * w
        for i in range(17, 19):
            p = torch.where(lt16, coef(i) + p * w, p)
        for i in range(19, 23):
            p = torch.where(lt625, coef(i) + p * w, p)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def normal_lo(dtype: torch.dtype) -> float:
    """nextafter(−1, 0) in ``dtype``: the open end of ``_normal_real``'s
    uniform."""
    return -1.0 + float(torch.finfo(dtype).eps) / 2


def normal_plain(key: Key, idx: torch.Tensor, dtype: torch.dtype, mean: float = 0.0,
                 std: float = 1.0) -> torch.Tensor:
    """``jax.random.normal(key, ..., dtype) * std + mean`` at ``idx``."""
    return normal_of_bits(bits_plain(key, idx, uniform_bits(dtype)), dtype, mean, std)


def normal_of_bits(bits: torch.Tensor, dtype: torch.dtype, mean: float = 0.0, std: float = 1.0) -> torch.Tensor:
    """``normal_plain``'s transform of its random ``bits`` (int64, the low
    ``uniform_bits(dtype)`` bits of b1 ^ b2)."""
    lo, span = (t.to(bits.device) for t in uniform_params(dtype, normal_lo(dtype), 1.0))
    u = torch.maximum(lo, _scale_shift(_raw_of_bits(bits, dtype), span, lo))
    if dtype in (torch.float16, torch.bfloat16):
        e = erf_inv_plain(u.float()).to(dtype)
    else:
        e = erf_inv_plain(u)
    sqrt2, std_, mean_ = (scalar(v, dtype).to(bits.device) for v in (math.sqrt(2.0), std, mean))
    affine = mean != 0.0 or std != 1.0
    if dtype == torch.float16:  # XLA keeps float32 from here to one rounding
        out = e.float() * sqrt2.float()
        return (out * std_.float() + mean_.float() if affine else out).to(dtype)
    out = e * sqrt2
    return _scale_shift(out, std_, mean_) if affine else out


def _wrap_signed(v: int, nbits: int) -> int:
    v %= 1 << nbits
    return v - (1 << nbits) if v >= 1 << (nbits - 1) else v


def randint_params(low: int, high: int, dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """(nbits, span, multiplier, minval) of ``jax.random.randint(key, shape,
    low, high, dtype)`` with ``low``/``high`` int64 (x64): types under 32
    bits are sampled in int32 (``random.py:566-571``), then ``_randint``'s
    clipping, span and multiplier (``:601-645``), as Python ints; span 0
    stands for 2^nbits (a remainder by it is the identity, as in XLA)."""
    info = torch.iinfo(dtype)
    if info.bits < 32:
        s_min, s_max, nbits, v_bits = -(2**31), 2**31 - 1, 32, 32
        lo = min(max(_wrap_signed(int(low), 32), info.min), info.max)
        hi = min(max(_wrap_signed(int(high), 32), info.min), info.max + 1)
    else:
        s_min, s_max, nbits, v_bits = info.min, info.max, info.bits, 64
        lo, hi = int(low), int(high)
    v_min, v_max = -(2 ** (v_bits - 1)), 2 ** (v_bits - 1) - 1
    out_of_range = hi > min(s_max, v_max)
    lo_c = min(max(lo, max(s_min, v_min)), min(s_max, v_max))
    hi_c = min(max(hi, max(s_min, v_min)), min(s_max, v_max))
    mod = 1 << nbits
    span = (hi_c - lo_c) % mod
    if hi_c <= lo_c:
        span = 1
    if out_of_range and hi_c > lo_c:
        span = (span + 1) % mod

    def rem(a: int) -> int:
        return a % span if span else a

    mult = rem(1 << (nbits // 2))
    mult = rem((mult * mult) % mod)
    return nbits, span, mult, lo_c


def _urem(x: torch.Tensor, span: int, nbits: int) -> torch.Tensor:
    """Unsigned ``x % span`` of nbits-wide values held in int64 (for 64
    bits, two's-complement patterns); span 0 is 2^nbits."""
    if span == 0:
        return x
    if nbits == 32:
        return torch.remainder(x, span)
    if span >= 2**63:  # x < 2^64 < 2·span: one subtraction
        s = span - 2**64
        below = (x ^ -(2**63)) < (s ^ -(2**63))
        return torch.where(below, x, x - s)
    r = torch.remainder(x, span)  # floor remainder of the signed pattern
    c = 2**64 % span
    # a negative pattern is x + 2^64: add 2^64 mod span, without overflow
    fix = torch.where(r >= span - c, r - (span - c), r + c)
    return torch.where(x < 0, fix, r)


def randint_plain(key: Key, idx: torch.Tensor, low: int, high: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.randint(key, shape, low, high, dtype)`` at ``idx``."""
    nbits, span, mult, lo = randint_params(low, high, dtype)
    k1, k2 = split(key)
    higher, lower = bits_plain(k1, idx, nbits), bits_plain(k2, idx, nbits)
    mask = (1 << nbits) - 1 if nbits < 64 else -1
    off = (_urem(higher, span, nbits) * _wrap_signed(mult, 64)) & mask
    off = (off + _urem(lower, span, nbits)) & mask
    off = _urem(off, span, nbits)
    v = (off + lo) & mask
    if nbits == 32:
        v = torch.where(v >= 1 << 31, v - (1 << 32), v)
    return v.to(dtype)


def shuffle_rounds(n: int) -> int:
    """``_shuffle``'s count of sort rounds for n elements."""
    uint32max = np.iinfo(np.uint32).max
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(uint32max)))
