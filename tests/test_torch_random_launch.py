"""The host side of kernel R1 (``kernels/threefry.py``) and of its
measurement in ``chip_smoke.py``, on the CPU.

- the launch constants are made once per (mode, dtype, args) and are the
  bit patterns the plain version's scalars hold;
- the flat index of a chunk's local elements, as the kernel computes it
  (start · inner + e + ⌊e / row⌋ · (extent − length) · inner), is
  ``Chunk.flat_index``;
- the normal transform alone (``normal_of_words``) is the draw's, and the
  words ``chip_smoke.py`` gives it reach every uniform a draw can make;
- the bound counts the function's operations (``R1_OPERATIONS``) and places
  the adds where the busiest pipe is least busy; it is the busiest pipe's
  clocks, or the bytes.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from heat_tpu_torch.core import _threefry as tf
from heat_tpu_torch.kernels import threefry as kt

spec = importlib.util.spec_from_file_location("chip_smoke_r1", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)


KEY = tf.fold_in(tf.seed_key(0x5BD), 17)


def _pattern(value, dtype) -> int:
    t = tf.scalar(value, dtype)
    word = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return int(t.view(word)) % (1 << (8 * t.element_size()))


@pytest.mark.parametrize("dtype", tf.FLOATS)
def test_normal_constants_are_the_plain_scalars_and_made_once(dtype):
    got = kt._constants("normal", dtype, (3.0, 0.5))
    assert kt._constants("normal", dtype, (3.0, 0.5)) is got
    lo, span = tf.uniform_params(dtype, tf.normal_lo(dtype), 1.0)
    want = tuple(_pattern(float(v), dtype) for v in (lo, span, math.sqrt(2.0), 0.5, 3.0))
    assert got == (kt._FLOAT_CODES[dtype], want, 1)
    assert kt._constants("normal", dtype, (0.0, 1.0))[2] == 0


@pytest.mark.parametrize("dtype", tf.INTS)
def test_randint_constants_are_the_plain_parameters(dtype):
    code, a, flag = kt._constants("randint", dtype, (-7, 100))
    nbits, span, mult, lo = tf.randint_params(-7, 100, dtype)
    assert (code, a, flag) == (kt._INT_CODES[dtype], (span, mult, lo % (1 << 64), 0, 0), 0)


CHUNKS = [tf.Chunk.whole((7, 5)), tf.Chunk((7, 5), 0, 2, 3), tf.Chunk((7, 10), 1, 3, 4), tf.Chunk((3, 8, 5), 1, 2, 5),
          tf.Chunk((4, 6, 2, 3), 2, 1, 1), tf.Chunk((9, 4), 0, 9, 0)]


@pytest.mark.parametrize("chunk", CHUNKS, ids=str)
def test_the_kernels_flat_index_is_the_chunks(chunk):
    n = chunk.numel
    got = cs._r1_chunk_index(chunk, 0, n, "cpu")
    assert torch.equal(got, chunk.flat_index("cpu").reshape(-1))
    if n > 2:
        assert torch.equal(cs._r1_chunk_index(chunk, 1, n - 1, "cpu"), got[1 : n - 1])


WORD_DTYPES = [torch.float32, torch.float16, torch.bfloat16]


@pytest.mark.parametrize("args", [(0.0, 1.0), (3.0, 0.5)], ids=str)
@pytest.mark.parametrize("dtype", WORD_DTYPES, ids=str)
def test_the_normal_transform_alone_is_the_draws(dtype, args):
    idx = torch.arange(2**32 - 700, 2**32 + 300, dtype=torch.int64)
    b1, b2 = tf.threefry_2x32(KEY, idx >> 32, idx & 0xFFFFFFFF)
    words = (b1 ^ b2) - (((b1 ^ b2) >> 31) << 32)
    got = kt.normal_of_words(words.to(torch.int32), dtype, args)
    want = kt.plain_at("normal", KEY, idx, dtype, args)
    assert got.dtype == dtype and torch.equal(got.view(torch.int16 if dtype.itemsize == 2 else torch.int32),
                                              want.view(torch.int16 if dtype.itemsize == 2 else torch.int32))


def test_the_normal_transform_alone_takes_int32_words_to_32_or_16_bits():
    with pytest.raises(ValueError):
        kt.normal_of_words(torch.zeros(4, dtype=torch.int64), torch.float32)
    with pytest.raises(ValueError):
        kt.normal_of_words(torch.zeros(4, dtype=torch.int32), torch.float64)


@pytest.mark.parametrize("dtype", WORD_DTYPES, ids=str)
def test_the_transform_domain_reaches_every_uniform_once(dtype):
    words = cs.normal_transform_domain(dtype, "cpu")
    raw = tf._raw_of_bits(words.long() & ((1 << tf.uniform_bits(dtype)) - 1), dtype)
    width = {torch.float32: 23, torch.float16: 10, torch.bfloat16: 7}[dtype]
    assert words.dtype == torch.int32 and words.numel() == 1 << width
    want = torch.arange(1 << width, dtype=torch.float64) / (1 << width)
    assert torch.equal(raw.double(), want)  # every [0, 1) step of the dtype, in order


def _least_on_a_grid(ops: dict) -> float:
    """The busiest pipe's clocks at the least, the adds placed on a grid of
    quarter adds (a slow check of ``r1_clocks``' closed form)."""
    b, rates = ops["blocks"], cs.R1_RATES
    fp32, imad, xu = ops.get("fp32", 0), ops.get("imad", 0), ops.get("xu", 0)
    best = math.inf
    for merged in range(b * cs.R1_BLOCK["fold"] + 1):
        alu = b * cs.R1_BLOCK["int"] + ops.get("int", 0) + merged
        adds = b * cs.R1_BLOCK["add"] + ops.get("add", 0) - 2 * merged
        for q in range(int(4 * adds) + 1):
            a = q / 4
            best = min(best, max((alu + a) / rates["alu"], (imad + adds - a) / rates["imad"],
                                 (imad + adds - a + fp32) / rates["fma"], xu / rates["xu"],
                                 (alu + adds + imad + fp32 + xu) / rates["issue"]))
    return best


@pytest.mark.parametrize("mode,dtype", sorted(cs.R1_OPERATIONS), ids=str)
def test_the_count_places_the_adds_where_the_busiest_pipe_is_least(mode, dtype):
    count = cs.r1_clocks(mode, getattr(torch, dtype))
    least = count["clocks"][count["pipe"]]
    assert least == max(count["clocks"].values())
    assert least <= _least_on_a_grid(cs.R1_OPERATIONS[(mode, dtype)]) + 1e-12
    assert least >= _least_on_a_grid(cs.R1_OPERATIONS[(mode, dtype)]) - 0.25 / 64
    assert 0 <= count["adds_on_alu"] and 0 <= count["merged"] <= 4 * cs.R1_OPERATIONS[(mode, dtype)]["blocks"]


def test_the_count_is_the_functions():
    # a normal: one block (20 shifts, 20 xors, 31 adds, 4 injections merged
    # into three-input adds) and its transform, bound by the issue slots
    normal = cs.r1_clocks("normal", torch.float32)
    assert (normal["pipe"], normal["merged"], normal["operations"]) == ("issue", 4, 40 + 31 - 4 + 11 + 41 + 2)
    # randint: two blocks and three remainders, bound by the integer pipe
    # with every add on the FMA pipe
    randint = cs.r1_clocks("randint", torch.int32)
    assert (randint["pipe"], randint["merged"], randint["adds_on_alu"]) == ("alu", 0, 0.0)
    assert randint["clocks"]["alu"] == (2 * 40 + 5) / 64
    # 16-bit normals round the uniform, erf_inv's result and the output
    assert cs.R1_OPERATIONS[("normal", "bfloat16")]["xu"] == 0.5 + 0.5 + 2 + 0.5 + 0.5


def test_the_bound_is_the_busiest_pipe_or_the_bytes():
    chunk = tf.Chunk.whole((1 << 20,))
    clock = 1.98e9
    bound, by, pipe, t_bytes, t_ops, count = cs.r1_bound("normal", chunk, torch.float32, clock)
    assert (by, pipe) == ("operations", "issue")
    assert t_ops == pytest.approx((1 << 20) * count["clocks"]["issue"] / (132 * clock) * 1e3) and bound == t_ops
    assert t_bytes == pytest.approx(4 * (1 << 20) / 3.35e12 * 1e3)
    assert cs.r1_bound("bits", chunk, torch.int32, 1e12)[1:3] == ("bytes", "hbm")
