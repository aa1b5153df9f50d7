"""Kernel R1 on a card (``csrc/threefry.cu``): every mode and dtype against
its plain version on the same card.

R1 makes a chunk of one draw of ``heat_tpu``'s Threefry stream: the raw
bits (8, 16, 32, 64), uniform and normal draws in float16, bfloat16,
float32 and float64, randint in int8, uint8, int16, int32 and int64. Bits,
uniforms and integers must equal the plain version bit for bit; normals
too: the kernel takes the plain version's operations one by one (the
same log1p and sqrt, no contraction but the fused multiply-adds both take),
so the stated limit is 0 ulp. The cases run at 2^24 elements, at chunks
whose global flat indices cross 2^32 (the counter's high word), contiguous
(split 0) and not (split 1 of a 3-D draw), at split-1 chunks of a 2-D
draw (rank 1 of 4, rows of 1024, and rows of 1025 elements, so that a
thread's run of consecutive elements crosses a row), at a split-0 chunk
whose crossing of 2^32 falls inside a run of every length (2, 4 or 8
elements), at lengths that are no multiple of a run (3003 and 5 elements:
the last run's elements stored one by one), and at an empty chunk (no
launch). The normal transform alone (``normal_of_words``) must equal its
plain version on every input a float32, float16 or bfloat16 draw can give
it (2^23, 2^10 and 2^7 uniforms). ``shuffle`` on the card (R1's bits, K4's
pair sort) must equal its CPU result.

This module imports neither JAX nor heat_tpu, so that it runs where only
PyTorch and a card are (the repo's ``conftest.py`` imports JAX, so there it
runs as ``python -m pytest --noconftest -m cuda tests/test_torch_random_card.py``).
Without a card every test skips.
"""

import pytest
import torch

from heat_tpu_torch.core import _threefry as tf
from heat_tpu_torch.kernels import threefry as kt

pytestmark = pytest.mark.cuda

KEY = tf.fold_in(tf.seed_key(0x5BD), 17)
BIG = (4096, 4096)  # 2^24 elements
# split-0 rows 2^22 - 64 .. 2^22 + 64 of 1024 columns: flat indices 2^32 ± 65536
CROSS_ROWS = tf.Chunk((2**23, 1024), 0, 2**22 - 64, 128)
# split 1 of (4, 2^31, 2), the last 8192 columns: row 0 ends just below 2^32, rows 1-3 lie past it
CROSS_COLS = tf.Chunk((4, 2**31, 2), 1, 2**31 - 8192, 8192)
# rows of 1005: flat index 2^32 is local element 301 (odd), inside a run of 2, 4 or 8
CROSS_MID = tf.Chunk((2**23, 1005), 0, 2**32 // 1005, 8)
CHUNKS = {"big": tf.Chunk.whole(BIG), "cross_rows": CROSS_ROWS, "cross_cols": CROSS_COLS,
          "split1": tf.Chunk((1024, 4096), 1, 1024, 1024), "split1_odd_rows": tf.Chunk((999, 4100), 1, 1025, 1025),
          "cross_mid_run": CROSS_MID, "ragged": tf.Chunk.whole((3, 1001)), "tiny": tf.Chunk.whole((5,))}

CASES = (
    [("bits", dt, ()) for dt in kt.BITS_DTYPES.values()]
    + [("uniform", dt, (0.0, 1.0)) for dt in tf.FLOATS]
    + [("uniform", dt, (-0.3, 0.3)) for dt in tf.FLOATS]
    + [("normal", dt, (0.0, 1.0)) for dt in tf.FLOATS]
    + [("normal", dt, (3.0, 0.5)) for dt in tf.FLOATS]
    + [("randint", dt, (lo, hi)) for dt in tf.INTS for lo, hi in ((0, 100), (-7, 7), (-(2**7), 2**7 - 1))]
    + [("randint", torch.int64, (0, 2**40)), ("randint", torch.int64, (-(2**63), 2**63 - 1)),
       ("randint", torch.int32, (-(2**31), 2**31 - 1)), ("randint", torch.uint8, (0, 256))]
)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: R1 has no CPU mode")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw words of ``t`` (floats compared by their patterns)."""
    word = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.view(word)


@pytest.mark.parametrize("where", sorted(CHUNKS))
@pytest.mark.parametrize("mode,dtype,args", CASES, ids=lambda v: str(v))
def test_r1_equals_its_plain_version(mode, dtype, args, where):
    dev = _card()
    chunk = CHUNKS[where]
    before = kt.THREEFRY_LAUNCHES
    got = kt.draw(mode, KEY, chunk, dtype, dev, args)
    torch.cuda.synchronize()
    assert kt.THREEFRY_LAUNCHES == before + 1 and kt.THREEFRY_ELEMENTS[-1] == chunk.numel
    want = kt.draw_plain(mode, KEY, chunk, dtype, dev, args)
    assert got.shape == want.shape == chunk.lshape and got.dtype == want.dtype == dtype
    assert torch.equal(_bits(got), _bits(want)), f"{int((_bits(got) != _bits(want)).sum())} elements differ"


def test_r1_launches_nothing_for_an_empty_chunk():
    dev = _card()
    before = kt.THREEFRY_LAUNCHES
    out = kt.draw("normal", KEY, tf.Chunk((9, 4), 0, 9, 0), torch.float32, dev, (0.0, 1.0))
    assert out.shape == (0, 4) and kt.THREEFRY_LAUNCHES == before


def test_r1_reruns_bit_for_bit_and_a_chunk_is_a_slice_of_the_whole():
    dev = _card()
    whole = kt.draw("uniform", KEY, tf.Chunk.whole((1000, 37)), torch.float32, dev, (0.0, 1.0))
    again = kt.draw("uniform", KEY, tf.Chunk.whole((1000, 37)), torch.float32, dev, (0.0, 1.0))
    part = kt.draw("uniform", KEY, tf.Chunk((1000, 37), 1, 5, 11), torch.float32, dev, (0.0, 1.0))
    assert torch.equal(whole, again) and torch.equal(part, whole[:, 5:16])


@pytest.mark.parametrize("n", [1, 2, 1000, 65537])
def test_shuffle_on_the_card_equals_the_cpu(n):
    dev = _card()
    assert torch.equal(kt.shuffle(KEY, n, dev).cpu(), kt.shuffle(KEY, n, "cpu"))


@pytest.mark.parametrize("args", [(0.0, 1.0), (3.0, 0.5)], ids=str)
@pytest.mark.parametrize("dtype,shift,width", [(torch.float32, 9, 23), (torch.float16, 6, 10), (torch.bfloat16, 1, 7)],
                         ids=str)
def test_the_normal_transform_equals_its_plain_version_on_every_input(dtype, shift, width, args):
    # one word for each value of the random bits the dtype's uniform reads:
    # every uniform a normal draw can make, so the transform's log1p, square
    # root and roundings are held on their whole domain
    dev = _card()
    words = torch.arange(1 << width, dtype=torch.int64, device=dev) << shift
    words = (words - ((words >> 31) << 32)).to(torch.int32)
    got = kt.normal_of_words(words, dtype, args)
    want = tf.normal_of_bits(words.long() & ((1 << tf.uniform_bits(dtype)) - 1), dtype, *args)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == words.shape
    differ = _bits(got) != _bits(want)
    assert not bool(differ.any()), f"{int(differ.sum())} inputs differ, the first at word {int(words[differ][0])}"
