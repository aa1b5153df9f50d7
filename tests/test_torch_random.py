"""heat_tpu_torch's random stream against heat_tpu's, on the same seeds.

The port draws heat_tpu's stream: JAX's partitionable Threefry-2x32
(``core/_threefry.py``, kernel R1's plain version here on the CPU).

- The key algebra, bit for bit against jax's own functions: the
  Threefry-2x32 primitive on counters whose high word is nonzero (indices
  ≥ 2^32, without allocating them), ``key`` of 0, 2^31, 2^32 + 5 and
  0x5BD, ``fold_in``, ``split`` and 8/16/32/64-bit ``random_bits``.
- Every export of ``heat_tpu.random`` after the same seed, over float16,
  bfloat16, float32 and float64 and int8/16/32/64/uint8: uniform, integer,
  permutation draws bit for bit, the state after a sequence of draws
  equal, and ``set_state(heat_tpu.random.get_state())`` continuing
  heat_tpu's stream. Normals within the stated ulp limit (``NORMAL_ULPS``:
  the port's erf⁻¹ takes torch's log1p and separate roundings, XLA its own
  log1p and fused multiply-adds; measured over 10^6 draws at most 3 ulp in
  float32, 30 in float64 and 0 in float16 and bfloat16).
- A chunk of a draw (split 0, 1 and 2, ragged, empty) equals the matching
  slice of the whole draw.
- The 4-rank gloo world of test_torch_distributed.py (``_random_cases`` in
  torch_mp_worker.py) against heat_tpu on 4 devices: ``randn``, ``rand``,
  ``randint`` and ``normal`` (number and array moments) split 0 and 1,
  ragged and with an empty last rank, ``randperm(split=0)`` and
  ``permutation`` of a split-0 array; the global values heat_tpu's, each
  rank's shard its chunk, the plain generator making only the rank's
  chunk's elements, no collective but the permutation's one all-to-all.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import prng as jprng

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu_torch.core import _threefry as tf
from heat_tpu_torch.kernels import threefry as kt

import torch_mp_worker as worker
from test_torch_distributed import _result, _slices, jcomm, ranks  # noqa: F401 (fixtures)

#: the largest distance of a standard normal draw from heat_tpu's, in ulp
#: (of ``std·|z| + |mean|`` for ``normal(mean, std)``)
NORMAL_ULPS = {"float16": 1, "bfloat16": 1, "float32": 4, "float64": 32}
FLOATS = ("float16", "bfloat16", "float32", "float64")
INTS = ("int8", "int16", "int32", "int64", "uint8")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.zeros(1)  # heat_tpu's first array sets its policy, x64 on the CPU, under which its keys are made


def _words(a: np.ndarray) -> np.ndarray:
    """The raw bit patterns of a numpy array (floats, bfloat16 included)."""
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _ordered(a: np.ndarray) -> np.ndarray:
    """Float patterns mapped to integers in the order of their values, so
    that the difference of two is their distance in ulp."""
    if a.dtype.itemsize == 8:
        w = _words(a).view(np.int64)
        return np.where(w < 0, -(w & (2**63 - 1)), w)
    w, sign = _words(a).astype(np.int64), 1 << (8 * a.dtype.itemsize - 1)
    return np.where(w >= sign, sign - w, w)  # sign and magnitude to one signed scale


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(_ordered(a) - _ordered(b)).max()) if a.size else 0


def _normal_close(got: np.ndarray, ref: np.ndarray, mean=0.0, std=1.0) -> bool:
    """Within NORMAL_ULPS of heat_tpu's draw: in ulp for a standard normal,
    else within that many spacings of std·|z| + |mean| (a shifted value
    near 0 has tiny ulps that the shift's rounding does not)."""
    dtype = "bfloat16" if got.dtype.name == "bfloat16" else got.dtype.name
    if np.isscalar(mean) and np.isscalar(std) and mean == 0.0 and std == 1.0:
        return got.dtype == ref.dtype and got.shape == ref.shape and _ulps(got, ref) <= NORMAL_ULPS[dtype]
    wide = ref.astype(np.float64)
    scale = np.abs(std) * np.abs((wide - mean) / std) + np.abs(mean)
    spacing = np.spacing(scale.astype(np.float32 if dtype == "float32" else np.float64))
    if dtype in ("float16", "bfloat16"):
        spacing = scale * 2.0 ** -(10 if dtype == "float16" else 7)
    return got.shape == ref.shape and bool(np.all(np.abs(got.astype(np.float64) - wide) <= NORMAL_ULPS[dtype] * spacing))


def _same(port: np.ndarray, ref: np.ndarray) -> bool:
    return port.dtype == ref.dtype and port.shape == ref.shape and np.array_equal(_words(port), _words(ref))


def _pair(k) -> tuple:
    return tuple(int(v) for v in np.asarray(k))


# --------------------------------------------------------------------- #
# the key algebra against jax                                           #
# --------------------------------------------------------------------- #
def test_threefry_2x32_on_counters_past_2_to_the_32():
    rng = np.random.default_rng(0)
    hi = rng.integers(1, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for key in ((0, 0), (0, 0x5BD), (0xDEADBEEF, 0x12345678)):
        j1, j2 = jprng.threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]), jnp.asarray(hi), jnp.asarray(lo))
        t1, t2 = tf.threefry_2x32(key, torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64)))
        assert np.array_equal(np.asarray(j1), t1.numpy().astype(np.uint32))
        assert np.array_equal(np.asarray(j2), t2.numpy().astype(np.uint32))


@pytest.mark.parametrize("seed", [0, 2**31, 2**32 + 5, 0x5BD])
def test_seed_key(seed):
    assert tf.seed_key(seed) == _pair(jax.random.key_data(jax.random.key(seed)))
    assert tf.seed_key(seed) == _pair(jax.random.PRNGKey(seed))


def test_fold_in_and_split():
    for seed in (0, 7, 2**32 + 5):
        jk, tk = jax.random.PRNGKey(seed), tf.seed_key(seed)
        for data in (0, 1, 123456, 2**32 - 1):
            assert tf.fold_in(tk, data) == _pair(jax.random.fold_in(jk, data))
        for num in (1, 2, 5):
            assert tf.split(tk, num) == [_pair(k) for k in np.asarray(jax.random.split(jk, num))]


@pytest.mark.parametrize("width", [8, 16, 32, 64])
def test_random_bits(width):
    jk, tk = jax.random.PRNGKey(9), tf.seed_key(9)
    ref = np.asarray(jax.random.bits(jk, (13, 7), dtype=getattr(jnp, f"uint{width}")))
    got = kt.draw("bits", tk, tf.Chunk.whole((13, 7)), kt.BITS_DTYPES[width], "cpu").numpy()
    assert np.array_equal(_words(got), _words(ref))


# --------------------------------------------------------------------- #
# heat_tpu.random's exports, bit for bit                                #
# --------------------------------------------------------------------- #
def _both(call, seed=42):
    jht.random.seed(seed)
    ht.random.seed(seed)
    ref, got = call(jht), call(ht)
    assert ht.random.get_state() == jht.random.get_state()
    return got.numpy(), ref.numpy()


UNIFORM_CALLS = {
    "rand": lambda m, dt: m.random.rand(9, 5, dtype=getattr(m, dt)),
    "rand_split1": lambda m, dt: m.random.rand(9, 5, dtype=getattr(m, dt), split=1),
    "random": lambda m, dt: m.random.random((4, 3), dtype=getattr(m, dt)),
    "random_sample": lambda m, dt: m.random.random_sample((6,), dtype=getattr(m, dt)),
    "ranf": lambda m, dt: m.random.ranf(dtype=getattr(m, dt)),
    "sample": lambda m, dt: m.random.sample((2, 2, 3), dtype=getattr(m, dt)),
}


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("name", sorted(UNIFORM_CALLS))
def test_uniform_draws_bit_for_bit(name, dtype):
    got, ref = _both(lambda m: UNIFORM_CALLS[name](m, dtype))
    assert _same(got, ref)


INT_RANGES = {"int8": [(-100, 100), (-128, 127)], "int16": [(-1000, 3000)], "int32": [(0, 10), (-(2**31), 2**31 - 1)],
              "int64": [(0, 2**40), (-(2**62), 2**62)], "uint8": [(0, 256), (3, 9)]}


@pytest.mark.parametrize("dtype", INTS)
def test_integer_draws_bit_for_bit(dtype):
    for lo, hi in INT_RANGES[dtype]:
        for call in (lambda m: m.random.randint(lo, hi, (11, 3), dtype=getattr(m, dtype)),
                     lambda m: m.random.random_integer(lo, hi, (4,), dtype=getattr(m, dtype), split=0)):
            got, ref = _both(call)
            assert _same(got, ref), (lo, hi)
    got, ref = _both(lambda m: m.random.randint(7, size=(5,), dtype=getattr(m, dtype)))
    assert _same(got, ref)


@pytest.mark.parametrize("n", [1, 2, 37, 1000])
def test_permutations_bit_for_bit(n):
    for call in (lambda m: m.random.randperm(n), lambda m: m.random.randperm(n, dtype=m.int32),
                 lambda m: m.random.permutation(n)):
        got, ref = _both(call)
        assert _same(got, ref)
    data = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got, ref = _both(lambda m: m.random.permutation(m.array(data)))
    assert _same(got, ref)


NORMAL_CALLS = {
    "randn": (lambda m, dt: m.random.randn(40, 25, dtype=getattr(m, dt)), 0.0, 1.0),
    "standard_normal": (lambda m, dt: m.random.standard_normal((30, 7), dtype=getattr(m, dt)), 0.0, 1.0),
    "normal": (lambda m, dt: m.random.normal(3.0, 0.5, (40, 25), dtype=getattr(m, dt)), 3.0, 0.5),
    "normal_split1": (lambda m, dt: m.random.normal(-1.0, 2.0, (40, 25), dtype=getattr(m, dt), split=1), -1.0, 2.0),
}


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("name", sorted(NORMAL_CALLS))
def test_normal_draws_within_the_ulp_limit(name, dtype):
    call, mean, std = NORMAL_CALLS[name]
    got, ref = _both(lambda m: call(m, dtype))
    assert got.dtype == ref.dtype and _normal_close(got, ref, mean, std)


def test_normal_with_array_moments():
    mean, std = np.linspace(-2, 2, 60, dtype=np.float32).reshape(12, 5), np.full((12, 5), 0.25, np.float32)
    got, ref = _both(lambda m: m.random.normal(m.array(mean), m.array(std)))
    assert got.shape == (12, 5) and _normal_close(got, ref, mean, std)
    got, ref = _both(lambda m: m.random.normal(m.array(np.float32(1.5)), 2.0, (4, 4)))
    assert _normal_close(got, ref, 1.5, 2.0)
    # moments that broadcast against the draw, on any split
    row = np.linspace(-1, 1, 5, dtype=np.float32)
    got, ref = _both(lambda m: m.random.normal(m.array(row), 1.0, (3, 5)))
    assert got.shape == (3, 5) and _normal_close(got, ref, row, 1.0)
    got, ref = _both(lambda m: m.random.normal(m.array(row, split=0), m.array(std[:3, :1], split=0), (3, 5),
                                               split=1))
    assert got.shape == (3, 5) and _normal_close(got, ref, row, std[:3, :1])


def test_a_sequence_of_draws_and_the_state_carried_from_heat_tpu():
    def sequence(m):
        m.random.rand(3, dtype=m.float64)
        m.random.randint(0, 5, (4,))
        m.random.randperm(6)
        m.random.randn(2, 2)
        return m.random.rand(7)

    got, ref = _both(sequence, seed=2**32 + 5)
    assert _same(got, ref) and ht.random.get_state()[2] == 3 + 4 + 6 + 4 + 7
    # heat_tpu's state continues in the port, also past 2^32 elements
    jht.random.set_state(("Threefry", 77, 2**32 + 12345, 0, 0.0))
    jht.random.rand(3)
    ht.random.set_state(jht.random.get_state())
    assert _same(ht.random.rand(50, 3).numpy(), jht.random.rand(50, 3).numpy())
    assert _same(ht.random.randint(0, 9, (8,)).numpy(), jht.random.randint(0, 9, (8,)).numpy())
    assert ht.random.get_state() == jht.random.get_state()
    with pytest.raises(ValueError):
        ht.random.set_state(("TorchGenerator", 1, 0, 0, 0.0))


# --------------------------------------------------------------------- #
# a chunk is its slice of the whole draw                                #
# --------------------------------------------------------------------- #
CHUNKS = {
    "split0_ragged": ((10, 3, 4), 0, 9, 1),
    "split1": ((5, 8, 3), 1, 2, 5),
    "split2": ((4, 3, 7), 2, 3, 4),
    "split0_empty": ((9, 2), 0, 9, 0),
    "split1_empty": ((3, 4), 1, 4, 0),
}


@pytest.mark.parametrize("mode,dtype,args", [("normal", torch.float32, (0.0, 1.0)),
                                              ("uniform", torch.bfloat16, (-1.0, 1.0)),
                                              ("randint", torch.int64, (-5, 2**40)),
                                              ("bits", torch.int16, ())])
@pytest.mark.parametrize("label", sorted(CHUNKS))
def test_a_chunk_is_the_slice_of_the_whole_draw(label, mode, dtype, args):
    shape, split, start, length = CHUNKS[label]
    key = tf.seed_key(3)
    whole = kt.draw(mode, key, tf.Chunk.whole(shape), dtype, "cpu", args)
    part = kt.draw(mode, key, tf.Chunk(shape, split, start, length), dtype, "cpu", args)
    want = whole.narrow(split, start, length)
    assert part.shape == want.shape and torch.equal(part, want)


# --------------------------------------------------------------------- #
# the 4-rank world against heat_tpu on 4 devices                        #
# --------------------------------------------------------------------- #
RANDOM_CASES = [(kind, label, split) for kind in worker.RANDOM_DRAWS for label in worker.RANDOM_SHAPES
                for split in (0, 1)]


def _heat_tpu_draw(call, jcomm):
    jht.random.seed(worker.RANDOM_SEED)
    x = call()
    return x.numpy(), jht.random.get_state()


@pytest.mark.parametrize("kind, label, split", RANDOM_CASES, ids=[f"{k}-{l}-{s}" for k, l, s in RANDOM_CASES])
def test_split_draws_across_4_ranks_are_heat_tpus(ranks, jcomm, kind, label, split):
    shape = worker.RANDOM_SHAPES[label]
    ref, state = _heat_tpu_draw(lambda: worker.RANDOM_DRAWS[kind](jht, shape, split, comm=jcomm), jcomm)
    for r, res in enumerate(_result(ranks, f"random_{kind}_{label}_{split}")):
        glob = res["global"]
        assert res["split"] == split and res["gshape"] == shape and res["state"] == state
        if kind == "randn":
            assert _normal_close(glob, ref)
        elif kind == "normal":
            assert _normal_close(glob, ref, 2.0, 0.5)
        elif kind == "normal_arrays":
            assert _normal_close(glob, ref, worker._array(shape, "float32", 71),
                                 np.abs(worker._array(shape, "float32", 72)))
        else:
            assert _same(glob, ref)
        sl = _slices(shape, split, r)
        assert np.array_equal(_words(res["local"]), _words(glob[sl]))
        # the plain generator made this rank's chunk alone (none on an empty rank), and no collective ran
        assert res["made"] == [res["local"].size]
        assert res["counts"] == {}


def test_randperm_and_permutation_across_4_ranks_are_heat_tpus(ranks, jcomm):
    ref, state = _heat_tpu_draw(lambda: jht.random.randperm(worker.RANDPERM_N, split=0, comm=jcomm), jcomm)
    for r, res in enumerate(_result(ranks, "random_randperm")):
        assert _same(res["global"], ref) and res["state"] == state
        assert np.array_equal(res["local"], ref[_slices((worker.RANDPERM_N,), 0, r)])
        assert res["made"] == [worker.RANDPERM_N] * tf.shuffle_rounds(worker.RANDPERM_N)  # whole on every rank
    for label, shape in worker.RANDOM_SHAPES.items():
        data = worker._array(shape, "float32", 73)
        ref, state = _heat_tpu_draw(lambda: jht.random.permutation(jht.array(data, split=0, comm=jcomm)), jcomm)
        for r, res in enumerate(_result(ranks, f"random_permutation_{label}")):
            assert _same(res["global"], ref) and res["state"] == state and res["split"] == 0
            assert np.array_equal(res["local"], ref[_slices(shape, 0, r)])
            assert res["counts"] == {"all-to-all": 1}
