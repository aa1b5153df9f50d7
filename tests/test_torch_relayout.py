"""heat_tpu_torch.kernels.relayout (the pack and unpack copies K5 and K6 of
the packed pivot) against heat_tpu.kernels.relayout.

On the CPU the port's wrappers run their plain versions; they are held bit
for bit (raw words) against heat_tpu's XLA formulations
(``_pack_rows_xla``/``_unpack_rows_xla``) over dtypes, ragged rows, p in
{1, 2, 4, 8} and special float bits, and against its Pallas kernels in
interpret mode (which take no complex dtype). The kernels themselves run only on a card (``cuda`` tests)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu as jht
from heat_tpu.kernels import relayout as jrel
from heat_tpu_torch.kernels import relayout as rel


@pytest.fixture(scope="module", autouse=True)
def _heat_tpu_dtype_policy():
    jht.arange(1)  # resolves heat_tpu's device, which sets its x64 policy (64-bit types on the CPU)

# (rows, c_in, c_out, p): the executor's per-rank shapes at p = 8 (the 1 GB
# move scaled down in rows) and p = 4 ((2048, 64) <-> (8192, 16)), ragged
# and degenerate ones
SHAPES = [
    (12, 25, 32, 8),
    (512, 16, 16, 4),
    (7, 13, 15, 5),
    (16, 3, 4, 4),
    (1, 25, 32, 8),
    (0, 25, 32, 8),
    (9, 5, 6, 2),
    (5, 7, 7, 1),
    (6, 1, 8, 8),
]

DTYPES = ["bool", "int8", "uint8", "int16", "bfloat16", "float16", "int32", "float32", "int64", "float64",
          "complex64", "complex128"]

_BITS = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64, 16: np.uint64}


def _values(n: int, dtype: str, seed: int = 0) -> np.ndarray:
    """n values of ``dtype`` as numpy (bfloat16 through jax's ml_dtypes)."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(n) < 0.5
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, n, endpoint=True, dtype=dtype)
    if dtype.startswith("complex"):
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(dtype)
    return np.asarray(jnp.asarray(rng.standard_normal(n), dtype=dtype))


def _torch_of(a: np.ndarray) -> torch.Tensor:
    """The tensor of ``a`` with the same bits (bfloat16 through its words)."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _words(x) -> np.ndarray:
    """The raw words of a torch tensor or a numpy/jax array."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        es = x.element_size()
        t = x.view(torch.uint8).numpy()
    else:
        t = np.ascontiguousarray(np.asarray(x))
        es = t.dtype.itemsize
        t = t.view(np.uint8)
    return t.reshape(-1).view(_BITS[es]) if t.size else t


@pytest.mark.parametrize("rows, c_in, c_out, p", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_equal_heat_tpu_xla_bit_for_bit(rows, c_in, c_out, p, dtype):
    a = _values(rows * c_in, dtype)
    got = rel.pack_rows(_torch_of(a), rows, c_in, c_out, p)
    ref = jrel._pack_rows_xla(jnp.asarray(a), rows, c_in, c_out, p)
    assert tuple(got.shape) == tuple(ref.shape) == (p, rows * c_out // p)
    np.testing.assert_array_equal(_words(got), _words(ref))
    back = rel.unpack_rows(got, rows, c_out, c_in, p)
    ref_back = jrel._unpack_rows_xla(ref, rows, c_out, c_in, p)
    assert tuple(back.shape) == (rows * c_in,)
    np.testing.assert_array_equal(_words(back), _words(ref_back))
    np.testing.assert_array_equal(_words(back), _words(a))


@pytest.mark.parametrize("rows, c_in, c_out, p", [s for s in SHAPES if s[0] > 0])
@pytest.mark.parametrize("dtype", ["bool", "int8", "bfloat16", "int32", "float32", "float64"])
def test_plain_versions_equal_heat_tpu_pallas_interpret(rows, c_in, c_out, p, dtype):
    a = _values(rows * c_in, dtype, seed=rows)
    ref = jrel.pack_rows(jnp.asarray(a), rows, c_in, c_out, p, impl="pallas")
    got = rel.pack_rows(_torch_of(a), rows, c_in, c_out, p)
    np.testing.assert_array_equal(_words(got), _words(ref))
    ref_back = jrel.unpack_rows(ref, rows, c_out, c_in, p, impl="pallas")
    np.testing.assert_array_equal(_words(rel.unpack_rows(got, rows, c_out, c_in, p)), _words(ref_back))


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16", "complex64"])
def test_special_float_bits_survive(dtype):
    specials = np.array([np.nan, -0.0, np.inf, -np.inf, 0.0, 1e-40, -1.5, 3.0, np.nan, -0.0, 7.0, -np.nan])
    a = np.asarray(jnp.asarray(specials, dtype=dtype))
    if dtype == "float32":  # a NaN payload and a signalling-looking NaN, as raw bits
        a = a.copy()
        a.view(np.uint32)[0] = 0x7FC12345
        a.view(np.uint32)[8] = 0xFF800001
    x = _torch_of(a)
    packed = rel.pack_rows(x, 3, 4, 8, 4)
    ref = jrel._pack_rows_xla(jnp.asarray(a), 3, 4, 8, 4)
    np.testing.assert_array_equal(_words(packed), _words(ref))
    np.testing.assert_array_equal(_words(rel.unpack_rows(packed, 3, 8, 4, 4)), _words(a))
    rows_back = packed.reshape(4, 3, 2).permute(1, 0, 2).reshape(3, 8)
    assert (_words(rows_back[:, 4:]) == 0).all()  # the pad is all zero bits


def test_shape_errors_match_heat_tpu():
    x = torch.zeros(24)
    for call, jcall, args in (
        (rel.pack_rows, jrel.pack_rows, (3, 8, 6, 4)),  # c_out < c_in
        (rel.pack_rows, jrel.pack_rows, (3, 8, 9, 4)),  # p does not divide c_out
        (rel.unpack_rows, jrel.unpack_rows, (3, 8, 9, 4)),  # c_out > c_in
        (rel.unpack_rows, jrel.unpack_rows, (2, 12, 8, 5)),  # p does not divide c_in
    ):
        with pytest.raises(ValueError) as mine:
            call(x, *args)
        with pytest.raises(ValueError) as theirs:
            jcall(jnp.zeros(24), *args, impl="xla")
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="elements"):
        rel.pack_rows(torch.zeros(23), 3, 8, 8, 4)


@pytest.mark.parametrize("minor", [0, 1, 25, 64, 100, 128, 129, 250000])
def test_lane_fill_matches_heat_tpu(minor):
    assert rel.lane_fill(minor) == jrel.lane_fill(minor)
    assert (rel.LANES, rel.PACK_FILL_THRESHOLD) == (jrel.LANES, jrel.PACK_FILL_THRESHOLD)


def test_cuda_tensors_launch_or_raise_never_compute_on_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensors below would be launched")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA operand reached the plain version")

    monkeypatch.setattr(rel, "pack_rows_plain", refuse)
    monkeypatch.setattr(rel, "unpack_rows_plain", refuse)
    launches = rel.PACK_LAUNCHES, rel.UNPACK_LAUNCHES
    with FakeTensorMode():
        x = torch.empty(12 * 25, device="cuda")
        with pytest.raises(RuntimeError):  # nothing here can build or launch the kernel
            rel.pack_rows(x, 12, 25, 32, 8)
        with pytest.raises(RuntimeError):
            rel.unpack_rows(torch.empty(8, 12 * 4, device="cuda"), 12, 32, 25, 8)
        with pytest.raises(ValueError):
            rel.pack_rows(x, 12, 25, 30, 8)
    assert (rel.PACK_LAUNCHES, rel.UNPACK_LAUNCHES) == launches


# --------------------------------------------------------------------- #
# the kernels on a card                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("rows, c_in, c_out, p", SHAPES + [(1_250_000, 25, 32, 8), (512, 64, 64, 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_equal_plain_versions_on_card(rows, c_in, c_out, p, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 and K6 have no CPU mode")
    x = _torch_of(_values(rows * c_in, dtype)).cuda()
    launches = rel.PACK_LAUNCHES, rel.UNPACK_LAUNCHES
    packed = rel.pack_rows(x, rows, c_in, c_out, p)
    back = rel.unpack_rows(packed, rows, c_out, c_in, p)
    launched = int(rows > 0)
    assert (rel.PACK_LAUNCHES, rel.UNPACK_LAUNCHES) == (launches[0] + launched, launches[1] + launched)
    np.testing.assert_array_equal(_words(packed.cpu()), _words(rel.pack_rows_plain(x, rows, c_in, c_out, p).cpu()))
    np.testing.assert_array_equal(_words(back.cpu()), _words(x.cpu()))
