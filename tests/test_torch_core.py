"""heat_tpu_torch's core (devices, types, communicator, DNDarray,
factories, random, interop) against heat_tpu's at world size 1."""

import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu_torch.core import interop


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")


FACTORY_CALLS = [
    lambda pkg: pkg.arange(10),
    lambda pkg: pkg.arange(2, 11, 3),
    lambda pkg: pkg.arange(0.5, 3.0, 0.25),
    lambda pkg: pkg.arange(5, dtype=pkg.float64, split=0),
    lambda pkg: pkg.zeros((3, 4), split=0),
    lambda pkg: pkg.zeros(5, dtype=pkg.int64),
    lambda pkg: pkg.eye(4),
    lambda pkg: pkg.eye((3, 5), dtype=pkg.float64, split=1),
    lambda pkg: pkg.array([1.5, 2.0, -3.0]),
    lambda pkg: pkg.array([[1, 2], [3, 4]], split=1),
    lambda pkg: pkg.array(np.linspace(0, 1, 7)),
    lambda pkg: pkg.array(np.arange(6, dtype=np.int64).reshape(2, 3), split=0),
    lambda pkg: pkg.array(np.array([1 + 2j, 3 - 1j], dtype=np.complex64)),
    lambda pkg: pkg.array([True, False]),
    lambda pkg: pkg.array(3.25),
    lambda pkg: pkg.array([1, 2, 3], dtype=pkg.float32, ndmin=2),
]


@pytest.mark.parametrize("call", FACTORY_CALLS, ids=[f"f{i}" for i in range(len(FACTORY_CALLS))])
def test_factories_match_heat_tpu(call):
    ref, got = call(jht), call(ht)
    assert got.dtype.__name__ == ref.dtype.__name__
    assert got.shape == ref.shape and got.gshape == ref.gshape and got.split == ref.split
    assert got.lshape == got.shape  # world size 1
    assert got.device == ht.cpu and got.larray.device.type == "cpu"
    out = got.numpy()
    assert out.dtype == ref.numpy().dtype
    np.testing.assert_array_equal(out, ref.numpy())


@pytest.mark.parametrize(
    "name", ["bool", "uint8", "int8", "int16", "int32", "int64", "float32", "float64", "complex64", "complex128"]
)
def test_numpy_round_trip_keeps_type_and_value(name):
    values = (np.arange(-3, 9).reshape(3, 4) % 5).astype(np.dtype(name))
    x = ht.array(values)
    assert x.dtype is ht.canonical_heat_type(np.dtype(name))
    assert x.dtype.torch_type() == x.larray.dtype
    back = x.numpy()
    assert back.dtype == values.dtype
    np.testing.assert_array_equal(back, values)
    np.testing.assert_array_equal(np.asarray(x), values)
    assert x.dtype.__name__ == jht.array(values).dtype.__name__


PAIRS = [
    ("int32", "float32"), ("float32", "float64"), ("int32", "int64"), ("uint8", "int8"),
    ("bool", "int32"), ("float32", "complex64"), ("float64", "complex64"), ("int16", "float16"),
    ("bfloat16", "float16"), ("uint8", "bool"),
]


@pytest.mark.parametrize("t1, t2", PAIRS)
def test_type_lattice_matches_heat_tpu(t1, t2):
    assert ht.promote_types(t1, t2).__name__ == jht.promote_types(t1, t2).__name__
    assert ht.canonical_heat_type(t1).__name__ == jht.canonical_heat_type(t1).__name__
    for probe in ("heat_type_is_exact", "heat_type_is_complexfloating"):
        assert getattr(ht, probe)(ht.canonical_heat_type(t1)) == getattr(jht, probe)(
            jht.canonical_heat_type(t1)
        )


@pytest.mark.parametrize("name", ["float16", "float32", "float64", "complex64"])
def test_finfo_matches_heat_tpu(name):
    got, ref = ht.finfo(getattr(ht, name)), jht.finfo(getattr(jht, name))
    assert (got.bits, got.eps, got.max, got.tiny) == (ref.bits, ref.eps, ref.max, ref.tiny)


@pytest.mark.parametrize("shape, split", [((10, 3), 0), ((7,), 0), ((4, 9, 2), 1), ((3, 0), 1), ((5, 5), None)])
@pytest.mark.parametrize("w_size", [1, 3, 4])
def test_chunk_geometry_matches_heat_tpu(shape, split, w_size):
    comm, ref = ht.get_comm(), jht.get_comm()
    assert comm.size == 1 and comm.rank == 0 and not comm.is_distributed()
    for rank in range(w_size):
        assert comm.chunk(shape, split, rank=rank, w_size=w_size) == ref.chunk(
            shape, split, rank=rank, w_size=w_size
        )
    if split is not None:
        counts, displs, lshape = comm.counts_displs_shape(shape, split)
        assert counts == (shape[split],) and displs == (0,) and lshape == shape


def test_gpu_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    assert ht.sanitize_device("gpu") == ht.gpu and ht.sanitize_device("cuda:0") == ht.gpu
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.zeros(3, device="gpu")
    ht.use_device("gpu")
    try:
        assert ht.get_device() == ht.gpu
        for make in (lambda: ht.zeros(3), lambda: ht.arange(4), lambda: ht.random.randn(2, 2)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    finally:
        ht.use_device("cpu")
    assert ht.zeros(2).device == ht.cpu


def test_dndarray_surface():
    x = ht.array(np.arange(12, dtype=np.float32).reshape(3, 4), split=0)
    y = x.resplit(1)
    assert y.split == 1 and x.split == 0 and y.larray.data_ptr() != x.larray.data_ptr()
    assert x.resplit_(None) is x and x.split is None
    z = x.astype(ht.float64)
    assert z.dtype is ht.float64 and z.larray.dtype == torch.float64 and x.dtype is ht.float32
    assert float(ht.array([2.5])) == 2.5 and ht.array(7).item() == 7 and int(ht.array([3])) == 3
    with pytest.raises(ValueError):
        x.item()
    assert len(x) == 3 and x.ndim == 2 and x.size == 12 and x.nbytes == 48
    assert "dtype=ht.float32" in repr(x) and "split=None" in repr(x)
    # torch's print profile, as heat_tpu's: whole up to 1000 elements, summarized above
    assert "..." not in repr(ht.zeros((20, 20))) and "0., 0., 0., ..., 0., 0., 0." in repr(ht.zeros((40, 40)))


def test_random_draws_are_seeded_and_typed():
    ht.random.seed(7)
    a = ht.random.randn(64, 32, split=0)
    b = ht.random.rand(64, dtype=ht.float64)
    ht.random.seed(7)
    assert torch.equal(ht.random.randn(64, 32, split=0).larray, a.larray)
    assert not torch.equal(ht.random.randn(64, 32).larray, a.larray)  # the counter advanced
    assert a.split == 0 and a.dtype is ht.float32 and b.dtype is ht.float64
    assert 0.0 <= float(b.larray.min()) and float(b.larray.max()) < 1.0
    n = ht.random.normal(3.0, 0.5, (4000,))
    assert abs(float(n.larray.mean()) - 3.0) < 0.05 and abs(float(n.larray.std()) - 0.5) < 0.05
    with pytest.raises(ValueError):
        ht.random.randn(3, dtype=ht.int32)


def test_from_numpy_state_carries_heat_tpu_arrays():
    rng = np.random.default_rng(0)
    src = jht.array(rng.standard_normal((40, 12)).astype(np.float32), split=0)
    g = np.asarray(rng.standard_normal((7, 40)))  # float64 operator
    labels = np.arange(40, dtype=np.int64)
    state = interop.from_numpy_state(
        {"a": src.numpy(), "g": g, "labels": labels}, split={"a": src.split}
    )
    assert set(state) == {"a", "g", "labels"}
    a = state["a"]
    assert a.split == 0 and a.dtype is ht.float32 and a.shape == src.shape
    np.testing.assert_array_equal(a.numpy(), src.numpy())
    assert state["g"].dtype is ht.float64 and state["g"].split is None
    np.testing.assert_array_equal(state["g"].numpy(), g)
    assert state["labels"].dtype is ht.int64
    g[0, 0] = 99.0  # the port holds its own copy
    assert state["g"].numpy()[0, 0] != 99.0
    one = interop.from_numpy_state({"x": labels}, split=0)
    assert one["x"].split == 0 and one["x"].device == ht.cpu
