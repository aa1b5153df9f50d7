"""heat_tpu_torch's factories, types, memory, printing and DNDarray metadata
against heat_tpu's.

At world size 1 the same input goes to heat_tpu on the 8-device CPU mesh
of conftest.py and to the port on the CPU: ``ones``, ``zeros``, ``full``,
``empty`` (its metadata), the ``*_like`` forms, ``asarray``, ``linspace``,
``logspace``, ``meshgrid``, ``from_partitioned`` and
``from_partition_dict``; ``iinfo``, ``iscomplex`` and ``isreal``;
``copy`` and ``sanitize_memory_layout``; ``repr`` under torch's print
profile at 10, 1000, 1001 and 5000 elements in 1, 2 and 3 dimensions,
split None, 0 and 1, int32, float32, bool, complex64 and bfloat16, and
the print options; the metadata (``balanced``, ``gnbytes``, ``lnbytes``,
``gnumel``, ``lnumel``, ``stride``, ``strides``, ``__partitioned__``,
``tolist``, ``fill_diagonal``, ``cpu``). Values, heat type, shape and split
must be equal: exactly, except ``linspace``/``logspace``, within rtol 1e-6
in float32 and 1e-12 in float64 (both compute in float64 and cast; XLA may
fuse the multiply-add). heat_tpu's ``meshgrid`` of a split input has the
mesh's padded extent and its partition dict of a split array fails on the
padded shards, so those are held against NumPy. The 4-rank cases are the
factory and repr entries of ``INDEXING_CASES`` in torch_mp_worker.py.
"""

import numpy as np
import pytest

import heat_tpu as jht
import heat_tpu_torch as ht
from test_torch_distributed import jcomm, ranks  # noqa: F401 (the test run's 4-rank world)
from test_torch_elementwise import numpy_of, release_programs, same
from test_torch_indexing import SURFACE_PREFIXES, indexing_world


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])
    yield
    release_programs()


SPLITS = (None, 0, 1)
SHAPES = ((10, 7), (3,), (), (0, 4))


def splits_of(shape):
    """The splits of ``shape`` (an empty array only along its empty axis:
    heat_tpu fails its own sharding check otherwise)."""
    return [s for s in SPLITS if s is None or s < len(shape) and (0 not in shape or shape[s] == 0)]


# --------------------------------------------------------------------- #
# factories                                                             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ones_zeros_full_and_empty_match_heat_tpu(shape):
    for split in splits_of(shape):
        for call in (
            lambda lib: lib.ones(shape, split=split),
            lambda lib: lib.zeros(shape, dtype=lib.int64, split=split),
            lambda lib: lib.full(shape, 2.5, split=split),
            lambda lib: lib.full(shape, 7, split=split),
            lambda lib: lib.full(shape, True, split=split),
            lambda lib: lib.full(shape, 1 + 2j, split=split),
            lambda lib: lib.full(shape, np.float64(2.5), split=split),
            lambda lib: lib.full(shape, 2.7, dtype=lib.int32, split=split),
            lambda lib: lib.ones(shape, dtype=lib.bool, split=split),
        ):
            same(call(ht), call(jht), "exact")
        got, ref = ht.empty(shape, dtype=ht.int32, split=split), jht.empty(shape, dtype=jht.int32, split=split)
        assert (got.dtype.__name__, got.gshape, got.split) == (ref.dtype.__name__, ref.gshape, ref.split)


@pytest.mark.parametrize("split", SPLITS)
def test_like_factories_and_asarray_match_heat_tpu(split):
    a = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    i = np.arange(6, dtype=np.int64).reshape(3, 2)
    for call in (
        lambda lib: lib.zeros_like(lib.array(a, split=split)),
        lambda lib: lib.ones_like(lib.array(a, split=split), dtype=lib.int32),
        lambda lib: lib.full_like(lib.array(a, split=split), -3),
        lambda lib: lib.full_like(lib.array(i, split=split), 4.5),
        lambda lib: lib.zeros_like(lib.array(a, split=split), split=0),
        lambda lib: lib.ones_like(a),
        lambda lib: lib.full_like(i, 2),
        lambda lib: lib.asarray(a, dtype=lib.float64),
        lambda lib: lib.asarray([[1, 2], [3, 4]]),
        lambda lib: lib.asarray(lib.array(a, split=split), dtype=lib.int32),
    ):
        same(call(ht), call(jht), "exact")
    got, ref = ht.empty_like(ht.array(a, split=split)), jht.empty_like(jht.array(a, split=split))
    assert (got.dtype.__name__, got.gshape, got.split) == (ref.dtype.__name__, ref.gshape, ref.split)
    x = ht.array(a, split=split)
    assert ht.asarray(x) is x and ht.asarray(x, dtype=ht.float32) is x and ht.asarray(x, copy=True) is not x


LINSPACES = ((-1.0, 3.0, 37, True), (0, 1, 10, False), (2.5, -7.25, 1, True), (5, 5, 4, True), (0.1, 1e4, 1001, True))


@pytest.mark.parametrize("split", (None, 0))
@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_linspace_and_logspace_match_heat_tpu(split, dtype):
    """rtol 1e-6 in float32, 1e-12 in float64, with the same share of the
    largest magnitude as atol (a sample at 0)."""
    rtol = 1e-6 if dtype == "float32" else 1e-12

    def close(got, ref):
        assert (got.dtype.__name__, got.gshape, got.split) == (ref.dtype.__name__, ref.gshape, ref.split)
        want = numpy_of(ref)
        np.testing.assert_allclose(numpy_of(got), want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))

    for start, stop, num, endpoint in LINSPACES:
        call = lambda lib: lib.linspace(start, stop, num, endpoint=endpoint, dtype=getattr(lib, dtype), split=split)
        close(call(ht), call(jht))
        (got, gstep), (ref, rstep) = [lib.linspace(start, stop, num, endpoint=endpoint, retstep=True, split=split)
                                      for lib in (ht, jht)]
        close(got, ref)
        assert gstep == rstep or (np.isnan(gstep) and np.isnan(rstep))
    for base in (10.0, 2.0):
        call = lambda lib: lib.logspace(-2.0, 3.0, 23, base=base, dtype=getattr(lib, dtype), split=split)
        close(call(ht), call(jht))
    close(ht.logspace(0.0, 2.0, 13, split=split), jht.logspace(0.0, 2.0, 13, split=split))
    for lib in (ht, jht):
        with pytest.raises(ValueError):
            lib.linspace(0, 1, 0)


def test_meshgrid_matches_heat_tpu_and_numpy():
    """Unsplit inputs against heat_tpu; split inputs against NumPy, with
    heat_tpu's split rule (the split input's axis, the first two swapped
    under ``xy``): heat_tpu's own outputs there have the padded extent."""
    x, y, z = np.arange(5, dtype=np.int32), np.linspace(0, 1, 3).astype(np.float32), np.arange(4, dtype=np.int64)
    for indexing in ("xy", "ij"):
        for args in ((x, y), (x, y, z), (y,)):
            got = ht.meshgrid(*[ht.array(v) for v in args], indexing=indexing)
            ref = jht.meshgrid(*[jht.array(v) for v in args], indexing=indexing)
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                same(g, r, "exact")
            want = np.meshgrid(*args, indexing=indexing)
            for at in range(len(args)):
                got = ht.meshgrid(*[ht.array(v, split=0 if j == at else None) for j, v in enumerate(args)],
                                  indexing=indexing)
                dim = {0: 1, 1: 0}.get(at, at) if indexing == "xy" and len(args) >= 2 else at
                for g, w in zip(got, want):
                    assert g.split == dim and g.dtype.__name__ == str(w.dtype) and g.gshape == w.shape
                    np.testing.assert_array_equal(g.numpy(), w)
    assert ht.meshgrid() == [] == jht.meshgrid()
    with pytest.raises(ValueError):
        ht.meshgrid(ht.array(x), indexing="bogus")


def _partition_round_trip(split, a: np.ndarray) -> None:
    """``__partitioned__`` and ``from_partitioned``/``from_partition_dict``
    of ``a`` at world size 1 against heat_tpu's on a 1-device mesh."""
    import jax
    from heat_tpu.core.communication import MeshCommunication

    x = ht.array(a, split=split)
    one = MeshCommunication(devices=jax.devices()[:1])
    y = jht.array(a, split=split, comm=one)
    same(ht.from_partitioned(x), jht.from_partitioned(y), "exact")
    same(ht.from_partition_dict(x.create_partition_interface()), jht.from_partition_dict(y.__partitioned__), "exact")
    mine, theirs = x.__partitioned__, y.__partitioned__
    assert mine["shape"] == theirs["shape"] and mine["partition_tiling"] == theirs["partition_tiling"]
    assert mine["locals"] == theirs["locals"]
    for key, part in theirs["partitions"].items():
        for field in ("start", "shape", "location"):
            assert mine["partitions"][key][field] == part[field]
        np.testing.assert_array_equal(mine["partitions"][key]["data"].float().numpy(),
                                      np.asarray(part["data"]).astype(np.float32))
    if split is None:
        if a.dtype == np.float32:  # heat_tpu reads a tensor through np.asarray, which has no bfloat16
            same(jht.from_partitioned(x), jht.array(a), "exact")
        same(ht.from_partitioned(jht.array(a)), x, "exact")


@pytest.mark.parametrize("split", SPLITS)
def test_partition_interface_round_trips_and_matches_heat_tpu(split):
    """At world size 1 the port's partition dict and heat_tpu's agree (one
    partition: the tiling, and so the split, is lost in both); heat_tpu
    reads the port's unsplit dict and the port reads heat_tpu's. The
    4-rank world's ``from_partitioned_*`` cases keep the split."""
    _partition_round_trip(split, np.random.default_rng(1).standard_normal((6, 5)).astype(np.float32))
    with pytest.raises(AttributeError):
        ht.from_partitioned(np.zeros(3))


@pytest.mark.parametrize("split", SPLITS)
def test_partition_interface_keeps_bfloat16(split):
    """``from_partitioned`` of a bfloat16 array is bfloat16, as in
    heat_tpu, whether the parts are the port's tensors or heat_tpu's."""
    import ml_dtypes

    a = np.random.default_rng(1).standard_normal((6, 5)).astype(ml_dtypes.bfloat16)
    _partition_round_trip(split, a)
    assert ht.from_partitioned(ht.array(a, split=split)).dtype is ht.bfloat16


# --------------------------------------------------------------------- #
# types and memory                                                      #
# --------------------------------------------------------------------- #
def test_iinfo_matches_heat_tpu():
    for name in ("uint8", "int8", "int16", "int32", "int64"):
        got, ref = ht.iinfo(getattr(ht, name)), jht.iinfo(getattr(jht, name))
        assert (got.bits, got.min, got.max) == (ref.bits, ref.min, ref.max)
    assert ht.iinfo("int32").max == 2 ** 31 - 1
    for lib in (ht, jht):
        with pytest.raises(ValueError):
            lib.iinfo(lib.bool)
        for bad in (lib.float32, lib.complex64, "bogus"):
            with pytest.raises(TypeError):
                lib.iinfo(bad)


@pytest.mark.parametrize("split", (None, 0))
def test_iscomplex_and_isreal_match_heat_tpu(split):
    c = np.array([1 + 0j, 2 + 1j, -1j, 0, 3.5 - 0j], dtype=np.complex64)
    for data in (c, c.real.astype(np.float32), np.array([1, 0, 3], np.int32), np.array([True, False])):
        for fn in ("iscomplex", "isreal"):
            same(getattr(ht, fn)(ht.array(data, split=split)), getattr(jht, fn)(jht.array(data, split=split)),
                 "exact")


@pytest.mark.parametrize("split", SPLITS)
def test_copy_and_memory_layout_match_heat_tpu(split):
    a = np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32)
    x = ht.array(a, split=split)
    y = ht.copy(x)
    same(y, jht.copy(jht.array(a, split=split)), "exact")
    y[0] = 5.0
    np.testing.assert_array_equal(x.numpy(), a)
    for order in ("C", "F", "K"):
        assert ht.sanitize_memory_layout(x, order) is x
    for lib in (ht, jht):
        with pytest.raises(ValueError):
            lib.sanitize_memory_layout(lib.array(a), "X")


# --------------------------------------------------------------------- #
# printing                                                              #
# --------------------------------------------------------------------- #
REPR_SHAPES = {
    10: ((10,), (2, 5), (2, 5, 1)),
    1000: ((1000,), (40, 25), (10, 10, 10)),
    1001: ((1001,), (7, 143), (7, 11, 13)),
    5000: ((5000,), (50, 100), (10, 20, 25)),
}


@pytest.mark.parametrize("size", list(REPR_SHAPES))
@pytest.mark.parametrize("ndim", (1, 2, 3))
def test_repr_matches_heat_tpu(size, ndim):
    """torch's print profile: the whole array up to 1000 elements, else
    the edge items only (``_edge_block``: no more than they reach the
    host); int32, float32, bool, complex64 and bfloat16 split 0, float32
    split None and 1."""
    shape = REPR_SHAPES[size][ndim - 1]
    a = np.random.default_rng(size + ndim).standard_normal(shape) * 50
    for split in splits_of(shape):
        for dtype in ("int32", "float32", "bool", "complex64", "bfloat16") if split == 0 else ("float32",):
            got, ref = [repr(lib.array(a, dtype=getattr(lib, dtype), split=split)) for lib in (ht, jht)]
            assert got == ref, (shape, split, dtype, got, ref)
            assert str(ht.array(a, dtype=getattr(ht, dtype), split=split)) == got


def test_repr_copies_only_the_edge_items(monkeypatch):
    """Above the threshold the host sees the edge block, never the array:
    ``numpy()`` is not called and the block is (2e + 1) a long axis."""
    from heat_tpu_torch.core import printing

    x = ht.zeros((10_000, 100), split=0)
    monkeypatch.setattr(ht.DNDarray, "numpy", lambda self: pytest.fail("repr gathered the whole array"))
    block = printing._edge_block(x, 3)
    assert block.shape == (7, 7)
    assert "..." in repr(x) and len(repr(x)) < 4000


def test_print_options_and_printing_modes_match_heat_tpu(capsys):
    """test_types_printing_misc.py::TestPrinting's inputs."""
    old = ht.get_printoptions()
    assert old == jht.get_printoptions()
    a = np.array([1.23456789, -2.5e-5, 1e6])
    try:
        for opts in ({"precision": 2}, {"profile": "short"}, {"sci_mode": True}, {"linewidth": 20},
                     {"profile": "full"}, {"edgeitems": 1, "threshold": 2}):
            ht.set_printoptions(**opts)
            jht.set_printoptions(**opts)
            assert ht.get_printoptions() == jht.get_printoptions()
            for x in (a, np.arange(30, dtype=np.float32).reshape(5, 6)):
                assert repr(ht.array(x, split=0)) == repr(jht.array(x, split=0))
        for lib in (ht, jht):
            with pytest.raises(ValueError):
                lib.set_printoptions(profile="bogus")
    finally:
        for lib in (ht, jht):
            lib.set_printoptions(profile="default", sci_mode=False)
            lib.set_printoptions(**{k: v for k, v in old.items() if v is not None})
    ht.local_printing()
    try:
        assert repr(ht.arange(8, split=0)) == repr(jht.arange(8, split=0))
    finally:
        ht.global_printing()
    ht.print0("hello-from-rank0")
    assert capsys.readouterr().out == "hello-from-rank0\n"


# --------------------------------------------------------------------- #
# metadata                                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ("float32", "int64", "bfloat16", "complex64", "bool"))
def test_metadata_matches_heat_tpu(split, dtype):
    a = np.random.default_rng(3).standard_normal((5, 3, 2)) * 3
    x, y = ht.array(a, dtype=getattr(ht, dtype), split=split), jht.array(a, dtype=getattr(jht, dtype), split=split)
    for name in ("gnbytes", "nbytes", "gnumel", "size", "stride", "strides", "balanced"):
        assert getattr(x, name) == getattr(y, name), name
    assert x.lnumel == x.gnumel and x.lnbytes == x.gnbytes  # this rank's shard: the whole array
    want = numpy_of(y).tolist()
    assert x.tolist() == want
    assert x.cpu() is x


@pytest.mark.parametrize("split", SPLITS)
def test_fill_diagonal_matches_heat_tpu(split):
    for shape in ((5, 5), (3, 6), (6, 3)):
        a = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
        got, ref = ht.array(a, split=split), jht.array(a, split=split)
        assert got.fill_diagonal(-1.5) is got
        ref.fill_diagonal(-1.5)
        same(got, ref, "exact")
    with pytest.raises(ValueError):
        ht.zeros((2, 2, 2)).fill_diagonal(0)


def test_balanced_reports_an_uneven_map():
    """A slice of the split axis keeps its rows where they fall (the Heat
    reference's layout), which ``balanced`` reports; ``balance_`` moves
    them to the chunk geometry. Here at world size 1 every map is the
    chunk geometry; the 4-rank world's ``get_uneven_*`` cases cover the
    others."""
    x = ht.arange(10, split=0)
    assert x.balanced and x[2:7].balanced and x.is_balanced()


# --------------------------------------------------------------------- #
# across ranks                                                          #
# --------------------------------------------------------------------- #
def _world_cases():
    import torch_mp_worker as worker

    return sorted(n for n in worker.INDEXING_CASES if n.startswith(SURFACE_PREFIXES))


@pytest.mark.parametrize("name", _world_cases())
def test_factories_and_repr_across_four_ranks_match_heat_tpu(ranks, jcomm, name):  # noqa: F811
    """Each rank makes only its chunk; repr gathers the edge items (one
    all-gather) and renders heat_tpu's string on every rank."""
    indexing_world(ranks, jcomm, name)


def test_repr_across_four_ranks_gathers_only_edge_items(ranks):  # noqa: F811
    from test_torch_distributed import _result

    for name in ("repr_split0", "repr_split1", "repr_3d_split2", "repr_empty_rank_big", "repr_int_split0"):
        for res in _result(ranks, f"indexing_{name}"):
            assert res["counts"] == {"all-gather": 1}, (name, res["counts"])
