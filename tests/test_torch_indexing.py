"""heat_tpu_torch's indexing against heat_tpu's: ``DNDarray.__getitem__`` and
``__setitem__`` with every key kind, ``lloc`` and ``LocalIndex``,
``__iter__``, ``nonzero`` and ``where``.

At world size 1 the same NumPy input goes to heat_tpu on the 8-device CPU
mesh of conftest.py and to the port on the CPU; the values (exactly), the
heat type, the global shape and the split must be equal. Keys: ints,
slices with every step sign, ``Ellipsis``, ``None``, lists, numpy and
DNDarray integer keys, element and row masks, mixed basic and advanced
tuples and bool scalars, on 10 and 3 rows split None, 0 and 1; float32
for every key, int64, bool and complex64 for a subset. Out-of-range
advanced keys are the one difference: heat_tpu clamps them in a read and
drops them in a write, the port raises IndexError as NumPy does
(``test_out_of_range_advanced_keys_raise_where_heat_tpu_clamps_or_drops``).
The 4-rank cases are ``INDEXING_CASES`` of torch_mp_worker.py, run in the
test run's world and held against heat_tpu on 4 devices.
"""

import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from test_torch_distributed import jcomm, ranks  # noqa: F401 (the test run's 4-rank world)
from test_torch_elementwise import numpy_of, release_programs, same, values


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])
    yield
    release_programs()


SPLITS = (None, 0, 1)
ROWS = (10, 3)
COLS = 7


def arr(lib, v, **kw):
    """``v`` as a key: a numpy array for NumPy's own check (``lib`` None),
    else a DNDarray of the package."""
    return np.asarray(v) if lib is None else lib.array(np.asarray(v), **kw)


# name -> key(lib, x, src): x is the operand (numpy where lib is None), src a
# float array of its shape that masks are drawn from
KEYS = {
    "int": lambda L, x, s: 2,
    "int_neg": lambda L, x, s: -1,
    "int_pair": lambda L, x, s: (1, 3),
    "int_neg_pair": lambda L, x, s: (-1, -2),
    "slice_all": lambda L, x, s: slice(None),
    "slice_from": lambda L, x, s: slice(1, None),
    "slice_step": lambda L, x, s: slice(2, 9, 3),
    "slice_reverse": lambda L, x, s: slice(None, None, -1),
    "slice_neg_step": lambda L, x, s: slice(8, 1, -3),
    "slice_neg_step2": lambda L, x, s: slice(None, None, -2),
    "slice_empty": lambda L, x, s: slice(5, 2),
    "slice_past_front": lambda L, x, s: slice(-20, None, -1),
    "slice_down_to_front": lambda L, x, s: slice(2, None, -1),
    "slice_cols_reverse": lambda L, x, s: (slice(None), slice(6, None, -4)),
    "slice_2d": lambda L, x, s: (slice(1, 3), slice(None, None, 2)),
    "slice_empty_cols": lambda L, x, s: (slice(None), slice(3, 3)),
    "ellipsis_last": lambda L, x, s: (Ellipsis, 1),
    "ellipsis_first": lambda L, x, s: (1, Ellipsis),
    "ellipsis_alone": lambda L, x, s: Ellipsis,
    "ellipsis_reverse": lambda L, x, s: (Ellipsis, slice(None, None, -1)),
    "none_front": lambda L, x, s: None,
    "none_slice": lambda L, x, s: (None, slice(1, 3)),
    "none_middle": lambda L, x, s: (slice(None), None, 2),
    "list": lambda L, x, s: [2, 0, 2],
    "list_neg": lambda L, x, s: [-1],
    "numpy_ints": lambda L, x, s: np.array([1, 0]),
    "numpy_ints_2d": lambda L, x, s: np.array([[0, 2], [1, 1]]),
    "numpy_cols": lambda L, x, s: (slice(None), np.array([6, 0, 6])),
    "dnd_ints": lambda L, x, s: arr(L, [2, 0]),
    "dnd_ints_split": lambda L, x, s: arr(L, [2, 0, 1], split=0),
    "mask_elements": lambda L, x, s: arr(L, s > 0.3, split=getattr(x, "split", None)),
    "mask_elements_none": lambda L, x, s: arr(L, s > 99.0, split=getattr(x, "split", None)),
    "mask_numpy": lambda L, x, s: s > 0.3,
    "mask_rows": lambda L, x, s: arr(L, s[:, 0] > 0, split=0),
    "mask_rows_whole": lambda L, x, s: arr(L, s[:, 0] > 0),
    "mask_rows_in_tuple": lambda L, x, s: (arr(L, s[:, 0] > 0), slice(1, 4)),
    "mixed_rows_slice": lambda L, x, s: (np.array([0, 2]), slice(1, 5)),
    "mixed_slice_list": lambda L, x, s: (slice(None), [1, 3]),
    "mixed_pairs": lambda L, x, s: (np.array([0, 1]), np.array([3, 4])),
    "mixed_int_list": lambda L, x, s: (1, [0, 6]),
    "mixed_apart": lambda L, x, s: ([0, 2], None, slice(None, None, -1)),
    "bool_true": lambda L, x, s: True,
    "bool_false": lambda L, x, s: False,
}
DTYPE_KEYS = ("int", "slice_step", "slice_reverse", "list", "dnd_ints", "mask_elements", "mask_rows",
              "mixed_int_list")
REPEATS = ("list", "numpy_ints_2d", "numpy_cols")  # repeated indices: a write's order is undefined
# a bare Python list: heat_tpu's write refuses it (jnp's ``at[]`` raises
# TypeError), the port writes it as NumPy does (ROADMAP "Not faults")
LISTS = ("list_neg",)


def operand(rows: int, dtype: str, seed: int = 5):
    return values((rows, COLS), dtype, seed=seed), np.random.default_rng(seed + 1).standard_normal((rows, COLS))


def valid(name: str, a: np.ndarray, src: np.ndarray) -> bool:
    """NumPy takes the key on this operand (out-of-range keys are the
    subject of their own test)."""
    try:
        a[KEYS[name](None, a, src)]
    except IndexError:
        return False
    return True


def get_cases():
    """Every key on 10 rows split None, 0 and 1 and on 3 rows (fewer than
    heat_tpu's 8 devices) split 0, in float32; a subset in the other
    dtypes."""
    out = [(name, rows, split, "float32") for name in KEYS for rows in ROWS for split in SPLITS
           if rows == 10 or split == 0]
    out += [(name, 10, split, dt) for name in DTYPE_KEYS for split in SPLITS for dt in ("int64", "bool", "complex64")]
    return out


@pytest.mark.parametrize("name,rows,split,dtype", get_cases())
def test_getitem_matches_heat_tpu(name, rows, split, dtype):
    a, src = operand(rows, dtype)
    if not valid(name, a, src):
        pytest.skip("NumPy refuses this key on this operand (out of range)")

    def call(lib):
        x = lib.array(a, dtype=getattr(lib, dtype), split=split)
        return x[KEYS[name](lib, x, src)]

    ref = call(jht)
    got = call(ht)
    same(got, ref, "exact")
    np.testing.assert_array_equal(numpy_of(got), a[KEYS[name](None, a, src)])


def set_cases():
    return [c for c in get_cases() if c[0] not in REPEATS]


@pytest.mark.parametrize("name,rows,split,dtype", set_cases())
def test_setitem_matches_heat_tpu(name, rows, split, dtype):
    """An array of the selection's shape written through the key: the
    whole operand after the write equals heat_tpu's. On 10 float32 rows
    also a scalar and (where the selection has axes) the array as a
    split-0 DNDarray, held against NumPy."""
    a, src = operand(rows, dtype)
    if not valid(name, a, src):
        pytest.skip("NumPy refuses this key on this operand (out of range)")
    shape = a[KEYS[name](None, a, src)].shape
    v = values(shape, dtype, seed=9)
    kinds = ("scalar", "array", "dndarray") if dtype == "float32" and rows == 10 else ("array",)
    for value in kinds:
        if value == "dndarray" and (not shape or rows != 10):
            continue

        def call(lib):
            x = lib.array(a, dtype=getattr(lib, dtype), split=split)
            vv = {"scalar": 3, "array": v, "dndarray": lib.array(v, dtype=getattr(lib, dtype), split=0)
                  if value == "dndarray" else None}[value]
            x[KEYS[name](lib, x, src)] = vv
            return x

        got = call(ht)
        if name in LISTS:
            with pytest.raises(TypeError):
                call(jht)
        elif value == "array":
            same(got, call(jht), "exact")
        assert (got.dtype.__name__, got.split, got.gshape) == (dtype, split, a.shape)
        want = a.copy()
        want[KEYS[name](None, a, src)] = 3 if value == "scalar" else v
        np.testing.assert_array_equal(numpy_of(got), want)


@pytest.mark.parametrize("split", SPLITS)
def test_results_never_alias_the_operand(split):
    a, _ = operand(10, "float32")
    x = ht.array(a, split=split)
    for key in (slice(2, 5), 3, (slice(None), 1), Ellipsis, (None, slice(1, 3)), [1, 2], slice(None, None, -1)):
        b = x[key]
        b[...] = -1.0
        np.testing.assert_array_equal(x.numpy(), a)
    for row in x:
        row[...] = 7.0  # a write into an iterated row leaves the source as it was
    np.testing.assert_array_equal(x.numpy(), a)
    np.testing.assert_array_equal(np.stack([r.numpy() for r in ht.array(a, split=split)]), a)


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("split", SPLITS)
def test_resplit_result_does_not_share_the_operand(split, axis):
    """``y = x.resplit(axis)`` has its own memory also where no data move
    (the same axis, or one rank): a write into ``x`` leaves ``y`` as
    heat_tpu's immutable arrays leave it. The 4-rank world's
    ``set_after_resplit_*`` cases hold the same across ranks."""
    a, _ = operand(10, "float32")
    got, ref = ht.array(a, split=split), jht.array(a, split=split)
    y, y_ref = got.resplit(axis), ref.resplit(axis)
    got[4] = -5.0
    ref[4] = -5.0
    same(y, y_ref, "exact")
    np.testing.assert_array_equal(y.numpy(), a)
    same(got, ref, "exact")


@pytest.mark.parametrize("split", SPLITS)
def test_iteration_matches_heat_tpu(split):
    a, _ = operand(3, "int64")
    for got, ref in zip(ht.array(a, split=split), jht.array(a, split=split)):
        same(got, ref, "exact")


def test_out_of_range_keys_raise_where_heat_tpu_clamps_or_drops():
    """ROADMAP "Not faults": jnp clamps an out-of-range read, of an integer
    or of an integer array, and drops an out-of-range advanced write
    (``mode="drop"``, heat_tpu dndarray.py:1038); the port raises
    IndexError, as NumPy does. A basic write out of range raises in both."""
    a = np.arange(70, dtype=np.float32).reshape(10, 7)
    x, y = jht.array(a, split=0), ht.array(a, split=0)
    np.testing.assert_array_equal(x[np.array([12])].numpy(), a[[9]])  # heat_tpu clamps to row 9
    with pytest.raises(IndexError):
        y[np.array([12])]
    x[np.array([0, 15])] = -1.0  # heat_tpu writes row 0 and drops 15
    want = a.copy()
    want[0] = -1.0
    np.testing.assert_array_equal(x.numpy(), want)
    with pytest.raises(IndexError):
        y[np.array([0, 15])] = -1.0
    np.testing.assert_array_equal(y.numpy(), a)  # nothing written
    np.testing.assert_array_equal(x[12].numpy(), a[9])  # heat_tpu clamps an integer too
    np.testing.assert_array_equal(x[3, 9].numpy(), a[3, 6])
    for key in (12, -11, (3, 9)):
        with pytest.raises(IndexError):
            y[key]
    for lib in (jht, ht):
        z = lib.array(a, split=0)
        with pytest.raises(IndexError):
            z[7, 9] = 1.0
        with pytest.raises(IndexError, match="too many"):
            z[1, 2, 3] = 0.0


# --------------------------------------------------------------------- #
# the inputs of heat_tpu's own tests that index                          #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [16, 13])
def test_basic_assignments_of_test_types_printing_misc(n):
    """tests/test_types_printing_misc.py::TestBasicSetitem and its
    regressions: ints, slices, Ellipsis, a row, negative steps, bool
    scalar keys, an empty write below the range."""
    x = np.random.default_rng(0).standard_normal((n, 4)).astype(np.float32)

    def call(lib):
        a = lib.array(x, split=0)
        a[0] = 9.0
        a[-1] = 5.0
        a[2:5] = 1.5
        a[:, 1] = 2.0
        a[...] = lib.array(x * 2)
        a[3] = np.arange(4, dtype=np.float32)
        a[::-1] = lib.array(x[:, ::-1].copy())
        a[-20::-1] = 99.0
        a[5:2] = 42.0
        return a

    same(call(ht), call(jht), "exact")
    for key, flag in ((True, 5.0), (False, 5.0)):
        got, ref = ht.zeros(4), jht.zeros(4)
        got[key] = flag
        ref[key] = flag
        same(got, ref, "exact")
    c, d = ht.arange(13, split=0, dtype=ht.float32), jht.arange(13, split=0, dtype=jht.float32)
    c[::-1] = np.arange(13, dtype=np.float32)
    d[::-1] = np.arange(13, dtype=np.float32)
    same(c, d, "exact")


def test_advanced_assignments_of_test_types_printing_misc():
    x = np.random.default_rng(1).standard_normal(13).astype(np.float32)
    m = x > 0

    def call(lib):
        a = lib.array(x, split=0)
        a[np.array([1, 5])] = 7.0
        a[lib.array(m, split=0)] = 0.25
        return a

    same(call(ht), call(jht), "exact")


def test_lloc_and_local_index_as_in_heat_tpu():
    """tests/test_types_printing_misc.py::TestLloc: at world size 1 the
    rank's tensor is the whole array, as in heat_tpu."""
    for lib in (ht, jht):
        x = lib.arange(16, split=0, dtype=lib.float32)
        assert float(np.asarray(x.lloc[3])) == 3.0
        x.lloc[0] = 99.0
        assert float(x.numpy()[0]) == 99.0
        y = lib.arange(10, split=0, dtype=lib.float32)
        assert float(np.asarray(y.lloc[-1])) == 9.0
        with pytest.raises(IndexError):
            y.lloc[50]
        with pytest.raises(IndexError):
            y.lloc[50] = 7.0
        y.lloc[0:2] = lib.array(np.array([7.0, 8.0], np.float32))
        assert list(y.numpy()[:2]) == [7.0, 8.0]
        z = lib.arange(10, split=0, dtype=lib.float32)
        m = z > 5
        np.testing.assert_array_equal(np.asarray(z.lloc[m]), np.arange(6, 10))
        z.lloc[m] = 0.0
        assert float(z.numpy().sum()) == sum(range(6))
    t = ht.arange(10, split=0)
    assert isinstance(t[ht.LocalIndex(slice(2, 4))], torch.Tensor)
    np.testing.assert_array_equal(t[ht.LocalIndex(slice(2, 4))].numpy(), [2, 3])
    t[ht.LocalIndex(1)] = 50
    assert int(t.numpy()[1]) == 50


def test_mask_selection_of_test_compaction():
    """tests/test_compaction.py::TestBoolMaskGetitem and the dense
    selection of TestChunkedBalancedGather."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(37).astype(np.float32)
    cases = [
        (x, lambda lib, h: h > 0),
        (np.random.default_rng(3).standard_normal((11, 7)).astype(np.float32), lambda lib, h: h < 0.2),
        (np.arange(10, dtype=np.float32), lambda lib, h: h > 99.0),
        (np.arange(10, dtype=np.float32), lambda lib, h: h > -1.0),
    ]
    r4 = np.random.default_rng(4).standard_normal((13, 4)).astype(np.float32)
    cases.append((r4, lambda lib, h: lib.array(r4[:, 0] > 0, split=0)))
    dense = np.random.default_rng(3).standard_normal(1037).astype(np.float32)
    keep = np.random.default_rng(3).random(1037) < 0.95
    cases.append((dense, lambda lib, h: lib.array(keep, split=0)))
    for data, key in cases:
        got, ref = [(lambda h: h[key(lib, h)])(lib.array(data, split=0)) for lib in (ht, jht)]
        same(got, ref, "exact")
    s = np.random.default_rng(5).standard_normal((6, 9)).astype(np.float32)
    got, ref = [(lambda h: h[h > 0])(lib.array(s, split=1)) for lib in (ht, jht)]
    same(got, ref, "exact")


@pytest.mark.parametrize("split,dtype", [(s, "float32") for s in SPLITS] + [(0, d) for d in ("int64", "bool",
                                                                                          "complex64")])
def test_nonzero_matches_heat_tpu(split, dtype):
    """test_compaction.py::TestNonzero and test_indexing_signal_io.py's
    inputs on every split, and the other dtypes split 0."""
    rng = np.random.default_rng(6)
    sets = [(rng.random((9, 5)) < 0.4) * rng.standard_normal((9, 5)), np.array([[0, 1, 0], [2, 0, 3]]),
            np.zeros((3, 4))]
    for data in sets if dtype == "float32" else sets[:1]:
        a = data.astype(dtype)
        got, ref = ht.nonzero(ht.array(a, split=split)), jht.nonzero(jht.array(a, split=split))
        same(got, ref, "exact")
    for data in (np.array([0.0, 1.0, 0.0, 2.0, 0.0, 0.0, 3.0]), np.zeros(11))[: 2 if dtype == "float32" else 1]:
        s = None if split is None else 0
        same(ht.nonzero(ht.array(data.astype(dtype), split=s)), jht.nonzero(jht.array(data.astype(dtype), split=s)),
             "exact")
    for lib in (ht, jht):  # NumPy 2 and jnp refuse a 0-d operand
        with pytest.raises(ValueError):
            lib.nonzero(lib.array(np.float32(2.0)))


@pytest.mark.parametrize("split", SPLITS)
def test_where_matches_heat_tpu(split):
    """test_indexing_signal_io.py::test_where, broadcasting, mixed splits,
    Python scalars on both sides and integer operands."""
    d = np.random.default_rng(7).standard_normal((5, 6)).astype(np.float32)
    i = np.random.default_rng(8).integers(-5, 5, (5, 6)).astype(np.int32)
    calls = [
        lambda lib, x: lib.where(x > 0, x, 0.0),
        lambda lib, x: lib.where(x > 0, 1.0, -1.0),
        lambda lib, x: lib.where(x > 0, 1, 0),
        lambda lib, x: lib.where(x > 0, x, lib.array(i, split=split)),
        lambda lib, x: lib.where(x > 0, lib.array(i), 2.5),
        lambda lib, x: lib.where(lib.array(d[0] > 0), x, -x),
        lambda lib, x: lib.where(x > 0, lib.array(d[:, :1], split=0), x),
        lambda lib, x: lib.where(lib.array(d > 0), lib.array(d, split=0), lib.array(d, split=1)),
        lambda lib, x: lib.where(x > 0),
    ]
    for call in calls:
        same(call(ht, ht.array(d, split=split)), call(jht, jht.array(d, split=split)), "exact")
    for lib in (ht, jht):
        with pytest.raises(TypeError):
            lib.where(lib.array(d) > 0, lib.array(d))


# --------------------------------------------------------------------- #
# across ranks: the test run's 4-rank world (torch_mp_worker.py's        #
# INDEXING_CASES) against heat_tpu on 4 devices                          #
# --------------------------------------------------------------------- #
SURFACE_PREFIXES = ("ones", "full", "zeros", "approx_", "meshgrid", "from_", "repr", "fill_")  # test_torch_factories.py


def indexing_world(ranks, jcomm, name: str) -> None:  # noqa: F811
    """Every rank's result of ``INDEXING_CASES[name]`` against heat_tpu's on
    the 4-device mesh (or against NumPy where heat_tpu is at fault,
    ``NUMPY_REFERENCE``): values exactly, dtype, split and shape; a rank in
    the chunk geometry holds heat_tpu's device-r chunk; repr strings
    equal."""
    import torch_mp_worker as worker
    from test_torch_distributed import WORLD, _result

    if name in worker.NUMPY_REFERENCE:
        values_of, split, dtype = worker.NUMPY_REFERENCE[name]
        want = values_of()
    else:
        ref = worker.INDEXING_CASES[name](jht, {"comm": jcomm})
        if isinstance(ref, str):
            for res in _result(ranks, f"indexing_{name}"):
                assert res["value"] == ref, (res["value"], ref)
            return
        want, split, dtype = numpy_of(ref), ref.split, ref.dtype.__name__
    for r, res in enumerate(_result(ranks, f"indexing_{name}")):
        assert res["dtype"] == dtype and res["split"] == split, (res["dtype"], dtype, res["split"], split)
        assert tuple(res["gshape"]) == want.shape
        # linspace/logspace: float64 then cast on both sides; XLA may fuse the
        # multiply-add, so a sample at 0 may differ by float64's last bits
        check = (lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max())) \
            if name.startswith("approx_") else np.testing.assert_array_equal
        check(res["global"], want)
        if res["split"] is not None and np.array_equal(res["lmap"], jcomm.lshape_map(want.shape, split)):
            check(res["local"], want[jcomm.chunk(want.shape, split, rank=r)[2]])
    assert len(_result(ranks, f"indexing_{name}")) == WORLD


def _world_cases():
    import torch_mp_worker as worker

    return sorted(n for n in worker.INDEXING_CASES if not n.startswith(SURFACE_PREFIXES))


@pytest.mark.parametrize("name", _world_cases())
def test_indexing_across_four_ranks_matches_heat_tpu(ranks, jcomm, name):  # noqa: F811
    """Gets and sets with every key kind, masks, nonzero and where across
    4 ranks, a rank with no rows and an uneven map among them."""
    indexing_world(ranks, jcomm, name)


def test_collectives_of_selections_across_four_ranks(ranks):  # noqa: F811
    """A mask selection and nonzero: one all-gather of the counts and one
    all-to-all to even chunks; an integer-array gather on the split axis:
    one all-gather; a row taken by an integer: one broadcast; a slice of
    the split axis: none."""
    from test_torch_distributed import _result

    want = {"get_mask_elements_split0": {"all-gather": 1, "all-to-all": 1},
            "nonzero_split0": {"all-gather": 1, "all-to-all": 1},
            "get_rows_across_ranks": {"all-gather": 1},
            "get_int_owner": {"broadcast": 1},
            "get_slice_step_split0": {}}
    for name, counts in want.items():
        for res in _result(ranks, f"indexing_{name}"):
            assert res["counts"] == counts, (name, res["counts"])


def test_lloc_across_four_ranks_indexes_each_rank_slab(ranks):  # noqa: F811
    """``lloc`` reads and writes each rank's own tensor (the Heat
    reference's meaning): rank r's result is its NumPy slab's."""
    import torch_mp_worker as worker
    from test_torch_distributed import _result, _slices

    a = worker.indexing_operand((10, 7), 0)
    for r, res in enumerate(_result(ranks, "lloc_slabs")):
        slab = a[_slices(a.shape, 0, r)]
        np.testing.assert_array_equal(res["read"], slab[::-1, 1:3])
        written = slab.copy()
        written[:1] = -1.0
        np.testing.assert_array_equal(res["after_write"], written)
