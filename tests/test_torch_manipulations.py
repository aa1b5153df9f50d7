"""heat_tpu_torch's manipulations against heat_tpu's, at world size 1: the
rest of ``core/manipulations.py`` (shape-only functions, joins, splits,
pads, rolls, repeats, tiles, rotations, diagonals, layout), the DNDarray's
shape methods, ``core/sanitation.py`` and ``utils/data/matrixgallery.py``.

The same seeded NumPy input goes to heat_tpu on the 8-device CPU mesh of
conftest.py and to the port on the CPU, on shapes uneven on every split of
the mesh ((5, 9), (7, 4, 3)); values (exactly, bit for bit), heat type,
global shape and split must equal heat_tpu's, and where heat_tpu raises
the port raises the same exception type. Every case runs in float32 on
every split; a subset also in float64, int32, bool and complex64. The
gallery's matrices draw heat_tpu's stream: their singular values agree
within 1e-5, and the matrices elementwise where ``qr``'s column signs
agree (``test_gallery_matrices_match_heat_tpu`` says where). The 4-rank
cases are ``_manip_cases`` of torch_mp_worker.py, in the test run's world.
"""

import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from test_torch_distributed import jcomm, ranks  # noqa: F401 (the test run's 4-rank world)
from test_torch_elementwise import numpy_of, release_programs, run_both, same, values


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])
    yield
    release_programs()


SPLITS = (None, 0, 1)
DTYPES = ("float64", "int32", "bool", "complex64")
SHAPE = (5, 9)
SHAPE3 = (7, 4, 3)


def _v(lib, shape, dtype="float32", split=None, seed=3):
    return lib.array(values(shape, dtype, seed=seed), split=split)


# name -> call(lib, x, split, dtype): x is the (5, 9) operand of the case's
# split and dtype; further operands are made from seeds
CASES = {
    # shape-only functions
    "squeeze_axis": lambda L, x, s, d: L.squeeze(L.expand_dims(x, 1), 1),
    "squeeze_all": lambda L, x, s, d: L.squeeze(L.expand_dims(L.expand_dims(x, 0), 3)),
    "squeeze_split_extent1": lambda L, x, s, d: L.squeeze(_v(L, (1, 9), d, s), 0),
    "squeeze_method": lambda L, x, s, d: L.expand_dims(x, 2).squeeze(),
    "squeeze_not_one": lambda L, x, s, d: L.squeeze(x, 0),
    "expand_dims_0": lambda L, x, s, d: L.expand_dims(x, 0),
    "expand_dims_last": lambda L, x, s, d: L.expand_dims(x, -1),
    "expand_dims_method": lambda L, x, s, d: x.expand_dims(1),
    "expand_dims_bad": lambda L, x, s, d: L.expand_dims(x, 3),
    "swapaxes": lambda L, x, s, d: L.swapaxes(x, 0, 1),
    "swapaxes_3d": lambda L, x, s, d: L.swapaxes(_v(L, (7, 4, 3), d, s), 2, 0),
    "swapaxes_method": lambda L, x, s, d: x.swapaxes(1, 0),
    "swapaxes_bad": lambda L, x, s, d: L.swapaxes(x, 0, 2),
    "broadcast_to_lead": lambda L, x, s, d: L.broadcast_to(x, (2, 5, 9)),
    "broadcast_to_extent1": lambda L, x, s, d: L.broadcast_to(_v(L, (1, 9), d, s), (5, 9)),
    "broadcast_to_col": lambda L, x, s, d: L.broadcast_to(_v(L, (5, 1), d, s), (3, 5, 9)),
    "broadcast_to_method": lambda L, x, s, d: x.broadcast_to((3, 5, 9)),
    "broadcast_to_bad": lambda L, x, s, d: L.broadcast_to(x, (3, 9)),
    "broadcast_to_fewer": lambda L, x, s, d: L.broadcast_to(x, (9,)),
    "broadcast_arrays": lambda L, x, s, d: L.broadcast_arrays(x, _v(L, (1, 1, 9), d, 2)),
    "flatten": lambda L, x, s, d: L.flatten(x),
    "flatten_3d": lambda L, x, s, d: L.flatten(_v(L, (7, 4, 3), d, s)),
    "ravel_method": lambda L, x, s, d: x.ravel(),
    "flatten_method": lambda L, x, s, d: x.flatten(),
    # joins
    "concatenate_0": lambda L, x, s, d: L.concatenate([x, _v(L, (3, 9), d, s, 4)], 0),
    "concatenate_1": lambda L, x, s, d: L.concatenate((x, _v(L, (5, 2), d, s, 4), x), 1),
    "concatenate_mixed_0": lambda L, x, s, d: L.concatenate([_v(L, (2, 9), d, None, 5), x, _v(L, (4, 9), d, 1, 6)], 0),
    "concatenate_mixed_1": lambda L, x, s, d: L.concatenate([x, _v(L, (5, 3), d, None, 5), _v(L, (5, 4), d, 0, 6)], 1),
    "concatenate_promote": lambda L, x, s, d: L.concatenate([x, _v(L, (5, 9), "int32", 0, 7)], 0),
    "concatenate_method": lambda L, x, s, d: x.concatenate([x, x], axis=1),
    "concatenate_3d": lambda L, x, s, d: L.concatenate([_v(L, (7, 4, 3), d, s), _v(L, (7, 4, 2), d, 2)], 2),
    "concatenate_shape_bad": lambda L, x, s, d: L.concatenate([x, _v(L, (5, 4), d)], 0),
    "concatenate_ndim_bad": lambda L, x, s, d: L.concatenate([x, _v(L, (9,), d)], 0),
    "concatenate_empty": lambda L, x, s, d: L.concatenate([], 0),
    "concatenate_not_seq": lambda L, x, s, d: L.concatenate(x, 0),
    "stack_0": lambda L, x, s, d: L.stack([x, _v(L, SHAPE, d, s, 8)]),
    "stack_1": lambda L, x, s, d: L.stack([x, _v(L, SHAPE, d, None, 8), x], axis=1),
    "stack_last": lambda L, x, s, d: L.stack((x, _v(L, SHAPE, d, 0, 8)), axis=-1),
    "stack_first_whole": lambda L, x, s, d: L.stack([_v(L, SHAPE, d, None, 8), x], axis=1),
    "stack_out": lambda L, x, s, d: L.stack([x, x], axis=0, out=L.zeros((2, 5, 9), dtype=getattr(L, d), split=s)),
    "stack_one": lambda L, x, s, d: L.stack([x]),
    "stack_shapes_bad": lambda L, x, s, d: L.stack([x, _v(L, (5, 4), d)]),
    "hstack": lambda L, x, s, d: L.hstack([x, _v(L, (5, 2), d, s, 9)]),
    "hstack_1d": lambda L, x, s, d: L.hstack([_v(L, (5,), d, s, 9), _v(L, (3,), d, None, 10)]),
    "vstack": lambda L, x, s, d: L.vstack([x, _v(L, (9,), d, 0, 11)]),
    "vstack_rows": lambda L, x, s, d: L.vstack([_v(L, (9,), d, 0, 11), x]),
    "row_stack": lambda L, x, s, d: L.row_stack([x, x]),
    "column_stack": lambda L, x, s, d: L.column_stack([_v(L, (5,), d, s and 0, 12), x]),
    "column_stack_2d": lambda L, x, s, d: L.column_stack([x, _v(L, (5,), d, 0, 12), _v(L, (5, 2), d, 1, 13)]),
    # splits
    "split_sections_0": lambda L, x, s, d: L.split(_v(L, (6, 9), d, s), 3, 0),
    "split_sections_1": lambda L, x, s, d: L.split(x, 3, axis=1),
    "split_indices": lambda L, x, s, d: L.split(x, [1, 3, 3], 0),
    "split_indices_dnd": lambda L, x, s, d: L.split(x, L.array([2, 7]), 1),
    "split_uneven": lambda L, x, s, d: L.split(x, 2, 0),
    "split_unsorted": lambda L, x, s, d: L.split(x, [3, 1], 0),
    "split_beyond": lambda L, x, s, d: L.split(x, [2, 20], 0),
    "split_zero": lambda L, x, s, d: L.split(x, 0, 0),
    "hsplit": lambda L, x, s, d: L.hsplit(x, [4]),
    "hsplit_1d": lambda L, x, s, d: L.hsplit(_v(L, (6,), d, s and 0), 3),
    "vsplit": lambda L, x, s, d: L.vsplit(x, [2, 4]),
    "dsplit": lambda L, x, s, d: L.dsplit(_v(L, (7, 4, 3), d, s), 3),
    "dsplit_2d": lambda L, x, s, d: L.dsplit(x, 1),
    # pads, rolls, repeats, tiles
    "pad_int": lambda L, x, s, d: L.pad(x, 1),
    "pad_pairs": lambda L, x, s, d: L.pad(x, ((1, 2), (0, 3)), constant_values=2),
    "pad_trailing": lambda L, x, s, d: L.pad(x, [(2, 1)]),
    "pad_one_pair_3d": lambda L, x, s, d: L.pad(_v(L, (7, 4, 3), d, s), [(0, 1), (2, 0)]),
    "pad_values": lambda L, x, s, d: L.pad(x, ((1, 1), (2, 1)), constant_values=((1, 2), (3, 4))),
    "pad_value_cast": lambda L, x, s, d: L.pad(x, 1, constant_values=2.7 if d != "bool" else True),
    "pad_1d": lambda L, x, s, d: L.pad(_v(L, (5,), d, s and 0), (2, 3)),
    "pad_negative": lambda L, x, s, d: L.pad(x, ((-1, 1), (0, 0))),
    "pad_too_many": lambda L, x, s, d: L.pad(x, ((1, 1), (0, 0), (1, 1))),
    "pad_pair_2d": lambda L, x, s, d: L.pad(x, (1, 2)),
    "pad_reflect": lambda L, x, s, d: L.pad(x, 1, mode="reflect"),
    "roll_0": lambda L, x, s, d: L.roll(x, 2, 0),
    "roll_1": lambda L, x, s, d: L.roll(x, -3, 1),
    "roll_both": lambda L, x, s, d: L.roll(x, (1, 2), (0, 1)),
    "roll_same_axis": lambda L, x, s, d: L.roll(x, (1, 2), (0,)),
    "roll_flat": lambda L, x, s, d: L.roll(x, 4),
    "roll_past": lambda L, x, s, d: L.roll(x, 12, 0),
    "repeat_0": lambda L, x, s, d: L.repeat(x, 2, 0),
    "repeat_counts": lambda L, x, s, d: L.repeat(x, [1, 0, 2, 1, 3], 0),
    "repeat_counts_1": lambda L, x, s, d: L.repeat(x, np.arange(9) % 3, 1),
    "repeat_dnd_counts": lambda L, x, s, d: L.repeat(x, L.array([2, 1, 0, 1, 1], split=0), 0),
    "repeat_one_count": lambda L, x, s, d: L.repeat(x, [2], 0),
    "repeat_flat": lambda L, x, s, d: L.repeat(x, 2),
    "repeat_method": lambda L, x, s, d: x.repeat(3, 1),
    "repeat_numpy_in": lambda L, x, s, d: L.repeat(values((4,), d), 2),
    "repeat_negative": lambda L, x, s, d: L.repeat(x, -1, 0),
    "repeat_counts_bad": lambda L, x, s, d: L.repeat(x, [1, 2], 0),
    "tile_0": lambda L, x, s, d: L.tile(x, (2, 1)),
    "tile_1": lambda L, x, s, d: L.tile(x, (1, 3)),
    "tile_both": lambda L, x, s, d: L.tile(x, [2, 2]),
    "tile_lead": lambda L, x, s, d: L.tile(x, (2, 1, 1)),
    "tile_int": lambda L, x, s, d: L.tile(x, 2),
    "tile_method": lambda L, x, s, d: x.tile((3, 1)),
    # rotations and flips
    "rot90": lambda L, x, s, d: L.rot90(x),
    "rot90_2": lambda L, x, s, d: L.rot90(x, 2),
    "rot90_3": lambda L, x, s, d: L.rot90(x, 3),
    "rot90_neg": lambda L, x, s, d: L.rot90(x, -1, (1, 0)),
    "rot90_0": lambda L, x, s, d: L.rot90(x, 4),
    "rot90_3d": lambda L, x, s, d: L.rot90(_v(L, (7, 4, 3), d, s), 1, (0, 2)),
    "rot90_same_axes": lambda L, x, s, d: L.rot90(x, 1, (0, 0)),
    "rot90_three_axes": lambda L, x, s, d: L.rot90(x, 1, (0, 1, 2)),
    "rot90_dup_axes": lambda L, x, s, d: L.rot90(x, 1, (0, -2)),
    "fliplr": lambda L, x, s, d: L.fliplr(x),
    "flipud": lambda L, x, s, d: L.flipud(x),
    "fliplr_1d": lambda L, x, s, d: L.fliplr(_v(L, (5,), d)),
    # diagonals
    "diag_2d": lambda L, x, s, d: L.diag(x),
    "diag_2d_offset": lambda L, x, s, d: L.diag(x, 3),
    "diag_1d": lambda L, x, s, d: L.diag(_v(L, (5,), d, s and 0), 0),
    "diag_1d_up": lambda L, x, s, d: L.diag(_v(L, (5,), d, s and 0), 2),
    "diag_1d_down": lambda L, x, s, d: L.diag(_v(L, (5,), d, s and 0), -3),
    "diagonal": lambda L, x, s, d: L.diagonal(x),
    "diagonal_up": lambda L, x, s, d: L.diagonal(x, 2),
    "diagonal_down": lambda L, x, s, d: L.diagonal(x, -2),
    "diagonal_swapped": lambda L, x, s, d: L.diagonal(x, 1, 1, 0),
    "diagonal_3d": lambda L, x, s, d: L.diagonal(_v(L, (7, 4, 3), d, s), 1, 1, 2),
    "diagonal_3d_outer": lambda L, x, s, d: L.diagonal(_v(L, (7, 4, 3), d, s), -1, 0, 2),
    "diagonal_1d": lambda L, x, s, d: L.diagonal(_v(L, (5,), d)),
    "diagonal_same_dims": lambda L, x, s, d: L.diagonal(x, 0, 1, 1),
    # layout
    "balance": lambda L, x, s, d: L.balance(x),
    "balance_copy": lambda L, x, s, d: L.balance(x, copy=True),
    "redistribute": lambda L, x, s, d: L.redistribute(x, target_map=x.lshape_map),
    "collect": lambda L, x, s, d: L.collect(x),
    "collect_bad_rank": lambda L, x, s, d: L.collect(x, 9),
    "collect_str_rank": lambda L, x, s, d: L.collect(x, "a"),
    "sanitize_distribution": lambda L, x, s, d: L.sanitize_distribution(_v(L, SHAPE, d, 1, 14), target=x),
    "sanitize_distribution_bcast": lambda L, x, s, d: L.sanitize_distribution(_v(L, (9,), d, 0, 15), x,
                                                                               target=_v(L, (4, 9), d, 1)),
    "scalar_to_1d": lambda L, x, s, d: L.scalar_to_1d(L.array(values((), d))),
}
# cases that run in every dtype on split 0 (the others: float32 only)
DTYPE_CASES = ("squeeze_split_extent1", "broadcast_to_extent1", "concatenate_mixed_1", "stack_1", "split_indices",
               "pad_value_cast", "roll_both", "tile_both", "diagonal_up")
# cases where both packages raise: on split 0 only
RAISING = ("squeeze_not_one", "expand_dims_bad", "swapaxes_bad", "broadcast_to_bad", "broadcast_to_fewer",
           "concatenate_shape_bad", "concatenate_ndim_bad", "concatenate_empty", "concatenate_not_seq", "stack_one",
           "stack_shapes_bad", "split_unsorted", "split_beyond", "split_zero", "split_uneven", "dsplit_2d",
           "pad_negative", "pad_too_many", "pad_pair_2d", "pad_reflect", "repeat_negative", "repeat_counts_bad",
           "rot90_same_axes", "rot90_three_axes", "rot90_dup_axes", "fliplr_1d", "diagonal_1d",
           "diagonal_same_dims", "collect_bad_rank", "collect_str_rank")


# cases that also run on an operand that is not split (split None); the
# others run split 0 and 1, where the split's bookkeeping shows
WHOLE_CASES = ("squeeze_split_extent1", "broadcast_to_extent1", "flatten", "concatenate_0", "concatenate_1",
               "concatenate_mixed_0", "concatenate_mixed_1", "stack_1", "stack_first_whole", "stack_out",
               "column_stack", "split_indices", "pad_pairs", "roll_both", "roll_flat", "repeat_counts",
               "repeat_flat", "tile_lead", "rot90", "diag_1d_up", "diagonal_up", "collect", "sanitize_distribution")


def _cases():
    """float32 on split 0 and 1 (and None for WHOLE_CASES); the methods,
    which call the functions, and the cases that raise on split 0 only."""
    out = [(name, split, "float32") for name in CASES for split in SPLITS
           if (split == 0 or (name not in RAISING and not name.endswith("_method")))
           and (split is not None or name in WHOLE_CASES)]
    return out + [(name, 0, dt) for name in DTYPE_CASES for dt in DTYPES]


def _whole_shard(x) -> None:
    """At world size 1 the one shard is the whole array: the map says so
    and the array is balanced."""
    assert tuple(x.larray.shape) == x.gshape, (tuple(x.larray.shape), x.gshape)
    assert x.lshape_map.tolist() == [list(x.gshape)], (x.lshape_map, x.gshape)
    assert x.is_balanced() and x.balanced
    if x.split is not None:
        assert x.counts_displs() == ((x.gshape[x.split],), (0,))


def _same(got, ref):
    if isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r)
    elif isinstance(ref, jht.DNDarray):
        same(got, ref, "exact")
        _whole_shard(got)
    else:
        assert got == ref


@pytest.mark.parametrize("name,split,dtype", _cases())
def test_manipulation_matches_heat_tpu(name, split, dtype):
    a = values(SHAPE, dtype)
    got, ref = run_both(lambda lib: CASES[name](lib, lib.array(a, split=split), split, dtype))
    assert ref is not None or split is not None or name in RAISING, name
    if name in RAISING:
        assert ref is None, name
    if ref is not None and name == "collect":
        # the port keeps the split with every row on the target rank;
        # heat_tpu replicates the array on its device (ROADMAP "Not faults")
        assert (got.split, ref.split) == (split, None)
        got = ht.resplit(got, None)
    if ref is not None:
        _same(got, ref)


# functions whose result's shard map is written by the function, not
# learnt: at world size 1 the map must still be the whole padded, joined or
# repeated shard
LAYOUT_CALLS = {
    "pad_split_axis": lambda x: ht.pad(x, ((1, 1), (2, 2))),
    "pad_before_only": lambda x: ht.pad(x, ((3, 0), (0, 0))),
    "diag_of_1d": lambda x: ht.diag(x[:, 0] if x.split == 0 else x[0], -2),
    "repeat_split_axis": lambda x: ht.repeat(x, [1, 2, 0, 3, 1] if x.split == 0 else 2, x.split),
    "tile_split_axis": lambda x: ht.tile(x, (2, 3)),
    "roll_split_axis": lambda x: ht.roll(x, 3, x.split),
    "concatenate_split_axis": lambda x: ht.concatenate([x, x], x.split),
    "split_split_axis": lambda x: ht.split(x, [2], x.split)[1],
    "diagonal": lambda x: ht.diagonal(x, 1),
    "flatten": lambda x: ht.flatten(x),
}


@pytest.mark.parametrize("split", (0, 1))
@pytest.mark.parametrize("name", sorted(LAYOUT_CALLS))
def test_world_size_one_result_maps_hold_the_shard(name, split):
    """The map of a result that a function writes itself holds its shard at
    world size 1 too: balanced, ``counts_displs`` and ``__partitioned__``
    of the result's shape, tiles over every row, and a ``redistribute`` to
    its own map conserves the rows."""
    a = values(SHAPE, "float32")
    y = LAYOUT_CALLS[name](ht.array(a, split=split))
    _whole_shard(y)
    want = y.numpy()
    parts = y.__partitioned__["partitions"]
    assert [tuple(part["shape"]) for part in parts.values()] == [y.gshape]
    np.testing.assert_array_equal(ht.redistribute(y, target_map=y.lshape_map).numpy(), want)
    if y.ndim == 2:
        tiles = ht.tiling.SplitTiles(y)
        assert [int(d.sum()) for d in tiles.tile_dimensions] == list(y.gshape)
        np.testing.assert_array_equal(np.concatenate([tiles[i].numpy() for i in range(len(tiles.tile_dimensions[0]))],
                                                     0), want)


@pytest.mark.parametrize("split", SPLITS)
def test_shape_and_metadata_methods_match_heat_tpu(split):
    """``shape``, ``numdims``, ``real``, ``imag`` (also of a real array) and
    ``create_lshape_map``."""
    a = values(SHAPE3, "complex64")
    for lib in (jht, ht):
        x = lib.array(a, split=split)
        assert lib.shape(x) == SHAPE3 and x.numdims == 3
        np.testing.assert_array_equal(x.create_lshape_map(), x.lshape_map)
        np.testing.assert_array_equal(x.create_lshape_map(force_check=True), x.lshape_map)
    for lib_x in (lambda lib: lib.array(a, split=split), lambda lib: lib.array(a.real, split=split)):
        got, ref = lib_x(ht), lib_x(jht)
        same(got.real, ref.real, "exact")
        same(got.imag, ref.imag, "exact")


def test_views_and_copies():
    """``split``, ``squeeze``, ``expand_dims``, ``flatten`` and ``ravel`` are
    views of the shard (NumPy's); the joins, moves and ``swapaxes`` have
    their own memory."""
    a = values(SHAPE, "float32")
    x = ht.array(a, split=0)
    views = [ht.split(x, [2], 0)[1], ht.squeeze(ht.expand_dims(x, 0)), ht.expand_dims(x, 1), ht.flatten(x),
             ht.ravel(x)]
    for v in views:
        assert v.larray.data_ptr() >= x.larray.data_ptr()
        assert v.larray.untyped_storage().data_ptr() == x.larray.untyped_storage().data_ptr()
    for fn in (lambda: ht.concatenate([x, x]), lambda: ht.pad(x, 0), lambda: ht.roll(x, 0, 0), lambda: ht.tile(x, 1),
               lambda: ht.swapaxes(x, 0, 0), lambda: ht.broadcast_to(x, SHAPE), lambda: ht.diagonal(x),
               lambda: ht.repeat(x, 1, 0), lambda: ht.rot90(x, 4)):
        y = fn()
        y.larray.zero_()
        np.testing.assert_array_equal(x.numpy(), a)


def test_sanitation_matches_heat_tpu():
    """``sanitize_in_tensor``, ``sanitize_lshape``, ``sanitize_infinity``,
    ``sanitize_sequence`` and ``sanitize_out`` (tests/test_stats_manip_sweep.py)."""
    for lib in (jht, ht):
        x = lib.array(values(SHAPE, "float32"), split=0)
        with pytest.raises(TypeError):
            lib.sanitize_in_tensor(np.zeros(3))
        with pytest.raises(TypeError):
            lib.sanitize_sequence(x)
        assert lib.sanitize_sequence((1, 2)) == [1, 2]
        lib.sanitize_lshape(x, np.zeros((2, 9)))
        for bad in (np.zeros((2, 8)), np.zeros((6, 9)), np.zeros(9)):
            with pytest.raises(ValueError):
                lib.sanitize_lshape(x, bad)
        with pytest.raises(ValueError):
            lib.sanitize_lshape(lib.array(np.zeros((2, 3))), np.zeros((2, 2)))
        with pytest.raises(TypeError):
            lib.sanitize_out(np.zeros(SHAPE), SHAPE, 0, x.device)
        with pytest.raises(ValueError):
            lib.sanitize_out(x, (9, 5), 0, x.device)
    ht.sanitize_in_tensor(torch.zeros(3))
    for dt in ("float32", "float64", "int32", "int64", "bool", "float16"):
        got = ht.sanitize_infinity(ht.zeros(2, dtype=getattr(ht, dt)))
        ref = jht.sanitize_infinity(jht.zeros(2, dtype=getattr(jht, dt)))
        assert got == ref and type(got) is type(ref), (dt, got, ref)


@pytest.mark.parametrize("split", (0, 1))
def test_uneven_operands_at_world_size_one(split):
    """A slice's operand goes through every join, move and split as the
    whole array's slice does in heat_tpu."""
    a = values((9, 8), "float32")
    calls = [lambda L, x: L.concatenate([x, x], split), lambda L, x: L.pad(x, 1), lambda L, x: L.roll(x, 3, split),
             lambda L, x: L.repeat(x, 2, split), lambda L, x: L.tile(x, (2, 2)), lambda L, x: L.split(x, 2, split),
             lambda L, x: L.stack([x, x], 1), lambda L, x: L.flatten(x), lambda L, x: L.diagonal(x, 1)]
    for call in calls:
        _same(call(ht, ht.array(a, split=split)[1:7, 2:]), call(jht, jht.array(a, split=split)[1:7, 2:]))


# --------------------------------------------------------------------- #
# the gallery                                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", (0, 1))
def test_gallery_matrices_match_heat_tpu(split):
    """``parter`` exactly; ``hermitian`` (complex and real) within float32
    rounding, both drawing heat_tpu's stream from one seed;
    ``random_orthogonal``, ``random_known_singularvalues`` and
    ``random_known_rank``: orthonormal factors, the singular values
    within 1e-5 of heat_tpu's (and of the requested ones), and the
    factors elementwise within 1e-5 once each column's sign is matched to
    heat_tpu's (the column signs are ``qr``'s choice); ``random_known_rank``
    takes heat_tpu's singular values from its uniform draws bit for bit
    (ascending: −log of the descending draws)."""
    from heat_tpu.utils.data import matrixgallery as jgal
    from heat_tpu_torch.utils.data import matrixgallery as gal

    same(gal.parter(7, split=split), jgal.parter(7, split=split), "exact")
    same(gal.parter(7, split=split, dtype=ht.float64), jgal.parter(7, split=split, dtype=jht.float64), "exact")
    for dtype in ("complex64", "float32"):
        ht.random.seed(5)
        jht.random.seed(5)
        got = gal.hermitian(6, dtype=getattr(ht, dtype), split=split)
        ref = jgal.hermitian(6, dtype=getattr(jht, dtype), split=split)
        assert (got.dtype.__name__, got.split, got.shape) == (ref.dtype.__name__, ref.split, ref.shape)
        np.testing.assert_allclose(numpy_of(got), numpy_of(ref), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(numpy_of(got), numpy_of(got).conj().T)

    def signed(got, ref):  # got's columns with ref's signs
        g, r = numpy_of(got), numpy_of(ref)
        return g * np.where(np.sum(g * r, axis=0) < 0, -1.0, 1.0), r

    ht.random.seed(9)
    jht.random.seed(9)
    got, ref = gal.random_orthogonal(14, 3, split=split), jgal.random_orthogonal(14, 3, split=split)
    assert (got.split, got.shape, got.dtype) == (ref.split, ref.shape, ht.float32)
    np.testing.assert_allclose(*signed(got, ref), atol=1e-5)
    np.testing.assert_allclose(numpy_of(got).T @ numpy_of(got), np.eye(3), atol=1e-5)
    for make in (lambda lib, g: g.random_known_singularvalues(14, 9, lib.array(np.array([4.0, 2.0, 0.5], "f4")),
                                                              split=split),
                 lambda lib, g: g.random_known_rank(14, 9, 3, split=split)):
        ht.random.seed(13)
        jht.random.seed(13)
        (A, (U, s, V)), (jA, (jU, js, jV)) = make(ht, gal), make(jht, jgal)
        assert (A.split, A.shape, A.dtype.__name__) == (jA.split, jA.shape, jA.dtype.__name__)
        np.testing.assert_array_equal(s.numpy(), js.numpy())
        np.testing.assert_allclose(np.linalg.svd(A.numpy(), compute_uv=False)[: s.shape[0]],
                                   np.sort(js.numpy())[::-1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.linalg.svd(A.numpy(), compute_uv=False),
                                   np.linalg.svd(jA.numpy(), compute_uv=False), atol=1e-5)
        for f, jf in ((U, jU), (V, jV)):
            np.testing.assert_allclose(*signed(f, jf), atol=1e-5)
    for lib, g in ((ht, gal), (jht, jgal)):
        with pytest.raises(ValueError):
            g.random_orthogonal(3, 5)
        with pytest.raises(ValueError):
            g.random_known_rank(4, 3, 5)


def test_gallery_feeds_hsvd_rank():
    """tests/test_linalg_sweep.py::test_hsvd_rank_known_rank on the port:
    ``hsvd_rank`` of a rank-3 gallery matrix finds its singular values."""
    from heat_tpu_torch.utils.data.matrixgallery import random_known_rank

    for split in (0, 1):
        data, (_, s_t, _) = random_known_rank(36, 16, 3, split=split)
        _, s, _, err = ht.linalg.hsvd_rank(data, 3, compute_sv=True)
        np.testing.assert_allclose(np.sort(s.numpy())[::-1], np.sort(s_t.numpy())[::-1], rtol=1e-2)
        assert float(err) < 1e-3


# --------------------------------------------------------------------- #
# across ranks: the test run's 4-rank world (torch_mp_worker.py's        #
# MANIP_CASES) against heat_tpu on 4 devices                             #
# --------------------------------------------------------------------- #
def manip_world(ranks, jcomm, name: str) -> None:  # noqa: F811
    """Every rank's result of ``MANIP_CASES[name]`` against heat_tpu's on
    the 4-device mesh: values exactly, dtype, split and global shape; each
    rank's map the layout of ``MANIP_LAYOUT[name]`` and its shard those
    rows of heat_tpu's global result; ``collect`` keeps the split with
    every row on its target (heat_tpu: split None)."""
    import torch_mp_worker as worker
    from test_torch_distributed import WORLD, _result

    ref = worker.MANIP_CASES[name](jht, {"comm": jcomm})
    refs = ref if isinstance(ref, (list, tuple)) else [ref]
    layouts = worker.MANIP_LAYOUT[name]
    every = _result(ranks, f"manip_{name}")
    assert len(every) == WORLD and len(layouts) == len(refs)
    for r, res in enumerate(every):
        parts = res["parts"]
        assert len(parts) == len(refs)
        for part, want, layout in zip(parts, refs, layouts):
            w = numpy_of(want)
            assert part["dtype"] == want.dtype.__name__ and tuple(part["gshape"]) == w.shape
            np.testing.assert_array_equal(part["global"], w)
            split = part["split"]
            if name.startswith("collect"):
                assert want.split is None and split == 0
            else:
                assert split == want.split, (split, want.split)
            if split is None:
                assert layout is None
                np.testing.assert_array_equal(part["local"], w)
                continue
            lmap = np.asarray(part["lmap"])
            assert lmap[:, split].tolist() == layout, (name, lmap[:, split].tolist(), layout)
            assert all(lmap[:, d].tolist() == [w.shape[d]] * WORLD for d in range(w.ndim) if d != split)
            st = np.concatenate([[0], np.cumsum(layout)])
            np.testing.assert_array_equal(part["local"], np.take(w, range(st[r], st[r + 1]), axis=split))


def _world_names():
    import torch_mp_worker as worker

    return sorted(worker.MANIP_CASES)


@pytest.mark.parametrize("name", _world_names())
def test_manipulations_across_four_ranks_match_heat_tpu(ranks, jcomm, name):  # noqa: F811
    """Joins, splits, pads, rolls, repeats, tiles, diagonals, layout and the
    shape functions across 4 ranks, on even, ragged and sliced (uneven)
    operands, a rank with no rows among them."""
    manip_world(ranks, jcomm, name)


@pytest.mark.parametrize("name", _world_names())
def test_collectives_across_four_ranks(ranks, name):  # noqa: F811
    """Each case issues the collectives its docstrings name, and none
    all-gathers a split operand: ``roll``, ``concatenate``, ``tile`` and a
    ``flip`` (inside ``rot90``) along the split axis one all-to-all; a
    planner resplit of an operand one more; ``pad``, ``repeat``, ``split``,
    ``diagonal``, ``diag``, ``flatten`` of split 0, ``swapaxes`` and joins
    of aligned operands none; squeezing or broadcasting a split axis of
    extent 1 one broadcast; ``collect``, ``balance`` and each array that
    ``sanitize_distribution`` moves one all-to-all (``redistribute_``)."""
    import torch_mp_worker as worker
    from test_torch_distributed import _result

    assert set(worker.MANIP_COUNTS) == set(worker.MANIP_CASES) == set(worker.MANIP_LAYOUT)
    for res in _result(ranks, f"manip_{name}"):
        assert res["counts"] == worker.MANIP_COUNTS[name], (name, res["counts"])
