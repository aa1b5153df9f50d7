"""heat_tpu_torch's DNDarray comparisons, truth value and hashing, and its
intake of bfloat16 NumPy arrays, against heat_tpu on the same inputs."""

import ml_dtypes
import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu_torch.core import interop


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")


def _values(name):
    rng = np.random.default_rng(5)
    return {
        "f32": (rng.integers(0, 3, (7,)).astype(np.float32), 0),
        "i64": (rng.integers(0, 3, (3, 4)).astype(np.int64), 1),
        "f64_whole": (rng.integers(0, 3, (2, 5)).astype(np.float64), None),
        "row": (np.array([[2.0, 1.0, 2.0]], np.float32), 0),  # split axis of extent 1
    }[name]


def _same(got, ref):
    assert got.dtype.__name__ == ref.dtype.__name__ == "bool"
    assert got.shape == ref.shape and got.split == ref.split
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


CASES = ["f32", "i64", "f64_whole", "row"]


@pytest.mark.parametrize("scalar", [2, 1.0, True, np.float32(2.0)], ids=["int", "float", "bool", "np.float32"])
@pytest.mark.parametrize("case", CASES)
def test_eq_ne_against_a_scalar_match_heat_tpu(case, scalar):
    values, split = _values(case)
    for op in ("__eq__", "__ne__"):
        ref = getattr(jht.array(values, split=split), op)(scalar)
        got = getattr(ht.array(values, split=split), op)(scalar)
        _same(got, ref)


@pytest.mark.parametrize("case", CASES)
def test_eq_ne_against_a_dndarray_of_the_same_shape_and_split_match_heat_tpu(case):
    values, split = _values(case)
    other = np.roll(values, 1)
    for op in ("__eq__", "__ne__"):
        ref = getattr(jht.array(values, split=split), op)(jht.array(other, split=split))
        got = getattr(ht.array(values, split=split), op)(ht.array(other, split=split))
        _same(got, ref)
    x = ht.array(values, split=split)
    assert bool((x == x).larray.all()) and not bool((x != x).larray.any())


@pytest.mark.parametrize(
    "value", [0.0, 7.0, [0.0], [3.0], [[0.0]], [0.0, 0.0], [1.0, 2.0]],
    ids=["0d-zero", "0d-seven", "1-zero", "1-three", "1x1-zero", "2-zeros", "2"],
)
def test_bool_matches_heat_tpu(value):
    ref_x, got_x = jht.array(value), ht.array(value)
    try:
        ref = bool(ref_x)
    except TypeError:
        with pytest.raises(TypeError, match="size-1"):
            bool(got_x)
        with pytest.raises(ValueError):  # numpy's error type for the same cast
            bool(got_x)
        return
    assert bool(got_x) is ref


def test_a_sum_compared_with_zero_takes_the_right_branch():
    x = ht.array(np.zeros(5, np.float32), split=0)
    assert bool(ht.sum(x) == 0) and not bool(ht.sum(x) != 0)
    assert bool(jht.sum(jht.array(np.zeros(5, np.float32), split=0)) == 0)


def test_dndarrays_are_unhashable_as_in_heat_tpu():
    for pkg in (jht, ht):
        with pytest.raises(TypeError, match="unhashable"):
            hash(pkg.array([1.0, 2.0]))


@pytest.mark.parametrize(
    "other",
    [
        lambda pkg: pkg.array(np.ones((1, 7), np.float32)),  # broadcasting
        lambda pkg: pkg.array(np.ones(7, np.float32)),  # same shape, other split
        lambda pkg: np.ones(7, np.float32),  # array-likes
        lambda pkg: torch.ones(7) if pkg is ht else np.ones(7, np.float32),
        lambda pkg: None,
    ],
    ids=["broadcast", "mixed-split", "numpy", "tensor", "none"],
)
def test_other_operands_raise_and_name_the_roadmap_item(other):
    """Broadcasting, mixed splits and array-likes compare as in heat_tpu
    since the binary-op machinery (ROADMAP Queue 1 item 6 (a)); an operand
    heat_tpu refuses (None) the port refuses with the same exception."""
    for op in ("__eq__", "__ne__"):
        try:
            ref = getattr(jht.array(np.ones(7, np.float32), split=0), op)(other(jht))
        except Exception as e:  # noqa: BLE001 (the port must fail the same way)
            with pytest.raises(type(e)):
                getattr(ht.array(np.ones(7, np.float32), split=0), op)(other(ht))
            continue
        _same(getattr(ht.array(np.ones(7, np.float32), split=0), op)(other(ht)), ref)


BF16 = np.array([1.5, -2.25, 3.1, 0.0, -0.0, 65504.0, 1e-3], dtype=ml_dtypes.bfloat16)


def _bits(x) -> np.ndarray:
    return x.larray.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize(
    "make",
    [
        lambda pkg, v: pkg.array(v),
        lambda pkg, v: pkg.array(v, dtype=pkg.bfloat16),
        lambda pkg, v: pkg.array(v.reshape(7, 1), split=0),
    ],
    ids=["array", "array-dtype", "array-split"],
)
def test_array_of_a_bfloat16_numpy_array_matches_heat_tpu(make):
    ref, got = make(jht, BF16), make(ht, BF16)
    assert got.dtype is ht.bfloat16 and ref.dtype.__name__ == "bfloat16"
    assert got.shape == ref.shape and got.split == ref.split
    np.testing.assert_array_equal(_bits(got).ravel(), np.asarray(ref.larray).view(np.uint16).ravel())
    np.testing.assert_array_equal(_bits(got).ravel(), BF16.view(np.uint16))


@pytest.mark.parametrize("split", [None, 0])
def test_interop_from_numpy_of_bfloat16_keeps_the_bits(split):
    got = interop.from_numpy(BF16, split=split)
    ref = jht.array(BF16, split=split)
    assert got.dtype is ht.bfloat16 and got.split == ref.split
    np.testing.assert_array_equal(_bits(got), np.asarray(ref.larray).view(np.uint16))
