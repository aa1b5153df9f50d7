"""heat_tpu_torch's statistics.py against heat_tpu's, at world size 1:
extremes, argmax/argmin (ties, NaNs), the moments (mean, var, std,
average, skew, kurtosis), percentile and median under every
interpolation, and cov, histogram, histc, bincount, digitize and
bucketize, across splits None, 0 and 1 of uneven extents and the dtypes
heat_tpu takes.

The same NumPy input goes to heat_tpu on the 8-device CPU mesh of
conftest.py and to the port on the CPU; values, heat type, shape and split
must equal heat_tpu's, and where heat_tpu raises the port raises the same
exception type. Tolerances: integers, bools, argmax/argmin, the extremes
and the lower, higher and nearest percentiles exactly; float32 reductions
within 1e-5 of the sum of |x| over the reduced axes (another summation
order), float64 within 1e-12 of it; float16 and bfloat16 within 2^-9 and
2^-6 of it; the linear and midpoint percentiles rtol 1e-6 (float32, one
rounding of the same float64 interpolation) and 1e-12 (float64). The
4-rank cases are in test_torch_distributed.py (``_statistics_cases`` of
torch_mp_worker.py).
"""

import numpy as np
import pytest

import heat_tpu as jht
import heat_tpu_torch as ht

from test_torch_distributed import jcomm, ranks  # noqa: F401 (the session's 4-rank world)
from test_torch_elementwise import (STATISTICS_PREFIXES, SPLITS, make, numpy_of, release_programs, run_both, same,
                                    surface_world, values)

SHAPE = (7, 9)  # uneven on every split of the 8-device mesh
DTYPES = ("float32", "float64", "int32", "int64", "bool", "float16", "bfloat16", "complex64")
# rtol of the absolute sum for reductions, by result type
SUM_RTOL = {"float32": 1e-5, "complex64": 1e-5, "float64": 1e-12, "complex128": 1e-12, "float16": 2.0 ** -9,
            "bfloat16": 2.0 ** -6}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])  # heat_tpu turns x64 on for the CPU with its first array
    yield
    release_programs()


def reduced(got, ref, scale: np.ndarray) -> None:
    """A reduction's result against heat_tpu's: exactly for integers and
    bools, else within SUM_RTOL of ``scale`` (the reduced sum of |x|)."""
    assert got.dtype.__name__ == ref.dtype.__name__, (got.dtype, ref.dtype)
    assert tuple(got.shape) == tuple(ref.shape) and got.split == ref.split, (got.shape, ref.shape, got.split,
                                                                            ref.split)
    g, r = numpy_of(got), numpy_of(ref)
    name = ref.dtype.__name__
    if name not in SUM_RTOL:
        np.testing.assert_array_equal(g, r)
        return
    bound = SUM_RTOL[name] * (np.broadcast_to(scale, r.shape) + 1e-30)
    nan = np.isnan(r)
    np.testing.assert_array_equal(np.isnan(g), nan)
    assert np.all(np.abs(g - r)[~nan] <= bound[~nan] + 1e-30), (np.abs(g - r).max(), bound.min())


def edges(got, ref) -> None:
    """Bin edges against heat_tpu's, within 4 ulps of the largest edge."""
    assert got.dtype.__name__ == ref.dtype.__name__ and got.shape == ref.shape and got.split == ref.split
    g, r = numpy_of(got), numpy_of(ref)
    np.testing.assert_allclose(g, r, rtol=0, atol=4 * np.finfo(r.dtype).eps * np.abs(r).max())


def binned(got, ref, a: np.ndarray, edges: np.ndarray) -> None:
    """Histogram counts against heat_tpu's. The bin edges are ``jnp.linspace``'s
    formula in the data's type, whose last bits XLA's CPU compiler and ATen
    round differently (held to 4 ulps of the largest edge by the caller), so
    a value that close to an interior edge may count in either neighbouring
    bin: the
    totals must agree, and each bin within the number of such values."""
    assert got.dtype.__name__ == ref.dtype.__name__ and got.shape == ref.shape and got.split == ref.split
    g, r = numpy_of(got).astype(np.float64), numpy_of(ref).astype(np.float64)
    inner = edges[1:-1].astype(np.float64)
    eps = np.finfo(edges.dtype).eps if edges.dtype.kind == "f" else 0.0
    flat = a.astype(np.float64).reshape(-1)
    near = int(np.sum(np.abs(flat[:, None] - inner[None, :]) <= 4 * eps * np.abs(edges).max()))
    rtol = 2.0 ** -9 if got.dtype.__name__ == "float16" else 1e-6
    if near == 0:
        np.testing.assert_allclose(g, r, rtol=rtol)
        return
    np.testing.assert_allclose(g.sum(), r.sum(), rtol=rtol)
    # a moved value carries at most the largest weight (or density) of a bin
    assert np.all(np.abs(g - r) <= near * float(np.abs(r).max()) + 1e-6)


def abs_sum(a: np.ndarray, axis, keepdims=False) -> np.ndarray:
    return np.sum(np.abs(a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)), axis=axis,
                  keepdims=keepdims)


def check_reduced(call, a, axis, keepdims=False, power: int = 1):
    got, ref = run_both(call)
    if ref is None:
        return
    ax = tuple(range(a.ndim)) if axis is None else axis
    scale = abs_sum(np.abs(a.astype(np.float64) if not np.iscomplexobj(a) else a) ** power, ax, keepdims) / max(
        1, int(np.prod([a.shape[i] for i in np.atleast_1d(ax)])))
    reduced(got, ref, np.maximum(scale, abs_sum(a, ax, keepdims)) if power == 1 else scale + 1)


# --------------------------------------------------------------------- #
# extremes and arg-extremes                                             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["max", "min"])
def test_max_and_min_match_heat_tpu(name, dtype, axis, split):
    """Values against heat_tpu's on the whole array: over a split axis its
    cross-device max drops a NaN (XLA's CPU all-reduce) and refuses complex
    values, where its whole-array max, ``jnp.max``, propagates the NaN and
    orders complex values; the port does what ``jnp.max`` does on any
    split. The split is heat_tpu's where its split call runs."""
    a = values(SHAPE, dtype, "any", 40)
    if dtype in ("float32", "float64"):
        a[2, 3] = np.nan
    for keep in (axis == 1,):
        got, ref = run_both(lambda lib: getattr(lib, name)(make(lib, a, dtype, None), axis=axis, keepdims=keep))
        if ref is None:
            continue
        port = getattr(ht, name)(make(ht, a, dtype, split), axis=axis, keepdims=keep)
        try:
            split_ref = getattr(jht, name)(make(jht, a, dtype, split), axis=axis, keepdims=keep).split
        except Exception:  # noqa: BLE001 (heat_tpu's complex all-reduce): the reduction's split rule
            axes = tuple(range(a.ndim)) if axis is None else np.atleast_1d(axis)
            split_ref = None if split is None or split in axes else split
        assert port.split == split_ref
        same(ht.array(port.numpy(), dtype=port.dtype), ref, "exact")


def _ties_and_nans(dtype: str) -> np.ndarray:
    """Rows with repeated extremes, and (floats) NaNs, some repeated."""
    a = values(SHAPE, dtype, "unit", 41)
    if dtype in ("float32", "float64", "float16"):
        a[1, 4] = a[1, 7] = np.nan
        a[5, 0] = np.nan
    a[:, 6] = a[:, 2]  # tied columns
    a[3] = a[0]  # tied rows
    return a


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("dtype", ("float32", "float64", "int32", "int64", "bool", "float16", "complex64"))
@pytest.mark.parametrize("name", ["argmax", "argmin"])
def test_argmax_and_argmin_take_the_first_extreme_and_the_first_nan_as_heat_tpu(name, dtype, axis, split):
    a = _ties_and_nans(dtype)
    for keep in (axis == 0,):
        got, ref = run_both(lambda lib: getattr(lib, name)(make(lib, a, dtype, split), axis=axis, keepdims=keep))
        if ref is not None:
            same(got, ref, "exact")


# --------------------------------------------------------------------- #
# moments                                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mean_matches_heat_tpu(dtype, axis, split):
    a = values(SHAPE, dtype, "any", 42)
    for keep in (False, True):
        check_reduced(lambda lib: lib.mean(make(lib, a, dtype, split), axis=axis, keepdims=keep), a, axis, keep)
    check_reduced(lambda lib: make(lib, a, dtype, split).mean(axis), a, axis)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["var", "std"])
def test_var_and_std_match_heat_tpu(name, dtype, axis, split):
    a = values(SHAPE, dtype, "any", 43)
    for ddof in (0, 1):
        check_reduced(lambda lib: getattr(lib, name)(make(lib, a, dtype, split), axis, ddof=ddof), a, axis,
                      power=2 if name == "var" else 1)
    check_reduced(lambda lib: getattr(make(lib, a, dtype, split), name)(axis, keepdims=True), a, axis, True,
                  power=2 if name == "var" else 1)
    check_reduced(lambda lib: getattr(lib, name)(make(lib, a, dtype, split), axis, bessel=True), a, axis,
                  power=2 if name == "var" else 1)
    for bad in (-1, 0.5):
        got, ref = run_both(lambda lib: getattr(lib, name)(make(lib, a, dtype, split), axis, ddof=bad))
        assert ref is None


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("dtype", ("float32", "float64", "int32", "float16", "complex64"))
@pytest.mark.parametrize("name", ["skew", "kurtosis"])
def test_skew_and_kurtosis_match_heat_tpu(name, dtype, axis, split):
    a = values(SHAPE, dtype, "any", 44)
    extra = [{"Fischer": False}] if name == "kurtosis" else []
    for kw in [{"unbiased": True}, {"unbiased": False}] + extra:
        got, ref = run_both(lambda lib: getattr(lib, name)(make(lib, a, dtype, split), axis, **kw))
        if ref is None:
            continue
        assert got.dtype.__name__ == ref.dtype.__name__ and got.split == ref.split and got.shape == ref.shape
        # ratios of moments: float32 moments in another summation order
        rtol = {"float16": 2.0 ** -7, "float64": 1e-10}.get(dtype, 1e-4)
        np.testing.assert_allclose(numpy_of(got), numpy_of(ref), rtol=rtol, atol=rtol)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("weights", ["none", "along_axis", "full"])
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("dtype", ("float32", "float64", "int32"))
def test_average_matches_heat_tpu(dtype, axis, weights, split):
    a = values(SHAPE, dtype, "any", 45)
    if weights == "along_axis" and axis is None:
        weights = "full"

    def call(lib, returned=False):
        x = make(lib, a, dtype, split)
        if weights == "none":
            w = None
        elif weights == "full":
            w = lib.array(values(SHAPE, "float32", "pos", 46), split=split)
        else:
            w = lib.array(values((SHAPE[axis],), "float32", "pos", 47), split=0 if split == axis else None)
        return lib.average(x, axis=axis, weights=w, returned=returned)

    check_reduced(call, a, axis)
    got, ref = run_both(lambda lib: call(lib, True))
    for g, r in zip(got, ref):
        reduced(g, r, abs_sum(a, tuple(range(a.ndim)) if axis is None else axis) + 10)


def test_average_refuses_weights_that_sum_to_zero_and_of_the_wrong_length_as_heat_tpu():
    a = values(SHAPE, "float32", "any", 48)
    for w in (np.zeros(SHAPE, np.float32), np.ones(4, np.float32)):
        got, ref = run_both(lambda lib: lib.average(lib.array(a, split=0), axis=1, weights=lib.array(w)))
        assert ref is None


# --------------------------------------------------------------------- #
# percentiles                                                           #
# --------------------------------------------------------------------- #
INTERPOLATIONS = ("linear", "lower", "higher", "midpoint", "nearest")


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("q", [30.0, [5.0, 50.0, 95.0, 100.0, 0.0]], ids=["scalar", "list"])
@pytest.mark.parametrize("dtype", ("float32", "int32", "bool"))  # float64, float16: the median test
@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
def test_percentile_matches_heat_tpu(interpolation, dtype, q, axis, split):
    """Along the split axis heat_tpu's 8 devices take its distributed branch,
    which keeps bools bool (and then cannot interpolate them); the port at
    world size 1 and heat_tpu on one device take ``jnp.percentile``'s
    float32: bools are held against heat_tpu's whole-array result there
    (ROADMAP "Not faults": compare at equal world size)."""
    a = values(SHAPE, dtype, "any", 49)
    kind = "exact" if interpolation in ("lower", "higher", "nearest") else "arith"
    ref_split = None if dtype == "bool" and split is not None and axis == split else split
    for keep in (axis == 1,):
        got, ref = run_both(lambda lib: lib.percentile(make(lib, a, dtype, split if lib is ht else ref_split), q,
                                                       axis=axis, interpolation=interpolation, keepdims=keep))
        if ref is not None:
            same(got, ref, kind)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("dtype", ("float32", "float64", "int32", "int64", "float16", "bfloat16"))
def test_median_matches_heat_tpu(dtype, axis, split):
    a = values(SHAPE, dtype, "any", 50)
    for keep in (False, True):
        check_median = run_both(lambda lib: lib.median(make(lib, a, dtype, split), axis=axis, keepdims=keep))
        if check_median[1] is not None:
            same(*check_median, "arith")
    got, ref = run_both(lambda lib: make(lib, a, dtype, split).median(axis))
    if ref is not None:
        same(got, ref, "arith")


@pytest.mark.parametrize("split", SPLITS)
def test_percentile_of_lanes_with_nan_and_its_refusals_match_heat_tpu(split):
    a = values(SHAPE, "float32", "any", 51)
    for q in (50, np.array([12.5, 87.5])):  # an int and a numpy q
        got, ref = run_both(lambda lib: lib.percentile(lib.array(a, split=split), q, axis=0))
        same(got, ref, "arith")
    a[3, 2] = np.nan
    for axis in (None, 0, 1):
        for interpolation in INTERPOLATIONS:
            got, ref = run_both(lambda lib: lib.percentile(lib.array(a, split=split), [10.0, 60.0], axis=axis,
                                                           interpolation=interpolation))
            same(got, ref, "exact" if interpolation in ("lower", "higher", "nearest") else "arith")
    for bad in (lambda lib, x: lib.percentile(x, 101.0), lambda lib, x: lib.percentile(x, [-1.0, 5.0]),
                lambda lib, x: lib.percentile(x, 5.0, interpolation="cubic"),
                lambda lib, x: lib.percentile(lib.array(a.astype(np.complex64)), 5.0)):
        got, ref = run_both(lambda lib: bad(lib, lib.array(a, split=split)))
        assert ref is None

    def with_out(lib):
        out = lib.array(np.zeros(SHAPE[1], np.float32))
        lib.percentile(lib.array(a, split=split), 25.0, axis=0, out=out)
        return out

    got, ref = run_both(with_out)
    np.testing.assert_allclose(numpy_of(got), numpy_of(ref), rtol=1e-6)


# --------------------------------------------------------------------- #
# counts and bins                                                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("dtype", ("int32", "int64", "bool", "uint8", "float32"))
def test_bincount_matches_heat_tpu(dtype, split):
    a = np.abs(values((23,), "int32" if dtype == "float32" else dtype, "any", 52)).astype(dtype)
    for minlength in (0, 12):
        got, ref = run_both(lambda lib: lib.bincount(lib.array(a, split=split), minlength=minlength))
        if ref is not None:
            same(got, ref, "exact")
    w = values((23,), "float32", "pos", 53)
    got, ref = run_both(lambda lib: lib.bincount(lib.array(a, split=split), weights=lib.array(w, split=split)))
    if ref is not None:
        same(got, ref, "arith")
    got, ref = run_both(lambda lib: lib.bincount(lib.array(-np.ones(3, np.int32), split=split)))
    assert ref is None


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ("float32", "float64", "int32"))
@pytest.mark.parametrize("right", [False, True])
def test_digitize_and_bucketize_match_heat_tpu(right, dtype, split):
    a = values(SHAPE, dtype, "any", 54)
    inc = np.array([-1.0, -0.25, 0.0, 0.5, 2.0])
    check = (lambda got_ref: same(*got_ref, "exact") if got_ref[1] is not None else None)
    check(run_both(lambda lib: lib.digitize(make(lib, a, dtype, split), inc, right=right)))
    check(run_both(lambda lib: lib.digitize(make(lib, a, dtype, split), inc[::-1].copy(), right=right)))
    check(run_both(lambda lib: lib.bucketize(make(lib, a, dtype, split), inc, right=right)))
    check(run_both(lambda lib: lib.bucketize(make(lib, a, dtype, split), lib.array(inc), right=right,
                                             out_int32=True)))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ("float32", "float64", "int32", "int64", "float16", "bool"))
def test_histc_matches_heat_tpu(dtype, split):
    a = values(SHAPE, dtype, "any", 55)
    for args in ({}, {"bins": 5, "min": -1.0, "max": 1.0}, {"bins": 4, "min": 2.0, "max": 2.0}):
        got, ref = run_both(lambda lib: lib.histc(make(lib, a, dtype, split), **args))
        if ref is None:
            continue
        lo, hi = (args.get("min", 0.0), args.get("max", 0.0))
        if lo == hi == 0.0:
            lo, hi = float(a.min()), float(a.max())
        if lo == hi:
            lo, hi = lo - 1e-6, hi + 1e-6
        edge_type = np.float16 if dtype == "float16" else np.float64 if dtype == "float64" else np.float32
        binned(got, ref, a, np.linspace(lo, hi, args.get("bins", 100) + 1).astype(edge_type))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ("float32", "float64", "int32", "int64", "float16"))
def test_histogram_matches_heat_tpu(dtype, split):
    a = values(SHAPE, dtype, "any", 56)
    w = values(SHAPE, "float32", "pos", 57)
    cases = ({"bins": 6}, {"bins": 4, "range": (-1.0, 1.0), "density": True},
             {"bins": np.array([-2.0, -0.5, 0.0, 0.3, 3.0])}, {"weights": "w"}, {"normed": True})
    for args in cases:
        def call(lib):
            kw = dict(args)
            if kw.get("weights") == "w":
                kw["weights"] = lib.array(w, split=split)
            return lib.histogram(make(lib, a, dtype, split), **kw)

        got, ref = run_both(call)
        if ref is None:
            continue
        edges(got[1], ref[1])
        binned(got[0], ref[0], a, numpy_of(ref[1]))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ("float32", "float64", "int32", "complex64"))
def test_cov_matches_heat_tpu(dtype, split):
    m = values((4, 11), dtype, "any", 58)
    y = values((4, 11), dtype, "any", 59)
    for kw in ({"rowvar": False}, {"bias": True, "ddof": 3}):
        got, ref = run_both(lambda lib: lib.cov(make(lib, m, dtype, split), **kw))
        if ref is not None:
            same(got, ref, "trans")
    got, ref = run_both(lambda lib: lib.cov(make(lib, m, dtype, split), make(lib, y, dtype, split)))
    if ref is not None:
        same(got, ref, "trans")
    got, ref = run_both(lambda lib: lib.cov(make(lib, m[0], dtype, None)))
    if ref is not None:
        same(got, ref, "trans")
    got, ref = run_both(lambda lib: lib.cov(make(lib, m, dtype, split), ddof=1.5))
    assert ref is None


# --------------------------------------------------------------------- #
# across ranks                                                          #
# --------------------------------------------------------------------- #
def _statistics_world_cases():
    import torch_mp_worker as worker

    return sorted(n for n in worker.SURFACE_CASES if n.startswith(STATISTICS_PREFIXES))


@pytest.mark.parametrize("name", _statistics_world_cases())
def test_statistics_across_four_ranks_match_heat_tpu(ranks, jcomm, name):
    """argmax/argmin with ties and NaNs across ranks, the moments, the
    extremes and the percentiles along the split axis (the distributed
    sort) against heat_tpu on 4 devices: float32 within 1e-5 of the largest
    magnitude, integers and indices exactly."""
    surface_world(ranks, jcomm, name, 1e-5)
