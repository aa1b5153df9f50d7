"""heat_tpu_torch's pairwise distances (``ht.spatial``) against heat_tpu
at world size 1: ``cdist`` in both forms, ``manhattan`` and ``rbf``, with
the split rule of heat_tpu's ``_wrap`` and ``ring=True`` (at world size 1
the plain form runs in both packages). Float32 within 1e-5, float64 within
1e-12, relative and absolute: both packages compute the same expressions,
in other summation orders over at most 5 features.
"""

import numpy as np
import pytest

import heat_tpu as jht
import heat_tpu_torch as ht

TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")


def _data(dtype, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((23, 5)).astype(dtype), rng.standard_normal((11, 5)).astype(dtype)


CALLS = {
    "cdist": lambda pkg, X, Y, ring: pkg.spatial.cdist(X, Y, ring=ring),
    "cdist_quadratic": lambda pkg, X, Y, ring: pkg.spatial.cdist(X, Y, quadratic_expansion=True, ring=ring),
    "manhattan": lambda pkg, X, Y, ring: pkg.spatial.manhattan(X, Y, ring=ring),
    "rbf": lambda pkg, X, Y, ring: pkg.spatial.rbf(X, Y, sigma=1.5, ring=ring),
    "rbf_quadratic": lambda pkg, X, Y, ring: pkg.spatial.rbf(X, Y, sigma=1.5, quadratic_expansion=True, ring=ring),
}


# ring=True with both operands split: heat_tpu on its 8-device test mesh
# runs the ppermute ring there, the port its plain form
@pytest.mark.parametrize(
    "splits, ring", [((None, None), False), ((0, None), False), ((None, 0), False), ((0, 0), False), ((0, 0), True)]
)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(CALLS))
def test_distances_match_heat_tpu(name, dtype, splits, ring):
    x, y = _data(dtype)
    sx, sy = splits
    ref = CALLS[name](jht, jht.array(x, split=sx), jht.array(y, split=sy), ring)
    got = CALLS[name](ht, ht.array(x, split=sx), ht.array(y, split=sy), ring)
    assert got.shape == ref.shape and got.split == ref.split
    assert got.dtype.__name__ == ref.dtype.__name__
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL[dtype], atol=TOL[dtype])


# X against itself, with the symmetric half ring in heat_tpu at split 0.
# The quadratic form of cdist is left out: its diagonal is sqrt of float
# rounding (about 1e-3 in float32), not a value to compare.
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["cdist", "manhattan", "rbf", "rbf_quadratic"])
def test_self_distances_match_heat_tpu(name, dtype, split):
    x, _ = _data(dtype, seed=1)
    ref = CALLS[name](jht, jht.array(x, split=split), None, True)
    got = CALLS[name](ht, ht.array(x, split=split), None, True)
    assert got.shape == ref.shape == (23, 23) and got.split == ref.split
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL[dtype], atol=TOL[dtype])


def test_integer_operands_promote_to_float32_and_bad_shapes_raise():
    x = np.arange(12).reshape(4, 3)
    ref = jht.spatial.cdist(jht.array(x))
    got = ht.spatial.cdist(ht.array(x))
    assert got.dtype is ht.float32 and ref.dtype.__name__ == "float32"
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        ht.spatial.cdist(ht.array(x), ht.array(np.zeros((2, 4))))
    with pytest.raises(ValueError):
        ht.spatial.manhattan(ht.array(np.zeros(3)))
    with pytest.raises(TypeError):
        ht.spatial.rbf(x)
