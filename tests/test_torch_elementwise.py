"""heat_tpu_torch's elementwise surface against heat_tpu's, at world size 1:
the promotion lattice (``result_type``, ``promote_types``, ``can_cast``,
``issubdtype``), ``arithmetics``, ``relational``, ``logical``, ``rounding``,
``trigonometrics``, ``exponential`` and ``complex_math``, the operator
dunders, broadcasting, ``out=`` and ``where=`` (the matrix of
test_op_parity_sweep.py), and the three faults of linalg/basics.py that
the port repaired (integer ``trace``/``vecdot``, bool products, float16
``det``).

The same NumPy input goes to heat_tpu on the 8-device CPU mesh of
conftest.py and to the port on the CPU. Each result's values, heat type,
shape and split must equal heat_tpu's; where heat_tpu raises, the port
raises the same exception type. Tolerances: integers, bools, comparisons
and rounding exactly; float32 arithmetic rtol 1e-6; transcendentals (XLA's
and ATen's CPU polynomials differ) rtol 1e-5; float64 rtol 1e-12;
float16 and bfloat16 within two of their ulps (rtol 2^-9, 2^-6),
transcendentals also within 4 ulps of the largest magnitude (jnp rounds
every step to the narrow type); complex64 as float32. Two things are
undefined and left out of the value checks: integer division by zero
(XLA gives fixed values, ATen raises on the CPU) and integers to negative
integer powers (jnp wraps, the port raises ValueError, as numpy does:
``test_integers_to_negative_powers_raise``). The 4-rank cases are in
test_torch_distributed.py (``_elementwise_cases`` of torch_mp_worker.py).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from test_torch_distributed import jcomm, ranks  # noqa: F401 (the session's 4-rank world)

SPLITS = (None, 0, 1)
DTYPES = ("float32", "float64", "int32", "int64", "bool", "bfloat16", "float16", "complex64")
SHAPE = (5, 9)  # uneven on every split of the 8-device mesh
# relative tolerances by result type: arithmetic, transcendental
RTOL = {
    "float32": (1e-6, 1e-5), "complex64": (1e-6, 1e-5), "float64": (1e-12, 1e-12), "complex128": (1e-12, 1e-12),
    "float16": (2.0 ** -9, 2.0 ** -9), "bfloat16": (2.0 ** -6, 2.0 ** -6),
}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])  # heat_tpu turns x64 on for the CPU with its first array
    yield
    release_programs()


def release_programs() -> None:
    """Drop the programs heat_tpu compiled for this module's thousands of
    small cases, so that the worker process does not carry them into the
    next test file."""
    import jax
    from heat_tpu.core.communication import _clear_mesh_caches

    _clear_mesh_caches()
    jax.clear_caches()


def values(shape, dtype: str, domain: str = "any", seed: int = 0) -> np.ndarray:
    """A NumPy operand of ``dtype`` from a seed: ``any`` spans both signs,
    ``pos`` stays ≥ 0.5 (integers ≥ 1), ``unit`` inside (−1, 1) (integers
    in {−1, 0, 1}). bfloat16 data come as float32 values that bfloat16
    holds exactly."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if dtype == "bool":
        return a > 0
    if "int" in dtype:
        lo, hi = {"any": (-9, 10), "pos": (1, 9), "unit": (-1, 2)}[domain]
        return rng.integers(lo, hi, size=shape).astype(dtype)
    if domain == "pos":
        a = np.abs(a) + 0.5
    elif domain == "unit":
        a = np.clip(a / 3.0, -0.99, 0.99)
    if "complex" in dtype:
        b = rng.standard_normal(shape) * (0.1 if domain != "any" else 1.0)
        return (a + 1j * b).astype(dtype)
    if dtype == "bfloat16":
        return a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a.astype(dtype)


def make(lib, a: np.ndarray, dtype: str, split=None):
    """``a`` as an array of heat type ``dtype`` in either package."""
    return lib.array(a, dtype=getattr(lib, dtype), split=split)


def numpy_of(x) -> np.ndarray:
    """An array's global values; bfloat16 widened to float32, exactly."""
    out = np.asarray(x.numpy())
    return out.astype(np.float32) if out.dtype == ml_dtypes.bfloat16 else out


def run_both(call):
    """(port result, heat_tpu result) of ``call(lib)``; where heat_tpu
    raises, the port must raise the same exception type, and (None, None)
    comes back."""
    try:
        ref = call(jht)
    except Exception as e:  # noqa: BLE001 (the port must fail the same way)
        with pytest.raises(type(e)):
            call(ht)
        return None, None
    return call(ht), ref


def same(got, ref, kind: str = "arith") -> None:
    """Values, heat type, shape and split of ``got`` against ``ref``;
    ``kind`` "exact", "arith" or "trans" picks the tolerance."""
    assert got.dtype.__name__ == ref.dtype.__name__, (got.dtype, ref.dtype)
    assert tuple(got.shape) == tuple(ref.shape), (got.shape, ref.shape)
    assert got.split == ref.split, (got.split, ref.split)
    g, r = numpy_of(got), numpy_of(ref)
    name = ref.dtype.__name__
    if kind == "exact" or name not in RTOL:
        np.testing.assert_array_equal(g, r)
        return
    rtol = RTOL[name][kind == "trans"]
    scale = float(np.nanmax(np.abs(r[np.isfinite(r)]))) if r.size and np.isfinite(r).any() else 1.0
    # jnp rounds each step of a float16/bfloat16 transcendental to the
    # narrow type, ATen rounds once: 4 ulps of the largest magnitude
    atol = rtol * scale * (4.0 if kind == "trans" and name in ("float16", "bfloat16") else 1e-3)
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, equal_nan=True)


def check(call, kind: str = "arith") -> None:
    got, ref = run_both(call)
    if ref is None:
        return
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            same(g, r, kind)
    elif isinstance(ref, (bool, np.bool_)):
        assert got is bool(ref)
    else:
        same(got, ref, kind)


# --------------------------------------------------------------------- #
# the promotion lattice                                                 #
# --------------------------------------------------------------------- #
HEAT_TYPES = ("bool", "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16", "float32", "float64",
              "complex64", "complex128")
SCALARS = {"bool": True, "int": 3, "float": 2.5, "complex": 1 + 2j}


@pytest.mark.parametrize("t1", HEAT_TYPES)
@pytest.mark.parametrize("t2", HEAT_TYPES)
def test_result_type_and_promote_types_of_every_pair_match_heat_tpu(t1, t2):
    want = jht.result_type(getattr(jht, t1), getattr(jht, t2)).__name__
    assert ht.result_type(getattr(ht, t1), getattr(ht, t2)).__name__ == want
    assert ht.promote_types(getattr(ht, t1), getattr(ht, t2)).__name__ == jht.promote_types(
        getattr(jht, t1), getattr(jht, t2)).__name__
    a, b = np.zeros(2, dtype="float32" if t1 == "bfloat16" else t1), np.zeros(2, "float32" if t2 == "bfloat16" else t2)
    if "bfloat16" not in (t1, t2):  # arrays take part with their strong types
        assert ht.result_type(make(ht, a, t1), make(ht, b, t2)).__name__ == want


@pytest.mark.parametrize("t1", HEAT_TYPES)
@pytest.mark.parametrize("scalar", list(SCALARS), ids=list(SCALARS))
def test_result_type_of_a_heat_type_and_a_python_scalar_matches_heat_tpu(t1, scalar):
    s = SCALARS[scalar]
    assert ht.result_type(getattr(ht, t1), s).__name__ == jht.result_type(getattr(jht, t1), s).__name__
    assert ht.result_type(s, getattr(ht, t1)).__name__ == jht.result_type(s, getattr(jht, t1)).__name__


@pytest.mark.parametrize("pair", [(a, b) for a in SCALARS for b in SCALARS], ids=lambda p: "-".join(p))
def test_result_type_of_python_scalars_alone_matches_heat_tpu(pair):
    s1, s2 = SCALARS[pair[0]], SCALARS[pair[1]]
    assert ht.result_type(s1, s2).__name__ == jht.result_type(s1, s2).__name__
    assert ht.result_type(np.float32(1), s1).__name__ == jht.result_type(np.float32(1), s1).__name__


@pytest.mark.parametrize("casting", ["no", "safe", "same_kind", "unsafe", "intuitive"])
def test_can_cast_and_issubdtype_match_heat_tpu(casting):
    for t1 in HEAT_TYPES:
        for t2 in HEAT_TYPES:
            got = ht.can_cast(getattr(ht, t1), getattr(ht, t2), casting)
            assert got == jht.can_cast(getattr(jht, t1), getattr(jht, t2), casting), (t1, t2, casting)
            assert ht.issubdtype(getattr(ht, t1), getattr(ht, t2)) == jht.issubdtype(getattr(jht, t1),
                                                                                    getattr(jht, t2))
    for abstract in ("floating", "integer", "signedinteger", "number", "complex"):
        for t in HEAT_TYPES:
            assert ht.issubdtype(getattr(ht, t), getattr(ht, abstract)) == jht.issubdtype(
                getattr(jht, t), getattr(jht, abstract))
    with pytest.raises(ValueError):
        ht.can_cast(ht.int32, ht.float32, "bogus")


# --------------------------------------------------------------------- #
# unary functions                                                       #
# --------------------------------------------------------------------- #
# (name, input domain, tolerance kind)
UNARY = [
    ("abs", "any", "arith"), ("fabs", "any", "arith"), ("ceil", "any", "exact"),
    ("floor", "any", "exact"), ("trunc", "any", "exact"), ("round", "any", "exact"), ("sign", "any", "exact"),
    ("sgn", "any", "arith"), ("negative", "any", "exact"), ("positive", "any", "exact"), ("square", "any", "arith"),
    ("invert", "any", "exact"), ("logical_not", "any", "exact"),
    ("isnan", "any", "exact"), ("isinf", "any", "exact"), ("isfinite", "any", "exact"),
    ("isneginf", "any", "exact"), ("isposinf", "any", "exact"), ("signbit", "any", "exact"),
    ("nan_to_num", "any", "exact"), ("conj", "any", "exact"), ("real", "any", "exact"), ("imag", "any", "exact"),
    ("angle", "any", "trans"),
    ("exp", "any", "trans"), ("expm1", "any", "trans"), ("exp2", "any", "trans"), ("log", "pos", "trans"),
    ("log2", "pos", "trans"), ("log10", "pos", "trans"), ("log1p", "pos", "trans"), ("sqrt", "pos", "trans"),
    ("sin", "any", "trans"), ("cos", "any", "trans"), ("tan", "unit", "trans"), ("arcsin", "unit", "trans"),
    ("arccos", "unit", "trans"), ("arctan", "any", "trans"), ("sinh", "unit", "trans"), ("cosh", "unit", "trans"),
    ("tanh", "any", "trans"), ("arcsinh", "any", "trans"), ("arctanh", "unit", "trans"),
    ("arccosh", "pos", "trans"), ("deg2rad", "any", "arith"), ("rad2deg", "any", "arith"),
]
# the second names of one function in heat_tpu: the port's are the same objects
ALIASES = {"absolute": "abs", "bitwise_not": "invert", "degrees": "rad2deg", "radians": "deg2rad",
           "arccos": "acos", "arcsin": "asin", "arctan": "atan", "arccosh": "acosh", "arcsinh": "asinh",
           "arctanh": "atanh", "arctan2": "atan2", "negative": "neg", "positive": "pos", "divide": "div",
           "multiply": "mul", "subtract": "sub", "power": "pow", "remainder": "mod", "floor_divide": "floordiv",
           "cumproduct": "cumprod", "conjugate": "conj", "greater": "gt", "greater_equal": "ge", "less": "lt",
           "less_equal": "le", "not_equal": "ne"}


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_aliases_name_the_same_functions_as_in_heat_tpu(alias):
    assert (getattr(jht, alias) is getattr(jht, ALIASES[alias])) == (getattr(ht, alias) is getattr(ht, ALIASES[alias]))
    assert getattr(ht, alias) is getattr(ht, ALIASES[alias])


@pytest.mark.parametrize("split", (None, 1))  # local ops: each shard alone; split 0 is the binary tests'
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name, domain, kind", UNARY, ids=[u[0] for u in UNARY])
def test_unary_functions_match_heat_tpu(name, domain, kind, dtype, split):
    a = values(SHAPE, dtype, domain, seed=1)
    if name == "arccosh" and dtype not in ("bool",):
        a = (a + 1).astype(a.dtype) if "int" not in dtype else np.abs(a) + 1
    if name in ("sign", "angle") and a.dtype.kind in "fc":  # NaN (a complex one's real part) and −0.0
        a = a.copy()
        a.flat[:2] = np.nan, -0.0
        if a.dtype.kind == "c":
            a.flat[2:4] = complex(np.nan, 1.0), complex(-0.0, -0.0)
    check(lambda lib: getattr(lib, name)(make(lib, a, dtype, split)), kind)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ("float32", "float64", "int32", "bool"))
@pytest.mark.parametrize("call", [
    ("clip_both", lambda lib, x: lib.clip(x, -0.5, 0.7)), ("clip_min", lambda lib, x: lib.clip(x, min=0)),
    ("clip_max", lambda lib, x: x.clip(max=1)), ("round_2", lambda lib, x: lib.round(x, 2)),
    ("round_dtype", lambda lib, x: lib.round(x, dtype=lib.float64)), ("abs_dtype", lambda lib, x: lib.abs(x, dtype=lib.float32)),
    ("modf", lambda lib, x: lib.modf(x)), ("angle_deg", lambda lib, x: lib.angle(x, deg=True)),
    ("nan_to_num_args", lambda lib, x: lib.nan_to_num(x / 0 if x.dtype is not lib.bool else x, nan=1.5, posinf=9.0, neginf=-9.0)),
], ids=lambda c: c[0])
def test_unary_functions_with_arguments_match_heat_tpu(call, dtype, split):
    a = values(SHAPE, dtype, "any", seed=2)
    check(lambda lib: call[1](lib, make(lib, a, dtype, split)), "arith")


# --------------------------------------------------------------------- #
# binary functions                                                      #
# --------------------------------------------------------------------- #
# (name, domain of the first and of the second operand, tolerance kind)
BINARY = [
    ("add", "any", "any", "arith"), ("sub", "any", "pos", "arith"), ("mul", "any", "pos", "arith"),
    ("div", "any", "pos", "arith"), ("floordiv", "any", "pos", "exact"), ("mod", "pos", "pos", "arith"),
    ("fmod", "any", "pos", "arith"), ("pow", "pos", "unit", "trans"), ("hypot", "any", "pos", "trans"),
    ("copysign", "pos", "any", "exact"), ("maximum", "any", "any", "exact"), ("minimum", "any", "any", "exact"),
    ("arctan2", "any", "pos", "trans"), ("logaddexp", "any", "any", "trans"), ("logaddexp2", "any", "any", "trans"),
    ("bitwise_and", "any", "any", "exact"), ("bitwise_or", "any", "any", "exact"),
    ("bitwise_xor", "any", "any", "exact"), ("gcd", "pos", "pos", "exact"), ("lcm", "pos", "pos", "exact"),
    ("left_shift", "pos", "pos", "exact"), ("right_shift", "pos", "unit", "exact"),
    ("eq", "unit", "unit", "exact"), ("ne", "unit", "unit", "exact"), ("lt", "any", "any", "exact"),
    ("le", "unit", "unit", "exact"), ("gt", "any", "any", "exact"), ("ge", "unit", "unit", "exact"),
    ("logical_and", "any", "any", "exact"), ("logical_or", "any", "any", "exact"),
    ("logical_xor", "any", "any", "exact"), ("isclose", "unit", "unit", "exact"),
]
SPLIT_PAIRS = ((None, None), (0, 1), (None, 0))


@pytest.mark.parametrize("splits", SPLIT_PAIRS, ids=lambda s: f"{s[0]}-{s[1]}")
@pytest.mark.parametrize("dtype", [d for d in DTYPES if d not in ("bfloat16", "int64")])  # those: the unary and mixed-type tests
@pytest.mark.parametrize("name, d1, d2, kind", BINARY, ids=[b[0] for b in BINARY])
def test_binary_functions_match_heat_tpu(name, d1, d2, kind, dtype, splits):
    a, b = values(SHAPE, dtype, d1, seed=3), values(SHAPE, dtype, d2, seed=4)
    if name in ("right_shift", "pow") and "int" in dtype:
        b = np.abs(b)
    if name in ("floordiv", "mod", "fmod") and dtype == "bool":
        b = np.ones_like(b)  # no division by zero
    check(lambda lib: getattr(lib, name)(make(lib, a, dtype, splits[0]), make(lib, b, dtype, splits[1])), kind)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("pair", [("int32", "float32"), ("int8", "uint8"), ("bool", "int64"), ("float16", "bfloat16"),
                                  ("int64", "float16"), ("float32", "complex64"), ("int32", "float64")],
                         ids=lambda p: "-".join(p))
@pytest.mark.parametrize("name", ["add", "mul", "div", "maximum", "lt", "pow"])
def test_binary_functions_promote_mixed_types_as_heat_tpu(name, pair, split):
    a, b = values(SHAPE, pair[0], "pos", seed=5), values(SHAPE, pair[1], "pos", seed=6)
    kind = "trans" if name == "pow" else "arith"
    check(lambda lib: getattr(lib, name)(make(lib, a, pair[0], split), make(lib, b, pair[1], split)), kind)


BROADCASTS = {
    "row": ((5, 9), (9,)), "outer": ((5, 1), (1, 9)), "one_first": ((1,), (5, 9)), "zero_d": ((5, 9), ()),
    "zero_d_first": ((), (5, 9)), "empty": ((0, 9), (9,)), "empty_both": ((0, 9), (1, 9)), "col": ((5, 9), (5, 1)),
    "three_d": ((2, 5, 9), (5, 1)),
}


@pytest.mark.parametrize("splits", [(0, None), (None, 0), (1, 0), (-1, None)], ids=lambda s: f"{s[0]}-{s[1]}")
@pytest.mark.parametrize("case", list(BROADCASTS))
@pytest.mark.parametrize("name", ["add", "sub", "div", "gt", "maximum", "logaddexp"])
def test_broadcasting_operands_match_heat_tpu(name, case, splits):
    s1, s2 = BROADCASTS[case]

    def split_of(shape, s):
        return None if s is None or not shape else s % len(shape)

    a, b = values(s1, "float32", "any", 7), values(s2, "float32", "pos", 8)

    def call(lib):
        return getattr(lib, name)(lib.array(a, split=split_of(s1, splits[0])),
                                  lib.array(b, split=split_of(s2, splits[1])))

    kind = "trans" if name == "logaddexp" else "arith"
    if "empty" not in case:
        check(call, kind)
        return
    # heat_tpu fails its own sharding check on an empty operand split along
    # the broadcast axis: hold the port against numpy and the split rule
    got = call(ht)
    np_name = {"add": "add", "sub": "subtract", "div": "divide", "gt": "greater", "maximum": "maximum",
               "logaddexp": "logaddexp"}[name]
    want = getattr(np, np_name)(a, b)
    assert got.shape == want.shape and numpy_of(got).dtype == want.dtype
    s = split_of(s1, splits[0])
    s = s + len(want.shape) - len(s1) if s is not None else split_of(s2, splits[1])
    if s is not None and split_of(s1, splits[0]) is None:
        s += len(want.shape) - len(s2)
    assert got.split == (s if s is not None and want.shape[s] > 1 else None)


@pytest.mark.parametrize("split", (None, 1))
@pytest.mark.parametrize("dtype", ("float32", "int32", "bool", "float16", "complex64"))
@pytest.mark.parametrize("scalar", [2, 0.5, True, -3, 1 + 1j, np.float32(2.0)],
                         ids=["int", "float", "bool", "neg_int", "complex", "np.float32"])
def test_scalar_operands_on_either_side_match_heat_tpu(scalar, dtype, split):
    a = values(SHAPE, dtype, "pos", seed=9)
    if isinstance(scalar, int) and scalar < 0 and dtype in ("int32", "int64", "bool"):
        with pytest.raises(ValueError):
            make(ht, a, dtype, split) ** scalar
        scalar = 3
    for op in ("__radd__", "__mul__", "__rtruediv__", "__rsub__", "__ge__", "__pow__"):
        check(lambda lib: getattr(make(lib, a, dtype, split), op)(scalar), "trans" if "pow" in op else "arith")


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("other", ["numpy", "numpy_row", "tensor"])
def test_array_like_operands_match_heat_tpu(other, split):
    a = values(SHAPE, "float32", "any", 10)
    b = values(SHAPE if other != "numpy_row" else (9,), "float64", "pos", 11)

    def call(lib):
        o = torch.from_numpy(b) if other == "tensor" and lib is ht else b
        return make(lib, a, "float32", split) + o, lib.mul(o, make(lib, a, "float32", split))

    check(call)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ("int32", "int64"))
def test_integers_to_negative_powers_raise(dtype, split):
    x = ht.array(values(SHAPE, dtype, "pos", 40), split=split)
    for exponent in (-1, ht.array(-values(SHAPE, dtype, "pos", 41), split=split)):
        with pytest.raises(ValueError, match="negative integer powers"):
            ht.pow(x, exponent)
    np.testing.assert_array_equal((x ** 2).numpy(), values(SHAPE, dtype, "pos", 40) ** 2)


# --------------------------------------------------------------------- #
# operator dunders                                                      #
# --------------------------------------------------------------------- #
DUNDERS = ["__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__", "__truediv__", "__rtruediv__",
           "__floordiv__", "__rfloordiv__", "__mod__", "__rmod__", "__pow__", "__rpow__", "__and__", "__rand__",
           "__or__", "__ror__", "__xor__", "__rxor__", "__lshift__", "__rshift__", "__eq__", "__ne__", "__lt__",
           "__le__", "__gt__", "__ge__", "__divmod__"]


@pytest.mark.parametrize("splits", [(0, 1), (1, None)], ids=lambda s: f"{s[0]}-{s[1]}")
@pytest.mark.parametrize("dtype", ("float32", "int32", "bool"))
@pytest.mark.parametrize("op", DUNDERS)
def test_binary_dunders_match_heat_tpu(op, dtype, splits):
    a, b = values(SHAPE, dtype, "pos", 12), values(SHAPE, dtype, "pos", 13)
    if dtype == "bool":  # no division by zero
        a, b = a | True, b | True
    kind = "trans" if "pow" in op else "arith"
    check(lambda lib: getattr(make(lib, a, dtype, splits[0]), op)(make(lib, b, dtype, splits[1])), kind)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ("float32", "int32", "bool", "complex64"))
@pytest.mark.parametrize("op", ["__neg__", "__pos__", "__abs__", "__invert__"])
def test_unary_dunders_match_heat_tpu(op, dtype, split):
    a = values(SHAPE, dtype, "any", 14)
    check(lambda lib: getattr(make(lib, a, dtype, split), op)(), "arith" if op == "__abs__" else "exact")


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("op", ["__iadd__", "__isub__", "__imul__", "__itruediv__"])
def test_in_place_dunders_match_heat_tpu(op, split):
    a, b = values(SHAPE, "float32", "any", 15), values(SHAPE, "float32", "pos", 16)

    def call(lib):
        x = lib.array(a, split=split)
        y = getattr(x, op)(lib.array(b, split=split))
        return y

    check(call)


@pytest.mark.parametrize("split", SPLITS)
def test_methods_match_heat_tpu(split):
    a, b = values(SHAPE, "float32", "pos", 17), values(SHAPE, "float32", "pos", 18)
    for m in ("add", "sub", "mul", "div", "pow", "mod"):
        check(lambda lib: getattr(lib.array(a, split=split), m)(lib.array(b, split=split)),
              "trans" if m == "pow" else "arith")
    for m in ("exp", "log", "sqrt", "square", "exp2", "expm1", "log2", "log10", "log1p", "cos", "sin", "tan",
              "cosh", "sinh", "tanh", "abs", "ceil", "floor", "round", "trunc", "fabs", "conj"):
        check(lambda lib: getattr(lib.array(a, split=split), m)(), "trans")
    check(lambda lib: lib.array(a, split=split).clip(0.7, 1.1))
    check(lambda lib: lib.array(a, split=split).isclose(lib.array(b, split=split)), "exact")
    assert ht.array(a, split=split).allclose(ht.array(a, split=split)) is True
    assert ht.array(a, split=split).allclose(ht.array(b, split=split)) is bool(
        jht.array(a, split=split).allclose(jht.array(b, split=split)))


# --------------------------------------------------------------------- #
# out= and where=                                                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("out_split", SPLITS)
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", ["add", "mul", "div", "bitwise_and", "floordiv"])
def test_out_buffers_keep_their_type_and_split_as_in_heat_tpu(name, split, out_split):
    dtype = "int32" if name in ("bitwise_and", "floordiv") else "float32"
    a, b = values(SHAPE, dtype, "pos", 19), values(SHAPE, dtype, "pos", 20)

    def call(lib):
        out = lib.array(np.zeros(SHAPE, dtype="float64"), split=out_split)
        res = getattr(lib, name)(lib.array(a, split=split), lib.array(b, split=split), out=out)
        assert res is out
        return out

    check(call)


@pytest.mark.parametrize("with_out", [False, True])
@pytest.mark.parametrize("where_kind", ["dndarray", "dndarray_row", "numpy"])
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", ["add", "sub", "mul", "div"])
def test_where_masks_match_heat_tpu(name, split, where_kind, with_out):
    a, b = values(SHAPE, "float32", "any", 21), values(SHAPE, "float32", "pos", 22)
    mask = values(SHAPE if where_kind != "dndarray_row" else (9,), "bool", seed=23)

    def call(lib):
        where = mask if where_kind == "numpy" else lib.array(mask, split=split if mask.ndim == 2 else None)
        out = lib.array(np.full(SHAPE, 7.0, np.float32), split=split) if with_out else None
        return getattr(lib, name)(lib.array(a, split=split), lib.array(b, split=split), out=out, where=where)

    check(call)


def test_divmod_pairs_and_out_tuples_match_heat_tpu():
    a, b = values(SHAPE, "float32", "any", 24), values(SHAPE, "float32", "pos", 25)
    check(lambda lib: lib.divmod(lib.array(a, split=0), lib.array(b, split=0)))
    check(lambda lib: divmod(lib.array(a, split=1), 2.0))

    def with_out(lib):
        o1, o2 = lib.array(np.zeros(SHAPE, np.float32)), lib.array(np.zeros(SHAPE, np.float32), split=0)
        lib.divmod(lib.array(a), lib.array(b), out=(o1, o2))
        return o1, o2

    check(with_out)


def test_operands_that_do_not_broadcast_raise_as_in_heat_tpu():
    for pkg in (jht, ht):
        with pytest.raises(ValueError):
            pkg.array(np.ones((5, 9))) + pkg.array(np.ones((4,)))
        with pytest.raises(TypeError):
            pkg.add(1, 2)
        with pytest.raises(TypeError):
            pkg.bitwise_and(pkg.array(np.ones(3, np.float32)), pkg.array(np.ones(3, np.float32)))


# --------------------------------------------------------------------- #
# the DNDarray protocol                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", SPLITS)
def test_iteration_copies_and_scalar_casts_match_heat_tpu(split):
    import copy

    a = values((4, 3), "float32", "any", 26)
    rows = [r.numpy() for r in ht.array(a, split=split)]
    want = [r.numpy() for r in jht.array(a, split=split)]
    assert len(rows) == len(want) == 4
    for r, w in zip(rows, want):
        np.testing.assert_array_equal(r, w)
    splits = [r.split for r in ht.array(a, split=split)]
    assert splits == [r.split for r in jht.array(a, split=split)]
    x = ht.array(a, split=split)
    shallow, deep, dup = copy.copy(x), copy.deepcopy(x), x.copy()
    assert shallow.larray is x.larray and deep.larray is not x.larray and dup.larray is not x.larray
    for c in (shallow, deep, dup):
        assert c.split == x.split and c.dtype is x.dtype
        np.testing.assert_array_equal(c.numpy(), a)
    dup += 1
    np.testing.assert_array_equal(x.numpy(), a)
    assert complex(ht.array([1.5 - 2j])) == complex(jht.array([1.5 - 2j])) == 1.5 - 2j


# --------------------------------------------------------------------- #
# cumulative sums and products, diff                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", ("float32", "float64", "int32", "int64", "bool", "float16", "complex64"))
@pytest.mark.parametrize("name", ["cumsum", "cumprod", "cumproduct"])
def test_cumulative_ops_match_heat_tpu(name, dtype, axis, split):
    a = values(SHAPE, dtype, "unit", 27)
    got, ref = run_both(lambda lib: getattr(lib, name)(make(lib, a, dtype, split), axis))
    if ref is None:
        return
    assert got.dtype.__name__ == ref.dtype.__name__ and got.split == ref.split and got.shape == ref.shape
    g, r = numpy_of(got), numpy_of(ref)
    if ref.dtype.__name__ in RTOL:  # rtol of the absolute sums (reductions in another order)
        scale = np.cumsum(np.abs(numpy_of(make(jht, a, dtype))).astype(np.float64), axis=axis) + 1
        np.testing.assert_array_less(np.abs(g - r), RTOL[ref.dtype.__name__][1] * 10 * scale + 1e-30)
    else:
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ("float32", "int32"))
def test_cumsum_with_dtype_and_out_matches_heat_tpu(dtype, split):
    a = values(SHAPE, dtype, "any", 28)
    check(lambda lib: lib.cumsum(lib.array(a, split=split), 1, dtype=lib.float64))

    def with_out(lib):
        out = lib.array(np.zeros(SHAPE, np.float32), split=split)
        lib.cumsum(lib.array(a, split=split), 0, out=out)
        return out

    check(with_out)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("n", [0, 1, 2, 3])
@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("dtype", ("float32", "int32", "bool"))
def test_diff_matches_heat_tpu(dtype, axis, n, split):
    a = values((4, 6), dtype, "any", 29)
    check(lambda lib: lib.diff(lib.array(a, split=split), n=n, axis=axis), "arith")


# --------------------------------------------------------------------- #
# the reductions of arithmetics and logical                             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", (None, 0))
@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
@pytest.mark.parametrize("dtype", ("float32", "float64", "int32", "bool", "float16", "complex64"))
@pytest.mark.parametrize("name", ["sum", "prod", "nansum", "nanprod", "all", "any"])
def test_arithmetic_and_logical_reductions_match_heat_tpu(name, dtype, axis, split):
    a = values(SHAPE, dtype, "unit" if "prod" in name else "any", 30)
    if dtype in ("float32", "float64") and "nan" in name:
        a[1, 2] = np.nan
    check(lambda lib: getattr(lib, name)(make(lib, a, dtype, split), axis=axis, keepdims=axis == 1), "trans")


@pytest.mark.parametrize("split", SPLITS)
def test_equal_and_allclose_give_one_bool_as_in_heat_tpu(split):
    a = values(SHAPE, "float32", "any", 31)
    b = a.copy()
    b[2, 3] += 1e-3
    for x, y in ((a, a), (a, b), (a, a[0]), (a, np.ones((2, 2), np.float32))):
        check(lambda lib: lib.equal(lib.array(x, split=split), lib.array(y)))
    for rtol in (1e-5, 1e-2):
        check(lambda lib: lib.allclose(lib.array(a, split=split), lib.array(b), rtol=rtol))
    assert ht.equal(ht.array(a, split=split), 0.5) is False


# --------------------------------------------------------------------- #
# across ranks: the session's 4-rank world (torch_mp_worker.py's         #
# SURFACE_CASES) against heat_tpu on 4 devices                           #
# --------------------------------------------------------------------- #
STATISTICS_PREFIXES = ("argmax", "argmin", "max_", "min_", "mean", "var", "std", "standardize", "average", "skew",
                       "kurtosis", "median", "percentile", "histc", "histogram", "bincount", "digitize", "prod",
                       "nansum", "any", "all", "abs_max", "count")


def surface_world(ranks, jcomm, name: str, rtol: float) -> None:
    """Every rank's result of ``SURFACE_CASES[name]`` against heat_tpu's on
    the 4-device mesh: dtype, split and shape equal; values exactly for
    integers and bools, else within ``rtol`` (and ``rtol`` of the largest
    magnitude); a rank whose map of shard shapes is the chunk geometry
    holds heat_tpu's device-r chunk."""
    import torch_mp_worker as worker
    from test_torch_distributed import WORLD, _result

    ref = worker.SURFACE_CASES[name](jht, {"comm": jcomm})
    want = None if isinstance(ref, bool) else numpy_of(ref)
    for r, res in enumerate(_result(ranks, f"surface_{name}")):
        if want is None:
            assert res["value"] is ref
            continue
        assert res["dtype"] == ref.dtype.__name__ and res["split"] == ref.split, (res["dtype"], ref.dtype, res["split"],
                                                                                 ref.split)
        assert tuple(res["gshape"]) == tuple(ref.gshape)
        got = res["global"].astype(np.float32) if res["global"].dtype.name == "bfloat16" else res["global"]
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want)
        else:
            scale = float(np.nanmax(np.abs(want))) if want.size and np.isfinite(want).any() else 1.0
            np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(scale, 1.0), equal_nan=True)
        if res["split"] is not None and np.array_equal(res["lmap"], jcomm.lshape_map(ref.gshape, ref.split)):
            mine = got[jcomm.chunk(ref.gshape, ref.split, rank=r)[2]]
            np.testing.assert_array_equal(res["local"], mine)
    assert len(_result(ranks, f"surface_{name}")) == WORLD


def _elementwise_world_cases():
    import torch_mp_worker as worker

    return sorted(n for n in worker.SURFACE_CASES if not n.startswith(STATISTICS_PREFIXES))


@pytest.mark.parametrize("name", _elementwise_world_cases())
def test_binary_ops_cumsum_and_diff_across_four_ranks_match_heat_tpu(ranks, jcomm, name):
    """Mixed splits, broadcasting, replicated and uneven operands, out= and
    where=, and cumsum/cumprod/diff along the split axis (ranks with no
    rows and gaps in the map included): float32 within rtol 1e-5 (sums in
    another order across ranks), exactly for integers and bools."""
    surface_world(ranks, jcomm, name, 1e-5)


# --------------------------------------------------------------------- #
# the three faults of linalg/basics.py (ROADMAP Queue 3)                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ("int8", "int16", "int32", "int64", "uint8", "bool"))
def test_trace_and_vecdot_of_integers_widen_as_in_heat_tpu(dtype, split):
    a = values((6, 6), "int8" if dtype == "uint8" else dtype, "pos", 32).astype(dtype)
    check(lambda lib: lib.trace(lib.array(a, split=split)), "exact")
    check(lambda lib: lib.trace(lib.array(a, split=split), offset=1), "exact")
    check(lambda lib: lib.vecdot(lib.array(a, split=split), lib.array(a, split=split)), "exact")
    check(lambda lib: lib.vecdot(lib.array(a, split=split), lib.array(a, split=split), axis=0), "exact")


@pytest.mark.parametrize("split", SPLITS)
def test_products_of_bools_are_bool_as_in_heat_tpu(split):
    a, b = values((5, 4), "bool", seed=33), values((4, 3), "bool", seed=34)
    v, w = values((7,), "bool", seed=35), values((7,), "bool", seed=36)
    vs = None if split is None else 0
    check(lambda lib: lib.matmul(lib.array(a, split=split), lib.array(b, split=split)), "exact")
    check(lambda lib: lib.dot(lib.array(a, split=split), lib.array(b)), "exact")
    check(lambda lib: lib.dot(lib.array(v, split=vs), lib.array(w, split=vs)), "exact")
    check(lambda lib: lib.vdot(lib.array(v, split=vs), lib.array(w, split=vs)), "exact")
    check(lambda lib: lib.dot(lib.array(np.zeros(7, bool), split=vs), lib.array(w, split=vs)), "exact")
    check(lambda lib: lib.linalg.vector_norm(lib.array(a, split=split)), "trans")
    check(lambda lib: lib.norm(lib.array(a, split=split)), "trans")
    check(lambda lib: lib.linalg.vector_norm(lib.array(a, split=split), axis=1, ord=1), "trans")


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", ("float16", "bfloat16"))
def test_float16_det_and_the_refusals_of_inv_and_matrix_norm_as_in_heat_tpu(dtype, split):
    """det of float16 and bfloat16 runs in float32 and comes back in the
    operand's type. heat_tpu on this tree raises NotImplementedError there
    (jax's LAPACK has no half precision), so the determinant is held
    against numpy's float64 one, rounded to the type; inv and the
    spectral and nuclear matrix norms raise NotImplementedError in both."""
    a = (values((4, 4), "float32", "any", 37) + 3 * np.eye(4, dtype=np.float32)).astype(np.float32)
    a = torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()  # exact in the type
    x = ht.array(a, dtype=getattr(ht, dtype), split=split)
    got = ht.linalg.det(x)
    assert got.dtype is getattr(ht, dtype) and got.split is None and got.shape == ()
    want = float(np.linalg.det(a.astype(np.float64)))
    np.testing.assert_allclose(float(got.item()), want, rtol=8 * RTOL[dtype][0])
    batch = ht.array(np.stack([a, 2 * a]), dtype=getattr(ht, dtype), split=0 if split is not None else None)
    np.testing.assert_allclose(ht.linalg.det(batch).numpy().astype(np.float64), [want, 16 * want],
                               rtol=8 * RTOL[dtype][0])
    for call in (lambda lib: lib.linalg.inv(make(lib, a, dtype, split)),
                 lambda lib: lib.linalg.matrix_norm(make(lib, a, dtype, split), ord=2),
                 lambda lib: lib.linalg.matrix_norm(make(lib, a, dtype, split), ord="nuc")):
        with pytest.raises(NotImplementedError):
            call(jht)
        with pytest.raises(NotImplementedError):
            call(ht)
    for ord_ in ("fro", 1, float("inf")):  # the other orders keep the type, as in heat_tpu
        check(lambda lib: lib.linalg.matrix_norm(make(lib, a, dtype, split), ord=ord_), "trans")
