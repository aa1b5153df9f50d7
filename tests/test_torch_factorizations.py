"""heat_tpu_torch's dense factorizations and iterative solvers against
heat_tpu's: ``polar``, ``cholesky``, ``lu``, ``solve``, ``eigh``, ``svd``,
``inv``/``det`` through the blocked LU, ``cg`` and ``lanczos``.

Every case of ``FACT_CASES`` (tests/torch_mp_worker.py) runs the same call
on both packages with the same seeded NumPy operands: at world size 1 (the
port in this process, heat_tpu on a 1-device ``MeshCommunication``) and in
the test run's 4-rank world (each rank's shard against heat_tpu on
``MeshCommunication(devices=jax.devices()[:4])``), on splits None, 0 and 1,
n = 37 (a pad block: blocks of 10, 10, 10, 7) and n = 5 (blocks of 2, 2, 1,
0: a rank with no rows), in float32, float64 and complex64. inv/det run the
blocked LU with ``_BLOCKED_MIN_N`` shrunk to 4 in both packages, eigh
recurses with ``_EIGH_RESPLIT_MIN_N`` shrunk to 3 in both (order 7 over 2,
2, 2, 1 rows, a branch of order 4 over 1, 1, 1, 0).

Tolerances: LU's ``perm`` and the sign of its permutation exactly; other
values within ``TOL`` of the largest magnitude of heat_tpu's output (float32
and complex64 1e-4, float64 1e-9: both sides factor in the same order, but
LAPACK's and XLA's kernels round otherwise), eigenvalues and singular values
too; eigenvectors and singular vectors column by column up to a phase,
within ``VEC_TOL`` (float32 2e-3, float64 1e-7: a vector's error is the
value error over the gap to the next eigenvalue). Global shape, split, heat
type and each rank's shard (the chunk geometry) equal heat_tpu's; whole
results are equal on every rank. The collectives each rank issues are the
ones the port's docstrings name (``_fact_counts``), and no all-gather moves
as many elements as the operand.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu.core.communication import MeshCommunication
from test_torch_distributed import WORLD, _result, jcomm, ranks  # noqa: F401 (the test run's 4-rank world)

import torch_mp_worker as worker

TOL = {"float32": 1e-4, "complex64": 1e-4, "float64": 1e-9, "complex128": 1e-9}
VEC_TOL = {"float32": 2e-3, "complex64": 2e-3, "float64": 1e-7, "complex128": 1e-7}

pfact = importlib.import_module("heat_tpu_torch.core.linalg.factorizations")
jfact = importlib.import_module("heat_tpu.core.linalg.factorizations")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.zeros(1)


_J1 = []


def _j1():
    """heat_tpu's communicator over one CPU device (world size 1)."""
    if not _J1:
        _J1.append(MeshCommunication(devices=jax.devices()[:1]))
    return _J1[0]


def _numpy(x) -> np.ndarray:
    if hasattr(x, "larray"):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _outputs(res) -> list:
    return list(res) if isinstance(res, (list, tuple)) else [res]


def _dtype_name(out) -> str:
    return out.dtype.__name__ if hasattr(out, "larray") else np.asarray(out).dtype.name


def _phase_aligned(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """``got``'s columns, each times the unit phase that best matches ``want``'s."""
    dots = np.sum(np.conj(got) * want, axis=0)
    mag = np.abs(dots)
    return got * np.where(mag > 0, dots / np.where(mag > 0, mag, 1), 1)


def _held(kind: str, got: np.ndarray, want: np.ndarray, dtype: str, what: str) -> None:
    """One output against heat_tpu's: ``exact`` integers, ``vec`` columns
    (``vech`` rows) up to a phase each, anything else values."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if kind == "exact":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    if got.size == 0:
        return
    scale = max(float(np.max(np.abs(want))), 1e-30)
    if kind in ("vec", "vech"):
        g, w = (got, want) if kind == "vec" else (got.T, want.T)
        np.testing.assert_allclose(_phase_aligned(g, w), w, rtol=0, atol=VEC_TOL[dtype] * max(scale, 1.0), err_msg=what)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale, err_msg=what)


def _tol_name(out, got: np.ndarray) -> str:
    """The dtype whose tolerance holds an output: its heat type's, or for
    values of a complex call (real numbers) the matching complex one."""
    name = _dtype_name(out)
    return name if name in TOL else {"int32": "float32", "int64": "float64"}.get(name, got.dtype.name)


# --------------------------------------------------------------------- #
# world size 1                                                          #
# --------------------------------------------------------------------- #
# heat_tpu's local eigh symmetrizes its operand, so at world size 1 it reads
# both triangles; the port reads UPLO's (test_world_size_one_reads_one_triangle).
# float64 eigh runs here only: across ranks float32 and complex64 hold the
# divide and conquer, each of whose dtypes costs heat_tpu seconds of compiles
ONE_RANK_CASES = {
    **{n: c for n, c in worker.FACT_CASES.items() if n != "eigh_37_0_junk_upper"},
    "eigh_5_0_float64_U": (lambda L, kw: L.linalg.eigh(
        L.array(worker.fact_matrix("spd", (5, 5), "float64", 24), split=0, **kw), UPLO="U"), ("w", "vec")),
}


@pytest.mark.parametrize("name", sorted(ONE_RANK_CASES))
def test_world_size_one_matches_heat_tpu(name):
    """Each case at world size 1: the port's ``torch.linalg`` route against
    heat_tpu's local XLA route on one device (inv/det gather below the
    blocked order, eigh does not recurse: both act across ranks only)."""
    call, kinds = ONE_RANK_CASES[name]
    ref = _outputs(call(jht, {"comm": _j1()}))
    got = _outputs(call(ht, {}))
    assert len(got) == len(ref) == len(kinds)
    for i, (g, w, kind) in enumerate(zip(got, ref, kinds)):
        if hasattr(w, "larray"):
            assert (g.split, tuple(g.gshape), g.dtype.__name__) == (w.split, tuple(w.gshape), w.dtype.__name__), (
                name, i, g.split, g.gshape, g.dtype, w.split, w.gshape, w.dtype)
        gn, wn = _numpy(g), _numpy(w)
        _held(kind, gn, wn, _tol_name(w, wn), f"{name}[{i}]")


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_world_size_one_reads_one_triangle(dtype):
    """cholesky reads A's lower triangle, eigh the ``UPLO`` one: noise in the
    other triangle changes nothing (against NumPy on the Hermitian fill)."""
    a = worker.fact_matrix("spd", (9, 9), dtype, 40)
    noise = worker.fact_matrix("tall", (9, 9), dtype, 41)
    lower, upper = np.tril(a) + np.triu(noise, 1), np.triu(a) + np.tril(noise, -1)
    L = ht.linalg.cholesky(ht.array(lower)).numpy()
    np.testing.assert_allclose(L, np.linalg.cholesky(a.astype(np.complex128)), rtol=0, atol=1e-5)
    for uplo, x in (("L", lower), ("U", upper)):
        w, v = ht.linalg.eigh(ht.array(x), UPLO=uplo)
        np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(a.astype(np.complex128)), rtol=0, atol=1e-5)
        np.testing.assert_allclose(v.numpy() @ np.diag(w.numpy()) @ v.numpy().conj().T, a, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 5, 37])
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64"])
def test_lapack_pivots_give_lax_lus_permutation(n, dtype):
    """``_lapack_permutation``: torch.linalg.lu_factor's 1-based LAPACK
    pivots as ``lax.linalg.lu``'s permutation (a[perm] = L U) and the int32
    parity of its swaps, exactly, on matrices that pivot at every step."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n)) * np.arange(1, n + 1)[:, None]  # later rows larger: many swaps
    if dtype == "complex64":
        a = a + 1j * rng.standard_normal((n, n))
    a = a.astype(dtype)
    lu, piv, perm = jax.lax.linalg.lu(jax.numpy.asarray(a))
    sign = np.prod(np.where(np.asarray(piv) != np.arange(n), -1, 1))
    lu_t, piv_t = torch.linalg.lu_factor(torch.from_numpy(a))
    got_perm, got_sign = pfact._lapack_permutation(lu_t, piv_t)
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(perm))
    assert got_sign.dtype == torch.int32 and int(got_sign) == int(sign)


def test_golden_plan_ids_equal_heat_tpus():
    """``golden_factorization_plans``: the same names, and each plan_id and
    canonical serialization heat_tpu's."""
    mine, theirs = pfact.golden_factorization_plans(), jfact.golden_factorization_plans()
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    for (name, p), (_, j) in zip(mine, theirs):
        assert p.plan_id == j.plan_id, name
        assert p.canonical_json() == j.canonical_json(), name


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_range_probe_is_heat_tpus_draw(dtype):
    """eigh's range probes: heat_tpu's Threefry normals, within 4 ulp."""
    tt = getattr(torch, dtype)
    got = pfact._range_probe(37, 12, 1, 0, tt, "cpu").numpy()
    want = np.asarray(jfact._range_probe(37, 12, 1, 0, jax.numpy.dtype(dtype)))
    np.testing.assert_allclose(got, want, rtol=4 * np.finfo(np.float32).eps, atol=4 * np.finfo(np.float32).tiny)


def test_every_heat_tpu_linalg_name_resolves_to_a_port_object():
    """``ht.linalg`` and ``ht`` carry every public name of heat_tpu's linear
    algebra but ``solve_endpoint`` (a serving endpoint, ROADMAP.md Queue 1
    item 13)."""
    names = set()
    for mod in ("basics", "qr", "solver", "svd", "svdtools", "factorizations"):
        names |= set(importlib.import_module(f"heat_tpu.core.linalg.{mod}").__all__)
    names.discard("solve_endpoint")
    for name in sorted(names):
        assert getattr(ht.linalg, name, None) is not None, name
        assert getattr(ht, name, None) is getattr(ht.linalg, name), name
    assert not hasattr(ht.linalg, "solve_endpoint")


REFUSALS = {
    "polar_1d": lambda L: L.linalg.polar(L.ones(4)),
    "polar_side": lambda L: L.linalg.polar(L.ones((4, 3)), side="up"),
    "polar_wide_right": lambda L: L.linalg.polar(L.ones((3, 4))),
    "polar_tall_left": lambda L: L.linalg.polar(L.ones((4, 3)), side="left"),
    "cholesky_rectangular": lambda L: L.linalg.cholesky(L.ones((4, 3))),
    "lu_rectangular": lambda L: L.linalg.lu(L.ones((4, 3))),
    "solve_assume": lambda L: L.linalg.solve(L.eye(4), L.ones(4), assume_a="sym"),
    "solve_b_shape": lambda L: L.linalg.solve(L.eye(4), L.ones((3, 2))),
    "eigh_uplo": lambda L: L.linalg.eigh(L.eye(4), UPLO="X"),
    "svd_method": lambda L: L.linalg.svd(L.ones((4, 3)), method="jacobi"),
    "svd_3d": lambda L: L.linalg.svd(L.ones((2, 4, 3))),
    "svd_full_matrices": lambda L: L.linalg.svd(L.ones((4, 3)), full_matrices=True),
    "cg_types": lambda L: L.linalg.cg(L.eye(4), np.ones(4), L.zeros(4)),
    "cg_b_2d": lambda L: L.linalg.cg(L.eye(4), L.ones((4, 1)), L.zeros(4)),
    "lanczos_rectangular": lambda L: L.linalg.lanczos(L.ones((4, 3)), 2),
    "lanczos_m": lambda L: L.linalg.lanczos(L.eye(4), "2"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_raise_heat_tpus_exception_type(name):
    """Bad arguments raise what heat_tpu raises (its own classes by name,
    beside the built-in class they derive from)."""
    with pytest.raises(Exception) as want:
        REFUSALS[name](jht)
    builtin = next(c for c in want.type.__mro__ if c.__module__ == "builtins")
    with pytest.raises(builtin) as got:
        REFUSALS[name](ht)
    assert got.type.__name__ == want.type.__name__, (got.type, want.type)


# --------------------------------------------------------------------- #
# across ranks: the test run's 4-rank world                             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(worker.FACT_CASES))
def test_four_ranks_match_heat_tpu(ranks, jcomm, name):  # noqa: F811
    """Each case across 4 ranks against heat_tpu on 4 devices: every rank's
    shard is its chunk of heat_tpu's global result (perm and sign exactly),
    with heat_tpu's split, global shape and heat type; a whole result is
    the same on every rank."""
    call, kinds = worker.FACT_CASES[name]
    ref = _outputs(call(jht, {"comm": jcomm}))
    every = _result(ranks, f"fact_{name}")
    assert len(every[0]["parts"]) == len(ref) == len(kinds)
    for i, (w, kind) in enumerate(zip(ref, kinds)):
        want = _numpy(w)
        parts = [res["parts"][i] for res in every]
        split = parts[0]["split"]
        if hasattr(w, "larray"):
            assert (split, tuple(parts[0]["gshape"]), parts[0]["dtype"]) == (w.split, want.shape, w.dtype.__name__), (
                name, i, split, parts[0]["gshape"], parts[0]["dtype"], w.split, w.dtype)
        if split is None:
            for part in parts[1:]:
                np.testing.assert_array_equal(part["local"], parts[0]["local"], err_msg=f"{name}[{i}] across ranks")
            got = parts[0]["local"]
        else:
            for r, part in enumerate(parts):
                assert part["local"].shape == jcomm.chunk(want.shape, split, rank=r)[1], (name, i, r)
            got = np.concatenate([part["local"] for part in parts], axis=split)
        _held(kind, got, want, _tol_name(w, want), f"{name}[{i}]")


def _operand_size(name: str) -> int:
    for tag, size in (("37x6", 222), ("6x37", 222), ("5x3", 15), ("_5_", 25), ("_7_", 49)):
        if tag in name:
            return size
    return 37 * 37


def _fact_counts(name: str, it: int, reads: int):
    """The collectives a rank issues in a case, from the docstrings (p = 4):
    polar one all-gather and an all-reduce a Newton–Schulz step plus one;
    cholesky p all-gathers; lu p all-gathers and p − 1 broadcasts; the block
    solves 2(p − 1) (Cholesky's backward sweep all-gathers); det one
    all-reduce more; eigh one all-gather of the diagonal, polar's, two
    TSQRs and two products with Q gathered a branch, the trace and QᴴAQ;
    cg and lanczos from their step counts; each resplit one all-to-all.
    None where the count follows the data further (eigh's recursion)."""
    p = WORLD
    moved = int(name.endswith("_1"))  # a split-1 operand is resplit
    lu = {"all-gather": p, "broadcast": p - 1}
    if name.endswith("_None") or "_None_None_3" in name:  # whole operands
        return {}
    if "recursive" in name:
        return None
    if name.startswith("polar"):
        base = {"all-gather": 1, "all-reduce": it + 1}
        moved = int(name == "polar_37x6_1")
    elif name.startswith("chol"):
        base = {"all-gather": p}
    elif name.startswith("lu"):
        base = dict(lu)
    elif name.startswith("solve_pos"):
        base = {"all-gather": 2 * p - 1, "broadcast": p - 1}
        moved = 2 * ("_1_1_" in name)  # A and b split 1
    elif name.startswith("solve_gen"):
        base = {"all-gather": p, "broadcast": 3 * (p - 1)}
        moved = 2 * ("_1_1_" in name)
    elif name.startswith("inv"):
        base = {"all-gather": p, "broadcast": 3 * (p - 1)}
        moved *= 2  # and the inverse resplit back to split 1
    elif name.startswith("det"):
        base = {**lu, "all-reduce": 1}
    elif name.startswith("eigh"):
        base = {"all-gather": 10, "all-reduce": it + 4}
        moved += 1  # the Hermitian fill's resplit of the strict triangle
    elif name == "svd_polar_37x6_0":
        base = {"all-gather": 1, "all-reduce": it + 1}
    elif name == "svdvals_polar_37x6_0":
        base = {"all-reduce": 1}
    elif name.startswith("svd"):
        base = {"all-gather": 1}
        moved = int(name == "svd_37x6_1")
    elif name.startswith("cg"):
        steps = reads - 1  # the stop test is read before each step and once when it fails
        base = {"all-gather": steps + 1 + (name == "cg_37_None_float64"), "all-reduce": 2 * steps + 1}
    elif name.startswith("lanczos"):
        m = reads + 1  # one breakdown test a step after the first
        base = {"all-gather": m, "all-reduce": 1 + 4 * (m - 1) + (name == "lanczos_seeded")}
    return {**base, **({"all-to-all": moved} if moved else {})}


@pytest.mark.parametrize("name", sorted(worker.FACT_CASES))
def test_collectives_across_four_ranks(ranks, name):  # noqa: F811
    """Each call issues the collectives its docstring names, the same on
    every rank, and no all-gather moves as many elements as the operand;
    eigh's stop tests are read once a Newton–Schulz step and once for the
    projector's rank, polar's once a step, cg's float64 stop test is met
    before n steps."""
    every = _result(ranks, f"fact_{name}")
    res = every[0]
    for other in every[1:]:
        assert (other["counts"], other["reads"]) == (res["counts"], res["reads"]), name
    want = _fact_counts(name, res["iterations"], res["reads"])
    if want is not None:
        assert res["counts"] == want, (name, res["counts"], want)
    if res["counts"]:
        assert res["gathered"] < _operand_size(name), (name, res["gathered"])
    if name.startswith(("polar", "svd_polar")):
        assert res["reads"] == res["iterations"] <= 64
    if name.startswith("eigh") and "recursive" not in name and "None" not in name:
        assert res["reads"] == res["iterations"] + 1
    if name.startswith("cg") and "float64" in name:
        assert res["reads"] - 1 < 37


@pytest.mark.parametrize("assume", ["gen", "pos"])
def test_whole_a_against_a_split_b_across_ranks(ranks, assume):  # noqa: F811
    """A whole A with b split 0 across ranks: A is taken split 0 (each rank
    its rows, no collective) and solved blocked, against NumPy within 1e-4
    (heat_tpu's shard_map refuses 37 rows over 4 devices: ROADMAP "Not
    faults")."""
    a = worker.fact_matrix("gen" if assume == "gen" else "spd", (37, 37), seed=36)
    b = worker.fact_matrix("tall", (37, 3), seed=37)
    want = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    every = _result(ranks, f"fact_solve_whole_{assume}")
    got = np.concatenate([res["parts"][0]["local"] for res in every])
    assert every[0]["parts"][0]["split"] == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert every[0]["counts"] == ({"all-gather": 4, "broadcast": 9} if assume == "gen"
                                  else {"all-gather": 7, "broadcast": 3})


SINGULAR = {
    "ones_4": np.ones((4, 4), np.float32),
    "rank2_3": np.array([[1, 2, 3], [2, 4, 6], [1, 0, 1]], np.float32),
    "zero_column_5": np.where(np.arange(5) == 2, 0.0, worker.fact_matrix("gen", (5, 5), "float64", 42)),
}


@pytest.mark.parametrize("name", sorted(SINGULAR))
def test_singular_lu_at_world_size_one_matches_heat_tpu(name):
    """``lu`` of a singular matrix returns its factors, as ``heat_tpu``'s
    ``lax.linalg.lu`` does: perm exactly, L and U within the float
    tolerance (a zero pivot raised before ``lu_factor_ex``)."""
    a = SINGULAR[name]
    want = jht.linalg.lu(jht.array(a, comm=_j1()))
    got = ht.linalg.lu(ht.array(a))
    for i, (g, w, kind) in enumerate(zip(got, want, ("exact", "f", "f"))):
        _held(kind, _numpy(g), _numpy(w), str(a.dtype), f"{name}[{i}]")


@pytest.mark.parametrize("name", ["fact_singular_det_0", "fact_singular_det_1", "fact_reversal_det_0"])
def test_singular_det_across_ranks_is_numpys(ranks, name):  # noqa: F811
    """``det`` across 4 ranks where the blocked LU meets a zero pivot (a
    singular 8 × 8, split 0 or 1; the row reversal, whose panel blocks are
    singular under pivoting within each rank's rows): every rank gathers
    and takes the determinant of the whole, NumPy's 0.0 and 1.0 (heat_tpu
    gives NaN: ROADMAP "Not faults")."""
    a = np.eye(8)[::-1] if name.startswith("fact_reversal") else np.ones((8, 8))
    for res in _result(ranks, name):
        assert float(res["parts"][0]["local"]) == np.linalg.det(a)
        assert res["counts"].get("all-gather", 0) > 0


def test_singular_lu_across_ranks_returns_heat_tpus_factors(ranks, jcomm):  # noqa: F811
    """``lu`` of a singular split-0 matrix across 4 ranks: no rank raises,
    and the factors are heat_tpu's on 4 devices (its blocked program meets
    the zero pivots too: NaN where it has NaN, its values elsewhere)."""
    want = [_numpy(w) for w in jht.linalg.lu(jht.array(np.ones((8, 8), np.float32), split=0, comm=jcomm))]
    every = _result(ranks, "fact_singular_lu_0")
    for i, w in enumerate(want):
        got = np.concatenate([res["parts"][i]["local"] for res in every])
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-6, equal_nan=True, err_msg=f"lu[{i}]")


@pytest.mark.parametrize("name", ["fact_singular_inv_0", "fact_singular_solve_0"])
def test_singular_inv_and_solve_raise_on_every_rank(ranks, name):  # noqa: F811
    """``inv`` and ``solve`` of a singular split matrix raise torch's
    ``LinAlgError`` on every rank together (ROADMAP "Not faults")."""
    for r in range(WORLD):
        res = ranks[r][name]
        assert isinstance(res, dict) and res.get("error", ("",))[0] == "_LinAlgError", res


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_collectives_take_a_one_element_strided_view(dtype):
    """The real part of a complex diagonal with one element (eigh's shift
    on a rank that holds one row) keeps its stride through ``contiguous``:
    the communicator's byte view copies it instead of raising."""
    x = torch.arange(7.0).reshape(1, 7).to(dtype)
    t = torch.real(torch.diagonal(x, offset=6))
    assert t.stride(0) != 1
    comm = ht.get_comm()
    assert comm.allgather(t).tolist() == comm.bcast(t).tolist() == [6.0]
