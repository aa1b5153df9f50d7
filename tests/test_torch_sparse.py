"""heat_tpu_torch.sparse (DCSR and DBCSR matrices) against heat_tpu at
world size 1.

Both packages get the same numpy/scipy input; heat_tpu runs on its forced
CPU mesh, the port on the CPU. What is integer or copied is compared
exactly: CSR patterns and values of the factories, the union and
intersection patterns of ``add``/``mul`` and their values (the same
single operation per entry), dense round trips, and the DBCSR components,
which must equal heat_tpu's ``split=None`` layout bit for bit. Products
sum in other orders: ``@`` and ``sddmm`` agree with heat_tpu within
rtol 1e-5 / atol 1e-5 for float32 data of unit scale (about 80 ulps of
the largest partial sums over ≤ 1024 terms), 1e-12 for float64, and 2e-2
for bfloat16 results, whose last bit (2^-8 relative) may round the other
way from a float32 sum that differs in its last ulps.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu_torch.core import interop
from heat_tpu_torch.sparse import dbcsr_matrix as tdb
from heat_tpu.sparse import dbcsr_matrix as jdb


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])  # heat_tpu turns x64 on for the CPU with its first array


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(jax.device_get(a))
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _ref_matrix(seed=0, m=9, n=7, density=0.3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((m, n)).astype(dtype)
    dense[rng.random((m, n)) > density] = 0
    return sp.csr_matrix(dense)


def _rand_csr(m, n, nnz, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    csr = sp.csr_matrix(
        (rng.standard_normal(nnz).astype(dtype), (rng.integers(0, m, nnz), rng.integers(0, n, nnz))), shape=(m, n)
    )
    csr.sum_duplicates()
    return csr


def _same_csr(t, j):
    assert t.shape == j.shape and t.nnz == j.nnz and t.split == j.split
    assert t.dtype.__name__ == j.dtype.__name__
    np.testing.assert_array_equal(_np(t.indptr), _np(j.indptr))
    np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
    np.testing.assert_array_equal(_np(t.data), _np(j.data))


# --------------------------------------------------------------------- #
# DCSR: factories and properties                                        #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [0, None])
def test_dcsr_from_scipy_matches(split):
    ref = _ref_matrix()
    _same_csr(ht.sparse.sparse_csr_matrix(ref, split=split), jht.sparse.sparse_csr_matrix(ref, split=split))


def test_dcsr_from_torch_sparse_csr_and_dense_and_dndarray():
    ref = _ref_matrix(seed=1)
    t = torch.sparse_csr_tensor(
        torch.tensor(ref.indptr, dtype=torch.int64), torch.tensor(ref.indices, dtype=torch.int64),
        torch.tensor(ref.data), size=ref.shape,
    )
    _same_csr(ht.sparse.sparse_csr_matrix(t, split=0), jht.sparse.sparse_csr_matrix(ref, split=0))
    dense = [[1.0, 0.0, 2.0], [0.0, 0.0, 0.0], [0.0, 3.0, 0.0]]
    _same_csr(ht.sparse.sparse_csr_matrix(dense), jht.sparse.sparse_csr_matrix(dense))
    arr = ref.toarray()
    _same_csr(ht.sparse.sparse_csr_matrix(ht.array(arr, split=0), split=0),
              jht.sparse.sparse_csr_matrix(jht.array(arr, split=0), split=0))


def test_dcsr_is_split_stitches_blocks():
    ref = _ref_matrix(seed=2, m=8)
    blocks = [ref[:3], ref[3:5], ref[5:]]
    got = ht.sparse.sparse_csr_matrix(blocks, is_split=0)
    assert got.split == 0
    _same_csr(got, jht.sparse.sparse_csr_matrix(blocks, is_split=0))


@pytest.mark.parametrize("kwargs", [dict(split=1), dict(is_split=1), dict(split=0, is_split=0)])
def test_dcsr_invalid_split_raises(kwargs):
    for pkg in (ht, jht):
        with pytest.raises(ValueError):
            pkg.sparse.sparse_csr_matrix(_ref_matrix(), **kwargs)


def test_dcsr_dtype_override_astype_and_properties():
    ref = _ref_matrix(seed=3, m=16)
    got = ht.sparse.sparse_csr_matrix(ref, dtype=ht.float64, split=0)
    _same_csr(got, jht.sparse.sparse_csr_matrix(ref, dtype=jht.float64, split=0))
    s = ht.sparse.sparse_csr_matrix(ref, split=0)
    d = s.astype(ht.float64)
    assert d.dtype is ht.float64 and d.data.dtype == torch.float64
    np.testing.assert_array_equal(_np(d.data), ref.data.astype(np.float64))
    # at world size 1 the local views are the whole matrix
    np.testing.assert_array_equal(_np(s.lindptr), ref.indptr)
    np.testing.assert_array_equal(_np(s.lindices), ref.indices)
    np.testing.assert_array_equal(_np(s.ldata), ref.data)
    assert s.lnnz == s.gnnz == ref.nnz and s.lshape == ref.shape and s.ndim == 2
    np.testing.assert_array_equal(s.global_indptr().numpy(), ref.indptr)
    assert s.counts_displs_nnz() == ((ref.nnz,), (0,))
    assert not s.is_distributed() and s.balanced
    assert s.component_nbytes == 4 * (len(ref.indptr) + 2 * ref.nnz)
    with pytest.raises(ValueError):
        ht.sparse.sparse_csr_matrix(ref).global_indptr()
    with pytest.raises(ValueError):
        ht.sparse.sparse_csr_matrix(ref).counts_displs_nnz()
    assert "indptr" in repr(s)


# --------------------------------------------------------------------- #
# DCSR: arithmetic (patterns and values exact)                          #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("op", ["add", "mul"])
@pytest.mark.parametrize("seeds", [(6, 7), (8, 8), (9, 10)])
def test_add_mul_patterns_match(op, seeds):
    a, b = _ref_matrix(seed=seeds[0], m=11, n=13, density=0.4), _ref_matrix(seed=seeds[1], m=11, n=13, density=0.4)
    got = getattr(ht.sparse, op)(ht.sparse.sparse_csr_matrix(a, split=0), ht.sparse.sparse_csr_matrix(b))
    ref = getattr(jht.sparse, op)(jht.sparse.sparse_csr_matrix(a, split=0), jht.sparse.sparse_csr_matrix(b))
    _same_csr(got, ref)
    scipy_ref = (a + b) if op == "add" else a.multiply(b)
    np.testing.assert_allclose(got.todense().numpy(), scipy_ref.toarray())


def test_dunders_scalar_mul_and_promotion():
    a = _ref_matrix(seed=11)
    ta, ja = ht.sparse.sparse_csr_matrix(a), jht.sparse.sparse_csr_matrix(a)
    _same_csr(ta + ta, ja + ja)
    _same_csr(ta * ta, ja * ja)
    _same_csr(ta * 2.5, ja * 2.5)
    _same_csr(3.0 * ta, 3.0 * ja)
    ints = sp.csr_matrix(np.array([[1, 0, 2], [0, 3, 0]], dtype=np.int32))
    ti, ji = ht.sparse.sparse_csr_matrix(ints), jht.sparse.sparse_csr_matrix(ints)
    _same_csr(ti * 0.5, ji * 0.5)
    assert (ti * 0.5).dtype is ht.float32
    a64 = _ref_matrix(seed=12, dtype=np.float64)
    t64, j64 = ht.sparse.sparse_csr_matrix(a64), jht.sparse.sparse_csr_matrix(a64)
    _same_csr(ta + t64, ja + j64)
    assert (ta + t64).dtype is ht.float64


def test_arithmetic_errors_match():
    a = _ref_matrix(seed=13)
    for pkg in (ht, jht):
        s = pkg.sparse.sparse_csr_matrix(a)
        with pytest.raises(TypeError):
            pkg.sparse.add(s, 1.0)
        with pytest.raises(TypeError):
            pkg.sparse.add(s, np.ones(a.shape))
        with pytest.raises(ValueError):
            pkg.sparse.add(s, pkg.sparse.sparse_csr_matrix(_ref_matrix(seed=1, m=4)))


def test_empty_operands_and_huge_column_space():
    empty = sp.csr_matrix((9, 7), dtype=np.float32)
    a = _ref_matrix(seed=14)
    for op in ("add", "mul"):
        _same_csr(
            getattr(ht.sparse, op)(ht.sparse.sparse_csr_matrix(empty), ht.sparse.sparse_csr_matrix(a)),
            getattr(jht.sparse, op)(jht.sparse.sparse_csr_matrix(empty), jht.sparse.sparse_csr_matrix(a)),
        )
    # m * ncols past int32: the linearized keys go to int64
    m, n = 70_000, 40_000
    rows, cols = np.array([3, 69_999, 69_999]), np.array([39_999, 0, 39_998])
    x = sp.csr_matrix((np.array([1.0, 2.0, 3.0], np.float32), (rows, cols)), shape=(m, n))
    y = sp.csr_matrix((np.array([5.0, 7.0], np.float32), (rows[1:], cols[1:])), shape=(m, n))
    for op in ("add", "mul"):
        _same_csr(
            getattr(ht.sparse, op)(ht.sparse.sparse_csr_matrix(x), ht.sparse.sparse_csr_matrix(y)),
            getattr(jht.sparse, op)(jht.sparse.sparse_csr_matrix(x), jht.sparse.sparse_csr_matrix(y)),
        )


# --------------------------------------------------------------------- #
# DCSR: manipulations and matmul                                        #
# --------------------------------------------------------------------- #
def test_to_dense_to_sparse_round_trip():
    ref = _ref_matrix(seed=15, m=12, n=10)
    s = ht.sparse.sparse_csr_matrix(ref, split=0)
    d = s.todense()
    np.testing.assert_array_equal(d.numpy(), jht.sparse.sparse_csr_matrix(ref, split=0).todense().numpy())
    assert d.split == 0 and d.dtype is ht.float32
    back = ht.sparse.to_sparse(ht.array(ref.toarray(), split=0))
    _same_csr(back, jht.sparse.to_sparse(jht.array(ref.toarray(), split=0)))
    _same_csr(ht.array(ref.toarray()).to_sparse(), jht.array(ref.toarray()).to_sparse())
    out = ht.zeros((12, 10), dtype=ht.float64, split=0)
    assert ht.sparse.to_dense(s, out=out) is out
    np.testing.assert_array_equal(out.numpy(), ref.toarray().astype(np.float64))
    for bad in (ht.zeros((12, 11), split=0), ht.zeros((12, 10), split=None)):
        with pytest.raises(ValueError):
            ht.sparse.to_dense(s, out=bad)
    with pytest.raises(ValueError):
        ht.sparse.to_sparse(ht.zeros((2, 2, 2)))
    empty = ht.sparse.sparse_csr_matrix(sp.csr_matrix((3, 4), dtype=np.float32))
    np.testing.assert_array_equal(empty.todense().numpy(), np.zeros((3, 4), np.float32))


@pytest.mark.parametrize("k", [None, 1, 5])
@pytest.mark.parametrize("split", [0, None])
def test_dcsr_matmul_matches(split, k):
    csr = _rand_csr(90, 260, 700, seed=7)
    x = np.random.default_rng(8).standard_normal((260,) if k is None else (260, k)).astype(np.float32)
    got = ht.sparse.sparse_csr_matrix(csr, split=split) @ x
    ref = jht.sparse.sparse_csr_matrix(csr, split=split) @ x
    assert got.shape == ref.shape and got.split == ref.split and got.dtype is ht.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_dcsr_matmul_operand_forms_dtypes_and_zero():
    csr = _rand_csr(40, 30, 200, seed=9)
    x = np.random.default_rng(10).standard_normal((30, 3)).astype(np.float32)
    A, J = ht.sparse.sparse_csr_matrix(csr), jht.sparse.sparse_csr_matrix(csr)
    ref = (J @ x).numpy()
    for operand in (x, torch.from_numpy(x), ht.array(x, split=0)):
        np.testing.assert_allclose((A @ operand).numpy(), ref, rtol=1e-5, atol=1e-5)
    x64 = x.astype(np.float64)
    got = A @ x64
    assert got.dtype is ht.float64
    np.testing.assert_allclose(got.numpy(), (J @ x64).numpy(), rtol=1e-12, atol=1e-12)
    Ab, Jb = A.astype(ht.bfloat16), J.astype(jht.bfloat16)
    got = Ab @ torch.from_numpy(x).bfloat16()
    assert got.dtype is ht.bfloat16
    np.testing.assert_allclose(got.numpy(), _np((Jb @ jax.numpy.asarray(x, jax.numpy.bfloat16)).larray),
                               rtol=2e-2, atol=2e-2)
    Z = ht.sparse.sparse_csr_matrix(sp.csr_matrix((40, 30), dtype=np.float32))
    np.testing.assert_array_equal((Z @ x).numpy(), np.zeros((40, 3), np.float32))


# --------------------------------------------------------------------- #
# DBCSR: components bit for bit                                         #
# --------------------------------------------------------------------- #
DBCSR_SHAPES = [(100, 300, 400), (1003, 777, 3000), (5, 7, 6), (8, 128, 50), (64, 1, 20), (1, 500, 30)]


def _components(A):
    bdata, bcol, brow, bmask = A._phys_components
    return {
        "bdata": _np(bdata), "bcol": _np(bcol), "brow": _np(brow), "bmask": _np(bmask),
        "slab_meta": A._slab_meta, "gnnz": A.gnnz, "nbricks": A.nbricks, "gshape": A.gshape,
        "dtype": A.dtype.__name__,
    }


def _assert_components_equal(got, ref):
    for key in ("bdata", "bcol", "brow", "bmask"):
        g, r = got[key], ref[key]
        assert g.dtype == r.dtype and g.shape == r.shape, key
        np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8), err_msg=key)
    for key in ("slab_meta", "gnnz", "nbricks", "gshape", "dtype"):
        assert got[key] == ref[key], key


@pytest.mark.parametrize("split", [0, None])
@pytest.mark.parametrize("shape", DBCSR_SHAPES, ids=[f"{m}x{n}" for m, n, _ in DBCSR_SHAPES])
def test_dbcsr_components_bit_identical(shape, split):
    m, n, nnz = shape
    csr = _rand_csr(m, n, nnz, seed=m + n)
    got = ht.sparse.sparse_dbcsr_matrix(csr, split=split)
    assert got.split == split and got.slab_bricks == max(1, got.nbricks)
    _assert_components_equal(_components(got), _components(jht.sparse.sparse_dbcsr_matrix(csr, split=None)))


@pytest.mark.parametrize("dtype", [np.float64, np.int32, np.int64])
def test_dbcsr_components_bit_identical_other_dtypes(dtype):
    csr = _rand_csr(45, 300, 500, seed=3)
    csr.data = (csr.data * 10).astype(dtype)
    _assert_components_equal(
        _components(ht.sparse.sparse_dbcsr_matrix(csr)), _components(jht.sparse.sparse_dbcsr_matrix(csr))
    )


def test_dbcsr_empty_matrix_is_one_pad_brick():
    csr = sp.csr_matrix((37, 300), dtype=np.float32)
    got = ht.sparse.sparse_dbcsr_matrix(csr)
    _assert_components_equal(_components(got), _components(jht.sparse.sparse_dbcsr_matrix(csr)))
    assert got.slab_bricks == 1 and got.nbricks == 0 and got.occupancy == 0.0
    assert not _np(got._phys_components[3]).any()


def test_dbcsr_metadata_matches():
    csr = _rand_csr(100, 300, 400, seed=1)
    got, ref = ht.sparse.sparse_dbcsr_matrix(csr, split=0), jht.sparse.sparse_dbcsr_matrix(csr, split=None)
    assert (got.mb, got.nb, got.nnz, got.nbricks) == (ref.mb, ref.nb, ref.nnz, ref.nbricks) == (13, 3, csr.nnz,
                                                                                                 ref.nbricks)
    assert got.occupancy == ref.occupancy and got.component_nbytes == ref.component_nbytes
    assert got.ndim == 2 and not got.is_distributed() and ht.sparse.BRICK_SHAPE == (8, 128)
    assert repr(got).replace("split=0", "split=None") == repr(ref)


@pytest.mark.parametrize("p", [1, 2, 3, 5, 8])
def test_slab_layout_matches(p):
    for m in (0, 1, 7, 8, 100, 1003):
        mb = -(-max(m, 1) // 8)
        assert tdb._slab_layout(m, mb, p) == jdb._slab_layout(m, mb, p)


def test_dbcsr_conversions_match():
    csr = _rand_csr(64, 256, 500, seed=2)
    A, J = ht.sparse.sparse_dbcsr_matrix(csr, split=0), jht.sparse.sparse_dbcsr_matrix(csr, split=0)
    np.testing.assert_array_equal(A.todense().numpy(), J.todense().numpy())
    assert A.todense().split == 0
    _same_csr(A.to_dcsr(), J.to_dcsr())
    D = ht.sparse.sparse_csr_matrix(csr, split=0)
    for B in (ht.sparse.to_dbcsr(D), ht.sparse.sparse_dbcsr_matrix(D), ht.sparse.to_dbcsr(ht.array(csr.toarray(),
                                                                                                   split=0))):
        assert B.split == 0
        _assert_components_equal(_components(B), _components(A))
    half = A.astype(ht.bfloat16)
    assert half.dtype is ht.bfloat16 and half._phys_components[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        half.todense().numpy(), J.astype(jht.bfloat16).todense().numpy().astype(np.float32)
    )


def test_dbcsr_raw_constructor_sorts_unsorted_rows_and_refuses_slabs():
    csr = _rand_csr(45, 300, 500, seed=4)
    A = ht.sparse.sparse_dbcsr_matrix(csr)
    bdata, bcol, brow, bmask = A._phys_components
    perm = torch.from_numpy(np.random.default_rng(0).permutation(A.nbricks))
    B = ht.sparse.DBCSR_matrix(bdata[perm], bcol[perm], brow[perm], bmask[perm], A._slab_meta, A.gnnz, A.nbricks,
                               A.shape, A.dtype, None, A.device, A.comm)
    assert bool((B._phys_components[2][1:] >= B._phys_components[2][:-1]).all())
    np.testing.assert_array_equal(B.todense().numpy(), A.todense().numpy())
    x = np.random.default_rng(1).standard_normal((300, 2)).astype(np.float32)
    np.testing.assert_allclose((B @ x).numpy(), (A @ x).numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        ht.sparse.DBCSR_matrix(bdata, bcol, brow, bmask, A._slab_meta * 2, A.gnnz, A.nbricks, A.shape, A.dtype,
                               0, A.device, A.comm)
    with pytest.raises(ValueError):
        ht.sparse.DBCSR_matrix(bdata, bcol[:-1], brow, bmask, A._slab_meta, A.gnnz, A.nbricks, A.shape, A.dtype,
                               0, A.device, A.comm)
    for pkg in (ht, jht):
        with pytest.raises(ValueError):
            pkg.sparse.sparse_dbcsr_matrix(csr, split=1)


# --------------------------------------------------------------------- #
# interop: heat_tpu's split-0 slabs carried across                      #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("m", [100, 8 * 8 + 4, 13])
def test_dbcsr_from_numpy_reassembles_split0_slabs(m):
    csr = _rand_csr(m, 256, 6 * m, seed=m)
    J = jht.sparse.sparse_dbcsr_matrix(csr, split=0)
    comps = _components(J)
    assert len(comps["slab_meta"]) == J.comm.size  # one slab per device of heat_tpu's mesh
    A = interop.dbcsr_from_numpy(comps)
    assert A.split == 0 and A.nbricks == J.nbricks and A.gnnz == J.gnnz
    np.testing.assert_array_equal(A.todense().numpy(), csr.toarray())
    _assert_components_equal(_components(A), _components(ht.sparse.sparse_dbcsr_matrix(csr, split=0)))
    comps["nbricks"] += 1
    with pytest.raises(ValueError):
        interop.dbcsr_from_numpy(comps)


def test_dbcsr_from_numpy_bfloat16_and_dcsr_from_numpy():
    csr = _rand_csr(40, 300, 300, seed=5)
    J = jht.sparse.sparse_dbcsr_matrix(csr, split=None).astype(jht.bfloat16)
    comps = _components(J)
    comps["bdata"] = np.asarray(jax.device_get(J._phys_components[0]))  # ml_dtypes bfloat16
    A = interop.dbcsr_from_numpy(comps)
    assert A.dtype is ht.bfloat16 and A.split is None
    np.testing.assert_array_equal(A.todense().numpy(), J.todense().numpy().astype(np.float32))
    D = jht.sparse.sparse_csr_matrix(csr, split=0)
    got = interop.dcsr_from_numpy(_np(D.indptr), _np(D.indices), _np(D.data), D.shape)
    _same_csr(got, D)


# --------------------------------------------------------------------- #
# DBCSR: @ and sddmm against heat_tpu                                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("k", [None, 1, 3, 16])
@pytest.mark.parametrize("split", [0, None])
def test_dbcsr_matmul_matches(split, k):
    csr = _rand_csr(90, 260, 700, seed=7)
    x = np.random.default_rng(8).standard_normal((260,) if k is None else (260, k)).astype(np.float32)
    got = ht.sparse.sparse_dbcsr_matrix(csr, split=split) @ x
    ref = jht.sparse.sparse_dbcsr_matrix(csr, split=split) @ x
    assert got.shape == ref.shape and got.split == ref.split and got.dtype is ht.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), csr @ x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split", [0, None])
def test_dbcsr_matmul_bf16_float64_and_operand_forms(split):
    csr = _rand_csr(64, 256, 2000, seed=9)
    x = np.random.default_rng(10).standard_normal((256, 4)).astype(np.float32)
    A, J = ht.sparse.sparse_dbcsr_matrix(csr, split=split), jht.sparse.sparse_dbcsr_matrix(csr, split=split)
    got = A.astype(ht.bfloat16) @ x
    ref = J.astype(jht.bfloat16) @ x
    assert got.dtype is ht.float32  # bfloat16 bricks times float32 x
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    got = A.astype(ht.bfloat16) @ torch.from_numpy(x).bfloat16()
    ref = J.astype(jht.bfloat16) @ jax.numpy.asarray(x, jax.numpy.bfloat16)
    assert got.dtype is ht.bfloat16
    np.testing.assert_allclose(got.numpy(), _np(ref.larray), rtol=2e-2, atol=2e-2)
    x64 = x.astype(np.float64)
    got, ref = A.astype(ht.float64) @ x64, J.astype(jht.float64) @ x64
    assert got.dtype is ht.float64
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    for operand in (torch.from_numpy(x), ht.array(x, split=0)):
        np.testing.assert_allclose((A @ operand).numpy(), (J @ x).numpy(), rtol=1e-5, atol=1e-5)


def test_dbcsr_matmul_empty_rows_and_empty_matrix():
    dense = np.zeros((40, 200), np.float32)
    dense[7, 130] = 3.0  # a single brick, most rows empty
    x = np.ones(200, np.float32)
    got = ht.sparse.sparse_dbcsr_matrix(sp.csr_matrix(dense), split=0) @ x
    np.testing.assert_array_equal(got.numpy(), dense @ x)
    E = ht.sparse.sparse_dbcsr_matrix(sp.csr_matrix((37, 300), dtype=np.float32))
    np.testing.assert_array_equal((E @ np.ones((300, 2), np.float32)).numpy(), np.zeros((37, 2), np.float32))
    I = ht.sparse.sparse_dbcsr_matrix(sp.csr_matrix(np.eye(9, dtype=np.int32)))
    got = I @ np.arange(9, dtype=np.int32)
    assert got.dtype is ht.int32
    np.testing.assert_array_equal(got.numpy(), np.arange(9))


@pytest.mark.parametrize("d", [1, 6])
@pytest.mark.parametrize("split", [0, None])
def test_sddmm_matches(split, d):
    csr = _rand_csr(70, 260, 500, seed=15)
    rng = np.random.default_rng(16)
    u, v = rng.standard_normal((70, d)).astype(np.float32), rng.standard_normal((260, d)).astype(np.float32)
    S, J = ht.sparse.sparse_dbcsr_matrix(csr, split=split), jht.sparse.sparse_dbcsr_matrix(csr, split=split)
    C = ht.sparse.sddmm(S, u, v)
    R = jht.sparse.sddmm(J, u, v)
    assert isinstance(C, ht.sparse.DBCSR_matrix) and C.split == split and C.dtype is ht.float32
    assert (C.nnz, C.nbricks, C._slab_meta) == (S.nnz, S.nbricks, S._slab_meta)
    np.testing.assert_allclose(C.todense().numpy(), R.todense().numpy(), rtol=1e-5, atol=1e-5)
    mask = csr.toarray() != 0
    np.testing.assert_allclose(C.todense().numpy() * mask, np.where(mask, csr.toarray() * (u @ v.T), 0),
                               rtol=1e-4, atol=1e-4)


def test_sddmm_bf16_and_float64():
    csr = _rand_csr(70, 260, 500, seed=17)
    rng = np.random.default_rng(18)
    u, v = rng.standard_normal((70, 8)), rng.standard_normal((260, 8))
    S, J = ht.sparse.sparse_dbcsr_matrix(csr), jht.sparse.sparse_dbcsr_matrix(csr)
    C, R = ht.sparse.sddmm(S.astype(ht.float64), u, v), jht.sparse.sddmm(J.astype(jht.float64), u, v)
    assert C.dtype is ht.float64
    np.testing.assert_allclose(C.todense().numpy(), R.todense().numpy(), rtol=1e-12, atol=1e-12)
    u32, v32 = u.astype(np.float32), v.astype(np.float32)
    C = ht.sparse.sddmm(S.astype(ht.bfloat16), torch.from_numpy(u32).bfloat16(), torch.from_numpy(v32).bfloat16())
    R = jht.sparse.sddmm(J.astype(jht.bfloat16), jax.numpy.asarray(u32, jax.numpy.bfloat16),
                         jax.numpy.asarray(v32, jax.numpy.bfloat16))
    assert C.dtype is ht.bfloat16 and C._phys_components[0].dtype == torch.bfloat16
    np.testing.assert_allclose(C.todense().numpy(), R.todense().numpy().astype(np.float32), rtol=2e-2, atol=2e-2)


def test_shape_and_type_errors_match():
    csr = _rand_csr(70, 260, 500, seed=19)
    rng = np.random.default_rng(20)
    u, v = rng.standard_normal((70, 6)).astype(np.float32), rng.standard_normal((260, 6)).astype(np.float32)
    for pkg in (ht, jht):
        S = pkg.sparse.sparse_dbcsr_matrix(csr)
        D = pkg.sparse.sparse_csr_matrix(csr)
        for A in (S, D):
            with pytest.raises(ValueError):
                A @ np.ones(259, np.float32)
            with pytest.raises(ValueError):
                A @ np.ones((260, 2, 2), np.float32)
        with pytest.raises(TypeError):
            pkg.sparse.matmul(np.eye(3), np.ones(3))
        with pytest.raises(ValueError):
            pkg.sparse.sddmm(S, u[:10], v)
        with pytest.raises(ValueError):
            pkg.sparse.sddmm(S, u, v[:, :3])
        with pytest.raises(ValueError):
            pkg.sparse.sddmm(S, u[:, 0], v)
        with pytest.raises(TypeError):
            pkg.sparse.sddmm(np.zeros((3, 3)), u, v)
