"""heat_tpu_torch's linear algebra basics and QR against heat_tpu's, at
world size 1 (the 4-rank cases are in test_torch_hsvd_dist.py).

The same numpy inputs, made from a seed, go through both packages. Values
agree within 1e-5 relative (float32) or 1e-10 (float64); the result's
split and dtype equal heat_tpu's. heat_tpu's split operands lie on the
8-device CPU mesh of conftest.py, the port's on one rank: the split rules
are the same at every mesh width. R of a QR is compared up to the signs of
its rows (each column of Q may flip with its row of R), and Q·R against A.
"""

import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht

SPLITS = (None, 0, 1)
PAIRS = [(sa, sb) for sa in SPLITS for sb in SPLITS]
TOL = {np.float32: 1e-5, np.float64: 1e-10}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")


def _data(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _close(port, ref, dtype=np.float32, scale=None):
    """Values, split and dtype of a port result against heat_tpu's."""
    got, want = port.numpy(), ref.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert port.split == ref.split, (port.split, ref.split)
    assert port.dtype.__name__ == ref.dtype.__name__, (port.dtype, ref.dtype)
    tol = TOL[np.dtype(dtype).type if np.dtype(dtype).kind != "c" else np.dtype(dtype).type(0).real.dtype.type]
    s = scale if scale is not None else max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * s)


# --------------------------------------------------------------------- #
# matmul                                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("sa, sb", PAIRS)
@pytest.mark.parametrize("shapes", [((16, 12), (12, 10)), ((13, 7), (7, 5)), ((5, 30), (30, 3))])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matmul_over_every_split_pair(sa, sb, shapes, dtype):
    a, b = _data(shapes[0], dtype, 1), _data(shapes[1], dtype, 2)
    ref = jht.matmul(jht.array(a, split=sa), jht.array(b, split=sb))
    got = ht.matmul(ht.array(a, split=sa), ht.array(b, split=sb))
    _close(got, ref, dtype, scale=float(np.abs(a).sum(1).max() * np.abs(b).max()))
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=TOL[dtype], atol=TOL[dtype] * 10)


@pytest.mark.parametrize("case", ["vec_mat", "mat_vec", "batched", "int", "complex", "operator"])
def test_matmul_other_operands(case):
    if case == "vec_mat":
        a, b, sa, sb = _data((7,)), _data((7, 4), seed=1), 0, None
    elif case == "mat_vec":
        a, b, sa, sb = _data((5, 7)), _data((7,), seed=1), 0, None
    elif case == "batched":
        a, b, sa, sb = _data((3, 5, 7)), _data((3, 7, 4), seed=1), 0, None
    elif case == "int":
        a, b, sa, sb = (_data((6, 5)) * 10).astype(np.int32), (_data((5, 4), seed=1) * 10).astype(np.int32), 1, 0
    elif case == "complex":
        a, b, sa, sb = _data((6, 5), np.complex64), _data((5, 4), np.complex64, 1), 0, 1
    else:
        a, b, sa, sb = _data((6, 5)), _data((5, 4), seed=1), 1, 1
    if case == "operator":
        ref, got = jht.array(a, split=sa) @ jht.array(b, split=sb), ht.array(a, split=sa) @ ht.array(b, split=sb)
    else:
        ref = jht.matmul(jht.array(a, split=sa), jht.array(b, split=sb))
        got = ht.matmul(ht.array(a, split=sa), ht.array(b, split=sb))
    _close(got, ref, a.dtype if a.dtype.kind != "i" else np.float64, scale=10.0 if case == "int" else None)


# --------------------------------------------------------------------- #
# products of vectors                                                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("sa, sb", [(0, 0), (None, 0), (0, None), (None, None)])
@pytest.mark.parametrize("fn", ["dot", "outer", "vdot", "projection"])
def test_vector_products(fn, sa, sb):
    x, y = _data((20,), seed=3), _data((20,), seed=4)
    ref = getattr(jht, fn)(jht.array(x, split=sa), jht.array(y, split=sb))
    got = getattr(ht, fn)(ht.array(x, split=sa), ht.array(y, split=sb))
    _close(got, ref, scale=20.0)


def test_dot_of_matrices_is_matmul_and_fills_out():
    a, b = _data((6, 5)), _data((5, 4), seed=1)
    _close(ht.dot(ht.array(a, split=0), ht.array(b)), jht.dot(jht.array(a, split=0), jht.array(b)))
    out = ht.array(np.zeros((), np.float32))
    ht.dot(ht.array(a[0]), ht.array(b[:, 0]), out=out)
    np.testing.assert_allclose(out.numpy(), a[0] @ b[:, 0], rtol=1e-5)
    with pytest.raises(NotImplementedError):
        ht.dot(ht.array(_data((2, 3, 4))), ht.array(_data((4,))))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis, keep", [(-1, False), (0, False), (1, True)])
def test_vecdot(split, axis, keep):
    x, y = _data((6, 5), np.complex64, 5), _data((6, 5), np.complex64, 6)
    ref = jht.vecdot(jht.array(x, split=split), jht.array(y, split=split), axis=axis, keepdims=keep)
    got = ht.vecdot(ht.array(x, split=split), ht.array(y, split=split), axis=axis, keepdims=keep)
    _close(got, ref, np.complex64, scale=10.0)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("ncomp", [3, 2])
def test_cross(split, ncomp):
    a, b = _data((6, ncomp), seed=7), _data((6, ncomp), seed=8)
    if split == 1 and ncomp == 2:
        split = None
    ref = jht.cross(jht.array(a, split=split), jht.array(b, split=split))
    got = ht.cross(ht.array(a, split=split), ht.array(b, split=split))
    _close(got, ref)


# --------------------------------------------------------------------- #
# square matrices                                                       #
# --------------------------------------------------------------------- #
def _spd(n, seed=9):
    m = _data((n, n), np.float64, seed)
    return m @ m.T + n * np.eye(n)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("fn", ["inv", "det", "trace"])
def test_inv_det_trace(fn, split):
    m = _spd(6)
    _close(getattr(ht, fn)(ht.array(m, split=split)), getattr(jht, fn)(jht.array(m, split=split)), np.float64)


@pytest.mark.parametrize("split", [None, 0, 1, 2])
@pytest.mark.parametrize("offset", [0, 1, -2])
def test_trace_of_batches_and_offsets(split, offset):
    m = _data((3, 5, 4), np.float64, 10)
    kw = dict(offset=offset, axis1=1, axis2=2)
    _close(ht.trace(ht.array(m, split=split), **kw), jht.trace(jht.array(m, split=split), **kw), np.float64)


@pytest.mark.parametrize("split", [None, 0])
def test_batched_inv_det(split):
    m = np.stack([_spd(4, s) for s in range(3)])
    for fn in ("inv", "det"):
        _close(getattr(ht, fn)(ht.array(m, split=split)), getattr(jht, fn)(jht.array(m, split=split)), np.float64)


def test_square_checks():
    for fn in (ht.inv, ht.det):
        with pytest.raises(ValueError):
            fn(ht.array(_data((3, 4))))
    with pytest.raises(ValueError):
        ht.trace(ht.array(_data((3,))))


# --------------------------------------------------------------------- #
# norms                                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", SPLITS)
def test_norm_of_every_element(split):
    a = _data((8, 6))
    _close(ht.norm(ht.array(a, split=split)), jht.norm(jht.array(a, split=split)))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [0, 1, None])
@pytest.mark.parametrize("ord_", [2, 1, np.inf, -np.inf, 0, 3])
def test_vector_norm(split, axis, ord_):
    a = _data((8, 6), seed=11)
    a[2, 3] = 0.0
    ref = jht.vector_norm(jht.array(a, split=split), axis=axis, ord=ord_)
    got = ht.vector_norm(ht.array(a, split=split), axis=axis, ord=ord_)
    _close(got, ref)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("ord_", ["fro", "nuc", 1, -1, np.inf, -np.inf, 2, -2])
def test_matrix_norm(split, ord_):
    a = _data((8, 6), np.float64, 12)
    _close(ht.matrix_norm(ht.array(a, split=split), ord=ord_), jht.matrix_norm(jht.array(a, split=split), ord=ord_),
           np.float64)


@pytest.mark.parametrize("split", [None, 0, 1, 2])
def test_norm_dispatch_and_keepdims(split):
    a = _data((3, 8, 6), seed=13)
    for kw in (dict(dim=(1, 2)), dict(dim=1, keepdim=True), dict(axis=(0, 2), keepdims=True), dict(dim=-1, ord=1)):
        _close(ht.norm(ht.array(a, split=split), **kw), jht.norm(jht.array(a, split=split), **kw))
    b = _data((8, 6), seed=14)
    _close(ht.norm(ht.array(b, split=min(split or 0, 1)), ord=1), jht.norm(jht.array(b, split=min(split or 0, 1)), ord=1))


def test_vector_norm_of_integers_is_float32():
    a = (np.arange(12).reshape(3, 4) - 5).astype(np.int32)
    _close(ht.vector_norm(ht.array(a, split=0), axis=1), jht.vector_norm(jht.array(a, split=0), axis=1))


# --------------------------------------------------------------------- #
# transpose, tril, triu                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", SPLITS)
def test_transpose_and_T(split):
    a = _data((5, 7))
    for got, ref in ((ht.array(a, split=split).T, jht.array(a, split=split).T),
                     (ht.transpose(ht.array(a, split=split)), jht.transpose(jht.array(a, split=split)))):
        _close(got, ref)
        assert got.split == (None if split is None else 1 - split)
    b = _data((2, 3, 4))
    axes = (1, 2, 0)
    for s in (None, 0, 1, 2):
        _close(ht.transpose(ht.array(b, split=s), axes), jht.transpose(jht.array(b, split=s), axes))
    with pytest.raises(ValueError):
        ht.transpose(ht.array(b), (0, 0, 1))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("k", [0, 1, -2, 4])
@pytest.mark.parametrize("fn", ["tril", "triu"])
def test_tril_triu(fn, split, k):
    a = _data((5, 7))
    _close(getattr(ht, fn)(ht.array(a, split=split), k), getattr(jht, fn)(jht.array(a, split=split), k))
    v = _data((6,))
    s = None if split is None else 0
    _close(getattr(ht, fn)(ht.array(v, split=s), k), getattr(jht, fn)(jht.array(v, split=s), k))


# --------------------------------------------------------------------- #
# QR                                                                    #
# --------------------------------------------------------------------- #
def _check_qr(a, split, dtype=np.float32):
    tol = 1e-4 if dtype in (np.float32, np.complex64) else 1e-10
    q, r = ht.linalg.qr(ht.array(a, split=split))
    jq, jr = jht.linalg.qr(jht.array(a, split=split))
    assert (q.split, r.split) == (jq.split, jr.split)
    assert (q.shape, r.shape) == (jq.shape, jr.shape)
    qn, rn, jrn = q.numpy(), r.numpy(), jr.numpy()
    np.testing.assert_allclose(qn @ rn, a, atol=tol * np.abs(a).max() * 10)
    np.testing.assert_allclose(qn.conj().T @ qn, np.eye(qn.shape[1]), atol=tol)
    np.testing.assert_allclose(np.tril(rn, -1), 0, atol=0)
    sign = np.sign(np.real(np.diag(rn) * np.conj(np.diag(jrn))))
    sign[sign == 0] = 1
    np.testing.assert_allclose(rn * sign[:, None], jrn, atol=tol * np.abs(a).max() * 10)


@pytest.mark.parametrize("shape", [(64, 8), (50, 7), (9, 3), (20, 12)])
@pytest.mark.parametrize("split", SPLITS)
def test_qr(shape, split):
    _check_qr(_data(shape, seed=15), split)


@pytest.mark.parametrize("split", SPLITS)
def test_qr_float64_and_complex(split):
    _check_qr(_data((30, 6), np.float64, 16), split, np.float64)
    _check_qr(_data((30, 6), np.complex64, 17), split, np.complex64)


@pytest.mark.parametrize("split", SPLITS)
def test_qr_without_q(split):
    a = _data((40, 6), seed=18)
    q, r = ht.linalg.qr(ht.array(a, split=split), calc_q=False)
    jq, jr = jht.linalg.qr(jht.array(a, split=split), calc_q=False)
    assert q is None and jq is None and r.split == jr.split
    np.testing.assert_allclose(np.abs(r.numpy()), np.abs(jr.numpy()), atol=1e-4)


def test_qr_checks_its_arguments():
    x = ht.array(_data((8, 3)))
    with pytest.raises(TypeError):
        ht.linalg.qr(x, calc_q=1)
    with pytest.raises(TypeError):
        ht.linalg.qr(x, tiles_per_proc=1.0)
    with pytest.raises(TypeError):
        ht.linalg.qr(x, overwrite_a=0)
    with pytest.raises(ValueError):
        ht.linalg.qr(ht.array(_data((2, 3, 4))))
    with pytest.warns(UserWarning, match="tiles_per_proc"):
        ht.linalg.qr(x, tiles_per_proc=2)


def test_tsqr_group_size_matches_heat_tpu():
    import importlib

    jqr = importlib.import_module("heat_tpu.core.linalg.qr")
    pqr = importlib.import_module("heat_tpu_torch.core.linalg.qr")
    for p in (1, 2, 4, 7, 16, 36, 64, 97):
        assert pqr._tsqr_group_size(p) == jqr._tsqr_group_size(p)
        assert pqr._tsqr_grouping(p) == jqr._tsqr_grouping(p)
