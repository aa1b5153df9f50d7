"""heat_tpu_torch's single-device hSVD against heat_tpu's.

Two levels:

- the sketch chains with the operators injected: both sides get the same
  numpy ``g`` / ``Ω``; the heat_tpu side composes its own stream and tail
  functions. Float32, on a full-rank matrix with
  spectrum σ_i = 2^{-i/2}: σ within relative error 1e-4, U and V up to
  column sign within 1e-3, the error estimate within 1e-4 absolute;
- the public ``hsvd_rank`` / ``hsvd_rtol`` / ``hsvd`` on both packages,
  each drawing its own operators, on an exactly rank-8 matrix with
  maxrank 10, where any sketch is exact: σ within relative error 1e-4,
  equal subspaces, error estimate ≤ 1e-4. These run in float64: in
  float32 the estimate ‖A‖² − Σσ² of an exact-rank input cancels to
  about 4e-4 on both packages alike;
- the public calls on a full-rank matrix, each package drawing its own
  operators: the port draws heat_tpu's Threefry stream, so the factors
  agree within the injected chains' tolerances.

heat_tpu arrays with ``split=0`` are distributed over the 8-device CPU
mesh of ``conftest.py`` and take its TSQR-merge branch; the port's
``split=0`` at world size 1 takes the single-device branch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu as jht
import heat_tpu.core.linalg.svdtools as jsvd
import heat_tpu_torch as ht
from heat_tpu_torch.core.linalg import svdtools as psvd

KEEP, SKETCH_L, R_FINAL = 15, 25, 10  # hsvd_rank(A, 10): keep 10+5, l = keep+10
K_HAT, L_ROW = KEEP + 9, 2 * (KEEP + 9) + 1  # the one-view widths of that call


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")


def _matrix(m, n, sigma, seed, dtype):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, len(sigma))))
    v, _ = np.linalg.qr(rng.standard_normal((n, len(sigma))))
    return ((u * sigma) @ v.T).astype(dtype)


def _decaying(m, n, seed=0):
    return _matrix(m, n, 2.0 ** (-np.arange(min(m, n)) / 2), seed, np.float32)


RANK8_SIGMA = np.arange(8, 0, -1.0)


def _rank8(dtype=np.float64):
    return _matrix(320, 256, RANK8_SIGMA, 1, dtype)


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _assert_up_to_sign(x, ref, atol):
    s = np.sign(np.sum(x * ref, axis=0))
    s[s == 0] = 1
    np.testing.assert_allclose(x * s, ref, atol=atol, rtol=0)


def _assert_factors(port, ref):
    (pu, pv, ps, perr), (ju, jv, js, jerr) = (tuple(_np(x) for x in t) for t in (port, ref))
    np.testing.assert_allclose(ps, js, rtol=1e-4)
    _assert_up_to_sign(pu, ju, 1e-3)
    _assert_up_to_sign(pv, jv, 1e-3)
    assert abs(float(perr) - float(jerr)) <= 1e-4


@pytest.mark.parametrize("shape", [(600, 300), (300, 700)])
def test_two_pass_chain_with_injected_sketch(shape):
    a = _decaying(*shape)
    g = np.random.default_rng(2).standard_normal((SKETCH_L, shape[0])).astype(np.float32)
    ja, jg = jnp.asarray(a), jnp.asarray(g)
    w = jsvd._pass1_tiles(jg, ja)
    qw = jsvd._gram_orthonormalize(jnp.conj(w).T)
    z, norm = jsvd._pass2_tiles(ja, qw, jnp.zeros((), jnp.float32))
    ref = jsvd._truncate_with_err(jsvd._projection_tail(z, qw, norm, KEEP, "both"), R_FINAL)
    res = psvd._sketched_uds_both(torch.from_numpy(a), KEEP, SKETCH_L, "both", g=torch.from_numpy(g))
    assert all(t.dtype == torch.float32 for t in res)
    _assert_factors(psvd._truncate_with_err(res, R_FINAL), ref)


@pytest.mark.parametrize("shape", [(600, 300), (300, 700)])
def test_one_view_chain_with_injected_sketch(shape):
    a = _decaying(*shape)
    rng = np.random.default_rng(3)
    g = rng.standard_normal((L_ROW + 10, shape[0])).astype(np.float32)
    omega = rng.standard_normal((shape[1], K_HAT)).astype(np.float32)
    ja, jg, jo = jnp.asarray(a), jnp.asarray(g), jnp.asarray(omega)
    w, y, norm = jsvd._oneview_tiles(
        jg, jo, ja, jnp.zeros((shape[0], K_HAT), jnp.float32), jnp.zeros((), jnp.float32)
    )
    ref = jsvd._truncate_with_err(jsvd._one_view_tail(w, y, norm, jg, KEEP, L_ROW, "both"), R_FINAL)
    res = psvd._one_view_uds_both(
        torch.from_numpy(a), KEEP, K_HAT, L_ROW, "both",
        g=torch.from_numpy(g), omega=torch.from_numpy(omega),
    )
    _assert_factors(psvd._truncate_with_err(res, R_FINAL), ref)


@pytest.mark.parametrize("shape", [(600, 300), (300, 700)])
@pytest.mark.parametrize("call", ["rank", "rank_one_view", "hsvd"])
def test_public_hsvd_draws_heat_tpus_sketch(shape, call):
    """Each package draws its own sketch operators, nothing injected, on a
    full-rank float32 matrix, whose factors depend on the sketch: the
    port's are heat_tpu's ``key(0x5BD)`` / ``split(key(0x5BD1))`` draws, so
    σ, U, V and the error estimate agree within the tolerances of the
    injected chains above. Unsplit, so that both take the single-device
    branch."""
    a = _decaying(*shape)
    jht.zeros(1)  # heat_tpu's policy (x64 on the CPU) before its keys are made
    outs = []
    for lib in (jht, ht):
        x = lib.array(a)
        if call == "rank":
            u, s, v, err = lib.linalg.hsvd_rank(x, R_FINAL, compute_sv=True)
        elif call == "rank_one_view":
            u, s, v, err = lib.linalg.hsvd_rank(x, R_FINAL, compute_sv=True, single_pass=True)
        else:
            u, s, v, err = lib.linalg.hsvd(x, maxrank=R_FINAL, compute_sv=True)
        outs.append((u, v, s, err))
    _assert_factors(outs[1], outs[0])


def test_one_view_params_consult_the_kernel_predicate_on_cuda():
    from torch._subclasses.fake_tensor import FakeTensorMode

    assert psvd._one_view_params(KEEP, 8192) == jsvd._one_view_params(KEEP, 8192) == (K_HAT, L_ROW)
    assert psvd._one_view_params(KEEP, 200) is None  # 4·(ℓ+10) > cap
    with FakeTensorMode():
        a = torch.empty((65536, 8192), device="cuda")
        assert psvd._one_view_params(KEEP, 8192, a) == (K_HAT, L_ROW)
        # keep 20 needs ℓ+10 = 69 > 64 rows: K2 cannot serve, so 2-pass
        assert psvd._one_view_params(20, 8192, a) is None
        assert psvd._one_view_params(20, 8192, a.double()) is None
    assert psvd._one_view_params(20, 8192, torch.empty((1, 1))) == (29, 59)


def _subspace(u, r=8):
    u = _np(u)[:, :r]
    return u @ u.conj().T


def _assert_rank8(U, sigma, V, err, r_final=R_FINAL):
    U, sigma, V = _np(U), _np(sigma), _np(V)
    assert U.shape[1] == r_final and sigma.shape == (r_final,)
    np.testing.assert_allclose(sigma[:8], RANK8_SIGMA, rtol=1e-4)
    assert np.all(np.abs(sigma[8:]) <= 1e-4 * RANK8_SIGMA[0])
    np.testing.assert_allclose(U[:, :8].T @ U[:, :8], np.eye(8), atol=1e-6)
    if V is not None:
        np.testing.assert_allclose(V[:, :8].T @ V[:, :8], np.eye(8), atol=1e-6)
    assert 0.0 <= float(err) <= 1e-4


@pytest.mark.parametrize("compute_sv", [True, False])
@pytest.mark.parametrize("single_pass", [False, True])
def test_hsvd_rank_matches_heat_tpu(compute_sv, single_pass):
    a = _rank8()
    ref = jht.linalg.hsvd_rank(jht.array(a), R_FINAL, compute_sv=compute_sv, single_pass=single_pass)
    got = ht.linalg.hsvd_rank(ht.array(a), R_FINAL, compute_sv=compute_sv, single_pass=single_pass)
    assert len(got) == len(ref) == (4 if compute_sv else 2)
    err = got[-1]
    assert err.shape == () and err.dtype is ht.float64 and err.device == ht.cpu
    assert got[0].dtype is ht.float64 and got[0].shape == ref[0].shape
    np.testing.assert_allclose(_subspace(got[0]), _subspace(ref[0]), atol=1e-6)
    if compute_sv:
        U, sigma, V, _ = got
        np.testing.assert_allclose(_np(sigma)[:8], _np(ref[1])[:8], rtol=1e-4)
        np.testing.assert_allclose(_subspace(V), _subspace(ref[2]), atol=1e-6)
        # A = U Σ Vᵀ on the rank-8 part
        np.testing.assert_allclose((_np(U) * _np(sigma)) @ _np(V).T, a, atol=1e-6)
        _assert_rank8(U, sigma, V, err)
    assert float(ref[-1]) <= 1e-4 and float(err) <= 1e-4


@pytest.mark.parametrize(
    "call",
    [
        lambda pkg, A: pkg.linalg.hsvd_rtol(A, 1e-2, compute_sv=True, maxrank=R_FINAL),
        lambda pkg, A: pkg.linalg.hsvd_rtol(A, 1e-2, compute_sv=True),
        lambda pkg, A: pkg.linalg.hsvd(A, maxrank=R_FINAL, compute_sv=True),
    ],
    ids=["rtol-sketch", "rtol-full-svd", "hsvd-maxrank"],
)
def test_hsvd_rtol_and_hsvd_match_heat_tpu(call):
    a = _rank8()
    JU, js, JV, jerr = call(jht, jht.array(a))
    U, sigma, V, err = call(ht, ht.array(a))
    r = JU.shape[1]
    assert U.shape == JU.shape and V.shape == JV.shape and sigma.shape == (r,)
    assert err.shape == () and err.dtype.__name__ == jerr.dtype.__name__
    np.testing.assert_allclose(_np(sigma)[:8], _np(js)[:8], rtol=1e-4)
    np.testing.assert_allclose(_subspace(U), _subspace(JU), atol=1e-6)
    np.testing.assert_allclose(_subspace(V), _subspace(JV), atol=1e-6)
    _assert_rank8(U, sigma, V, err, r_final=r)
    assert float(jerr) <= 1e-4


def test_split0_matches_heat_tpu_merge_branch():
    a = _rank8()
    A = jht.array(a, split=0)
    assert A.is_distributed()  # heat_tpu: level-0 sketches + TSQR merge
    JU, js, JV, jerr = jht.linalg.hsvd_rank(A, R_FINAL, compute_sv=True)
    P = ht.array(a, split=0)
    assert P.split == 0 and not P.is_distributed()
    U, sigma, V, err = ht.linalg.hsvd_rank(P, R_FINAL, compute_sv=True)
    np.testing.assert_allclose(_np(sigma)[:8], _np(js)[:8], rtol=1e-4)
    np.testing.assert_allclose(_subspace(U), _subspace(JU), atol=1e-6)
    np.testing.assert_allclose(_subspace(V), _subspace(JV), atol=1e-6)
    _assert_rank8(U, sigma, V, err)
    assert float(jerr) <= 1e-4


def test_hsvd_rank_float32_and_integer_operands():
    U, sigma, V, err = ht.linalg.hsvd_rank(ht.array(_rank8(np.float32)), R_FINAL, compute_sv=True)
    assert U.dtype is ht.float32 and sigma.dtype is ht.float32 and err.dtype is ht.float32
    np.testing.assert_allclose(_np(sigma)[:8], RANK8_SIGMA, rtol=1e-4)
    assert float(err) <= 1e-3  # float32 cancellation in ‖A‖² − Σσ², see the module docstring
    ints = np.arange(120).reshape(12, 10)
    Ui, erri = ht.linalg.hsvd_rank(ht.array(ints), 2)  # too small to sketch: full SVD
    JUi, jerri = jht.linalg.hsvd_rank(jht.array(ints), 2)
    assert Ui.dtype is ht.float32 and Ui.shape == JUi.shape == (12, 2)
    assert erri.dtype.__name__ == jerri.dtype.__name__
    assert abs(float(erri) - float(jerri)) <= 1e-6  # rank 2: both errors are rounding


def test_hsvd_rejects_what_heat_tpu_rejects():
    A = ht.array(_rank8())
    for bad in (
        lambda: ht.linalg.hsvd_rank(A.larray, 3),
        lambda: ht.linalg.hsvd_rank(ht.array(np.ones(4)), 3),
        lambda: ht.linalg.hsvd_rank(A, 0),
        lambda: ht.linalg.hsvd_rtol(A, 0.0),
        lambda: ht.linalg.hsvd(A),
    ):
        with pytest.raises((TypeError, ValueError)):
            bad()


def _complex_rank8():
    """A complex64 (320, 256) matrix of rank 8, σ = 8, 7, ..., 1."""
    rng = np.random.default_rng(1)
    u, _ = np.linalg.qr(rng.standard_normal((320, 8)) + 1j * rng.standard_normal((320, 8)))
    v, _ = np.linalg.qr(rng.standard_normal((256, 8)) + 1j * rng.standard_normal((256, 8)))
    return ((u * RANK8_SIGMA) @ v.conj().T).astype(np.complex64)


@pytest.mark.parametrize("compute_sv", [True, False])
@pytest.mark.parametrize(
    "call",
    [
        lambda pkg, A, sv: pkg.linalg.hsvd_rank(A, R_FINAL, compute_sv=sv),
        lambda pkg, A, sv: pkg.linalg.hsvd_rank(A, R_FINAL, compute_sv=sv, single_pass=True),
        lambda pkg, A, sv: pkg.linalg.hsvd(A, maxrank=R_FINAL, compute_sv=sv),
    ],
    ids=["hsvd_rank-two-pass", "hsvd_rank-one-view", "hsvd"],
)
def test_complex64_hsvd_reads_back_and_matches_heat_tpu(call, compute_sv):
    """U of a complex operand reads back with numpy(). U is unique only up
    to a phase per column, so σ, the error estimate, ‖UᴴU − I‖ and the
    reconstruction are compared, at the float32 tolerances of this file:
    σ to 1e-4 relative, the error estimate to 1e-3 (its float32
    cancellation), factors to 1e-3."""
    a = _complex_rank8()
    ref = call(jht, jht.array(a), compute_sv)
    got = call(ht, ht.array(a), compute_sv)
    assert len(got) == len(ref) == (4 if compute_sv else 2)
    U, JU = got[0].numpy(), np.asarray(ref[0].numpy())
    assert U.dtype == JU.dtype == np.complex64 and U.shape == JU.shape
    assert np.abs(U[:, :8].conj().T @ U[:, :8] - np.eye(8)).max() <= 1e-3
    err, jerr = float(got[-1]), float(ref[-1])
    assert got[-1].dtype.__name__ == ref[-1].dtype.__name__ == "float32"
    assert 0.0 <= err <= 1e-3 and abs(err - jerr) <= 1e-3
    np.testing.assert_allclose(_subspace(U), _subspace(JU), atol=1e-3)
    if compute_sv:
        sigma, V = got[1].numpy(), got[2].numpy()
        assert sigma.dtype == np.float32 and V.dtype == np.complex64
        np.testing.assert_allclose(sigma[:8], np.asarray(ref[1].numpy())[:8], rtol=1e-4)
        np.testing.assert_allclose(sigma[:8], RANK8_SIGMA, rtol=1e-4)
        np.testing.assert_allclose((U * sigma) @ V.conj().T, a, atol=1e-3)


# σ₈² = 5.8e-6 lies below n·eps·σ²_max = 25 · 1.19e-7 · 64 = 1.9e-4, where
# the (25, 25) Gram's eigen-solver cannot resolve it
SUB_RESOLUTION_SIGMA = np.array([8.0, 7.0, 6.0, 5.0, 4.0, 3.0, 2.0, 2.4e-3])


@pytest.mark.parametrize("seed, vs_heat_tpu", [(2, True), (5, True), (7, True), (8, True), (9, False)])
def test_a_sigma_below_the_gram_resolution_keeps_its_column_zero(seed, vs_heat_tpu, monkeypatch):
    """The projection tail of a (256, 25) float32 z with seven σ of order 1
    and an eighth below the Gram eigen-solver's resolution, the case of an
    exactly rank-8 level-0 block. ``heat_tpu``'s rule, 1/σ wherever σ > 0,
    blows that column's rounding up into directions that leave
    Cholesky-QR's Gram singular: torch's Cholesky raises on these seeds,
    where XLA's returns NaN (on seed 9 for all of U, so that seed is held
    against numpy's SVD alone) or refines the noise into a unit column.
    The port keeps every column with σ² ≤ n·eps·σ²_max at zero: the kept
    columns and σ match ``heat_tpu``'s and the exact SVD's within this
    file's float32 tolerances (σ 1e-4 relative, U up to column sign 1e-3,
    the error 1e-4 absolute)."""
    z_np = _matrix(256, SKETCH_L, SUB_RESOLUTION_SIGMA, seed, np.float32)
    z = torch.from_numpy(z_np)
    qw, norm_sq = torch.eye(SKETCH_L), torch.sum(z * z)
    with monkeypatch.context() as patched:
        patched.setattr(psvd, "_inv_sigma", lambda s, n: torch.where(s > 0, 1.0 / s, 0.0))
        with pytest.raises(torch.linalg.LinAlgError):
            psvd._projection_tail(z, qw, norm_sq, KEEP, "left")
    u, _, s, err_sq, _ = psvd._projection_tail(z, qw, norm_sq, KEEP, "left")
    u, s = u.numpy(), s.numpy()
    kept = s * s > SKETCH_L * np.finfo(np.float32).eps * s[0] ** 2
    assert kept.tolist() == [True] * 7 + [False] * (KEEP - 7)
    assert np.all(u[:, 7:] == 0.0) and np.all(np.isfinite(u))
    assert np.abs(u[:, :7].T @ u[:, :7] - np.eye(7)).max() <= 1e-5
    exact_u, exact_s, _ = np.linalg.svd(z_np.astype(np.float64), full_matrices=False)
    np.testing.assert_allclose(s[:7], exact_s[:7], rtol=1e-4)
    _assert_up_to_sign(u[:, :7], exact_u[:, :7], 1e-3)
    if vs_heat_tpu:
        ju, _, js, jerr_sq, _ = jsvd._projection_tail(jnp.asarray(z_np), jnp.eye(SKETCH_L),
                                                      jnp.float32(norm_sq), KEEP, "left")
        np.testing.assert_allclose(s[:7], np.asarray(js)[:7], rtol=1e-4)
        _assert_up_to_sign(u[:, :7], np.asarray(ju)[:, :7], 1e-3)
        assert abs(float(err_sq) - float(jerr_sq)) <= 1e-4
