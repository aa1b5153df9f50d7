"""The distributed hSVD, TSQR and matmul of heat_tpu_torch against
heat_tpu.

Two levels:

- the 4-rank gloo world of test_torch_distributed.py (its cases of
  ``_linalg_cases`` in torch_mp_worker.py, run once per pytest run) against
  heat_tpu on ``MeshCommunication(devices=jax.devices()[:4])``:
  - ``matmul`` over every split pair: the result's split and each rank's
    shard equal heat_tpu's, values within 1e-5 of the product's scale;
  - TSQR flat and as the two-level tree with groups of 2, and ``qr`` at
    splits 0, 1 and None: Q·R = A and QᴴQ = I within 1e-5, R equal to
    heat_tpu's up to row signs within 1e-5 of its scale, the splits
    heat_tpu's;
  - ``hsvd_rank`` (2-pass and one-view), ``hsvd_rtol`` and ``hsvd`` at
    split 0 and 1, ``compute_sv`` both ways, on an exactly rank-8 float32
    matrix whose last shard is ragged: σ within 1e-4 relative, U and V
    equal up to column signs within 1e-3, U and V split 0, the error's
    dtype heat_tpu's, σ and the rank equal bit for bit on every rank, and
    every rank's level-0 widths (rloc, ⌈n/p⌉, sketch width, one-view
    widths) equal to heat_tpu's ``_local_svd_fn`` arguments;
  - the distributed Cholesky-QR refine equal within 1e-5 to the refine of
    the whole matrix, where each rank refining alone is off by more than
    1e-3;
- ``hsvd_rank`` (2-pass and one-view) and ``hsvd`` at split 0 and 1 on a
  full-rank float32 matrix, each package drawing its own operators:
  σ within 1e-4, U and V up to sign within 1e-3, the error estimate
  within 1e-4 of heat_tpu's (the port draws heat_tpu's stream);
- one process: the level-0 body on a split-0 shard (K1's swapped roles,
  K2 on the copied Sᵀ), with heat_tpu's own draws injected, against
  heat_tpu's ``_sketched_uds`` and ``_one_view_uds_both`` on the same
  transposed block, on a full-rank matrix: B = U·Σ within 1e-5 of its
  scale up to column signs, the error and norm sums within 1e-5
  relative.
"""

import functools
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht

import torch_mp_worker as worker
from test_torch_distributed import WORLD, _jcomm, _result, _slices, jcomm, ranks  # noqa: F401 (fixtures)

jsvd = importlib.import_module("heat_tpu.core.linalg.svdtools")
psvd = importlib.import_module("heat_tpu_torch.core.linalg.svdtools")
SPLITS = (None, 0, 1)


def _up_to_sign(x, ref, atol, axis=0):
    """x equals ref up to the sign of each column (axis 0) or row (axis 1)."""
    s = np.sign(np.sum(np.real(x * np.conj(ref)), axis=axis, keepdims=True))
    s[s == 0] = 1
    np.testing.assert_allclose(x * s, ref, atol=atol, rtol=0)


# --------------------------------------------------------------------- #
# matmul                                                                #
# --------------------------------------------------------------------- #
MATMULS = [(label, sa, sb) for label in worker.MATMUL_SHAPES for sa in SPLITS for sb in SPLITS]
NO_MOVE = {(None, None): {}, (0, None): {}, (None, 1): {}, (1, 0): {"all-reduce": 1},
           (1, None): {"all-reduce": 1}, (None, 0): {"all-reduce": 1}}
# the other pairs gather the operand that must be whole (b for a.split = 0,
# a for b.split = 1), unless gathering the other operand and moving the
# m x n product brings fewer elements to a rank; at 4 ranks these take
# that other route (thin_k, a reconstruction U @ V^T, must not)
OTHER_ROUTE = {(0, 0): {"all-gather": 1, "all-reduce": 1}, (0, 1): {"all-gather": 1, "all-to-all": 1},
               (1, 1): {"all-gather": 1, "all-reduce": 1}}
TAKES_OTHER = {("small_a", 0, 0), ("small_a", 0, 1), ("wide", 1, 1)}


def _matmul_counts(label, sa, sb):
    if (sa, sb) in NO_MOVE:
        return NO_MOVE[(sa, sb)]
    return OTHER_ROUTE[(sa, sb)] if (label, sa, sb) in TAKES_OTHER else {"all-gather": 1}


@pytest.mark.parametrize("label, sa, sb", MATMULS, ids=[f"{l}-{a}-{b}" for l, a, b in MATMULS])
def test_matmul_over_split_pairs_at_world_size_4(ranks, jcomm, label, sa, sb):
    sa_shape, sb_shape = worker.MATMUL_SHAPES[label]
    a, b = worker._array(sa_shape, "float32", 41), worker._array(sb_shape, "float32", 42)
    ref = jht.matmul(jht.array(a, split=sa, comm=jcomm), jht.array(b, split=sb, comm=jcomm))
    want = ref.numpy()
    scale = float(np.abs(a).sum(1).max() * np.abs(b).max())
    for r, res in enumerate(_result(ranks, f"matmul_{label}_{sa}_{sb}")):
        assert (res["split"], res["gshape"], res["dtype"]) == (ref.split, ref.gshape, ref.dtype.__name__)
        np.testing.assert_allclose(res["global"], want, atol=1e-5 * scale, rtol=0)
        np.testing.assert_allclose(res["local"], want[_slices(want.shape, ref.split, r)] if ref.split is not None
                                   else want, atol=1e-5 * scale, rtol=0)
        assert res["counts"] == _matmul_counts(label, sa, sb)


# --------------------------------------------------------------------- #
# TSQR and qr                                                           #
# --------------------------------------------------------------------- #
def _check_q_r(q_global, r, a):
    np.testing.assert_allclose(q_global @ r, a, atol=1e-5 * np.abs(a).max() * np.sqrt(a.shape[1]))
    np.testing.assert_allclose(q_global.T @ q_global, np.eye(q_global.shape[1]), atol=1e-5)
    assert np.all(np.tril(r, -1) == 0)


@pytest.mark.parametrize("label", list(worker.QR_SHAPES))
@pytest.mark.parametrize("s", [1, 2])
def test_tsqr_flat_and_two_level(ranks, jcomm, label, s):
    shape = worker.QR_SHAPES[label]
    a = worker._array(shape, "float32", 43)
    jr = jht.linalg.qr(jht.array(a, split=0, comm=jcomm)).R.numpy()
    rs = _result(ranks, f"tsqr_{label}_{s}")
    for r, res in enumerate(rs):
        q = res["q"]
        assert q["split"] == 0 and q["gshape"] == (shape[0], shape[1])
        _check_q_r(q["global"], res["r"], a)
        np.testing.assert_array_equal(q["local"], q["global"][_slices(q["gshape"], 0, r)])
        _up_to_sign(res["r"], jr, 1e-5 * np.abs(jr).max(), axis=1)
        np.testing.assert_array_equal(res["r"], rs[0]["r"])  # one R on every rank
        np.testing.assert_allclose(np.abs(res["r_only"]), np.abs(res["r"]), atol=1e-6 * np.abs(jr).max())
        assert res["counts"] == {"all-gather": s}


@pytest.mark.parametrize("label", list(worker.QR_SHAPES))
@pytest.mark.parametrize("split", SPLITS)
def test_qr_at_world_size_4(ranks, jcomm, label, split):
    shape = worker.QR_SHAPES[label]
    a = worker._array(shape, "float32", 43)
    jq, jr = jht.linalg.qr(jht.array(a, split=split, comm=jcomm))
    for r, res in enumerate(_result(ranks, f"qr_{label}_{split}")):
        q, rr = res["q"], res["r"]
        assert (q["split"], rr["split"], q["gshape"], rr["gshape"]) == (jq.split, jr.split, jq.gshape, jr.gshape)
        _check_q_r(q["global"], rr["global"], a)
        _up_to_sign(rr["global"], jr.numpy(), 1e-5 * np.abs(a).max() * np.sqrt(shape[0]), axis=1)
        np.testing.assert_array_equal(q["local"], q["global"][_slices(q["gshape"], q["split"], r)]
                                      if q["split"] is not None else q["global"])


# --------------------------------------------------------------------- #
# the distributed hSVD                                                  #
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _reference(split: int, call: str, shape=worker.HSVD_SHAPE):
    """heat_tpu's factors on the 4-device mesh, and the level-0 arguments
    of its ``_local_svd_fn``."""
    a = worker.rank8(shape) if split == 0 else worker.rank8(shape).T.copy()
    seen = []
    real = jsvd._local_svd_fn

    def recording(mesh, axis, lrows, lcols, rloc, jdtype, sketch_l=None, one_view=None):
        seen.append({"rloc": rloc, "lcols": lcols, "sketch_l": sketch_l, "one_view": one_view})
        return real(mesh, axis, lrows, lcols, rloc, jdtype, sketch_l, one_view)

    with mock.patch.object(jsvd, "_local_svd_fn", recording):
        U, s, V, err = worker.hsvd_call(jht, jht.array(a, split=split, comm=_jcomm()), call, True)
    return {"U": U.numpy(), "sigma": s.numpy(), "V": V.numpy(), "err": float(err), "err_dtype": err.dtype.__name__,
            "splits": (U.split, V.split, err.split), "level0": seen}


HSVD_CASES = [(split, call, sv) for split in (0, 1) for call in worker.HSVD_CALLS for sv in (True, False)]


@pytest.mark.parametrize("split, call, compute_sv", HSVD_CASES, ids=[f"{s}-{c}-{v}" for s, c, v in HSVD_CASES])
def test_hsvd_at_world_size_4_matches_heat_tpu(ranks, jcomm, split, call, compute_sv):
    ref = _reference(split, call)
    results = _result(ranks, f"hsvd_{split}_{call}_{compute_sv}")
    k = min(8, ref["U"].shape[1])
    for r, res in enumerate(results):
        U = res["U"]
        assert U["split"] == ref["splits"][0] == 0 and U["gshape"] == ref["U"].shape
        assert (res["err_dtype"], res["err_split"]) == (ref["err_dtype"], None)
        assert 0.0 <= res["err"] <= 1e-3 and 0.0 <= ref["err"] <= 1e-3
        _up_to_sign(U["global"][:, :k], ref["U"][:, :k], 1e-3)
        np.testing.assert_array_equal(U["local"], U["global"][_slices(U["gshape"], 0, r)])
        # one route on every rank, heat_tpu's
        assert len(res["level0"]) == 1
        mine = {key: res["level0"][0][key] for key in ("rloc", "lcols", "sketch_l", "one_view")}
        assert mine == ref["level0"][0]
        if compute_sv:
            s, V = res["sigma"], res["V"]
            assert s["split"] is None and V["split"] == ref["splits"][1] == 0 and V["gshape"] == ref["V"].shape
            np.testing.assert_allclose(s["global"][:k], ref["sigma"][:k], rtol=1e-4)
            np.testing.assert_allclose(s["global"][:8], worker.RANK8_SIGMA[: len(s["global"][:8])], rtol=1e-4)
            _up_to_sign(V["global"][:, :k], ref["V"][:, :k], 1e-3)
            # σ and the rank: the same bits on every rank
            np.testing.assert_array_equal(s["local"], results[0]["sigma"]["local"])
        assert U["gshape"] == results[0]["U"]["gshape"]


DRAW_CASES = [(split, call) for split in (0, 1) for call in ("rank", "rank_one_view", "hsvd")]


@pytest.mark.parametrize("split, call", DRAW_CASES, ids=[f"{s}-{c}" for s, c in DRAW_CASES])
def test_hsvd_at_world_size_4_draws_heat_tpus_sketches(ranks, jcomm, split, call):
    """Each package draws its own level-0 operators, nothing injected, on a
    full-rank float32 matrix (σ_i = 2^(-i/2)), whose factors depend on the
    sketch: the port's ranks draw heat_tpu's ``key(0x5BD)`` /
    ``split(key(0x5BD1))`` operators, so σ within 1e-4, U and V up to
    sign within 1e-3 and the error estimate within 1e-4 of heat_tpu's."""
    a = worker.decaying(worker.HSVD_DECAYING)
    a = a if split == 0 else a.T.copy()
    U, s, V, err = worker.hsvd_call(jht, jht.array(a, split=split, comm=_jcomm()), call, True)
    k = min(8, U.shape[1])
    for res in _result(ranks, f"random_hsvd_{split}_{call}"):
        np.testing.assert_allclose(res["sigma"][:k], s.numpy()[:k], rtol=1e-4)
        _up_to_sign(res["U"][:, :k], U.numpy()[:, :k], 1e-3)
        _up_to_sign(res["V"][:, :k], V.numpy()[:, :k], 1e-3)
        assert abs(res["err"] - float(err)) <= 1e-4


def test_hsvd_routes_split_1_two_pass_and_one_view_as_heat_tpu(ranks):
    """The level-0 route of each call (sketch, one-view) is the one the
    shapes select: the sketch everywhere, one-view where asked for."""
    for split in (0, 1):
        rank = _result(ranks, f"hsvd_{split}_rank_True", 0)["level0"][0]
        one = _result(ranks, f"hsvd_{split}_rank_one_view_True", 0)["level0"][0]
        assert rank["sketch_l"] == 25 and rank["one_view"] is None
        assert one["one_view"] == (24, 49)
        assert (rank["lcols"], rank["rloc"]) == (249, 15)


def test_short_last_shard_takes_the_route_of_the_others(ranks):
    m, n = worker.HSVD_BOUNDARY
    ref = _reference(0, "rank", shape=worker.HSVD_BOUNDARY)
    for r, res in enumerate(_result(ranks, "hsvd_boundary")):
        (rec,) = res["level0"]
        assert rec["rows"] == _jcomm().chunk((m, n), 0, rank=r)[1][0]
        assert {key: rec[key] for key in ("rloc", "lcols", "sketch_l", "one_view")} == ref["level0"][0]
        assert rec["sketch_l"] == 25 and rec["lcols"] == 100  # rank 3 holds 97 rows: 4 · 25 > 97 alone
        np.testing.assert_allclose(res["sigma"][:8], ref["sigma"][:8], rtol=1e-4)


def test_distributed_refine_allreduces_the_gram(ranks):
    for res in _result(ranks, "refine"):
        np.testing.assert_allclose(res["together"], res["whole"], atol=1e-5)
        np.testing.assert_allclose(res["together"].T @ res["together"], np.eye(5), atol=1e-5)
        assert np.abs(res["alone"] - res["whole"]).max() > 1e-3


# --------------------------------------------------------------------- #
# the level-0 body with heat_tpu's draws injected                      #
# --------------------------------------------------------------------- #
KEEP = 15


def _shard(rows, m, seed=5):
    """A full-rank split-0 shard S (rows x m) with σ_i = 2^{-i/2}."""
    rng = np.random.default_rng(seed)
    k = min(rows, m)
    u, _ = np.linalg.qr(rng.standard_normal((rows, k)))
    v, _ = np.linalg.qr(rng.standard_normal((m, k)))
    return ((u * 2.0 ** (-np.arange(k) / 2)) @ v.T).astype(np.float32)


def _compare_block(b, err_sq, norm_sq, ref_u, ref_s, ref_err, ref_norm):
    want = np.asarray(ref_u) * np.asarray(ref_s)
    _up_to_sign(b.numpy()[:, : want.shape[1]], want, 1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(norm_sq), float(ref_norm), rtol=1e-5)
    np.testing.assert_allclose(float(err_sq), float(ref_err), rtol=1e-5, atol=1e-5 * float(ref_norm))


@pytest.mark.parametrize("rows, m", [(600, 300), (700, 512), (130, 700)])
def test_swapped_two_pass_level0_with_injected_draw(rows, m):
    ht.use_device("cpu")
    s = _shard(rows, m)
    sketch_l = KEEP + 10
    a_blk = jnp.asarray(s.T)
    g = np.array(jax.random.normal(jax.random.key(0x5BD), (sketch_l, m), dtype=jnp.float32))
    ref_u, ref_s, ref_err, ref_norm = jsvd._sketched_uds(a_blk, KEEP, sketch_l)
    b, err_sq, norm_sq = psvd._level0(torch.from_numpy(s), True, KEEP, rows, sketch_l, None, g=torch.from_numpy(g))
    assert b.shape == (m, KEEP)
    _compare_block(b, err_sq, norm_sq, ref_u, ref_s, ref_err, ref_norm)


@pytest.mark.parametrize("transposed", [True, False])
def test_one_view_level0_with_injected_draws(transposed):
    ht.use_device("cpu")
    s = _shard(600, 300)
    a = s.T if transposed else s
    m, n = a.shape
    k_hat, l_row = KEEP + 9, 2 * (KEEP + 9) + 1
    kg, ko = jax.random.split(jax.random.key(0x5BD1))
    g = np.array(jax.random.normal(kg, (l_row + 10, m), dtype=jnp.float32))
    omega = np.array(jax.random.normal(ko, (n, k_hat), dtype=jnp.float32))
    ref_u, _, ref_s, ref_err, ref_norm = jsvd._one_view_uds_both(jnp.asarray(a), KEEP, k_hat, l_row, "left")
    b, err_sq, norm_sq = psvd._level0(torch.from_numpy(np.ascontiguousarray(s)), transposed, KEEP, n, 25,
                                      (k_hat, l_row), g=torch.from_numpy(g), omega=torch.from_numpy(omega))
    _compare_block(b, err_sq, norm_sq, ref_u, ref_s, ref_err, ref_norm)


def test_level0_params_follow_the_global_shape():
    # blocks of ⌈n/p⌉ columns on every rank, whatever the last shard holds
    assert psvd._level0_params(128, 397, 4, 10, 5, None, False) == (15, 100, 25, None)
    assert psvd._level0_params(256, 995, 4, 10, 5, None, True) == (15, 249, 25, (24, 49))
    assert psvd._level0_params(128, 395, 4, 10, 5, None, False)[2] is None  # 99 columns: the full SVD
    assert psvd._level0_params(256, 995, 4, 10, 5, 1e-4, False)[2] is None  # tight rtol: the full SVD
    assert psvd._level0_params(256, 995, 4, None, 5, 0.1, False) == (249, 249, None, None)


def test_empty_shard_is_a_zero_block():
    b, err_sq, norm_sq = psvd._level0(torch.zeros((0, 40)), True, 6, 10, None, None)
    assert b.shape == (40, 6) and not b.any() and float(err_sq) == float(norm_sq) == 0.0


# --------------------------------------------------------------------- #
# the rest of linalg/basics.py across ranks                             #
# --------------------------------------------------------------------- #
BASICS = [(name, split) for name in worker.BASICS for split in SPLITS]


@pytest.mark.parametrize("name, split", BASICS, ids=[f"{n}-{s}" for n, s in BASICS])
def test_basics_at_world_size_4(ranks, jcomm, name, split):
    ref = worker.BASICS[name](jht, *worker.basics_operands(jht, split, comm=jcomm))
    want = ref.numpy()
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    for r, res in enumerate(_result(ranks, f"basics_{name}_{split}")):
        assert (res["split"], res["gshape"], res["dtype"]) == (ref.split, ref.gshape, ref.dtype.__name__)
        np.testing.assert_allclose(res["global"], want, rtol=1e-5, atol=1e-5 * scale)
        mine = want[_slices(want.shape, ref.split, r)] if ref.split is not None else want
        np.testing.assert_allclose(res["local"], mine, rtol=1e-5, atol=1e-5 * scale)
