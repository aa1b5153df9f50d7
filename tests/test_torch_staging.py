"""Out-of-core staging of heat_tpu_torch (``redistribution.staging`` and the
routes that take a ``HostArray``) against heat_tpu's.

- ``window_extents`` equal to heat_tpu's; the ``host-staging`` plans of
  heat_tpu's golden staged set equal to heat_tpu's in their spec, steps,
  windows, bytes, slab, resident bytes and passes, at the same pinned slab
  and card capacity. The modeled times, ``hbm_capacity_bytes`` and the
  ``plan_id`` carry this card's rates (``core.tiers``) and are not compared.
- ``hsvd_rank`` of a ``HostArray`` streamed in several windows a pass (a
  1 MiB slab), 2-pass and one-view, ``compute_sv`` both ways, against
  heat_tpu's staged route: on a float32 matrix with σ_i = 2^{-i/2}
  within the in-memory parity tolerances of test_torch_hsvd.py (σ 1e-4
  relative, U and V up to sign 1e-3, the estimate 1e-4), and on an exactly
  rank-8 float64 one exactly (σ 1e-4, the subspaces 1e-6); the staged
  factors bit for bit those of the port's own in-memory route, also under
  ``HEAT_TPU_OOC=1``.
- ``HEAT_TPU_OOC=0`` materializes the operand (the in-memory result), and
  raises ``MemoryError`` where ``HEAT_TPU_HBM_BYTES`` is below it; a staged
  plan larger than that capacity raises ``MemoryError`` too.
- ``svd(compute_uv=False)`` (σ within 1e-5 of the largest), ``solve`` with a
  ``HostArray`` of right-hand sides (within 1e-10, float64), ``KMeans.fit``
  and ``partial_fit`` (centers within 1e-5, inertia 1e-5 relative),
  ``pagerank_stream`` (ranks within 1e-6, iterations equal) and both
  ``stream_transform``\\ s (one-hot exact, TF-IDF within 1e-6) against
  heat_tpu.
- across ranks: ``hsvd_rank`` of a ``HostArray`` in the 4-rank world of
  test_torch_distributed.py, whole factors (split None) on every rank that
  agree with each other and with one process's within the parity
  tolerances.
"""

import functools

import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu.redistribution import staging as jstaging
from heat_tpu_torch.redistribution import staging

import torch_mp_worker as worker
from test_torch_distributed import WORLD, _result, ranks  # noqa: F401 (fixture)
from test_torch_hsvd import R_FINAL, RANK8_SIGMA, _assert_factors, _matrix, _subspace

SLAB_MB = 1  # windows of 512 columns or rows at these sizes: several a pass


@functools.lru_cache(maxsize=None)
def _decaying(m, n):
    """float32 (m, n) with σ_i = 2^{-i/2}, its first 128 (the rest lie below
    float32's resolution of σ_0): worker.staged_operand's matrix."""
    return worker.decaying_128(m, n)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.zeros(1)  # heat_tpu's policy (x64 on the CPU) before its keys are made


@pytest.fixture
def slab(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_OOC_SLAB_MB", str(SLAB_MB))
    monkeypatch.delenv("HEAT_TPU_OOC", raising=False)
    monkeypatch.delenv("HEAT_TPU_HBM_BYTES", raising=False)


# --------------------------------------------------------------------- #
# window geometry and the staged plans                                  #
# --------------------------------------------------------------------- #
EXTENTS = [((65536, 8192), 4, 0, 256 << 20), ((65536, 8192), 4, 1, 256 << 20), ((1300, 1100), 4, 1, 1 << 20),
           ((1300, 1100), 8, 0, 1 << 20), ((100, 3), 4, 0, 1 << 20), ((0, 5), 4, 0, 1 << 20),
           ((70000, 2), 4, 0, 1 << 20), ((40, 1 << 20), 4, 1, 1 << 20)]


@pytest.mark.parametrize("shape, itemsize, axis, slab_b", EXTENTS)
def test_window_extents_match_heat_tpu(shape, itemsize, axis, slab_b):
    got = staging.window_extents(shape, itemsize, axis, slab_b)
    assert got == jstaging.window_extents(shape, itemsize, axis, slab_b)
    assert got[0][0] == 0 and got[-1][1] == shape[axis]
    assert all(b - a == got[0][1] - got[0][0] for a, b in got[:-1])


GOLDEN = [name for name, _ in jstaging.golden_staged_plans()]
_COMPARED = ("depth", "grain", "passes", "n_windows", "window_bytes", "slab_bytes", "resident_bytes", "host_bytes")


@pytest.mark.parametrize("name", GOLDEN)
def test_staged_plans_match_heat_tpus_golden_set(name):
    ref = dict(jstaging.golden_staged_plans())[name]
    sg = ref.staging
    passes = [{k: p[k] for k in ("tag", "axis", "writeback")} for p in sg["passes"]]
    got = staging.plan_staged_passes(ref.spec.gshape, ref.spec.dtype, passes, slab=sg["slab_bytes"],
                                     out_bytes=sg["resident_bytes"], hbm_bytes=sg["hbm_capacity_bytes"])
    assert got.strategy == ref.strategy == "host-staging"
    assert got.spec.as_dict() == ref.spec.as_dict()
    assert [s.as_dict() for s in got.steps] == [s.as_dict() for s in ref.steps]
    assert all(s.tier == "pcie" for s in got.steps)
    assert {k: got.staging[k] for k in _COMPARED} == {k: sg[k] for k in _COMPARED}
    assert (got.peak_bytes, got.budget_bytes, got.bytes_moved, got.liveness_peak_bytes, got.collective_counts()) == (
        ref.peak_bytes, ref.budget_bytes, ref.bytes_moved, ref.liveness_peak_bytes, ref.collective_counts())
    assert got.staging["hbm_capacity_bytes"] == sg["hbm_capacity_bytes"]
    assert set(got.as_dict()) == set(ref.as_dict())  # the conditional staging key, nothing else
    assert "staging: depth=2" in got.describe()


def test_plans_without_staging_keep_their_bytes():
    plan = ht.redistribution.plan(ht.redistribution.RedistSpec.normalize((64, 48), "float32", 0, 1, 4))
    assert "staging" not in plan.as_dict() and all("tier" not in s.as_dict() for s in plan.steps)


def test_the_pcie_tier_is_the_staging_steps_alone():
    with pytest.raises(ValueError):
        ht.redistribution.Step("stage_in")
    with pytest.raises(ValueError):
        ht.redistribution.Step("slice", tier="pcie")


def test_a_plan_larger_than_the_card_is_refused(monkeypatch, slab):
    sched = staging.plan_staged_passes((4096, 4096), np.float32, [{"tag": "sketch", "axis": 1}], out_bytes=1 << 20)
    assert staging.prove_fits(sched) is sched
    monkeypatch.setenv("HEAT_TPU_HBM_BYTES", str(sched.liveness_peak_bytes - 1))
    with pytest.raises(MemoryError, match="capacity"):
        staging.prove_fits(sched)


def test_capacity_and_slab_read_their_overrides(monkeypatch):
    from heat_tpu_torch.core import tiers

    monkeypatch.setenv("HEAT_TPU_HBM_BYTES", str(64 << 20))
    monkeypatch.setenv("HEAT_TPU_HOST_BYTES", "12345")
    monkeypatch.setenv("HEAT_TPU_OOC_SLAB_MB", "512")
    assert tiers.capacity("hbm") == 64 << 20 and tiers.capacity("host") == 12345
    assert staging.slab_bytes() == 16 << 20  # a quarter of the card
    monkeypatch.delenv("HEAT_TPU_HBM_BYTES")
    assert tiers.capacity("hbm") > 1 << 20  # the CPU's memory
    assert tiers.transfer_time(int(tiers.HBM_BPS), "hbm") == 1.0
    with pytest.raises(ValueError):
        tiers.capacity("ici")


@pytest.mark.parametrize("mode, want", [("0", False), ("off", False), ("1", True), ("auto", None), ("", None)])
def test_the_gate(monkeypatch, mode, want):
    monkeypatch.setenv("HEAT_TPU_OOC", mode)
    assert staging.ooc_mode() == jstaging.ooc_mode()
    for host in (False, True):
        assert staging.ooc_engaged(1, host) == jstaging.ooc_engaged(1, host) == (host if want is None else want)


# --------------------------------------------------------------------- #
# hsvd_rank                                                             #
# --------------------------------------------------------------------- #
SHAPES = [(1300, 1100), (1100, 1300)]


def _factors(out, compute_sv):
    return (out[0], out[2], out[1], out[3]) if compute_sv else (out[0], None, None, out[1])


@pytest.mark.parametrize("compute_sv", [True, False])
@pytest.mark.parametrize("single_pass", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_staged_hsvd_rank_matches_heat_tpus_staged_route(slab, shape, single_pass, compute_sv):
    a = _decaying(*shape)
    ref = jht.linalg.hsvd_rank(jstaging.HostArray(a), R_FINAL, compute_sv=compute_sv, single_pass=single_pass)
    got = ht.linalg.hsvd_rank(staging.HostArray(a), R_FINAL, compute_sv=compute_sv, single_pass=single_pass)
    assert len(got) == len(ref) == (4 if compute_sv else 2)
    assert all(t.split is None for t in got) and got[0].shape == ref[0].shape and got[0].dtype is ht.float32
    pu, pv, ps, perr = _factors(got, compute_sv)
    ju, jv, js, jerr = _factors(ref, compute_sv)
    if compute_sv:
        _assert_factors((pu, pv, ps, perr), (ju, jv, js, jerr))
    else:
        _assert_factors((pu, pu, np.ones(1), perr), (ju, ju, np.ones(1), jerr))


@pytest.mark.parametrize("single_pass", [False, True])
def test_staged_hsvd_rank_is_exact_on_a_rank8_operand(slab, single_pass):
    a = _matrix(1300, 1100, RANK8_SIGMA, 1, np.float64)
    JU, js, JV, jerr = jht.linalg.hsvd_rank(jstaging.HostArray(a), R_FINAL, compute_sv=True, single_pass=single_pass)
    U, sigma, V, err = ht.linalg.hsvd_rank(staging.HostArray(a), R_FINAL, compute_sv=True, single_pass=single_pass)
    assert U.dtype is ht.float64 and err.shape == ()
    np.testing.assert_allclose(sigma.numpy()[:8], js.numpy()[:8], rtol=1e-4)
    np.testing.assert_allclose(sigma.numpy()[:8], RANK8_SIGMA, rtol=1e-4)
    np.testing.assert_allclose(_subspace(U), _subspace(JU), atol=1e-6)
    np.testing.assert_allclose(_subspace(V), _subspace(JV), atol=1e-6)
    assert float(err) <= 1e-4 and float(jerr) <= 1e-4


@pytest.mark.parametrize("single_pass", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(700, 600), (300, 200)])
def test_staged_factors_are_the_in_memory_routes_bit_for_bit(monkeypatch, slab, shape, single_pass):
    a = _decaying(*shape)
    want = ht.linalg.hsvd_rank(ht.array(a), R_FINAL, compute_sv=True, single_pass=single_pass)
    got = ht.linalg.hsvd_rank(staging.HostArray(a), R_FINAL, compute_sv=True, single_pass=single_pass)
    monkeypatch.setenv("HEAT_TPU_OOC", "1")
    forced = ht.linalg.hsvd_rank(ht.array(a), R_FINAL, compute_sv=True, single_pass=single_pass)
    for g, f, w in zip(got, forced, want):
        assert torch.equal(g.larray, w.larray) and torch.equal(f.larray, w.larray)


def test_ooc_0_materializes_and_refuses_what_does_not_fit(monkeypatch, slab):
    a = torch.randn((2600, 2600), generator=torch.Generator().manual_seed(8)).numpy()  # larger than two windows
    monkeypatch.setenv("HEAT_TPU_OOC", "0")
    want = ht.linalg.hsvd_rank(ht.array(a), R_FINAL, compute_sv=True)
    got = ht.linalg.hsvd_rank(staging.HostArray(a), R_FINAL, compute_sv=True)
    assert all(torch.equal(g.larray, w.larray) for g, w in zip(got, want))
    monkeypatch.setenv("HEAT_TPU_HBM_BYTES", str(a.nbytes - 1))
    with pytest.raises(MemoryError, match="staging is not engaged"):
        ht.linalg.hsvd_rank(staging.HostArray(a), R_FINAL)
    monkeypatch.setenv("HEAT_TPU_OOC", "auto")
    U, err = ht.linalg.hsvd_rank(staging.HostArray(a), R_FINAL)  # staged, in a card smaller than A
    assert torch.equal(U.larray, want[0].larray)


def test_a_sketch_inadmissible_budget_takes_the_full_svd(slab):
    a = _matrix(60, 40, 2.0 ** (-np.arange(40) / 2), 0, np.float32)
    U, sigma, V, err = ht.linalg.hsvd_rank(staging.HostArray(a), 12, compute_sv=True)
    JU, js, JV, jerr = jht.linalg.hsvd_rank(jstaging.HostArray(a), 12, compute_sv=True)
    _assert_factors((U, V, sigma, err), (JU, JV, js, jerr))


def test_host_array_from_hdf5(tmp_path, slab):
    h5py = pytest.importorskip("h5py")
    a = _decaying(700, 600)
    with h5py.File(tmp_path / "a.h5", "w") as f:
        f["a"] = a
    host = staging.HostArray.from_hdf5(str(tmp_path / "a.h5"), "a")
    assert host.shape == a.shape and host.dtype == np.float32 and host.nbytes == a.nbytes
    got = ht.linalg.hsvd_rank(host, R_FINAL, compute_sv=True)
    want = ht.linalg.hsvd_rank(staging.HostArray(a), R_FINAL, compute_sv=True)
    _assert_factors((got[0], got[2], got[1], got[3]), (want[0], want[2], want[1], want[3]))


# --------------------------------------------------------------------- #
# the other staged routes                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_staged_svd_values_match_heat_tpu(slab, dtype):
    a = np.random.default_rng(4).standard_normal((2100, 300)).astype(dtype)
    got = ht.linalg.svd(staging.HostArray(a), compute_uv=False)
    want = jht.linalg.svd(jstaging.HostArray(a), compute_uv=False).numpy()
    assert got.split is None and got.shape == (300,) and got.dtype.__name__ == np.dtype(dtype).name
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * want[0])
    with pytest.raises(NotImplementedError, match="hsvd_rank"):
        ht.linalg.svd(staging.HostArray(a))


@pytest.mark.parametrize("assume_a", ["gen", "pos"])
def test_solve_with_a_host_array_of_right_hand_sides_matches_heat_tpu(slab, assume_a):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((40, 40)) + 40 * np.eye(40)
    a = a @ a.T if assume_a == "pos" else a
    b = rng.standard_normal((40, 5000))
    got = ht.linalg.solve(ht.array(a), staging.HostArray(b), assume_a=assume_a)
    want = jht.linalg.solve(jht.array(a), jstaging.HostArray(b), assume_a=assume_a)
    assert isinstance(got, staging.HostArray) and got.shape == want.shape
    np.testing.assert_allclose(got.window(0, 0, 40), want.window(0, 0, 40), rtol=0, atol=1e-10)


def _blobs(n, seed=61):
    return worker.km_blobs(n, seed)


@pytest.mark.parametrize("how", ["fit", "partial_fit"])
def test_kmeans_on_a_host_array_matches_heat_tpu(slab, how):
    data = _blobs(70000)  # 16 B a row: five windows of 16384 rows
    kms = []
    for lib, st in ((jht, jstaging), (ht, staging)):
        km = lib.cluster.KMeans(worker.KM_K, init=lib.array(data[: worker.KM_K]))
        getattr(km, how)(st.HostArray(data))
        if how == "partial_fit":
            km.partial_fit(st.HostArray(_blobs(20000, 62)))
        kms.append(km)
    ref, got = kms
    np.testing.assert_allclose(got.cluster_centers_.numpy(), ref.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5)
    assert abs(got.inertia_ - ref.inertia_) <= 1e-5 * abs(ref.inertia_)


def test_pagerank_stream_matches_heat_tpu(slab):
    rng = np.random.default_rng(6)
    n = 900
    edges = rng.integers(0, n, (300000, 2)).astype(np.int32)
    edges = edges[edges[:, 0] % 7 != 3]  # some nodes without out-edges
    # tol well above float32's rounding of the l1 delta (about 1e-8 here), so that both stop on one step
    ref = jht.graph.pagerank_stream(edges, n, tol=1e-6)
    got = ht.graph.pagerank_stream(staging.HostArray(edges), n, tol=1e-6)
    assert got.iterations == ref.iterations and got.converged == ref.converged
    assert got.ranks.split is None and got.ranks.shape == (n,)
    np.testing.assert_allclose(got.ranks.numpy(), ref.ranks.numpy(), rtol=0, atol=1e-6)
    whole = ht.graph.pagerank(np.histogram2d(edges[:, 0], edges[:, 1], bins=n, range=[[0, n], [0, n]])[0],
                              tol=1e-6, split=None)
    np.testing.assert_allclose(got.ranks.numpy(), whole.ranks.numpy(), rtol=0, atol=1e-6)


def test_stream_transforms_match_heat_tpu(slab):
    rng = np.random.default_rng(7)
    fit_codes = rng.integers(0, 6, (200, 4)).astype(np.int32)
    codes = rng.integers(0, 7, (90000, 4)).astype(np.int32)  # 7: unseen in fit
    ref = jht.preprocessing.OneHotEncoder().fit(jht.array(fit_codes)).stream_transform(codes)
    got = ht.preprocessing.OneHotEncoder().fit(ht.array(fit_codes)).stream_transform(staging.HostArray(codes))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    counts = rng.poisson(0.7, (40000, 30)).astype(np.float32)
    fit_counts = rng.poisson(0.7, (300, 30)).astype(np.float32)
    for norm in ("l2", None):
        ref = jht.preprocessing.TfidfTransformer(norm=norm).fit(jht.array(fit_counts)).stream_transform(counts)
        got = ht.preprocessing.TfidfTransformer(norm=norm).fit(ht.array(fit_counts)).stream_transform(counts)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# --------------------------------------------------------------------- #
# across ranks                                                          #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("single_pass", [False, True])
def test_staged_hsvd_rank_is_the_same_on_every_rank(ranks, slab, single_pass):
    """Every rank streams the whole operand and holds whole factors; they
    agree with each other and with one process's within the parity
    tolerances (bits are not asked across processes: MKL's float32 products
    may round by a buffer's alignment)."""
    want = ht.linalg.hsvd_rank(staging.HostArray(worker.staged_operand()), R_FINAL, compute_sv=True,
                               single_pass=single_pass)
    results = _result(ranks, f"staged_hsvd_{single_pass}")
    for res in results:
        assert res["splits"] == [None] * 4
        u, s, v, err = res["factors"]
        _assert_factors((u, v, s, err), (want[0], want[2], want[1], want[3]))
        u0, s0, v0, err0 = results[0]["factors"]
        _assert_factors((u, v, s, err), (u0, v0, s0, err0))
