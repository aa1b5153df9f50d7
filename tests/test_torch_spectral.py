"""heat_tpu_torch's graph Laplacian, Spectral, spectral_embedding and the
Lanczos loop on an operator, against heat_tpu, at world size 1 and across
4 ranks.

Both packages get the same NumPy input. Tolerances:

- ``Laplacian`` of one fixed similarity matrix: elementwise within 1e-6 of
  its largest magnitude; from the data through ``rbf``'s product form,
  within 1e-5 (the two packages' float32 ‖x‖² + ‖y‖² − 2x·y round apart);
- ``Spectral``: labels equal up to a permutation of the clusters after the
  same ``seed``, the random stream left in the same state, and the same
  eigengap choice of ``n_clusters``;
- ``spectral_embedding``: Ritz values within 1e-5, the embedding within
  1e-4 up to each column's sign; the Laplacian's product runs the brick
  SpMM (K7 on a card) 1 + m times;
- ``_lanczos_operator``: bit for bit the loop of ``ht.linalg.lanczos``
  with the same start vector, and within 1e-5 of ``heat_tpu``'s
  ``_lanczos_program`` with a ``matvec`` (also through a breakdown, whose
  restart directions are heat_tpu's Threefry normals).

The 4-rank cases are ``_estimator_cases`` of torch_mp_worker.py, in the
session's world of test_torch_distributed.py, against heat_tpu on 4
devices. The ``cuda`` tests need a card and skip here.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu.core.linalg import solver as jsolver
from heat_tpu_torch.core.linalg import solver as tsolver
from heat_tpu_torch.kernels import spmm as ks

import torch_mp_worker as worker
from test_torch_distributed import WORLD, _jcomm, _result, jcomm, ranks  # noqa: F401 (fixtures)


@pytest.fixture(autouse=True)
def _cpu():
    ht.use_device("cpu")


def _close(got, want, tol, scale=None):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    s = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(s, 1e-30))


def _same_partition(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and len(set(zip(a.tolist(), b.tolist()))) == len(set(a.tolist())) == len(set(b.tolist()))


def _blobs(per=30, seed=3):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [6.0, 0.0], [0.0, 6.0]])
    return np.concatenate([c + 0.5 * rng.standard_normal((per, 2)) for c in centers]).astype(np.float32)


# --------------------------------------------------------------------- #
# Laplacian                                                             #
# --------------------------------------------------------------------- #
MODES = {"fully_connected": {}, "upper": {"mode": "eNeighbour", "threshold_key": "upper", "threshold_value": 0.9},
         "lower": {"mode": "eNeighbour", "threshold_key": "lower", "threshold_value": 0.3}}


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("definition", ["simple", "norm_sym"])
def test_laplacian_of_one_similarity_matches_heat_tpu(definition, mode, weighted, split):
    x, _ = worker.iris()
    s = worker.similarity()
    kw = dict(MODES[mode], definition=definition, weighted=weighted)
    want = jht.graph.Laplacian(lambda d: jht.array(s, split=d.split), **kw).construct(jht.array(x, split=split))
    got = ht.graph.Laplacian(lambda d: ht.array(s, split=d.split), **kw).construct(ht.array(x, split=split))
    assert (got.split, got.dtype.__name__, got.shape) == (want.split, want.dtype.__name__, want.shape)
    _close(got.numpy(), want.numpy(), 1e-6)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("definition", ["simple", "norm_sym"])
def test_laplacian_from_rbf_matches_heat_tpu(definition, split):
    x, _ = worker.iris()
    want = jht.graph.Laplacian(lambda d: jht.spatial.rbf(d, sigma=1.0, quadratic_expansion=True),
                               definition=definition).construct(jht.array(x, split=split))
    got = ht.graph.Laplacian(lambda d: ht.spatial.rbf(d, sigma=1.0, quadratic_expansion=True),
                             definition=definition).construct(ht.array(x, split=split))
    _close(got.numpy(), want.numpy(), 1e-5)


def test_laplacian_refusals_match_heat_tpu():
    for lib in (jht, ht):
        with pytest.raises(NotImplementedError):
            lib.graph.Laplacian(lambda d: d, definition="random_walk")
        with pytest.raises(NotImplementedError):
            lib.graph.Laplacian(lambda d: d, mode="kNN")
        with pytest.raises(TypeError):
            lib.graph.Laplacian(lambda d: d).construct(np.ones((3, 3)))


# --------------------------------------------------------------------- #
# Spectral                                                              #
# --------------------------------------------------------------------- #
SPECTRAL = {"iris_rbf": ("iris", {"n_clusters": 3, "gamma": 1.0, "n_lanczos": 40}),
            "blobs_rbf": ("blobs", {"n_clusters": 3, "gamma": 0.5, "n_lanczos": 30}),
            "blobs_eneighbour": ("blobs", {"n_clusters": 3, "gamma": 0.5, "n_lanczos": 30, "laplacian": "eNeighbour",
                                           "boundary": "lower", "threshold": 0.05}),
            "blobs_eigengap": ("blobs", {"gamma": 0.5, "n_lanczos": 30})}


@pytest.mark.parametrize("case, split", [(case, None) for case in SPECTRAL] + [("iris_rbf", 0), ("blobs_rbf", 0)])
def test_spectral_matches_heat_tpu_after_the_same_seed(case, split):
    label, kw = SPECTRAL[case]
    x = worker.iris()[0] if label == "iris" else _blobs()
    models = []
    for lib in (jht, ht):
        lib.random.seed(worker.SPECTRAL_SEED)
        models.append(lib.cluster.Spectral(**kw).fit(lib.array(x, split=split)))
    ref, got = models
    assert got.n_clusters == ref.n_clusters
    assert got.labels_.split == ref.labels_.split
    assert _same_partition(got.labels_.numpy(), ref.labels_.numpy())
    np.testing.assert_array_equal(got.predict(ht.array(x, split=split)).numpy(), got.labels_.numpy())
    assert ht.random.get_state()[1:3] == tuple(jht.random.get_state()[1:3])
    if label == "blobs":
        assert _same_partition(got.labels_.numpy(), np.repeat(np.arange(3), 30))


def test_spectral_refusals_match_heat_tpu():
    x = _blobs()
    for lib in (jht, ht):
        with pytest.raises(NotImplementedError):
            lib.cluster.Spectral(3).fit(lib.array(x, split=1))
        with pytest.raises(RuntimeError):
            lib.cluster.Spectral(3).predict(lib.array(x))
        for kw in ({"metric": "cosine"}, {"laplacian": "kNN"}, {"assign_labels": "discretize"}):
            with pytest.raises(NotImplementedError):
                lib.cluster.Spectral(3, **kw)
    assert ht.cluster.Spectral(3, n_lanczos=12).get_params() == jht.cluster.Spectral(3, n_lanczos=12).get_params()


# --------------------------------------------------------------------- #
# spectral_embedding                                                    #
# --------------------------------------------------------------------- #
def _columns_close(got, want, tol):
    sign = np.sign((got * want).sum(0))
    _close(got * sign, want, tol, scale=1.0)


@pytest.mark.parametrize("normalized, m, form", [(n, m, "csr") for n in (True, False) for m in (None, worker.EMBED_M)]
                         + [(True, None, "dense"), (False, worker.EMBED_M, "dense"),
                            (True, worker.EMBED_M, "dbcsr_f64"), (False, None, "dbcsr_f64")])
def test_spectral_embedding_matches_heat_tpu(normalized, m, form):
    a = worker.graph_adjacency()
    if form == "csr":
        ops = (sp.csr_matrix(a),) * 2
    elif form == "dense":
        ops = (a, a)
    else:
        ops = (jht.sparse.sparse_dbcsr_matrix(sp.csr_matrix(a.astype(np.float64))),
               ht.sparse.sparse_dbcsr_matrix(sp.csr_matrix(a.astype(np.float64))))
    ev_ref, emb_ref = jht.graph.spectral_embedding(ops[0], worker.EMBED_K, m=m, normalized=normalized)
    state = ht.random.get_state()
    ev, emb = ht.graph.spectral_embedding(ops[1], worker.EMBED_K, m=m, normalized=normalized)
    assert ht.random.get_state() == state  # the start vector is numpy's, not the stream's
    assert ev.dtype == np.float32 and emb.dtype == ht.float32 and emb.shape == emb_ref.shape
    assert emb.split == emb_ref.split
    _close(ev, ev_ref, 1e-5, scale=1.0)
    _columns_close(emb.numpy(), emb_ref.numpy(), 1e-4)


def test_spectral_embedding_runs_one_brick_spmm_a_lanczos_step(monkeypatch):
    calls = []
    plain = ks.brick_spmm

    def counting(*args, **kw):
        calls.append(tuple(args[-2].shape))
        return plain(*args, **kw)

    monkeypatch.setattr(ks, "brick_spmm", counting)
    n = worker.EMBED_N
    ht.graph.spectral_embedding(worker.graph_adjacency(), worker.EMBED_K, m=worker.EMBED_M)
    assert calls == [(n, 1)] * (1 + worker.EMBED_M)  # the degrees, then one a step
    calls.clear()
    ht.graph.spectral_embedding(ht.sparse.sparse_dbcsr_matrix(worker.graph_adjacency(), split=0), 2)
    assert len(calls) == 1 + min(n, max(2 * 2 + 1, 20))


def test_spectral_embedding_refusals_match_heat_tpu():
    a = worker.graph_adjacency()
    for lib in (jht, ht):
        with pytest.raises(ValueError):
            lib.graph.spectral_embedding(a[:, :-1], 2)
        with pytest.raises(ValueError):
            lib.graph.spectral_embedding(a, 0)
        with pytest.raises(ValueError):
            lib.graph.spectral_embedding(a, 5, m=4)


# --------------------------------------------------------------------- #
# the Lanczos loop on an operator                                       #
# --------------------------------------------------------------------- #
def _dense_mv(A, v):
    return A @ v


def _symmetric(n, seed):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return ((g + g.T) / 2).astype(np.float32)


def _v0(n, seed=5):
    v = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("n, m", [(40, 12), (40, 40), (9, 1)])
def test_lanczos_operator_is_the_dense_loop_bit_for_bit(n, m):
    a, v0 = _symmetric(n, n), _v0(n)
    V, T = ht.linalg.lanczos(ht.array(a), m, v0=ht.array(v0))
    at = torch.from_numpy(a)
    V2, alpha, beta = tsolver._lanczos_operator(lambda v: at @ v, n, m, torch.from_numpy(v0), torch.float32)
    np.testing.assert_array_equal(V2.numpy(), V.numpy())
    T2 = torch.diag(alpha) + torch.diag(beta[1:], 1) + torch.diag(beta[1:], -1)
    np.testing.assert_array_equal(T2.numpy(), T.numpy())


@pytest.mark.parametrize("n, m, breakdown", [(40, 12, False), (30, 10, True)])
def test_lanczos_operator_matches_heat_tpus_matvec_program(n, m, breakdown):
    """With ``breakdown`` the start vector is an eigenvector of a diagonal
    operator: the first step's new direction is exactly zero, and both
    loops restart from the normal of ``fold_in(key(0x1A2C05), 1)``."""
    jht.zeros(1)  # heat_tpu's 64-bit mode, as its own calls set it
    if breakdown:
        a, v0 = np.diag(np.arange(1.0, n + 1.0)).astype(np.float32), np.eye(n, dtype=np.float32)[0]
    else:
        a, v0 = _symmetric(n, 7), _v0(n)
    prog = jsolver._lanczos_program(n, m, "float32", 1e-10, _dense_mv)
    Vj, aj, bj = (np.asarray(t) for t in prog(jnp.asarray(a), jnp.asarray(v0), jax.random.key(0x1A2C05)))
    at = torch.from_numpy(a)
    V, alpha, beta = tsolver._lanczos_operator(lambda v: at @ v, n, m, torch.from_numpy(v0), torch.float32)
    _close(alpha.numpy(), aj, 1e-5, scale=1.0)
    _close(beta.numpy(), bj, 1e-5, scale=1.0)
    _close(V.numpy(), Vj, 1e-4, scale=1.0)
    assert (beta[1] == 0) == breakdown


# --------------------------------------------------------------------- #
# across 4 ranks                                                        #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["fully_connected", "eNeighbour"])
@pytest.mark.parametrize("definition", ["simple", "norm_sym"])
def test_laplacian_across_ranks_matches_heat_tpu(ranks, jcomm, definition, mode):
    x, _ = worker.iris()
    s = worker.similarity()
    want = jht.graph.Laplacian(lambda d: jht.array(s, split=d.split, comm=jcomm), definition=definition, mode=mode,
                               threshold_key="lower", threshold_value=0.3).construct(jht.array(x, split=0, comm=jcomm))
    L = want.numpy()
    for r, res in enumerate(_result(ranks, f"est_laplacian_{definition}_{mode}")):
        assert res["split"] == 0
        _close(res["global"], L, 1e-6)
        _close(res["local"], L[jcomm.chunk(L.shape, 0, rank=r)[2]], 1e-6, scale=np.abs(L).max())
        # the degrees of the columns: one all-gather of n values; the simple Laplacian none
        assert res["counts"] == ({"all-gather": 1} if definition == "norm_sym" else {})


def test_spectral_across_ranks_matches_heat_tpu(ranks, jcomm):
    x, _ = worker.iris()
    jht.random.seed(worker.SPECTRAL_SEED)
    want = jht.cluster.Spectral(n_clusters=3, gamma=1.0, n_lanczos=worker.SPECTRAL_LANCZOS).fit(
        jht.array(x, split=0, comm=jcomm)).labels_.numpy()
    for res in _result(ranks, "est_spectral"):
        assert res["split"] == 0
        assert _same_partition(res["labels"], want)


def test_spectral_embedding_across_ranks(ranks, jcomm):
    ev_ref, emb_ref = jht.graph.spectral_embedding(worker.graph_adjacency(), worker.EMBED_K, m=worker.EMBED_M)
    every = _result(ranks, "est_embedding_replicated")
    for res in every:
        assert res["split"] is None
        np.testing.assert_array_equal(res["embedding"], every[0]["embedding"])
        _close(res["evals"], ev_ref, 1e-5, scale=1.0)
        _columns_close(res["embedding"], emb_ref.numpy(), 1e-4)
    ev_split, emb_split = jht.graph.spectral_embedding(jht.array(worker.graph_adjacency(), split=0, comm=jcomm),
                                                       worker.EMBED_K)
    for res in _result(ranks, "est_embedding_split"):  # the split operand's slab on each rank
        assert res["split"] == emb_split.split == 0
        _close(res["evals"], ev_split, 1e-5, scale=1.0)
        _columns_close(res["embedding"], emb_split.numpy(), 1e-4)


# --------------------------------------------------------------------- #
# on a card                                                             #
# --------------------------------------------------------------------- #
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    ht.use_device("gpu")


@pytest.mark.cuda
def test_spectral_embedding_on_a_card_launches_k7_once_a_step():
    _card()
    ks.SPMM_LAUNCHES = 0
    ev, emb = ht.graph.spectral_embedding(worker.graph_adjacency(), worker.EMBED_K, m=worker.EMBED_M)
    assert ks.SPMM_LAUNCHES == 1 + worker.EMBED_M
    ev_ref, emb_ref = jht.graph.spectral_embedding(worker.graph_adjacency(), worker.EMBED_K, m=worker.EMBED_M)
    _close(ev, ev_ref, 1e-5, scale=1.0)
    _columns_close(emb.numpy(), emb_ref.numpy(), 1e-4)


@pytest.mark.cuda
def test_spectral_on_a_card_runs_k3_and_r1():
    _card()
    from heat_tpu_torch.cluster import _cuda_assign
    from heat_tpu_torch.kernels import threefry

    ht.random.seed(worker.SPECTRAL_SEED)
    _cuda_assign.ASSIGN_LAUNCHES = threefry.THREEFRY_LAUNCHES = 0
    model = ht.cluster.Spectral(n_clusters=3, gamma=0.5, n_lanczos=30).fit(ht.array(_blobs(), split=0))
    assert _cuda_assign.ASSIGN_LAUNCHES == model._cluster.n_iter_
    assert threefry.THREEFRY_LAUNCHES == 1 + 3  # lanczos's start vector, then k-means++'s k draws
    assert _same_partition(model.labels_.numpy(), np.repeat(np.arange(3), 30))
