"""heat_tpu_torch.graph.pagerank against heat_tpu.graph.pagerank at world
size 1, on the random digraphs of tests/test_graph.py.

Both build the same float32 transition matrix on the host and run the
same float32 iteration; their SpMV sums, the dangling mass and the l1
delta run in other orders. So the ranks agree within 1e-6 (the limit of
tests/test_graph.py against its float64 oracle), and the iteration counts
and convergence flags agree exactly where ``tol`` (1e-5, 1e-6) lies well
above the float32 noise of the delta, about n ulps of the largest rank
(1e-7 at these sizes): there a rounding cannot move the step at which
the delta falls under ``tol``. Nearer that noise, at tol = 1e-8, both
converge to the float64 oracle within 1e-6, but which step first dips
under tol is a matter of rounding and may differ by a few.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu.graph import pagerank as jpagerank
from heat_tpu_torch.graph import PageRankResult, pagerank
from heat_tpu_torch.kernels import spmm as ks


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])  # heat_tpu turns x64 on for the CPU with its first array


def _random_digraph(n=60, avg_deg=5, seed=0):
    """tests/test_graph.py's graph: uniform random edges, self-loops
    dropped, duplicates summed."""
    rng = np.random.default_rng(seed)
    e = n * avg_deg
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = src != dst
    A = sp.csr_matrix((np.ones(int(keep.sum()), np.float32), (src[keep], dst[keep])), shape=(n, n))
    A.sum_duplicates()
    return A


def _oracle(A, alpha=0.85, tol=1e-12, max_iter=1000):
    """float64 dense power iteration with uniform dangling teleport."""
    n = A.shape[0]
    A = A.toarray().astype(np.float64)
    outdeg = A.sum(axis=1)
    dangling = outdeg == 0
    M = np.divide(A, outdeg[:, None], out=np.zeros_like(A), where=~dangling[:, None]).T
    r = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        r_new = alpha * (M @ r + r[dangling].sum() / n) + (1 - alpha) / n
        done = np.abs(r_new - r).sum() < tol
        r = r_new
        if done:
            break
    return r / r.sum()


def _assert_same_result(got, ref):
    assert isinstance(got, PageRankResult)
    assert got.iterations == ref.iterations and got.converged == ref.converged
    assert got.ranks.split == ref.ranks.split and got.ranks.dtype is ht.float32
    np.testing.assert_allclose(got.ranks.numpy(), ref.ranks.numpy(), rtol=0, atol=1e-6)
    assert abs(float(got.ranks.numpy().sum()) - 1.0) < 1e-6


GRAPHS = [(60, 5, 1), (200, 8, 2), (1000, 4, 3), (2048, 16, 4)]


@pytest.mark.parametrize("tol", [1e-5, 1e-6])
@pytest.mark.parametrize("n, deg, seed", GRAPHS)
def test_pagerank_matches_heat_tpu(n, deg, seed, tol):
    A = _random_digraph(n, deg, seed)
    _assert_same_result(pagerank(A, tol=tol), jpagerank(A, tol=tol))


@pytest.mark.parametrize("n, deg, seed", GRAPHS)
def test_pagerank_reaches_the_float64_oracle(n, deg, seed):
    A = _random_digraph(n, deg, seed)
    got, ref = pagerank(A, tol=1e-8), jpagerank(A, tol=1e-8)
    assert got.converged and ref.converged
    np.testing.assert_allclose(got.ranks.numpy(), _oracle(A), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.ranks.numpy(), ref.ranks.numpy(), rtol=0, atol=1e-6)


def test_pagerank_runs_one_spmm_per_iteration_through_the_brick_wrapper(monkeypatch):
    calls = []
    wrapper = ks.brick_spmm

    def counting(*args):
        calls.append(args[-2].shape)
        return wrapper(*args)

    monkeypatch.setattr(ks, "brick_spmm", counting)
    res = pagerank(_random_digraph(seed=5))
    assert len(calls) == res.iterations and all(shape == (60, 1) for shape in calls)


def test_dangling_sinks():
    n = 40
    A = _random_digraph(n=n, seed=2).tolil()
    A[n - 3 :, :] = 0  # three dangling sinks
    A = A.tocsr()
    A.eliminate_zeros()
    _assert_same_result(pagerank(A, tol=1e-6), jpagerank(A, tol=1e-6))
    np.testing.assert_allclose(pagerank(A, tol=1e-8).ranks.numpy(), _oracle(A), rtol=0, atol=1e-6)


def test_adjacency_forms_agree():
    A = _random_digraph(seed=3)
    forms = [
        A,
        ht.sparse.sparse_dbcsr_matrix(A, split=0),
        ht.sparse.sparse_csr_matrix(A, split=0),
        ht.array(A.toarray(), split=0),
        A.toarray(),
    ]
    results = [pagerank(f, tol=1e-6) for f in forms]
    for res in results[1:]:
        assert res.iterations == results[0].iterations
        np.testing.assert_allclose(res.ranks.numpy(), results[0].ranks.numpy(), rtol=0, atol=1e-7)
    _assert_same_result(results[0], jpagerank(A, tol=1e-6))


@pytest.mark.parametrize("split", [0, None])
def test_ranks_split(split):
    A = _random_digraph(n=64, seed=4)
    got = pagerank(A, tol=1e-6, split=split)
    assert got.ranks.split == split
    _assert_same_result(got, jpagerank(A, tol=1e-6, split=split))


def test_max_iter_tol_and_errors():
    A = _random_digraph(seed=5)
    got, ref = pagerank(A, tol=1e-14, max_iter=2), jpagerank(A, tol=1e-14, max_iter=2)
    assert got.iterations == 2 and not got.converged and got.delta > 1e-14
    _assert_same_result(got, ref)
    assert abs(got.delta - ref.delta) <= 1e-6 * ref.delta
    for fn in (pagerank, jpagerank):
        for alpha in (0.0, 1.0, 1.5):
            with pytest.raises(ValueError):
                fn(A, alpha=alpha)
        with pytest.raises(ValueError):
            fn(sp.csr_matrix((3, 4), dtype=np.float32))


def test_ranks_land_on_the_matrix_device():
    res = pagerank(_random_digraph(seed=6), device="cpu")
    assert res.ranks.device == ht.cpu and res.ranks.larray.device == torch.device("cpu")
