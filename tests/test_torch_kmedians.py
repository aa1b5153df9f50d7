"""KMedians and KMedoids of heat_tpu_torch on operands split across ranks,
against heat_tpu, and the exact cross-rank median under them.

- the 4-rank gloo world of test_torch_distributed.py (the cases of
  ``_kmedians_cases`` in torch_mp_worker.py, run once per pytest run)
  against heat_tpu on ``MeshCommunication(devices=jax.devices()[:4])``:
  both estimators on split-0 and split-1 operands, ``"random"`` and
  ``++`` seeding with a ``random_state``, on ragged shards whose last
  rank holds no row and on one sorted by cluster (a cluster empty on some
  ranks): labels equal, centers within 1e-6 relative (KMedoids'
  centers are rows of the data, so equal), ``n_iter_`` equal, centers
  equal on every rank;
- one process: ``_cluster_medians`` against numpy's ``nanmedian`` of each
  cluster's rows, bit for bit, in float32, float64 and float16, with NaN
  values and empty clusters; its all-reduces (one for the counts, then
  one for each two bits of the key) and the one K4 pair sort a step on the port's
  plain route; ``_nearest_members``'s first index on ties.
"""

import warnings

import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu_torch.cluster import _kcluster
from heat_tpu_torch.kernels import sort as ks

import torch_mp_worker as worker
from test_torch_distributed import WORLD, _jcomm, _result, jcomm, ranks  # noqa: F401 (fixtures)


@pytest.fixture(autouse=True)
def _cpu():
    ht.use_device("cpu")


# --------------------------------------------------------------------- #
# the 4-rank world                                                      #
# --------------------------------------------------------------------- #
_REFERENCE = {}


def _reference(est, label, init):
    """heat_tpu's fit on the split-0 operand over 4 devices: (labels,
    centers, n_iter_). Its fit is one program whatever the operand's
    split, so the port's split-1 fits are held against it too."""
    key = (est, label, init)
    if key not in _REFERENCE:
        ref = getattr(jht.cluster, est)(worker.KM_K, init=init, random_state=7)
        ref.fit(jht.array(worker.kmd_data(label), split=0, comm=_jcomm()))
        _REFERENCE[key] = (ref.labels_.numpy(), ref.cluster_centers_.numpy(), ref.n_iter_)
    return _REFERENCE[key]


@pytest.mark.parametrize("init", worker.KMD_INITS)
@pytest.mark.parametrize("label", list(worker.KMD_ROWS))
@pytest.mark.parametrize("est", ["KMedians", "KMedoids"])
def test_fit_across_ranks_matches_heat_tpu(ranks, jcomm, est, label, init):
    data = worker.kmd_data(label)
    labels, want, n_iter = _reference(est, label, init)
    for res in (res for split in (0, 1) for res in _result(ranks, f"kmd_{est}_{label}_{split}_{init}")):
        np.testing.assert_array_equal(res["labels"], labels)
        assert res["labels_split"] == 0 and res["n_iter"] == n_iter
        np.testing.assert_allclose(res["centers"], want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
        if est == "KMedoids":  # centers are rows of the data
            assert all((data == c).all(axis=1).any() for c in res["centers"])
        assert all(np.array_equal(res["every"][q], res["every"][0]) for q in range(WORLD))


def test_a_cluster_empty_on_some_ranks_and_a_rank_without_rows_are_served(ranks, jcomm):
    (label, n), = worker.KMD_ROWS.items()
    lab = np.sort(np.arange(n) % worker.KM_K)  # the blob of each row of kmd_data(label)
    per_rank = [set(lab[jcomm.chunk((n,), 0, rank=q)[2][0]]) for q in range(WORLD)]
    assert any(0 < len(s) < worker.KM_K for s in per_rank) and not per_rank[-1]  # the operand does what it says
    for res in _result(ranks, f"kmd_KMedians_{label}_0_random"):
        assert np.isfinite(res["centers"]).all()


# --------------------------------------------------------------------- #
# one process                                                           #
# --------------------------------------------------------------------- #
def _median_reference(a, lab, k):
    out = np.full((k, a.shape[1]), np.nan)
    for i in range(k):
        if (lab == i).any():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                out[i] = np.nanmedian(a[lab == i].astype(np.float64), axis=0)
    return out


@pytest.mark.parametrize("n", [0, 1, 2, 9, 64])
@pytest.mark.parametrize("dtype", ["float32", "float64", "float16"])
def test_cluster_medians_are_exact(dtype, n):
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((n, 5)) * 10.0 ** rng.integers(-3, 4, (n, 5))).astype(dtype)
    if n > 8:
        a[3, 2] = np.nan
        a[rng.random(n) < 0.5, 4] = np.nan
        a[:4, 1] = -0.0
    lab = rng.integers(0, 4, n)
    med, sizes = _kcluster._cluster_medians(torch.from_numpy(a), torch.from_numpy(lab), 4, _kcluster._Rows(None, [n]))
    np.testing.assert_array_equal(sizes.numpy(), np.bincount(lab, minlength=4))
    ref = _median_reference(a, lab, 4)
    for i in range(4):
        if sizes[i]:
            # the two order statistics are exact; their mean rounds once in the data's type
            np.testing.assert_array_equal(med[i].numpy(), ref[i].astype(dtype))


def test_cluster_medians_take_one_pair_sort_and_a_count_a_bit():
    a = torch.from_numpy(np.random.default_rng(1).standard_normal((50, 3)).astype(np.float32))
    lab = torch.from_numpy(np.arange(50) % 4)
    calls = []

    class Counting(_kcluster._Rows):
        def allreduce(self, t, op="sum"):
            calls.append(tuple(t.shape))
            return t

    sorts = []
    real = ks.pair_sort
    ks.pair_sort = lambda *a, **kw: sorts.append(kw.get("pay_bytes")) or real(*a, **kw)
    try:
        _kcluster._cluster_medians(a, lab, 4, Counting(None, [50]))
    finally:
        ks.pair_sort = real
    assert sorts == [4]
    assert calls == [(4 * 3 + 4,)] + [(4, 3, 2, 3)] * 16  # the counts, then two key bits a round


def test_nearest_members_take_the_first_index_on_ties():
    arr = torch.tensor([[1.0, 0.0], [0.0, 1.0], [5.0, 5.0], [0.0, 1.0]])
    lab = torch.tensor([0, 0, 1, 1])
    med = torch.tensor([[0.5, 0.5], [0.0, 1.0]])
    got = _kcluster._nearest_members(arr, lab, med, _kcluster._Rows(None, [4]))
    np.testing.assert_array_equal(got.numpy(), [[1.0, 0.0], [0.0, 1.0]])
