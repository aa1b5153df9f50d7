"""heat_tpu_torch's scalers, GaussianNB, Lasso and KNeighborsClassifier
against heat_tpu, at world size 1 and across 4 ranks.

Both packages get the same NumPy input: iris (``heat_tpu/datasets``, read
with NumPy) and random data from a seed. heat_tpu runs on conftest's CPU
mesh, the port on torch's CPU. Tolerances:

- scalers: the fitted statistics, the transform and its inverse within
  1e-6 of the largest magnitude in float32 (1e-12 in float64);
- GaussianNB: θ within 1e-5 relative, probabilities within 1e-5; the
  variances within 1e-5 of the largest E[x²] of a class and feature. The
  port sums in float64; ``heat_tpu``'s one-pass ``E[x²] − E[x]²`` in
  float32 cancels E[x²] down to the variance, so on iris (E[x²] up to 43,
  variances down to 0.01) it sits 1.5e-5 of the largest variance off the
  float64 value, which the port reaches within 1e-6 (held against NumPy's
  float64 statistics);
- Lasso: θ within 1e-4·max|θ| in float32 and 1e-10·max|θ| in float64,
  and the same number of sweeps. On iris in float32 at lam 0.1 the last
  sweeps change θ by about float32's resolution, so heat_tpu's float32
  iterates stop 3 sweeps before the exact ones (the port's float64
  sweeps, and heat_tpu in float64, take 65): there only θ is held;
- KNN: labels exactly, also through a planted distance tie that only the
  (distance, index) order resolves.

The 4-rank cases are ``_estimator_cases`` of torch_mp_worker.py, in the
session's world of test_torch_distributed.py, against heat_tpu on 4
devices: the same tolerances, and the collectives a fit issues (Lasso one
all-reduce, GaussianNB one all-reduce beside the label all-gathers,
RobustScaler one sort). The ``cuda`` tests need a card and skip here.
"""

import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu_torch.classification import kneighborsclassifier as tknn
from heat_tpu_torch.kernels import sort as ks
from heat_tpu_torch.naive_bayes import gaussianNB as tgnb
from heat_tpu_torch.regression import lasso as tlasso

import torch_mp_worker as worker
from test_torch_distributed import WORLD, _jcomm, _result, jcomm, ranks  # noqa: F401 (fixtures)


@pytest.fixture(autouse=True)
def _cpu():
    ht.use_device("cpu")


def _random(shape, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    return (3.0 * rng.standard_normal(shape) + 1.0).astype(dtype)


def _data(label, dtype="float32"):
    if label == "iris":
        return worker.iris()[0].astype(dtype)
    return _random((37, 5), 5, dtype)


def _tol(dtype):
    return 1e-12 if np.dtype(dtype) == np.float64 else 1e-6


def _close(got, want, tol, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    s = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=0, atol=tol * max(s, 1e-30))


# --------------------------------------------------------------------- #
# scalers                                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("label, dtype", [("iris", "float32"), ("random", "float64")])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", worker.EST_SCALERS)
def test_scaler_matches_heat_tpu(name, split, label, dtype):
    a = _data(label, dtype)
    ref = getattr(jht.preprocessing, name)().fit(jht.array(a, split=split))
    got = getattr(ht.preprocessing, name)().fit(ht.array(a, split=split))
    want_attrs, got_attrs = worker.scaler_attrs(ref), worker.scaler_attrs(got)
    assert set(got_attrs) == set(want_attrs)
    for key, want in want_attrs.items():
        assert got_attrs[key].dtype == want.dtype, key
        _close(got_attrs[key], want, _tol(dtype))
    rt, gt = ref.transform(jht.array(a, split=split)), got.transform(ht.array(a, split=split))
    assert (gt.split, gt.dtype.__name__) == (rt.split, rt.dtype.__name__)
    _close(gt.numpy(), rt.numpy(), _tol(dtype))
    if name != "Normalizer":
        back = got.inverse_transform(gt)
        _close(back.numpy(), ref.inverse_transform(rt).numpy(), _tol(dtype))
        _close(back.numpy(), a, 10 * _tol(dtype))


@pytest.mark.parametrize("name", worker.EST_SCALERS)
def test_scaler_of_integers_takes_heat_tpus_types(name):
    a = (_random((23, 4), 8) * 10).astype(np.int32)
    ref = getattr(jht.preprocessing, name)().fit(jht.array(a))
    got = getattr(ht.preprocessing, name)().fit(ht.array(a))
    want_attrs, got_attrs = worker.scaler_attrs(ref), worker.scaler_attrs(got)
    for key, want in want_attrs.items():
        assert got_attrs[key].dtype == want.dtype, key
        _close(got_attrs[key], want, 1e-6)
    rt, gt = ref.transform(jht.array(a)), got.transform(ht.array(a))
    assert gt.dtype.__name__ == rt.dtype.__name__
    _close(gt.numpy(), rt.numpy(), 1e-6)


OPTIONS = {
    "robust_10_90_no_centering": ("RobustScaler", {"quantile_range": (10.0, 90.0), "with_centering": False}),
    "robust_no_scaling": ("RobustScaler", {"with_scaling": False}),
    "standard_no_mean": ("StandardScaler", {"with_mean": False}),
    "standard_no_std": ("StandardScaler", {"with_std": False}),
    "minmax_range_clip": ("MinMaxScaler", {"feature_range": (-2.0, 3.0), "clip": True}),
    "normalizer_l1": ("Normalizer", {"norm": "l1"}),
    "normalizer_max": ("Normalizer", {"norm": "max"}),
}


@pytest.mark.parametrize("split", [None, 1])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_scaler_options_match_heat_tpu(option, split):
    name, kw = OPTIONS[option]
    a, b = _data("random"), _random((11, 5), 9)  # b beyond the fitted range: clip acts
    ref = getattr(jht.preprocessing, name)(**kw).fit(jht.array(a, split=split))
    got = getattr(ht.preprocessing, name)(**kw).fit(ht.array(a, split=split))
    _close(got.transform(ht.array(b, split=split)).numpy(), ref.transform(jht.array(b, split=split)).numpy(), 1e-6)
    assert got.get_params() == ref.get_params()


def test_scaler_refusals_match_heat_tpu():
    for lib in (jht, ht):
        with pytest.raises(ValueError):
            lib.preprocessing.MinMaxScaler(feature_range=(1.0, 0.0))
        with pytest.raises(ValueError):
            lib.preprocessing.RobustScaler(quantile_range=(80.0, 20.0))
        with pytest.raises(NotImplementedError):
            lib.preprocessing.RobustScaler(unit_variance=True)
        with pytest.raises(NotImplementedError):
            lib.preprocessing.Normalizer(norm="l3")
        with pytest.raises(TypeError):
            lib.preprocessing.StandardScaler().fit(np.ones((3, 2)))


def test_robust_scaler_takes_its_three_quantiles_from_one_sort(monkeypatch):
    calls = []
    plain = ks.local_sort

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(ks, "local_sort", counting)
    ht.preprocessing.RobustScaler().fit(ht.array(_data("iris"), split=0))
    assert calls == [(150, 4)]


@pytest.mark.parametrize("shape, axis, dtype", [((5000, 3), 0, "float32"), ((3, 4097), 1, "int32"),
                                                ((4097, 2, 2), 0, "float32"), ((10, 7), 0, "float32")])
def test_sorted_lanes_are_local_sorts_values(monkeypatch, shape, axis, dtype):
    """Lanes longer than SEG_MAX sort as one segment of (lane, value) pairs
    ordered by both: one pair sort, the values of ``local_sort``."""
    x = torch.from_numpy((_random(shape, 14) * 100).astype(dtype))
    if dtype == "float32":
        x.view(-1)[::97] = float("nan")
        x.view(-1)[5] = -0.0
    calls = []
    plain = ks.pair_sort
    monkeypatch.setattr(ks, "pair_sort", lambda *a, **kw: calls.append(kw.get("pay_bytes")) or plain(*a, **kw))
    got, want = ks.sorted_lanes(x, axis), ks.local_sort(x, axis)[0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert calls == ([4] if shape[axis] > ks.SEG_MAX else [])


def test_fit_transform_is_fit_then_transform():
    a = ht.array(_data("random"), split=0)
    for name in worker.EST_SCALERS:
        one = getattr(ht.preprocessing, name)().fit_transform(a).numpy()
        two = getattr(ht.preprocessing, name)().fit(a).transform(a).numpy()
        np.testing.assert_array_equal(one, two)


# --------------------------------------------------------------------- #
# GaussianNB                                                            #
# --------------------------------------------------------------------- #
def _nb_data(label, dtype):
    if label == "iris":
        x, y = worker.iris()
        return x.astype(dtype), y
    rng = np.random.default_rng(12)
    y = rng.integers(0, 4, 90)
    x = (rng.standard_normal((90, 6)) + y[:, None] * np.arange(1, 7)).astype(dtype)
    return x, y


def _nb_close(got, ref, dtype):
    tol = 1e-12 if dtype == "float64" else 1e-5
    theta, var = ref.theta_.numpy(), ref.var_.numpy()
    _close(got.theta_.numpy(), theta, tol)
    _close(got.var_.numpy(), var, tol, scale=np.abs(var + theta.astype(np.float64) ** 2).max())
    for name in ("class_count_", "class_prior_", "classes_"):
        got_a, want = getattr(got, name).numpy(), getattr(ref, name).numpy()
        assert got_a.dtype == want.dtype, name
        _close(got_a, want, tol)
    assert got.epsilon_ == pytest.approx(ref.epsilon_, rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("label", ["iris", "random"])
def test_gaussian_nb_matches_heat_tpu(label, split, dtype):
    x, y = _nb_data(label, dtype)
    ref = jht.naive_bayes.GaussianNB().fit(jht.array(x, split=split), jht.array(y, split=split))
    got = ht.naive_bayes.GaussianNB().fit(ht.array(x, split=split), ht.array(y, split=split))
    _nb_close(got, ref, dtype)
    tol = 1e-12 if dtype == "float64" else 1e-5
    q_ref, q_got = jht.array(x, split=split), ht.array(x, split=split)
    p = got.predict_proba(q_got)
    assert (p.split, p.dtype.__name__) == (split, dtype)
    _close(p.numpy(), ref.predict_proba(q_ref).numpy(), tol, scale=1.0)
    np.testing.assert_array_equal(got.predict(q_got).numpy(), ref.predict(q_ref).numpy())
    # each (x - θ)²/var term carries heat_tpu's variance rounding (up to 6e-4 of iris's smallest variance)
    lp, lp_ref = got.predict_log_proba(q_got).numpy(), ref.predict_log_proba(q_ref).numpy()
    np.testing.assert_allclose(lp, lp_ref, rtol=1e-4 if dtype == "float32" else 1e-10, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gaussian_nb_predicts_as_heat_tpu_from_the_same_parameters(dtype):
    """The joint log-likelihood's arithmetic alone: the port's model given
    heat_tpu's fitted θ, var and priors predicts heat_tpu's
    log-probabilities within 1e-5 relative (float32 sums over 4 features
    in other orders)."""
    x, y = _nb_data("iris", dtype)
    ref = jht.naive_bayes.GaussianNB().fit(jht.array(x), jht.array(y))
    got = ht.naive_bayes.GaussianNB().fit(ht.array(x), ht.array(y))
    for name in ("theta_", "var_", "class_prior_", "classes_"):
        setattr(got, name, ht.array(getattr(ref, name).numpy()))
    want = ref.predict_log_proba(jht.array(x)).numpy()
    np.testing.assert_allclose(got.predict_log_proba(ht.array(x)).numpy(), want,
                               rtol=1e-5 if dtype == "float32" else 1e-12, atol=1e-5)
    np.testing.assert_array_equal(got.predict(ht.array(x)).numpy(), ref.predict(jht.array(x)).numpy())


def test_gaussian_nb_in_float64_equals_numpys_statistics():
    x, y = worker.iris()
    got = ht.naive_bayes.GaussianNB().fit(ht.array(x), ht.array(y))
    x64 = x.astype(np.float64)
    means = np.stack([x64[y == c].mean(0) for c in range(3)])
    var = np.stack([x64[y == c].var(0) for c in range(3)]) + 1e-9 * x64.var(0).max()
    _close(got.theta_.numpy(), means, 1e-6)
    _close(got.var_.numpy(), var, 1e-6)


def test_gaussian_nb_streaming_merge_matches_heat_tpu():
    x, y = worker.iris()
    models = []
    for lib in (jht, ht):
        m = lib.naive_bayes.GaussianNB()
        m.partial_fit(lib.array(x[::2]), lib.array(y[::2]), classes=lib.array(np.arange(3)))
        m.partial_fit(lib.array(x[1::2]), lib.array(y[1::2]))
        models.append(m)
    _nb_close(models[1], models[0], "float32")
    _close(models[1].predict_proba(ht.array(x)).numpy(), models[0].predict_proba(jht.array(x)).numpy(), 1e-5, 1.0)


def test_gaussian_nb_priors_and_weights_match_heat_tpu():
    x, y = worker.iris()
    w = np.linspace(0.5, 2.0, 150).astype(np.float32)
    for kw, fit_kw in (({"priors": np.array([0.2, 0.3, 0.5])}, {}), ({}, {"sample_weight": w})):
        ref = jht.naive_bayes.GaussianNB(**kw).fit(jht.array(x), jht.array(y),
                                                   **{k: jht.array(v) for k, v in fit_kw.items()})
        got = ht.naive_bayes.GaussianNB(**kw).fit(ht.array(x), ht.array(y), **{k: ht.array(v) for k, v in fit_kw.items()})
        _nb_close(got, ref, "float32")
        _close(got.predict_proba(ht.array(x)).numpy(), ref.predict_proba(jht.array(x)).numpy(), 1e-5, 1.0)
    for priors, err in (([0.5, 0.5], "match"), ([0.5, 0.6, -0.1], "non-negative"), ([0.2, 0.2, 0.2], "sum")):
        with pytest.raises(ValueError, match=err):
            ht.naive_bayes.GaussianNB(priors=np.array(priors)).fit(ht.array(x), ht.array(y))
    with pytest.raises(RuntimeError):
        ht.naive_bayes.GaussianNB().predict(ht.array(x))


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("kw", [{"axis": 1}, {"axis": 0, "keepdims": True}, {"axis": None},
                                {"axis": 1, "b": "weights", "return_sign": True}])
def test_logsumexp_matches_heat_tpu(kw, split):
    a = _random((9, 4), 13)
    kw = dict(kw)
    outs = []
    for lib in (jht, ht):
        k = dict(kw)
        if k.get("b") == "weights":
            k["b"] = np.linspace(-1.0, 1.0, 36).reshape(9, 4).astype(np.float32)
        outs.append(lib.naive_bayes.GaussianNB().logsumexp(lib.array(a, split=split), **k))
    ref, got = outs
    for r, g in zip(ref if isinstance(ref, tuple) else (ref,), got if isinstance(got, tuple) else (got,)):
        assert (g.shape, g.split) == (r.shape, r.split)
        _close(g.numpy(), r.numpy(), 1e-6)


def test_joint_log_likelihood_runs_in_row_blocks(monkeypatch):
    x, y = worker.iris()
    model = ht.naive_bayes.GaussianNB().fit(ht.array(x), ht.array(y))
    whole = model.predict_log_proba(ht.array(x)).numpy()
    monkeypatch.setattr(tgnb, "_BLOCK", 7)
    np.testing.assert_array_equal(model.predict_log_proba(ht.array(x)).numpy(), whole)
    again = ht.naive_bayes.GaussianNB().fit(ht.array(x), ht.array(y))
    _close(again.var_.numpy(), model.var_.numpy(), 1e-6)


# --------------------------------------------------------------------- #
# Lasso                                                                 #
# --------------------------------------------------------------------- #
def _lasso_data(label, dtype):
    if label == "iris":
        x = worker.iris()[0]
        return x[:, 1:].astype(dtype), x[:, 0].astype(dtype)
    x, y = worker.lasso_data()
    return x.astype(dtype), y.astype(dtype)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("lam", [0.01, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("label", ["iris", "random"])
def test_lasso_matches_heat_tpu(label, dtype, lam, split):
    x, y = _lasso_data(label, dtype)
    ref = jht.regression.Lasso(lam=lam).fit(jht.array(x, split=split), jht.array(y, split=split))
    got = ht.regression.Lasso(lam=lam).fit(ht.array(x, split=split), ht.array(y, split=split))
    theta = ref.theta.numpy()
    assert got.theta.numpy().dtype == theta.dtype and got.theta.shape == ref.theta.shape
    _close(got.theta.numpy(), theta, 1e-10 if dtype == "float64" else 1e-4)
    if not (label == "iris" and dtype == "float32" and lam == 0.1):  # float32 rounding sets heat_tpu's count there
        assert got.n_iter == ref.n_iter
    pred, pred_ref = got.predict(ht.array(x, split=split)), ref.predict(jht.array(x, split=split))
    assert pred.split == pred_ref.split
    _close(pred.numpy(), pred_ref.numpy(), 1e-9 if dtype == "float64" else 1e-4)
    assert got.rmse(ht.array(y, split=split), pred) == pytest.approx(ref.rmse(jht.array(y, split=split), pred_ref),
                                                                     rel=1e-4)
    _close(got.coef_.numpy(), ref.coef_.numpy(), 1e-10 if dtype == "float64" else 1e-4, scale=np.abs(theta).max())
    _close(got.intercept_.numpy(), ref.intercept_.numpy(), 1e-10 if dtype == "float64" else 1e-4,
           scale=np.abs(theta).max())


def test_lasso_reads_x_once_and_the_host_once_a_sweep(monkeypatch):
    calls = []
    plain = tlasso._gram
    monkeypatch.setattr(tlasso, "_gram", lambda *a: calls.append(a[0].shape) or plain(*a))
    x, y = worker.lasso_data()
    tlasso.HOST_READS = 0
    model = ht.regression.Lasso(lam=0.05).fit(ht.array(x, split=0), ht.array(y, split=0))
    assert calls == [x.shape] and tlasso.HOST_READS == model.n_iter
    monkeypatch.setattr(tlasso, "_BLOCK", 17)
    blocked = ht.regression.Lasso(lam=0.05).fit(ht.array(x), ht.array(y))
    _close(blocked.theta.numpy(), model.theta.numpy(), 1e-5)


def test_lasso_soft_threshold_and_refusals_match_heat_tpu():
    for lib in (jht, ht):
        m = lib.regression.Lasso(lam=0.5)
        assert [m.soft_threshold(v) for v in (-2.0, 0.1, 3.0)] == [-1.5, 0.0, 2.5]
        st = m.soft_threshold(lib.array(np.array([-2.0, 0.1, 3.0], np.float32)))
        np.testing.assert_array_equal(st.numpy(), [-1.5, 0.0, 2.5])
        with pytest.raises(ValueError):
            m.fit(lib.array(np.ones(4, np.float32)), lib.array(np.ones(4, np.float32)))
        with pytest.raises(ValueError):
            m.fit(lib.array(np.ones((4, 2), np.float32)), lib.array(np.ones((4, 2), np.float32)))
        with pytest.raises(RuntimeError):
            m.predict(lib.array(np.ones((4, 2), np.float32)))
        m.lam = 0.25
        assert m.lam == 0.25 and m.coef_ is None and m.intercept_ is None


# --------------------------------------------------------------------- #
# KNeighborsClassifier                                                  #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("k", [1, 3, 5, 10])
def test_knn_matches_heat_tpu(k, split, dtype):
    x, y = worker.iris()
    x = x.astype(dtype)
    q = (x[::2] + 0.05 * np.random.default_rng(k).standard_normal(x[::2].shape)).astype(dtype)
    ref = jht.classification.KNeighborsClassifier(k).fit(jht.array(x, split=split), jht.array(y, split=split))
    got = ht.classification.KNeighborsClassifier(k).fit(ht.array(x, split=split), ht.array(y, split=split))
    labels = got.predict(ht.array(q, split=split))
    want = ref.predict(jht.array(q, split=split))
    assert (labels.split, labels.dtype.__name__) == (want.split, want.dtype.__name__)
    np.testing.assert_array_equal(labels.numpy(), want.numpy())


def test_knn_resolves_a_distance_tie_by_the_lower_index():
    xt, yt, xq = worker.knn_ties()
    want = jht.classification.KNeighborsClassifier(3).fit(jht.array(xt), jht.array(yt)).predict(jht.array(xq))
    got = ht.classification.KNeighborsClassifier(3).fit(ht.array(xt), ht.array(yt)).predict(ht.array(xq))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.numpy()[0] == 2  # the tie's lowest index (row 1, label 2) joins row 0


def test_knn_one_hot_labels_custom_metric_and_encoding_match_heat_tpu(monkeypatch):
    x, y = worker.iris()
    onehot = np.eye(3, dtype=np.float32)[y]
    for kw in ({}, {"effective_metric_": "manhattan"}):
        models = []
        for lib in (jht, ht):
            k = {"effective_metric_": lib.spatial.manhattan} if kw else {}
            models.append(lib.classification.KNeighborsClassifier(4, **k).fit(lib.array(x, split=0),
                                                                              lib.array(onehot, split=0)))
        np.testing.assert_array_equal(models[1].predict(ht.array(x[1::3], split=0)).numpy(),
                                      models[0].predict(jht.array(x[1::3], split=0)).numpy())
    enc = ht.classification.KNeighborsClassifier.one_hot_encoding(ht.array(y, split=0))
    ref = jht.classification.KNeighborsClassifier.one_hot_encoding(jht.array(y, split=0))
    assert (enc.split, enc.dtype.__name__, enc.shape) == (ref.split, ref.dtype.__name__, ref.shape)
    np.testing.assert_array_equal(enc.numpy(), ref.numpy())
    model = ht.classification.KNeighborsClassifier(5).fit(ht.array(x), ht.array(y))
    whole = model.predict(ht.array(x)).numpy()
    monkeypatch.setattr(tknn, "_QUERY_BLOCK", 7)
    np.testing.assert_array_equal(model.predict(ht.array(x)).numpy(), whole)
    with pytest.raises(RuntimeError):
        ht.classification.KNeighborsClassifier().predict(ht.array(x))
    with pytest.raises(ValueError):
        ht.classification.KNeighborsClassifier().fit(ht.array(x), ht.array(np.zeros((2, 2, 2))))


# --------------------------------------------------------------------- #
# across 4 ranks                                                        #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("name", worker.EST_SCALERS)
def test_scalers_across_ranks_match_heat_tpu(ranks, jcomm, name, split):
    x, _ = worker.iris()
    ref = getattr(jht.preprocessing, name)().fit(jht.array(x, split=split, comm=jcomm))
    rt = ref.transform(jht.array(x, split=split, comm=jcomm))
    want_attrs = worker.scaler_attrs(ref)
    for res in _result(ranks, f"est_{name}_{split}"):
        assert set(res["attrs"]) == set(want_attrs)
        for key, want in want_attrs.items():
            _close(res["attrs"][key], want, 1e-6)
        assert res["split"] == split
        _close(res["global"], rt.numpy(), 1e-6)
        if res["inverse"] is not None:
            _close(res["inverse"], ref.inverse_transform(rt).numpy(), 1e-6)
    if name == "RobustScaler" and split == 0:  # one sort for the median and both quantiles
        assert all(res["counts"].get("all-gather") == 1 for res in _result(ranks, "est_RobustScaler_0"))


@pytest.mark.parametrize("case", ["est_gnb_0", "est_gnb_whole_labels", "est_gnb_weights"])
def test_gaussian_nb_across_ranks_matches_heat_tpu(ranks, jcomm, case):
    x, y = worker.iris()
    kw = {}
    if case == "est_gnb_weights":
        kw["sample_weight"] = jht.array(np.linspace(0.5, 2.0, 150, dtype=np.float32), split=0, comm=jcomm)
    ref = jht.naive_bayes.GaussianNB().fit(jht.array(x, split=0, comm=jcomm), jht.array(y, split=0, comm=jcomm), **kw)
    proba = ref.predict_proba(jht.array(x, split=0, comm=jcomm)).numpy()
    theta, var = ref.theta_.numpy(), ref.var_.numpy()
    for res in _result(ranks, case):
        _close(res["theta"], theta, 1e-5)
        _close(res["var"], var, 1e-5, scale=np.abs(var + theta.astype(np.float64) ** 2).max())
        _close(res["count"], ref.class_count_.numpy(), 1e-6)
        _close(res["prior"], ref.class_prior_.numpy(), 1e-6)
        np.testing.assert_array_equal(res["classes"], ref.classes_.numpy())
        assert res["epsilon"] == pytest.approx(ref.epsilon_, rel=1e-5)
        _close(res["proba"], proba, 1e-5, scale=1.0)
        np.testing.assert_array_equal(res["predict"], ref.predict(jht.array(x, comm=jcomm)).numpy())
        assert res["counts"].get("all-reduce") == 1  # counts, sums, squares and the features' moments
        assert res["counts"].get("all-gather", 0) == (0 if case == "est_gnb_whole_labels" else 2)  # the classes


def test_gaussian_nb_streaming_across_ranks_matches_heat_tpu(ranks, jcomm):
    x, y = worker.iris()
    ref = jht.naive_bayes.GaussianNB()
    ref.partial_fit(jht.array(x[::2], split=0, comm=jcomm), jht.array(y[::2], split=0, comm=jcomm),
                    classes=jht.array(np.arange(3), comm=jcomm))
    ref.partial_fit(jht.array(x[1::2], split=0, comm=jcomm), jht.array(y[1::2], split=0, comm=jcomm))
    theta, var = ref.theta_.numpy(), ref.var_.numpy()
    for res in _result(ranks, "est_gnb_partial"):
        _close(res["theta"], theta, 1e-5)
        _close(res["var"], var, 1e-5, scale=np.abs(var + theta.astype(np.float64) ** 2).max())
        _close(res["count"], ref.class_count_.numpy(), 1e-6)
        _close(res["proba"], ref.predict_proba(jht.array(x, comm=jcomm)).numpy(), 1e-5, scale=1.0)


@pytest.mark.parametrize("case, y_split", [("est_lasso_0", 0), ("est_lasso_whole_y", None)])
def test_lasso_across_ranks_matches_heat_tpu(ranks, jcomm, case, y_split):
    x, y = worker.lasso_data()
    ref = jht.regression.Lasso(lam=0.05).fit(jht.array(x, split=0, comm=jcomm), jht.array(y, split=y_split, comm=jcomm))
    theta = ref.theta.numpy()
    for res in _result(ranks, case):
        _close(res["theta"], theta, 1e-4)
        assert res["n_iter"] == ref.n_iter
        assert res["counts"] == {"all-reduce": 1}  # the Gram, Xᵀy and nothing else
        assert res["predict_split"] == 0
        _close(res["predict"], ref.predict(jht.array(x, split=0, comm=jcomm)).numpy(), 1e-4)
        assert res["rmse"] == pytest.approx(float(np.sqrt(np.mean((res["predict"] - y) ** 2))), rel=1e-5)


@pytest.mark.parametrize("k", worker.KNN_KS)
def test_knn_across_ranks_matches_heat_tpu(ranks, jcomm, k):
    x, y = worker.iris()
    ref = jht.classification.KNeighborsClassifier(k).fit(jht.array(x, split=0, comm=jcomm),
                                                         jht.array(y, split=0, comm=jcomm))
    want = ref.predict(jht.array(x[::3], split=0, comm=jcomm)).numpy()
    for res in _result(ranks, f"est_knn_iris_{k}"):
        np.testing.assert_array_equal(res["labels"], want)
        assert res["split"] == 0 and res["counts"] == {"all-gather": 2}  # the training rows and their labels


def test_knn_tie_across_ranks_takes_the_lowest_global_index(ranks, jcomm):
    xt, yt, xq = worker.knn_ties()
    want = jht.classification.KNeighborsClassifier(3).fit(jht.array(xt, split=0, comm=jcomm),
                                                          jht.array(yt, split=0, comm=jcomm))
    labels = want.predict(jht.array(xq, split=0, comm=jcomm)).numpy()
    for res in _result(ranks, "est_knn_ties"):
        np.testing.assert_array_equal(res["labels"], labels)
        assert res["labels"][0] == 2
        np.testing.assert_array_equal(res["one_hot"], np.eye(3, dtype=np.float32)[yt])


# --------------------------------------------------------------------- #
# on a card                                                             #
# --------------------------------------------------------------------- #
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    ht.use_device("gpu")


@pytest.mark.cuda
def test_robust_scaler_on_a_card_sorts_with_k4():
    _card()
    a = _random((5000, 16), 21)  # lanes longer than SEG_MAX: one K4 pair sort
    ks.SORT_LAUNCHES = 0
    got = ht.preprocessing.RobustScaler().fit(ht.array(a, split=0))
    assert ks.SORT_LAUNCHES >= 1
    want = np.percentile(a, [50.0, 25.0, 75.0], axis=0)
    _close(got.center_.numpy(), want[0], 1e-6)
    _close(got.iqr_.cpu().numpy(), want[2] - want[1], 1e-5)


@pytest.mark.cuda
def test_gaussian_nb_predict_on_a_card_holds_no_n_by_c_by_f_tensor():
    _card()
    rng = np.random.default_rng(22)
    y = rng.integers(0, 8, 1 << 18)
    x = (rng.standard_normal((1 << 18, 64)) + y[:, None]).astype(np.float32)
    model = ht.naive_bayes.GaussianNB().fit(ht.array(x, split=0), ht.array(y, split=0))
    X = ht.array(x, split=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    labels = model.predict(X)
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= 3 * x.nbytes  # an (n, C, F) broadcast would take 8 x X
    cpu = ht.naive_bayes.GaussianNB()
    ht.use_device("cpu")
    cpu.fit(ht.array(x), ht.array(y))
    assert (labels.numpy() == cpu.predict(ht.array(x)).numpy()).mean() > 0.9999
