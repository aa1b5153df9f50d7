"""heat_tpu_torch's k-clustering (KMeans, KMedians, KMedoids) and kernel
K3 against heat_tpu at world size 1.

Here, without a card, K3's plain version is held against heat_tpu's
Pallas kernel in interpret mode and against its jnp Lloyd step. Counts
agree exactly (the labels agree on these inputs); sums within relative
Frobenius error 1e-5 and inertia within relative error 2e-5, the rounding
of float32 sums in two orders over up to 20000 rows. The kernel itself
runs only on a card: the ``cuda`` test compares it with the plain version
there.

Fits from the same initial centers agree with heat_tpu: centers within
1e-5, labels and iteration counts equal, inertia within relative error
1e-5; medians and medoids within 1e-6. Seeded inits draw heat_tpu's
Threefry stream in both packages, so a seeded fit starts from heat_tpu's
centers (kmeans++ and random, each estimator), a heat_tpu model's
``rng_state`` carried across draws heat_tpu's next init, and
``create_spherical_dataset`` gives heat_tpu's points.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu.cluster import _pallas
from heat_tpu.cluster import kmeans as jkmeans
from heat_tpu_torch.cluster import _cuda_assign as ca
from heat_tpu_torch.cluster import kmeans as tkmeans
from heat_tpu_torch.core import interop

K3_SHAPES = [(1000, 64, 8), (1003, 16, 4), (64, 8, 3), (20000, 3, 4)]
BLOCK = 64  # rows per ground-truth blob


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _blobs(seed=0, per=BLOCK, radius=1.0, offset=4.0):
    """Four 3-D blobs of the given radius at s·offset (s = −2, −1, 1, 2) on
    the diagonal, as ``create_spherical_dataset`` lays them out with its
    default radius and offset. Tighter blobs further out (radius 0.5,
    offset 6) leave the float32 quadratic expansion ‖x‖² + ‖c‖² − 2x·c
    cancelling ‖x‖² ≈ 430 down to d² ≈ 0.1: each package's inertia is then
    ~5e-5 off the float64 value, too far for a 1e-5 comparison."""
    rng = np.random.default_rng(seed)
    parts = []
    for s in (-2.0, -1.0, 1.0, 2.0):
        v = rng.standard_normal((per, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        parts.append(v * rng.uniform(size=(per, 1)) ** (1 / 3) * radius + s * offset)
    return np.concatenate(parts).astype(np.float32)


def _both(values, split):
    return jht.array(values, split=split), ht.array(values, split=split)


def _recovers_blobs(labels, k=4, per=BLOCK) -> bool:
    blocks = [np.unique(labels[b * per : (b + 1) * per]) for b in range(k)]
    return all(len(u) == 1 for u in blocks) and len({int(u[0]) for u in blocks}) == k


# --------------------------------------------------------------------- #
# K3: plain version against heat_tpu                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n, d, k", K3_SHAPES)
def test_fused_assign_plain_matches_pallas_interpret(n, d, k):
    rng = np.random.default_rng(n + d + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = x[:k]
    prog = _pallas.fused_assign_program(n, d, k, "float32", interpret=True)
    jsums, jcounts, jinertia = prog(jnp.asarray(x), jnp.asarray(c))
    sums, counts, inertia = ca.fused_assign_plain(torch.from_numpy(x), torch.from_numpy(c))
    assert sums.dtype == counts.dtype == inertia.dtype == torch.float32
    assert tuple(sums.shape) == (k, d) and tuple(counts.shape) == (k,) and inertia.ndim == 0
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert _rel(sums, jsums) <= 1e-5
    assert abs(float(inertia) - float(jinertia)) <= 2e-5 * float(jinertia)


@pytest.mark.parametrize("n, d, k", K3_SHAPES)
def test_lloyd_step_matches_jnp_step(n, d, k):
    rng = np.random.default_rng(7 * n + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = x[-k:]
    jc, jshift, jinertia = jkmeans._lloyd_step(k, (n, d), "float32", use_pallas=False)(
        jnp.asarray(x), jnp.asarray(c)
    )
    tc, tshift, tinertia = tkmeans._lloyd_step(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    assert abs(float(tshift) - float(jshift)) <= 1e-5 * max(float(jshift), 1e-6)
    assert abs(float(tinertia) - float(jinertia)) <= 2e-5 * float(jinertia)


def test_fused_assign_takes_the_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((300, 16)).astype(np.float32))
    launches = ca.ASSIGN_LAUNCHES
    got, want = ca.fused_assign(x, x[:5]), ca.fused_assign_plain(x, x[:5])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ca.ASSIGN_LAUNCHES == launches


def test_fused_assign_cuda_tensors_launch_or_raise(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensors below would be launched")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*args):
        raise AssertionError("a CUDA operand reached the plain version")

    monkeypatch.setattr(ca, "fused_assign_plain", refuse)
    launches = ca.ASSIGN_LAUNCHES
    host_c = torch.zeros((8, 64))
    with FakeTensorMode():
        x = torch.empty((1000, 64), device="cuda")
        c = torch.empty((8, 64), device="cuda")
        with pytest.raises(RuntimeError):  # nothing here can build or launch the kernel
            ca.fused_assign(x, c)
        with pytest.raises(ValueError):  # operands on two devices
            ca.fused_assign(x, host_c)
        with pytest.raises(TypeError):  # the kernel takes float32 only
            ca.fused_assign(x.double(), c.double())
        with pytest.raises(ValueError):  # past the kernel's bounds
            ca.fused_assign(torch.empty((10, 125), device="cuda"), torch.empty((8, 125), device="cuda"))
    assert ca.ASSIGN_LAUNCHES == launches


@pytest.mark.parametrize(
    "n, d, k, dtype, cuda, expected",
    [
        (15_625_000, 64, 8, torch.float32, True, True),  # the main path
        (20000, 3, 4, torch.float32, True, True),  # the reference benchmark
        (1003, 124, 64, torch.float32, True, True),
        (1003, 125, 8, torch.float32, True, False),
        (1003, 64, 65, torch.float32, True, False),
        (0, 64, 8, torch.float32, True, False),
        (1003, 64, 8, torch.float64, True, False),
        (1003, 64, 8, torch.float32, False, False),
    ],
)
def test_assign_serviceable(n, d, k, dtype, cuda, expected):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty((n, d), dtype=dtype, device="cuda" if cuda else "cpu")
        assert ca.assign_serviceable(n, d, k, x) is expected


# --------------------------------------------------------------------- #
# fits from the same initial centers                                    #
# --------------------------------------------------------------------- #
def _same_start(cls_name, data, centers, split, **params):
    jx, tx = _both(data, split)
    jinit, tinit = _both(centers, None)
    jm = getattr(jht.cluster, cls_name)(n_clusters=len(centers), init=jinit, **params).fit(jx)
    tm = getattr(ht.cluster, cls_name)(n_clusters=len(centers), init=tinit, **params).fit(tx)
    return jm, tm


def _gaussian(seed=11, n=500, d=8):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


KMEANS_CASES = {
    "blobs": lambda: (_blobs(1), _blobs(1)[[3, 70, 140, 200]] + 0.3, {}),
    "gaussian": lambda: (_gaussian(), _gaussian()[:5], {"max_iter": 5}),
}


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("case", sorted(KMEANS_CASES))
def test_kmeans_fit_matches_heat_tpu(case, split):
    data, centers, params = KMEANS_CASES[case]()
    jm, tm = _same_start("KMeans", data, centers, split, **params)
    np.testing.assert_allclose(
        tm.cluster_centers_.numpy(), jm.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5
    )
    labels = tm.labels_.numpy()
    assert labels.dtype == np.int64 and tm.labels_.split == jm.labels_.split
    np.testing.assert_array_equal(labels, jm.labels_.numpy())
    assert tm.n_iter_ == jm.n_iter_
    assert abs(tm.inertia_ - jm.inertia_) <= 1e-5 * jm.inertia_
    np.testing.assert_array_equal(tm.predict(ht.array(data)).numpy(), labels)


@pytest.mark.parametrize("split", [None, 0])
def test_partial_fit_over_three_batches_matches_heat_tpu(split):
    data = _gaussian(seed=5, n=900, d=6)
    centers = data[:4] * 0.5
    jinit, tinit = _both(centers, None)
    jm = jht.cluster.KMeans(n_clusters=4, init=jinit)
    tm = ht.cluster.KMeans(n_clusters=4, init=tinit)
    for b in range(3):
        jx, tx = _both(data[b * 300 : (b + 1) * 300], split)
        jm.partial_fit(jx)
        tm.partial_fit(tx)
        np.testing.assert_allclose(
            tm.cluster_centers_.numpy(), jm.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5
        )
        np.testing.assert_array_equal(tm._partial_counts.numpy(), np.asarray(jm._partial_counts))
        assert abs(tm.inertia_ - jm.inertia_) <= 1e-5 * jm.inertia_


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("cls_name", ["KMedians", "KMedoids"])
def test_kmedians_kmedoids_match_heat_tpu(cls_name, split):
    data = _blobs(2, per=65)  # odd and even cluster sizes give both median forms
    data = np.concatenate([data, data[:3] + 0.01]).astype(np.float32)
    centers = data[[5, 80, 150, 220]] + 0.2
    jm, tm = _same_start(cls_name, data, centers, split)
    np.testing.assert_allclose(
        tm.cluster_centers_.numpy(), jm.cluster_centers_.numpy(), rtol=0, atol=1e-6
    )
    np.testing.assert_array_equal(tm.labels_.numpy(), jm.labels_.numpy())
    assert tm.n_iter_ == jm.n_iter_
    assert abs(tm.inertia_ - jm.inertia_) <= 1e-5 * jm.inertia_
    if cls_name == "KMedoids":  # medoids are data points
        for c in tm.cluster_centers_.numpy():
            assert np.any(np.all(data == c, axis=1))


def test_update_centroids_matches_heat_tpu():
    data = _gaussian(seed=12, n=400, d=4)
    labels = np.random.default_rng(12).integers(0, 3, size=400).astype(np.int64)
    labels[labels == 2] = 0  # cluster 2 stays empty and keeps its center
    centers = data[:3]
    jm = jht.cluster.KMeans(n_clusters=3, init=jht.array(centers))
    tm = ht.cluster.KMeans(n_clusters=3, init=ht.array(centers))
    jm._initialize_cluster_centers(jht.array(data))
    tm._initialize_cluster_centers(ht.array(data))
    ref = jm._update_centroids(jht.array(data, split=0), jht.array(labels, split=0))
    got = tm._update_centroids(ht.array(data, split=0), ht.array(labels, split=0))
    assert got.shape == ref.shape == (3, 4) and got.split is None
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[2], centers[2])


# --------------------------------------------------------------------- #
# state carried from heat_tpu                                           #
# --------------------------------------------------------------------- #
def _state_of(model) -> dict:
    state = {
        "cluster_centers_": model.cluster_centers_.numpy(),
        "labels_": None if model.labels_ is None else model.labels_.numpy(),
        "n_iter_": model.n_iter_,
        "inertia_": model.inertia_,
    }
    if getattr(model, "_partial_counts", None) is not None:
        state["_partial_counts"] = np.asarray(model._partial_counts)
    return state


@pytest.mark.parametrize("cls_name", ["KMeans", "KMedians", "KMedoids"])
def test_predict_after_carrying_fitted_state(cls_name):
    data = _blobs(3)
    jm = getattr(jht.cluster, cls_name)(n_clusters=4, init="kmeans++", random_state=9)
    jm.fit(jht.array(data, split=0))
    tm = interop.kcluster_from_numpy(getattr(ht.cluster, cls_name), _state_of(jm), n_clusters=4)
    assert tm.n_iter_ == jm.n_iter_ and tm.inertia_ == jm.inertia_
    np.testing.assert_array_equal(tm.labels_.numpy(), jm.labels_.numpy())
    new = _blobs(4) + np.random.default_rng(4).normal(scale=0.5, size=(4 * BLOCK, 3)).astype(np.float32)
    for split in (None, 0):
        jx, tx = _both(new, split)
        np.testing.assert_array_equal(tm.predict(tx).numpy(), jm.predict(jx).numpy())


def test_partial_fit_continues_after_carrying_stream_state():
    data = _gaussian(seed=8, n=600, d=5)
    jinit = jht.array(data[:3])
    jm = jht.cluster.KMeans(n_clusters=3, init=jinit)
    jm.partial_fit(jht.array(data[:300]))
    tm = interop.kcluster_from_numpy(ht.cluster.KMeans, _state_of(jm), n_clusters=3)
    jm.partial_fit(jht.array(data[300:], split=0))
    tm.partial_fit(ht.array(data[300:], split=0))
    np.testing.assert_allclose(
        tm.cluster_centers_.numpy(), jm.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(tm._partial_counts.numpy(), np.asarray(jm._partial_counts))


# --------------------------------------------------------------------- #
# seeded inits                                                          #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("cls_name", ["KMeans", "KMedians", "KMedoids"])
def test_kmeanspp_recovers_the_blobs_in_both_packages(cls_name):
    jdata = jht.utils.data.create_spherical_dataset(BLOCK, radius=0.5, offset=6.0, random_state=5)
    tdata = ht.utils.data.create_spherical_dataset(BLOCK, radius=0.5, offset=6.0, random_state=5)
    assert tdata.shape == jdata.shape == (4 * BLOCK, 3) and tdata.split == jdata.split == 0
    for pkg, data in ((jht, jdata), (ht, tdata)):
        model = getattr(pkg.cluster, cls_name)(n_clusters=4, init="kmeans++", random_state=3)
        assert _recovers_blobs(model.fit(data).labels_.numpy()), pkg.__name__


@pytest.mark.parametrize("init", ["random", "kmeans++"])
def test_same_random_state_gives_the_same_centers(init):
    data = ht.array(_blobs(6), split=0)
    ht.random.seed(123)
    before = ht.random.get_state()
    a = ht.cluster.KMeans(n_clusters=4, init=init, max_iter=3, random_state=17).fit(data)
    b = ht.cluster.KMeans(n_clusters=4, init=init, max_iter=3, random_state=17).fit(data)
    c = ht.cluster.KMeans(n_clusters=4, init=init, max_iter=3, random_state=18).fit(data)
    np.testing.assert_array_equal(a.cluster_centers_.numpy(), b.cluster_centers_.numpy())
    assert not np.array_equal(a.cluster_centers_.numpy(), c.cluster_centers_.numpy())
    assert ht.random.get_state() == before  # the private streams leave the global one alone
    assert a.rng_state[0] == "Threefry" and a.rng_state[2] > 0


def test_random_init_draws_data_rows_and_fits_like_heat_tpu_from_them():
    data = _blobs(7)
    tm = ht.cluster.KMeans(n_clusters=4, init="random", max_iter=0, random_state=2)
    tm._initialize_cluster_centers(ht.array(data))
    drawn = tm.cluster_centers_.numpy()
    rows = [np.flatnonzero(np.all(data == c, axis=1)) for c in drawn]
    assert all(len(r) == 1 for r in rows) and len({int(r[0]) for r in rows}) == 4
    seeded = ht.cluster.KMeans(n_clusters=4, init="random", random_state=2).fit(ht.array(data))
    jm, tm = _same_start("KMeans", data, drawn, 0)
    np.testing.assert_allclose(seeded.cluster_centers_.numpy(), jm.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(seeded.labels_.numpy(), jm.labels_.numpy())


@pytest.mark.parametrize("init", ["kmeans++", "random"])
@pytest.mark.parametrize("cls_name", ["KMeans", "KMedians", "KMedoids"])
def test_seeded_init_and_fit_are_heat_tpus(cls_name, init):
    """Each package draws its own seeded init, nothing injected: the same
    initial centers (k-means++'s candidates are drawn from the cumulative
    sum of d²/Σd², which the two packages round in their own orders, so a
    draw within that rounding of a boundary between two rows could pick
    another row; no such draw occurs on these inputs), then the same
    labels and n_iter and centers within 1e-5."""
    data = _blobs(8)
    jx, tx = _both(data, None)
    jm = getattr(jht.cluster, cls_name)(n_clusters=4, init=init, random_state=21)
    tm = getattr(ht.cluster, cls_name)(n_clusters=4, init=init, random_state=21)
    jm._initialize_cluster_centers(jx)
    tm._initialize_cluster_centers(tx)
    np.testing.assert_array_equal(tm.cluster_centers_.numpy(), jm.cluster_centers_.numpy())
    assert tm.rng_state == jm.rng_state
    jm = getattr(jht.cluster, cls_name)(n_clusters=4, init=init, random_state=21).fit(jx)
    tm = getattr(ht.cluster, cls_name)(n_clusters=4, init=init, random_state=21).fit(tx)
    np.testing.assert_array_equal(tm.labels_.numpy(), jm.labels_.numpy())
    assert tm.n_iter_ == jm.n_iter_
    np.testing.assert_allclose(tm.cluster_centers_.numpy(), jm.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5)


def test_kmeanspp_from_the_global_stream_is_heat_tpus():
    data = _gaussian(seed=12, n=300, d=5)
    jht.random.seed(33)
    ht.random.seed(33)
    jx, tx = _both(data, None)
    jm = jht.cluster.KMeans(n_clusters=6, init="kmeans++")
    tm = ht.cluster.KMeans(n_clusters=6, init="kmeans++")
    jm._initialize_cluster_centers(jx)
    tm._initialize_cluster_centers(tx)
    np.testing.assert_array_equal(tm.cluster_centers_.numpy(), jm.cluster_centers_.numpy())
    assert ht.random.get_state() == jht.random.get_state()


def test_a_heat_tpu_models_rng_state_carries_across():
    """A heat_tpu KMeans that has drawn inits carries its private stream
    into the port (``kcluster_from_numpy``): the next init is heat_tpu's."""
    data = _blobs(9)
    jx, tx = _both(data, None)
    jm = jht.cluster.KMeans(n_clusters=4, init="kmeans++", random_state=7).fit(jx)
    state = {"cluster_centers_": jm.cluster_centers_.numpy(), "rng_state": jm.rng_state}
    tm = interop.kcluster_from_numpy(ht.cluster.KMeans, state, n_clusters=4, init="kmeans++")
    assert tm.rng_state == jm.rng_state and tm.rng_state[0] == "Threefry" and tm.rng_state[2] > 0
    jm._initialize_cluster_centers(jx)
    tm._initialize_cluster_centers(tx)
    np.testing.assert_array_equal(tm.cluster_centers_.numpy(), jm.cluster_centers_.numpy())
    assert tm.rng_state == jm.rng_state


def test_spherical_dataset_is_heat_tpus():
    """The points of ``create_spherical_dataset(random_state=1)``: its
    uniform draws are heat_tpu's bit for bit and its directions' normals
    within 4 ulp, so the points agree within 1e-6 of their scale (the norm
    and the cube root round in each package's own way)."""
    for kw in ({}, {"radius": 0.5, "offset": 6.0}):
        ref = jht.utils.data.create_spherical_dataset(50, random_state=1, **kw).numpy()
        got = ht.utils.data.create_spherical_dataset(50, random_state=1, **kw).numpy()
        assert got.shape == ref.shape == (200, 3) and got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
        assert ht.random.get_state() == jht.random.get_state()


def test_state_round_trip_and_foreign_stream_refused():
    ht.random.seed(5)
    ht.random.randn(10)
    state = ht.random.get_state()
    assert state == ("Threefry", 5, 10, 0, 0.0)
    x = ht.random.randint(0, 100, (7,)).numpy()
    ht.random.set_state(state)
    np.testing.assert_array_equal(ht.random.randint(0, 100, (7,)).numpy(), x)
    perm = ht.random.randperm(50)
    assert perm.dtype is ht.int64 and sorted(perm.numpy().tolist()) == list(range(50))
    ht.random.set_state(("Threefry", 5, 10, 0, 0.0))  # heat_tpu's algorithm is the port's own
    np.testing.assert_array_equal(ht.random.randint(0, 100, (7,)).numpy(), x)
    with pytest.raises(ValueError):
        ht.random.set_state(("MT19937", 5, 10, 0, 0.0))


# --------------------------------------------------------------------- #
# estimator API                                                         #
# --------------------------------------------------------------------- #
def test_estimator_api_and_unported_operands():
    km = ht.cluster.KMeans(n_clusters=4)
    assert km.get_params()["n_clusters"] == 4
    assert km.set_params(n_clusters=5).n_clusters == 5
    with pytest.raises(ValueError):
        km.set_params(bogus=1)
    assert ht.is_estimator(km) and ht.is_clusterer(km) and not ht.is_classifier(km)
    assert "KMeans" in repr(km)
    data = ht.array(_blobs(0))
    labels = ht.cluster.KMedoids(n_clusters=4, init="kmeans++", random_state=1).fit_predict(data)
    assert _recovers_blobs(labels.numpy())
    with pytest.raises(ValueError):
        ht.cluster.KMeans(n_clusters=4, init="bogus").fit(data)
    with pytest.raises(NotImplementedError, match="item 13"):
        ht.cluster.KMeans(n_clusters=4).fit(data, ckpt=object())
    # a host-resident operand is fitted by one epoch of streamed windows
    streamed = ht.cluster.KMeans(n_clusters=4, init=data[:4]).fit(ht.redistribution.HostArray(_blobs(0)))
    assert streamed.cluster_centers_.shape == (4, data.shape[1])
    assert bool(torch.isfinite(streamed.cluster_centers_.larray).all())
    with pytest.raises(RuntimeError):
        ht.cluster.KMeans(n_clusters=4).predict(data)


@pytest.mark.cuda
@pytest.mark.parametrize("n, d, k", K3_SHAPES)
def test_fused_assign_matches_plain_version_on_card(n, d, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((n, d)).astype(np.float32)).to(dev)
    c = x[:k].contiguous()
    sums, counts, inertia = ca.fused_assign(x, c)
    psums, pcounts, pinertia = ca.fused_assign_plain(x, c)
    assert torch.equal(counts, pcounts)
    assert _rel(sums.cpu(), psums.cpu()) <= 1e-5
    assert abs(float(inertia) - float(pinertia)) <= 1e-5 * float(pinertia)


@pytest.mark.parametrize("cls_name", ["KMeans", "KMedians", "KMedoids"])
def test_random_init_refuses_more_clusters_than_samples(cls_name):
    """heat_tpu fails in the fit from a (60, d) against (50, d) broadcast
    (a ValueError in KMeans, a TypeError in the others); the port names
    both counts in a ValueError, as scikit-learn refuses k > n."""
    data = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    with pytest.raises((ValueError, TypeError)):
        getattr(jht.cluster, cls_name)(n_clusters=60, init="random").fit(jht.array(data))
    with pytest.raises(ValueError, match=r"n_clusters=60 .* only 50"):
        getattr(ht.cluster, cls_name)(n_clusters=60, init="random").fit(ht.array(data))
    model = getattr(ht.cluster, cls_name)(n_clusters=50, init="random", max_iter=1).fit(ht.array(data))
    assert model.cluster_centers_.shape == (50, 3)
