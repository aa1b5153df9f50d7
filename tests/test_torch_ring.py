"""KMeans, the pairwise-distance ring and ring attention of heat_tpu_torch
on operands split across ranks, and its one unseeded random stream,
against heat_tpu.

Two levels:

- the 4-rank gloo world of test_torch_distributed.py (the cases of
  ``_ring_cases`` in torch_mp_worker.py, run once per pytest run) against
  heat_tpu on ``MeshCommunication(devices=jax.devices()[:4])``, on shards
  that are ragged and on one whose last rank holds no row (9 rows over 4
  ranks):
  - an unseeded ``randn(40, split=0)``: every rank's state equal, and the
    shards the chunks of one world-size-1 draw under that state, bit for
    bit;
  - ``KMeans`` with a given init (whole and split): centers within 1e-5,
    ``n_iter_`` equal, labels equal with each rank's shard heat_tpu's
    chunk, ``inertia_`` within 1e-5 relative, one all-reduce a Lloyd step,
    centers bit for bit on every rank; ``predict``, ``partial_fit`` and
    ``_update_centroids`` on split data the same way; ``kmeans++`` and
    ``"random"`` with a ``random_state`` the port's own partition at world
    size 1 (the streams differ from heat_tpu's Threefry, ROADMAP item 5);
  - ``cdist``, ``manhattan`` and ``rbf`` with X split 0, None or 1 against
    itself, a whole Y, Y split 0 and Y split 1, ``ring`` both ways: the
    split and each rank's shard heat_tpu's, values within 1e-5 of the
    result's largest magnitude (float64: 1e-12), the quadratic form of
    ``cdist`` compared as squares (its float32 rounding is absolute in d²,
    so a zero distance comes back as about 1e-3 on both sides); the
    collectives of the ring and the half ring pinned (3 hops), and of the
    gathered route (one all-gather);
  - ``ring_attention`` with q split: float32 within 1e-5 of heat_tpu, the
    output split along the sequence axis; bfloat16 each package against a
    float64 result, the port's error no worse than heat_tpu's plus K9's
    bf16 limit 3 · 2^-8 (|o| + the attention of |v|);
  - the gradients dQ, dK and dV of sum((o − tgt)²) with q, k and v split,
    with k and v whole and with q whole (``ATT_GRAD_SHAPES``, causal and
    not): float32 within 1e-5 of the largest gradient magnitude of
    ``jax.grad`` through heat_tpu's ring program on the 4-device mesh (its
    single-device program for a whole q), float64 within 1e-10 of torch's
    dense attention; a whole operand's gradient whole on every rank, a
    split one's the rank's rows; the backward's collectives pinned (p
    collective-permutes, and one all-gather for each whole k and v);
- one process: the calls that serve a key block at any offset from the
  queries (``_decompose``) combine to attention under the global causal
  mask within 1e-6, and their shares of ``flash_attention_backward`` from
  the combined (o, lse) sum to the gradient of that attention within
  1e-10; they launch K9 r + 1 times on rank r (p times not causal) with
  even shards.
"""

import math

import jax
import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu_torch.kernels import attention as ka
from heat_tpu_torch.nn import attention as natt

import torch_mp_worker as worker
from test_torch_distributed import WORLD, _eq_bits, _result, _shard, jcomm, ranks  # noqa: F401 (fixtures)

TOL = {"float32": 1e-5, "float64": 1e-12}
BF16_O = 3 * 2.0**-8


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")


def _every_rank_equal(res):
    every = res["every"]
    assert all(np.array_equal(every[q], every[0]) for q in range(WORLD))


# --------------------------------------------------------------------- #
# one unseeded stream                                                   #
# --------------------------------------------------------------------- #
def test_an_unseeded_draw_is_one_stream_across_ranks(ranks):
    results = _result(ranks, "seed_unseeded")
    assert all(res["unseeded"] for res in results)  # the process's first draw
    state = results[0]["state"]
    assert all(res["state"] == state for res in results) and state[2] == 40
    outer = ht.random.get_state()
    try:
        ht.random.set_state((state[0], state[1], 0, 0, 0.0))
        whole = ht.random.randn(40).numpy()
    finally:
        ht.random.set_state(outer)
    for r, res in enumerate(results):
        _eq_bits(res["local"], _shard(whole, 0, r))
        _eq_bits(res["global"], whole)


# --------------------------------------------------------------------- #
# KMeans                                                                #
# --------------------------------------------------------------------- #
def _check_fit(res, ref, r):
    np.testing.assert_allclose(res["centers"], ref.cluster_centers_.numpy(), rtol=1e-5, atol=1e-5)
    assert res["n_iter"] == ref.n_iter_
    assert abs(res["inertia"] - ref.inertia_) <= 1e-5 * abs(ref.inertia_)
    labels = ref.labels_.numpy()
    assert res["labels"]["split"] == ref.labels_.split == 0 and res["labels"]["gshape"] == ref.labels_.gshape
    np.testing.assert_array_equal(res["labels"]["global"], labels)
    np.testing.assert_array_equal(res["labels"]["local"], _shard(labels, 0, r))
    _every_rank_equal(res)


@pytest.mark.parametrize("init_split", [None, 0])
@pytest.mark.parametrize("label", list(worker.KM_ROWS))
def test_kmeans_fit_across_ranks_matches_heat_tpu(ranks, jcomm, label, init_split):
    data = worker.km_blobs(worker.KM_ROWS[label])
    init = jht.array(data[: worker.KM_K], split=init_split, comm=jcomm)
    ref = jht.cluster.KMeans(worker.KM_K, init=init).fit(jht.array(data, split=0, comm=jcomm))
    for r, res in enumerate(_result(ranks, f"km_fit_{label}_{init_split}")):
        _check_fit(res, ref, r)
        assert res["counts"].get("all-reduce") == ref.n_iter_  # one all-reduce a Lloyd step


@pytest.mark.parametrize("label", list(worker.KM_ROWS))
def test_kmeans_predict_on_split_data_matches_heat_tpu(ranks, jcomm, label):
    n = worker.KM_ROWS[label]
    data = worker.km_blobs(n)
    km = jht.cluster.KMeans(worker.KM_K, init=jht.array(data[: worker.KM_K], comm=jcomm))
    ref = km.fit(jht.array(data, comm=jcomm)).predict(jht.array(worker.km_blobs(n, seed=62), split=0, comm=jcomm))
    for r, res in enumerate(_result(ranks, f"km_predict_{label}")):
        assert res["split"] == ref.split == 0
        np.testing.assert_array_equal(res["global"], ref.numpy())
        np.testing.assert_array_equal(res["local"], _shard(ref.numpy(), 0, r))


@pytest.mark.parametrize("label", list(worker.KM_ROWS))
def test_kmeans_partial_fit_on_split_batches_matches_heat_tpu(ranks, jcomm, label):
    n = worker.KM_ROWS[label]
    data = worker.km_blobs(n)
    km = jht.cluster.KMeans(worker.KM_K, init=jht.array(data[: worker.KM_K], comm=jcomm))
    want = []
    for batch in (data, worker.km_blobs(n, seed=63)):
        km.partial_fit(jht.array(batch, split=0, comm=jcomm))
        want.append((km.cluster_centers_.numpy(), km.inertia_))
    for res in _result(ranks, f"km_partial_{label}"):
        for got, (centers, inertia) in zip(res["batches"], want):
            np.testing.assert_allclose(got["centers"], centers, rtol=1e-5, atol=1e-5)
            assert abs(got["inertia"] - inertia) <= 1e-5 * abs(inertia)
        _every_rank_equal(res)


@pytest.mark.parametrize("label", list(worker.KM_ROWS))
def test_kmeans_update_centroids_on_split_data_matches_heat_tpu(ranks, jcomm, label):
    n = worker.KM_ROWS[label]
    data = worker.km_blobs(n)
    km = jht.cluster.KMeans(worker.KM_K, init=jht.array(data[: worker.KM_K], comm=jcomm))
    km._initialize_cluster_centers(jht.array(data, comm=jcomm))
    labels = jht.array(np.arange(n) % worker.KM_K, split=0, comm=jcomm)
    ref = km._update_centroids(jht.array(data, split=0, comm=jcomm), labels).numpy()
    for res in _result(ranks, f"km_update_{label}"):
        np.testing.assert_allclose(res["centers"], ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("init", worker.KM_SEEDED)
@pytest.mark.parametrize("label", list(worker.KM_ROWS))
def test_seeded_kmeans_across_ranks_matches_the_port_at_world_size_1(ranks, label, init):
    data = worker.km_blobs(worker.KM_ROWS[label])
    ref = ht.cluster.KMeans(worker.KM_K, init=init, random_state=5).fit(ht.array(data, split=0))
    for r, res in enumerate(_result(ranks, f"km_seeded_{label}_{init}")):
        _check_fit(res, ref, r)


# --------------------------------------------------------------------- #
# the pairwise-distance ring                                            #
# --------------------------------------------------------------------- #
def _dist_counts(x_split, y_kind, ring):
    """The collectives a rank issues where the route fixes them: p − 1 hops
    of the ring (the half ring: 2 rotations and 1 transposed block at 4
    ranks) or one all-gather, and none where every rank has what it needs;
    None where a feature-split operand is gathered first (its plan's)."""
    if x_split == 0 and y_kind in ("self", "split0"):
        return {"collective-permute": WORLD - 1} if ring else {"all-gather": 1}
    if x_split != 1 and y_kind != "split1":
        return {}
    return None


def _close(got, want, dtype, squares=False):
    if squares:
        got, want = got.astype(np.float64) ** 2, want.astype(np.float64) ** 2
    scale = max(float(np.abs(want).max()), 1.0) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


DISTS = [(name, xs, yk, ring) for name in worker.DIST_CALLS for xs in worker.DIST_X_SPLITS
         for yk in worker.DIST_Y_KINDS for ring in (False, True)]


@pytest.mark.parametrize("name, x_split, y_kind, ring", DISTS, ids=[f"{n}-{x}-{y}-{r}" for n, x, y, r in DISTS])
def test_distances_across_ranks_match_heat_tpu(ranks, jcomm, name, x_split, y_kind, ring):
    X, Y = worker.dist_operands(jht, x_split, y_kind, comm=jcomm)
    ref = worker.DIST_CALLS[name](jht, X, Y, ring)
    want = ref.numpy()
    counts = _dist_counts(x_split, y_kind, ring)
    squares = name == "cdist_quadratic"
    for r, res in enumerate(_result(ranks, f"dist_{name}_{x_split}_{y_kind}_{ring}")):
        assert (res["split"], res["gshape"], res["dtype"]) == (ref.split, ref.gshape, "float32")
        _close(res["global"], want, "float32", squares)
        _close(res["local"], _shard(want, ref.split, r), "float32", squares)
        if counts is not None:
            assert res["counts"] == counts


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("y_kind", ["self", "split0"])
def test_float64_distances_across_ranks_match_heat_tpu(ranks, jcomm, y_kind, ring):
    X, Y = worker.dist_operands(jht, 0, y_kind, "float64", comm=jcomm)
    want = jht.spatial.cdist(X, Y, ring=ring).numpy()
    for r, res in enumerate(_result(ranks, f"dist_f64_{y_kind}_{ring}")):
        assert res["dtype"] == "float64" and res["split"] == 0
        _close(res["global"], want, "float64")
        _close(res["local"], _shard(want, 0, r), "float64")


# --------------------------------------------------------------------- #
# ring attention                                                        #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("label", list(worker.ATT_SHAPES))
def test_ring_attention_with_split_q_matches_heat_tpu(ranks, jcomm, label, causal):
    ref = jht.nn.ring_attention(*worker.att_operands(jht, label, comm=jcomm), causal=causal)
    want = ref.numpy()
    for kind in ("att", "att_whole_kv"):
        for r, res in enumerate(_result(ranks, f"{kind}_{label}_{causal}")):
            assert res["split"] == ref.split == 2 and res["gshape"] == ref.gshape
            np.testing.assert_allclose(res["global"], want, rtol=0, atol=1e-5)
            np.testing.assert_allclose(res["local"], _shard(want, 2, r), rtol=0, atol=1e-5)
            if kind == "att":
                assert res["counts"] == {"collective-permute": WORLD - 1}


def _dense(q, k, v, causal):
    """float64 attention under the global causal mask (query i sees key j
    iff j ≤ i), with the attention of |v| beside it."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        i, j = np.arange(q.shape[-2])[:, None], np.arange(k.shape[-2])[None, :]
        s = s.masked_fill(torch.from_numpy(j > i), -math.inf)
    w = torch.softmax(s, dim=-1)
    return (w @ v).numpy(), (w @ v.abs()).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("label", worker.ATT_BF16)
def test_bf16_ring_attention_is_no_worse_than_heat_tpus(ranks, jcomm, label, causal):
    jq, jk, jv = worker.att_operands(jht, label, "bfloat16", comm=jcomm)
    got_ref = jht.nn.ring_attention(jq, jk, jv, causal=causal).numpy().astype(np.float64)
    q, k, v = (torch.from_numpy(t.numpy().astype(np.float64)) for t in (jq, jk, jv))
    exact, att_abs = _dense(q, k, v, causal)
    limit = np.abs(got_ref - exact) + BF16_O * (np.abs(exact) + att_abs)
    for res in _result(ranks, f"att_bf16_{label}_{causal}"):
        assert res["dtype"] == "bfloat16" and res["split"] == 2
        assert np.all(np.abs(res["global"].astype(np.float64) - exact) <= limit)


GRAD_TOL = 1e-5  # float32, of the largest gradient magnitude (heat_tpu's own ring test: 2e-4)
GRAD_COUNTS = {"split": {"collective-permute": WORLD}, "whole_kv": {"collective-permute": WORLD, "all-gather": 2},
               "whole_q": {}}  # the backward's collectives: p hops, and the whole k and v gathered back
GRADS = [(label, kind, causal) for label in worker.ATT_GRAD_SHAPES for kind in worker.ATT_GRAD_KINDS
         for causal in (False, True)]


def _heat_tpu_grads(jcomm, label, kind, causal):
    """jax.grad of sum((o − tgt)²) on heat_tpu's route: the ring program on
    the 4-device mesh (``_ring_attention_program``, its padded shards) for a
    split q, the single-device program for a whole q."""
    import jax.numpy as jnp
    from heat_tpu.nn import attention as jatt

    (q, k, v), tgt = worker.att_grad_operands(jht, label, kind, comm=jcomm)
    s_q, s_kv = worker.ATT_GRAD_SHAPES[label]
    scale = 1.0 / math.sqrt(q.shape[-1])
    if kind == "whole_q":
        def attend(*a):
            return jatt._single_device_attention(*a, causal, scale)
        args = tuple(jnp.asarray(t.numpy()) for t in (q, k, v))
    else:
        prog = jatt._ring_attention_program(jcomm.mesh, jcomm.axis_name, 4, 2, s_q, s_kv, causal, scale, "float32")

        def attend(*a):
            return prog(*a)[..., :s_q, :]
        args = tuple(jht.array(t.numpy(), split=2, comm=jcomm)._phys for t in (q, k, v))
    grads = jax.grad(lambda *a: jnp.sum((attend(*a) - tgt) ** 2), argnums=(0, 1, 2))(*args)
    return [np.asarray(g)[..., :n, :] for g, n in zip(grads, (s_q, s_kv, s_kv))]


def _dense_grads(label, kind, causal):
    """The float64 gradients of sum((o − tgt)²) with torch's dense attention."""
    (q, k, v), tgt = worker.att_grad_operands(ht, label, kind, "float64")
    q, k, v = (torch.from_numpy(t.numpy()).requires_grad_() for t in (q, k, v))
    o = torch.softmax(_scores(q, k, causal), dim=-1) @ v
    return [g.numpy() for g in torch.autograd.grad(((o - torch.from_numpy(tgt)) ** 2).sum(), (q, k, v))]


def _scores(q, k, causal):
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        i, j = torch.arange(q.shape[-2])[:, None], torch.arange(k.shape[-2])[None, :]
        s = s.masked_fill(j > i, -math.inf)
    return s


def _check_grads(ranks, name, kind, want, tol):
    splits = (None, 2, 2) if kind == "whole_q" else (2, None, None) if kind == "whole_kv" else (2, 2, 2)
    for r, res in enumerate(_result(ranks, name)):
        for got, w, split, which in zip(res["grads"], want, splits, "qkv"):
            atol = tol * max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(got, _shard(w, split, r), rtol=0, atol=atol, err_msg=f"d{which}, rank {r}")
        assert res["counts"] == GRAD_COUNTS[kind]


@pytest.mark.parametrize("label, kind, causal", GRADS, ids=[f"{lb}-{kd}-{c}" for lb, kd, c in GRADS])
def test_ring_attention_gradients_match_heat_tpus_jax_grad(ranks, jcomm, label, kind, causal):
    want = _heat_tpu_grads(jcomm, label, kind, causal)
    _check_grads(ranks, f"att_grad_{label}_{kind}_float32_{causal}", kind, want, GRAD_TOL)


@pytest.mark.parametrize("label, kind, causal", GRADS, ids=[f"{lb}-{kd}-{c}" for lb, kd, c in GRADS])
def test_float64_ring_attention_gradients_match_dense_attention(ranks, label, kind, causal):
    _check_grads(ranks, f"att_grad_{label}_{kind}_float64_{causal}", kind, _dense_grads(label, kind, causal), 1e-10)


BQ, BK = 7, 5
DELTAS = (-BQ - 1, -3, 0, 2, BK, BK + 5)


def _global_reference(q, k, v, delta, causal):
    """(o, lse) in float64 with query i seeing key j iff j ≤ i + delta."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        i, j = torch.arange(q.shape[-2])[:, None], torch.arange(k.shape[-2])[None, :]
        s = s.masked_fill(j > i + delta, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    live = ~torch.isneginf(lse)
    w = torch.where(live[..., None], torch.exp(s - torch.where(live, lse, 0.0)[..., None]), 0.0)
    return w @ v, lse


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("delta", DELTAS)
def test_decomposed_calls_give_attention_under_the_global_mask(delta, causal):
    gen = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn((2, s, 8), generator=gen, dtype=torch.float64) for s in (BQ, BK, BK))
    acc = None
    for r0, k0, k1, masked in natt._decompose(BQ, BK, delta, causal):
        o, lse = ka.flash_attention_plain(q[..., r0:, :], k[..., k0:k1, :], v[..., k0:k1, :], masked)
        acc = natt._fold(acc, r0, o, lse)
    ro, rl = _global_reference(q, k, v, delta, causal)
    if acc is None:
        assert bool(torch.isneginf(rl).all())
        return
    o, lse = acc
    assert torch.equal(torch.isneginf(lse), torch.isneginf(rl))
    live = ~torch.isneginf(rl)
    assert float((o - ro).abs().max()) <= 1e-6
    assert float((lse - rl).abs()[live].max()) <= 1e-6


@pytest.mark.parametrize("p", [2, 4, 5])
def test_even_shards_launch_k9_r_plus_1_times_causal_and_p_times_not(p):
    block = 6
    for r in range(p):
        causal = [call for src in range(p) for call in natt._decompose(block, block, (r - src) * block, True)]
        assert len(causal) == r + 1 and [c[3] for c in causal].count(True) == 1  # the diagonal block
        assert sum(len(natt._decompose(block, block, (r - src) * block, False)) for src in range(p)) == p


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("delta", DELTAS)
def test_decomposed_backward_shares_sum_to_the_gradient_under_the_global_mask(delta, causal):
    gen = torch.Generator().manual_seed(10)
    q, k, v = (torch.randn((2, s, 8), generator=gen, dtype=torch.float64) for s in (BQ, BK, BK))
    o, lse = _global_reference(q, k, v, delta, causal)
    do = torch.randn(o.shape, generator=gen, dtype=torch.float64)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for r0, k0, k1, masked in natt._decompose(BQ, BK, delta, causal):
        gq, gk, gv = ka.flash_attention_backward(q[..., r0:, :], k[..., k0:k1, :], v[..., k0:k1, :],
                                                 o[..., r0:, :], lse[..., r0:], do[..., r0:, :], masked)
        dq[..., r0:, :] += gq
        dk[..., k0:k1, :] += gk
        dv[..., k0:k1, :] += gv
    qa, ka_, va = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(_global_reference(qa, ka_, va, delta, causal)[0], (qa, ka_, va), do, allow_unused=True)
    for got, w in zip((dq, dk, dv), want):
        w = torch.zeros_like(got) if w is None else w
        assert bool(torch.isfinite(got).all())
        assert float((got - w).abs().max()) <= 1e-10
