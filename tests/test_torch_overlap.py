"""The rings of ``heat_tpu_torch.kernels.cmatmul`` against their barrier
forms and against ``heat_tpu.kernels.cmatmul``.

- In one process, p ranks of ``redistribution.LocalWorld`` (its exchange
  offers the communicator's ``permute``): ``ring_all_gather`` equals the
  stacked inputs bit for bit, flat and in both groupings of the two-level
  tree; ``ring_bcast`` gives every rank the root's block bit for bit;
  ``ring_matmul_reduce`` gives the same bits on every rank, within float32
  rounding of the whole product (1e-5 of Σ|a||b|); each issues p − 1
  permutes (the matmul 2(p − 1)). Against heat_tpu's rings in a
  ``shard_map`` over the 8-device CPU mesh: the gathers and broadcasts bit
  for bit, the matmul within the same rounding bound (the partial products
  are torch's and XLA's).
- In the 4-rank world (``_wire_cases`` of ``tests/torch_mp_worker.py``):
  every call under ``HEAT_TPU_REDIST_OVERLAP=1`` (the rings) and ``=0``
  (the barrier collectives). TSQR (flat and, at ``HEAT_TPU_TOPOLOGY=2x2``,
  grouped by node), the blocked LU and Cholesky, the solves and the hSVD
  give the same bits either way; the collective matmul and polar give one
  result on every rank, within float32 rounding of the barrier form's.
  The collectives are pinned: a ring issues p − 1 permutes where the
  barrier form issues one all-gather or broadcast, 2(p − 1) where it
  issues one all-reduce. The ring forms also match heat_tpu's under
  ``HEAT_TPU_REDIST_OVERLAP=1`` on 4 devices (R up to the signs of its
  rows, the products within float32 rounding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

import heat_tpu as jht
from heat_tpu.core._jax_compat import shard_map
from heat_tpu.kernels import cmatmul as jcm

import heat_tpu_torch as ht
from heat_tpu_torch.kernels import cmatmul
from heat_tpu_torch.redistribution import LocalWorld

import torch_mp_worker as worker
from test_torch_distributed import WORLD, _result, jcomm, ranks  # noqa: F401 (fixtures)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])


def _blocks(p, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(p)]


def _run(p, body, blocks):
    world = LocalWorld(p)
    out = world.run(body, [torch.from_numpy(b) for b in blocks])
    return [o.numpy() for o in out], world.counts


def _heat_tpu(body, blocks):
    """``body(x, i)`` in a shard_map over heat_tpu's 8 devices, one block a
    device; returns every device's result."""
    comm = jht.get_comm()
    axis = comm.axis_name
    fn = shard_map(lambda xb: body(xb[0], lax.axis_index(axis), axis)[None], mesh=comm.mesh, in_specs=(P(axis),),
                   out_specs=P(axis), check_vma=False)
    return np.asarray(jax.jit(fn)(jnp.asarray(np.stack(blocks))))


GROUPINGS = [("flat", 1, 8, False), ("within", 2, 4, False), ("within4", 4, 2, False), ("across", 2, 4, True)]


@pytest.mark.parametrize("label, G, s, across", GROUPINGS, ids=[g[0] for g in GROUPINGS])
def test_ring_all_gather_is_the_all_gather(label, G, s, across):
    p = G * s
    blocks = _blocks(p, (3, 5), seed=1)
    perm = cmatmul.grouped_ring_perm(G, s, across)
    assert perm == jcm.grouped_ring_perm(G, s, across)
    size = G if across else s

    def pos(r):
        return r // s if across else r % s

    def members(r):
        return [g * s + r % s for g in range(G)] if across else [r // s * s + j for j in range(s)]

    got, counts = _run(p, lambda x, r, p_, ex: cmatmul.ring_all_gather(x, ex, size, pos(r), perm), blocks)
    for r in range(p):
        np.testing.assert_array_equal(got[r], np.stack([blocks[q] for q in members(r)]))
        assert counts[r] == {"collective-permute": size - 1}
    ref = _heat_tpu(lambda x, i, axis: jcm.ring_all_gather(x, axis, size, (i // s) if across else (i % s), perm),
                    blocks)
    np.testing.assert_array_equal(np.stack(got), ref)


@pytest.mark.parametrize("root", [0, 3, 7])
def test_ring_bcast_is_the_broadcast(root):
    p = 8
    blocks = _blocks(p, (4, 6), seed=2)
    blocks[root][0, :3] = [np.nan, np.inf, -0.0]
    perm = cmatmul.grouped_ring_perm(1, p)
    got, counts = _run(p, lambda x, r, p_, ex: cmatmul.ring_bcast(x, ex, p, root, perm), blocks)
    for r in range(p):
        np.testing.assert_array_equal(got[r].view(np.uint32), blocks[root].view(np.uint32))
        assert counts[r] == {"collective-permute": p - 1}
    ref = _heat_tpu(lambda x, i, axis: jcm.ring_bcast(x, axis, p, root, perm), blocks)
    np.testing.assert_array_equal(np.stack(got).view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("m", [8, 13])
def test_ring_matmul_reduce_is_the_reduced_product(p, m):
    rng = np.random.default_rng(p + m)
    k, n = 3, 5
    a_blocks = [rng.standard_normal((m, k)).astype(np.float32) for _ in range(p)]
    b_blocks = [rng.standard_normal((k, n)).astype(np.float32) for _ in range(p)]
    world = LocalWorld(p)
    got = world.run(lambda ab, r, p_, ex: cmatmul.ring_matmul_reduce(ab[0], ab[1], ex, p),
                    [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in zip(a_blocks, b_blocks)])
    whole = sum(a.astype(np.float64) @ b for a, b in zip(a_blocks, b_blocks))
    scale = sum(np.abs(a) @ np.abs(b) for a, b in zip(a_blocks, b_blocks)).max()
    mc = -(-m // p)
    for r in range(p):
        assert tuple(got[r].shape) == (mc * p, n)
        np.testing.assert_array_equal(got[r].numpy(), got[0].numpy())  # one result on every rank
        np.testing.assert_allclose(got[r].numpy()[:m], whole, rtol=0, atol=1e-5 * scale)
        assert world.counts[r] == {"collective-permute": 2 * (p - 1)}
    if p == 8:
        ab = [np.concatenate([a, b.T]) for a, b in zip(a_blocks, b_blocks)]  # one block a device
        ref = _heat_tpu(lambda x, i, axis: jcm.ring_matmul_reduce(x[:m], x[m:].T, axis, p, precision="highest"), ab)
        for r in range(p):
            np.testing.assert_allclose(got[r].numpy(), ref[r], rtol=0, atol=1e-5 * scale)


def test_rings_are_off_unless_forced(monkeypatch):
    monkeypatch.delenv("HEAT_TPU_REDIST_OVERLAP", raising=False)
    assert not cmatmul.ring_enabled()
    monkeypatch.setenv("HEAT_TPU_REDIST_OVERLAP", "auto")
    monkeypatch.setenv("HEAT_TPU_TOPOLOGY", "2x4")
    assert not cmatmul.ring_enabled() and not jcm.ring_enabled()  # heat_tpu off the TPU, and tiered
    monkeypatch.setenv("HEAT_TPU_REDIST_OVERLAP", "1")
    assert cmatmul.ring_enabled() and jcm.ring_enabled()
    monkeypatch.setenv("HEAT_TPU_REDIST_OVERLAP", "0")
    assert not cmatmul.ring_enabled()


# --------------------------------------------------------------------- #
# the world                                                             #
# --------------------------------------------------------------------- #
RING_CASES = [f"ring_qr_{label}_{t}" for label in worker.RING_QR for t in worker.WIRE_TOPOLOGIES] + [
    "ring_matmul", "ring_polar", "ring_lu", "ring_cholesky", "ring_solve_gen", "ring_solve_pos", "ring_hsvd"]
# what the ring replaces: exact (same bits as the barrier form) or rounded
# (the reduction in ring order), and which barrier collectives become rings
RING_KIND = {"ring_matmul": ("rounded", ("all-reduce",)), "ring_polar": ("rounded", ("all-gather", "all-reduce"))}


def _ring_counts(name, barrier):
    """The ring form's collectives from the barrier form's: size − 1
    permutes for each all-gather and broadcast it replaces (size p, or 2 for
    the two-level TSQR's groups at 2x2), 2(p − 1) for each all-reduce; the
    hSVD replaces only its TSQR merge's all-gather."""
    p = 2 if name.endswith("_2x2") else WORLD
    if name == "ring_hsvd":
        out = dict(barrier)
        out["all-gather"] -= 1
        out["collective-permute"] = p - 1
        return {k: v for k, v in out.items() if v}
    replaced = RING_KIND.get(name, ("exact", ("all-gather", "broadcast")))[1]
    out = {k: v for k, v in barrier.items() if k not in replaced}
    permutes = sum(barrier.get(k, 0) * (2 if k == "all-reduce" else 1) * (p - 1) for k in replaced)
    out["collective-permute"] = permutes
    return out


@pytest.mark.parametrize("name", RING_CASES)
def test_world_ring_forms_equal_their_barrier_forms(ranks, name):
    exactness = RING_KIND.get(name, ("exact",))[0]
    results = _result(ranks, name)
    for r, res in enumerate(results):
        ring, barrier = res["1"], res["0"]
        assert ring["counts"] == _ring_counts(name, barrier["counts"])
        assert "collective-permute" not in barrier["counts"] or name == "ring_hsvd"
        for got, want in zip(ring["parts"], barrier["parts"]):
            assert got.shape == want.shape
            if exactness == "exact":
                np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8),
                                              np.ascontiguousarray(want).view(np.uint8))
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    if exactness == "rounded":  # the replicated result: one on every rank, bit for bit
        rep = -1 if name == "ring_polar" else 0  # polar's H, the matmul's product
        for res in results[1:]:
            np.testing.assert_array_equal(res["1"]["parts"][rep], results[0]["1"]["parts"][rep])


def _up_to_sign(got, want, atol):
    signs = np.sign(np.sum(got * want, axis=1, keepdims=True))
    signs[signs == 0] = 1
    np.testing.assert_allclose(got * signs, want, rtol=0, atol=atol)


@pytest.mark.parametrize("label", list(worker.RING_QR))
@pytest.mark.parametrize("topology", worker.WIRE_TOPOLOGIES)
def test_world_ring_tsqr_matches_heat_tpus_ring(ranks, jcomm, label, topology, monkeypatch):
    """R against heat_tpu's TSQR with its rings on 4 devices (the topology
    gate set alike), up to the signs of its rows, within the world's QR
    bound (tests/test_torch_hsvd_dist.py)."""
    monkeypatch.setenv("HEAT_TPU_REDIST_OVERLAP", "1")
    monkeypatch.setenv("HEAT_TPU_TOPOLOGY", topology)
    a = worker.wire_matrix(worker.RING_QR[label], 2)
    jr = jht.linalg.qr(jht.array(a, split=0, comm=jcomm)).R.numpy()
    for res in _result(ranks, f"ring_qr_{label}_{topology}"):
        _up_to_sign(res["1"]["parts"][1], jr, 1e-5 * np.abs(a).max() * np.sqrt(a.shape[0]))


def test_world_collective_matmul_and_polar_match_heat_tpus_rings(ranks, jcomm, monkeypatch):
    """The collective matmul's product and polar's H against heat_tpu's
    rings on 4 devices: float32 rounding of their sums (1e-5 of Σ|a||b| for
    the product, test_torch_factorizations.py's 1e-5 relative for H)."""
    monkeypatch.setenv("HEAT_TPU_REDIST_OVERLAP", "1")
    a, b = worker.wire_matrix(worker.RING_MATMUL[0], 3), worker.wire_matrix(worker.RING_MATMUL[1], 4)
    want = jht.matmul(jht.array(a, split=1, comm=jcomm), jht.array(b, split=0, comm=jcomm)).numpy()
    scale = float((np.abs(a) @ np.abs(b)).max())
    for res in _result(ranks, "ring_matmul"):
        np.testing.assert_allclose(res["1"]["parts"][0], want, rtol=0, atol=1e-5 * scale)
    n = worker.RING_FACT_N
    jh = jht.linalg.polar(jht.array(worker.fact_matrix("gen", (n, n), seed=50), split=0, comm=jcomm))[1].numpy()
    for res in _result(ranks, "ring_polar"):
        np.testing.assert_allclose(res["1"]["parts"][1], jh, rtol=0, atol=1e-5 * np.abs(jh).max())
