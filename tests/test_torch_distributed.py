"""heat_tpu_torch in a 4-rank world against heat_tpu on a 4-device mesh.

One gloo world of 4 processes (``torch.multiprocessing``, joined through
``init_method=file://``, so no TCP port) runs every case of
``tests/torch_mp_worker.py`` once per session; under xdist the first worker
to need it runs it, and the others read its results. Each test compares
the ranks' results with ``heat_tpu`` on ``MeshCommunication(devices=
jax.devices()[:4])``: rank r's shard is the shard heat_tpu places on
device r, bit for bit for every redistribution; ``arange(N,
split=0).sum()`` is exact for integers and within 1e-6 Σ|x| for float32;
the collectives each rank issued equal the plan's ``collective_counts()``;
every entry point of slices 1–5 on a split operand matches heat_tpu; and
``ring_attention`` with a whole q and a split k/v equals heat_tpu's result
within test_torch_attention.py's float32 tolerance (rtol 2e-5, atol 2e-6:
both sides are float32 online softmaxes that sum in other orders)."""

import fcntl
import os
import pickle
import time

import jax
import numpy as np
import pytest

import heat_tpu as jht
from heat_tpu.core.communication import MeshCommunication
from heat_tpu.redistribution import RedistSpec, planner as jplanner

import torch_mp_worker as worker

WORLD = 4
TIMEOUT_S = 300


def _spawn(out_dir) -> None:
    import torch.multiprocessing as mp

    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(
        worker.run, args=(WORLD, str(out_dir / "init"), str(out_dir)), nprocs=WORLD, join=False,
        start_method="spawn",
    )
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD}-rank world did not finish in {TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's {case: result}, from the session's one 4-rank world."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    out_dir = root / "torch_world"
    with open(root / "torch_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out_dir / "done").exists():
            _spawn(out_dir)
            (out_dir / "done").write_text("")
    out = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


_J4 = []


@pytest.fixture(scope="module")
def jcomm():
    return _jcomm()


def _jcomm():
    """heat_tpu's communicator over 4 of the 8 CPU devices of conftest.py."""
    if not _J4:
        _J4.append(MeshCommunication(devices=jax.devices()[:WORLD]))
    return _J4[0]


def _result(ranks, name, r=None):
    """The case's result on rank r (every rank's when r is None); a case
    that raised fails the test with its traceback."""
    out = [ranks[q][name] for q in (range(WORLD) if r is None else [r])]
    for res in out:
        if isinstance(res, dict) and "error" in res:
            pytest.fail(f"{name} raised {res['error']}\n{res.get('trace', '')}")
    return out if r is None else out[0]


def _slices(gshape, split, r):
    """heat_tpu's slices of device r's shard."""
    return _jcomm().chunk(gshape, split, rank=r)[2]


def _shard(a: np.ndarray, split, r) -> np.ndarray:
    return a if split is None else a[_slices(a.shape, split, r)]


def _eq_bits(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    if got.size:
        words = [np.ascontiguousarray(a).view(np.uint8) for a in (got, want)]
        np.testing.assert_array_equal(*words)


def _plan(gshape, dtype, src, dst, reshape_to=None, budget=None):
    """heat_tpu's plan of the same move on 4 devices."""
    spec = RedistSpec.normalize(gshape, dtype, src, dst, WORLD, reshape_to=reshape_to)
    return jplanner.plan(spec, budget, quant="0", topology="flat")


# --------------------------------------------------------------------- #
# the world                                                             #
# --------------------------------------------------------------------- #
def test_a_four_rank_world_reports_size_4_and_ranks_0_to_3(ranks):
    got = [_result(ranks, "world", r) for r in range(WORLD)]
    assert got == [{"rank": r, "size": WORLD, "distributed": True} for r in range(WORLD)]


@pytest.mark.parametrize("n", [1000, 1003])
@pytest.mark.parametrize("dt", ["int32", "float32"])
def test_arange_sum_across_ranks(ranks, jcomm, n, dt):
    ref = jht.arange(n, dtype=getattr(jht, dt), split=0, comm=jcomm).sum()
    exact = n * (n - 1) // 2
    for r, res in enumerate(_result(ranks, f"sum_arange_{n}_{dt}")):
        assert res["dtype"] == ref.dtype.__name__ and res["split"] is None
        assert res["counts"] == {"all-reduce": 1}
        assert res["lshape"] == jcomm.chunk((n,), 0, rank=r)[1]
        if dt == "int32":
            assert res["value"] == exact == ref.item()
        else:
            assert abs(res["value"] - exact) <= 1e-6 * exact
            assert abs(res["value"] - ref.item()) <= 1e-6 * exact
    assert sum(res["local_sum"] for res in _result(ranks, f"sum_arange_{n}_{dt}")) == exact


@pytest.mark.parametrize("axis, keep", [(0, False), (1, False), (1, True), (None, False)])
def test_sum_over_axes_keeps_heat_tpus_split(ranks, jcomm, axis, keep):
    a = np.arange(7 * 5, dtype=np.int64).reshape(7, 5)
    ref = jht.array(a, split=0, comm=jcomm).sum(axis=axis, keepdims=keep)
    for r, res in enumerate(_result(ranks, f"sum_axis_{axis}_{keep}")):
        assert (res["split"], res["gshape"], res["dtype"]) == (ref.split, ref.gshape, ref.dtype.__name__)
        np.testing.assert_array_equal(res["global"], ref.numpy())
        np.testing.assert_array_equal(res["local"], _shard(ref.numpy(), ref.split, r))


def test_bool_sum_across_ranks(ranks, jcomm):
    ref = jht.array(np.eye(6, 9, dtype=bool), split=1, comm=jcomm).sum().item()
    assert [res["value"] for res in _result(ranks, "sum_bool_split1")] == [ref] * WORLD == [6] * WORLD


# --------------------------------------------------------------------- #
# resplit and reshape, bit for bit                                      #
# --------------------------------------------------------------------- #
SHAPES = {"2d_even": (8, 12), "2d_ragged": (7, 5), "3d_even": (8, 4, 6), "3d_ragged": (5, 7, 3)}
RESPLITS = [(label, src, dst) for label in SHAPES for src in (None, 0, 1) for dst in (None, 0, 1) if src != dst]


def _check_moved(results, ref, gshape, dtype, src, dst, reshape_to=None, budget=None):
    """Each rank holds heat_tpu's device-r shard of ``ref`` bit for bit and
    issued the collectives of heat_tpu's plan."""
    want = ref.numpy()
    sched = _plan(gshape, dtype, src, dst, reshape_to, budget)
    for r, res in enumerate(results):
        assert (res["split"], res["gshape"]) == (ref.split, ref.gshape)
        _eq_bits(res["local"], _shard(want, ref.split, r))
        assert res["lshape"] == res["local"].shape
        _eq_bits(res["global"], want)
        assert res["counts"] == res["plan"] == sched.collective_counts()
    return sched


@pytest.mark.parametrize("label, src, dst", RESPLITS, ids=[f"{l}-{s}to{d}" for l, s, d in RESPLITS])
def test_resplit_matches_heat_tpu_bit_for_bit(ranks, jcomm, label, src, dst):
    shape = SHAPES[label]
    a = worker._array(shape, "float32", len(shape) * 10 + shape[0])
    ref = jht.array(a, split=src, comm=jcomm).resplit(dst)
    _check_moved(_result(ranks, f"resplit_{label}_{src}_{dst}"), ref, shape, "float32", src, dst)


@pytest.mark.parametrize("dt", ["int64", "bool", "complex64", "bfloat16", "float64"])
def test_resplit_moves_every_dtype_bit_for_bit(ranks, jcomm, dt):
    a = worker._array((7, 5), dt, 3)
    ref = jht.array(a, split=0, dtype=getattr(jht, dt), comm=jcomm).resplit(1)
    results = _result(ranks, f"resplit_dtype_{dt}")
    assert all(res["dtype"] == ref.dtype.__name__ for res in results)
    _check_moved(results, ref, (7, 5), dt, 0, 1)  # bfloat16 comes back widened to float32 on both sides


def test_in_place_resplit(ranks, jcomm):
    ref = jht.array(worker._array((7, 5), "float32", 4), split=1, comm=jcomm).resplit(0)
    results = _result(ranks, "resplit_in_place")
    for res in results:
        res["plan"] = res["counts"]
    _check_moved(results, ref, (7, 5), "float32", 1, 0)


@pytest.mark.parametrize("case, shape, strategy", [("resplit_chunked", (1024, 1024), "chunked-all-to-all"),
                                                   ("resplit_ring", (4, 262144), "ring")])
def test_small_budget_laps_and_ring(ranks, jcomm, case, shape, strategy):
    ref = jht.array(worker._array(shape, "float32", 5), split=0, comm=jcomm).resplit(1)
    results = _result(ranks, case)
    sched = _check_moved(results, ref, shape, "float32", 0, 1, budget=1 << 20)
    assert sched.strategy == strategy and all(res["strategy"] == strategy for res in results)


RESHAPES = {
    "local": ((64, 48), 0, (32, 96), 0, "float32", "local-reshape"),
    "pivot": ((64, 48), 0, (96, 32), 1, "float32", "split0-pivot"),
    "pivot_in": ((64, 48), 1, (96, 32), 0, "float32", "packed-pivot"),
    "packed": ((2048, 64), 1, (8192, 16), 1, "float32", "packed-pivot"),
    "packed_rev": ((8192, 16), 1, (2048, 64), 1, "float32", "packed-pivot"),
    "packed_bf16": ((2048, 64), 1, (8192, 16), 1, "bfloat16", "packed-pivot"),
    "gather": ((1000, 26), 1, (26, 1000), 1, "float32", "gather-reshape"),
    "replicated": ((64, 48), None, (96, 32), 1, "float32", "local-reshape"),
    "ragged_3d": ((6, 5, 4), 2, (5, 6, 4), 1, "int32", "gather-reshape"),
}


@pytest.mark.parametrize("label", list(RESHAPES))
def test_reshape_new_split_matches_heat_tpu_bit_for_bit(ranks, jcomm, label):
    shape, src, out_shape, dst, dt, strategy = RESHAPES[label]
    x = jht.array(worker._array(shape, dt, shape[0]), split=src, dtype=getattr(jht, dt), comm=jcomm)
    ref = jht.reshape(x, out_shape, new_split=dst)
    results = _result(ranks, f"reshape_{label}")
    sched = _check_moved(results, ref, shape, dt, src, dst, reshape_to=out_shape)
    assert sched.strategy == strategy and all(res["strategy"] == strategy for res in results)
    if strategy == "packed-pivot":  # the steps that run K6 (a packed source) and K5 (a packed target)
        assert results[0]["packs"] == [st.kind for st in sched.steps if st.kind in ("pack", "unpack")]


# --------------------------------------------------------------------- #
# layout                                                                #
# --------------------------------------------------------------------- #
def test_numpy_lshape_map_and_counts_displs_match_heat_tpu(ranks, jcomm):
    x = jht.array(worker._array((10, 3), "float32", 6), split=0, comm=jcomm)
    y = jht.array(worker._array((3, 10), "float32", 7), split=1, comm=jcomm)
    for r, res in enumerate(_result(ranks, "layout")):
        np.testing.assert_array_equal(res["x_map"], x.lshape_map)
        np.testing.assert_array_equal(res["y_map"], y.lshape_map)
        assert res["x_cd"] == tuple(x.counts_displs()) and res["y_cd"] == tuple(y.counts_displs())
        _eq_bits(res["x_global"], x.numpy())
        _eq_bits(res["y_global"], y.numpy())
        _eq_bits(res["x_local"], x.numpy()[_slices((10, 3), 0, r)])
        assert res["balanced"] == (True, True)


def test_redistribute_moves_to_a_target_map_and_back(ranks, jcomm):
    a = worker._array((10, 3), "float32", 6)
    counts = [1, 2, 3, 4]
    starts = np.cumsum([0] + counts)
    ref_resplit = jht.array(a, split=0, comm=jcomm).resplit(1).numpy()
    for r, res in enumerate(_result(ranks, "redistribute")):
        assert res["lshape"] == (counts[r], 3) and not res["balanced"]
        np.testing.assert_array_equal(res["map"], [[c, 3] for c in counts])
        assert res["cd"] == (tuple(counts), tuple(int(s) for s in starts[:-1]))
        _eq_bits(res["global"], a)
        _eq_bits(res["resplit_local"], ref_resplit[_slices((10, 3), 1, r)])
        assert res["after_balance"] == (_jcomm().chunk((10, 3), 0, rank=r)[1], True)
        np.testing.assert_array_equal(res["sum"], a.sum(axis=1))


def test_larray_setter_and_is_split_gather_the_global_shape(ranks):
    want = np.concatenate([np.full((r + 1, 3), float(r), np.float32) for r in range(WORLD)])
    for res in _result(ranks, "larray_setter"):
        assert res["gshape"] == (10, 3) and res["z_gshape"] == (10, 2) and not res["balanced"]
        np.testing.assert_array_equal(res["map"], [[r + 1, 3] for r in range(WORLD)])
        np.testing.assert_array_equal(res["global"], want)
        np.testing.assert_array_equal(res["z_global"], np.concatenate([np.full((r + 1, 2), r) for r in range(WORLD)]))


def test_split_factories_hold_heat_tpus_shards(ranks, jcomm):
    results = _result(ranks, "factories")
    for r, res in enumerate(results):
        for key, split in (("eye", 0), ("eye1", 1)):
            ref = jht.eye((7, 5), split=split, comm=jcomm).numpy()
            np.testing.assert_array_equal(res[key], ref[_slices((7, 5), split, r)])
        assert res["zeros"] == _jcomm().chunk((5, 3), 1, rank=r)[1]
        ref = jht.arange(3, 20, 2, split=0, comm=jcomm).numpy()
        np.testing.assert_array_equal(res["arange"], ref[_slices(ref.shape, 0, r)])
        np.testing.assert_array_equal(res["randn_same"], results[0]["randn_same"])  # one global draw


def test_interop_gives_each_rank_heat_tpus_shard(ranks, jcomm):
    ref = jht.array(worker._array((9, 4), "float64", 9), split=0, comm=jcomm)
    for r, res in enumerate(_result(ranks, "interop")):
        assert (res["dtype"], res["gshape"]) == ("float64", (9, 4))
        _eq_bits(res["local"], _shard(ref.numpy(), 0, r))


# --------------------------------------------------------------------- #
# the entry points of slices 1-5 on a split operand                     #
# --------------------------------------------------------------------- #
def _entry_reference(name, jcomm):
    """heat_tpu's result of the ``entry_<name>`` case on 4 devices."""
    split_x = lambda shape=(40, 6), split=0: jht.array(worker._array(shape, "float32", 8), split=split, comm=jcomm)
    if name == "sparse_csr_split":
        return jht.sparse.sparse_csr_matrix(np.eye(8, dtype=np.float32), split=0, comm=jcomm).todense()
    if name == "sparse_dbcsr_split":
        return jht.sparse.sparse_dbcsr_matrix(np.eye(8, dtype=np.float32), split=0, comm=jcomm).todense()
    if name == "sparse_matmul_split_x":
        return jht.sparse.matmul(jht.sparse.sparse_csr_matrix(np.eye(40, dtype=np.float32), comm=jcomm), split_x())
    if name == "sddmm_split_u":
        return jht.sparse.sddmm(jht.sparse.sparse_dbcsr_matrix(np.eye(40, 6, dtype=np.float32), comm=jcomm),
                                split_x((40, 4)), split_x((6, 4), None)).todense()
    return jht.graph.pagerank(np.ones((8, 8), dtype=np.float32), comm=jcomm).ranks


SPLIT_ENTRIES = ["sparse_csr_split", "sparse_dbcsr_split", "sparse_matmul_split_x", "sddmm_split_u", "pagerank"]


@pytest.mark.parametrize("name", SPLIT_ENTRIES)
def test_entry_points_on_a_split_operand_match_heat_tpu(ranks, jcomm, name):
    """The sparse entry points that refused a split operand before the
    sparse engine ran across ranks (ROADMAP.md Queue 1, item 15): each
    rank's part and the gathered result equal heat_tpu's (1e-6 for the
    products and the ranks, which sum in another order)."""
    ref = _entry_reference(name, jcomm)
    want = ref.numpy()
    for r, res in enumerate(_result(ranks, f"entry_{name}")):
        assert (res["split"], res["gshape"]) == (ref.split, ref.gshape)
        np.testing.assert_allclose(res["global"], want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(res["local"], _shard(want, ref.split, r), rtol=0, atol=1e-6)


def test_entry_points_along_other_axes_match_heat_tpu(ranks, jcomm):
    x = jht.array(worker._array((12, 8), "float32", 8), split=0, comm=jcomm)
    v, i = jht.sort(x, axis=1)
    tv, ti = jht.topk(x, 3, dim=1)
    f = jht.flip(x, 1)
    m = jht.moveaxis(jht.array(worker._array((4, 6, 5), "float32", 8), split=1, comm=jcomm), 1, 2)
    for r, res in enumerate(_result(ranks, "entry_served")):
        sl = _slices((12, 8), 0, r)
        lv, li, gshape, split = res["sort"]
        assert (gshape, split) == (v.gshape, v.split)
        np.testing.assert_array_equal(lv, v.numpy()[sl])
        np.testing.assert_array_equal(li, i.numpy()[sl])
        np.testing.assert_array_equal(res["sort_global"], v.numpy())
        np.testing.assert_array_equal(res["topk"][0], tv.numpy()[sl])
        np.testing.assert_array_equal(res["topk"][1], ti.numpy()[sl])
        np.testing.assert_array_equal(res["flip"], f.numpy()[sl])
        lm, mshape, msplit = res["moveaxis"]
        assert (mshape, msplit) == (m.gshape, m.split)
        np.testing.assert_array_equal(lm, m.numpy()[_slices(m.gshape, m.split, r)])


# --------------------------------------------------------------------- #
# ring_attention with a whole q at world size 4                         #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal, k_split, v_split", worker.ATTENTION_UNSPLIT_Q)
def test_ring_attention_with_unsplit_q_matches_heat_tpu(ranks, jcomm, causal, k_split, v_split):
    q, k, v = (worker._array(worker.ATTENTION_SHAPE, "float32", seed) for seed in (31, 32, 33))
    jq, jk, jv = (jht.array(a, split=split, comm=jcomm) for a, split in ((q, None), (k, k_split), (v, v_split)))
    ref = jht.nn.ring_attention(jq, jk, jv, causal=causal)
    assert ref.split is None
    want = ref.numpy()
    for res in _result(ranks, f"attention_unsplit_q_{causal}_{k_split}_{v_split}"):
        assert res["split"] is None and res["gshape"] == ref.gshape == worker.ATTENTION_SHAPE
        assert (res["k_split"], res["v_split"]) == (k_split, v_split)  # the caller's operands keep their split
        np.testing.assert_allclose(res["local"], want, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(res["global"], want, rtol=2e-5, atol=2e-6)
