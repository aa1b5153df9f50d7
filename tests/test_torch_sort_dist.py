"""The distributed sort family of heat_tpu_torch against heat_tpu.

Two levels:

- the 4-rank gloo world of test_torch_distributed.py (the cases of
  ``_sort_cases`` in torch_mp_worker.py, run once per pytest run) against
  heat_tpu on ``MeshCommunication(devices=jax.devices()[:4])``, on NumPy
  inputs from a seed: ``sort`` over the odd-even network (n = 5, 37, 40)
  and columnsort (95 and 1021 with pads, 96 and 1024 without), in both
  directions, for float32 with NaN, ±0, ±inf and heavy duplicates, int32
  and int64 with their type-max, float64, bool and complex (gathered), and
  along split 0 of a 2-D array (batch lanes); the values-only programs;
  ``topk`` with k ≤ B and k > B, NaNs of both signs against the pads;
  flat ``unique`` and ``unique(axis=)`` with their inverses (complex
  values with NaN parts against ``jnp.unique`` of the whole array); the
  split-axis ``flip``; ``permute``'s one-sided ends. Each rank holds heat_tpu's
  device-r shard: indices and integers exactly, float values equal under
  ``lax.sort``'s comparator (±0 tie, NaNs match as NaN), ``topk``'s and
  ``unique``'s values bit for bit; splits and shapes as heat_tpu's; the
  port's own collectives a call pinned per network;
- one process: ``block_sort`` against ``lax.sort`` on the same operands,
  every route (K4's plain version for float32 and int32, two stable
  ``torch.sort`` passes otherwise), batch lanes along either axis, and the
  K4 entry and index bytes each dtype and extent takes;
  ``_columnsort_local`` against heat_tpu's at p = 4, 8 and 16; ``permute``
  at world size 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu.core import manipulations as jmanip
from heat_tpu.core import parallel as jparallel
from heat_tpu.kernels import sort as jsort
from heat_tpu_torch.core import parallel
from heat_tpu_torch.kernels import sort as ks

import torch_mp_worker as worker
from test_torch_distributed import WORLD, _eq_bits, _result, _shard, jcomm, ranks  # noqa: F401 (fixtures)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])  # heat_tpu turns x64 on for the CPU with its first array


def _same_under_comparator(got, want):
    """Equal with NaN matched as NaN (any payload) and −0.0 equal to +0.0;
    integers and bools exactly."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    if np.iscomplexobj(want):
        _same_under_comparator(got.real, want.real)
        _same_under_comparator(got.imag, want.imag)
    elif want.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got[~np.isnan(want)], want[~np.isnan(want)])
    else:
        np.testing.assert_array_equal(got, want)


def _check_shards(results, key, ref, r_check):
    """Every rank's ``results[key]`` holds heat_tpu's device-r shard of
    ``ref`` (checked by ``r_check``), with its split, shape and dtype."""
    want = ref.numpy()
    for r, res in enumerate(results):
        got = res[key]
        assert (got["split"], got["gshape"], got["dtype"]) == (ref.split, ref.gshape, ref.dtype.__name__)
        r_check(got["local"], _shard(want, ref.split, r))
        r_check(got["global"], want)


def _rounds(p: int) -> int:
    """Rounds of the odd-even network that pair some ranks."""
    return sum(1 for t in range(p) if range(t % 2, p - 1, 2))


def _network_counts(n: int, descending: bool) -> dict:
    """The port's collectives in one distributed ``sort`` of n rows."""
    B = -(-n // WORLD)
    flips = 2 if descending else 0
    if parallel.columnsort_applicable(WORLD, B):
        return {"all-to-all": 2 + flips, "collective-permute": 2}
    return {"collective-permute": _rounds(WORLD), **({"all-to-all": flips} if flips else {})}


# --------------------------------------------------------------------- #
# sort across ranks                                                     #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dt", worker.SORT_DTYPES)
@pytest.mark.parametrize("n", worker.SORT_NS)
def test_sort_across_ranks_matches_heat_tpu(ranks, jcomm, n, dt, descending):
    x = worker.sort_data((n,), dt, n)
    v, i = jht.sort(jht.array(x, split=0, comm=jcomm), descending=descending)
    results = _result(ranks, f"sort_{n}_{dt}_{descending}")
    _check_shards(results, "v", v, _same_under_comparator)
    _check_shards(results, "i", i, np.testing.assert_array_equal)
    B = -(-n // WORLD)
    assert parallel.columnsort_applicable(WORLD, B) == jparallel._columnsort_applicable(WORLD, B)
    for res in results:
        if dt == "complex64":  # gathered and argsorted, as heat_tpu does
            assert "collective-permute" not in res["counts"] and res["counts"].get("all-gather", 0) >= 1
        else:
            assert res["counts"] == _network_counts(n, descending)


@pytest.mark.parametrize("n", [n for n in worker.SORT_NS if parallel.columnsort_applicable(WORLD, -(-n // WORLD))])
@pytest.mark.parametrize("dt", ["float32", "int32"])
def test_four_rank_columnsort_equals_the_one_process_schedule(ranks, n, dt):
    x = worker.sort_data((n,), dt, n)
    got = _result(ranks, f"sort_{n}_{dt}_False", 0)
    sv, si = ks._columnsort_local((torch.from_numpy(x), torch.arange(n)), 2, WORLD, -(-n // WORLD), n)
    _same_under_comparator(got["v"]["global"], sv.numpy())
    np.testing.assert_array_equal(got["i"]["global"], si.numpy())


@pytest.mark.parametrize("dt", ["float32", "int32"])
@pytest.mark.parametrize("shape", worker.SORT_2D)
def test_sort_of_batch_lanes_across_ranks(ranks, jcomm, shape, dt):
    v, i = jht.sort(jht.array(worker.sort_data(shape, dt, shape[0]), split=0, comm=jcomm), axis=0)
    results = _result(ranks, f"sort2d_{shape[0]}_{dt}")
    _check_shards(results, "v", v, _same_under_comparator)
    _check_shards(results, "i", i, np.testing.assert_array_equal)


@pytest.mark.parametrize("n", worker.VALUES_NS)
def test_values_only_programs_match_heat_tpu(ranks, jcomm, n):
    a = jht.array(worker.sort_data((n,), "float32", n), split=0, comm=jcomm)
    want = jmanip._sorted_values(a, 0).numpy()
    results = _result(ranks, f"sort_values_{n}")
    whole = np.concatenate([res["block"] for res in results])
    B = -(-n // WORLD)
    assert whole.shape == (WORLD * B,) and np.isnan(whole[n:]).all()  # the pads, at the tail
    _same_under_comparator(whole[:n], want)
    expect = ({"all-to-all": 2, "collective-permute": 2} if parallel.columnsort_applicable(WORLD, B)
              else {"collective-permute": _rounds(WORLD)})
    assert all(res["counts"] == expect for res in results)


# --------------------------------------------------------------------- #
# topk, unique and flip across ranks                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dt", worker.TOPK_DTYPES)
@pytest.mark.parametrize("n, k", worker.TOPK)
def test_topk_across_ranks_matches_heat_tpu(ranks, jcomm, n, k, dt, largest):
    x = worker.sort_data((n,), dt, n + k)
    v, i = jht.topk(jht.array(x, split=0, comm=jcomm), k, largest=largest)
    results = _result(ranks, f"topk_{n}_{k}_{dt}_{largest}")
    assert v.split is None
    _check_shards(results, "v", v, _eq_bits)
    _check_shards(results, "i", i, np.testing.assert_array_equal)
    assert all(res["counts"] == ({"all-gather": 1} if k else {}) for res in results)


def test_topk_of_batch_lanes_across_ranks(ranks, jcomm):
    v, i = jht.topk(jht.array(worker.sort_data((37, 3), "float32", 7), split=0, comm=jcomm), 4, dim=0)
    results = _result(ranks, "topk_2d")
    _check_shards(results, "v", v, _eq_bits)
    _check_shards(results, "i", i, np.testing.assert_array_equal)


@pytest.mark.parametrize("shape, split, dt", worker.UNIQUE_FLAT)
def test_flat_unique_across_ranks_matches_heat_tpu(ranks, jcomm, shape, split, dt):
    u, inv = jht.unique(jht.array(worker.sort_data(shape, dt, shape[0]), split=split, comm=jcomm),
                        return_inverse=True)
    results = _result(ranks, f"unique_{'x'.join(map(str, shape))}_{split}_{dt}")
    assert u.split == 0 and inv.split == 0 and inv.gshape == (int(np.prod(shape)),)
    _check_shards(results, "u", u, _eq_bits)  # each group's first member in global order
    _check_shards(results, "inv", inv, np.testing.assert_array_equal)
    for res in results:
        _eq_bits(res["plain"]["global"], u.numpy())
        if len(shape) == 1 and split == 0:  # counts, then the candidates; the inverse is in place
            assert res["counts"] == {"all-gather": 2}


@pytest.mark.parametrize("n", worker.UNIQUE_COMPLEX_NAN)
def test_flat_unique_of_complex_nans_across_ranks_matches_jnp_unique(ranks, n):
    """Complex values with NaN parts: every NaN is one value, as
    ``jnp.unique`` of the whole array makes it (``heat_tpu``'s distributed
    branch keeps several NaN groups; ROADMAP, Not faults)."""
    u, inv = (np.asarray(t) for t in jnp.unique(jnp.asarray(worker.complex_nan_data(n, n)), return_inverse=True))
    inv = inv.reshape(-1)
    assert np.isnan(u).sum() == 1
    for r, res in enumerate(_result(ranks, f"unique_complex_nan_{n}")):
        assert (res["u"]["split"], res["inv"]["split"], res["inv"]["gshape"]) == (0, 0, (n,))
        _eq_bits(res["u"]["global"], u)
        _eq_bits(res["u"]["local"], _shard(u, 0, r))
        np.testing.assert_array_equal(res["inv"]["global"], inv)
        np.testing.assert_array_equal(res["inv"]["local"], _shard(inv, 0, r))


@pytest.mark.parametrize("shape, split, axis, dt", worker.UNIQUE_AXIS)
def test_unique_along_an_axis_across_ranks_matches_heat_tpu(ranks, jcomm, shape, split, axis, dt):
    data = worker.sort_data(shape, dt, shape[0])
    if dt == "int32":
        data = data % 3
    u, inv = jht.unique(jht.array(data, split=split, comm=jcomm), return_inverse=True, axis=axis)
    results = _result(ranks, f"unique_axis_{'x'.join(map(str, shape))}_{split}_{axis}_{dt}")
    _check_shards(results, "u", u, _eq_bits)  # canonical values (rows formulation) or gathered
    _check_shards(results, "inv", inv, np.testing.assert_array_equal)


@pytest.mark.parametrize("shape, split, axis", worker.FLIPS)
def test_flip_of_the_split_axis_matches_heat_tpu(ranks, jcomm, shape, split, axis):
    ref = jht.flip(jht.array(np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape), split=split,
                             comm=jcomm), axis)
    results = _result(ranks, f"flip_{'x'.join(map(str, shape))}_{split}_{axis}")
    for r, res in enumerate(results):
        assert (res["split"], res["gshape"]) == (ref.split, ref.gshape)
        _eq_bits(res["local"], _shard(ref.numpy(), split, r))
        _eq_bits(res["global"], ref.numpy())
        assert res["counts"] == {"all-to-all": 1}


def test_permute_leaves_the_ends_of_a_shift_zero(ranks):
    results = _result(ranks, "permute")
    for r, res in enumerate(results):
        fwd, bwd, swap = res["got"]
        np.testing.assert_array_equal(fwd, np.full(3, float(r) if r > 0 else 0.0, np.float32))
        np.testing.assert_array_equal(bwd, np.full(3, float(r + 2) if r < WORLD - 1 else 0.0, np.float32))
        np.testing.assert_array_equal(swap, np.full(3, {0: 2.0, 1: 1.0}.get(r, 0.0), np.float32))
        assert res["counts"] == {"collective-permute": 3}
        assert "partial permutation" in res["refused"]


# --------------------------------------------------------------------- #
# one process                                                           #
# --------------------------------------------------------------------- #
BLOCK_DTYPES = ["float32", "int32", "float64", "int64", "bool", "float16"]
BLOCK_LAYOUTS = {"1d": ((257,), 0), "lanes_axis0": ((33, 7), 0), "lanes_axis1": ((5, 40), 1)}


def _block_operands(shape, dt, axis, extent, seed=3):
    """Values with duplicates and specials, and distinct int64 indices in
    [0, extent) in shuffled order along ``axis`` (the same in every lane)."""
    x = worker.sort_data(shape, "float32" if dt == "float16" else dt, seed).astype(dt)
    rng = np.random.default_rng(seed)
    pos = rng.permutation(extent)[: shape[axis]].astype(np.int64)
    idx = np.broadcast_to(np.expand_dims(pos, 1 - axis) if len(shape) == 2 else pos, shape).copy()
    return x, idx


@pytest.mark.parametrize("num_keys", [1, 2])
@pytest.mark.parametrize("layout", list(BLOCK_LAYOUTS))
@pytest.mark.parametrize("dt", BLOCK_DTYPES)
def test_block_sort_matches_lax_sort(dt, layout, num_keys):
    shape, axis = BLOCK_LAYOUTS[layout]
    x, idx = _block_operands(shape, dt, axis, 70_000 if layout == "1d" else shape[axis])
    ops = (x, idx)[:num_keys]
    want = lax.sort(tuple(jnp.asarray(o) for o in ops), dimension=axis, num_keys=num_keys, is_stable=True)
    extent = 70_000 if layout == "1d" else shape[axis]
    got = ks.block_sort([torch.from_numpy(o) for o in ops], axis, num_keys, extent=extent)
    _same_under_comparator(got[0].numpy(), np.asarray(want[0]))
    if num_keys == 2:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_block_sort_needs_the_extent_of_its_indices():
    with pytest.raises(ValueError, match="extent"):
        ks.block_sort([torch.zeros(4), torch.arange(4)], 0, 2)


@pytest.mark.parametrize("extent, pay_bytes", [(1 << 16, 2), ((1 << 16) + 1, 4), (None, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.float64])
def test_block_sort_routes_float32_and_int32_to_k4(monkeypatch, dtype, extent, pay_bytes):
    """float32 and int32 take K4 (the fused entry for values, the pair sort
    with the index's 2 or 4 low bytes for pairs), one segment a lane; other
    dtypes take neither."""
    calls = []
    real_pair, real_fused = ks.pair_sort, ks.fused_sort

    def pair(keys, pays, seg_len, pay_bytes):
        calls.append(("pair", seg_len, pay_bytes))
        return real_pair(keys, pays, seg_len, pay_bytes)

    def fused(x, seg_len=None, **kw):
        calls.append(("fused", seg_len, None))
        return real_fused(x, seg_len, **kw)

    monkeypatch.setattr(ks, "pair_sort", pair)
    monkeypatch.setattr(ks, "fused_sort", fused)
    x = torch.arange(24, dtype=dtype).reshape(3, 8).flip(1).contiguous()
    if extent is None:
        ks.block_sort([x], 1, 1)
        want = [("fused", 8, None)]
    else:
        ks.block_sort([x, torch.arange(24).reshape(3, 8)], 1, 2, extent=extent)
        want = [("pair", 8, pay_bytes)]
    assert calls == (want if dtype != torch.float64 else [])


@pytest.mark.parametrize("num_keys", [1, 2])
@pytest.mark.parametrize("p, b, n", [(4, 20, 77), (8, 104, 832), (16, 464, 7400)])
def test_columnsort_local_matches_heat_tpu(p, b, n, num_keys):
    x = worker.sort_data((n,), "float32", n)
    idx = np.arange(n)
    keys = jsort.to_sortable(jnp.asarray(x))
    want = jsort._columnsort_local((keys, jnp.asarray(idx, jnp.int32))[:num_keys], num_keys, p, b, n)
    got = ks._columnsort_local((torch.from_numpy(x), torch.from_numpy(idx))[:num_keys], num_keys, p, b, n)
    _same_under_comparator(got[0].numpy(), np.asarray(jsort.from_sortable(want[0], jnp.float32)))
    if num_keys == 2:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[1].numpy(), np.lexsort((idx, ks.to_sortable(torch.from_numpy(x)).numpy()
                                                                  .view(np.uint32))))


def test_permute_at_world_size_1():
    comm = ht.get_comm()
    t = torch.arange(5.0)
    np.testing.assert_array_equal(comm.permute(t, [(0, 0)]).numpy(), t.numpy())
    np.testing.assert_array_equal(comm.permute(t, []).numpy(), np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="partial permutation"):
        comm.permute(t, [(0, 1)])
