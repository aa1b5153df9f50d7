"""heat_tpu_torch's SPMD primitives against heat_tpu's: the halo exchange
(``parallel.halo_exchange``, ``DNDarray.get_halo``, ``halo_prev``,
``halo_next``, ``array_with_halos``), ``parallel.ring_pairwise``,
``signal.convolve`` and the tile maps (``SplitTiles``,
``SquareDiagTiles``), with the cases of tests/test_parallel_primitives.py
(TestHaloExchange, TestGetHalo, TestDistributedConvolve,
TestRingPairwise), tests/test_indexing_signal_io.py and the tiling cases
of tests/test_linalg.py.

At world size 1 the port is held against heat_tpu on a 1-device mesh
(where the mesh's blocks show: halos, tiles, the ring; and ``convolve``,
whose values do not depend on the mesh) and on conftest.py's 8-device mesh
elsewhere. Tolerances: halos, tiles and integer
convolutions exactly; float32 convolutions within 1e-5 of Σ|a||v|,
float64 within 1e-12 of it; the ring as tests/test_torch_spatial.py holds
``cdist`` (rtol 1e-5, atol 1e-5 of the largest distance). The 4-rank
cases are ``_halo_cases`` of torch_mp_worker.py, in the test run's world,
held against heat_tpu on 4 devices where every rank holds rows (heat_tpu
exchanges between the mesh's padded blocks, so there a fully padded tail
hands on zeros), else against NumPy.
"""

import jax
import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu.core import parallel as jparallel
from heat_tpu.core.communication import MeshCommunication
from heat_tpu_torch.core import parallel
from test_torch_distributed import jcomm, ranks  # noqa: F401 (the test run's 4-rank world)
from test_torch_elementwise import numpy_of, release_programs, run_both, same, values


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])
    yield
    release_programs()


_J1 = []


def j1():
    """heat_tpu's communicator over one device: its blocks are the whole
    array, as the port's shard is at world size 1."""
    if not _J1:
        _J1.append(MeshCommunication(devices=jax.devices()[:1]))
    return _J1[0]


# --------------------------------------------------------------------- #
# halos                                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("halo_prev,halo_next", [(1, 1), (2, 2), (1, 0), (0, 2), (0, 0)])
def test_halo_exchange_matches_heat_tpu(halo_prev, halo_next):
    """At world size 1 both ends are zeros: [0 | x | 0] (heat_tpu's block
    on a 1-device mesh)."""
    a = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    c = j1()
    ref = jparallel.halo_exchange(c.shard(jax.numpy.asarray(a), 0), c.mesh, c.axis_name, 0, halo_prev, halo_next)
    got = parallel.halo_exchange(torch.as_tensor(a), ht.get_comm(), 0, halo_prev, halo_next)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref1 = jparallel.halo_exchange(c.shard(jax.numpy.asarray(a.T.copy()), 1), c.mesh, c.axis_name, 1, halo_prev,
                                   halo_next)
    got1 = parallel.halo_exchange(torch.as_tensor(a.T.copy()), ht.get_comm(), 1, halo_prev, halo_next)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(ref1))
    with pytest.raises(ValueError):
        parallel.halo_exchange(torch.as_tensor(a), ht.get_comm(), 0, 9, 0)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("size", [0, 1, 3])
def test_get_halo_matches_heat_tpu(split, size):
    """TestGetHalo at world size 1: no neighbour, so no halo, and
    ``array_with_halos`` is the shard; the argument checks raise alike."""
    a = values((6, 5), "float32")
    got, ref = ht.array(a, split=split), jht.array(a, split=split, comm=j1())
    got.get_halo(size)
    ref.get_halo(size)
    assert got.halo_prev is None and got.halo_next is None
    assert ref.halo_prev is None and ref.halo_next is None
    np.testing.assert_array_equal(got.array_with_halos.numpy(), np.asarray(ref.array_with_halos))
    for bad, exc in (("1", TypeError), (-1, ValueError), (1.5, TypeError)):
        for x in (got, ref):
            with pytest.raises(exc):
                x.get_halo(bad)


def test_halos_are_dropped_on_rebind(ranks):  # noqa: F811
    """test_parallel_primitives.py::test_halo_cache_invalidated_on_rebind:
    after ``x.larray = ...`` ``array_with_halos`` is the new shard, in the
    4-rank world (``halo_rebind``) as at world size 1."""
    from test_torch_distributed import _result

    x = ht.arange(8, split=0, dtype=ht.float32)
    x.get_halo(1)
    x.larray = torch.arange(100.0, 108.0)
    assert float(x.array_with_halos.max()) >= 100.0
    for r, res in enumerate(_result(ranks, "halo_rebind")):
        np.testing.assert_array_equal(res["with"], 100.0 + np.arange(4 * r, 4 * r + 4, dtype=np.float32))
        assert res["prev"] is None and res["next"] is None


# --------------------------------------------------------------------- #
# convolve                                                               #
# --------------------------------------------------------------------- #
CONV = [(64, 3), (61, 5), (17, 3), (9, 8), (3, 11)]


def _conv_tol(a, v, dtype):
    scale = np.convolve(np.abs(a).astype(np.float64), np.abs(v).astype(np.float64)).max()
    return {"float32": 1e-5, "complex64": 1e-5, "float64": 1e-12, "complex128": 1e-12}[dtype] * scale


def _conv_cases():
    """Every size and mode in float32; two sizes (one the swap) in the
    other types."""
    out = [(mode, n, k, "float32") for n, k in CONV for mode in ("full", "same", "valid")]
    return out + [(mode, n, k, dt) for (n, k), modes in (((61, 5), ("full", "same", "valid")), ((3, 11), ("full",)))
                  for mode in modes for dt in ("float64", "int32", "bool", "complex64")]


@pytest.mark.parametrize("mode,n,k,dtype", _conv_cases())
def test_convolve_matches_heat_tpu(mode, n, k, dtype):
    """TestDistributedConvolve's and test_indexing_signal_io.py's inputs on
    a split signal, the kernel longer than the signal among them (the
    swap): values, type and split equal heat_tpu's, ints and bools
    exactly."""
    a, v = values((n,), dtype, seed=n), values((k,), dtype, seed=k + 1000)
    kw = {jht: {"comm": j1()}, ht: {}}
    got, ref = run_both(lambda lib: lib.convolve(lib.array(a, split=0, **kw[lib]), lib.array(v, **kw[lib]), mode=mode))
    if ref is None:
        assert mode == "same" and k % 2 == 0
        return
    assert (got.dtype.__name__, got.split, got.shape) == (ref.dtype.__name__, ref.split, ref.shape)
    if dtype in ("int32", "bool"):
        np.testing.assert_array_equal(numpy_of(got), numpy_of(ref))
    else:
        np.testing.assert_allclose(numpy_of(got), numpy_of(ref), rtol=0, atol=_conv_tol(a, v, dtype))
    want = np.convolve(a.astype(np.float64 if dtype == "bool" else a.dtype), v.astype(np.float64 if dtype == "bool"
                                                                                        else v.dtype), mode=mode)
    np.testing.assert_allclose(numpy_of(got), want, rtol=0, atol=_conv_tol(a, v, "float32") + 1e-12)


def test_convolve_arguments_as_in_heat_tpu():
    """test_indexing_signal_io.py::test_convolve_errors and the review
    regressions of test_parallel_primitives.py: 2-D input, an even kernel
    in mode same (before the swap), an unknown mode, empty input; NumPy
    arrays are taken; a whole signal gives a whole result."""
    for call in (lambda L: L.convolve(L.ones((3, 3)), L.ones(2)),
                 lambda L: L.convolve(L.ones(10), L.ones(4), mode="same"),
                 lambda L: L.convolve(L.ones(10), L.ones(3), mode="x"),
                 lambda L: L.convolve(L.zeros(0), L.ones(3))):
        run_both(call)
    for call in (lambda L: L.convolve(np.arange(7.0), np.ones(3)),
                 lambda L: L.convolve(L.array(np.arange(7.0)), L.array(np.ones(3), split=0), mode="same"),
                 lambda L: L.convolve(L.ones(3), L.arange(9, split=0, dtype=L.float32), mode="same"),
                 lambda L: L.convolve(L.arange(12, split=0), L.array(np.array([1, 2, 1])), mode="full")):
        got, ref = run_both(call)
        same(got, ref, "exact")


# --------------------------------------------------------------------- #
# the ring                                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "euclidean_direct", "sqeuclidean_direct",
                                    "manhattan"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_ring_pairwise_matches_heat_tpu(metric, symmetric):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 4)).astype(np.float32)
    y = x if symmetric else rng.standard_normal((6, 4)).astype(np.float32)
    c = j1()
    ref = np.array(jparallel.ring_pairwise(c.shard(jax.numpy.asarray(x), 0), c.shard(jax.numpy.asarray(y), 0),
                                           c.mesh, c.axis_name, metric=metric, symmetric=symmetric))
    got = parallel.ring_pairwise(torch.as_tensor(x), torch.as_tensor(y), ht.get_comm(), metric, symmetric).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if symmetric and metric == "euclidean":  # the quadratic form's diagonal is sqrt of float32 rounding
        np.fill_diagonal(got, 0.0)
        np.fill_diagonal(ref, 0.0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    for lib_ring, args in ((jparallel.ring_pairwise, (c.shard(jax.numpy.asarray(x), 0),) * 2 + (c.mesh, c.axis_name)),
                           (parallel.ring_pairwise, (torch.as_tensor(x),) * 2 + (ht.get_comm(),))):
        with pytest.raises(ValueError):
            lib_ring(*args, metric="cosine")


# --------------------------------------------------------------------- #
# tile maps                                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 0, 1])
def test_split_tiles_match_heat_tpu(split):
    """TestTiling's SplitTiles cases: geometry, reads (a tile, a run of
    tiles, the whole rebuilt), a write through."""
    a = values((13, 5), "float32")
    got, ref = ht.array(a, split=split), jht.array(a, split=split, comm=j1())
    tg, tr = ht.tiling.SplitTiles(got), jht.tiling.SplitTiles(ref)
    for t in (tg, tr):
        assert len(t.tile_dimensions) == 2 and t.lshape_map.shape == (1, 2)
    for d in range(2):
        np.testing.assert_array_equal(tg.tile_dimensions[d], tr.tile_dimensions[d])
    np.testing.assert_array_equal(tg.tile_ends_g, tr.tile_ends_g)
    np.testing.assert_array_equal(tg.tile_locations, tr.tile_locations)
    for key in (0, (0, 0), slice(0, 1), (slice(None), 0)):
        np.testing.assert_array_equal(tg[key].numpy(), np.asarray(tr[key]))
    tg[0] = 7.0
    tr[0] = 7.0
    same(got, ref, "exact")


@pytest.mark.parametrize("shape,tiles_per_proc", [((16, 16), 2), ((16, 16), 1), ((13, 9), 3), ((7, 12), 2)])
def test_square_diag_tiles_match_heat_tpu(shape, tiles_per_proc):
    """TestTiling's SquareDiagTiles cases: geometry, every tile read, a
    write through, the local accessors of this rank's band, match_tiles."""
    a = values(shape, "float32")
    got, ref = ht.array(a, split=0), jht.array(a, split=0, comm=j1())
    tg, tr = ht.tiling.SquareDiagTiles(got, tiles_per_proc), jht.tiling.SquareDiagTiles(ref, tiles_per_proc)
    for attr in ("tile_rows", "tile_columns", "tile_columns_per_process", "tile_rows_per_process", "row_indices",
                 "col_indices", "last_diagonal_process"):
        assert getattr(tg, attr) == getattr(tr, attr), attr
    np.testing.assert_array_equal(tg.tile_map, tr.tile_map)
    np.testing.assert_array_equal(tg.lshape_map, tr.lshape_map)
    for i in range(tg.tile_rows):
        for j in range(tg.tile_columns):
            assert tg.get_start_stop((i, j)) == tr.get_start_stop((i, j))
            assert tg.get_tile_size((i, j)) == tr.get_tile_size((i, j))
            np.testing.assert_array_equal(tg[i, j].numpy(), np.asarray(tr[i, j]))
    np.testing.assert_array_equal(tg[0].numpy(), np.asarray(tr[0]))
    np.testing.assert_array_equal(tg[0:2, 1:].numpy(), np.asarray(tr[0:2, 1:]))
    last, col = tg.tile_rows - 1, min(1, tg.tile_columns - 1)
    assert tg.local_to_global((last, 0)) == tr.local_to_global((last, 0), rank=0)
    np.testing.assert_array_equal(tg.local_get((last, col)).numpy(), np.asarray(tr.local_get((last, col), rank=0)))
    tg[0, col] = 0.0
    tr[0, col] = 0.0
    tg.local_set((last, 0), 3.5)
    tr.local_set((last, 0), 3.5, rank=0)
    same(got, ref, "exact")
    with pytest.raises(ValueError):
        tg.local_get((0, 0), rank=1)
    other = [lib.zeros((shape[0] + 3, shape[0] + 3), split=0, **kw) for lib, kw in ((ht, {}), (jht, {"comm": j1()}))]
    mg, mr = ht.tiling.SquareDiagTiles(other[0], 1), jht.tiling.SquareDiagTiles(other[1], 1)
    mg.match_tiles(tg)
    mr.match_tiles(tr)
    for attr in ("row_indices", "col_indices", "tile_rows_per_process", "tile_rows", "tile_columns"):
        assert getattr(mg, attr) == getattr(mr, attr), attr
    for lib in (ht, jht):
        with pytest.raises(ValueError):
            lib.tiling.SquareDiagTiles(lib.zeros(4))
        with pytest.raises(TypeError):
            lib.tiling.SplitTiles(np.zeros(4))


# --------------------------------------------------------------------- #
# across ranks: the test run's 4-rank world (torch_mp_worker.py's        #
# _halo_cases) against heat_tpu on 4 devices                             #
# --------------------------------------------------------------------- #
def _neighbour_halos(a: np.ndarray, lmap, size: int, prev=True, nxt=True):
    """NumPy's halos of each rank of the map: the last ``size`` rows of the
    previous rank that holds rows, the first of the next one."""
    counts = lmap[:, 0]
    st = np.concatenate([[0], np.cumsum(counts)])
    held = [q for q in range(len(counts)) if counts[q]]
    out = []
    for r in range(len(counts)):
        p = n = None
        if r in held and len(held) > 1:
            i = held.index(r)
            if prev and i > 0:
                p = a[st[held[i - 1] + 1] - size: st[held[i - 1] + 1]]
            if nxt and i < len(held) - 1:
                n = a[st[held[i + 1]]: st[held[i + 1]] + size]
        out.append((p, n, a[st[r]: st[r + 1]]))
    return out


def _halo_names():
    import torch_mp_worker as worker

    return sorted(worker.HALO_WORLD)


@pytest.mark.parametrize("name", _halo_names())
def test_get_halo_across_four_ranks(ranks, jcomm, name):  # noqa: F811
    """Each rank's halos and ``array_with_halos`` equal NumPy's neighbours
    among the ranks that hold rows (a slice's uneven map, a rank without
    rows), and heat_tpu's halos on the 4-device mesh where every rank
    holds rows of even blocks; one permute a direction asked for."""
    import torch_mp_worker as worker
    from test_torch_distributed import _result

    rows, cut, size, prev, nxt = worker.HALO_WORLD[name]
    a = worker.halo_operand(rows)
    if cut is not None:
        a = a[slice(*cut)]
    every = _result(ranks, name)
    want = _neighbour_halos(a, every[0]["lmap"], size, prev, nxt)
    for r, (res, (p, n, mine)) in enumerate(zip(every, want)):
        for got, w in ((res["prev"], p), (res["next"], n)):
            assert (got is None) == (w is None), (r, got, w)
            if w is not None:
                np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(res["with"], np.concatenate([h for h in (p, mine, n) if h is not None]))
        assert res["counts"] == {"collective-permute": int(prev) + int(nxt)}
    if cut is None and rows % 4 == 0:
        ref = jht.array(a, split=0, comm=jcomm)
        ref.get_halo(size, prev=prev, next=nxt)
        for r, res in enumerate(every):
            for got, w in ((res["prev"], ref.halo_prev[r]), (res["next"], ref.halo_next[r])):
                assert (got is None) == (w is None)
                if w is not None:
                    np.testing.assert_array_equal(got, np.asarray(w))


def test_halo_exchange_and_errors_across_four_ranks(ranks, jcomm):  # noqa: F811
    """The raw exchange on even blocks equals heat_tpu's per-device blocks
    (zeros at the outer ends), with one all-gather of the row counts where
    they are not given; a halo larger than the fewest rows a rank holds
    raises ValueError on every rank, from ``get_halo`` and from the raw
    exchange alike."""
    import torch_mp_worker as worker
    from test_torch_distributed import _result

    a = worker.halo_operand(16)
    out = np.asarray(jparallel.halo_exchange(jcomm.shard(jax.numpy.asarray(a), 0), jcomm.mesh, jcomm.axis_name,
                                             0, 2, 1))
    for r, res in enumerate(_result(ranks, "halo_exchange_raw")):
        np.testing.assert_array_equal(res["out"], out[r * 7: (r + 1) * 7])
        np.testing.assert_array_equal(res["given"], out[r * 7: (r + 1) * 7])
        assert res["counts"] == {"all-gather": 1, "collective-permute": 2}
        assert res["given_counts"] == {"collective-permute": 2}
    for res in _result(ranks, "halo_too_large"):
        assert res["raised"] and "halo_size" in res["raised"]
    for res in _result(ranks, "halo_exchange_short"):
        assert res["raised"] and "halo size" in res["raised"]


def _conv_names():
    import torch_mp_worker as worker

    return [f"conv_{label}_{mode}" for label, _, k in worker.CONV_CASES for mode in worker.CONV_MODES
            if not (mode == "same" and k % 2 == 0)] + ["conv_int", "conv_swapped"]


@pytest.mark.parametrize("name", _conv_names())
def test_convolve_across_four_ranks(ranks, jcomm, name):  # noqa: F811
    """``convolve`` of a split signal over 4 ranks (ragged, a last rank
    without rows, k − 1 beyond the next rank's rows) against heat_tpu on 4
    devices: float32 within 1e-5 of Σ|a||v|, ints exactly; the result's
    rows where the signal's fall; one permute a hop, no all-gather of the
    signal."""
    import torch_mp_worker as worker
    from test_torch_distributed import _result

    if name == "conv_int":
        a, v = worker.conv_operands(21, 4, "int32")
        ref = jht.convolve(jht.array(a, split=0, comm=jcomm), jht.array(v, comm=jcomm))
    elif name == "conv_swapped":
        a, v = worker.conv_operands(11, 3)
        ref = jht.convolve(jht.array(v, comm=jcomm), jht.array(a, split=0, comm=jcomm), mode="same")
    else:
        _, label, mode = name.split("_")
        n, k = next((n, k) for lb, n, k in worker.CONV_CASES if lb == label)
        a, v = worker.conv_operands(n, k)
        ref = jht.convolve(jht.array(a, split=0, comm=jcomm), jht.array(v, comm=jcomm), mode=mode)
    w = numpy_of(ref)
    tol = 0 if name == "conv_int" else _conv_tol(a, v, "float32")
    for res in _result(ranks, name):
        (part,) = res["parts"]
        assert (part["dtype"], part["split"], tuple(part["gshape"])) == (ref.dtype.__name__, ref.split, w.shape)
        np.testing.assert_allclose(part["global"], w, rtol=0, atol=tol)
        if "counts" in res:
            assert set(res["counts"]) <= {"collective-permute", "all-gather"} and \
                res["counts"].get("all-gather", 0) == 0, res["counts"]
            assert res["counts"].get("collective-permute", 0) >= 1


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "euclidean_direct", "sqeuclidean_direct",
                                    "manhattan"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_ring_pairwise_across_four_ranks(ranks, jcomm, metric, symmetric):  # noqa: F811
    """Each rank's rows of the ring's matrix against heat_tpu's ring on 4
    devices (its padded columns cut away) and NumPy's distances."""
    from test_torch_distributed import _result

    rng = np.random.default_rng(71)
    xs = rng.standard_normal((14, 5)).astype(np.float32)
    ys = xs if symmetric else rng.standard_normal((10, 5)).astype(np.float32)
    from heat_tpu.core import _padding

    xp = jht.array(xs, split=0, comm=jcomm)._phys
    yp = jht.array(ys, split=0, comm=jcomm)._phys
    ref = np.asarray(jparallel.ring_pairwise(xp, yp, jcomm.mesh, jcomm.axis_name, metric=metric, symmetric=symmetric))
    bx, by = xp.shape[0] // 4, yp.shape[0] // 4
    cols = np.concatenate([np.arange(q * by, q * by + jcomm.chunk((ys.shape[0],), 0, rank=q)[1][0])
                           for q in range(4)])
    del _padding
    for r, res in enumerate(_result(ranks, f"ring_{metric}_{symmetric}")):
        start, (rows,), _ = jcomm.chunk((xs.shape[0],), 0, rank=r)
        want = ref[r * bx: r * bx + rows][:, cols]
        got = res["rows"].copy()
        if symmetric and metric == "euclidean":  # the quadratic form's diagonal is sqrt of float32 rounding
            for i in range(rows):
                got[i, start + i] = want[i, start + i] = 0.0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("layout", ["even", "uneven"])
def test_tiles_across_four_ranks(ranks, jcomm, layout):  # noqa: F811
    """SplitTiles and SquareDiagTiles over 4 ranks: on even shards the
    geometry, reads and local accessors equal heat_tpu's (its ``rank=r``
    for rank r's band); on a slice the tiles follow the port's own shards;
    the writes land on every rank alike."""
    from test_torch_distributed import _result

    a = np.arange(16 * 12, dtype=np.float32).reshape(16, 12)
    every = _result(ranks, f"tiles_{layout}")
    src = a if layout == "even" else a[1:15]
    after = src.copy()
    if layout == "even":
        ref = jht.array(a, split=0, comm=jcomm)
        st, sq = jht.tiling.SplitTiles(ref), jht.tiling.SquareDiagTiles(ref, tiles_per_proc=2)
        geo = every[0]["geometry"]
        assert geo["tile_dimensions"] == [t.tolist() for t in st.tile_dimensions]
        np.testing.assert_array_equal(geo["tile_ends_g"], st.tile_ends_g)
        np.testing.assert_array_equal(geo["tile_locations"], st.tile_locations)
        np.testing.assert_array_equal(geo["tile_map"], sq.tile_map)
        for attr, key in (("tile_rows", "tile_rows"), ("tile_columns", "tile_columns"),
                          ("tile_rows_per_process", "rows_per_process"), ("row_indices", "row_indices"),
                          ("col_indices", "col_indices"), ("last_diagonal_process", "last_diagonal_process")):
            assert geo[key] == getattr(sq, attr), attr
        assert tuple(geo["start_stop_1_2"]) == sq.get_start_stop((1, 2))
        for r, res in enumerate(every):
            np.testing.assert_array_equal(res["reads"]["split_tile_1"], np.asarray(st[1]))
            np.testing.assert_array_equal(res["reads"]["split_tiles_0_2"], np.asarray(st[0:2]))
            np.testing.assert_array_equal(res["reads"]["square_1_2"], np.asarray(sq[1, 2]))
            np.testing.assert_array_equal(res["reads"]["local_0_0"], np.asarray(sq.local_get((0, 0), rank=r)))
            assert tuple(res["reads"]["global_of_local"]) == sq.local_to_global((0, 0), rank=r)
    geo = every[0]["geometry"]
    ends = np.concatenate([[0], np.cumsum(geo["tile_dimensions"][0])])
    after[ends[2]: ends[3]] = -1.0
    rows, cols = geo["row_indices"] + [src.shape[0]], geo["col_indices"] + [src.shape[1]]
    after[rows[0]: rows[1], cols[1]: cols[2]] = -2.0
    for r, res in enumerate(every):
        for k in geo:
            np.testing.assert_array_equal(np.asarray(res["geometry"][k]), np.asarray(geo[k]))
        if layout == "uneven":
            np.testing.assert_array_equal(res["reads"]["split_tile_1"], src[ends[1]: ends[2]])
        g = sum(geo["rows_per_process"][:r])
        after[rows[g]: rows[g + 1], cols[0]: cols[1]] = 7.0
    for res in every:
        np.testing.assert_array_equal(res["after"], after)


def test_gallery_across_four_ranks(ranks, jcomm):  # noqa: F811
    """``random_known_rank(40, 20, 4)`` split 0 and 1 at P = 4 (BASELINE's
    hsvd_rank harness shape at P ranks, cut to size) against heat_tpu: the
    singular values bit for bit, the matrix's within 1e-5; ``parter``
    exactly; every rank holds the same global matrix. heat_tpu's draws do
    not depend on its mesh, and its gallery fails on a communicator other
    than the default one (the singular values land on the default mesh),
    so its reference runs on conftest.py's 8-device mesh."""
    from heat_tpu.utils.data import matrixgallery as jgal
    from test_torch_distributed import _result

    every = _result(ranks, "gallery")
    for split in (0, 1):
        jht.random.seed(13)
        jA, (_, js, _) = jgal.random_known_rank(40, 20, 4, split=split)
        for res in every:
            got = res[split]
            assert got["split"] == split
            np.testing.assert_array_equal(got["s"], js.numpy())
            np.testing.assert_allclose(np.linalg.svd(got["A"], compute_uv=False)[:4], np.sort(js.numpy())[::-1],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["A"], every[0][split]["A"], rtol=0, atol=0)
            np.testing.assert_array_equal(got["parter"], jgal.parter(9, split=split).numpy())
        np.testing.assert_allclose(np.linalg.svd(every[0][split]["A"], compute_uv=False),
                                   np.linalg.svd(jA.numpy(), compute_uv=False), atol=1e-5)
