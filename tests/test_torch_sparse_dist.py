"""The sparse engine of heat_tpu_torch across ranks against heat_tpu on a
4-device mesh.

The 4-rank gloo world of test_torch_distributed.py runs the cases of
``_sparse_cases`` in torch_mp_worker.py once per pytest run; each test
holds every rank's result against heat_tpu on ``MeshCommunication(devices=
jax.devices()[:4])`` with the same scipy operands, on row maps that are
uneven (37 rows: 10, 10, 10, 7), leave a rank empty (9 rows: 3, 3, 3, 0)
and straddle brick rows (45 rows: blocks of 12, so ranks 1-3 start inside
a brick row):

- the DCSR factories: each rank's ``lindptr``/``lindices``/``ldata`` equal
  the scipy CSR of its chunk of the rows, and the gathered global
  ``indptr``/``indices``/``data``, ``gnnz`` and the dense form equal
  heat_tpu's exactly; ``is_split=0`` stacks the ranks' own blocks (another
  row map, one rank stitching two blocks) to heat_tpu's matrix of the
  blocks, and ``to_dense`` moves it to the chunk map (one all-to-all);
- the DBCSR factory: each rank's slab equals heat_tpu's slab r bit for bit
  (without heat_tpu's pad bricks), ``slab_meta``, ``gnnz``, ``nbricks`` and
  ``occupancy`` equal heat_tpu's, and ``todense``/``to_dcsr`` its global
  values;
- ``A @ x`` for both formats with x whole, split 0, split 1 and a vector,
  and a replicated DBCSR: each rank's rows equal heat_tpu's shard within
  1e-5 of the product's scale |A|·|x| (the sums run in another order); a
  split x costs one all-gather and a whole x no collective;
- ``sddmm`` with u and v whole or split: within 1e-5 of |s|·(|u|·|v|ᵀ),
  one all-gather a split operand;
- ``add``/``mul`` on one row map, with a whole operand (no collective but
  the all-reduce of the result's gnnz), with another row map (three
  all-to-alls more) and with a scalar (none): patterns and values equal
  heat_tpu's exactly; ``to_sparse`` of a split-0 array (the all-reduce of
  gnnz) and of a split-1 one;
- sizes read with no collective; a global property read before the
  collective ``global_components()`` raises;
- ``pagerank`` split 0 and None: the same iteration count as heat_tpu and
  as world size 1, ranks within 1e-6 of heat_tpu's and equal to world size
  1's bit for bit, one all-gather to build the slabs (each rank blocking
  only its rows), one a step, and no other collective;
- ``spectral_embedding`` of a DBCSR split 0: Ritz values within 1e-5 and
  embedding columns within 1e-4 (up to sign) of heat_tpu's, one all-gather
  a Lanczos step, the embedding split 0.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp

import heat_tpu as jht
import heat_tpu_torch as ht

import torch_mp_worker as worker
from test_torch_distributed import WORLD, _jcomm, _result, jcomm, ranks  # noqa: F401 (the session world)

TOL = 1e-5


def _jnp(a):
    a = np.asarray(jax.device_get(a))
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _chunk(n, r):
    return _jcomm().chunk((n,), 0, rank=r)[2][0]


def _scale_close(got, want, scale):
    got, want, scale = (np.asarray(a, dtype=np.float64) for a in (got, want, scale))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.abs(got - want) <= TOL * np.maximum(scale, 1e-30)), float(np.max(np.abs(got - want)))


def _check_dcsr(res, ref, r):
    """A DCSR state of rank r against heat_tpu's matrix ``ref`` (and its
    scipy form)."""
    csr = sp.csr_matrix((_jnp(ref.data), _jnp(ref.indices), _jnp(ref.indptr)), shape=ref.shape)
    assert (res["shape"], res["gnnz"], res["split"]) == (ref.shape, ref.gnnz, ref.split)
    np.testing.assert_array_equal(res["indptr"], _jnp(ref.indptr))
    np.testing.assert_array_equal(res["indices"], _jnp(ref.indices))
    np.testing.assert_array_equal(res["data"], _jnp(ref.data))
    np.testing.assert_array_equal(res["dense"], ref.todense().numpy())
    rows = np.cumsum((0,) + tuple(res["row_counts"]))
    mine = csr[rows[r] : rows[r + 1]]
    np.testing.assert_array_equal(res["lindptr"], mine.indptr)
    np.testing.assert_array_equal(res["lindices"], mine.indices)
    np.testing.assert_array_equal(res["ldata"], mine.data)
    assert res["lnnz"] == mine.nnz
    np.testing.assert_array_equal(res["dense_local"], ref.todense().numpy()[_chunk(ref.shape[0], r)])


@pytest.mark.parametrize("label", list(worker.SPARSE_ROWS))
def test_dcsr_split0_keeps_each_ranks_rows(ranks, jcomm, label):
    m = worker.SPARSE_ROWS[label]
    ref = jht.sparse.sparse_csr_matrix(worker.sparse_operand(m, seed=m), split=0, comm=jcomm)
    for r, res in enumerate(_result(ranks, f"sp_csr_{label}")):
        assert res["balanced"] and res["row_counts"] == tuple(jcomm.counts_displs_shape((m, 1), 0)[0])
        _check_dcsr(res, ref, r)


def test_dcsr_is_split_stacks_each_ranks_block(ranks, jcomm):
    big = worker.sparse_operand(sum(worker.SPARSE_IS_SPLIT_ROWS), seed=40)
    starts = np.cumsum((0,) + worker.SPARSE_IS_SPLIT_ROWS)
    ref = jht.sparse.sparse_csr_matrix([big[starts[r] : starts[r + 1]] for r in range(WORLD)], is_split=0, comm=jcomm)
    for r, res in enumerate(_result(ranks, "sp_csr_is_split")):
        assert res["row_counts"] == worker.SPARSE_IS_SPLIT_ROWS and not res["balanced"]
        assert res["counts"] == {"all-gather": 1}  # the blocks' shapes and nonzeros
        _check_dcsr(res, ref, r)
    dense = big.toarray()
    for r, res in enumerate(_result(ranks, "sp_to_dense_is_split")):
        assert res["split"] == 0 and res["counts"] == {"all-to-all": 1}
        np.testing.assert_array_equal(res["global"], dense)
        np.testing.assert_array_equal(res["local"], dense[_chunk(dense.shape[0], r)])


@pytest.mark.parametrize("label", list(worker.SPARSE_ROWS))
def test_dbcsr_split0_slab_per_rank_matches_heat_tpu(ranks, jcomm, label):
    m = worker.SPARSE_ROWS[label]
    ref = jht.sparse.sparse_dbcsr_matrix(worker.sparse_operand(m, seed=m), split=0, comm=jcomm)
    bdata, bcol, brow, bmask = (_jnp(a) for a in ref._phys_components)
    B = ref.slab_bricks
    dcsr = ref.to_dcsr()
    for r, res in enumerate(_result(ranks, f"sp_dbcsr_{label}")):
        assert res["slab_meta"] == ref._slab_meta
        assert (res["gnnz"], res["nbricks"], res["occupancy"]) == (ref.gnnz, ref.nbricks, ref.occupancy)
        nreal = ref._slab_meta[r][2]
        for key, want in (("bdata", bdata), ("bcol", bcol), ("brow", brow), ("bmask", bmask)):
            np.testing.assert_array_equal(res[key][:nreal], want[r * B : r * B + nreal], err_msg=key)
        assert res["bdata"].shape[0] == max(1, nreal) and not res["bmask"][nreal:].any()
        np.testing.assert_array_equal(res["dense"], ref.todense().numpy())
        np.testing.assert_array_equal(res["dense_local"], ref.todense().numpy()[_chunk(m, r)])
        _check_dcsr(res["dcsr"], dcsr, r)


MATMULS = [(fmt, x, label) for fmt in ("dcsr", "dbcsr") for x in ("whole", "split0", "split1", "vector")
           for label in worker.SPARSE_ROWS] + [("dbcsr", "replicated", label) for label in worker.SPARSE_ROWS]


@pytest.mark.parametrize("fmt, x_kind, label", MATMULS)
def test_matmul_across_ranks_matches_heat_tpu(ranks, jcomm, fmt, x_kind, label):
    m = worker.SPARSE_ROWS[label]
    csr = worker.sparse_operand(m, seed=m)
    x = worker.sparse_dense_x(worker.SPARSE_COLS, 0 if x_kind == "vector" else worker.SPARSE_K, seed=m + 1)
    make = jht.sparse.sparse_csr_matrix if fmt == "dcsr" else jht.sparse.sparse_dbcsr_matrix
    A = make(csr, split=None if x_kind == "replicated" else 0, comm=jcomm)
    jx = jht.array(x, split=int(x_kind[-1]), comm=jcomm) if x_kind.startswith("split") else x
    ref = (A @ jx).numpy()
    scale = abs(csr).astype(np.float64) @ np.abs(x).astype(np.float64)
    _scale_close(ref, csr.astype(np.float64) @ x.astype(np.float64), scale)
    name = f"sp_matmul_dbcsr_replicated_{label}" if x_kind == "replicated" else f"sp_matmul_{fmt}_{x_kind}_{label}"
    for r, res in enumerate(_result(ranks, name)):
        split = None if x_kind == "replicated" else 0
        assert (res["split"], res["gshape"]) == (split, ref.shape)
        assert res["counts"] == ({"all-gather": 1} if x_kind.startswith("split") else {})
        _scale_close(res["global"], ref, scale)
        rows = slice(None) if split is None else _chunk(m, r)
        _scale_close(res["local"], ref[rows], scale[rows])


SDDMMS = [(u, v, label) for u, v in ((None, None), (0, None), (0, 0), (1, 1)) for label in worker.SPARSE_ROWS]


@pytest.mark.parametrize("u_split, v_split, label", SDDMMS)
def test_sddmm_across_ranks_matches_heat_tpu(ranks, jcomm, u_split, v_split, label):
    m = worker.SPARSE_ROWS[label]
    csr = worker.sparse_operand(m, seed=m)
    u = worker.sparse_dense_x(m, worker.SPARSE_D, seed=m + 2)
    v = worker.sparse_dense_x(worker.SPARSE_COLS, worker.SPARSE_D, seed=m + 3)
    S = jht.sparse.sparse_dbcsr_matrix(csr, split=0, comm=jcomm)
    ref = jht.sparse.sddmm(S, jht.array(u, split=u_split, comm=jcomm), jht.array(v, split=v_split, comm=jcomm))
    want = ref.todense().numpy()
    scale = abs(csr).toarray().astype(np.float64) * (np.abs(u).astype(np.float64) @ np.abs(v).T)
    _scale_close(want, csr.toarray() * (u.astype(np.float64) @ v.T.astype(np.float64)), scale)
    gathers = int(u_split is not None) + int(v_split is not None)
    for r, res in enumerate(_result(ranks, f"sp_sddmm_{u_split}_{v_split}_{label}")):
        assert res["counts"] == ({"all-gather": gathers} if gathers else {})
        assert res["slab_meta"] == ref._slab_meta and (res["gnnz"], res["nbricks"]) == (ref.gnnz, ref.nbricks)
        _scale_close(res["dense"], want, scale)
        _scale_close(res["dense_local"], want[_chunk(m, r)], scale[_chunk(m, r)])


ARITHMETIC = {"same_map": {"all-reduce": 1}, "whole": {"all-reduce": 1},
              "other_map": {"all-to-all": 3, "all-reduce": 1}}  # the result's gnnz, counted at construction


@pytest.mark.parametrize("op", ["add", "mul"])
@pytest.mark.parametrize("kind", list(ARITHMETIC))
def test_add_and_mul_across_ranks_match_heat_tpu(ranks, jcomm, op, kind):
    a, b = worker.sparse_operand(37, seed=50), worker.sparse_operand(37, seed=51)
    f = jht.sparse.sparse_add if op == "add" else jht.sparse.sparse_mul
    ref = f(jht.sparse.sparse_csr_matrix(a, split=0, comm=jcomm), jht.sparse.sparse_csr_matrix(b, split=0, comm=jcomm))
    for r, res in enumerate(_result(ranks, f"sp_{op}_{kind}")):
        assert res["counts"] == ARITHMETIC[kind] and res["balanced"]
        _check_dcsr(res, ref, r)


def test_dcsr_sizes_are_local_and_the_global_components_a_collective(ranks, jcomm):
    """gnnz is counted at construction, so reading it (or any size) starts
    no collective; a global property read before ``global_components()``
    raises on the rank that reads it instead of waiting for the others;
    ``global_components()`` gathers once, and the properties then return
    what it gathered."""
    ref = jht.sparse.sparse_csr_matrix(worker.sparse_operand(37, seed=50), split=0, comm=jcomm)
    for r, res in enumerate(_result(ranks, "sp_csr_property_reads")):
        assert res["sizes"][:2] == (ref.gnnz, ref.gnnz) and res["sizes"][3] == ref.shape
        assert res["size_counts"] == {}
        assert res["early"] is not None and "global_components()" in res["early"]
        assert res["gather_counts"] == {"all-gather": 3} and res["after_counts"] == {} and res["same"]
        np.testing.assert_array_equal(res["indptr"], _jnp(ref.indptr))
        np.testing.assert_array_equal(res["indices"], _jnp(ref.indices))
        np.testing.assert_array_equal(res["data"], _jnp(ref.data))


def test_scalar_mul_and_to_sparse_across_ranks_match_heat_tpu(ranks, jcomm):
    a = worker.sparse_operand(37, seed=50)
    ref = jht.sparse.sparse_csr_matrix(a, split=0, comm=jcomm) * 2.5
    for r, res in enumerate(_result(ranks, "sp_mul_scalar")):
        assert res["counts"] == {}
        _check_dcsr(res, ref, r)
    dense = worker.sparse_operand(37, seed=52).toarray()
    for split in (0, 1):
        ref = jht.sparse.to_sparse(jht.array(dense, split=split, comm=jcomm))
        for r, res in enumerate(_result(ranks, f"sp_to_sparse_{split}")):
            if split == 0:
                assert res["counts"] == {"all-reduce": 1}  # gnnz
            _check_dcsr(res, ref, r)


@pytest.mark.parametrize("split", [0, None])
def test_pagerank_across_ranks_matches_heat_tpu_and_world_size_1(ranks, jcomm, split):
    a = worker.pagerank_graph()
    ref = jht.graph.pagerank(a, split=split, comm=jcomm)
    ht.use_device("cpu")
    one = ht.graph.pagerank(a, split=split, comm=ht.MPI_SELF)
    want = ref.ranks.numpy()
    for r, res in enumerate(_result(ranks, f"sp_pagerank_{split}")):
        assert res["iterations"] == ref.iterations == one.iterations and res["converged"]
        assert res["split"] == ref.ranks.split
        np.testing.assert_allclose(res["global"], want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(res["global"], one.ranks.numpy())  # world size 1's bits
        rows = _chunk(a.shape[0], r) if split == 0 else slice(None)
        np.testing.assert_allclose(res["local"], want[rows], rtol=0, atol=1e-6)
        if split == 0:
            steps = res["iterations"]
            assert res["counts"] == {"all-gather": 1 + steps}  # the slabs' brick counts, then one a step
        else:
            assert res["counts"] == {}


def test_spectral_embedding_of_a_split_dbcsr_matches_heat_tpu(ranks, jcomm):
    a = worker.graph_adjacency()
    ev_ref, emb_ref = jht.graph.spectral_embedding(jht.sparse.sparse_dbcsr_matrix(a, split=0, comm=jcomm),
                                                   worker.EMBED_K, m=worker.EMBED_M)
    want = emb_ref.numpy()
    for r, res in enumerate(_result(ranks, "sp_embedding_dbcsr")):
        assert res["split"] == emb_ref.split == 0
        assert res["counts"]["all-gather"] == worker.EMBED_M  # one a Lanczos step's product
        np.testing.assert_allclose(res["evals"], ev_ref, rtol=0, atol=1e-5)
        sign = np.sign((res["embedding"] * want).sum(0))
        np.testing.assert_allclose(res["embedding"] * sign, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(res["local"] * sign, want[_chunk(a.shape[0], r)], rtol=0, atol=1e-4)
