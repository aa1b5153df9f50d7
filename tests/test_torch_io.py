"""I/O, datasets, checkpoints, vision transforms, PartialH5Dataset and the
sparse encoders of heat_tpu_torch against heat_tpu.

At world size 1, with the same numpy input made from a seed:

- ``load_csv``/``load`` at split None, 0 and 1 (a ``;`` file, one column,
  one row, header lines) equal heat_tpu's loads exactly, and the files that
  ``save_csv``/``save`` write (float32, int64, a header, ``decimals``, a
  vector, one row, one column) equal heat_tpu's byte for byte;
- HDF5 (where h5py imports): each package reads the other's file exactly,
  also with ``load_fraction``, and bfloat16 is stored as float32;
- ``datasets.path`` gives the port's own copies, byte-identical to
  heat_tpu's files;
- a checkpoint of DNDarrays (split 0, 1, None; float32, bfloat16, int64),
  a tensor, a numpy array and scalars under dicts with int keys, lists and
  tuples comes back bit for bit; both packages refuse the reserved keys;
- the vision transforms give heat_tpu's arrays exactly;
- ``PartialH5Dataset`` yields heat_tpu's batches exactly, and a shuffled
  pass pairs each data row with its label;
- ``OneHotEncoder``: categories, the DCSR components and the dense form
  equal heat_tpu's exactly; ``TfidfTransformer``: idf and values within
  1e-6 relative (float32 logs and norms in another library), patterns
  exactly.

Across ranks, the 4-rank world of test_torch_distributed.py (``_io_cases``
of torch_mp_worker.py) against heat_tpu on 4 devices: split-0 CSV loads
read each rank's byte range (two all-gathers, no other collective),
rank-ordered ``save_csv`` writes heat_tpu's bytes, HDF5 round trips, a
checkpoint saved at 4 ranks loads at 4 and here at 1 bit for bit and one
written as by one rank loads at 4, and the encoders on a split input give
heat_tpu's global values, each rank encoding its own rows with no
collective.
"""

import os

import numpy as np
import pytest
import torch

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu.datasets import path as jpath

import torch_mp_worker as worker
from test_torch_distributed import _jcomm, _result, jcomm, ranks  # noqa: F401 (the session's world)

HDF5 = pytest.mark.skipif(not ht.supports_hdf5(), reason="h5py is not installed")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _rel(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)


# --------------------------------------------------------------------- #
# CSV at world size 1                                                   #
# --------------------------------------------------------------------- #
def _csv_files(tmp_path):
    one_row = tmp_path / "one_row.csv"
    one_row.write_text("1.5,2.5,3.5\n")
    header = tmp_path / "header.csv"
    header.write_text("# a\n# b\n1,2\n3,4\n5,6\n")
    missing = tmp_path / "missing.csv"  # NumPy's C parser refuses it: genfromtxt's NaN
    missing.write_text("1.5,,3\n4,5,6.25\n")
    return {"iris": (jpath("iris.csv"), {"sep": ";"}), "labels": (jpath("iris_labels.csv"), {}),
            "one_row": (str(one_row), {}), "header": (str(header), {"header_lines": 2}),
            "missing": (str(missing), {})}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", ["iris", "labels", "one_row", "header", "missing"])
def test_load_csv_matches_heat_tpu(tmp_path, split, name):
    path, kw = _csv_files(tmp_path)[name]
    if split == 1 and name == "labels":
        split = 0  # one column
    got = ht.load_csv(path, split=split, **kw)
    want = jht.load_csv(path, split=split, **kw)
    assert (got.split, got.gshape, got.dtype.__name__) == (want.split, want.gshape, want.dtype.__name__)
    _same(got.numpy(), want.numpy())
    _same(ht.load(path, split=split, **kw).numpy(), want.numpy())
    if name != "missing":  # no integer NaN
        _same(ht.load_csv(path, dtype=ht.int64 if name == "header" else ht.float64, split=split, **kw).numpy(),
              jht.load_csv(path, dtype=jht.int64 if name == "header" else jht.float64, split=split, **kw).numpy())


SAVES = {
    "float": (lambda: worker.io_array(), {}),
    "int": (lambda: worker.io_codes(), {}),
    "header": (lambda: worker.io_array(), {"header_lines": ["x", "y,z"]}),
    "decimals": (lambda: worker.io_array(), {"decimals": 3, "sep": ";"}),
    "vector": (lambda: worker.io_array()[:, 0], {}),
    "one_row": (lambda: worker.io_array()[:1], {}),
    "one_column": (lambda: worker.io_array()[:, :1], {}),
}


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("kind", list(SAVES))
def test_save_csv_writes_heat_tpus_bytes(tmp_path, split, kind):
    make, kw = SAVES[kind]
    a = make()
    ht.save_csv(ht.array(a, split=split), str(tmp_path / "port.csv"), **kw)
    jht.save_csv(jht.array(a, split=split), str(tmp_path / "heat_tpu.csv"), **kw)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "heat_tpu.csv").read_bytes()
    ht.save(ht.array(a, split=split), str(tmp_path / "by_ext.csv"), **kw)
    assert (tmp_path / "by_ext.csv").read_bytes() == (tmp_path / "heat_tpu.csv").read_bytes()


def test_io_errors_match_heat_tpu(tmp_path):
    x = ht.array(worker.io_array())
    for lib, arr in ((ht, x), (jht, jht.array(worker.io_array()))):
        with pytest.raises(ValueError):
            lib.load(str(tmp_path / "a.txt"))
        with pytest.raises(ValueError):
            lib.save(arr, str(tmp_path / "a.txt"))
        with pytest.raises(TypeError):
            lib.load(1)
        with pytest.raises(TypeError):
            lib.save_csv(np.zeros(3), str(tmp_path / "a.csv"))
        with pytest.raises(ValueError):
            lib.load_csv(jpath("iris.csv"), sep=";", split=2)
    assert ht.supports_netcdf() == jht.supports_netcdf()


# --------------------------------------------------------------------- #
# HDF5 and the datasets                                                 #
# --------------------------------------------------------------------- #
@HDF5
@pytest.mark.parametrize("split", [None, 0, 1])
def test_hdf5_reads_and_writes_heat_tpus_files(tmp_path, split):
    import h5py

    got = ht.load_hdf5(jpath("iris.h5"), "data", split=split)
    want = jht.load_hdf5(jpath("iris.h5"), "data", split=split)
    assert got.split == want.split
    _same(got.numpy(), want.numpy())
    _same(ht.load(jpath("diabetes.h5"), "y", split=0 if split is not None else None).numpy(),
          jht.load(jpath("diabetes.h5"), "y", split=0 if split is not None else None).numpy())
    _same(ht.load_hdf5(jpath("iris.h5"), "data", split=0, load_fraction=0.5).numpy(),
          jht.load_hdf5(jpath("iris.h5"), "data", split=0, load_fraction=0.5).numpy())
    a = worker.io_array()
    ht.save(ht.array(a, split=split), str(tmp_path / "port.h5"), "data")
    jht.save(jht.array(a, split=split), str(tmp_path / "heat_tpu.h5"), "data")
    _same(jht.load(str(tmp_path / "port.h5"), "data").numpy(), a)
    _same(ht.load(str(tmp_path / "heat_tpu.h5"), "data", split=split).numpy(), a)
    ht.save_hdf5(ht.array(a, dtype=ht.bfloat16, split=split), str(tmp_path / "bf16.h5"), "data")
    with h5py.File(str(tmp_path / "bf16.h5"), "r") as f:
        assert f["data"].dtype == np.float32
        _same(f["data"][...], ht.array(a, dtype=ht.bfloat16).numpy())


@pytest.mark.parametrize("name", ["iris.csv", "iris_labels.csv", "iris.h5", "diabetes.h5"])
def test_datasets_are_the_ports_own_copies(name):
    mine = ht.datasets.path(name)
    assert os.path.dirname(mine).endswith(os.path.join("heat_tpu_torch", "datasets"))
    with open(mine, "rb") as f, open(jpath(name), "rb") as g:
        assert f.read() == g.read()
    with pytest.raises(FileNotFoundError):
        ht.datasets.path("mnist.h5")


# --------------------------------------------------------------------- #
# checkpoints and vision transforms                                     #
# --------------------------------------------------------------------- #
def _tree_equal(got, want):
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_equal(g, w)
    elif isinstance(want, ht.DNDarray):
        assert (got.split, got.gshape, got.dtype) == (want.split, want.gshape, want.dtype)
        assert torch.equal(got.larray.view(torch.uint8), want.larray.contiguous().view(torch.uint8))
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    elif isinstance(want, np.ndarray):
        _same(got, want)
    else:
        assert got == want


def test_checkpoint_round_trips_bit_for_bit(tmp_path):
    tree = worker.checkpoint_tree(ht)
    tree["nested"] = [ht.array(np.array([True, False, True]), split=0),
                      (ht.array(np.arange(6, dtype=np.complex64).reshape(2, 3), split=1), -0.0, float("inf")),
                      {"neg": ht.array(np.array([-0.0, np.nan], np.float32))}]
    tree["bf16_t"] = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    tree["scalar"] = np.float32(2.5)
    ht.utils.save_checkpoint(str(tmp_path / "c"), tree)
    back = ht.utils.load_checkpoint(str(tmp_path / "c"))
    nan = back["nested"][2]["neg"].larray
    assert torch.isnan(nan[1]) and torch.signbit(nan[0])
    back["nested"][2]["neg"] = tree["nested"][2]["neg"]  # NaN != NaN; its bits are checked above
    _tree_equal(back, tree)
    with pytest.raises(FileExistsError):
        ht.utils.save_checkpoint(str(tmp_path / "c"), tree, overwrite=False)


@pytest.mark.parametrize("key", ["__heat_dndarray__", "__tuple__"])
def test_checkpoint_refuses_heat_tpus_reserved_keys(tmp_path, key):
    from heat_tpu.utils import checkpoint as jck

    with pytest.raises(ValueError):
        jck._encode({"a": {key: 1}})
    with pytest.raises(ValueError):
        ht.utils.save_checkpoint(str(tmp_path / "c"), {"a": {key: 1}})


def test_vision_transforms_match_heat_tpu():
    img = np.random.default_rng(3).integers(0, 256, (4, 28, 28)).astype(np.uint8)
    for lib in (ht, jht):
        assert set(lib.utils.vision_transforms.__all__) == {"Compose", "Normalize", "ToTensor"}
    pipe = [lib.utils.vision_transforms.Compose([lib.utils.vision_transforms.ToTensor(),
                                                 lib.utils.vision_transforms.Normalize((0.1307,), (0.3081,))])
            for lib in (ht, jht)]
    _same(pipe[0](img), pipe[1](img))
    _same(ht.utils.vision_transforms.ToTensor()(img.astype(np.float64)),
          jht.utils.vision_transforms.ToTensor()(img.astype(np.float64)))
    with pytest.raises(AttributeError):
        ht.utils.vision_transforms.RandomCrop


# --------------------------------------------------------------------- #
# PartialH5Dataset                                                      #
# --------------------------------------------------------------------- #
BATCH_STARTS = (0, 8, 20, 28, 40)  # 50 rows, chunks of 20, batches of 8


@HDF5
def test_partial_h5_dataset_yields_heat_tpus_batches(tmp_path):
    import h5py

    file = str(tmp_path / "p.h5")
    with h5py.File(file, "w") as f:
        f["data"] = worker.io_array((50, 4), seed=63)
        f["labels"] = np.arange(50, dtype=np.int64)
    kw = {"batch_size": 8, "initial_load": 20}
    mine = ht.utils.data.PartialH5Dataset(file, ["data", "labels"], **kw)
    theirs = jht.utils.data.PartialH5Dataset(file, ["data", "labels"], **kw)
    assert len(mine) == len(theirs) == 6
    got, want = list(mine), list(theirs)
    assert len(got) == len(want) == len(BATCH_STARTS)  # two batches a chunk of 20, then one; the tails dropped
    for (d, l), (jd, jl) in zip(got, want):
        assert d.split == 0 and l.split == 0
        _same(d.numpy(), jd.numpy())
        _same(l.numpy(), jl.numpy())
    mine.Shuffle()
    data = worker.io_array((50, 4), seed=63)
    labels = []
    for d, l in mine:
        _same(d.numpy(), data[l.numpy().astype(np.int64)])  # the labels come as the dataset's float32
        labels.append(l.numpy())
    with pytest.raises(NotImplementedError):
        mine.Ishuffle()
    it = iter(ht.utils.data.PartialH5Dataset(file, "data", **kw))
    _same(next(it).numpy(), data[:8])
    it.close()


# --------------------------------------------------------------------- #
# the sparse encoders                                                   #
# --------------------------------------------------------------------- #
def _same_dcsr(got, want):
    assert got.shape == want.shape and got.split == want.split and got.gnnz == want.gnnz
    for a, b in ((got.indptr, want.indptr), (got.indices, want.indices), (got.data, want.data)):
        _same(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("split", [None, 0])
def test_onehot_matches_heat_tpu(split):
    codes = worker.io_codes()
    unknown = codes.copy()
    unknown[::5, 1] = 999
    mine = ht.preprocessing.OneHotEncoder().fit(ht.array(codes, split=split))
    theirs = jht.preprocessing.OneHotEncoder().fit(jht.array(codes, split=split))
    assert mine.n_features_out_ == theirs.n_features_out_
    for a, b in zip(mine.categories_, theirs.categories_):
        _same(a, b)
    for x in (codes, unknown):
        _same_dcsr(mine.transform(ht.array(x, split=split)), theirs.transform(jht.array(x, split=split)))
        _same_dcsr(mine.transform(x), theirs.transform(x))
    dense = ht.preprocessing.OneHotEncoder(sparse_output=False).fit_transform(ht.array(codes, split=split))
    jdense = jht.preprocessing.OneHotEncoder(sparse_output=False).fit_transform(jht.array(codes, split=split))
    assert dense.split == jdense.split
    _same(dense.numpy(), jdense.numpy())
    with pytest.raises(TypeError):
        ht.preprocessing.OneHotEncoder().fit(codes.astype(np.float32))
    with pytest.raises(ValueError):
        mine.transform(codes[:, :2])
    with pytest.raises(NotImplementedError, match="item 13"):
        mine.serving_program()
    np.testing.assert_array_equal(mine.stream_transform(unknown), theirs.stream_transform(unknown))


@pytest.mark.parametrize("form, norm", [("dense", "l2"), ("dcsr", "l2"), ("dense", None), ("dcsr_split", "l2")])
def test_tfidf_matches_heat_tpu(form, norm):
    c = worker.io_counts()
    if form == "dense":
        x, jx = ht.array(c), jht.array(c)
    else:
        split = 0 if form == "dcsr_split" else None
        x, jx = ht.sparse.sparse_csr_matrix(c, split=split), jht.sparse.sparse_csr_matrix(c, split=split)
    mine = ht.preprocessing.TfidfTransformer(norm=norm).fit(x)
    theirs = jht.preprocessing.TfidfTransformer(norm=norm).fit(jx)
    _rel(mine.idf_, theirs.idf_)
    got, want = mine.transform(x), theirs.transform(jx)
    assert got.shape == want.shape and got.split == want.split and got.gnnz == want.gnnz
    _same(got.indptr.numpy(), np.asarray(want.indptr))
    _same(got.indices.numpy(), np.asarray(want.indices))
    _rel(got.data.numpy(), np.asarray(want.data))
    dense = ht.preprocessing.TfidfTransformer(sparse_output=False, norm=norm).fit_transform(x)
    _rel(dense.numpy(), jht.preprocessing.TfidfTransformer(sparse_output=False, norm=norm).fit_transform(jx).numpy())
    with pytest.raises(NotImplementedError, match="item 13"):
        mine.serving_program()
    with pytest.raises(ValueError):
        ht.preprocessing.TfidfTransformer(norm="l1")


# --------------------------------------------------------------------- #
# across ranks                                                          #
# --------------------------------------------------------------------- #
def _world_dir(ranks):
    return _result(ranks, "io_dir", 0)["dir"]


def _chunk(shape, split, r):
    return _jcomm().chunk(shape, split, rank=r)[2]


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("header", [0, 2])
def test_world_csv_load_reads_each_ranks_rows(ranks, jcomm, split, header):
    path = os.path.join(_world_dir(ranks), f"io_in_{header}.csv")
    want = jht.load_csv(path, header_lines=header, split=split, comm=jcomm)
    for r, res in enumerate(_result(ranks, f"io_csv_load_{split}_{header}")):
        assert (res["split"], res["gshape"]) == (want.split, want.gshape)
        _same(res["global"], want.numpy())
        _same(res["local"], want.numpy()[_chunk(want.gshape, split, r)] if split is not None else want.numpy())
        if split == 0:  # each rank's byte range: the counts, then the anchors
            assert res["counts"] == {"all-gather": 2}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("kind", ["float", "int", "header", "decimals", "vector"])
def test_world_save_csv_writes_heat_tpus_bytes(ranks, tmp_path, split, kind):
    a = worker.io_array() if kind != "int" else worker.io_codes()
    kw = {"header_lines": ["a", "b"]} if kind == "header" else {"decimals": 3} if kind == "decimals" else {}
    jht.save_csv(jht.array(a if kind != "vector" else a[:, 0]), str(tmp_path / "want.csv"), **kw)
    res = _result(ranks, f"io_csv_save_{split}_{kind}")
    if split == 0 or kind == "vector":
        assert all(r["counts"] == {} for r in res)  # rank-ordered appends, nothing gathered
    with open(os.path.join(_world_dir(ranks), f"io_out_{split}_{kind}.csv"), "rb") as f:
        assert f.read() == (tmp_path / "want.csv").read_bytes()


@HDF5
@pytest.mark.parametrize("split", [None, 0, 1])
def test_world_hdf5_round_trip(ranks, jcomm, split):
    a = worker.io_array()
    _same(jht.load(os.path.join(_world_dir(ranks), f"io_{split}.h5"), "data").numpy(), a)
    half = jht.load_hdf5(os.path.join(_world_dir(ranks), f"io_{split}.h5"), "data", split=0, load_fraction=0.5,
                         comm=jcomm).numpy()
    for r, res in enumerate(_result(ranks, f"io_hdf5_{split}")):
        assert res["split"] == split and res["counts"] == {}
        _same(res["global"], a)
        _same(res["local"], a[_chunk(a.shape, split, r)] if split is not None else a)
        _same(res["half"], half)
        _same(res["half_local"], half[_chunk(half.shape, 0, r)])


def _check_leaves(got, tree, r, whole=False):
    for key in worker.IO_CHECKPOINT_TREE:
        want = tree[key]
        if isinstance(want, dict) and "global" in want:
            assert (got[key]["split"], got[key]["dtype"]) == (want["split"], want["dtype"])
            _same(got[key]["global"], want["global"])
            if not whole:
                split = want["split"]
                _same(got[key]["local"], want["global"][_chunk(want["global"].shape, split, r)]
                      if split is not None else want["global"])
        elif key == "t":
            _same(got[key]["tensor"], want["tensor"])
        else:
            _same(got[key], want) if key == "np" else None
            assert key == "np" or got[key] == want


def test_world_checkpoint_across_world_sizes(ranks):
    every = _result(ranks, "io_checkpoint_4_to_4")
    saved = every[0]["saved"]
    for r, res in enumerate(every):
        assert res["counts"] == {}  # each rank reads its rows of the shards
        _check_leaves(res["loaded"], saved, r)
        for key in ("x0", "x1", "bf16", "counts"):
            _same(res["loaded"][key]["local"], res["saved"][key]["local"])  # the same shard, bit for bit
    back = ht.utils.load_checkpoint(os.path.join(_world_dir(ranks), "ckpt4"))  # 4 -> 1, here
    _check_leaves(worker._leaves(back), saved, 0, whole=True)
    for r, res in enumerate(_result(ranks, "io_checkpoint_1_to_4")):  # written as by one rank, read at 4
        _check_leaves(res["loaded"], saved, r)


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("sparse_output", [True, False])
def test_world_onehot_encodes_each_ranks_rows(ranks, jcomm, split, sparse_output):
    codes = worker.io_codes()
    enc = jht.preprocessing.OneHotEncoder(sparse_output=sparse_output).fit(jht.array(codes, split=split, comm=jcomm))
    want = enc.transform(jht.array(codes, split=split, comm=jcomm))
    dense = (want.todense() if sparse_output else want).numpy()
    for r, res in enumerate(_result(ranks, f"io_onehot_{split}_{sparse_output}")):
        for a, b in zip(res["categories"], enc.categories_):
            _same(a, b)
        if split == 0:
            assert res["fit_counts"] == {"all-gather": 2} and res["counts"] == {"all-reduce": 1}  # gnnz
        if sparse_output:
            assert res["gnnz"] == want.gnnz and res["split"] == want.split == 0
            _same(res["indptr"], np.asarray(want.indptr))
            _same(res["indices"], np.asarray(want.indices))
            _same(res["data"], np.asarray(want.data))
            _same(res["dense"], dense)
        else:
            assert res["split"] == 0
            _same(res["global"], dense)
            _same(res["local"], dense[_chunk(dense.shape, 0, r)])


@pytest.mark.parametrize("form", ["dense", "dcsr"])
def test_world_tfidf_scales_each_ranks_rows(ranks, jcomm, form):
    c = worker.io_counts()
    x = jht.array(c, split=0, comm=jcomm) if form == "dense" else jht.sparse.sparse_csr_matrix(c, split=0, comm=jcomm)
    t = jht.preprocessing.TfidfTransformer().fit(x)
    want = t.transform(x)
    for r, res in enumerate(_result(ranks, f"io_tfidf_{form}")):
        assert res["fit_counts"] == {"all-reduce": 1} and res["counts"] == {"all-reduce": 1}  # gnnz
        _rel(res["idf"], t.idf_)
        assert res["gnnz"] == want.gnnz and res["split"] == 0
        _same(res["indptr"], np.asarray(want.indptr))
        _same(res["indices"], np.asarray(want.indices))
        _rel(res["data"], np.asarray(want.data))


@HDF5
def test_world_partial_h5_dataset_splits_each_batch(ranks, jcomm):
    data = worker.io_array((50, 4), seed=63)
    every = _result(ranks, "io_partial_h5")
    for r, res in enumerate(every):
        assert res["len"] == 6 and len(res["batches"]) == len(BATCH_STARTS)
        for start, (local, glob, labels_local, split) in zip(BATCH_STARTS, res["batches"]):
            _same(glob, data[start : start + 8])
            _same(local, data[start : start + 8][_chunk((8, 4), 0, r)])
            _same(labels_local, np.arange(start, start + 8, dtype=np.float32)[_chunk((8,), 0, r)])
            assert split == 0
        for (d, l, local), (d0, l0, _) in zip(res["shuffled"], every[0]["shuffled"]):
            _same(d, data[l.astype(np.int64)])  # each row with its label
            _same(l, l0)  # one permutation on every rank
            _same(local, d[_chunk(d.shape, 0, r)])
