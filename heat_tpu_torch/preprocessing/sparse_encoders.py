"""Transforms whose output is sparse: one-hot encoding and TF-IDF (port of
``heat_tpu.preprocessing.sparse_encoders``).

Both return a ``DCSR_matrix`` (``sparse_output=True``, the default)
instead of densifying N x C: a one-hot row holds one stored value a
feature, a TF-IDF row keeps the document's term pattern. The category
tables and the idf weights are found on the host, as ``heat_tpu`` finds
them. Across ranks a split input stays where it is: ``fit`` reduces what
each rank saw of its own rows (the categories by two all-gathers, the
document frequencies by one all-reduce), and ``transform`` gives a
split-0 ``DCSR_matrix`` with the input's row map, each rank encoding its
own rows with no gather (the matrix's gnnz costs one scalar all-reduce).
``stream_transform`` takes a host-resident ``HostArray`` through the card
in row windows, each encoded on the card and written back to a dense host
array. ``heat_tpu``'s serving endpoints (``serving_program``) wait for the
service layers (ROADMAP.md Queue 1, item 13).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..core import types
from ..core.base import BaseEstimator, TransformMixin
from ..core.communication import sanitize_comm
from ..core.dndarray import DNDarray
from ..sparse.dcsr_matrix import DCSR_matrix
from ..sparse import factories as _sfactories

__all__ = ["OneHotEncoder", "TfidfTransformer"]


def _rows(x):
    """(this rank's rows as a host 2-D ndarray, the row map or None): a
    DNDarray split across ranks gives its own rows (split 1 is resplit to
    0), anything else the whole array and None."""
    if isinstance(x, DCSR_matrix):
        raise TypeError("expected a dense operand, got a sparse matrix")
    if isinstance(x, DNDarray) and x.is_distributed() and x.ndim == 2:
        if x.split != 0:
            x = x.resplit(0)
        return _sfactories._host_numpy(x.larray), x.lshape_map[:, 0]
    if isinstance(x, DNDarray) and x.is_distributed():  # a split vector: one feature a sample
        return _sfactories._host_numpy(x.larray)[:, None], x.lshape_map[:, 0]
    arr = x.numpy() if isinstance(x, DNDarray) else np.asarray(x)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2:
        raise ValueError(f"expected 1-D or 2-D input, got {arr.ndim}-D")
    return arr, None


def _output(csr, x, counts, split, sparse_output: bool):
    """The encoded rows as a DCSR_matrix: split 0 with the row map
    ``counts`` where the input was split across ranks, else whole with
    ``split``; ``to_dense`` of it where ``sparse_output`` is False."""
    device = _device_of(x)
    comm = x.comm if isinstance(x, (DNDarray, DCSR_matrix)) else sanitize_comm(None)
    if counts is not None:
        values = _sfactories._values(csr.data, types.float32, device)
        out = _sfactories._from_local(csr.indptr.astype(np.int32), csr.indices.astype(np.int32), values,
                                      (int(np.sum(counts)), csr.shape[1]), 0, device, comm, None, counts)
    else:
        out = _sfactories.sparse_csr_matrix(csr, dtype=types.float32, split=split, device=device, comm=comm)
    if sparse_output:
        return out
    from ..sparse.manipulations import to_dense

    return to_dense(out)


def _device_of(x):
    return x.device if isinstance(x, (DNDarray, DCSR_matrix)) else None


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what}: see ROADMAP.md Queue 1, {item}")


def _stream(host, tag: str, width: int, out_bytes: int, slab: Optional[int], encode) -> np.ndarray:
    """The dense (N, ``width``) float32 host array of ``encode(window)``
    over the row windows of ``host``: a ``host-staging`` plan with
    write-back, proven to fit the card, each window encoded on the card and
    copied back to its rows (the ``stage_out`` steps)."""
    from ..core.devices import get_device
    from ..redistribution import staging

    sched = staging.prove_fits(staging.plan_staged_passes(
        host.shape, host.dtype, [{"tag": tag, "axis": 0, "writeback": True}], out_bytes=out_bytes, slab=slab))
    wins = staging.window_extents(host.shape, host.dtype.itemsize, 0, int(sched.staging["slab_bytes"]))
    out = np.zeros((host.shape[0], width), np.float32)

    def consume(k, win, ext):
        out[ext[0] : ext[1]] = encode(win).cpu().numpy()

    staging.stream_windows(host, 0, wins, consume, get_device().torch_device)
    return out


class OneHotEncoder(BaseEstimator, TransformMixin):
    """Encode integer categorical features as one-hot rows, emitted sparse
    (``heat_tpu`` sparse_encoders.py:53).

    ``fit`` learns the per-column category tables (sorted, as
    ``np.unique`` gives them); ``transform`` emits an (N, sum of the
    categories) ``DCSR_matrix`` with one stored 1.0 per (sample, feature):
    nnz = N * F whatever the encoded width. Unknown categories at transform
    time encode as all-zero for that feature's block (sklearn's
    ``handle_unknown='ignore'``).
    """

    def __init__(self, sparse_output: bool = True):
        self.sparse_output = bool(sparse_output)
        self.categories_ = None  # list of sorted 1-D int arrays, per column
        self._offsets = None  # starting column of each feature block

    @property
    def n_features_out_(self) -> int:
        if self.categories_ is None:
            raise RuntimeError("fit needs to be called first")
        return int(sum(len(c) for c in self.categories_))

    def fit(self, x, y=None) -> "OneHotEncoder":
        arr, counts = _rows(x)
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(f"OneHotEncoder encodes integer codes, got {arr.dtype}")
        cats = [np.unique(arr[:, f]) for f in range(arr.shape[1])]
        if counts is not None:  # the union of every rank's categories
            comm, dev = x.comm, x.device.torch_device
            sizes = comm.allgather(torch.tensor([[len(c) for c in cats]], dtype=torch.int64, device=dev)).cpu().numpy()
            mine = torch.from_numpy(np.concatenate(cats).astype(np.int64)).to(dev)
            every = comm.allgather(mine, 0, sizes.sum(axis=1)).cpu().numpy()
            ends = np.cumsum(sizes.reshape(-1))
            parts = np.split(every, ends[:-1])
            F = arr.shape[1]
            cats = [np.unique(np.concatenate(parts[f::F])).astype(arr.dtype) for f in range(F)]
        self.categories_ = cats
        sizes = np.array([len(c) for c in self.categories_], np.int64)
        self._offsets = np.concatenate([[0], np.cumsum(sizes)])
        return self

    def _encode_columns(self, arr: np.ndarray) -> np.ndarray:
        """Global output column per (sample, feature); -1 for unknown."""
        cols = np.empty(arr.shape, np.int64)
        for f, cats in enumerate(self.categories_):
            idx = np.searchsorted(cats, arr[:, f])
            idx_c = np.clip(idx, 0, len(cats) - 1)
            known = cats[idx_c] == arr[:, f]
            cols[:, f] = np.where(known, self._offsets[f] + idx_c, -1)
        return cols

    def transform(self, x) -> Union[DCSR_matrix, DNDarray]:
        """The one-hot rows of ``x``; across ranks each rank encodes its
        own rows into its row slab of a split-0 matrix."""
        if self.categories_ is None:
            raise RuntimeError("fit needs to be called before transform")
        arr, counts = _rows(x)
        if arr.shape[1] != len(self.categories_):
            raise ValueError(f"fit saw {len(self.categories_)} features, transform got {arr.shape[1]}")
        import scipy.sparse as sp

        cols = self._encode_columns(arr)
        keep = cols >= 0
        # a row's columns ascend with its features: the CSR comes without a sort
        indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
        indices = cols[keep]
        csr = sp.csr_matrix((np.ones(indices.size, np.float32), indices, indptr),
                            shape=(arr.shape[0], self.n_features_out_))
        split = 0 if isinstance(x, DNDarray) and x.split is not None else None  # heat_tpu's rule
        return _output(csr, x, counts, split, self.sparse_output)

    def serving_program(self) -> dict:
        _not_ported("OneHotEncoder.serving_program (a serving transform endpoint)", "item 13")

    def stream_transform(self, host, slab: Optional[int] = None) -> np.ndarray:
        """The dense (N, C) one-hot rows of a host-resident code matrix
        (``heat_tpu`` sparse_encoders.py:171): row windows stream through
        the card, each encoded there (a sorted search of each feature's
        categories, then one scatter of ones) and written back to a host
        array, which never lies on the card whole. An array is wrapped as
        an int32 ``HostArray``."""
        from ..redistribution import staging

        if self.categories_ is None:
            raise RuntimeError("fit needs to be called before stream_transform")
        if not isinstance(host, staging.HostArray):
            host = staging.HostArray(np.ascontiguousarray(host, np.int32))
        if host.shape[1] != len(self.categories_):
            raise ValueError(f"fit saw {len(self.categories_)} features, stream got {host.shape[1]}")
        C = self.n_features_out_
        tables = []

        def encode(win):
            if not tables:
                tables.extend(torch.from_numpy(np.ascontiguousarray(c)).to(win.device) for c in self.categories_)
            block = torch.zeros((win.shape[0], C + 1), dtype=torch.float32, device=win.device)
            rows = torch.arange(win.shape[0], device=win.device)
            for f, cats in enumerate(tables):
                ct = torch.promote_types(cats.dtype, win.dtype)
                vals, cats = win[:, f].to(ct).contiguous(), cats.to(ct)
                idx = torch.clamp(torch.searchsorted(cats, vals), max=cats.shape[0] - 1)
                col = torch.where(cats[idx] == vals, int(self._offsets[f]) + idx, C)  # C: unknown, dropped
                block.index_put_((rows, col), torch.ones_like(vals, dtype=torch.float32), accumulate=True)
            return block[:, :C]

        return _stream(host, "onehot", C, C * 4 * 4096 + (1 << 20), slab, encode)


class TfidfTransformer(BaseEstimator, TransformMixin):
    """Scale a term-count matrix to smoothed TF-IDF, emitted sparse
    (``heat_tpu`` sparse_encoders.py:214).

    ``idf = log((1 + N) / (1 + df)) + 1`` (sklearn's ``smooth_idf``), rows
    l2-normalized. ``fit`` takes a dense count matrix or a ``DCSR_matrix``;
    ``transform`` keeps the input's pattern: the work is a scale of each
    stored element and a norm a row, never a densify."""

    def __init__(self, sparse_output: bool = True, norm: Optional[str] = "l2"):
        if norm not in (None, "l2"):
            raise ValueError(f"norm must be 'l2' or None, got {norm!r}")
        self.sparse_output = bool(sparse_output)
        self.norm = norm
        self.idf_ = None

    @staticmethod
    def _counts_csr(x):
        """(this rank's rows of the counts as scipy CSR, the row map or
        None)."""
        import scipy.sparse as sp

        if isinstance(x, DCSR_matrix):
            ptr, idx, dat = (_sfactories._host_numpy(t) for t in x._phys_components)
            csr = sp.csr_matrix((dat, idx, ptr), shape=x.lshape)
            return csr, (np.asarray(x.row_counts) if x.is_distributed() else None)
        if isinstance(x, DNDarray) and x.is_distributed() and x.split != 0:
            x = x.numpy()  # a split-1 operand's result is whole in heat_tpu
        arr, counts = _rows(x)
        return sp.csr_matrix(arr.astype(np.float32, copy=False)), counts

    def fit(self, x, y=None) -> "TfidfTransformer":
        csr, counts = self._counts_csr(x)
        N, V = int(csr.shape[0] if counts is None else np.sum(counts)), csr.shape[1]
        df = np.bincount(csr.indices, minlength=V).astype(np.float64)
        if counts is not None:  # every rank's document frequencies
            df = x.comm.allreduce(torch.from_numpy(df).to(x.device.torch_device)).cpu().numpy()
        self.idf_ = (np.log((1.0 + N) / (1.0 + df)) + 1.0).astype(np.float32)
        return self

    def transform(self, x) -> Union[DCSR_matrix, DNDarray]:
        """The TF-IDF rows of ``x``; across ranks each rank scales its own
        rows into its row slab of a split-0 matrix."""
        if self.idf_ is None:
            raise RuntimeError("fit needs to be called before transform")
        csr, counts = self._counts_csr(x)
        csr = csr.astype(np.float32)
        if csr.shape[1] != self.idf_.shape[0]:
            raise ValueError(f"fit saw {self.idf_.shape[0]} terms, transform got {csr.shape[1]}")
        out = csr.copy()
        out.data = out.data * self.idf_[out.indices]
        if self.norm == "l2":
            norms = np.sqrt(np.asarray(out.multiply(out).sum(axis=1))).ravel()
            scale = np.where(norms > 0, 1.0 / np.maximum(norms, 1e-30), 0.0)
            out.data = out.data * np.repeat(scale.astype(np.float32), np.diff(out.indptr))
        split = 0 if isinstance(x, (DNDarray, DCSR_matrix)) and x.split == 0 else None  # heat_tpu's rule
        return _output(out, x, counts, split, self.sparse_output)

    def serving_program(self) -> dict:
        _not_ported("TfidfTransformer.serving_program (a serving transform endpoint)", "item 13")

    def stream_transform(self, host, slab: Optional[int] = None) -> np.ndarray:
        """The dense TF-IDF rows of a host-resident count matrix
        (``heat_tpu`` sparse_encoders.py:302), streamed as
        :meth:`OneHotEncoder.stream_transform` is: each row window scaled by
        idf (and l2-normalized) on the card. An array is wrapped as a
        float32 ``HostArray``."""
        from ..redistribution import staging

        if self.idf_ is None:
            raise RuntimeError("fit needs to be called before stream_transform")
        if not isinstance(host, staging.HostArray):
            host = staging.HostArray(np.ascontiguousarray(host, np.float32))
        V = host.shape[1]
        if V != self.idf_.shape[0]:
            raise ValueError(f"fit saw {self.idf_.shape[0]} terms, stream got {V}")
        idf = []

        def encode(win):
            if not idf:
                idf.append(torch.from_numpy(self.idf_).to(win.device))
            y = win.to(torch.float32) * idf[0][None, :]
            if self.norm == "l2":
                nrm = torch.sqrt(torch.sum(y * y, dim=1, keepdim=True))
                y = y / torch.where(nrm > 0, nrm, 1.0)
            return y

        return _stream(host, "tfidf", V, V * 4 + (1 << 20), slab, encode)
