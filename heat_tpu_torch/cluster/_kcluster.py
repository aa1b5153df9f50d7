"""Shared k-clustering machinery.

Port of ``heat_tpu.cluster._kcluster`` (Heat reference:
heat/cluster/_kcluster.py). ``heat_tpu`` compiles each whole fit (seeding,
the convergence loop and the final assignment) into one XLA program. The
port runs the same steps as a plain function on torch tensors: seeding,
then a Python loop with ``heat_tpu``'s condition, then the final
assignment. The loop reads the centers' shift on the host once per
iteration.

Temporaries that XLA never built are not built here either: the
k-means++ candidate distances are taken one candidate at a time, in row
chunks, and the L1 distances through ``torch.cdist``.

``heat_tpu`` runs a fit on a mesh-sharded operand as one program. The
port runs one process per rank: on an operand split along axis 0 each
rank holds its rows, and every step that needs all of them takes a
collective (``_Rows``), so that every rank keeps the same centers: the
k-means++ draws and potentials, the k random rows, the Lloyd step's sums,
counts and inertia, the exact per-cluster medians of KMedians and
KMedoids (``_cluster_medians``: one sort a step on each rank, then a
bisection on the values' order-preserving keys with the counts below
each pivot all-reduced), the medoid's nearest member, and the functional
value.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..core import _threefry, random as ht_random, types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from ..kernels import sort as _sort, threefry as _r1

__all__ = ["_KCluster"]

_SEEDED_INITS = ("probability_based", "kmeans++", "k-means++")

# rows per chunk when distances to one point are taken over the whole
# operand: a (chunk, d) temporary instead of an (n, d) one
_ROW_CHUNK = 1 << 20


def _seed_key(k: int) -> _threefry.Key:
    """The seeding key, ``fold_in(key(seed), counter)`` of the current
    stream, which then advances by the k draws the ++-seeding consumes
    (``heat_tpu``'s ``_seed_key``, _kcluster.py:33)."""
    state = ht_random.get_state()
    key = _threefry.fold_in(_threefry.seed_key(state[1]), state[2])
    ht_random.set_state((state[0], state[1], state[2] + k, 0, 0.0))
    return key


def make_fit_loop(step: Callable, tol: float, max_iter: int, returns_inertia: bool):
    """The convergence loop of a fit: ``step(arr, centers)`` returns
    ``(new_centers, shift[, inertia])``; the loop runs while
    ``it < max_iter and shift > tol``, from shift = +inf, as ``heat_tpu``'s
    ``while_loop`` does (_kcluster.py:44). Returns ``run(arr, centers0) ->
    (centers, n_iter[, inertia])``."""

    def run(arr: torch.Tensor, centers: torch.Tensor):
        # the comparison runs in the data's dtype, as in the traced loop
        tol_ = torch.tensor(tol, dtype=arr.dtype).item()
        it, shift = 0, float("inf")
        inertia = torch.zeros((), dtype=arr.dtype, device=arr.device)
        while it < max_iter and shift > tol_:
            res = step(arr, centers)
            centers = res[0]
            if returns_inertia:
                inertia = res[2]
            shift = float(res[1])
            it += 1
        return (centers, it, inertia) if returns_inertia else (centers, it)

    return run


def _sqdist_to(arr: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """``Σ_j (arr[:, j] − point[j])²`` per row, in row chunks."""
    out = torch.empty(arr.shape[0], dtype=arr.dtype, device=arr.device)
    for s in range(0, arr.shape[0], _ROW_CHUNK):
        diff = arr[s : s + _ROW_CHUNK] - point
        out[s : s + _ROW_CHUNK] = torch.sum(diff * diff, dim=1)
    return out


class _Rows:
    """Where the rows of an operand lie: ``comm`` is None for an operand
    whole on this rank, else the communicator of one split along axis 0
    with ``counts[q]`` rows on rank q. ``n`` is the global row count and
    ``offset`` the global index of this rank's first row."""

    def __init__(self, comm, counts):
        self.comm = comm
        self.counts = [int(c) for c in counts]
        self.n = sum(self.counts)
        self.rank = 0 if comm is None else comm.rank
        self.offset = sum(self.counts[: self.rank])

    @classmethod
    def of(cls, x: DNDarray) -> "_Rows":
        return cls(x.comm, x.counts_displs()[0]) if x.is_distributed() else cls(None, [x.shape[0]])

    def allreduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the ranks by ``op`` (``t`` itself for a whole
        operand)."""
        return t if self.comm is None else self.comm.allreduce(t, op)

    def row(self, arr: torch.Tensor, i: int) -> torch.Tensor:
        """Global row ``i`` on every rank: one broadcast from its owner."""
        if self.comm is None:
            return arr[i]
        owner = int(np.searchsorted(np.cumsum(self.counts), i, side="right"))
        mine = arr[i - self.offset] if owner == self.rank else arr.new_zeros(arr.shape[1])
        return self.comm.bcast(mine.contiguous(), root=owner)


def _draw_rows(arr: torch.Tensor, d2: torch.Tensor, size: int, key, rows: _Rows) -> torch.Tensor:
    """``size`` rows drawn with replacement with probability proportional to
    ``d2``, as ``jax.random.choice(key, n, (size,), p=d2 / max(Σd2, 1e-30))``
    draws them (random.py:806-808), in d2's dtype: the cumulative sum of the
    probabilities, then a search for ``total · (1 − u)`` with u
    ``jax.random.uniform(key, (size,))``. Across ranks Σd2 is all-reduced,
    every rank draws the same u, and the cumulative sum is each rank's own,
    after the totals of the ranks before it (one all-gather of the
    per-rank totals); only the owner of a draw searches its rows, and the
    drawn rows reach every rank in one all-gather."""
    probs = d2 / torch.clamp_min(rows.allreduce(torch.sum(d2)), 1e-30)
    cum = torch.cumsum(probs, dim=0)
    u = _r1.draw("uniform", key, _threefry.Chunk.whole((size,)), d2.dtype, arr.device, (0.0, 1.0))
    if rows.comm is None:
        return arr[torch.searchsorted(cum, cum[-1] * (1 - u)).clamp_max(arr.shape[0] - 1)]
    comm = rows.comm
    mine = cum[-1:] if cum.numel() else torch.zeros(1, dtype=cum.dtype, device=arr.device)
    totals = comm.allgather(mine)
    ends = torch.cumsum(totals, dim=0)
    r = ends[-1] * (1.0 - u)
    # a rank without rows owns no draw, also when every total is 0
    holders = torch.tensor([q for q, c in enumerate(rows.counts) if c], device=arr.device)
    owner = holders[torch.searchsorted(ends[holders], r).clamp_max(holders.numel() - 1)]
    picked = arr.new_zeros((size, arr.shape[1]))
    if arr.shape[0]:
        start = ends[rows.rank] - totals[rows.rank]
        local = torch.searchsorted(cum, r - start).clamp_max(arr.shape[0] - 1)
        picked = torch.where((owner == rows.rank)[:, None], arr[local], picked)
    every = comm.allgather(picked)  # (p · size, d): rank q's picks at [q · size, (q + 1) · size)
    return every[owner * size + torch.arange(size, device=arr.device)]


def _kmeanspp(arr: torch.Tensor, k: int, key, rows: Optional[_Rows] = None) -> torch.Tensor:
    """Greedy k-means++ seeding (``heat_tpu``'s ``_kmeanspp_program``,
    _kcluster.py:150) from ``key`` (``_seed_key``): ``split(key, k)``, the
    first row ``randint(keys[0], (), 0, n)``, then step i draws 2 + ⌊ln k⌋
    candidates with ``keys[i]`` with probability proportional to the
    current squared distance and keeps the one that minimizes the
    potential. ``arr`` holds this rank's rows (``rows``; a whole operand by
    default): every rank draws the same candidates from the same keys, the
    first row comes from its owner, and the candidates' potentials are one
    all-reduce a step, so every rank keeps the same centers."""
    rows = _Rows(None, [arr.shape[0]]) if rows is None else rows
    n_candidates = 2 + int(np.log(max(k, 2)))
    keys = _threefry.split(key, k)
    first = int(_r1.draw("randint", keys[0], _threefry.Chunk.whole(()), torch.int64, arr.device, (0, rows.n)))
    centers = torch.zeros((k, arr.shape[1]), dtype=arr.dtype, device=arr.device)
    centers[0] = rows.row(arr, first)
    d2 = _sqdist_to(arr, centers[0])
    for i in range(1, k):
        cand_pts = _draw_rows(arr, d2, n_candidates, keys[i], rows)  # (L, d)
        cand_d2 = torch.stack([_sqdist_to(arr, p) for p in cand_pts])  # (L, n)
        potentials = rows.allreduce(torch.stack([torch.sum(torch.minimum(d2, c)) for c in cand_d2]))
        best = torch.argmin(potentials)
        centers[i] = cand_pts[best]
        d2 = torch.minimum(d2, cand_d2[best])
    return centers


def _random_rows(arr: torch.Tensor, idx: torch.Tensor, rows: _Rows) -> torch.Tensor:
    """The rows of global indices ``idx`` on every rank: each rank fills
    the rows it owns, and one all-reduce sums them."""
    if rows.comm is None:
        return arr[idx]
    local = idx - rows.offset
    here = (local >= 0) & (local < arr.shape[0])
    picked = arr.new_zeros((idx.numel(), arr.shape[1]))
    if arr.shape[0]:
        picked = torch.where(here[:, None], arr[local.clamp(0, arr.shape[0] - 1)], picked)
    return rows.allreduce(picked)


def _pairwise(arr: torch.Tensor, c: torch.Tensor, metric: str = "euclidean") -> torch.Tensor:
    """Sample × center distances: Euclidean through the quadratic
    expansion, or Manhattan through ``torch.cdist`` (no (n, k, d)
    temporary)."""
    if metric == "manhattan":
        return torch.cdist(arr, c, p=1)
    x2 = torch.sum(arr * arr, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1, keepdim=True).T
    return torch.sqrt(torch.clamp_min(x2 + c2 - 2.0 * (arr @ c.T), 0.0))


def _l1_assign(arr: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """First-index argmin labels under the L1 metric."""
    return torch.argmin(_pairwise(arr, centers, "manhattan"), dim=1)


_SIGN64 = -(1 << 63)  # the sign bit of an int64
_DIGIT = 2  # key bits a counting round of the cross-rank median settles


def _int64_word(u: int) -> int:
    """The int64 holding the unsigned 64-bit value ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


def _unsigned_words(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned ``bits``-bit values held in int64 as the words of
    ``kernels.sort.to_sortable`` (the signed dtype of that width)."""
    if bits == 64:
        return u
    return torch.where(u >= 2 ** (bits - 1), u - 2**bits, u).to(_sort._INT_OF_BITS[bits])


def _segment_counter(arr: torch.Tensor, labels: torch.Tensor, k: int):
    """Sort this rank's values once by (segment, value), segment j·k + i
    for cluster i and column j, and return ``(count_le, bits)``:
    ``count_le(s, c)`` counts segment s's values whose unsigned
    order-preserving key (``kernels.sort.to_sortable``, ``bits`` wide) is
    at most c, for (k, f, T) tensors s and c. Keys of at most 32 bits take
    one pair sort (K4 on a card: the segment as key, the value's word as
    the payload, ordered by both) into a (segment << 32 | key) composite
    that one ``searchsorted`` reads; 64-bit keys take two stable sorts and
    a binary search within each segment."""
    n, f = arr.shape
    words = _sort.to_sortable(arr).reshape(-1)
    bits = words.element_size() * 8
    seg = (labels[:, None].to(torch.int32) + torch.arange(f, dtype=torch.int32, device=arr.device) * k).reshape(-1)
    if bits <= 32:
        if bits < 32:
            words = (words.to(torch.int64) & ((1 << bits) - 1)).to(torch.int32)
        sk, sp = _sort.pair_sort(seg, words, pay_bytes=bits // 8)
        del words, seg
        comp = sk.to(torch.int64)
        del sk
        comp <<= 32
        low = sp.to(torch.int64)
        del sp
        low &= 0xFFFFFFFF
        comp |= low
        del low

        def count_le(s, c):
            return torch.searchsorted(comp, (s << 32) | c, right=True) - torch.searchsorted(comp, s << 32)

        return count_le, bits
    key = words ^ _SIGN64  # signed order = the words' unsigned order
    del words
    order = torch.sort(key, stable=True).indices
    order = order[torch.sort(seg[order], stable=True).indices]
    sorted_key, sorted_seg = key[order], seg[order].to(torch.int64)
    del key, seg, order
    ids = torch.arange(k * f, device=arr.device)
    starts = torch.searchsorted(sorted_seg, ids)
    ends = torch.searchsorted(sorted_seg, ids, right=True)
    steps = int((ends - starts).max()).bit_length() if ids.numel() and sorted_key.numel() else 0

    def count_le(s, c):
        lo, hi = starts[s], ends[s]
        q = c ^ _SIGN64
        for _ in range(steps):
            mid = (lo + hi) >> 1
            le = sorted_key[mid.clamp(max=sorted_key.numel() - 1)] <= q
            lo, hi = torch.where((lo < hi) & le, mid + 1, lo), torch.where((lo < hi) & ~le, mid, hi)
        return lo - starts[s]

    return count_le, bits


def _cluster_medians(arr: torch.Tensor, labels: torch.Tensor, k: int, rows: "_Rows"):
    """The coordinate-wise median of each cluster over every rank's rows,
    exact, and the clusters' global row counts: ``jnp.nanmedian`` of the
    NaN-masked operand (``heat_tpu`` kmedians.py:36, kmedoids.py:38). For
    cluster i and column j with C non-NaN values, q = 0.5 · (C − 1): the
    order statistics ⌊q⌋ and ⌈q⌉, interpolated linearly; NaN where C = 0.

    Each rank sorts its (cluster, column) segments once (``_segment_counter``).
    The order statistics are then found ``_DIGIT`` bits at a time on the
    values' unsigned order-preserving keys, from the top: a round counts
    the keys at most each of the digit's 2^_DIGIT − 1 candidates in every
    segment and all-reduces one (k, f, 2, 2^_DIGIT − 1) int64 tensor, so
    ``bits / _DIGIT`` rounds (16 for float32) give both statistics bit for
    bit; one more all-reduce first gives the counts."""
    f, dev = arr.shape[1], arr.device
    count_le, bits = _segment_counter(arr, labels, k)
    s = (torch.arange(k, device=dev)[:, None] + torch.arange(f, device=dev)[None, :] * k)[:, :, None]
    # the NaN key is all ones: everything below it is a value
    not_nan = count_le(s, torch.full_like(s, (1 << bits) - 2 if bits < 64 else -2))[:, :, 0]
    sizes = torch.bincount(labels, minlength=k)
    counts = rows.allreduce(torch.cat([not_nan.reshape(-1), sizes]))
    not_nan, sizes = counts[: k * f].reshape(k, f), counts[k * f :]
    rank = torch.stack([(not_nan - 1) // 2, not_nan // 2], dim=-1).clamp_min(0)[..., None]  # (k, f, 2, 1)
    width = (1 << _DIGIT) - 1
    s = s[..., None].expand(k, f, 2, width)
    prefix = torch.zeros((k, f, 2, 1), dtype=torch.int64, device=dev)
    lows = list(reversed(range(0, bits, _DIGIT)))
    # digit d at bits b.. of round i's candidates (as int64 words)
    steps = torch.tensor([[_int64_word(d << b) for d in range(width + 1)] for b in lows], dtype=torch.int64,
                         device=dev)
    for b, step in zip(lows, steps):
        # digit d's candidate: the prefix, d at bits b.., every lower bit set
        below = rows.allreduce(count_le(s, prefix | step[:width] | ((1 << b) - 1)))
        # the digit is the first d whose candidate has more keys at or below it than the rank
        prefix = prefix | step[torch.sum(below <= rank, dim=-1, keepdim=True)]
    prefix = prefix[..., 0]
    values = _sort.from_sortable(_unsigned_words(prefix, bits), arr.dtype)
    q = 0.5 * (not_nan.to(arr.dtype) - 1)
    w_hi = q - torch.floor(q)
    med = values[..., 0] * (1 - w_hi) + values[..., 1] * w_hi
    med = torch.where(not_nan > 0, med, torch.full_like(med, float("nan")))
    return med, sizes


def _nearest_members(arr: torch.Tensor, labels: torch.Tensor, med: torch.Tensor, rows: "_Rows") -> torch.Tensor:
    """For each cluster the member row nearest to ``med[i]`` in L1 over
    every rank's rows, the lowest global index on ties (``jnp.argmin``'s
    first index, ``heat_tpu`` kmedoids.py:40-42): the least distance and
    then the least index of a row at it are all-reduced minima, and the
    rows reach every rank in one all-reduce (``_random_rows``). A cluster
    without members gets some row; callers keep its center."""
    k = med.shape[0]
    dist = torch.empty(arr.shape[0], dtype=arr.dtype, device=arr.device)
    for s in range(0, arr.shape[0], _ROW_CHUNK):
        dist[s : s + _ROW_CHUNK] = torch.sum(
            torch.abs(arr[s : s + _ROW_CHUNK] - med[labels[s : s + _ROW_CHUNK]]), dim=1
        )
    inf = torch.full((k,), float("inf"), dtype=arr.dtype, device=arr.device)
    best = rows.allreduce(inf.scatter_reduce(0, labels, dist, "amin"), "min")
    none = torch.full((k,), rows.n, dtype=torch.int64, device=arr.device)
    index = torch.arange(arr.shape[0], device=arr.device) + rows.offset
    at_best = torch.where(dist == best[labels], index, rows.n)
    first = rows.allreduce(none.scatter_reduce(0, labels, at_best, "amin"), "min")
    return _random_rows(arr, first.clamp_max(rows.n - 1), rows)


def _predict(arr: torch.Tensor, centers: torch.Tensor, metric: str, eval_fv: bool, rows: Optional[_Rows] = None):
    """Labels (int64, first-index argmin) of this rank's rows and, with
    ``eval_fv``, the functional value over every rank's (one all-reduce):
    Σ min d for Manhattan, Σ (min d)² for Euclidean (``heat_tpu``'s
    ``_predict_program``, _kcluster.py:109)."""
    d = _pairwise(arr, centers, metric)
    labels = torch.argmin(d, dim=1)
    if not eval_fv:
        return labels
    dmin = torch.gather(d, 1, labels[:, None])
    fun = torch.sum(dmin) if metric == "manhattan" else torch.sum(dmin**2)
    return labels, fun if rows is None else rows.allreduce(fun)


class _KCluster(BaseEstimator, ClusteringMixin):
    """Base class for k-statistics clustering (reference: _kcluster.py)."""

    def __init__(
        self,
        n_clusters: int,
        init: Union[str, DNDarray],
        max_iter: int,
        tol: float,
        random_state: Optional[int],
    ):
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state

        self._cluster_centers = None
        self._labels = None
        self._inertia = None
        self._n_iter = None
        # random_state gives the model a private (seed, counter) stream that
        # only its own inits advance; without it the global stream is used
        # (heat_tpu _kcluster.py:206-222)
        self._rng_state = (
            None if random_state is None else (ht_random.ALGORITHM, int(random_state), 0, 0, 0.0)
        )

    def _with_stream(self, fn):
        """Run ``fn()`` against the model's private stream when it has one,
        else against the global stream; the private stream's advanced state
        is kept and the global stream is left as it was (heat_tpu
        _kcluster.py:224)."""
        if self._rng_state is None:
            return fn()
        outer = ht_random.get_state()
        ht_random.set_state(self._rng_state)
        try:
            return fn()
        finally:
            self._rng_state = ht_random.get_state()
            ht_random.set_state(outer)

    @property
    def rng_state(self):
        """The model's private stream state ``("Threefry", seed, counter, 0,
        0.0)`` (``heat_tpu``'s, so a ``heat_tpu`` model's carries across), or
        None for a model on the global stream."""
        return self._rng_state

    @rng_state.setter
    def rng_state(self, state) -> None:
        self._rng_state = None if state is None else tuple(state)

    @property
    def cluster_centers_(self) -> DNDarray:
        """Coordinates of the cluster centers."""
        return self._cluster_centers

    @property
    def labels_(self) -> DNDarray:
        """Label of each sample point."""
        return self._labels

    @property
    def inertia_(self) -> float:
        """Sum of squared distances of samples to their closest center (L1
        distances for the Manhattan family). Kept on the device by fit; the
        first access reads it to the host."""
        if self._inertia is None:
            return None
        if not isinstance(self._inertia, float):
            self._inertia = float(self._inertia)
        return self._inertia

    @property
    def n_iter_(self) -> int:
        """Number of iterations run."""
        return None if self._n_iter is None else int(self._n_iter)

    # ------------------------------------------------------------------ #
    # the operand                                                        #
    # ------------------------------------------------------------------ #
    def _operand(self, x: DNDarray):
        """``(x_rows, arr, rows)``: ``x`` with its samples along axis 0 (an
        operand split along its features is resplit to 0 first), this
        rank's rows as a contiguous float tensor (integer data become
        float32), and where the rows lie."""
        if x.is_distributed() and x.split != 0:
            x = x.resplit(0)
        arr = x.larray
        arr = arr.to(torch.float32) if types.heat_type_is_exact(x.dtype) else arr
        return x, arr.contiguous(), _Rows.of(x)

    # ------------------------------------------------------------------ #
    # initialization (reference: _kcluster.py:87-187)                    #
    # ------------------------------------------------------------------ #
    def _initialize_cluster_centers(self, x: DNDarray) -> None:
        self._init_centers(*self._operand(x))

    def _init_centers(self, x: DNDarray, arr: torch.Tensor, rows: _Rows) -> None:
        """The initial centers, the same on every rank: the given array
        (gathered when split), k rows of one global permutation, or
        k-means++ over every rank's rows."""
        k = self.n_clusters
        n, d = x.shape
        if isinstance(self.init, DNDarray):
            if self.init.shape != (k, d):
                raise ValueError(
                    f"passed centroids need to be of shape ({k}, {d}), got {self.init.shape}"
                )
            centers = self.init.resplit(None).larray.to(device=arr.device, dtype=arr.dtype)
        elif isinstance(self.init, str) and self.init == "random":
            # k observations drawn at random from the data
            if k > n:
                raise ValueError(
                    f"init='random' draws n_clusters={k} distinct samples, but the data hold only {n}"
                )
            idx = self._with_stream(lambda: ht_random.randperm(n, device=x.device).larray[:k])
            centers = _random_rows(arr, idx.to(arr.device), rows)
        elif isinstance(self.init, str) and self.init in _SEEDED_INITS:
            centers = _kmeanspp(arr, k, self._with_stream(lambda: _seed_key(k)), rows)
        else:
            raise ValueError(
                f"initialization needs to be 'random', 'probability_based' or a DNDarray, got {self.init}"
            )
        self._cluster_centers = self._replicated(centers, x)

    @staticmethod
    def _replicated(centers: torch.Tensor, x: DNDarray) -> DNDarray:
        return DNDarray(
            centers, tuple(centers.shape), types.canonical_heat_type(centers.dtype), None,
            x.device, x.comm,
        )

    @staticmethod
    def _labels_of(labels: torch.Tensor, x: DNDarray) -> DNDarray:
        """Labels of ``x``'s rows (``x`` as ``_operand`` returns it), split
        0 when ``x`` is split, each rank's shard the labels of its rows."""
        split = 0 if x.split is not None else None
        lmap = x.lshape_map[:, :1] if x.is_distributed() else None
        return DNDarray(labels, (x.shape[0],), types.int64, split, x.device, x.comm, lmap)

    # ------------------------------------------------------------------ #
    # assignment (reference: _kcluster.py:196-209)                       #
    # ------------------------------------------------------------------ #
    _assignment_metric = "euclidean"

    def _assign_to_cluster(self, x: DNDarray, eval_functional_value: bool = False) -> DNDarray:
        """Label of the closest center for every sample, with the subclass's
        assignment metric; with ``eval_functional_value`` also sets
        ``inertia_`` (over every rank's rows)."""
        sanitize_in(x)
        x, arr, rows = self._operand(x)
        c = self._cluster_centers.larray.to(device=arr.device)
        if eval_functional_value:
            labels, self._inertia = _predict(arr, c, self._assignment_metric, True, rows)
        else:
            labels = _predict(arr, c, self._assignment_metric, False)
        return self._labels_of(labels, x)

    # ------------------------------------------------------------------ #
    # the whole fit, shared by the three estimators                      #
    # ------------------------------------------------------------------ #
    def _fit_fused(self, x: DNDarray, step: Callable, returns_inertia: bool):
        """The whole fit (``heat_tpu``'s ``_fused_fit_program``,
        _kcluster.py:80): seeding or the given init, the convergence loop
        over ``step(arr, centers)`` (Lloyd / median / medoid), then the
        final assignment. On a split operand the step also takes where the
        rows lie (``rows=``) and gives the same centers on every rank.
        ``inertia_`` is the last step's when ``returns_inertia``, else the
        final assignment's functional value."""
        sanitize_in(x)
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2-dimensional, got {x.ndim}")
        x, arr, rows = self._operand(x)
        self._init_centers(x, arr, rows)
        if rows.comm is not None:
            step = functools.partial(step, rows=rows)
        loop = make_fit_loop(step, float(self.tol), int(self.max_iter), returns_inertia)
        res = loop(arr, self._cluster_centers.larray)
        centers, n_iter = res[0], res[1]
        if returns_inertia:
            labels, inertia = _predict(arr, centers, self._assignment_metric, False), res[2]
        else:
            labels, inertia = _predict(arr, centers, self._assignment_metric, True, rows)
        self._n_iter = n_iter
        self._inertia = inertia
        self._cluster_centers = self._replicated(centers, x)
        self._labels = self._labels_of(labels, x)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Labels of the closest cluster center for new data (reference:
        _kcluster.py predict)."""
        sanitize_in(x)
        if self._cluster_centers is None:
            raise RuntimeError("fit needs to be called before predict")
        return self._assign_to_cluster(x)
