"""SPMD primitives across ranks: the halo exchange, the ring of pairwise
distances, and the distributed sort family (sort networks, top-k and
unique).

Port of ``heat_tpu.core.parallel`` (``halo_exchange`` :131, ``ring_pairwise``
:492, ``distributed_sort``
:446, ``_columnsort_program`` :343, ``_oddeven_sort_program`` :280,
``_oddeven_sort_values_program`` :237, ``distributed_topk`` :80,
``distributed_unique`` :947, ``distributed_unique_rows`` :922). ``heat_tpu``
runs each as one ``shard_map`` program over the mesh; here every rank runs
the same schedule on its own block over ``torch.distributed``, the mesh's
``ppermute`` and ``all_to_all`` becoming the communicator's ``permute`` and
``alltoall``. The local sorts are ``kernels.sort.block_sort`` (K4 for
float32 and int32 on CUDA).

The networks work on physical blocks: every rank holds B = ⌈n/p⌉ rows along
the sort axis, the pads at the global tail (positions ≥ n) holding
``kernels.sort.sentinel``, so that after the network rank r holds rows
[rB, (r + 1)B) of the sorted array and the pads are again at the tail. The
global position of every row rides as a second key, so every row is
distinct and real NaNs or type-max values stay ahead of the pads. Each
exchange packs the values and indices into one byte buffer.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..kernels import sort as _ksort

__all__ = [
    "columnsort_applicable",
    "distributed_sort",
    "distributed_topk",
    "distributed_unique",
    "halo_exchange",
    "ring_pairwise",
    "sorted_dedup",
]


# --------------------------------------------------------------------- #
# halo exchange                                                         #
# --------------------------------------------------------------------- #
def halo_exchange(x: torch.Tensor, comm, split: int, halo_prev: int, halo_next: int,
                  counts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This rank's tensor ``x`` with ``halo_prev`` rows of the previous rank
    before it and ``halo_next`` rows of the next rank after it along
    ``split``: ``[prev halo | x | next halo]``, zeros at the outer ends
    (``heat_tpu`` parallel.py:131, whose blocks are those of the mesh). Two
    ``comm.permute``s, one a direction that is asked for. Neighbours are
    the ranks that hold rows, as in the Heat reference; a rank that holds
    none sends nothing and gets zeros. ``counts`` is every rank's extent
    along ``split`` (default: learnt by one all-gather; ``DNDarray.get_halo``
    passes its map), so every rank raises ``ValueError`` together where a
    halo exceeds the fewest rows a rank that holds rows has."""
    if counts is None:
        n = torch.tensor([x.shape[split]], dtype=torch.int64, device=x.device)
        counts = comm.allgather(n).tolist()
    ranks = [q for q in range(comm.size) if int(counts[q]) > 0]
    fewest = min((int(counts[q]) for q in ranks), default=0)
    if max(halo_prev, halo_next) > fewest:
        raise ValueError(f"halo size ({halo_prev}/{halo_next}) exceeds the fewest rows a rank holds ({fewest})")
    inside = comm.rank in ranks
    n = x.shape[split]
    hops = list(zip(ranks[:-1], ranks[1:]))

    def edge(start: int, size: int) -> torch.Tensor:
        if inside:
            return x.narrow(split, start, size).contiguous()
        shape = list(x.shape)
        shape[split] = size
        return x.new_zeros(shape)

    parts = [x]
    if halo_prev > 0:  # each rank's last rows go to the next one
        parts.insert(0, comm.permute(edge(n - halo_prev if inside else 0, halo_prev), hops))
    if halo_next > 0:  # each rank's first rows go to the previous one
        parts.append(comm.permute(edge(0, halo_next), [(b, a) for a, b in hops]))
    return torch.cat(parts, split) if len(parts) > 1 else x


# --------------------------------------------------------------------- #
# the ring of pairwise distances                                        #
# --------------------------------------------------------------------- #
def ring_pairwise(x: torch.Tensor, y: torch.Tensor, comm, metric: str = "euclidean",
                  symmetric: bool = False) -> torch.Tensor:
    """This rank's rows of the all-pairs ``metric`` between the row blocks
    ``x`` and ``y`` of two arrays split along axis 0 (``heat_tpu``
    parallel.py:492): ``spatial.distance``'s ring, y's blocks passing
    around it, p − 1 hops (one all-gather of the blocks' row counts first).
    ``symmetric=True`` (x the same array as y, under a symmetric metric)
    computes p//2 + 1 blocks and fills the others with the transposes their
    owners computed. Metrics: ``euclidean`` and ``sqeuclidean`` (the
    quadratic expansion), their ``_direct`` forms and ``manhattan``. The
    result has y's global row count as columns, in the promoted type of x
    and y."""
    from ..spatial import distance

    if metric not in distance._FORMS:
        raise ValueError(f"unknown metric {metric!r}; options: {sorted(distance._FORMS)}")
    tt = torch.promote_types(x.dtype, y.dtype)
    x, y = x.to(tt), y.to(tt)
    counts = [int(y.shape[0])]
    if comm.is_distributed():
        counts = [int(c) for c in comm.allgather(torch.tensor([y.shape[0]], device=y.device)).cpu()]
    return distance._ring(comm, x, y, counts, distance._FORMS[metric], symmetric)


# --------------------------------------------------------------------- #
# byte packing of the operands of one exchange                          #
# --------------------------------------------------------------------- #
def _pack(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors (each with B rows along dim 0) as one (B, bytes) uint8
    buffer, row r holding every tensor's row r."""
    rows = ts[0].shape[0]
    return torch.cat([t.contiguous().reshape(rows, -1).view(torch.uint8) for t in ts], dim=1)


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Inverse of :func:`_pack`: tensors of ``like``'s dtypes and trailing
    shapes, with ``buf``'s rows."""
    out, at = [], 0
    for t in like:
        width = t[:1].numel() * t.element_size()
        part = buf[:, at : at + width].contiguous().view(t.dtype)
        out.append(part.reshape((buf.shape[0],) + tuple(t.shape[1:])))
        at += width
    return out


# --------------------------------------------------------------------- #
# distributed sort                                                      #
# --------------------------------------------------------------------- #
def columnsort_applicable(p: int, B: int) -> bool:
    """Leighton's bound (B ≥ 2(p − 1)², p | B), at more than 2 ranks: the
    gate between columnsort and odd-even (``heat_tpu`` parallel.py:440)."""
    return p > 2 and B % p == 0 and B >= 2 * (p - 1) ** 2


def _neighbour_pairs(p: int, start: int) -> List[Tuple[int, int]]:
    return [(a, a + 1) for a in range(start, p - 1, 2)]


def _oddeven(comm, ops: List[torch.Tensor], extent: int) -> List[torch.Tensor]:
    """The odd-even merge-split network (Baudet–Stevenson): a local sort,
    then p rounds in which paired neighbours swap blocks (one permute),
    sort the 2B rows and keep the low or high half. With indices (two
    operands) both partners sort the same distinct pairs; values alone
    are concatenated in global rank order on both sides, so the stable
    sort orders their ties alike."""
    p, r = comm.size, comm.rank
    nk = len(ops)
    B = ops[0].shape[0]
    ops = list(_ksort.block_sort(ops, 0, nk, extent=extent))
    for t in range(p):
        start = t % 2
        pairs = _neighbour_pairs(p, start)
        if not pairs:
            continue
        theirs = _unpack(comm.permute(_pack(ops), pairs + [(b, a) for a, b in pairs]), ops)
        if not start <= r <= pairs[-1][1]:
            continue
        low = (r - start) % 2 == 0
        first, second = (ops, theirs) if low else (theirs, ops)
        merged = _ksort.block_sort([torch.cat([x, y]) for x, y in zip(first, second)], 0, nk, extent=extent)
        ops = [m[:B] if low else m[B:] for m in merged]
    return ops


def _columnsort(comm, ops: List[torch.Tensor], extent: int) -> List[torch.Tensor]:
    """Leighton's columnsort: sort, deal (one all-to-all), sort, undeal (one
    all-to-all), sort; then each rank sorts the half-shard windows it
    shares with its neighbours (two permutes and two sorts), the ring ends
    keeping their boundary halves."""
    p, r = comm.size, comm.rank
    nk = len(ops)
    B = ops[0].shape[0]

    def srt(ts):
        return list(_ksort.block_sort(ts, 0, nk, extent=extent))

    def deal(ts):  # rows q·p + c go to rank c
        send = [t.reshape((B // p, p) + t.shape[1:]).movedim(1, 0).reshape(t.shape) for t in ts]
        return _unpack(comm.alltoall(_pack(send)), ts)

    def undeal(ts):  # row i of the block from rank q lands at row i·p + q
        got = _unpack(comm.alltoall(_pack(ts)), ts)
        return [t.reshape((p, B // p) + t.shape[1:]).movedim(0, 1).reshape(t.shape) for t in got]

    ops = srt(ops)
    ops = srt(deal(ops))
    ops = srt(undeal(ops))
    h = B // 2
    tops = [t[: B - h] for t in ops]
    bots = [t[B - h :] for t in ops]
    from_prev = _unpack(comm.permute(_pack(bots), [(i, i + 1) for i in range(p - 1)]), bots)
    from_next = _unpack(comm.permute(_pack(tops), [(i + 1, i) for i in range(p - 1)]), tops)
    up = tops if r == 0 else [t[h:] for t in srt([torch.cat(x) for x in zip(from_prev, tops)])]
    dn = bots if r == p - 1 else [t[:h] for t in srt([torch.cat(x) for x in zip(bots, from_next)])]
    return [torch.cat(x) for x in zip(up, dn)]


def distributed_sort(x: torch.Tensor, comm, split: int, with_indices: bool = True):
    """Ascending sort along ``split`` of the array whose physical block on
    this rank is ``x`` (B rows along ``split`` on every rank, pads at the
    global tail holding ``kernels.sort.sentinel``), without gathering it.
    Every rank calls it.

    Columnsort where ``columnsort_applicable(p, B)`` (2 all-to-alls and 2
    permutes), else the odd-even network (at most p permutes). Returns this
    rank's block of the sorted values and, with ``with_indices``, of the
    int64 global positions they came from (pads have positions ≥ n);
    without, the values alone through the values-only odd-even network,
    or columnsort on values."""
    p, r = comm.size, comm.rank
    v = x.movedim(split, 0).contiguous()
    B = v.shape[0]
    ops = [v]
    if with_indices:
        pos = torch.arange(r * B, (r + 1) * B, dtype=torch.int64, device=v.device)
        ops.append(pos.reshape((B,) + (1,) * (v.ndim - 1)).expand(v.shape).contiguous())
    if columnsort_applicable(p, B):
        out = _columnsort(comm, ops, p * B)
    else:
        out = _oddeven(comm, ops, p * B)
    out = [t.movedim(0, split).contiguous() for t in out]
    return tuple(out) if with_indices else out[0]


# --------------------------------------------------------------------- #
# distributed top-k                                                     #
# --------------------------------------------------------------------- #
def distributed_topk(x: torch.Tensor, comm, split: int, k: int, largest: bool = True):
    """Top k along ``split`` of the array whose physical block on this rank
    is ``x`` (B rows along ``split`` on every rank, the caller having filled
    the pads with the value that loses). Each rank takes its top min(k, B)
    with their global positions; one all-gather of the p·min(k, B)
    candidates, then the final top k on every rank. The order is IEEE
    totalOrder (``lax.top_k``'s), the lower position first among ties.
    Returns (values, int64 positions), whole on every rank."""
    moved = x.movedim(split, -1).contiguous()
    B = moved.shape[-1]
    kk = min(k, B)
    lead = moved.shape[:-1]
    if k == 0:  # nothing to gather
        empty = moved[..., :0]
        return empty.movedim(-1, split), empty.to(torch.int64).movedim(-1, split)
    order = _ksort.argsort(moved, total=True, descending=largest)[..., :kk].contiguous()
    lv = moved.gather(-1, order)
    gi = order + comm.rank * B
    cand = comm.allgather(_pack([lv.reshape(1, -1), gi.reshape(1, -1)]))  # (p, bytes)
    cv, ci = _unpack(cand, [lv.reshape(1, -1), gi.reshape(1, -1)])
    p = comm.size
    cv = cv.reshape((p,) + lead + (kk,)).movedim(0, -2).reshape(lead + (p * kk,))
    ci = ci.reshape((p,) + lead + (kk,)).movedim(0, -2).reshape(lead + (p * kk,))
    sel = _ksort.argsort(cv, total=True, descending=largest)[..., :k].contiguous()
    return cv.gather(-1, sel).movedim(-1, split).contiguous(), ci.gather(-1, sel).movedim(-1, split).contiguous()


# --------------------------------------------------------------------- #
# unique                                                                #
# --------------------------------------------------------------------- #
def _nan_canonical(t: torch.Tensor) -> torch.Tensor:
    """Complex values with a NaN in either part become nan+0j, as
    ``jnp.unique`` makes them before it sorts."""
    if not t.is_complex():
        return t
    return torch.where(torch.isnan(t), torch.full_like(t, complex(float("nan"), 0.0)), t)


def _columns_of(t: torch.Tensor):
    """Real columns of a 1-D tensor, most significant first: itself, or
    (real, imag) for complex."""
    if t.is_complex():
        return [t.real.contiguous(), t.imag.contiguous()]
    return [t]


def _item_columns(items: torch.Tensor):
    """The real columns that order the items (rows of ``items`` along dim
    0), most significant first: every element of a row, complex ones as
    (real, imag)."""
    if items.ndim == 1:
        return _columns_of(items)
    rows = items.flatten(1)
    return [c for j in range(rows.shape[1]) for c in _columns_of(rows[:, j].contiguous())]


def _lex_sort(cols):
    """Stable lexicographic argsort of rows whose columns are the 1-D real
    ``cols`` (most significant first), by their sort keys: one stable sort
    per column, the last column first, carrying the row permutation (the
    first of them K4's fused entry for float32 and int32 on CUDA). Returns
    the permutation and the columns' keys in its order."""
    perm = None
    for col in reversed(cols):
        if perm is None:
            last, perm = _ksort.sort_with_key(col)
        else:
            last, perm = _ksort.sort_keys(_ksort.sort_key(col[perm]), perm)
    return perm, [last] + [_ksort.sort_key(col[perm]) for col in cols[1:]]


def _groups(sorted_keys, n: int, device) -> torch.Tensor:
    """True where a run of equal keys begins."""
    start = torch.ones(n, dtype=torch.bool, device=device)
    if n > 1:
        differ = torch.zeros(n - 1, dtype=torch.bool, device=device)
        for key in sorted_keys:
            differ |= key[1:] != key[:-1]
        start[1:] = differ
    return start


def sorted_dedup(items: torch.Tensor):
    """Unique items (rows of ``items`` along dim 0, complex NaNs made one
    value first) grouped on the sort keys of their columns, in sorted
    order: the first of each group in input order, and each item's group
    (int64) — the dedup core of every unique (``heat_tpu``
    ``_sorted_dedup`` :779 and ``_sorted_dedup_rows`` :848)."""
    items = _nan_canonical(items)
    n = items.shape[0]
    perm, sorted_keys = _lex_sort(_item_columns(items))
    start = _groups(sorted_keys, n, items.device)
    inverse = torch.empty(n, dtype=torch.int64, device=items.device)
    inverse[perm] = torch.cumsum(start, 0) - 1
    return items[perm[start]], inverse


def distributed_unique(items: torch.Tensor, comm):
    """Unique items (rows along dim 0) of the array split across ranks whose
    items on this rank are ``items``, without gathering it (``heat_tpu``
    parallel.py:947 and, for rows, :922): a sorted dedup on each rank, one
    all-gather of the counts, one all-gather of the candidates, and the
    merge on every rank. A group's representative is its first member in
    global order. Returns the unique items (whole on every rank) and each
    local item's position among them."""
    local, inv = sorted_dedup(items)
    counts = comm.allgather(torch.tensor([local.shape[0]], dtype=torch.int64, device=items.device))
    counts = [int(c) for c in counts.cpu()]
    merged, where = sorted_dedup(comm.allgather(local, 0, counts))
    start = sum(counts[: comm.rank])
    return merged, where[start : start + local.shape[0]][inv]
