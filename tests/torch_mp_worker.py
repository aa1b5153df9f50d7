"""One rank of the 4-rank gloo world of tests/test_torch_distributed.py.

``run(rank, world, init_file, out_dir)`` joins a ``torch.distributed``
world through ``init_method=file://init_file`` (no TCP port), runs every
case of ``CASES`` on heat_tpu_torch, and pickles {case: result} to
``out_dir/rank<r>.pkl``. A result is a dict of plain values and numpy
arrays, or ``{"error": (type name, message)}``. This module imports
neither heat_tpu nor jax (pytest does not collect it).
"""

import contextlib
import importlib
import os
import pickle
import traceback

import numpy as np

_OUT = {}  # "dir": the world's shared directory, where the I/O cases write their files


# linear algebra and the distributed hSVD (tests/test_torch_hsvd_dist.py)
MATMUL_SHAPES = {"ragged": ((13, 7), (7, 5)), "even": ((16, 12), (12, 8)), "wide": ((6, 40), (40, 3)),
                 "small_a": ((3, 20), (20, 30)), "thin_k": ((24, 2), (2, 40))}
# the other functions of linalg/basics.py on split operands: (name, call on
# either package given x (7, 6), v (9,), w (9,) and c (6, 3) of one split)
BASICS = {
    "tril": lambda lib, x, v, w, c: lib.tril(x, 1), "triu": lambda lib, x, v, w, c: lib.triu(x, -2),
    "tril_vector": lambda lib, x, v, w, c: lib.tril(v, 0), "trace": lambda lib, x, v, w, c: lib.trace(x, offset=1),
    "transpose": lambda lib, x, v, w, c: x.T, "norm": lambda lib, x, v, w, c: lib.norm(x),
    "vector_norm_0": lambda lib, x, v, w, c: lib.vector_norm(x, axis=0),
    "vector_norm_1_inf": lambda lib, x, v, w, c: lib.vector_norm(x, axis=1, ord=float("inf")),
    "vector_norm_min": lambda lib, x, v, w, c: lib.vector_norm(x, ord=-float("inf")),
    "matrix_norm_1": lambda lib, x, v, w, c: lib.matrix_norm(x, ord=1),
    "inv": lambda lib, x, v, w, c: lib.inv(lib.matmul(x.T, x)),
    "det": lambda lib, x, v, w, c: lib.det(lib.matmul(x.T, x)),
    "dot": lambda lib, x, v, w, c: lib.dot(v, w), "vdot": lambda lib, x, v, w, c: lib.vdot(x, x),
    "outer": lambda lib, x, v, w, c: lib.outer(v, w), "projection": lambda lib, x, v, w, c: lib.projection(v, w),
    "vecdot_0": lambda lib, x, v, w, c: lib.vecdot(x, x, axis=0),
    "vecdot_1": lambda lib, x, v, w, c: lib.vecdot(x, x, axis=1, keepdims=True),
    "cross": lambda lib, x, v, w, c: lib.cross(c, lib.tril(c, 1)),
}


def basics_operands(lib, split, **kw):
    """x (7, 6), v and w (9,), c (6, 3) for BASICS, split like ``split``
    (vectors split 0 where ``split`` is not None)."""
    vs = None if split is None else 0
    return (lib.array(_array((7, 6), "float32", 51), split=split, **kw),
            lib.array(_array((9,), "float32", 52), split=vs, **kw),
            lib.array(_array((9,), "float32", 53), split=vs, **kw),
            lib.array(_array((6, 3), "float32", 54), split=split, **kw))
QR_SHAPES = {"tall": (50, 7), "short_last": (9, 3), "ragged_rows": (61, 16)}
HSVD_SHAPE = (995, 256)  # split 0 (and its transpose split 1): blocks of 249 rows, the last 248
HSVD_BOUNDARY = (397, 128)  # blocks of 100 (sketch: 4 l = 100 ≤ 100), the last 97 (alone it would take the full SVD)
HSVD_CALLS = ("rank", "rank_one_view", "rtol", "hsvd")
RANK8_SIGMA = np.arange(8, 0, -1.0)


def rank8(shape, seed=1):
    """An exactly rank-8 float32 matrix with σ = 8, 7, ..., 1."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((shape[0], 8)))
    v, _ = np.linalg.qr(rng.standard_normal((shape[1], 8)))
    return ((u * RANK8_SIGMA) @ v.T).astype(np.float32)


def hsvd_call(lib, x, call: str, compute_sv: bool):
    """One of HSVD_CALLS on either package."""
    if call == "rank":
        return lib.linalg.hsvd_rank(x, 10, compute_sv=compute_sv)
    if call == "rank_one_view":
        return lib.linalg.hsvd_rank(x, 10, compute_sv=compute_sv, single_pass=True)
    if call == "rtol":
        return lib.linalg.hsvd_rtol(x, 0.01, compute_sv=compute_sv)
    return lib.linalg.hsvd(x, maxrank=10, compute_sv=compute_sv)


ATTENTION_SHAPE = (2, 3, 37, 8)  # (B, H, S, D): a ragged S over 4 ranks
ATTENTION_UNSPLIT_Q = ((False, 2, 2), (True, 2, 2), (True, None, 2))  # (causal, k's split, v's split)


def _np(t):
    """numpy of a tensor (bfloat16 widened to float32, which is exact)."""
    import torch

    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _array(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if dtype == "bool":
        return a > 0
    if "int" in dtype:
        return (a * 1000).astype(dtype)
    if "complex" in dtype:
        return (a + 1j * rng.standard_normal(shape)).astype(dtype)
    return a.astype("float32" if dtype == "bfloat16" else dtype)


def _moved(ht, x, call):
    """Run ``call()`` (a redistribution of ``x``) and record the shard, the
    global array, the collectives issued and the plan's census."""
    comm = ht.get_comm()
    comm.counts.clear()
    y = call()
    counts = dict(comm.counts)
    return {"local": _np(y.larray), "lshape": y.lshape, "split": y.split, "gshape": y.gshape,
            "counts": counts, "global": y.numpy(), "dtype": y.dtype.__name__}


def _cases(ht):
    import torch

    from heat_tpu_torch.redistribution import planner

    comm = ht.get_comm()
    cases = {}

    cases["world"] = lambda: {"rank": comm.rank, "size": comm.size, "distributed": comm.is_distributed()}
    cases["seed_unseeded"] = lambda: _unseeded_draw(ht)

    for n in (1000, 1003):
        for dt in ("int32", "float32"):
            def sum_case(n=n, dt=dt):
                x = ht.arange(n, dtype=getattr(ht, dt), split=0)
                comm.counts.clear()
                s = x.sum()
                return {"value": s.item(), "dtype": s.dtype.__name__, "split": s.split, "lshape": x.lshape,
                        "counts": dict(comm.counts), "local_sum": float(x.larray.double().sum())}
            cases[f"sum_arange_{n}_{dt}"] = sum_case
    for axis, keep in ((0, False), (1, False), (1, True), (None, False)):
        def sum_axis(axis=axis, keep=keep):
            x = ht.array(np.arange(7 * 5, dtype=np.int64).reshape(7, 5), split=0)
            s = x.sum(axis=axis, keepdims=keep)
            return {"local": _np(s.larray), "global": s.numpy(), "split": s.split, "gshape": s.gshape,
                    "dtype": s.dtype.__name__}
        cases[f"sum_axis_{axis}_{keep}"] = sum_axis
    cases["sum_bool_split1"] = lambda: {"value": ht.array(np.eye(6, 9, dtype=bool), split=1).sum().item()}

    shapes = {"2d_even": (8, 12), "2d_ragged": (7, 5), "3d_even": (8, 4, 6), "3d_ragged": (5, 7, 3)}
    for label, shape in shapes.items():
        for src in (None, 0, 1):
            for dst in (None, 0, 1):
                if src == dst:
                    continue

                def resplit_case(shape=shape, src=src, dst=dst, seed=len(shape) * 10 + shape[0]):
                    x = ht.array(_array(shape, "float32", seed), split=src)
                    out = _moved(ht, x, lambda: x.resplit(dst))
                    out["plan"] = planner.explain(x, dst).collective_counts()
                    return out
                cases[f"resplit_{label}_{src}_{dst}"] = resplit_case
    for dt in ("int64", "bool", "complex64", "bfloat16", "float64"):
        def dtype_case(dt=dt):
            x = ht.array(_array((7, 5), dt, 3), split=0, dtype=getattr(ht, dt))
            out = _moved(ht, x, lambda: x.resplit(1))
            out["plan"] = planner.explain(x, 1).collective_counts()
            return out
        cases[f"resplit_dtype_{dt}"] = dtype_case

    def in_place():
        x = ht.array(_array((7, 5), "float32", 4), split=1)
        return _moved(ht, x, lambda: x.resplit_(0))
    cases["resplit_in_place"] = in_place

    def budget_case(shape):
        def case():
            os.environ["HEAT_TPU_REDIST_BUDGET_MB"] = "1"
            try:
                x = ht.array(_array(shape, "float32", 5), split=0)
                sched = planner.explain(x, 1)
                out = _moved(ht, x, lambda: x.resplit(1))
            finally:
                del os.environ["HEAT_TPU_REDIST_BUDGET_MB"]
            out.update(plan=sched.collective_counts(), strategy=sched.strategy)
            return out
        return case
    cases["resplit_chunked"] = budget_case((1024, 1024))
    cases["resplit_ring"] = budget_case((4, 262144))

    reshapes = {
        "local": ((64, 48), 0, (32, 96), 0, "float32"),
        "pivot": ((64, 48), 0, (96, 32), 1, "float32"),
        "pivot_in": ((64, 48), 1, (96, 32), 0, "float32"),
        "packed": ((2048, 64), 1, (8192, 16), 1, "float32"),
        "packed_rev": ((8192, 16), 1, (2048, 64), 1, "float32"),
        "packed_bf16": ((2048, 64), 1, (8192, 16), 1, "bfloat16"),
        "gather": ((1000, 26), 1, (26, 1000), 1, "float32"),
        "replicated": ((64, 48), None, (96, 32), 1, "float32"),
        "ragged_3d": ((6, 5, 4), 2, (5, 6, 4), 1, "int32"),
    }
    for label, (shape, src, out_shape, dst, dt) in reshapes.items():
        def reshape_case(shape=shape, src=src, out_shape=out_shape, dst=dst, dt=dt):
            x = ht.array(_array(shape, dt, shape[0]), split=src, dtype=getattr(ht, dt))
            sched = planner.explain(x, reshape=out_shape, new_split=dst)
            out = _moved(ht, x, lambda: ht.reshape(x, out_shape, new_split=dst))
            out.update(plan=sched.collective_counts(), strategy=sched.strategy,
                       packs=[st.kind for st in sched.steps if st.kind in ("pack", "unpack")])
            return out
        cases[f"reshape_{label}"] = reshape_case

    def layout():
        x = ht.array(_array((10, 3), "float32", 6), split=0)
        y = ht.array(_array((3, 10), "float32", 7), split=1)
        return {"x_map": x.lshape_map, "x_cd": x.counts_displs(), "x_global": x.numpy(), "x_local": _np(x.larray),
                "y_map": y.lshape_map, "y_cd": y.counts_displs(), "y_global": y.numpy(),
                "balanced": (x.is_balanced(), y.is_balanced())}
    cases["layout"] = layout

    def redistribute():
        x = ht.array(_array((10, 3), "float32", 6), split=0)
        target = np.array([[1, 3], [2, 3], [3, 3], [4, 3]])
        x.redistribute_(target_map=target)
        moved = {"lshape": x.lshape, "map": x.lshape_map, "balanced": x.is_balanced(), "global": x.numpy(),
                 "cd": x.counts_displs()}
        r = x.resplit(1)
        x.balance_()
        return {**moved, "resplit_local": _np(r.larray), "after_balance": (x.lshape, x.is_balanced()),
                "sum": x.sum(axis=1).numpy()}
    cases["redistribute"] = redistribute

    def larray_setter():
        y = ht.zeros((8, 3), split=0)
        y.larray = torch.full((comm.rank + 1, 3), float(comm.rank))
        z = ht.array(np.full((comm.rank + 1, 2), comm.rank), is_split=0)
        return {"gshape": y.gshape, "map": y.lshape_map, "global": y.numpy(), "z_gshape": z.gshape,
                "z_global": z.numpy(), "balanced": y.is_balanced()}
    cases["larray_setter"] = larray_setter

    def factories():
        return {
            "eye": _np(ht.eye((7, 5), split=0).larray), "eye1": _np(ht.eye((7, 5), split=1).larray),
            "zeros": ht.zeros((5, 3), split=1).lshape, "randn_same": ht.random.randn(9, 4, split=0).numpy(),
            "arange": _np(ht.arange(3, 20, 2, split=0).larray),
        }
    cases["factories"] = factories

    def interop():
        from heat_tpu_torch.core import interop

        x = interop.from_numpy(_array((9, 4), "float64", 9), split=0)
        return {"local": _np(x.larray), "dtype": x.dtype.__name__, "gshape": x.gshape}
    cases["interop"] = interop

    # entry points of slices 1-5 on a split operand
    def split_x(shape=(40, 6), split=0):
        return ht.array(_array(shape, "float32", 8), split=split)

    entry = {
        "sparse_csr_split": lambda: ht.sparse.sparse_csr_matrix(np.eye(8, dtype=np.float32), split=0).todense(),
        "sparse_dbcsr_split": lambda: ht.sparse.sparse_dbcsr_matrix(np.eye(8, dtype=np.float32), split=0).todense(),
        "sparse_matmul_split_x": lambda: ht.sparse.matmul(
            ht.sparse.sparse_csr_matrix(np.eye(40, dtype=np.float32)), split_x()),
        "sddmm_split_u": lambda: ht.sparse.sddmm(
            ht.sparse.sparse_dbcsr_matrix(np.eye(40, 6, dtype=np.float32)), split_x((40, 4)),
            split_x((6, 4), None)).todense(),
        "pagerank": lambda: ht.graph.pagerank(np.ones((8, 8), dtype=np.float32)).ranks,
    }
    for name, call in entry.items():
        def entry_case(call=call):
            out = call()
            return {"local": _np(out.larray), "global": out.numpy(), "split": out.split, "gshape": out.gshape}
        cases[f"entry_{name}"] = entry_case

    # ring_attention with a whole q and a split k/v: heat_tpu's single-device
    # route at any world size (its nn/attention.py:817)
    for causal, k_split, v_split in ATTENTION_UNSPLIT_Q:
        def attention_case(causal=causal, k_split=k_split, v_split=v_split):
            q, k, v = (ht.array(_array(ATTENTION_SHAPE, "float32", seed), split=split)
                       for seed, split in ((31, None), (32, k_split), (33, v_split)))
            out = ht.nn.ring_attention(q, k, v, causal=causal)
            return {"local": _np(out.larray), "split": out.split, "gshape": out.gshape, "global": out.numpy(),
                    "k_split": k.split, "v_split": v.split}
        cases[f"attention_unsplit_q_{causal}_{k_split}_{v_split}"] = attention_case

    def served():
        x = split_x((12, 8), 0)
        v, i = ht.sort(x, axis=1)
        tv, ti = ht.topk(x, 3, dim=1)
        f = ht.flip(x, 1)
        m = ht.moveaxis(split_x((4, 6, 5), 1), 1, 2)
        return {"sort": (_np(v.larray), _np(i.larray), v.gshape, v.split), "topk": (_np(tv.larray), _np(ti.larray)),
                "flip": _np(f.larray), "moveaxis": (_np(m.larray), m.gshape, m.split), "sort_global": v.numpy()}
    cases["entry_served"] = served
    cases.update(_linalg_cases(ht))
    cases.update(_ring_cases(ht))
    cases.update(_sort_cases(ht))
    cases.update(_random_cases(ht))
    cases.update(_surface_cases(ht))
    cases.update(_indexing_cases(ht))
    cases.update(_train_cases(ht))
    cases.update(_kmedians_cases(ht))
    cases.update(_manip_cases(ht))
    cases.update(_halo_cases(ht))
    cases.update(_fact_cases(ht))
    cases.update(_estimator_cases(ht))
    cases.update(_sparse_cases(ht))
    cases.update(_staging_cases(ht))
    cases.update(_io_cases(ht))
    cases.update(_wire_cases(ht))
    return cases


def _linalg_cases(ht):
    """matmul over split pairs, TSQR, QR and the distributed hSVD."""
    import importlib
    from unittest import mock

    import torch

    comm = ht.get_comm()
    psvd = importlib.import_module("heat_tpu_torch.core.linalg.svdtools")
    pqr = importlib.import_module("heat_tpu_torch.core.linalg.qr")
    cases = {}

    def arr(x):
        return {"local": _np(x.larray), "split": x.split, "gshape": x.gshape, "global": x.numpy(),
                "dtype": x.dtype.__name__}

    for label, (sa_shape, sb_shape) in MATMUL_SHAPES.items():
        for sa in (None, 0, 1):
            for sb in (None, 0, 1):
                def matmul_case(sa_shape=sa_shape, sb_shape=sb_shape, sa=sa, sb=sb):
                    a = ht.array(_array(sa_shape, "float32", 41), split=sa)
                    b = ht.array(_array(sb_shape, "float32", 42), split=sb)
                    comm.counts.clear()
                    c = ht.matmul(a, b)
                    counts = dict(comm.counts)
                    return {**arr(c), "counts": counts}
                cases[f"matmul_{label}_{sa}_{sb}"] = matmul_case

    for name, fn in BASICS.items():
        for split in (None, 0, 1):
            def basics_case(fn=fn, split=split):
                return arr(fn(ht, *basics_operands(ht, split)))
            cases[f"basics_{name}_{split}"] = basics_case

    for label, shape in QR_SHAPES.items():
        for s in (1, 2):
            def tsqr_case(shape=shape, s=s):
                x = ht.array(_array(shape, "float32", 43), split=0)
                block = -(-shape[0] // comm.size)
                comm.counts.clear()
                q, r = pqr._tsqr_local(comm, x.larray, block, True, s)
                counts = dict(comm.counts)
                _, r_only = pqr._tsqr_local(comm, x.larray, block, False, s)
                q_arr = ht.DNDarray(q, (shape[0], q.shape[1]), ht.float32, 0, x.device, comm)
                return {"q": arr(q_arr), "r": _np(r), "r_only": _np(r_only), "counts": counts}
            cases[f"tsqr_{label}_{s}"] = tsqr_case
        for split in (None, 0, 1):
            def qr_case(shape=shape, split=split):
                q, r = ht.linalg.qr(ht.array(_array(shape, "float32", 43), split=split))
                return {"q": arr(q), "r": arr(r)}
            cases[f"qr_{label}_{split}"] = qr_case

    seen = []

    def recording(fn):
        def wrapped(s_loc, transposed, rloc, lcols, sketch_l, one_view, *args, **kw):
            seen.append({"rows": int(s_loc.shape[0]), "cols": int(s_loc.shape[1]), "rloc": rloc, "lcols": lcols,
                         "sketch_l": sketch_l, "one_view": one_view})
            return fn(s_loc, transposed, rloc, lcols, sketch_l, one_view, *args, **kw)
        return wrapped

    for split in (0, 1):
        a = rank8(HSVD_SHAPE) if split == 0 else rank8(HSVD_SHAPE).T.copy()
        for call in HSVD_CALLS:
            for compute_sv in (True, False):
                def hsvd_case(a=a, split=split, call=call, compute_sv=compute_sv):
                    seen.clear()
                    with mock.patch.object(psvd, "_level0", recording(psvd._level0)):
                        out = hsvd_call(ht, ht.array(a, split=split), call, compute_sv)
                    res = {"U": arr(out[0]), "err": float(out[-1]), "err_dtype": out[-1].dtype.__name__,
                           "err_split": out[-1].split, "level0": list(seen)}
                    if compute_sv:
                        res.update(sigma=arr(out[1]), V=arr(out[2]))
                    return res
                cases[f"hsvd_{split}_{call}_{compute_sv}"] = hsvd_case

    def boundary():
        seen.clear()
        with mock.patch.object(psvd, "_level0", recording(psvd._level0)):
            U, s, V, err = ht.linalg.hsvd_rank(ht.array(rank8(HSVD_BOUNDARY), split=0), 10, compute_sv=True)
        return {"level0": list(seen), "sigma": _np(s.larray), "U": arr(U), "V": arr(V)}
    cases["hsvd_boundary"] = boundary

    def refine():
        # a split-0 near-orthonormal matrix: the refine with the Gram
        # allreduced against the refine of the whole matrix on one rank
        rng = np.random.default_rng(44)
        q, _ = np.linalg.qr(rng.standard_normal((37, 5)))
        v = (q + 1e-3 * rng.standard_normal((37, 5))).astype(np.float32)
        mine = torch.from_numpy(v[comm.chunk((37, 5), 0)[2]].copy())
        together = psvd._cholqr2_refine(mine, comm)
        alone = psvd._cholqr2_refine(mine, None)
        whole = psvd._cholqr2_refine(torch.from_numpy(v), None)
        gather = comm.allgather
        return {"together": _np(gather(together, 0, comm.lshape_map((37, 5), 0)[:, 0])),
                "alone": _np(gather(alone, 0, comm.lshape_map((37, 5), 0)[:, 0])), "whole": _np(whole)}
    cases["refine"] = refine
    return cases


# out-of-core staging across ranks (tests/test_torch_staging.py)
def decaying_128(m: int, n: int, seed: int = 0) -> np.ndarray:
    """float32 (m, n) with σ_i = 2^{-i/2} for its first 128 values (the rest
    would lie below float32's resolution of σ_0), in memory that torch
    allocated: on 64 bytes, as a DNDarray's copy of it is (MKL's float32
    products may round otherwise on operands aligned otherwise)."""
    import torch

    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, 128)))
    v, _ = np.linalg.qr(rng.standard_normal((n, 128)))
    out = torch.empty((m, n), dtype=torch.float32).numpy()
    out[...] = (u * 2.0 ** (-np.arange(128) / 2)) @ v.T
    return out


def staged_operand():
    """``decaying_128(1300, 1100)``: three windows a pass at a 1 MiB slab."""
    return decaying_128(1300, 1100)


def _staging_cases(ht):
    from heat_tpu_torch.redistribution import staging

    cases = {}
    for single_pass in (False, True):
        def staged_hsvd(single_pass=single_pass):
            os.environ["HEAT_TPU_OOC_SLAB_MB"] = "1"
            try:
                out = ht.linalg.hsvd_rank(staging.HostArray(staged_operand()), 10, compute_sv=True,
                                          single_pass=single_pass)
            finally:
                del os.environ["HEAT_TPU_OOC_SLAB_MB"]
            return {"factors": [_np(t.larray) for t in out], "splits": [t.split for t in out]}
        cases[f"staged_hsvd_{single_pass}"] = staged_hsvd
    return cases


# KMeans, the distance ring and ring attention across ranks (tests/test_torch_ring.py)
KM_ROWS = {"ragged": 37, "last_empty": 9}  # over 4 ranks: 10, 10, 10, 7 and 3, 3, 3, 0 rows
KM_K, KM_D = 3, 4
KM_SEEDED = ("kmeans++", "random")
DIST_X, DIST_Y = (9, 5), (10, 5)  # X's last rank holds no row, Y's holds one
DIST_CALLS = {
    "cdist": lambda lib, X, Y, ring: lib.spatial.cdist(X, Y, ring=ring),
    "cdist_quadratic": lambda lib, X, Y, ring: lib.spatial.cdist(X, Y, quadratic_expansion=True, ring=ring),
    "manhattan": lambda lib, X, Y, ring: lib.spatial.manhattan(X, Y, ring=ring),
    "rbf": lambda lib, X, Y, ring: lib.spatial.rbf(X, Y, sigma=1.5, ring=ring),
    "rbf_quadratic": lambda lib, X, Y, ring: lib.spatial.rbf(X, Y, sigma=1.5, quadratic_expansion=True, ring=ring),
}
DIST_X_SPLITS = (0, None, 1)
DIST_Y_KINDS = ("self", "whole", "split0", "split1")  # "self": Y=None, X against itself
ATT_SHAPES = {"even": (16, 16), "ragged": (10, 10), "cross": (12, 20)}  # (S_q, S_kv) at (2, 3, S, 8)
ATT_BF16 = ("even", "ragged")
# the ring's backward: ATT_SHAPES and 9 rows over 4 ranks, the last rank empty
ATT_GRAD_SHAPES = {**ATT_SHAPES, "last_empty": (9, 9)}
ATT_GRAD_KINDS = ("split", "whole_kv", "whole_q")  # q, k and v split; k and v whole; q whole, k and v split


def att_grad_operands(lib, label, kind, dtype="float32", **kw):
    """q, k, v (2, 3, S, 8) of ATT_GRAD_SHAPES[label] split as ``kind`` says,
    and the target tgt (2, 3, S_q, 8) of the loss sum((o − tgt)²), numpy."""
    s_q, s_kv = ATT_GRAD_SHAPES[label]
    q, k, v, tgt = (_array((2, 3, s, 8), dtype, seed) for s, seed in ((s_q, 84), (s_kv, 85), (s_kv, 86), (s_q, 87)))
    q_split, kv_split = (None, 2) if kind == "whole_q" else (2, None if kind == "whole_kv" else 2)
    return tuple(lib.array(a, split=split, **kw) for a, split in ((q, q_split), (k, kv_split), (v, kv_split))), tgt


def km_blobs(n: int, seed: int = 61) -> np.ndarray:
    """n float32 points in KM_D dimensions, row i in blob i % KM_K; the
    blobs' centers lie 20 apart, each point within a few units of its own."""
    rng = np.random.default_rng(seed)
    centers = 20.0 * np.eye(KM_K, KM_D)
    return (centers[np.arange(n) % KM_K] + rng.standard_normal((n, KM_D))).astype(np.float32)


def dist_operands(lib, x_split, y_kind, dtype="float32", **kw):
    """X (DIST_X) and Y (DIST_Y, or None for "self") on either package."""
    X = lib.array(_array(DIST_X, dtype, 71), split=x_split, **kw)
    if y_kind == "self":
        return X, None
    return X, lib.array(_array(DIST_Y, dtype, 72), split={"whole": None, "split0": 0, "split1": 1}[y_kind], **kw)


def att_operands(lib, label, dtype="float32", kv_split=2, **kw):
    """q, k and v (2, 3, S, 8) of ATT_SHAPES[label], q split along S."""
    s_q, s_kv = ATT_SHAPES[label]
    q, k, v = (_array((2, 3, s, 8), "float32", seed) for s, seed in ((s_q, 81), (s_kv, 82), (s_kv, 83)))
    return tuple(lib.array(a, split=split, dtype=getattr(lib, dtype), **kw)
                 for a, split in ((q, 2), (k, kv_split), (v, kv_split)))


def _unseeded_draw(ht):
    """The first draw of a process: an unseeded split randn."""
    import importlib

    rmod = importlib.import_module("heat_tpu_torch.core.random")
    was_unseeded = getattr(rmod, "__seed") is None
    x = ht.random.randn(40, split=0)
    return {"unseeded": was_unseeded, "state": ht.random.get_state(), "local": _np(x.larray), "global": x.numpy()}


def _ring_cases(ht):
    import torch

    comm = ht.get_comm()
    cases = {}

    def arr(x):
        return {"local": _np(x.larray), "split": x.split, "gshape": x.gshape, "global": x.numpy()}

    def every_rank(t):
        return _np(comm.allgather(t[None]))

    def fitted(km):
        c = km.cluster_centers_.larray
        return {"centers": _np(c), "every": every_rank(c), "n_iter": km.n_iter_, "inertia": km.inertia_,
                "labels": arr(km.labels_)}

    for label, n in KM_ROWS.items():
        data = km_blobs(n)
        for init_split in (None, 0):
            def km_fit(data=data, init_split=init_split):
                init = ht.array(data[:KM_K], split=init_split)
                comm.counts.clear()
                km = ht.cluster.KMeans(KM_K, init=init).fit(ht.array(data, split=0))
                counts = dict(comm.counts)
                return {**fitted(km), "counts": counts}
            cases[f"km_fit_{label}_{init_split}"] = km_fit

        def km_predict(data=data, n=n):
            km = ht.cluster.KMeans(KM_K, init=ht.array(data[:KM_K])).fit(ht.array(data))
            return arr(km.predict(ht.array(km_blobs(n, seed=62), split=0)))
        cases[f"km_predict_{label}"] = km_predict

        def km_partial(data=data, n=n):
            km = ht.cluster.KMeans(KM_K, init=ht.array(data[:KM_K]))
            out = []
            for batch in (data, km_blobs(n, seed=63)):
                km.partial_fit(ht.array(batch, split=0))
                out.append({"centers": _np(km.cluster_centers_.larray), "inertia": km.inertia_})
            return {"batches": out, "every": every_rank(km.cluster_centers_.larray)}
        cases[f"km_partial_{label}"] = km_partial

        def km_update(data=data, n=n):
            km = ht.cluster.KMeans(KM_K, init=ht.array(data[:KM_K]))
            km._initialize_cluster_centers(ht.array(data))
            labels = ht.array(np.arange(n) % KM_K, split=0)
            return {"centers": _np(km._update_centroids(ht.array(data, split=0), labels).larray)}
        cases[f"km_update_{label}"] = km_update

        for init in KM_SEEDED:
            def km_seeded(data=data, init=init):
                return fitted(ht.cluster.KMeans(KM_K, init=init, random_state=5).fit(ht.array(data, split=0)))
            cases[f"km_seeded_{label}_{init}"] = km_seeded

    for name, call in DIST_CALLS.items():
        for x_split in DIST_X_SPLITS:
            for y_kind in DIST_Y_KINDS:
                for ring in (False, True):
                    def dist_case(call=call, x_split=x_split, y_kind=y_kind, ring=ring):
                        X, Y = dist_operands(ht, x_split, y_kind)
                        comm.counts.clear()
                        out = call(ht, X, Y, ring)
                        counts = dict(comm.counts)
                        return {**arr(out), "counts": counts, "dtype": out.dtype.__name__}
                    cases[f"dist_{name}_{x_split}_{y_kind}_{ring}"] = dist_case
    for y_kind in ("self", "split0"):
        for ring in (False, True):
            def dist_f64(y_kind=y_kind, ring=ring):
                X, Y = dist_operands(ht, 0, y_kind, "float64")
                out = ht.spatial.cdist(X, Y, ring=ring)
                return {**arr(out), "dtype": out.dtype.__name__}
            cases[f"dist_f64_{y_kind}_{ring}"] = dist_f64

    for label in ATT_SHAPES:
        for causal in (False, True):
            def att_case(label=label, causal=causal):
                q, k, v = att_operands(ht, label)
                comm.counts.clear()
                out = ht.nn.ring_attention(q, k, v, causal=causal)
                counts = dict(comm.counts)
                return {**arr(out), "counts": counts}
            cases[f"att_{label}_{causal}"] = att_case

            def att_whole_kv(label=label, causal=causal):
                return arr(ht.nn.ring_attention(*att_operands(ht, label, kv_split=None), causal=causal))
            cases[f"att_whole_kv_{label}_{causal}"] = att_whole_kv
    for label in ATT_BF16:
        for causal in (False, True):
            def att_bf16(label=label, causal=causal):
                out = ht.nn.ring_attention(*att_operands(ht, label, "bfloat16"), causal=causal)
                return {**arr(out), "dtype": out.dtype.__name__}
            cases[f"att_bf16_{label}_{causal}"] = att_bf16

    for label in ATT_GRAD_SHAPES:
        for kind in ATT_GRAD_KINDS:
            for dtype in ("float32", "float64"):
                for causal in (False, True):
                    def att_grad(label=label, kind=kind, dtype=dtype, causal=causal):
                        (q, k, v), tgt = att_grad_operands(ht, label, kind, dtype)
                        for t in (q, k, v):
                            t.larray.requires_grad_()
                        out = ht.nn.ring_attention(q, k, v, causal=causal)
                        tgt = torch.from_numpy(tgt)
                        if out.split is not None:
                            off = out.counts_displs()[1][comm.rank]
                            tgt = tgt[..., off : off + out.lshape[2], :]
                        comm.counts.clear()
                        ((out.larray - tgt) ** 2).sum().backward()
                        counts = dict(comm.counts)
                        return {"grads": [_np(t.larray.grad) for t in (q, k, v)], "counts": counts}
                    cases[f"att_grad_{label}_{kind}_{dtype}_{causal}"] = att_grad
    return cases


# the distributed sort family (tests/test_torch_sort_dist.py): over 4 ranks
# 5 leaves the last rank empty, 37 and 40 take the odd-even network, 95 and
# 1021 columnsort with pads at the tail, 96 and 1024 columnsort without
SORT_NS = (5, 37, 40, 95, 96, 1024, 1021)
SORT_DTYPES = ("float32", "int32", "float64", "int64", "bool", "complex64")
SORT_2D = ((37, 3), (96, 5))  # split 0, sorted along 0: batch lanes
VALUES_NS = (37, 96, 1021)  # the values-only programs: odd-even, columnsort
TOPK = ((37, 0), (37, 3), (37, 15), (1021, 5), (1021, 300))  # (n, k): k <= B and k > B
TOPK_DTYPES = ("float32", "int32", "float64", "negnan")
UNIQUE_FLAT = (((5,), 0, "float32"), ((37,), 0, "float32"), ((1021,), 0, "float32"), ((96,), 0, "int32"),
               ((40,), 0, "bool"), ((37,), 0, "float64"), ((37,), 0, "complex64"), ((13, 3), 0, "float32"),
               ((7, 9), 1, "int32"))  # (shape, split, dtype)
UNIQUE_AXIS = (((37, 3), 0, 0, "int32"), ((96, 2), 0, 0, "float32"), ((5, 40), 1, 1, "float32"),
               ((40, 3), 0, 1, "int64"), ((9, 2, 3), 0, 0, "bool"), ((9, 300), 0, 0, "float32"),
               ((13, 2), 0, 0, "complex64"))  # (shape, split, axis, dtype); (9, 300) and complex are gathered
UNIQUE_COMPLEX_NAN = (37, 1021)  # flat unique of complex with NaN parts, split 0, against jnp.unique
FLIPS = (((5,), 0, 0), ((37,), 0, 0), ((40,), 0, None), ((7, 5), 0, 0), ((7, 5), 0, None), ((5, 9), 1, 1),
         ((6, 4, 5), 2, (0, 2)))  # (shape, split, axis)


def sort_data(shape, dtype: str, seed: int) -> np.ndarray:
    """Sort inputs with heavy duplicates: float32 also with NaN, ±0 and ±inf
    ("negnan": NaNs with the sign bit set as well), integers with their
    type-max, complex with ties in the real part."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if dtype == "bool":
        return (rng.random(n) < 0.5).reshape(shape)
    if dtype == "complex64":
        return (rng.integers(-3, 3, n) + 1j * rng.integers(-3, 3, n)).astype(np.complex64).reshape(shape)
    base = rng.integers(-5, 5, n)
    if dtype in ("int32", "int64"):
        x = base.astype(dtype)
        x[rng.random(n) < 0.1] = np.iinfo(dtype).max
        return x.reshape(shape)
    x = (base / 2).astype("float32" if dtype == "negnan" else dtype)
    specials = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf], x.dtype)
    pick = rng.random(n) < 0.2
    x[pick] = specials[rng.integers(0, len(specials), int(pick.sum()))]
    if dtype == "negnan":
        x[rng.random(n) < 0.3] = -np.float32(np.nan)
    return x.reshape(shape)


def complex_nan_data(n: int, seed: int) -> np.ndarray:
    """complex64 with ties, a third of it NaN in the real part, the
    imaginary part or both."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-2, 2, n) + 1j * rng.integers(-2, 2, n)).astype(np.complex64)
    pick = np.nonzero(rng.random(n) < 0.3)[0]
    kind = rng.integers(0, 3, len(pick))
    x.real[pick[kind != 1]] = np.nan
    x.imag[pick[kind != 0]] = np.nan
    return x


def _sort_cases(ht):
    import torch

    from heat_tpu_torch.core import parallel

    comm = ht.get_comm()
    cases = {}

    def arr(x):
        return {"local": _np(x.larray), "split": x.split, "gshape": x.gshape, "global": x.numpy(),
                "dtype": x.dtype.__name__}

    def counted(call):
        comm.counts.clear()
        out = call()
        return out, dict(comm.counts)

    for n in SORT_NS:
        for dt in SORT_DTYPES:
            for descending in (False, True):
                def sort_case(n=n, dt=dt, descending=descending):
                    x = ht.array(sort_data((n,), dt, n), split=0)
                    (v, i), counts = counted(lambda: ht.sort(x, descending=descending))
                    return {"v": arr(v), "i": arr(i), "counts": counts}
                cases[f"sort_{n}_{dt}_{descending}"] = sort_case
    for shape in SORT_2D:
        for dt in ("float32", "int32"):
            def sort_2d(shape=shape, dt=dt):
                v, i = ht.sort(ht.array(sort_data(shape, dt, shape[0]), split=0), axis=0)
                return {"v": arr(v), "i": arr(i)}
            cases[f"sort2d_{shape[0]}_{dt}"] = sort_2d
    for n in VALUES_NS:
        def values_case(n=n):
            B = -(-n // comm.size)
            x = ht.array(sort_data((n,), "float32", n), split=0)
            padded = torch.cat([x.larray, torch.full((B - x.lshape[0],), float("nan"))])
            out, counts = counted(lambda: parallel.distributed_sort(padded, comm, 0, with_indices=False))
            return {"block": _np(out), "counts": counts}
        cases[f"sort_values_{n}"] = values_case
    for n, k in TOPK:
        for dt in TOPK_DTYPES:
            for largest in (True, False):
                def topk_case(n=n, k=k, dt=dt, largest=largest):
                    x = ht.array(sort_data((n,), dt, n + k), split=0)
                    (v, i), counts = counted(lambda: ht.topk(x, k, largest=largest))
                    return {"v": arr(v), "i": arr(i), "counts": counts}
                cases[f"topk_{n}_{k}_{dt}_{largest}"] = topk_case

    def topk_2d():
        v, i = ht.topk(ht.array(sort_data((37, 3), "float32", 7), split=0), 4, dim=0)
        return {"v": arr(v), "i": arr(i)}
    cases["topk_2d"] = topk_2d
    for shape, split, dt in UNIQUE_FLAT:
        def unique_flat(shape=shape, split=split, dt=dt):
            x = ht.array(sort_data(shape, dt, shape[0]), split=split)
            (u, inv), counts = counted(lambda: ht.unique(x, return_inverse=True))
            return {"u": arr(u), "inv": arr(inv), "counts": counts, "plain": arr(ht.unique(x))}
        cases[f"unique_{'x'.join(map(str, shape))}_{split}_{dt}"] = unique_flat
    for n in UNIQUE_COMPLEX_NAN:
        def unique_complex_nan(n=n):
            u, inv = ht.unique(ht.array(complex_nan_data(n, n), split=0), return_inverse=True)
            return {"u": arr(u), "inv": arr(inv)}
        cases[f"unique_complex_nan_{n}"] = unique_complex_nan
    for shape, split, axis, dt in UNIQUE_AXIS:
        def unique_axis(shape=shape, split=split, axis=axis, dt=dt):
            data = sort_data(shape, dt, shape[0])
            if dt == "int32":
                data = data % 3  # few distinct rows
            x = ht.array(data, split=split)
            (u, inv), counts = counted(lambda: ht.unique(x, return_inverse=True, axis=axis))
            return {"u": arr(u), "inv": arr(inv), "counts": counts}
        cases[f"unique_axis_{'x'.join(map(str, shape))}_{split}_{axis}_{dt}"] = unique_axis
    for shape, split, axis in FLIPS:
        def flip_case(shape=shape, split=split, axis=axis):
            x = ht.array(np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape), split=split)
            out, counts = counted(lambda: ht.flip(x, axis))
            return {**arr(out), "counts": counts}
        cases[f"flip_{'x'.join(map(str, shape))}_{split}_{axis}"] = flip_case

    def permute_case():
        t = torch.full((3,), float(comm.rank + 1))
        p = comm.size
        out, counts = counted(lambda: [_np(comm.permute(t, pairs)) for pairs in (
            [(i, i + 1) for i in range(p - 1)], [(i + 1, i) for i in range(p - 1)], [(0, 1), (1, 0)])])
        try:
            comm.permute(t, [(0, 1), (0, 2)])
            refused = None
        except ValueError as e:
            refused = str(e)
        return {"got": out, "counts": counts, "refused": refused}
    cases["permute"] = permute_case
    return cases


# the random stream across ranks (tests/test_torch_random.py): draws of
# each kind split 0 and 1, ragged and with an empty last rank
RANDOM_SEED = 11
RANDOM_SHAPES = {"ragged": (10, 7), "last_empty": (9, 5), "cols": (5, 9)}  # 3,3,3,1 and 3,3,3,0 rows; 3,3,3,0 cols
RANDOM_DRAWS = {
    "randn": lambda lib, shape, split, **kw: lib.random.randn(*shape, split=split, **kw),
    "rand": lambda lib, shape, split, **kw: lib.random.rand(*shape, split=split, **kw),
    "randint": lambda lib, shape, split, **kw: lib.random.randint(-50, 1000, shape, split=split, **kw),
    "normal": lambda lib, shape, split, **kw: lib.random.normal(2.0, 0.5, shape, split=split, **kw),
    "normal_arrays": lambda lib, shape, split, **kw: lib.random.normal(
        lib.array(_array(shape, "float32", 71), split=split, **kw),
        lib.array(np.abs(_array(shape, "float32", 72)), split=split, **kw), split=split, **kw),
}
RANDPERM_N = 23
HSVD_DECAYING = (995, 256)  # a full-rank float32 matrix with σ_i = 2^(-i/2): the result depends on the sketch


def decaying(shape, seed=2):
    """A float32 matrix of the given shape with singular values 2^(-i/2)."""
    rng = np.random.default_rng(seed)
    k = min(shape)
    u, _ = np.linalg.qr(rng.standard_normal((shape[0], k)))
    v, _ = np.linalg.qr(rng.standard_normal((shape[1], k)))
    return ((u * 2.0 ** (-np.arange(k) / 2)) @ v.T).astype(np.float32)


def _random_cases(ht):
    """Split draws of heat_tpu's stream: each rank's shard, the global
    array, the state after, and the element counts the plain generator
    made on this rank (each draw: this rank's chunk only)."""
    import importlib
    from unittest import mock

    kt = importlib.import_module("heat_tpu_torch.kernels.threefry")
    comm = ht.get_comm()
    cases = {}
    made = []

    def counted(draw):
        def wrapped(mode, key, chunk, dtype, device, args=()):
            made.append(chunk.numel)
            return draw(mode, key, chunk, dtype, device, args)
        return wrapped

    def drawn(call):
        made.clear()
        ht.random.seed(RANDOM_SEED)
        with mock.patch.object(kt, "draw_plain", counted(kt.draw_plain)):
            comm.counts.clear()
            x = call()
            counts = dict(comm.counts)
        return {"local": _np(x.larray), "split": x.split, "gshape": x.gshape, "global": x.numpy(),
                "state": ht.random.get_state(), "made": list(made), "counts": counts}

    for kind, draw in RANDOM_DRAWS.items():
        for label, shape in RANDOM_SHAPES.items():
            for split in (0, 1):
                def draw_case(draw=draw, shape=shape, split=split):
                    return drawn(lambda: draw(ht, shape, split))
                cases[f"random_{kind}_{label}_{split}"] = draw_case

    cases["random_randperm"] = lambda: drawn(lambda: ht.random.randperm(RANDPERM_N, split=0))
    for label, shape in RANDOM_SHAPES.items():
        def permute_case(shape=shape):
            return drawn(lambda: ht.random.permutation(ht.array(_array(shape, "float32", 73), split=0)))
        cases[f"random_permutation_{label}"] = permute_case

    a = decaying(HSVD_DECAYING)
    for split in (0, 1):
        for call in ("rank", "rank_one_view", "hsvd"):
            def hsvd_case(a=a if split == 0 else a.T.copy(), split=split, call=call):
                U, s, V, err = hsvd_call(ht, ht.array(a, split=split), call, True)
                return {"U": U.numpy(), "sigma": s.numpy(), "V": V.numpy(), "err": float(err)}
            cases[f"random_hsvd_{split}_{call}"] = hsvd_case
    return cases


# the NumPy surface across ranks (tests/test_torch_elementwise.py and
# tests/test_torch_statistics.py): name -> call(lib, kw) on either package,
# kw holding heat_tpu's communicator (empty for the port)
def _surface_array(lib, kw, shape, split, seed, dtype="float32", nan_at=(), lmap=None):
    """An operand from a seed; ``nan_at`` flat positions set to NaN; ``lmap``
    a map of shard extents along split 0 the port's operand is moved to
    (heat_tpu keeps its chunks)."""
    a = _array(shape, dtype, seed)
    for i in nan_at:
        a.reshape(-1)[i] = np.nan
    x = lib.array(a, split=split, **kw)
    if lmap is not None and lib.__name__ == "heat_tpu_torch":
        target = x.lshape_map
        target[:, split] = lmap
        x.redistribute_(target_map=target)
    return x


def _ties(lib, kw, seed, nan: bool):
    """(21,) float32 split 0 over 4 ranks (6, 6, 6, 3): the maximum at 3
    and 17 and the minimum at 5 and 19 (ties across ranks), with NaNs at
    13 and 8 (the first one on rank 1) where ``nan``."""
    a = _array((21,), "float32", seed)
    a[[3, 17]] = 9.0
    a[[5, 19]] = -9.0
    if nan:
        a[[13, 8]] = np.nan
    return lib.array(a, split=0, **kw)


def _surface_defs():
    A = _surface_array
    cases = {
        # mixed splits, broadcasting, replicated operands, uneven maps
        "add_split0_split1": lambda lib, kw: lib.add(A(lib, kw, (13, 10), 0, 1), A(lib, kw, (13, 10), 1, 2)),
        "mul_split1_split0": lambda lib, kw: A(lib, kw, (13, 10), 1, 3) * A(lib, kw, (13, 10), 0, 4),
        "sub_row_split0": lambda lib, kw: A(lib, kw, (13, 10), 0, 5) - A(lib, kw, (10,), 0, 6),
        "div_col_split1": lambda lib, kw: A(lib, kw, (13, 10), 1, 7) / A(lib, kw, (13, 1), 0, 8),
        "add_outer_0_1": lambda lib, kw: A(lib, kw, (13, 1), 0, 9) + A(lib, kw, (1, 10), 1, 10),
        "add_3d_split2": lambda lib, kw: A(lib, kw, (3, 5, 9), 2, 11) + A(lib, kw, (5, 1), 0, 12),
        "mul_whole_split0": lambda lib, kw: A(lib, kw, (13, 10), None, 13) * A(lib, kw, (13, 10), 0, 14),
        "sub_scalar_left": lambda lib, kw: 2.5 - A(lib, kw, (13, 10), 1, 15),
        "add_empty_rank": lambda lib, kw: A(lib, kw, (3, 5), 0, 16) + A(lib, kw, (5,), None, 17),
        "add_uneven_map": lambda lib, kw: A(lib, kw, (13, 6), 0, 18, lmap=[6, 1, 4, 2]) + A(lib, kw, (13, 6), 0, 19),
        "add_uneven_maps": lambda lib, kw: (A(lib, kw, (13, 6), 0, 20, lmap=[1, 5, 0, 7])
                                            + A(lib, kw, (13, 6), 0, 21, lmap=[6, 1, 4, 2])),
        "gt_split0_split1": lambda lib, kw: A(lib, kw, (13, 10), 0, 22) > A(lib, kw, (13, 10), 1, 23),
        "eq_int_bcast": lambda lib, kw: A(lib, kw, (13, 10), 0, 24, "int32") % 3 == A(lib, kw, (10,), None, 25,
                                                                                        "int32") % 3,
        "where_out_mixed": lambda lib, kw: lib.add(
            A(lib, kw, (13, 10), 0, 26), A(lib, kw, (13, 10), 1, 27),
            out=lib.array(np.full((13, 10), 7.0), split=1, **kw), where=A(lib, kw, (13, 10), 0, 28, "bool")),
        "equal_mixed": lambda lib, kw: lib.equal(A(lib, kw, (13, 10), 0, 29), A(lib, kw, (13, 10), 1, 29)),
        "allclose_mixed": lambda lib, kw: lib.allclose(A(lib, kw, (13, 10), 0, 30), A(lib, kw, (13, 10), 1, 31)),
        "exp_split0": lambda lib, kw: lib.exp(A(lib, kw, (13, 10), 0, 32)),
        "abs_max_split0": lambda lib, kw: abs(A(lib, kw, (13, 10), 0, 33)).max(),
        "count_positive": lambda lib, kw: (A(lib, kw, (13, 10), 0, 34) > 0).sum(),
        # cumulative ops and diff along the split axis
        "cumsum_split0": lambda lib, kw: lib.cumsum(A(lib, kw, (13, 10), 0, 35), 0),
        "cumsum_int_split0": lambda lib, kw: lib.cumsum(A(lib, kw, (13, 4), 0, 36, "int32"), 0),
        "cumsum_bool_split0": lambda lib, kw: lib.cumsum(A(lib, kw, (13,), 0, 37, "bool"), 0),
        "cumprod_split0": lambda lib, kw: lib.cumprod(A(lib, kw, (13, 3), 0, 38) * 0.5 + 1, 0),
        "cumsum_empty_rank": lambda lib, kw: lib.cumsum(A(lib, kw, (3, 5), 0, 39), 0),
        "cumsum_split1_axis0": lambda lib, kw: lib.cumsum(A(lib, kw, (13, 10), 1, 40), 0),
        "cumsum_uneven_map": lambda lib, kw: lib.cumsum(A(lib, kw, (13, 2), 0, 41, lmap=[0, 7, 0, 6]), 0),
        "diff_split0": lambda lib, kw: lib.diff(A(lib, kw, (13, 10), 0, 42), axis=0),
        "diff_split0_n3": lambda lib, kw: lib.diff(A(lib, kw, (13, 10), 0, 43), n=3, axis=0),
        "diff_empty_rank": lambda lib, kw: lib.diff(A(lib, kw, (3, 5), 0, 44), axis=0),
        "diff_gaps": lambda lib, kw: lib.diff(A(lib, kw, (13, 2), 0, 45, lmap=[0, 7, 0, 6]), n=2, axis=0),
        "diff_split0_axis1": lambda lib, kw: lib.diff(A(lib, kw, (13, 10), 0, 46), axis=1),
        # extremes, argmax/argmin with ties and NaNs across ranks
        "argmax_ties": lambda lib, kw: lib.argmax(_ties(lib, kw, 47, False)),
        "argmin_ties": lambda lib, kw: lib.argmin(_ties(lib, kw, 47, False)),
        "argmax_nan": lambda lib, kw: lib.argmax(_ties(lib, kw, 47, True)),
        "argmin_nan": lambda lib, kw: lib.argmin(_ties(lib, kw, 47, True), axis=0),
        "argmax_2d_axis0": lambda lib, kw: A(lib, kw, (13, 10), 0, 48, "int32").__mod__(7).argmax(axis=0),
        "argmax_2d_flat": lambda lib, kw: lib.argmax(A(lib, kw, (13, 10), 0, 49)),
        "argmin_2d_flat_split1": lambda lib, kw: lib.argmin(A(lib, kw, (13, 10), 1, 50)),
        "argmax_2d_axis1": lambda lib, kw: lib.argmax(A(lib, kw, (13, 10), 0, 51), axis=1, keepdims=True),
        "argmax_empty_rank": lambda lib, kw: lib.argmax(A(lib, kw, (3, 5), 0, 52), axis=0),
        "max_split0": lambda lib, kw: lib.max(A(lib, kw, (13, 10), 0, 53), axis=0),
        "min_split1_axis1": lambda lib, kw: lib.min(A(lib, kw, (13, 10), 1, 54), axis=1, keepdims=True),
        # moments
        "mean_split0": lambda lib, kw: A(lib, kw, (13, 10), 0, 55).mean(axis=0),
        "mean_all": lambda lib, kw: A(lib, kw, (13, 10), 0, 56).mean(),
        "mean_split0_axis1": lambda lib, kw: A(lib, kw, (13, 10), 0, 57).mean(axis=1),
        "mean_int_split1": lambda lib, kw: lib.mean(A(lib, kw, (13, 10), 1, 58, "int32"), axis=1),
        "var_split0": lambda lib, kw: A(lib, kw, (13, 10), 0, 59).var(axis=0),
        "var_all_ddof1": lambda lib, kw: lib.var(A(lib, kw, (13, 10), 0, 60), ddof=1),
        "std_split1": lambda lib, kw: lib.std(A(lib, kw, (13, 10), 1, 61), axis=1),
        "var_empty_rank": lambda lib, kw: lib.var(A(lib, kw, (3, 5), 0, 62), axis=0),
        "standardize": lambda lib, kw: ((lambda x: (x - x.mean(axis=0)) / x.std(axis=0))(A(lib, kw, (13, 10), 0, 63))),
        "average_weights": lambda lib, kw: lib.average(A(lib, kw, (13, 10), 0, 64), axis=0,
                                                       weights=lib.array(np.arange(1.0, 14.0), split=0, **kw)),
        "skew_split0": lambda lib, kw: lib.skew(A(lib, kw, (13, 10), 0, 65), axis=0),
        "kurtosis_all": lambda lib, kw: lib.kurtosis(A(lib, kw, (13, 10), 0, 66)),
        "prod_split0": lambda lib, kw: lib.prod(A(lib, kw, (13, 3), 0, 67) * 0.1 + 1, axis=0),
        "nansum_split0": lambda lib, kw: lib.nansum(A(lib, kw, (13, 3), 0, 68, nan_at=(4, 20)), axis=0),
        "any_split0": lambda lib, kw: lib.any(A(lib, kw, (13, 3), 0, 69) > 1.5, axis=0),
        "all_split0": lambda lib, kw: lib.all(A(lib, kw, (13, 3), 0, 70) > -2.5),
        # percentiles along the split axis (the distributed sort) and not
        "median_1d": lambda lib, kw: lib.median(A(lib, kw, (21,), 0, 71)),
        "median_2d_axis0": lambda lib, kw: lib.median(A(lib, kw, (13, 6), 0, 72), axis=0),
        "median_empty_rank": lambda lib, kw: lib.median(A(lib, kw, (3,), 0, 73)),
        "median_int": lambda lib, kw: lib.median(A(lib, kw, (22,), 0, 74, "int32")),
        "median_nan_lane": lambda lib, kw: lib.median(A(lib, kw, (13, 4), 0, 75, nan_at=(9,)), axis=0),
        "median_axis1_split0": lambda lib, kw: lib.median(A(lib, kw, (13, 6), 0, 76), axis=1),
        "median_keepdims": lambda lib, kw: lib.median(A(lib, kw, (13, 6), 0, 77), axis=0, keepdims=True),
        "percentile_vector_axis1": lambda lib, kw: lib.percentile(A(lib, kw, (13, 6), 0, 78), [10.0, 90.0], axis=1),
        "histc_split0": lambda lib, kw: lib.histc(A(lib, kw, (13, 10), 0, 79), bins=9),
        "histogram_split1": lambda lib, kw: lib.histogram(A(lib, kw, (13, 10), 1, 80), bins=6)[0],
        "bincount_split0": lambda lib, kw: lib.bincount(A(lib, kw, (23,), 0, 81, "int32") % 5 + 5),
        "digitize_split0": lambda lib, kw: lib.digitize(A(lib, kw, (13, 10), 0, 82), [-1.0, 0.0, 0.5]),
    }
    for interp in ("linear", "lower", "higher", "midpoint", "nearest"):
        cases[f"percentile_{interp}"] = lambda lib, kw, interp=interp: lib.percentile(
            A(lib, kw, (22, 3), 0, 83), [0.0, 5.0, 37.5, 50.0, 95.0, 100.0], axis=0, interpolation=interp)
    return cases


SURFACE_CASES = _surface_defs()


def _surface_cases(ht):
    comm = ht.get_comm()
    out = {}
    for name, call in SURFACE_CASES.items():
        def case(call=call):
            comm.counts.clear()
            res = call(ht, {})
            counts = dict(comm.counts)
            if isinstance(res, bool):
                return {"value": res, "counts": counts}
            return {"local": _np(res.larray), "split": res.split, "gshape": res.gshape, "global": res.numpy(),
                    "dtype": res.dtype.__name__, "counts": counts, "lmap": res.lshape_map}
        out[f"surface_{name}"] = case
    return out


# indexing, where/nonzero, the factories and repr across ranks
# (tests/test_torch_indexing.py, tests/test_torch_factories.py): name ->
# call(lib, kw) on either package, kw holding heat_tpu's communicator
def indexing_operand(shape, seed):
    return _array(shape, "float32", seed)


def _assigned(x, key, value):
    x[key] = value
    return x


def _resplit_then_write(x, axis):
    """``x.resplit(axis)`` after a write into ``x``: unchanged by it."""
    y = x.resplit(axis)
    x[4] = -5.0
    return y


def _indexing_defs():
    A = _surface_array
    mask_rows = indexing_operand((10, 7), 100)[:, 0] > 0

    def a(lib, kw, split=0, lmap=None):  # 10 rows over 4 ranks: 3, 3, 3, 1 (or lmap)
        return A(lib, kw, (10, 7), split, 100, lmap=lmap)

    def b(lib, kw):  # 3 rows over 4 ranks: 1, 1, 1, 0
        return A(lib, kw, (3, 5), 0, 101)

    def z(lib, kw):  # split 1: columns 2, 2, 2, 1
        return A(lib, kw, (10, 7), 1, 102)

    def v(shape, seed=103):
        return indexing_operand(shape, seed)

    def n_sel(x, t):
        return int((x.numpy() > t).sum())

    cases = {
        "get_int_owner": lambda lib, kw: a(lib, kw)[4],
        "get_int_neg": lambda lib, kw: a(lib, kw)[-1],
        "get_slice_step_split0": lambda lib, kw: a(lib, kw)[2:9:3],
        "get_slice_reverse_split0": lambda lib, kw: a(lib, kw)[::-1],
        "get_slice_neg_step": lambda lib, kw: a(lib, kw)[8:1:-3],
        "get_slice_empty": lambda lib, kw: a(lib, kw)[5:2],
        "get_col_split0": lambda lib, kw: a(lib, kw)[:, 1],
        "get_none_slice_split0": lambda lib, kw: a(lib, kw)[None, 2:5],
        "get_rows_across_ranks": lambda lib, kw: a(lib, kw)[np.array([9, 0, 4, 7, 4])],
        "get_list_repeat": lambda lib, kw: a(lib, kw)[[7, 1, 7]],
        "get_dnd_ints_split": lambda lib, kw: a(lib, kw)[lib.array(np.array([9, 2, 5]), split=0, **kw)],
        "get_mixed_pairs": lambda lib, kw: a(lib, kw)[np.array([9, 0]), np.array([3, 4])],
        "get_mixed_slice_cols": lambda lib, kw: a(lib, kw)[1:8, [6, 0]],
        "get_mask_elements_split0": lambda lib, kw: (lambda x: x[x > 0.5])(a(lib, kw)),
        "get_mask_rows_split0": lambda lib, kw: a(lib, kw)[lib.array(mask_rows, split=0, **kw)],
        "get_mask_rows_whole": lambda lib, kw: a(lib, kw)[lib.array(mask_rows, **kw)],
        "get_mask_empty": lambda lib, kw: (lambda x: x[x > 99.0])(a(lib, kw)),
        "get_mask_split1": lambda lib, kw: (lambda x: x[x > 0.5])(z(lib, kw)),
        "get_split1_col": lambda lib, kw: z(lib, kw)[:, 1],
        "get_split1_rows": lambda lib, kw: z(lib, kw)[np.array([3, 1])],
        "get_split1_adv_cols": lambda lib, kw: z(lib, kw)[:, np.array([3, 1])],
        "get_split1_slice_cols": lambda lib, kw: z(lib, kw)[:, 6:1:-2],
        "get_empty_rank_int": lambda lib, kw: b(lib, kw)[2],
        "get_empty_rank_slice": lambda lib, kw: b(lib, kw)[1:],
        "get_empty_rank_mask": lambda lib, kw: (lambda x: x[x > 0])(b(lib, kw)),
        "get_empty_rank_rows": lambda lib, kw: b(lib, kw)[[2, 0]],
        "get_uneven_slice": lambda lib, kw: a(lib, kw, lmap=[6, 1, 0, 3])[2:9],
        "get_uneven_rows": lambda lib, kw: a(lib, kw, lmap=[6, 1, 0, 3])[[8, 0, 6]],
        "get_uneven_mask": lambda lib, kw: (lambda x: x[x > 0])(a(lib, kw, lmap=[6, 1, 0, 3])),
        "get_uneven_int": lambda lib, kw: a(lib, kw, lmap=[6, 1, 0, 3])[7],
        "get_iterated_row": lambda lib, kw: list(a(lib, kw))[5],
        "nonzero_split0": lambda lib, kw: lib.nonzero(a(lib, kw) > 0.5),
        "nonzero_split1": lambda lib, kw: lib.nonzero(z(lib, kw) > 0.5),
        "nonzero_empty_rank": lambda lib, kw: lib.nonzero(b(lib, kw) > 0),
        "where_split0": lambda lib, kw: lib.where(a(lib, kw) > 0, a(lib, kw), 0.0),
        "where_mixed_splits": lambda lib, kw: lib.where(a(lib, kw) > 0, a(lib, kw), z(lib, kw)),
        "set_slice_split0": lambda lib, kw: _assigned(a(lib, kw), slice(2, 9, 3), v((3, 7))),
        "set_slice_reverse": lambda lib, kw: _assigned(a(lib, kw), slice(None, None, -1), v((10, 7))),
        "set_slice_dnd_split0": lambda lib, kw: _assigned(a(lib, kw), slice(1, 8), lib.array(v((7, 7)), split=0,
                                                                                             **kw)),
        "set_slice_dnd_split1": lambda lib, kw: _assigned(a(lib, kw), slice(1, 8), lib.array(v((7, 7)), split=1,
                                                                                             **kw)),
        "set_int_owner": lambda lib, kw: _assigned(a(lib, kw), 4, v((7,))),
        "set_rows": lambda lib, kw: _assigned(a(lib, kw), np.array([9, 0, 4]), v((3, 7))),
        "set_mixed": lambda lib, kw: _assigned(a(lib, kw), (np.array([9, 0]), np.array([3, 4])), [1.0, 2.0]),
        "set_cols_split0": lambda lib, kw: _assigned(a(lib, kw), (slice(None), 1), v((10,))),
        "set_mask_scalar": lambda lib, kw: (lambda x: _assigned(x, x > 0.5, 0.0))(a(lib, kw)),
        "set_mask_values": lambda lib, kw: (lambda x: _assigned(x, x > 0.5, np.arange(n_sel(x, 0.5), dtype=np.float32))
                                            )(a(lib, kw)),
        "set_mask_dnd_values": lambda lib, kw: (lambda x: _assigned(
            x, x > 0.5, lib.array(np.arange(n_sel(x, 0.5), dtype=np.float32), split=0, **kw)))(a(lib, kw)),
        "set_mask_rows": lambda lib, kw: _assigned(a(lib, kw), lib.array(mask_rows, split=0, **kw),
                                                   v((int(mask_rows.sum()), 7))),
        "set_mask_split1_values": lambda lib, kw: (lambda x: _assigned(
            x, x > 0.5, np.arange(n_sel(x, 0.5), dtype=np.float32)))(z(lib, kw)),
        "set_mask_split1_scalar": lambda lib, kw: (lambda x: _assigned(x, x > 0.5, -1.0))(z(lib, kw)),
        "set_mask_rows_split1": lambda lib, kw: _assigned(z(lib, kw), lib.array(mask_rows, split=0, **kw),
                                                          v((int(mask_rows.sum()), 7))),
        "set_empty_rank_mask": lambda lib, kw: (lambda x: _assigned(x, x > 0, np.arange(n_sel(x, 0), dtype=np.float32))
                                                )(b(lib, kw)),
        "set_empty_rank_int": lambda lib, kw: _assigned(b(lib, kw), 2, v((5,))),
        "set_after_resplit_same": lambda lib, kw: _resplit_then_write(a(lib, kw), 0),
        "set_after_resplit_other": lambda lib, kw: _resplit_then_write(a(lib, kw), 1),
        "set_uneven_slice": lambda lib, kw: _assigned(a(lib, kw, lmap=[6, 1, 0, 3]), slice(1, 9), v((8, 7))),
        "fill_diagonal_split0": lambda lib, kw: a(lib, kw).fill_diagonal(-2.0),
        "fill_diagonal_split1": lambda lib, kw: z(lib, kw).fill_diagonal(-2.0),
        "ones_split0": lambda lib, kw: lib.ones((10, 7), split=0, **kw),
        "full_split1": lambda lib, kw: lib.full((10, 7), 2.5, split=1, **kw),
        "full_int_split0": lambda lib, kw: lib.full((3, 5), 7, split=0, **kw),
        "zeros_like_split1": lambda lib, kw: lib.zeros_like(z(lib, kw)),
        "ones_like_int": lambda lib, kw: lib.ones_like(b(lib, kw), dtype=lib.int64),
        "full_like_split0": lambda lib, kw: lib.full_like(a(lib, kw), -3.0),
        "approx_linspace_split0": lambda lib, kw: lib.linspace(-1.0, 3.0, 37, split=0, **kw),
        "approx_linspace_no_end": lambda lib, kw: lib.linspace(0, 1, 10, endpoint=False, split=0, **kw),
        "approx_logspace_split0": lambda lib, kw: lib.logspace(0.0, 2.0, 13, split=0, **kw),
        "meshgrid_xy_0": lambda lib, kw: lib.meshgrid(lib.arange(5, split=0, **kw), lib.arange(3, **kw))[0],
        "meshgrid_xy_1": lambda lib, kw: lib.meshgrid(lib.arange(5, split=0, **kw), lib.arange(3, **kw))[1],
        "meshgrid_ij_0": lambda lib, kw: lib.meshgrid(lib.arange(6, split=0, **kw), lib.arange(4, **kw),
                                                      indexing="ij")[0],
        "from_partitioned_split0": lambda lib, kw: lib.from_partitioned(a(lib, kw), **kw),
        "from_partitioned_split1": lambda lib, kw: lib.from_partitioned(z(lib, kw), **kw),
        "repr_split0": lambda lib, kw: repr(A(lib, kw, (50, 40), 0, 104)),
        "repr_split1": lambda lib, kw: repr(A(lib, kw, (50, 40), 1, 105)),
        "repr_3d_split2": lambda lib, kw: repr(A(lib, kw, (10, 11, 12), 2, 106)),
        "repr_small_split0": lambda lib, kw: repr(a(lib, kw)),
        "repr_empty_rank_big": lambda lib, kw: repr(A(lib, kw, (3, 400), 0, 107)),
        "repr_int_split0": lambda lib, kw: repr(lib.arange(5000, split=0, **kw)),
    }
    return cases


INDEXING_CASES = _indexing_defs()
# cases where heat_tpu on 4 devices is at fault (its meshgrid of a split input
# has the padded extent, its partition dict of a split array the padded
# shards): held against NumPy instead, as (values, split, dtype)
_I32 = np.arange(6, dtype=np.int32)
NUMPY_REFERENCE = {
    "meshgrid_xy_0": (lambda: np.meshgrid(_I32[:5], _I32[:3])[0], 1, "int32"),
    "meshgrid_xy_1": (lambda: np.meshgrid(_I32[:5], _I32[:3])[1], 1, "int32"),
    "meshgrid_ij_0": (lambda: np.meshgrid(_I32, _I32[:4], indexing="ij")[0], 0, "int32"),
    "from_partitioned_split0": (lambda: indexing_operand((10, 7), 100), 0, "float32"),
    "from_partitioned_split1": (lambda: indexing_operand((10, 7), 102), 1, "float32"),
}


def _indexing_cases(ht):
    comm = ht.get_comm()
    out = {}
    for name, call in INDEXING_CASES.items():
        def case(call=call):
            comm.counts.clear()
            res = call(ht, {})
            counts = dict(comm.counts)
            if isinstance(res, str):
                return {"value": res, "counts": counts}
            return {"local": _np(res.larray), "split": res.split, "gshape": res.gshape, "global": res.numpy(),
                    "dtype": res.dtype.__name__, "counts": counts, "lmap": res.lshape_map}
        out[f"indexing_{name}"] = case

    def lloc_slabs():
        x = ht.array(indexing_operand((10, 7), 0), split=0)
        read = _np(x.lloc[::-1, 1:3])
        x.lloc[:1] = -1.0
        return {"read": read, "after_write": _np(x.larray)}
    out["lloc_slabs"] = lloc_slabs
    return out


# data-parallel training (tests/test_torch_train.py): the MLP 16-8-4 and
# the CNN 1->4->8 on 10 x 10 inputs, on either package's nn (``lib.nn``)
def train_mlp(nn, dropout: bool = True):
    layers = [nn.Linear(16, 8), nn.ReLU()] + ([nn.Dropout(0.25)] if dropout else []) + [nn.Linear(8, 4)]
    return nn.Sequential(*layers)


def train_cnn(nn):
    return nn.Sequential(nn.Conv2d(1, 4, 3), nn.ReLU(), nn.Conv2d(4, 8, 3, padding="same"), nn.ReLU(),
                         nn.MaxPool2d(2), nn.Dropout2d(0.25), nn.Flatten(), nn.Linear(8 * 4 * 4, 16), nn.ReLU(),
                         nn.Dropout(0.5), nn.Linear(16, 4))


def train_data(model: str, n: int, seed: int = 91):
    """(x, y): n samples for ``model`` ("mlp": 16 features, "cnn": 1 x 10 x
    10), labels in [0, 4) that a linear map of x separates."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 16) if model == "mlp" else (n, 1, 10, 10)).astype(np.float32)
    w = np.random.default_rng(seed + 1).standard_normal((x[0].size, 4)).astype(np.float32)
    return x, np.argmax(x.reshape(n, -1) @ w, axis=1).astype(np.int32)


def train_optimizer(optim, name: str):
    return {"sgd": lambda: optim.SGD(0.05, momentum=0.9, nesterov=True, weight_decay=1e-3),
            "adam": lambda: optim.Adam(0.01, weight_decay=1e-3), "adamw": lambda: optim.AdamW(0.01)}[name]()


# (model, optimizer, global batch): 30 rows over 4 ranks are 8, 8, 8, 6; 3 rows 1, 1, 1, 0
TRAIN_DP = {"cnn_sgd_30": ("cnn", "sgd", 30), "mlp_adam_32": ("mlp", "adam", 32), "mlp_adamw_3": ("mlp", "adamw", 3)}
TRAIN_DASO = {"daso_compressed": True, "daso_full": False}  # n_nodes=2, global_skip=2, the MLP with dropout
TRAIN_STEPS = 3
DASO_STEPS = 4
SHUFFLES = {"even": (40, 0), "uneven": (37, 0), "replicated_targets": (37, None)}  # (n, split of the targets)


def _train_cases(ht):
    import torch

    comm = ht.get_comm()
    cases = {}

    def params(model):  # copies: on the CPU numpy() shares the parameters' memory
        return [_np(p).copy() for p in model.module.parameters()]

    for label, (kind, opt, n) in TRAIN_DP.items():
        def dp_case(kind=kind, opt=opt, n=n):
            x, y = train_data(kind, n)
            model = ht.nn.DataParallel((train_cnn if kind == "cnn" else train_mlp)(ht.nn), key=11)
            dpo = ht.optim.DataParallelOptimizer(train_optimizer(ht.optim, opt), model)
            X, Y = ht.array(x, split=0), ht.array(y, split=0)
            steps = []
            for _ in range(TRAIN_STEPS):
                comm.counts.clear()
                loss = dpo.step(X, Y)
                steps.append({"loss": float(loss), "params": params(model), "counts": dict(comm.counts)})
            out = model(X)
            flat = torch.cat([p.detach().reshape(-1) for p in model.module.parameters()])
            return {"steps": steps, "lshape": X.lshape, "every": _np(comm.allgather(flat[None])),
                    "out": out.numpy(), "out_split": out.split}
        cases[f"train_{label}"] = dp_case

    for label, compression in TRAIN_DASO.items():
        def daso_case(compression=compression):
            x, y = train_data("mlp", 32, seed=93)
            model = ht.nn.DataParallel(train_mlp(ht.nn), key=12)
            daso = ht.optim.DASO(train_optimizer(ht.optim, "sgd"), model, n_nodes=2, global_skip=2,
                                 compression=compression)
            X, Y = ht.array(x, split=0), ht.array(y, split=0)
            steps = []
            for _ in range(DASO_STEPS):
                loss = daso.step(X, Y)
                steps.append({"loss": float(loss), "params": params(model)})
            evaluated = model(X).numpy()
            daso.sync_params()
            return {"steps": steps, "eval": evaluated, "synced": params(model)}
        cases[f"train_{label}"] = daso_case

    for label, (n, t_split) in SHUFFLES.items():
        def shuffle_case(n=n, t_split=t_split):
            data = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
            ds = ht.utils.data.Dataset(ht.array(data, split=0), targets=ht.array(np.arange(n), split=t_split))
            ht.random.seed(21)
            comm.counts.clear()
            ds.Shuffle()
            counts = dict(comm.counts)
            loader = ht.utils.data.DataLoader(ds, batch_size=8)
            first = next(iter(loader))
            return {"data": _np(ds.htdata.larray), "targets": ds.httargets.numpy(), "counts": counts,
                    "state": ht.random.get_state(), "batch_lshape": first[0].lshape, "batch": first[0].numpy()}
        cases[f"shuffle_{label}"] = shuffle_case
    return cases


# KMedians and KMedoids across ranks (tests/test_torch_kmedians.py): rows
# sorted by blob, 3, 3, 3 and 0 over 4 ranks, so that the last rank holds no
# row and each other rank one cluster only
KMD_ROWS = {"by_blob_last_empty": 9}
KMD_INITS = ("random", "probability_based")


def kmd_data(label: str) -> np.ndarray:
    data = km_blobs(KMD_ROWS[label], seed=64)
    return data[np.argsort(np.arange(len(data)) % KM_K, kind="stable")]


def _kmedians_cases(ht):
    comm = ht.get_comm()
    cases = {}
    for est in ("KMedians", "KMedoids"):
        for label in KMD_ROWS:
            for split in (0, 1):
                for init in KMD_INITS:
                    def kmd_case(est=est, label=label, split=split, init=init):
                        comm.counts.clear()
                        km = getattr(ht.cluster, est)(KM_K, init=init, random_state=7)
                        km.fit(ht.array(kmd_data(label), split=split))
                        c = km.cluster_centers_.larray
                        return {"centers": _np(c), "every": _np(comm.allgather(c[None])), "n_iter": km.n_iter_,
                                "labels": km.labels_.numpy(), "labels_split": km.labels_.split,
                                "inertia": km.inertia_, "counts": dict(comm.counts)}
                    cases[f"kmd_{est}_{label}_{split}_{init}"] = kmd_case
    return cases


# manipulations across ranks (tests/test_torch_manipulations.py): name ->
# call(lib, kw) on either package, kw holding heat_tpu's communicator; a
# DNDarray or a list of them
COLLECT_TARGET = 2


def _manip_defs():
    A = _surface_array

    def a(lib, kw, dtype="float32"):  # 13 rows over 4 ranks: 4, 4, 4, 1
        return A(lib, kw, (13, 6), 0, 300, dtype)

    def e(lib, kw):  # 9 rows: 3, 3, 3, 0 (the last rank holds none)
        return A(lib, kw, (9, 5), 0, 301)

    def u(lib, kw):  # a slice: the port keeps rows 2-10 where they fall (2, 4, 3, 0), heat_tpu rechunks
        return A(lib, kw, (13, 6), 0, 302)[2:11]

    def c(lib, kw):  # split 1: 13 columns over 4 ranks
        return A(lib, kw, (5, 13), 1, 303)

    def w(lib, kw, shape, seed, split=None):
        return A(lib, kw, shape, split, seed)

    cases = {
        # joins
        "concat_split0": lambda lib, kw: lib.concatenate([a(lib, kw), w(lib, kw, (7, 6), 304, 0)], 0),
        "concat_split0_three": lambda lib, kw: lib.concatenate([e(lib, kw)[:, :3], w(lib, kw, (2, 3), 305, 0),
                                                                u(lib, kw)[:, :3]], 0),
        "concat_harness": lambda lib, kw: lib.concatenate([w(lib, kw, (3, 10), 306, 1), w(lib, kw, (3, 5), 307),
                                                           w(lib, kw, (3, 7), 308, 1)], 1),
        "concat_whole_first": lambda lib, kw: lib.concatenate([w(lib, kw, (3, 6), 309), a(lib, kw)], 0),
        "concat_off_split": lambda lib, kw: lib.concatenate([a(lib, kw), w(lib, kw, (13, 3), 310, 0)], 1),
        "concat_off_split_uneven": lambda lib, kw: lib.concatenate([u(lib, kw), w(lib, kw, (9, 2), 311, 0)], 1),
        "concat_mixed": lambda lib, kw: lib.concatenate([w(lib, kw, (13, 6), 312), a(lib, kw),
                                                         w(lib, kw, (13, 6), 313, 1)], 0),
        "concat_promote_int": lambda lib, kw: lib.concatenate([a(lib, kw, "int32"), w(lib, kw, (6, 13), 323, 1).T], 0),
        "stack_split0": lambda lib, kw: lib.stack([a(lib, kw), a(lib, kw)], 1),
        "column_stack": lambda lib, kw: lib.column_stack([w(lib, kw, (13,), 317, 0), a(lib, kw)]),
        # splits
        "split_split0": lambda lib, kw: lib.split(a(lib, kw), [3, 9], 0),
        "split_uneven": lambda lib, kw: lib.split(u(lib, kw), 3, 0),
        "vsplit_empty_rank": lambda lib, kw: lib.vsplit(e(lib, kw), [4]),
        # shape-only functions
        "squeeze_extent1": lambda lib, kw: lib.squeeze(w(lib, kw, (1, 6), 318, 0)),
        "squeeze_keep_split": lambda lib, kw: lib.squeeze(lib.expand_dims(u(lib, kw), 1), 1),
        "broadcast_extent1": lambda lib, kw: lib.broadcast_to(w(lib, kw, (1, 6), 319, 0), (13, 6)),
        "broadcast_lead": lambda lib, kw: lib.broadcast_to(u(lib, kw), (2, 9, 6)),
        "flatten_split0": lambda lib, kw: lib.flatten(u(lib, kw)),
        "flatten_split1": lambda lib, kw: lib.flatten(c(lib, kw)),
        # moves along the split axis
        "pad_split0": lambda lib, kw: lib.pad(a(lib, kw), ((2, 3), (1, 0)), constant_values=-1),
        "pad_uneven": lambda lib, kw: lib.pad(u(lib, kw), 2),
        "pad_empty_rank": lambda lib, kw: lib.pad(e(lib, kw), ((1, 4), (0, 0))),
        "pad_split1": lambda lib, kw: lib.pad(c(lib, kw), ((0, 1), (3, 2))),
        "roll_split0": lambda lib, kw: lib.roll(a(lib, kw), 5, 0),
        "roll_uneven": lambda lib, kw: lib.roll(u(lib, kw), -4, 0),
        "roll_empty_rank": lambda lib, kw: lib.roll(e(lib, kw), 7, 0),
        "roll_split1": lambda lib, kw: lib.roll(c(lib, kw), 6, 1),
        "roll_flat": lambda lib, kw: lib.roll(a(lib, kw), 11),
        "roll_off_split": lambda lib, kw: lib.roll(a(lib, kw), 2, 1),
        "repeat_split0": lambda lib, kw: lib.repeat(a(lib, kw), 2, 0),
        "repeat_counts": lambda lib, kw: lib.repeat(u(lib, kw), [1, 0, 2, 1, 3, 0, 1, 2, 1], 0),
        "repeat_dnd_counts": lambda lib, kw: lib.repeat(a(lib, kw), lib.array(np.arange(13) % 3, split=0, **kw), 0),
        "repeat_flat": lambda lib, kw: lib.repeat(e(lib, kw), 2),
        "repeat_off_split": lambda lib, kw: lib.repeat(a(lib, kw), 2, 1),
        "tile_split0": lambda lib, kw: lib.tile(a(lib, kw), (3, 1)),
        "tile_uneven": lambda lib, kw: lib.tile(u(lib, kw), (2, 2)),
        "tile_off_split": lambda lib, kw: lib.tile(a(lib, kw), (1, 2)),
        "rot90_split0": lambda lib, kw: lib.rot90(a(lib, kw)),
        "rot90_k3_split0": lambda lib, kw: lib.rot90(a(lib, kw), 3),
        "rot90_uneven_k2": lambda lib, kw: lib.rot90(u(lib, kw), 2),
        "diagonal_split0": lambda lib, kw: lib.diagonal(a(lib, kw), 1),
        "diagonal_split1": lambda lib, kw: lib.diagonal(c(lib, kw), -1),
        "diagonal_uneven": lambda lib, kw: lib.diagonal(u(lib, kw), -2),
        "diag_1d_up": lambda lib, kw: lib.diag(w(lib, kw, (13,), 320, 0), 2),
        # layout
        "balance_uneven": lambda lib, kw: lib.balance(u(lib, kw), copy=True),
        "collect_split0": lambda lib, kw: lib.collect(a(lib, kw), COLLECT_TARGET),
        "collect_uneven": lambda lib, kw: lib.collect(u(lib, kw), COLLECT_TARGET),
        "sanitize_distribution": lambda lib, kw: lib.sanitize_distribution(w(lib, kw, (9, 6), 322, 1), a(lib, kw)[:9],
                                                                           target=u(lib, kw)),
    }
    return cases


MANIP_CASES = _manip_defs()
# each call's collectives a rank (the operands' making issues none): no
# case all-gathers a split operand; ``repeat_dnd_counts`` all-gathers the
# shard shapes of a result whose counts only their owners know
MANIP_COUNTS = {
    "concat_split0": {"all-to-all": 1},
    "concat_split0_three": {"all-to-all": 1},
    "concat_harness": {"all-to-all": 1},
    "concat_whole_first": {"all-to-all": 1},
    "concat_off_split": {},
    "concat_off_split_uneven": {"all-to-all": 1},
    "concat_mixed": {"all-to-all": 2},
    "concat_promote_int": {"all-to-all": 1},
    "stack_split0": {},
    "column_stack": {},
    "split_split0": {},
    "split_uneven": {},
    "vsplit_empty_rank": {},
    "squeeze_extent1": {"broadcast": 1},
    "squeeze_keep_split": {},
    "broadcast_extent1": {"broadcast": 1},
    "broadcast_lead": {},
    "flatten_split0": {},
    "flatten_split1": {"all-to-all": 1},
    "pad_split0": {},
    "pad_uneven": {},
    "pad_empty_rank": {},
    "pad_split1": {},
    "roll_split0": {"all-to-all": 1},
    "roll_uneven": {"all-to-all": 1},
    "roll_empty_rank": {"all-to-all": 1},
    "roll_split1": {"all-to-all": 1},
    "roll_flat": {"all-to-all": 1},
    "roll_off_split": {},
    "repeat_split0": {},
    "repeat_counts": {},
    "repeat_dnd_counts": {"all-gather": 1},
    "repeat_flat": {},
    "repeat_off_split": {},
    "tile_split0": {"all-to-all": 1},
    "tile_uneven": {"all-to-all": 1},
    "tile_off_split": {},
    "rot90_split0": {},
    "rot90_k3_split0": {"all-to-all": 1},
    "rot90_uneven_k2": {"all-to-all": 1},
    "diagonal_split0": {},
    "diagonal_split1": {},
    "diagonal_uneven": {},
    "diag_1d_up": {},
    "balance_uneven": {"all-to-all": 1},
    "collect_split0": {"all-to-all": 1},
    "collect_uneven": {"all-to-all": 1},
    "sanitize_distribution": {"all-to-all": 3},
}
# each result's extents along its split a rank, one list a part (None: not
# split), as the docstrings promise: rows that stay with their owner where
# they fall (a: 4, 4, 4, 1; e: 3, 3, 3, 0; u: 2, 4, 3, 0; c's columns: 4,
# 4, 4, 1), pad rows on the first and last rank that hold rows, a roll in
# the input's map, joins, tiles, flips and ``balance`` in the chunk
# geometry of the result, ``collect`` every row on its target
_A, _U, _E = [4, 4, 4, 1], [2, 4, 3, 0], [3, 3, 3, 0]
MANIP_LAYOUT = {
    "concat_split0": [[5, 5, 5, 5]],
    "concat_split0_three": [[5, 5, 5, 5]],
    "concat_harness": [[6, 6, 6, 4]],
    "concat_whole_first": [[4, 4, 4, 4]],
    "concat_off_split": [_A],
    "concat_off_split_uneven": [_U],
    "concat_mixed": [[10, 10, 10, 9]],
    "concat_promote_int": [[7, 7, 7, 5]],
    "stack_split0": [_A],
    "column_stack": [_A],
    "split_split0": [[3, 0, 0, 0], [1, 4, 1, 0], [0, 0, 3, 1]],
    "split_uneven": [[2, 1, 0, 0], [0, 3, 0, 0], [0, 0, 3, 0]],
    "vsplit_empty_rank": [[3, 1, 0, 0], [0, 2, 3, 0]],
    "squeeze_extent1": [None],
    "squeeze_keep_split": [_U],
    "broadcast_extent1": [_A],
    "broadcast_lead": [_U],
    "flatten_split0": [[12, 24, 18, 0]],
    "flatten_split1": [[26, 26, 13, 0]],
    "pad_split0": [[6, 4, 4, 4]],
    "pad_uneven": [[4, 4, 5, 0]],
    "pad_empty_rank": [[4, 3, 7, 0]],
    "pad_split1": [[7, 4, 4, 3]],
    "roll_split0": [_A],
    "roll_uneven": [_U],
    "roll_empty_rank": [_E],
    "roll_split1": [_A],
    "roll_flat": [_A],
    "roll_off_split": [_A],
    "repeat_split0": [[8, 8, 8, 2]],
    "repeat_counts": [[1, 6, 4, 0]],
    "repeat_dnd_counts": [[3, 4, 5, 0]],
    "repeat_flat": [[30, 30, 30, 0]],
    "repeat_off_split": [_A],
    "tile_split0": [[10, 10, 10, 9]],
    "tile_uneven": [[5, 5, 5, 3]],
    "tile_off_split": [_A],
    "rot90_split0": [_A],
    "rot90_k3_split0": [_A],
    "rot90_uneven_k2": [_E],
    "diagonal_split0": [[4, 1, 0, 0]],
    "diagonal_split1": [[4, 0, 0, 0]],
    "diagonal_uneven": [[0, 4, 2, 0]],
    "diag_1d_up": [[4, 4, 4, 3]],
    "balance_uneven": [_E],
    "collect_split0": [[0, 0, 13, 0]],
    "collect_uneven": [[0, 0, 9, 0]],
    "sanitize_distribution": [_U, _U],
}


def _parts(res):
    parts = res if isinstance(res, (list, tuple)) else [res]
    return [{"local": _np(p.larray), "split": p.split, "gshape": p.gshape, "global": p.numpy(),
             "dtype": p.dtype.__name__, "lmap": p.lshape_map} for p in parts]


def _manip_cases(ht):
    comm = ht.get_comm()
    out = {}
    for name, call in MANIP_CASES.items():
        def case(call=call):
            comm.counts.clear()
            res = call(ht, {})
            counts = dict(comm.counts)
            return {"parts": _parts(res), "counts": counts}
        out[f"manip_{name}"] = case
    return out


# halos, convolve, the distance ring, tile maps and the gallery across ranks
# (tests/test_torch_halo.py)
# name -> (rows, the slice of them the array is, halo size, prev, next): 16
# rows are 4 a rank; 13 rows 4, 4, 4, 1; 9 rows 3, 3, 3, 0; rows 3-13 of 16
# 1, 4, 4, 2; rows 5-14 0, 3, 4, 3 (the first rank holds none)
HALO_WORLD = {
    "halo_even_1": (16, None, 1, True, True), "halo_even_2": (16, None, 2, True, True),
    "halo_ragged_1": (13, None, 1, True, True), "halo_last_empty_2": (9, None, 2, True, True),
    "halo_prev_only": (16, None, 2, True, False), "halo_next_only": (16, None, 1, False, True),
    "halo_uneven": (16, (3, 14), 1, True, True), "halo_gap": (16, (5, 15), 2, True, True),
}
CONV_CASES = (("even", 64, 3), ("ragged", 61, 5), ("short", 17, 7), ("wide", 9, 8), ("widest", 13, 12))
CONV_MODES = ("full", "same", "valid")
RING_METRICS = ("euclidean", "sqeuclidean", "euclidean_direct", "sqeuclidean_direct", "manhattan")


def halo_operand(rows: int, width: int = 3):
    return np.arange(rows * width, dtype=np.float32).reshape(rows, width)


def conv_operands(n: int, k: int, dtype: str = "float32"):
    rng = np.random.default_rng(n * 100 + k)
    a, v = rng.standard_normal(n), rng.standard_normal(k)
    if "int" in dtype:
        return (a * 10).astype(dtype), (v * 3).astype(dtype)
    return a.astype(dtype), v.astype(dtype)


def _halo_cases(ht):
    import torch

    from heat_tpu_torch.core import parallel

    comm = ht.get_comm()
    cases = {}

    def halos(x, size, **kw):
        comm.counts.clear()
        x.get_halo(size, **kw)
        return {"prev": None if x.halo_prev is None else _np(x.halo_prev),
                "next": None if x.halo_next is None else _np(x.halo_next),
                "with": _np(x.array_with_halos), "counts": dict(comm.counts), "lmap": x.lshape_map}

    for name, (rows, cut, size, prev, nxt) in HALO_WORLD.items():
        def halo_case(rows=rows, cut=cut, size=size, prev=prev, nxt=nxt):
            x = ht.array(halo_operand(rows), split=0)
            return halos(x if cut is None else x[slice(*cut)], size, prev=prev, next=nxt)
        cases[name] = halo_case

    def rebind():
        x = ht.array(halo_operand(16, 1).reshape(-1), split=0)
        x.get_halo(1)
        x.larray = torch.arange(100.0, 104.0) + 4 * comm.rank
        return {"with": _np(x.array_with_halos), "prev": x.halo_prev, "next": x.halo_next}
    cases["halo_rebind"] = rebind

    def too_large():
        try:
            ht.array(halo_operand(13), split=0).get_halo(2)
        except ValueError as e:
            return {"raised": str(e)}
        return {"raised": None}
    cases["halo_too_large"] = too_large

    def exchange():
        x = torch.as_tensor(halo_operand(16))[comm.rank * 4: comm.rank * 4 + 4]
        comm.counts.clear()
        out = parallel.halo_exchange(x, comm, 0, 2, 1)
        counts = dict(comm.counts)
        comm.counts.clear()
        given = parallel.halo_exchange(x, comm, 0, 2, 1, counts=[4] * comm.size)
        return {"out": _np(out), "counts": counts, "given": _np(given), "given_counts": dict(comm.counts)}
    cases["halo_exchange_raw"] = exchange

    def exchange_short():  # 13 rows: 4, 4, 4, 1; a halo of 2 raises on every rank, none waits in a permute
        x = torch.as_tensor(halo_operand(13))[comm.rank * 4: comm.rank * 4 + 4]
        try:
            parallel.halo_exchange(x, comm, 0, 2, 0)
        except ValueError as e:
            return {"raised": str(e)}
        return {"raised": None}
    cases["halo_exchange_short"] = exchange_short

    for label, n, k in CONV_CASES:
        for mode in CONV_MODES:
            if mode == "same" and k % 2 == 0:
                continue
            def conv(n=n, k=k, mode=mode):
                a, v = conv_operands(n, k)
                comm.counts.clear()
                out = ht.convolve(ht.array(a, split=0), ht.array(v), mode=mode)
                counts = dict(comm.counts)
                return {"parts": _parts(out), "counts": counts}
            cases[f"conv_{label}_{mode}"] = conv

    def conv_int():
        a, v = conv_operands(21, 4, "int32")
        return {"parts": _parts(ht.convolve(ht.array(a, split=0), ht.array(v)))}
    cases["conv_int"] = conv_int

    def conv_swapped():
        a, v = conv_operands(11, 3)
        return {"parts": _parts(ht.convolve(ht.array(v), ht.array(a, split=0), mode="same"))}
    cases["conv_swapped"] = conv_swapped

    for metric in RING_METRICS:
        for symmetric in (False, True):
            def ring(metric=metric, symmetric=symmetric):
                rng = np.random.default_rng(71)
                xs = rng.standard_normal((14, 5)).astype(np.float32)
                ys = xs if symmetric else rng.standard_normal((10, 5)).astype(np.float32)
                x, y = ht.array(xs, split=0), ht.array(ys, split=0)
                out = parallel.ring_pairwise(x.larray, y.larray, comm, metric=metric, symmetric=symmetric)
                return {"rows": _np(out), "lmap": x.lshape_map}
            cases[f"ring_{metric}_{symmetric}"] = ring

    def tiles(uneven: bool):
        a = np.arange(16 * 12, dtype=np.float32).reshape(16, 12)
        x = ht.array(a, split=0)
        if uneven:
            x = x[1:15]
        st = ht.tiling.SplitTiles(x)
        sq = ht.tiling.SquareDiagTiles(x, tiles_per_proc=2)
        geo = {"tile_dimensions": [t.tolist() for t in st.tile_dimensions], "tile_ends_g": st.tile_ends_g,
               "tile_locations": st.tile_locations, "tile_map": sq.tile_map, "tile_rows": sq.tile_rows,
               "tile_columns": sq.tile_columns, "rows_per_process": sq.tile_rows_per_process,
               "row_indices": sq.row_indices, "col_indices": sq.col_indices,
               "last_diagonal_process": sq.last_diagonal_process, "start_stop_1_2": sq.get_start_stop((1, 2))}
        reads = {"split_tile_1": _np(st[1]).copy(), "split_tiles_0_2": _np(st[0:2]).copy(),
                 "square_1_2": _np(sq[1, 2]).copy(), "local_0_0": _np(sq.local_get((0, 0))).copy(),
                 "global_of_local": sq.local_to_global((0, 0))}
        st[2] = -1.0
        sq[0, 1] = -2.0
        sq.local_set((0, 0), 7.0)
        return {"geometry": geo, "reads": reads, "after": x.numpy()}
    cases["tiles_even"] = lambda: tiles(False)
    cases["tiles_uneven"] = lambda: tiles(True)

    def gallery():
        from heat_tpu_torch.utils.data import matrixgallery as gal

        out = {}
        for split in (0, 1):
            ht.random.seed(13)
            A, (U, s, V) = gal.random_known_rank(40, 5 * comm.size, 4, split=split)
            out[split] = {"A": A.numpy(), "split": A.split, "s": s.numpy(), "U": U.numpy(), "V": V.numpy(),
                          "parter": gal.parter(9, split=split).numpy()}
        return out
    cases["gallery"] = gallery
    return cases


# the dense factorizations and the iterative solvers across ranks
# (tests/test_torch_factorizations.py): every case runs the same call on
# either package, heat_tpu with kw = {"comm": its 4-device communicator}
FACT_SEED = 2000
FACT_MIN_N = 4  # inv/det's _BLOCKED_MIN_N, shrunk alike in both packages
FACT_RESPLIT_N = 3  # eigh's _EIGH_RESPLIT_MIN_N, shrunk alike: the recursion


def fact_matrix(kind: str, shape, dtype: str = "float32", seed: int = 0) -> np.ndarray:
    """A seeded operand: ``gen`` a well-conditioned square matrix (noise of
    norm about 2 around 3·I), ``spd`` a Hermitian positive-definite one
    (``G Gᴴ/n + 2I``), ``tall`` plain noise, ``neg`` ``gen`` with its first
    row negated (a determinant of either sign), ``spectrum`` diag(1, ..., n)."""
    rng = np.random.default_rng(FACT_SEED + seed)
    g = rng.standard_normal(shape)
    if "complex" in dtype:
        g = g + 1j * rng.standard_normal(shape)
    n = shape[0]
    if kind == "tall":
        a = g
    elif kind == "spd":
        a = g @ g.conj().T / n + 2 * np.eye(n)
    elif kind == "spectrum":
        a = np.diag(np.arange(1.0, n + 1))
    else:
        a = g / np.sqrt(n) + 3 * np.eye(n)
        if kind == "neg":
            a[0] *= -1
    return a.astype(dtype)


@contextlib.contextmanager
def fact_constants(lib, blocked=None, resplit=None):
    """Shrink ``basics._BLOCKED_MIN_N`` and ``factorizations._EIGH_RESPLIT_MIN_N``
    of ``lib`` (either package) for the call."""
    import importlib

    basics = importlib.import_module(lib.__name__ + ".core.linalg.basics")
    facts = importlib.import_module(lib.__name__ + ".core.linalg.factorizations")
    old = basics._BLOCKED_MIN_N, facts._EIGH_RESPLIT_MIN_N
    basics._BLOCKED_MIN_N = old[0] if blocked is None else blocked
    facts._EIGH_RESPLIT_MIN_N = old[1] if resplit is None else resplit
    try:
        yield
    finally:
        basics._BLOCKED_MIN_N, facts._EIGH_RESPLIT_MIN_N = old


def _blocked_call(lib, fn):
    """``fn()`` with inv/det's blocked order shrunk to FACT_MIN_N."""
    with fact_constants(lib, blocked=FACT_MIN_N):
        return fn()


def _fact_defs():
    """name -> (call(lib, kw), kinds): ``kinds`` says how each output is
    held against heat_tpu's: "f" and "w" values, "exact" integers, "vec"
    columns ("vech" rows) up to a phase each. The lu cases call the private
    ``_lu_factor`` of either package for the sign of the permutation."""
    M = fact_matrix

    def arr(lib, kw, kind, shape, split, dtype="float32", seed=0):
        return lib.array(M(kind, shape, dtype, seed), split=split, **kw)

    def lu(lib, x):
        return lib.linalg.factorizations._lu_factor(x)

    def blocked(fn):
        def call(lib, kw):
            with fact_constants(lib, blocked=FACT_MIN_N):
                return fn(lib, kw)
        return call

    cases = {}
    for s in (None, 0, 1):
        cases[f"polar_37x6_{s}"] = (lambda L, kw, s=s: L.linalg.polar(arr(L, kw, "tall", (37, 6), s)), "ff")
        cases[f"chol_37_{s}"] = (lambda L, kw, s=s: L.linalg.cholesky(arr(L, kw, "spd", (37, 37), s)), "f")
        cases[f"lu_37_{s}"] = (lambda L, kw, s=s: lu(L, arr(L, kw, "gen", (37, 37), s, seed=1)),
                               ("exact", "f", "f", "exact"))
        cases[f"eigh_37_{s}"] = (lambda L, kw, s=s: L.linalg.eigh(arr(L, kw, "spd", (37, 37), s, seed=2)),
                                 ("w", "vec"))
        cases[f"svd_37x6_{s}"] = (lambda L, kw, s=s: L.linalg.svd(arr(L, kw, "tall", (37, 6), s, seed=3)),
                                  ("vec", "w", "vech"))
    cases["polar_5x3_0"] = (lambda L, kw: L.linalg.polar(arr(L, kw, "tall", (5, 3), 0, seed=4)), "ff")
    cases["polar_37x6_0_complex64"] = (lambda L, kw: L.linalg.polar(arr(L, kw, "tall", (37, 6), 0, "complex64")),
                                       "ff")
    cases["polar_37x6_0_float64"] = (lambda L, kw: L.linalg.polar(arr(L, kw, "tall", (37, 6), 0, "float64")), "ff")
    cases["polar_left_6x37_1"] = (
        lambda L, kw: L.linalg.polar(arr(L, kw, "tall", (37, 6), 0, seed=5).T.resplit(1), side="left"), "ff")
    cases["chol_5_0_complex64"] = (lambda L, kw: L.linalg.cholesky(arr(L, kw, "spd", (5, 5), 0, "complex64", 6)), "f")
    cases["lu_5_0_float64"] = (lambda L, kw: lu(L, arr(L, kw, "neg", (5, 5), 0, "float64", 7)),
                               ("exact", "f", "f", "exact"))
    cases["lu_37_0_complex64"] = (lambda L, kw: lu(L, arr(L, kw, "gen", (37, 37), 0, "complex64", 9)),
                                  ("exact", "f", "f", "exact"))
    for assume, small in (("gen", "float64"), ("pos", "complex64")):
        kind = "gen" if assume == "gen" else "spd"
        for sa, sb, rhs, dtype in ((0, 0, 3, "float32"), (1, 1, 3, "float32"), (0, None, None, "float32"),
                                   (None, None, 3, "float32"), ("5", 0, 3, small)):
            n = 5 if sa == "5" else 37
            sa = 0 if sa == "5" else sa
            shape = (n, rhs) if rhs else (n,)
            cases[f"solve_{assume}_{n}_{sa}_{sb}_{rhs}_{dtype}"] = (
                lambda L, kw, sa=sa, sb=sb, n=n, shape=shape, kind=kind, assume=assume, dtype=dtype: L.linalg.solve(
                    arr(L, kw, kind, (n, n), sa, dtype, 10), arr(L, kw, "tall", shape, sb, dtype, 11), assume_a=assume),
                "f")
    for s in (0, 1):
        cases[f"inv_37_{s}"] = (blocked(lambda L, kw, s=s: L.linalg.inv(arr(L, kw, "gen", (37, 37), s, seed=18))), "f")
        cases[f"det_37_{s}"] = (blocked(lambda L, kw, s=s: L.linalg.det(arr(L, kw, "neg", (37, 37), s, seed=19))), "f")
    cases["det_5_0_float64"] = (blocked(lambda L, kw: L.linalg.det(arr(L, kw, "neg", (5, 5), 0, "float64", 20))),
                                "f")

    def junk_upper(L, kw):  # only the lower triangle is read: noise above the diagonal
        a = np.tril(M("spd", (37, 37), "float32", 2)) + np.triu(M("tall", (37, 37), "float32", 35), 1)
        return L.linalg.eigh(L.array(a, split=0, **kw))
    cases["eigh_37_0_junk_upper"] = (junk_upper, ("w", "vec"))

    def recursive(L, kw):  # 7 rows: 2, 2, 2, 1; a branch of order 4 recurses over 1, 1, 1, 0 rows
        with fact_constants(L, resplit=FACT_RESPLIT_N):
            return L.linalg.eigh(arr(L, kw, "spd", (7, 7), 0, "complex64", 25), UPLO="U")
    cases["eigh_7_0_complex64_U_recursive"] = (recursive, ("w", "vec"))
    cases["svd_polar_37x6_0"] = (lambda L, kw: L.linalg.svd(arr(L, kw, "tall", (37, 6), 0, seed=26), method="polar"),
                                 ("vec", "w", "vech"))
    for method in ("qr", "polar"):
        cases[f"svdvals_{method}_37x6_0"] = (
            lambda L, kw, method=method: L.linalg.svd(arr(L, kw, "tall", (37, 6), 0, seed=26), compute_uv=False,
                                                      method=method), "w")
    cases["svd_wide_6x37_1"] = (lambda L, kw: L.linalg.svd(arr(L, kw, "tall", (37, 6), 0, seed=27).T.resplit(1)),
                                ("vec", "w", "vech"))
    cases["svd_37x6_0_complex64"] = (lambda L, kw: L.linalg.svd(arr(L, kw, "tall", (37, 6), 0, "complex64", 28)),
                                     ("vec", "w", "vech"))
    for dtype, sb in (("float64", 0), ("float64", None), ("float32", 0)):
        cases[f"cg_37_{sb}_{dtype}"] = (
            lambda L, kw, dtype=dtype, sb=sb: L.linalg.cg(
                arr(L, kw, "spd", (37, 37), 0, dtype, 29), arr(L, kw, "tall", (37,), sb, dtype, 30),
                L.zeros((37,), dtype=getattr(L, dtype), split=sb, **kw)), "f")

    def lanczos(L, kw, kind, m, dtype="float64", v0=None, seed=31):
        A = arr(L, kw, kind, (37, 37), 0, dtype, seed)
        return L.linalg.lanczos(A, m, v0=None if v0 is None else L.array(v0.astype(dtype), split=0, **kw))

    v_break = np.zeros(37)
    v_break[:2] = 2 ** -0.5  # in a 2-dimensional invariant subspace of diag(1, ..., 37): a breakdown at step 2
    cases["lanczos_37_0"] = (lambda L, kw: lanczos(L, kw, "spd", 10, v0=M("tall", (37,), "float64", 32)),
                             ("f", "f"))
    cases["lanczos_breakdown"] = (lambda L, kw: lanczos(L, kw, "spectrum", 5, v0=v_break), ("f", "f"))

    def seeded(L, kw):
        L.random.seed(33)
        return lanczos(L, kw, "spd", 6, "float32")
    cases["lanczos_seeded"] = (seeded, ("f", "f"))
    return cases


FACT_CASES = _fact_defs()


def _fact_cases(ht):
    """Each of FACT_CASES with the collectives it issued, the largest
    all-gather's element count, the Newton–Schulz steps of its last
    ``polar`` and the stop-test reads."""
    facts = importlib.import_module("heat_tpu_torch.core.linalg.factorizations")
    comm = ht.get_comm()
    out = {}

    def case(call):
        gathered = []
        plain = comm.allgather

        def recording(t, *args, **kw):
            res = plain(t, *args, **kw)
            gathered.append(int(res.numel()))
            return res

        comm.counts.clear()
        facts.HOST_READS = 0
        comm.allgather = recording
        try:
            res = call(ht, {})
        finally:
            del comm.allgather
        counts = dict(comm.counts)
        parts = []
        for p in (res if isinstance(res, (list, tuple)) else [res]):
            if hasattr(p, "larray"):
                parts.append({"local": _np(p.larray), "split": p.split, "gshape": p.gshape,
                              "dtype": p.dtype.__name__, "lmap": p.lshape_map})
            else:
                parts.append({"local": _np(p), "split": None, "gshape": tuple(p.shape), "dtype": None, "lmap": None})
        return {"parts": parts, "counts": counts, "gathered": max(gathered, default=0),
                "iterations": facts.POLAR_ITERATIONS, "reads": facts.HOST_READS}

    for name, (call, _) in FACT_CASES.items():
        out[f"fact_{name}"] = lambda call=call: case(call)
    # a zero pivot across ranks (tests/test_torch_factorizations.py, against
    # NumPy: heat_tpu gives NaN): det of a singular matrix, and of the row
    # reversal, whose panel blocks are singular under pivoting within each
    # rank's rows; lu returns its factors; inv and solve raise on every rank
    rev = np.eye(8, dtype=np.float32)[::-1].copy()
    for split in (0, 1):
        out[f"fact_singular_det_{split}"] = lambda split=split: case(lambda L, kw: _blocked_call(
            L, lambda: L.linalg.det(L.array(np.ones((8, 8), np.float32), split=split))))
    out["fact_reversal_det_0"] = lambda: case(lambda L, kw: _blocked_call(
        L, lambda: L.linalg.det(L.array(rev, split=0))))
    out["fact_singular_lu_0"] = lambda: case(lambda L, kw: L.linalg.lu(L.array(np.ones((8, 8), np.float32), split=0)))
    out["fact_singular_inv_0"] = lambda: case(lambda L, kw: _blocked_call(
        L, lambda: L.linalg.inv(L.array(np.ones((8, 8), np.float32), split=0))))
    out["fact_singular_solve_0"] = lambda: case(lambda L, kw: L.linalg.solve(
        L.array(np.ones((8, 8), np.float32), split=0), L.array(np.ones((8,), np.float32), split=0)))
    for assume in ("gen", "pos"):  # a whole A and a split b: heat_tpu refuses 37 rows over 4 devices
        out[f"fact_solve_whole_{assume}"] = lambda assume=assume: case(
            lambda L, kw: L.linalg.solve(L.array(fact_matrix("gen" if assume == "gen" else "spd", (37, 37), seed=36)),
                                         L.array(fact_matrix("tall", (37, 3), seed=37), split=0), assume_a=assume))
    return out


# the estimators across ranks (tests/test_torch_estimators.py,
# tests/test_torch_spectral.py): the same operands for both packages
DATASETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "heat_tpu", "datasets")
EST_SCALERS = ("StandardScaler", "MinMaxScaler", "Normalizer", "MaxAbsScaler", "RobustScaler")
SCALER_ATTRS = ("mean_", "var_", "data_min_", "data_max_", "data_range_", "min_", "scale_", "max_abs_", "center_",
                "iqr_")
KNN_KS = (1, 5)
SPECTRAL_SEED, SPECTRAL_LANCZOS = 7, 40
EMBED_N, EMBED_K, EMBED_M = 150, 3, 24


def iris():
    """Iris's 150 x 4 float32 features and int64 labels, read with numpy."""
    x = np.loadtxt(os.path.join(DATASETS, "iris.csv"), delimiter=";").astype(np.float32)
    y = np.loadtxt(os.path.join(DATASETS, "iris_labels.csv")).astype(np.int64)
    return x, y


def lasso_data(n=203, f=12, seed=31):
    """y = Xθ* + 0.3 + noise with 4 of 12 coefficients non-zero, float32;
    203 rows are ragged over 4 ranks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    theta = np.zeros(f, np.float32)
    theta[:4] = [2.0, -1.5, 1.0, 0.5]
    return x, (x @ theta + 0.3 + 0.01 * rng.standard_normal(n)).astype(np.float32)


def knn_ties():
    """Training rows where a query at the origin meets its k = 3 nearest
    through a tie: row 0 (label 2) at distance 1, rows 1-7 at distance 3,
    row 1 labelled 2 and the rest 1. Taking the tie's lowest index (row 1,
    as ``top_k`` does) votes 2; any other pick votes 1. Over 4 ranks the
    tied rows lie on every rank. Queries: the origin and three others."""
    xt = np.array([[1, 0], [0, 3], [3, 0], [-3, 0], [0, -3], [0, 3], [3, 0], [-3, 0]], np.float32)
    yt = np.array([2, 2, 1, 1, 1, 1, 1, 1], np.int64)
    xq = np.array([[0, 0], [0, 0.5], [2.5, 0], [0, -2.5]], np.float32)
    return xt, yt, xq


def similarity(seed=41):
    """A fixed symmetric 150 x 150 float32 similarity in (0, 1] with unit
    diagonal, so that the Laplacians of both packages start from the same
    bits."""
    x, _ = iris()
    d2 = ((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2 / 2.0).astype(np.float32)


def graph_adjacency(n=EMBED_N, seed=43):
    """A symmetric 0/1 float32 adjacency of n nodes, about 6% dense, no
    self-loops, every node connected."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.03).astype(np.float32)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0.0)
    ring = np.arange(n)
    a[ring, (ring + 1) % n] = a[(ring + 1) % n, ring] = 1.0
    return a


def scaler_attrs(model) -> dict:
    """The fitted statistics of a scaler as numpy (DNDarrays and raw arrays
    alike)."""
    out = {}
    for name in SCALER_ATTRS:
        v = getattr(model, name, None)
        if v is not None:
            out[name] = v.numpy() if hasattr(v, "numpy") and hasattr(v, "split") else _np(v) if hasattr(v, "detach") \
                else np.asarray(v)
    return out


def _estimator_cases(ht):
    comm = ht.get_comm()
    cases = {}
    x_np, y_np = iris()

    def counted(fn):
        comm.counts.clear()
        res = fn()
        return res, dict(comm.counts)

    for name in EST_SCALERS:
        for split in (0, 1):
            def scaler_case(name=name, split=split):
                x = ht.array(x_np, split=split)
                model, counts = counted(lambda: getattr(ht.preprocessing, name)().fit(x))
                t = model.transform(x)
                back = model.inverse_transform(t).numpy() if hasattr(model, "inverse_transform") else None
                return {"attrs": scaler_attrs(model), "local": _np(t.larray), "split": t.split, "global": t.numpy(),
                        "inverse": back, "counts": counts}
            cases[f"est_{name}_{split}"] = scaler_case

    def gnb(model, x, *fit_args, **fit_kw):
        _, counts = counted(lambda: model.fit(x, *fit_args, **fit_kw))
        return {"theta": model.theta_.numpy(), "var": model.var_.numpy(), "count": model.class_count_.numpy(),
                "prior": model.class_prior_.numpy(), "classes": model.classes_.numpy(), "epsilon": model.epsilon_,
                "proba": model.predict_proba(x).numpy(), "predict": model.predict(x), "counts": counts}

    cases["est_gnb_0"] = lambda: gnb(ht.naive_bayes.GaussianNB(), ht.array(x_np, split=0), ht.array(y_np, split=0))
    cases["est_gnb_whole_labels"] = lambda: gnb(ht.naive_bayes.GaussianNB(), ht.array(x_np, split=0), ht.array(y_np))
    cases["est_gnb_weights"] = lambda: gnb(ht.naive_bayes.GaussianNB(), ht.array(x_np, split=0),
                                           ht.array(y_np, split=0),
                                           sample_weight=ht.array(np.linspace(0.5, 2.0, 150, dtype=np.float32), split=0))

    def gnb_partial():
        model = ht.naive_bayes.GaussianNB()
        model.partial_fit(ht.array(x_np[::2], split=0), ht.array(y_np[::2], split=0),
                          classes=ht.array(np.arange(3, dtype=np.int64)))
        model.partial_fit(ht.array(x_np[1::2], split=0), ht.array(y_np[1::2], split=0))
        return {"theta": model.theta_.numpy(), "var": model.var_.numpy(), "count": model.class_count_.numpy(),
                "proba": model.predict_proba(ht.array(x_np, split=0)).numpy()}
    cases["est_gnb_partial"] = gnb_partial

    def lasso(y_split):
        xl, yl = lasso_data()
        model = ht.regression.Lasso(lam=0.05)
        x, y = ht.array(xl, split=0), ht.array(yl, split=y_split)
        _, counts = counted(lambda: model.fit(x, y))
        pred = model.predict(x)
        return {"theta": model.theta.numpy(), "n_iter": model.n_iter, "counts": counts, "predict": pred.numpy(),
                "predict_split": pred.split, "rmse": model.rmse(y, pred)}
    cases["est_lasso_0"] = lambda: lasso(0)
    cases["est_lasso_whole_y"] = lambda: lasso(None)

    for k in KNN_KS:
        def knn_iris(k=k):
            model = ht.classification.KNeighborsClassifier(k).fit(ht.array(x_np, split=0), ht.array(y_np, split=0))
            labels, counts = counted(lambda: model.predict(ht.array(x_np[::3], split=0)))
            return {"labels": labels.numpy(), "split": labels.split, "counts": counts}
        cases[f"est_knn_iris_{k}"] = knn_iris

    def knn_tied():
        xt, yt, xq = knn_ties()
        model = ht.classification.KNeighborsClassifier(3).fit(ht.array(xt, split=0), ht.array(yt, split=0))
        return {"labels": model.predict(ht.array(xq, split=0)).numpy(),
                "one_hot": ht.classification.KNeighborsClassifier.one_hot_encoding(ht.array(yt, split=0)).numpy()}
    cases["est_knn_ties"] = knn_tied

    s_np = similarity()
    for definition in ("simple", "norm_sym"):
        for mode in ("fully_connected", "eNeighbour"):
            def laplacian(definition=definition, mode=mode):
                lap = ht.graph.Laplacian(lambda x: ht.array(s_np, split=x.split), definition=definition, mode=mode,
                                         threshold_key="lower", threshold_value=0.3)
                L, counts = counted(lambda: lap.construct(ht.array(x_np, split=0)))
                return {"global": L.numpy(), "local": _np(L.larray), "split": L.split, "counts": counts}
            cases[f"est_laplacian_{definition}_{mode}"] = laplacian

    def spectral():
        ht.random.seed(SPECTRAL_SEED)
        model = ht.cluster.Spectral(n_clusters=3, gamma=1.0, n_lanczos=SPECTRAL_LANCZOS)
        model.fit(ht.array(x_np, split=0))
        return {"labels": model.labels_.numpy(), "split": model.labels_.split}
    cases["est_spectral"] = spectral

    def embedding():
        evals, emb = ht.graph.spectral_embedding(graph_adjacency(), EMBED_K, m=EMBED_M)
        return {"evals": evals, "embedding": emb.numpy(), "split": emb.split}
    cases["est_embedding_replicated"] = embedding
    def embedding_split():
        evals, emb = ht.graph.spectral_embedding(ht.array(graph_adjacency(), split=0), EMBED_K)
        return {"evals": evals, "embedding": emb.numpy(), "split": emb.split}
    cases["est_embedding_split"] = embedding_split
    return cases


# the sparse engine across ranks (tests/test_torch_sparse_dist.py): the
# same operands for both packages
SPARSE_ROWS = {"ragged": 37, "last_empty": 9, "straddle": 45}  # 10,10,10,7; 3,3,3,0; 12,12,12,9 rows a rank
SPARSE_COLS = 300
SPARSE_IS_SPLIT_ROWS = (2, 5, 0, 30)  # the blocks of is_split=0: another row map than the chunks'
SPARSE_K = 3
SPARSE_D = 5


def sparse_operand(m, n=SPARSE_COLS, density=0.05, seed=0):
    """A float32 scipy CSR (m, n), ``density`` dense, from ``seed``; every
    row of the last brick row but one is empty past ``m``."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=density, format="csr", dtype=np.float32, random_state=rng)


def sparse_dense_x(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k) if k else (n,)).astype(np.float32)


def pagerank_graph(n=60, seed=5):
    """A random directed 0/1 adjacency of n nodes with dangling nodes."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.08).astype(np.float32)
    np.fill_diagonal(a, 0.0)
    a[rng.choice(n, 5, replace=False)] = 0.0  # dangling: no out-edges
    return a


def _dcsr_state(D):
    """A DCSR matrix's local and global components and dense form."""
    dense = D.todense()
    indptr, indices, data = D.global_components()
    return {"lindptr": _np(D.lindptr), "lindices": _np(D.lindices), "ldata": _np(D.ldata), "lnnz": D.lnnz,
            "gnnz": D.gnnz, "shape": D.shape, "split": D.split, "balanced": D.balanced,
            "row_counts": tuple(D.row_counts), "indptr": _np(indptr), "indices": _np(indices),
            "data": _np(data), "dense": dense.numpy(), "dense_local": _np(dense.larray),
            "dense_split": dense.split}


def _dbcsr_state(B):
    bdata, bcol, brow, bmask = B._phys_components
    return {"bdata": _np(bdata), "bcol": _np(bcol), "brow": _np(brow), "bmask": _np(bmask),
            "slab_meta": B._slab_meta, "gnnz": B.gnnz, "nbricks": B.nbricks, "occupancy": B.occupancy,
            "dense": B.todense().numpy(), "dense_local": _np(B.todense().larray), "dcsr": _dcsr_state(B.to_dcsr())}


def _sparse_cases(ht):
    comm = ht.get_comm()
    cases = {}

    def counted(call):
        comm.counts.clear()
        out = call()
        return out, dict(comm.counts)

    def product(out, counts):
        return {"local": _np(out.larray), "global": out.numpy(), "split": out.split, "gshape": out.gshape,
                "lshape": out.lshape, "counts": counts}

    for label, m in SPARSE_ROWS.items():
        csr = sparse_operand(m, seed=m)
        cases[f"sp_csr_{label}"] = lambda csr=csr: _dcsr_state(ht.sparse.sparse_csr_matrix(csr, split=0))
        cases[f"sp_dbcsr_{label}"] = lambda csr=csr: _dbcsr_state(ht.sparse.sparse_dbcsr_matrix(csr, split=0))
        for fmt in ("dcsr", "dbcsr"):
            for x_kind in ("whole", "split0", "split1", "vector"):
                def matmul(csr=csr, fmt=fmt, x_kind=x_kind, m=m):
                    make = ht.sparse.sparse_csr_matrix if fmt == "dcsr" else ht.sparse.sparse_dbcsr_matrix
                    A = make(csr, split=0)
                    x = sparse_dense_x(SPARSE_COLS, 0 if x_kind == "vector" else SPARSE_K, seed=m + 1)
                    if x_kind in ("split0", "split1"):
                        x = ht.array(x, split=int(x_kind[-1]))
                    return product(*counted(lambda: A @ x))
                cases[f"sp_matmul_{fmt}_{x_kind}_{label}"] = matmul
        for u_split, v_split in ((None, None), (0, None), (0, 0), (1, 1)):
            def sddmm(csr=csr, u_split=u_split, v_split=v_split, m=m):
                S = ht.sparse.sparse_dbcsr_matrix(csr, split=0)
                u = ht.array(sparse_dense_x(m, SPARSE_D, seed=m + 2), split=u_split)
                v = ht.array(sparse_dense_x(SPARSE_COLS, SPARSE_D, seed=m + 3), split=v_split)
                C, counts = counted(lambda: ht.sparse.sddmm(S, u, v))
                return {**_dbcsr_state(C), "counts": counts}
            cases[f"sp_sddmm_{u_split}_{v_split}_{label}"] = sddmm
        whole = ht.sparse.sparse_dbcsr_matrix(csr)
        cases[f"sp_matmul_dbcsr_replicated_{label}"] = lambda whole=whole, m=m: product(
            *counted(lambda: whole @ sparse_dense_x(SPARSE_COLS, SPARSE_K, seed=m + 1)))

    big = sparse_operand(sum(SPARSE_IS_SPLIT_ROWS), seed=40)
    starts = np.cumsum((0,) + SPARSE_IS_SPLIT_ROWS)
    mine = big[starts[comm.rank] : starts[comm.rank + 1]]

    def is_split():
        blocks = [mine[:1], mine[1:]] if mine.shape[0] > 1 else mine  # rank 1 stitches two blocks
        D, counts = counted(lambda: ht.sparse.sparse_csr_matrix(blocks, is_split=0))
        return {**_dcsr_state(D), "counts": counts}
    cases["sp_csr_is_split"] = is_split

    def arithmetic(op, kind):
        a = sparse_operand(37, seed=50)
        b = sparse_operand(37, seed=51)
        A = ht.sparse.sparse_csr_matrix(a, split=0)
        if kind == "same_map":
            B = ht.sparse.sparse_csr_matrix(b, split=0)
        elif kind == "whole":
            B = ht.sparse.sparse_csr_matrix(b)
        else:  # another row map: moved to A's
            starts = np.cumsum((0, 20, 0, 10, 7))
            B = ht.sparse.sparse_csr_matrix(b[starts[comm.rank] : starts[comm.rank + 1]], is_split=0)
        f = ht.sparse.sparse_add if op == "add" else ht.sparse.sparse_mul
        C, counts = counted(lambda: f(A, B))
        return {**_dcsr_state(C), "counts": counts}
    for op in ("add", "mul"):
        for kind in ("same_map", "whole", "other_map"):
            cases[f"sp_{op}_{kind}"] = lambda op=op, kind=kind: arithmetic(op, kind)

    def property_reads():
        D = ht.sparse.sparse_csr_matrix(sparse_operand(37, seed=50), split=0)
        sizes, size_counts = counted(lambda: (D.gnnz, D.nnz, D.lnnz, D.shape, D.lshape))
        try:
            D.indptr
            early = None
        except RuntimeError as e:
            early = str(e)
        gathered, gather_counts = counted(D.global_components)
        after, after_counts = counted(lambda: (D.indptr, D.indices, D.data, D.global_components()))
        return {"sizes": sizes, "size_counts": size_counts, "early": early, "gather_counts": gather_counts,
                "after_counts": after_counts, "same": all(a is b for a, b in zip(after[:3], gathered)),
                "indptr": _np(gathered[0]), "indices": _np(gathered[1]), "data": _np(gathered[2])}
    cases["sp_csr_property_reads"] = property_reads

    def scalar_mul():
        A = ht.sparse.sparse_csr_matrix(sparse_operand(37, seed=50), split=0)
        C, counts = counted(lambda: A * 2.5)
        return {**_dcsr_state(C), "counts": counts}
    cases["sp_mul_scalar"] = scalar_mul

    def to_dense_unbalanced():
        D = ht.sparse.sparse_csr_matrix(mine, is_split=0)
        dense, counts = counted(lambda: ht.sparse.to_dense(D))
        return {"local": _np(dense.larray), "global": dense.numpy(), "split": dense.split, "counts": counts,
                "lshape": dense.lshape}
    cases["sp_to_dense_is_split"] = to_dense_unbalanced

    for split in (0, 1):
        def to_sparse(split=split):
            x = ht.array(sparse_operand(37, seed=52).toarray(), split=split)
            D, counts = counted(lambda: ht.sparse.to_sparse(x))
            return {**_dcsr_state(D), "counts": counts}
        cases[f"sp_to_sparse_{split}"] = to_sparse

    for split in (0, None):
        def pagerank(split=split):
            res, counts = counted(lambda: ht.graph.pagerank(pagerank_graph(), split=split))
            return {"local": _np(res.ranks.larray), "global": res.ranks.numpy(), "split": res.ranks.split,
                    "iterations": res.iterations, "converged": res.converged, "delta": res.delta, "counts": counts}
        cases[f"sp_pagerank_{split}"] = pagerank

    def embedding(form):
        a = graph_adjacency()
        A = ht.sparse.sparse_dbcsr_matrix(a, split=0) if form == "dbcsr" else ht.array(a, split=0)
        (evals, emb), counts = counted(lambda: ht.graph.spectral_embedding(A, EMBED_K, m=EMBED_M))
        return {"evals": evals, "embedding": emb.numpy(), "local": _np(emb.larray), "split": emb.split,
                "counts": counts}
    cases["sp_embedding_dbcsr"] = lambda: embedding("dbcsr")
    return cases


# I/O, checkpoints and the sparse encoders across ranks
# (tests/test_torch_io.py): every file lives in the world's directory
IO_SHAPE = (37, 5)  # 10, 10, 10, 7 rows; 2, 2, 1, 0 columns over 4 ranks
IO_CODES = (37, 3)  # integer codes, a few categories each
IO_CHECKPOINT_TREE = ("x0", "x1", "xn", "bf16", "counts", "t", "np", "meta")


def io_array(shape=IO_SHAPE, seed=60):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def io_codes(shape=IO_CODES, seed=61):
    return np.random.default_rng(seed).integers(0, 6, shape).astype(np.int64) * 3 - 4


def io_counts(shape=(37, 12), seed=62):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, shape) * (rng.random(shape) < 0.3)).astype(np.float32)


def checkpoint_tree(ht, comm=None):
    """The tree of the checkpoint cases: DNDarrays split 0, 1 and None, a
    bfloat16 one, an int64 one, a tensor, a numpy array and scalars."""
    import torch

    a = io_array()
    kw = {} if comm is None else {"comm": comm}
    return {"x0": ht.array(a, split=0, **kw), "x1": ht.array(a, split=1, **kw), "xn": ht.array(a, **kw),
            "bf16": ht.array(a, split=0, dtype=ht.bfloat16, **kw),
            "counts": ht.array(io_codes(), split=0, **kw), "t": torch.arange(6, dtype=torch.float64) / 7,
            "np": np.arange(5, dtype=np.int16), "meta": {"step": 3, 7: (1.5, "adam", None)}}


def _leaves(tree):
    """The checkpoint tree's leaves as plain values: a DNDarray as (local,
    global, split), bfloat16 as its int16 words."""
    import torch

    out = {}
    for k, v in tree.items():
        if hasattr(v, "larray"):
            words = (lambda t: t.view(torch.int16).numpy()) if v.dtype.__name__ == "bfloat16" else _np
            full = v.larray if not v.is_distributed() else v.comm.allgather(v.larray.contiguous(), v.split,
                                                                            v.lshape_map[:, v.split])
            out[k] = {"local": words(v.larray.cpu()), "global": words(full.cpu()), "split": v.split,
                      "dtype": v.dtype.__name__}
        elif hasattr(v, "detach"):
            out[k] = {"tensor": _np(v), "dtype": str(v.dtype)}
        else:
            out[k] = v
    return out


def _io_cases(ht):
    comm = ht.get_comm()
    cases = {}

    def path(name):
        return os.path.join(_OUT["dir"], name)

    cases["io_dir"] = lambda: {"dir": _OUT["dir"]}

    def counted(call):
        comm.counts.clear()
        out = call()
        return out, dict(comm.counts)

    def loaded(x, counts):
        return {"local": _np(x.larray), "global": x.numpy(), "split": x.split, "gshape": x.gshape,
                "counts": counts, "dtype": x.dtype.__name__}

    def csv_load(split, header):
        name = f"io_in_{header}.csv"
        if comm.rank == 0:
            with open(path(name), "w") as fh:
                fh.write("".join(f"# header {i}\n" for i in range(header)))
                np.savetxt(fh, io_array(), delimiter=",", fmt="%s")
        comm.barrier()
        return loaded(*counted(lambda: ht.load_csv(path(name), header_lines=header, split=split)))
    for split in (None, 0, 1):
        for header in (0, 2):
            cases[f"io_csv_load_{split}_{header}"] = lambda split=split, header=header: csv_load(split, header)

    def csv_save(split, kind):
        a = io_array() if kind != "int" else io_codes()
        kw = {"header_lines": ["a", "b"]} if kind == "header" else {"decimals": 3} if kind == "decimals" else {}
        x = ht.array(a if kind != "vector" else a[:, 0], split=split if kind != "vector" or split != 1 else 0)
        _, counts = counted(lambda: ht.save_csv(x, path(f"io_out_{split}_{kind}.csv"), **kw))
        return {"counts": counts}
    for split in (None, 0, 1):
        for kind in ("float", "int", "header", "decimals", "vector"):
            cases[f"io_csv_save_{split}_{kind}"] = lambda split=split, kind=kind: csv_save(split, kind)

    def hdf5(split):
        if not ht.supports_hdf5():
            return {"skipped": "no h5py"}
        x = ht.array(io_array(), split=split)
        ht.save(x, path(f"io_{split}.h5"), "data")
        back, counts = counted(lambda: ht.load(path(f"io_{split}.h5"), "data", split=split))
        half = ht.load_hdf5(path(f"io_{split}.h5"), "data", split=0, load_fraction=0.5)
        return {**loaded(back, counts), "half": half.numpy(), "half_local": _np(half.larray)}
    for split in (None, 0, 1):
        cases[f"io_hdf5_{split}"] = lambda split=split: hdf5(split)

    def checkpoint_4():
        tree = checkpoint_tree(ht)
        ht.utils.save_checkpoint(path("ckpt4"), tree)
        back, counts = counted(lambda: ht.utils.load_checkpoint(path("ckpt4")))
        return {"saved": _leaves(tree), "loaded": _leaves(back), "counts": counts}
    cases["io_checkpoint_4_to_4"] = checkpoint_4

    def checkpoint_1():  # written as a world of one rank writes it: arrays whole, on rank 0
        tree = checkpoint_tree(ht, comm=ht.MPI_SELF)
        ht.utils.save_checkpoint(path("ckpt1"), tree)
        return {"loaded": _leaves(ht.utils.load_checkpoint(path("ckpt1")))}
    cases["io_checkpoint_1_to_4"] = checkpoint_1

    def onehot(split, sparse_output):
        x = ht.array(io_codes(), split=split)
        enc = ht.preprocessing.OneHotEncoder(sparse_output=sparse_output)
        (enc, fit_counts) = counted(lambda: enc.fit(x))
        out, counts = counted(lambda: enc.transform(x))
        res = {"categories": enc.categories_, "fit_counts": fit_counts, "counts": counts}
        if sparse_output:
            return {**res, **_dcsr_state(out)}
        return {**res, "global": out.numpy(), "local": _np(out.larray), "split": out.split}
    for split in (0, 1):
        for sparse_output in (True, False):
            cases[f"io_onehot_{split}_{sparse_output}"] = lambda split=split, s=sparse_output: onehot(split, s)

    def tfidf(form):
        c = io_counts()
        x = ht.array(c, split=0) if form == "dense" else ht.sparse.sparse_csr_matrix(c, split=0)
        t = ht.preprocessing.TfidfTransformer()
        (t, fit_counts) = counted(lambda: t.fit(x))
        out, counts = counted(lambda: t.transform(x))
        return {"idf": t.idf_, "fit_counts": fit_counts, "counts": counts, **_dcsr_state(out)}
    for form in ("dense", "dcsr"):
        cases[f"io_tfidf_{form}"] = lambda form=form: tfidf(form)

    def partial():
        if not ht.supports_hdf5():
            return {"skipped": "no h5py"}
        import h5py

        if comm.rank == 0:
            with h5py.File(path("io_partial.h5"), "w") as f:
                f["data"] = io_array((50, 4), seed=63)
                f["labels"] = np.arange(50, dtype=np.int64)
        comm.barrier()
        ds = ht.utils.data.PartialH5Dataset(path("io_partial.h5"), ["data", "labels"], batch_size=8,
                                            initial_load=20)
        batches = [(_np(d.larray), d.numpy(), _np(l.larray), l.split) for d, l in ds]
        ds.Shuffle()
        shuffled = [(d.numpy(), l.numpy(), _np(d.larray)) for d, l in ds]
        return {"batches": batches, "shuffled": shuffled, "len": len(ds)}
    cases["io_partial_h5"] = partial
    return cases


# the distributed runtime's wire (tests/test_torch_quant.py,
# tests/test_torch_overlap.py): the codec's all-reduces, a quantized
# resplit, data-parallel training on the quantized wire, and the rings
WIRE_N = 5000  # a flat vector over 4 ranks: blocks of 1250, ragged tiles
WIRE_MODES = ("int8", "bf16")
WIRE_TOPOLOGIES = ("flat", "2x2")
WIRE_RESPLIT = (1024, 768)  # 3 MiB, split 0 -> 1: large enough that 2x2 plans the hierarchical form
WIRE_MIN_GROUP = 1024  # the codec's group threshold, lowered alike in both planners
WIRE_DP_STEPS = 3
RING_QR = {"tall": (50, 7), "short_last": (9, 3)}
RING_MATMUL = ((13, 22), (22, 5))  # a split 1, b split 0: 6, 6, 6, 4 contraction columns
RING_FACT_N = 37  # polar, lu, solve: blocks of 10 rows, the last 7


def wire_vector(rank: int, n: int = WIRE_N) -> np.ndarray:
    """Rank r's flat float32 vector, with a NaN-free wide range."""
    rng = np.random.default_rng(300 + rank)
    return (rng.standard_normal(n) * 10.0 ** rng.integers(-2, 3, n)).astype(np.float32)


def wire_matrix(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(400 + seed).standard_normal(shape).astype(np.float32)


@contextlib.contextmanager
def wire_env(**gates):
    """Set ``HEAT_TPU_<name>`` gates for the call, restoring them after."""
    old = {k: os.environ.get("HEAT_TPU_" + k) for k in gates}
    os.environ.update({"HEAT_TPU_" + k: str(v) for k, v in gates.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop("HEAT_TPU_" + k, None)
            else:
                os.environ["HEAT_TPU_" + k] = v


def _wire_cases(ht):
    from unittest import mock

    import torch

    from heat_tpu_torch.kernels import quant
    from heat_tpu_torch.redistribution import planner

    comm = ht.get_comm()
    cases = {}

    def counted(call):
        comm.counts.clear()
        out = call()
        return out, dict(comm.counts)

    for mode in WIRE_MODES:
        def allreduce(mode=mode):
            h = torch.from_numpy(wire_vector(comm.rank))
            (flat, resid), counts = counted(lambda: quant.quantized_allreduce_sum(h, comm, mode))
            (hier, hresid), hcounts = counted(lambda: quant.hierarchical_allreduce_sum(h, comm, 2, 2, mode))
            return {"sum": _np(flat), "resid": _np(resid), "counts": counts, "hier_sum": _np(hier),
                    "hier_resid": _np(hresid), "hier_counts": hcounts}
        cases[f"wire_allreduce_{mode}"] = allreduce

    def resplit(wire, topology):
        a = wire_matrix(WIRE_RESPLIT, 1)
        old = planner.QUANT_MIN_WIRE_BYTES
        planner.QUANT_MIN_WIRE_BYTES = WIRE_MIN_GROUP
        try:
            with wire_env(WIRE_QUANT=wire, TOPOLOGY=topology):
                x = ht.array(a, split=0)
                sched = planner.plan(planner.RedistSpec.normalize(a.shape, "float32", 0, 1, comm.size))
                y, counts = counted(lambda: x.resplit(1))
        finally:
            planner.QUANT_MIN_WIRE_BYTES = old
            planner.clear_plan_cache()
        return {"local": _np(y.larray), "counts": counts, "plan_counts": sched.collective_counts(),
                "strategy": sched.strategy, "quant": sched.quant["mode"] if sched.quant else None}
    for wire in ("1", "bf16", "0"):
        for topology in WIRE_TOPOLOGIES:
            cases[f"wire_resplit_{wire}_{topology}"] = lambda wire=wire, topology=topology: resplit(wire, topology)

    def dp(mode, topology):
        x, y = train_data("mlp", 30)
        seen = []  # the codec's input a step, h = gradient + carry

        def recorded(fn):
            def call(h, *args):
                seen.append(_np(h).copy())
                return fn(h, *args)
            return call
        with wire_env(TOPOLOGY=topology), mock.patch.object(
                quant, "quantized_allreduce_sum", recorded(quant.quantized_allreduce_sum)), mock.patch.object(
                quant, "hierarchical_allreduce_sum", recorded(quant.hierarchical_allreduce_sum)):
            model = ht.nn.DataParallel(train_mlp(ht.nn), key=13)
            dpo = ht.optim.DataParallelOptimizer(train_optimizer(ht.optim, "sgd"), model, wire_quant=mode)
            X, Y = ht.array(x, split=0), ht.array(y, split=0)
            steps = []
            for _ in range(WIRE_DP_STEPS):
                loss, counts = counted(lambda: dpo.step(X, Y))
                steps.append({"loss": float(loss), "params": [_np(p).copy() for p in model.module.parameters()],
                              "carry": _np(dpo._ef_carry).copy(), "counts": counts, "h": seen[-1]})
            state = dpo.checkpoint_state()
            other = ht.optim.DataParallelOptimizer(train_optimizer(ht.optim, "sgd"),
                                                   ht.nn.DataParallel(train_mlp(ht.nn), key=13), wire_quant=mode)
            other.load_checkpoint_state(state)
        return {"steps": steps, "ef_rows": _np(state["ef_carry"]), "restored": _np(other._ef_carry)}
    for mode in WIRE_MODES:
        for topology in WIRE_TOPOLOGIES:
            cases[f"wire_dp_{mode}_{topology}"] = lambda mode=mode, topology=topology: dp(mode, topology)

    # the rings: each call under HEAT_TPU_REDIST_OVERLAP=1 and =0
    def both(call, topology="flat"):
        out = {}
        for overlap in ("1", "0"):
            with wire_env(REDIST_OVERLAP=overlap, TOPOLOGY=topology):
                res, counts = counted(call)
            parts = res if isinstance(res, (list, tuple)) else [res]
            out[overlap] = {"parts": [_np(p.larray) if hasattr(p, "larray") else _np(p) if hasattr(p, "detach")
                                      else np.asarray(p) for p in parts if p is not None], "counts": counts}
        return out

    for label, shape in RING_QR.items():
        for topology in WIRE_TOPOLOGIES:
            cases[f"ring_qr_{label}_{topology}"] = lambda shape=shape, topology=topology: both(
                lambda: ht.linalg.qr(ht.array(wire_matrix(shape, 2), split=0)), topology)
    cases["ring_matmul"] = lambda: both(lambda: ht.matmul(ht.array(wire_matrix(RING_MATMUL[0], 3), split=1),
                                                          ht.array(wire_matrix(RING_MATMUL[1], 4), split=0)))
    n = RING_FACT_N
    cases["ring_polar"] = lambda: both(lambda: ht.linalg.polar(ht.array(fact_matrix("gen", (n, n), seed=50), split=0)))
    cases["ring_lu"] = lambda: both(lambda: ht.linalg.lu(ht.array(fact_matrix("gen", (n, n), seed=51), split=0)))
    cases["ring_cholesky"] = lambda: both(lambda: ht.linalg.cholesky(ht.array(fact_matrix("spd", (n, n), seed=52),
                                                                             split=0)))
    for assume in ("gen", "pos"):
        cases[f"ring_solve_{assume}"] = lambda assume=assume: both(lambda: ht.linalg.solve(
            ht.array(fact_matrix("gen" if assume == "gen" else "spd", (n, n), seed=53), split=0),
            ht.array(fact_matrix("tall", (n, 3), seed=54), split=0), assume_a=assume))
    cases["ring_hsvd"] = lambda: both(lambda: ht.linalg.hsvd_rank(ht.array(rank8(HSVD_SHAPE), split=0), 8,
                                                                  compute_sv=True))
    return cases


def _plain(value):
    """Results as plain values: DNDarrays and tensors become numpy."""
    if hasattr(value, "larray"):
        return value.numpy()
    if hasattr(value, "detach"):
        return _np(value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_plain(v) for v in value)
    return value


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch.distributed as dist

    import heat_tpu_torch as ht

    ht.use_device("cpu")
    ht.init_distributed(backend="gloo", init_method=f"file://{init_file}", world_size=world, rank=rank)
    _OUT["dir"] = out_dir
    results = {}
    try:
        for name, case in _cases(ht).items():
            try:
                results[name] = _plain(case())
            except Exception as e:  # noqa: BLE001 (every outcome is a result the test judges)
                results[name] = {"error": (type(e).__name__, str(e)), "trace": traceback.format_exc()}
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()
