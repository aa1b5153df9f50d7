"""One rank of the 4-rank gloo world of tests/test_torch_distributed.py.

``run(rank, world, init_file, out_dir)`` joins a ``torch.distributed``
world through ``init_method=file://init_file`` (no TCP port), runs every
case of ``CASES`` on heat_tpu_torch, and pickles {case: result} to
``out_dir/rank<r>.pkl``. A result is a dict of plain values and numpy
arrays, or ``{"error": (type name, message)}``. This module imports
neither heat_tpu nor jax (pytest does not collect it).
"""

import os
import pickle
import traceback

import numpy as np


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
        "hsvd_rank": lambda: ht.linalg.hsvd_rank(split_x((64, 16)), 4),
        "hsvd": lambda: ht.linalg.hsvd(split_x((64, 16)), maxrank=4),
        "sort_split_axis": lambda: ht.sort(split_x((40,))),
        "topk_split_axis": lambda: ht.topk(split_x((40,)), 3),
        "unique": lambda: ht.unique(split_x((40,))),
        "flip_split_axis": lambda: ht.flip(split_x(), 0),
        "kmeans_fit": lambda: ht.cluster.KMeans(3).fit(split_x()),
        "kmedians_fit": lambda: ht.cluster.KMedians(3).fit(split_x()),
        "kmedoids_fit": lambda: ht.cluster.KMedoids(3).fit(split_x()),
        "kmeans_predict": lambda: ht.cluster.KMeans(3, init="kmeans++").fit(split_x(split=None)).predict(split_x()),
        "cdist": lambda: ht.spatial.cdist(split_x(), split_x(split=None)),
        "sparse_csr_split": lambda: ht.sparse.sparse_csr_matrix(np.eye(8, dtype=np.float32), split=0),
        "sparse_dbcsr_split": lambda: ht.sparse.sparse_dbcsr_matrix(np.eye(8, dtype=np.float32), split=0),
        "sparse_matmul_split_x": lambda: ht.sparse.matmul(
            ht.sparse.sparse_csr_matrix(np.eye(40, dtype=np.float32)), split_x()),
        "sddmm_split_u": lambda: ht.sparse.sddmm(
            ht.sparse.sparse_dbcsr_matrix(np.eye(40, 6, dtype=np.float32)), split_x((40, 4)), split_x((6, 4), None)),
        "pagerank": lambda: ht.graph.pagerank(np.ones((8, 8), dtype=np.float32)),
        "ring_attention": lambda: ht.nn.ring_attention(*(split_x((2, 8, 4), 1) for _ in range(3))),
    }
    for name, call in entry.items():
        cases[f"entry_{name}"] = lambda call=call: {"value": call()}

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
