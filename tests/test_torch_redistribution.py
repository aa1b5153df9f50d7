"""heat_tpu_torch.redistribution against heat_tpu.redistribution.

* Plan parity: for heat_tpu's 19 golden specs, the p = 4 moves whose
  strategy decides whether the relayout kernels run, and a small budget
  that forces chunked laps, the port's plan serializes byte for byte as
  heat_tpu's (``canonical_json``, hence ``plan_id``) at the default
  budget, ``quant="0"`` and ``topology="flat"``, and renders the same
  ``describe()``.
* Execution: the executor's per-rank bodies, run for all ranks in one
  process (``LocalWorld``, the stand-in exchange ``chip_smoke.py`` uses on
  the card), give every rank exactly the shard heat_tpu places on that
  device after the same resplit or reshape on its 8-device CPU mesh, bit
  for bit, with the collectives the plan counts.
"""

import numpy as np
import pytest
import torch

import heat_tpu as jht
from heat_tpu.redistribution import RedistSpec as JSpec, planner as jplanner
from heat_tpu_torch.redistribution import RedistSpec, executor, planner

S = RedistSpec.normalize
BUDGET = planner.DEFAULT_BUDGET_MB << 20

# p = 4 moves of the 1 GB row and the small shapes where the packed pivot
# (and so K5/K6) is chosen at 4 ranks
P4_SPECS = [
    ("reshape_split1_1gb_p4", ((1000, 250000), "float32", 1, 1, 4, (10_000_000, 25))),
    ("reshape_split1_1gb_rev_p4", ((10_000_000, 25), "float32", 1, 1, 4, (1000, 250000))),
    ("reshape_packed_p4", ((2048, 64), "float32", 1, 1, 4, (8192, 16))),
    ("reshape_packed_rev_p4", ((8192, 16), "float32", 1, 1, 4, (2048, 64))),
    ("reshape_pivot_p4", ((40960, 40), "float32", 1, 1, 4, (20480, 80))),
    ("reshape_bf16_p4", ((2048, 64), "bfloat16", 1, 1, 4, (8192, 16))),
    ("resplit_ragged_3d_p4", ((5, 7, 3), "int64", 2, 0, 4, None)),
]
P4_STRATEGIES = {
    "reshape_split1_1gb_p4": ("split0-pivot", {"all-to-all": 8}),
    "reshape_split1_1gb_rev_p4": ("split0-pivot", {"all-to-all": 12}),
    "reshape_packed_p4": ("packed-pivot", {"all-to-all": 2}),
    "reshape_packed_rev_p4": ("packed-pivot", {"all-to-all": 2}),
    "reshape_pivot_p4": ("packed-pivot", {"all-to-all": 2}),
}
GOLDEN_STRATEGIES = {
    "reshape_split1_1gb_p8": ("packed-pivot", {"all-to-all": 9}),
    "reshape_packed_rev_p8": ("packed-pivot", {"all-to-all": 9}),
    "resplit_ring_8gb_p8": ("ring", {"collective-permute": 7}),
    "resplit_chunked_2gb_p8": ("chunked-all-to-all", {"all-to-all": 4}),
}


def _both(gshape, dtype, src, dst, p, reshape_to=None):
    kw = {} if reshape_to is None else {"reshape_to": reshape_to}
    return S(gshape, dtype, src, dst, p, **kw), JSpec.normalize(gshape, dtype, src, dst, p, **kw)


def _assert_same_plan(spec, jspec, budget=BUDGET):
    mine = planner.plan(spec, budget)
    ref = jplanner.plan(jspec, budget, quant="0", topology="flat")
    assert mine.canonical_json() == ref.canonical_json()
    assert mine.plan_id == ref.plan_id
    assert mine.describe() == ref.describe()
    assert mine.collective_counts() == ref.collective_counts()
    return mine


def test_golden_matrix_is_heat_tpus():
    assert [n for n, _ in planner.golden_specs()] == [n for n, _ in jplanner.golden_specs()]
    assert len(planner.golden_specs()) == 19
    assert planner.DEFAULT_BUDGET_MB == jplanner.DEFAULT_BUDGET_MB == 256


@pytest.mark.parametrize("name", [n for n, _ in jplanner.golden_specs()])
def test_golden_plans_equal_heat_tpu_byte_for_byte(name):
    spec = dict(planner.golden_specs())[name]
    jspec = dict(jplanner.golden_specs())[name]
    assert spec.as_dict() == jspec.as_dict()
    mine = _assert_same_plan(spec, jspec)
    if name in GOLDEN_STRATEGIES:
        assert (mine.strategy, mine.collective_counts()) == GOLDEN_STRATEGIES[name]


@pytest.mark.parametrize("name, args", P4_SPECS, ids=[n for n, _ in P4_SPECS])
def test_p4_plans_equal_heat_tpu_byte_for_byte(name, args):
    gshape, dtype, src, dst, p, reshape_to = args
    mine = _assert_same_plan(*_both(gshape, dtype, src, dst, p, reshape_to))
    if name in P4_STRATEGIES:
        assert (mine.strategy, mine.collective_counts()) == P4_STRATEGIES[name]


@pytest.mark.parametrize("budget", [2048, 8192, 1 << 20])
def test_small_budgets_chunk_like_heat_tpu(budget):
    mine = _assert_same_plan(*_both((64, 48), "float32", 0, 1, 8), budget=budget)
    assert mine.strategy == ("chunked-all-to-all" if budget == 2048 else "all-to-all")
    ring = _assert_same_plan(*_both((8, 4096), "float32", 0, 1, 8), budget=budget)
    assert ring.strategy == ("ring" if budget <= 8192 else "all-to-all")


def test_budget_knob_is_shared(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_REDIST_BUDGET_MB", "1")
    assert planner.budget_bytes() == jplanner.budget_bytes() == 1 << 20
    spec, jspec = _both((1024, 1024), "float32", 0, 1, 4)
    assert planner.plan(spec).canonical_json() == jplanner.plan(jspec, quant="0", topology="flat").canonical_json()
    assert planner.plan(spec).strategy == "chunked-all-to-all"


@pytest.mark.parametrize(
    "kwargs, env",
    [({"quant": "int8"}, {}), ({"topology": "2x4"}, {}), ({}, {"HEAT_TPU_WIRE_QUANT": "1"}),
     ({}, {"HEAT_TPU_TOPOLOGY": "2x4"}), ({}, {"HEAT_TPU_LATTICE_PROFILE": "/nonexistent.json"})],
)
def test_unported_planner_options_raise(kwargs, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item 12"):
        planner.plan(S((64, 48), "float32", 0, 1, 8), **kwargs)


# --------------------------------------------------------------------- #
# the executor's bodies, all ranks in one process                       #
# --------------------------------------------------------------------- #
def _chunks(a: np.ndarray, split, p: int):
    """Rank r's chunk of ``a`` along ``split`` (ceil-division blocks)."""
    if split is None:
        return [a] * p
    n = a.shape[split]
    b = -(-n // p)
    return [np.take(a, range(min(r * b, n), min(r * b + b, n)), axis=split) for r in range(p)]


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _words(t: torch.Tensor) -> np.ndarray:
    if t.numel() == 0:
        return np.empty(0, np.uint8)
    return t.contiguous().view(torch.uint8).numpy().reshape(-1)


EXEC_CASES = [
    # (gshape, dtype, src, dst, reshape_to, budget) on heat_tpu's 8 devices
    ((64, 48), "float32", 0, 1, None, None),
    ((64, 48), "float32", 1, 0, None, None),
    ((63, 48), "float32", 0, 1, None, None),
    ((16, 24, 40), "float32", 1, 2, None, None),
    ((13, 7, 5), "int64", 2, 0, None, None),
    ((64, 48), "float32", 0, None, None, None),
    ((64, 48), "float32", None, 1, None, None),
    ((64, 48), "complex64", 0, 1, None, 2048),
    ((8, 4096), "float32", 0, 1, None, 8192),
    ((40960, 40), "float32", 1, 1, (20480, 80), None),
    ((64, 48), "float32", 0, 0, (32, 96), None),
    ((1000, 26), "float32", 1, 1, (26, 1000), None),
    ((2048, 64), "bool", 1, 1, (8192, 16), None),
    ((8192, 16), "int32", 1, 1, (2048, 64), None),
    ((64, 48), "float64", 1, 0, (96, 32), None),
    ((64, 48), "float32", 0, 1, (96, 32), None),
    ((64, 48), "float32", None, 1, (96, 32), None),
    ((8, 12, 10), "float32", 1, 2, (16, 6, 10), None),
]


@pytest.mark.parametrize("gshape, dtype, src, dst, reshape_to, budget", EXEC_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}to{c[3]}" + ("-reshape" if c[4] else "") for c in EXEC_CASES])
def test_emulated_ranks_equal_heat_tpu_shards(gshape, dtype, src, dst, reshape_to, budget):
    p = jht.get_comm().size
    assert p == 8
    rng = np.random.default_rng(len(gshape) * 100 + gshape[0])
    a = rng.standard_normal(gshape)
    a = (a > 0) if dtype == "bool" else (a * 1000).astype(dtype) if "int" in dtype else a.astype(dtype)
    x = jht.array(a, split=src)
    out = jht.reshape(x, reshape_to, new_split=dst) if reshape_to else x.resplit(dst)
    ref = out.numpy()
    spec = S(gshape, dtype, src, dst, p, reshape_to=reshape_to)
    sched = planner.plan(spec, budget if budget is not None else BUDGET)
    world = executor.LocalWorld(p)
    shards = world.run(executor.program(spec, sched), [_tensor(c) for c in _chunks(a, src, p)])
    for r, (got, want) in enumerate(zip(shards, _chunks(ref, dst, p))):
        assert tuple(got.shape) == want.shape, (r, got.shape, want.shape)
        np.testing.assert_array_equal(_words(got), _words(_tensor(want)))
    assert all(c == sched.collective_counts() for c in world.counts)


def test_local_world_reraises_a_rank_failure():
    world = executor.LocalWorld(4)

    def body(x, rank, p, exchange):
        if rank == 2:
            raise ValueError("rank 2 fails")
        return exchange.alltoall(x)

    with pytest.raises(ValueError, match="rank 2 fails"):
        world.run(body, [torch.zeros(4, 1)] * 4)
