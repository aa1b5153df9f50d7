"""Two-tier topologies, the gate registry and the lattice of
heat_tpu_torch against heat_tpu.

- ``Topology`` and ``topology_for`` give heat_tpu's answers on the same
  inputs (explicit overrides and ``HEAT_TPU_TOPOLOGY`` values).
- Every gate the port declares has heat_tpu's name, legal values, kind,
  scopes and default, but ``HEAT_TPU_HBM_BYTES``/``HEAT_TPU_HOST_BYTES``,
  whose heat_tpu defaults are a TPU host's sizes: unset, the port takes the
  machine's (``core.tiers.capacity``).
- Plans of every golden spec × {no codec, int8, bf16} × {flat, 2x4, 4x2}
  serialize byte for byte as heat_tpu's when both packages read one lattice
  profile (written by heat_tpu's ``calibration.build_profile`` with every
  edge measured, so both price every edge alike); without a profile the
  port's ``penalty("dcn")`` is 9 (NVLink 4 over one NDR port), heat_tpu's
  8. One profile gives both the same ``profile_id``; a tampered one is
  dropped by both.
- The executor's bodies of 8 ranks in one process (``LocalWorld``) under
  the codec and the topologies give every rank heat_tpu's shard on its
  8-device CPU mesh with the collectives the plan counts: bit for bit on
  the exact and the bf16 wire (the codec's rows are heat_tpu's), within one
  int8 scale step on the int8 wire (see the test).
  The codec's admissibility threshold is lowered in both planners alike so
  that it engages at test sizes.
"""

import json

import numpy as np
import pytest
import torch

import heat_tpu as jht
from heat_tpu.core import communication as jcomm_mod
from heat_tpu.core import gates as jgates
from heat_tpu.core import tiers as jtiers
from heat_tpu.observability import calibration
from heat_tpu.redistribution import executor as jexecutor, planner as jplanner

import heat_tpu_torch as ht
from heat_tpu_torch.core import communication as comm_mod
from heat_tpu_torch.core import gates, tiers
from heat_tpu_torch.redistribution import RedistSpec, executor, planner

S = RedistSpec.normalize


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])


def _write_profile(path) -> str:
    """A profile with every edge of the lattice measured at the port's rates."""
    edges = {e: {"bps": rate, "method": "spec"} for e, (_, _, rate) in tiers.EDGES.items()}
    calibration.save_profile(calibration.build_profile(edges, platform="gpu", topology="flat"), str(path))
    return str(path)


@pytest.fixture
def shared_profile(tmp_path, monkeypatch):
    path = _write_profile(tmp_path / "lattice.json")
    monkeypatch.setenv("HEAT_TPU_LATTICE_PROFILE", path)
    yield path
    monkeypatch.delenv("HEAT_TPU_LATTICE_PROFILE")
    tiers.reload_profile()
    jtiers.reload_profile()


# --------------------------------------------------------------------- #
# Topology                                                              #
# --------------------------------------------------------------------- #
def _as_tuple(t):
    return (t.n_slices, t.chips_per_slice, t.size, t.tiered, str(t))


OVERRIDES = [None, "flat", "2x4", "4x2", "2x8", "8x1", "1x8", "16x1"]


@pytest.mark.parametrize("size", [1, 4, 8, 16])
@pytest.mark.parametrize("override", OVERRIDES)
def test_topology_for_matches_heat_tpu(size, override):
    assert _as_tuple(comm_mod.topology_for(size, override)) == _as_tuple(jcomm_mod.topology_for(size, override))


@pytest.mark.parametrize("env", ["auto", "", "flat", "2x4", "4x2", "2x2", "2 x 4", "none", "junk", "1x8"])
def test_topology_gate_matches_heat_tpu(env, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_TOPOLOGY", env)
    for size in (4, 8):
        assert _as_tuple(comm_mod.topology_for(size)) == _as_tuple(jcomm_mod.topology_for(size))
        assert planner.resolve_topology(size) == jplanner.resolve_topology(size)
    assert planner.resolve_topology(8, (2, 4)) == jplanner.resolve_topology(8, (2, 4)) == (2, 4)


@pytest.mark.parametrize("text", ["2x4", "4x2", "3x5", "1x1"])
def test_topology_methods_match_heat_tpu(text):
    mine, theirs = comm_mod.Topology.parse(text), jcomm_mod.Topology.parse(text)
    assert mine.chip_axis_groups() == theirs.chip_axis_groups()
    assert mine.slice_axis_groups() == theirs.slice_axis_groups()
    for a in range(mine.size):
        assert mine.slice_of(a) == theirs.slice_of(a)
        for b in range(mine.size):
            assert mine.crosses(a, b) == theirs.crosses(a, b)
    for group in mine.chip_axis_groups() + mine.slice_axis_groups():
        assert mine.spans(group) == theirs.spans(group)
    assert comm_mod.Topology.parse("x") is None and comm_mod.Topology.parse("0x3") is None
    with pytest.raises(ValueError):
        comm_mod.topology_for(8, "two by four")


def test_the_world_of_one_rank_is_flat_and_the_rates_are_an_h100s():
    assert not ht.get_comm().topology.tiered
    assert comm_mod.ICI_BPS == tiers.ICI_BPS == 900e9 and comm_mod.DCN_BPS == tiers.DCN_BPS == 100e9
    assert comm_mod.DCN_PENALTY == tiers.penalty("dcn") == 9 and jcomm_mod.DCN_PENALTY == 8
    assert tiers.penalty("hbm") == 1 and tiers.penalty("pcie") == int(900e9 / tiers.PCIE_BPS)
    assert tiers.edge_between("hbm", "host") == jtiers.edge_between("hbm", "host") == "pcie"
    assert tiers.edge_between("hbm", "ici") is None
    assert "penalty 9x" in tiers.describe()
    assert tiers.sparse_transfer_time(1000, 4, "ici") == 8000 / 900e9


# --------------------------------------------------------------------- #
# the gate registry                                                     #
# --------------------------------------------------------------------- #
_MACHINE_DEFAULTS = ("HEAT_TPU_HBM_BYTES", "HEAT_TPU_HOST_BYTES")


@pytest.mark.parametrize("name", sorted(gates.GATES))
def test_each_gate_is_declared_as_heat_tpu_declares_it(name):
    mine, theirs = gates.snapshot()[name], jgates.snapshot()[name]
    for key in ("values", "kind", "affects_programs", "scopes", "key_params"):
        assert mine[key] == theirs[key], (name, key)
    if name in _MACHINE_DEFAULTS:
        assert mine["default"] is None
    else:
        assert mine["default"] == theirs["default"]
    spec, jspec = gates.GATES[name], jgates.GATES[name]
    for raw in (None, "", "0", "1", "on", "off", "auto", "int8", "bf16", "force", "junk", "2x4"):
        assert spec.recognizes(raw) == jspec.recognizes(raw), (name, raw)


def test_gates_read_the_environment_and_refuse_undeclared_names(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_WIRE_QUANT", "bf16")
    assert gates.get("HEAT_TPU_WIRE_QUANT") == jgates.get("HEAT_TPU_WIRE_QUANT") == "bf16"
    assert gates.is_set("HEAT_TPU_WIRE_QUANT") and gates.snapshot()["HEAT_TPU_WIRE_QUANT"]["raw"] == "bf16"
    assert planner.wire_quant_mode() == jplanner.wire_quant_mode() == "bf16"
    assert planner.wire_quant_gate() == jplanner.wire_quant_gate() == "bf16"
    monkeypatch.setenv("HEAT_TPU_WIRE_QUANT", "auto")
    assert planner.wire_quant_gate() is None  # the exact wire on every device the port runs on
    with pytest.raises(KeyError):
        gates.get("HEAT_TPU_NOT_A_GATE")
    assert [g.name for g in gates.scope_gates("plan")] == sorted(
        n for n in gates.GATES if "plan" in jgates.GATES[n].scopes)
    assert set(gates.program_gate_roster().split(",")) <= set(jgates.program_gate_roster().split(","))


def test_the_port_reads_its_gates_only_through_the_registry():
    import pathlib
    import re

    root = pathlib.Path(ht.__file__).parent
    for path in root.rglob("*.py"):
        if path.name == "gates.py":
            continue
        text = path.read_text()
        assert not re.search(r"os\.environ(\.get)?\(?\[?[\"']HEAT_TPU_", text), path
        assert not re.search(r"environ\.get\((_?[A-Z_]*ENV)", text), path


# --------------------------------------------------------------------- #
# plans under a shared lattice profile                                  #
# --------------------------------------------------------------------- #
GOLDEN = planner.golden_specs()
JGOLDEN = dict(jplanner.golden_specs())


@pytest.mark.parametrize("quant", ["0", "int8", "bf16"])
@pytest.mark.parametrize("topology", ["flat", "2x4", "4x2"])
@pytest.mark.parametrize("name", [n for n, _ in GOLDEN])
def test_golden_plans_equal_heat_tpus_under_one_profile(name, quant, topology, shared_profile):
    spec = dict(GOLDEN)[name]
    mine = planner.plan(spec, quant=quant, topology=topology)
    ref = jplanner.plan(JGOLDEN[name], quant=quant, topology=topology)
    assert mine.canonical_json() == ref.canonical_json()
    assert mine.plan_id == ref.plan_id and mine.describe() == ref.describe()
    assert planner.tier_time_model(mine) == jplanner.tier_time_model(ref)


def test_one_profile_one_profile_id_and_a_tampered_one_is_dropped(tmp_path, monkeypatch):
    path = _write_profile(tmp_path / "p.json")
    monkeypatch.setenv("HEAT_TPU_LATTICE_PROFILE", path)
    assert tiers.reload_profile()["profile_id"] == jtiers.reload_profile()["profile_id"]
    assert tiers.profile_annotation() == jtiers.profile_annotation()
    doc = json.load(open(path))
    doc["edges"]["dcn"]["bps"] = 1.0  # an edited price: the digest no longer holds
    json.dump(doc, open(path, "w"))
    assert tiers.reload_profile() is None and tiers.penalty("dcn") == 9
    assert not (tmp_path / "p.json").exists()  # dropped, as heat_tpu drops it
    monkeypatch.setenv("HEAT_TPU_LATTICE_PROFILE", str(tmp_path / "missing.json"))
    assert tiers.active_profile() is None and planner.plan(GOLDEN[1][1]).calibration is None
    tiers.reload_profile()
    jtiers.reload_profile()


def test_without_a_profile_dcn_costs_nine_ici_bytes():
    spec = dict(GOLDEN)["resplit_1gb_p16"]
    mine = planner.plan(spec, quant="0", topology="2x8")
    assert mine.topology["dcn_penalty"] == 9 and mine.calibration is None
    assert jplanner.plan(JGOLDEN["resplit_1gb_p16"], quant="0", topology="2x8").topology["dcn_penalty"] == 8
    assert mine.strategy == "hierarchical-a2a" and mine.tier_bytes()["dcn"] > 0


def test_staged_plans_keep_their_bytes_with_the_lattice():
    """A staged plan prices only pcie and hbm: the wire edges change none of
    its numbers, and without a profile it carries no calibration; under one
    it carries heat_tpu's annotation."""
    from heat_tpu.redistribution import staging as jstaging

    from heat_tpu_torch.redistribution import staging

    passes = [{"tag": "sketch", "axis": 1}]
    mine = staging.plan_staged_passes((4096, 4096), np.float32, passes, out_bytes=1 << 20, hbm_bytes=1 << 34)
    assert mine.calibration is None and "calibration" not in mine.canonical_json()
    assert mine.staging["model"]["pcie_s"] == round(tiers.transfer_time(mine.tier_bytes()["pcie"], "pcie"), 9)
    ref = jstaging.plan_staged_passes((4096, 4096), np.float32, passes, out_bytes=1 << 20, hbm_bytes=1 << 34)
    assert mine.n_steps == ref.n_steps and mine.tier_bytes() == ref.tier_bytes()


# --------------------------------------------------------------------- #
# the executor under the codec and the topologies                      #
# --------------------------------------------------------------------- #
EXEC = [
    # (gshape, src, dst, reshape_to): 4 MiB, enough that the hierarchical
    # form wins at 2x4 once dcn costs 9 ici bytes
    ((1024, 1024), 0, 1, None),
    ((1000, 1024), 1, 0, None),
    ((1024, 1000), 1, 1, (40960, 25)),
    ((40960, 25), 1, 1, (1024, 1000)),
]


@pytest.fixture
def small_codec_groups(monkeypatch):
    """The codec engages from 64 KiB groups in both planners (from 2 MiB by
    default): the planners read the module constant when they plan."""
    for mod in (planner, jplanner):
        monkeypatch.setattr(mod, "QUANT_MIN_WIRE_BYTES", 64 << 10)
    planner.clear_plan_cache()
    jplanner.clear_plan_cache()
    jexecutor.clear_program_cache()
    yield
    planner.clear_plan_cache()
    jplanner.clear_plan_cache()
    jexecutor.clear_program_cache()


@pytest.mark.parametrize("wire", ["0", "1", "bf16"])
@pytest.mark.parametrize("topology", ["flat", "2x4"])
@pytest.mark.parametrize("gshape, src, dst, reshape_to", EXEC, ids=[f"{c[0]}-{c[1]}to{c[2]}" for c in EXEC])
def test_emulated_ranks_equal_heat_tpu_under_codec_and_tiers(gshape, src, dst, reshape_to, wire, topology,
                                                             shared_profile, small_codec_groups, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_WIRE_QUANT", wire)
    monkeypatch.setenv("HEAT_TPU_TOPOLOGY", topology)
    p = jht.get_comm().size
    assert p == 8
    a = np.random.default_rng(gshape[0] + src).standard_normal(gshape).astype(np.float32)
    a[3, :5] = [np.nan, np.inf, -np.inf, 0.0, -0.0]
    x = jht.array(a, split=src)
    out = jht.reshape(x, reshape_to, new_split=dst) if reshape_to else x.resplit(dst)
    ref = np.asarray(out.numpy())
    spec = S(gshape, "float32", src, dst, p, reshape_to=reshape_to)
    sched = planner.plan(spec)
    jspec = jplanner.RedistSpec.normalize(gshape, "float32", src, dst, p, reshape_to=reshape_to)
    assert sched.canonical_json() == jplanner.plan(jspec).canonical_json()
    assert bool(sched.quant) == (wire != "0")
    assert (sched.strategy == "hierarchical-a2a") == (topology == "2x4")
    world = executor.LocalWorld(p)
    chunks = [np.ascontiguousarray(a[comm_slices(gshape, src, r, p)]) for r in range(p)]
    shards = world.run(executor.program(spec, sched), [torch.from_numpy(c) for c in chunks])
    out_shape = reshape_to or gshape
    # one int8 scale step a codec leg the values cross (the pivot's two
    # stages are two legs): heat_tpu's compiled program multiplies by the
    # constant 1/126 where its codec divides by 126, so a tile's scale may
    # differ in its last bit and a code on a rounding tie flip (the codec
    # divides; tests/test_torch_quant.py holds it bit for bit). 1.01: the
    # second leg's absmax is the first's decoded, within 2^-7 of it.
    _, qin, qout = executor._quant_flags(sched)
    step = 1.01 * np.max(np.abs(a[np.isfinite(a)])) / 126 * (qin + qout) if wire == "1" else 0.0
    for r, got in enumerate(shards):
        want = np.ascontiguousarray(ref[comm_slices(out_shape, dst, r, p)])
        assert tuple(got.shape) == want.shape
        if step:
            np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=step)
        else:
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert all(c == sched.collective_counts() for c in world.counts)


def comm_slices(shape, split, r, p):
    return ht.get_comm().chunk(shape, split, rank=r, w_size=p)[2]
