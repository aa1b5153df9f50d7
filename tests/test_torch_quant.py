"""The port's wire codec (``heat_tpu_torch.kernels.quant``) against
``heat_tpu.kernels.quant``.

- Q1's plain version (the CPU route of ``encode_blocks``/``decode_blocks``)
  gives heat_tpu's wire bytes, the same int8 codes and scale bytes (int8) or
  bfloat16 words (bf16), on finite normal data, all-zero tiles, NaN and ±inf
  tiles, a ragged last tile and rounding ties; decoding gives heat_tpu's
  float32 words exactly. Subnormal inputs are held against a NumPy
  formulation instead, since XLA's CPU flushes subnormals to zero and
  torch's does not (ROADMAP.md "Not faults").
- Round trip within ``tolerance(mode)`` of the governing absmax, the
  specials exactly (the codec's own bound, heat_tpu's pinned value).
- ``wire_bytes``, ``wire_ratio``, ``tolerance``, ``compose_tolerance`` and
  both step models equal heat_tpu's, at rates passed to both.
- The quantized all-reduces in a world of one rank: the sum and the
  residual are the codec's round trips of the input, exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as jht
from heat_tpu.kernels import quant as jquant
import heat_tpu_torch as ht
from heat_tpu_torch.kernels import quant

MODES = ("int8", "bf16")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])


def _cases():
    rng = np.random.default_rng(0)
    out = {"normal": rng.standard_normal((3, 2500)).astype(np.float32) * 7}
    z = rng.standard_normal((2, 3072)).astype(np.float32)
    z[0, 1024:2048] = 0.0
    z[1] = 0.0
    out["zero_tiles"] = z
    s = rng.standard_normal((3, 2048)).astype(np.float32)
    s[0, 5], s[0, 6], s[0, 7], s[1, 9] = np.nan, -np.nan, np.inf, -np.inf
    s[1, 1500:1600] = np.nan
    s[2, :1024] = np.inf  # a tile without a finite value: scale 1
    s[2, 1024:1030] = -np.inf
    out["specials"] = s
    out["ragged"] = rng.standard_normal((4, 1030)).astype(np.float32)
    out["tiny_row"] = rng.standard_normal((5, 3)).astype(np.float32)
    out["ties"] = ((np.arange(2048, dtype=np.float32).reshape(2, 1024) - 1000) * 0.5).astype(np.float32)
    out["wide_range"] = (rng.standard_normal((2, 4096)) * 10.0 ** rng.integers(-30, 30, (2, 4096))).astype(np.float32)
    out["neg_zero"] = np.full((1, 1024), -0.0, np.float32)
    out["empty_rows"] = np.zeros((0, 1500), np.float32)
    return out


CASES = _cases()


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_encode_gives_heat_tpus_wire_bytes_and_decode_its_words(case, mode):
    x = CASES[case]
    want = np.asarray(jquant.encode_blocks(jnp.asarray(x), mode))
    got = quant.encode_blocks(torch.from_numpy(x), mode)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape == (x.shape[0], quant.wire_bytes(x.shape[1], mode))
    np.testing.assert_array_equal(got.numpy(), want)
    dec = quant.decode_blocks(got, x.shape[1], mode)
    ref = np.asarray(jquant.decode_blocks(jnp.asarray(want), x.shape[1], mode))
    assert dec.dtype == torch.float32 and tuple(dec.shape) == x.shape
    np.testing.assert_array_equal(_bits(dec.numpy()), _bits(ref))


def _numpy_encode_int8(x: np.ndarray) -> np.ndarray:
    """heat_tpu's formulation in NumPy, which keeps subnormals as torch does."""
    B, n = x.shape
    npad = -(-n // 1024) * 1024
    xt = np.pad(x, ((0, 0), (0, npad - n))).reshape(B, npad // 1024, 1024)
    finite = np.isfinite(xt)
    amax = np.where(finite, np.abs(xt), np.float32(0)).max(axis=-1)
    scale = np.where(amax > 0, amax / np.float32(126), np.float32(1)).astype(np.float32)
    q = np.clip(np.rint(np.where(finite, xt, np.float32(0)) / scale[..., None]), -126, 126).astype(np.int8)
    q = np.where(np.isnan(xt), np.int8(-128), q)
    q = np.where(xt == np.inf, np.int8(127), np.where(xt == -np.inf, np.int8(-127), q))
    return np.concatenate([q.reshape(B, npad), scale.view(np.int8).reshape(B, -1)], axis=1)


@pytest.mark.parametrize("scale", [1.0, 1e-40])
def test_subnormal_payloads_against_numpy(scale):
    """A tile of subnormals (and one mixing them with normals): XLA's CPU
    flushes them, so NumPy is the reference here."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 1500)) * 1e-39).astype(np.float32)
    x[1, :10] = np.float32(scale)
    assert np.any((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny))
    got = quant.encode_blocks(torch.from_numpy(x), "int8").numpy()
    np.testing.assert_array_equal(got, _numpy_encode_int8(x))
    dec = quant.decode_blocks(torch.from_numpy(got), 1500, "int8").numpy()
    np.testing.assert_array_equal(_bits(dec), _bits(_numpy_decode_int8(got, 1500)))


def _numpy_decode_int8(w: np.ndarray, n: int) -> np.ndarray:
    B = w.shape[0]
    npad = -(-n // 1024) * 1024
    nt = npad // 1024
    q = w[:, :npad].reshape(B, nt, 1024)
    scale = np.ascontiguousarray(w[:, npad:]).view(np.float32).reshape(B, nt)
    v = q.astype(np.float32) * scale[..., None]
    v = np.where(q == -128, np.float32(np.nan), v)
    v = np.where(q == 127, np.float32(np.inf), np.where(q == -127, np.float32(-np.inf), v))
    return v.reshape(B, npad)[:, :n]


@pytest.mark.parametrize("mode", MODES)
def test_round_trip_within_the_codecs_bound(mode):
    """|x − decode(encode(x))| ≤ tolerance(mode) · the tile's absmax (int8)
    or |x| (bf16): the bound heat_tpu pins (int8: half a scale step,
    absmax/252 < 2^-7 absmax; bf16: half an ulp of 8 bits); specials exact."""
    x = CASES["specials"]
    back = quant.decode_blocks(quant.encode_blocks(torch.from_numpy(x), mode), x.shape[1], mode).numpy()
    finite = np.isfinite(x)
    np.testing.assert_array_equal(np.isnan(back), np.isnan(x))
    np.testing.assert_array_equal(back[np.isinf(x)], x[np.isinf(x)])
    tol = quant.tolerance(mode)
    if mode == "int8":
        tiles = np.where(finite, np.abs(x), 0).reshape(x.shape[0], -1, 1024).max(-1)  # 2048 columns: whole tiles
        bound = np.repeat(tiles, 1024, axis=1)[:, : x.shape[1]] * tol
    else:
        bound = np.abs(x) * tol
    assert np.all(np.abs(back[finite] - x[finite]) <= bound[finite])


def test_codec_refuses_what_it_does_not_encode():
    with pytest.raises(TypeError):
        quant.encode_blocks(torch.zeros(2, 4, dtype=torch.float64), "int8")
    with pytest.raises(ValueError):
        quant.encode_blocks(torch.zeros(8), "int8")
    with pytest.raises(ValueError):
        quant.encode_blocks(torch.zeros(2, 4), "fp8")


@pytest.mark.parametrize("mode", MODES)
def test_wire_sizes_and_tolerances_equal_heat_tpus(mode):
    for n in (0, 1, 3, 1023, 1024, 1025, 4096, 10**6 + 7):
        assert quant.wire_bytes(n, mode) == jquant.wire_bytes(n, mode)
        assert quant.wire_ratio(n, mode) == jquant.wire_ratio(n, mode)
    assert quant.tolerance(mode) == jquant.tolerance(mode)
    assert quant.TILE == jquant.TILE and quant.MODES == jquant.MODES
    tols = [quant.tolerance(mode), 0.0, quant.tolerance(mode)]
    assert quant.compose_tolerance(tols) == jquant.compose_tolerance(tols)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("compute_s", [1e-5, 1e-3, 1.0])
def test_step_models_equal_heat_tpus_at_the_same_rates(mode, compute_s):
    for params in (4 << 20, 4_825_000, 1 << 30):
        assert quant.dp_step_model(params, compute_s, p=16, ici_bps=900e9, mode=mode) == jquant.dp_step_model(
            params, compute_s, p=16, ici_bps=900e9, mode=mode)
        mine = quant.dp_step_model_2tier(params, compute_s, 2, 4, ici_bps=900e9, dcn_bps=100e9, mode=mode)
        assert mine == jquant.dp_step_model_2tier(params, compute_s, 2, 4, ici_bps=900e9, dcn_bps=100e9, mode=mode)


def test_step_models_default_to_the_lattices_rates():
    from heat_tpu_torch.core import tiers

    assert quant.dp_step_model(1 << 26, 0.0) == quant.dp_step_model(1 << 26, 0.0, ici_bps=tiers.ICI_BPS)
    assert quant.dp_step_model_2tier(1 << 26, 0.0) == quant.dp_step_model_2tier(
        1 << 26, 0.0, ici_bps=tiers.ICI_BPS, dcn_bps=tiers.DCN_BPS)


@pytest.mark.parametrize("mode", MODES)
def test_allreduces_in_a_world_of_one_rank(mode):
    """p = 1: the flat form's sum is the input encoded twice (stage 1, then
    the re-encoded sum) and its residual the two encode errors; the
    two-tier form encodes once (its node leg is exact)."""
    h = torch.from_numpy(CASES["ragged"].reshape(-1)[:3000].copy())
    comm = ht.MPI_SELF

    def rt(v):
        return quant.decode_blocks(quant.encode_blocks(v[None], mode), v.numel(), mode)[0]

    back = rt(h)
    out, resid = quant.quantized_allreduce_sum(h, comm, mode)
    np.testing.assert_array_equal(out.numpy(), rt(back).numpy())
    np.testing.assert_array_equal(resid.numpy(), ((h - back) + (back - rt(back))).numpy())
    out1, resid1 = quant.hierarchical_allreduce_sum(h, comm, 1, 1, mode)
    np.testing.assert_array_equal(out1.numpy(), back.numpy())
    np.testing.assert_array_equal(resid1.numpy(), (h - back).numpy())


def test_codec_calls_run_under_the_profiler_scope():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        quant.decode_blocks(quant.encode_blocks(torch.ones(2, 5), "int8"), 5, "int8")
    names = [e.key for e in prof.key_averages()]
    assert "wire_codec_int8" in names


# --------------------------------------------------------------------- #
# the 4-rank world against heat_tpu on 4 devices                        #
# --------------------------------------------------------------------- #
import torch_mp_worker as worker  # noqa: E402
from test_torch_distributed import WORLD, _jcomm, _result, jcomm, ranks  # noqa: E402,F401 (fixtures)


def _j_allreduce(mode: str, hierarchical: bool):
    """heat_tpu's quantized all-reduce of the ranks' vectors on 4 devices:
    (sum, residual) a device."""
    from jax.sharding import PartitionSpec as P

    from heat_tpu.core._jax_compat import shard_map

    comm = _jcomm()
    axis = comm.axis_name

    def body(hb):
        if hierarchical:
            out, resid = jquant.hierarchical_allreduce_sum(hb[0], axis, 2, 2, mode)
        else:
            out, resid = jquant.quantized_allreduce_sum(hb[0], axis, WORLD, mode)
        return out[None], resid[None]

    h = np.stack([worker.wire_vector(r) for r in range(WORLD)])
    fn = jax.jit(shard_map(body, mesh=comm.mesh, in_specs=(P(axis),), out_specs=(P(axis), P(axis)),
                           check_vma=False))
    out, resid = fn(jnp.asarray(h))
    return np.asarray(out), np.asarray(resid)


def _codec_step(mode: str, amax: float) -> float:
    """One step of the codec at a value of size ``amax``: the int8 scale
    ``amax/126``, or one bfloat16 ulp (``2^-7`` of it)."""
    return amax / 126 if mode == "int8" else amax * 2.0**-7


def _assert_codec_agrees(got, want, tight: float, step: float) -> None:
    """Element by element: ``|got − want| <= tight`` everywhere (float32
    sums in other orders), but at no more than one element in a thousand
    (at least one) where a code flipped on a rounding tie or on a scale
    one ulp off: there by at most one codec ``step``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got - want)
    off = d > tight
    budget = max(1, want.size // 1000)
    assert int(off.sum()) <= budget, (
        f"{int(off.sum())} of {want.size} elements differ by more than {tight:.3g} (at most {budget} may): "
        f"max |d| {d.max():.3g} at {int(np.argmax(d))}")
    assert np.all(d[off] <= step), (d[off].max(), step)


def _wire_amax() -> float:
    return float(max(np.max(np.abs(worker.wire_vector(r))) for r in range(WORLD)))


def _check_allreduce(results, key: str, want_sum, want_resid, mode: str) -> None:
    """Each rank's sum and residual against heat_tpu's, element by element
    (:func:`_assert_codec_agrees`): tight at 1e-6·p·max|h| (a few float32
    ulps of a p-term sum), a flipped code by one step of the stage-2 value,
    p·max|h|."""
    amax = _wire_amax()
    tight, step = 1e-6 * WORLD * amax, _codec_step(mode, WORLD * amax)
    for r, res in enumerate(results):
        _assert_codec_agrees(res[key + "sum"], want_sum[r], tight, step)
        _assert_codec_agrees(res[key + "resid"], want_resid[r], tight, step)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("form", ["flat", "hierarchical"])
def test_world_quantized_allreduces_match_heat_tpu(ranks, jcomm, mode, form):
    """Sum and residual a rank against heat_tpu's on 4 devices, element by
    element (:func:`_check_allreduce`). The flat form's collectives: one
    all-to-all and one all-gather; the two-tier form's: one all-to-all and
    two all-gathers."""
    hierarchical = form == "hierarchical"
    want_sum, want_resid = _j_allreduce(mode, hierarchical)
    key = "hier_" if hierarchical else ""
    results = _result(ranks, f"wire_allreduce_{mode}")
    _check_allreduce(results, key, want_sum, want_resid, mode)
    for res in results:
        assert res[key + "counts"] == ({"all-to-all": 1, "all-gather": 2} if hierarchical
                                       else {"all-to-all": 1, "all-gather": 1})
    sums = [res[key + "sum"] for res in results]
    assert all(np.array_equal(s, sums[0]) for s in sums)  # one sum on every rank, bit for bit
    exact = sum(worker.wire_vector(r).astype(np.float64) for r in range(WORLD))
    # the sum's own error: stage-1 codes (p of them) and the stage-2 code,
    # half a step each at most
    np.testing.assert_allclose(sums[0], exact, rtol=0, atol=_codec_step(mode, 2 * WORLD * _wire_amax()))


def _rt(v: torch.Tensor, mode: str) -> torch.Tensor:
    """The codec's round trip of the rows of ``v``."""
    return quant.decode_blocks(quant.encode_blocks(v, mode), v.shape[-1], mode)


def _port_allreduce(hierarchical: bool, mode: str):
    """Each rank's (sum, residual) written out from the wire vectors with
    the port's codec: the flat form's residual is its blocks' stage-1 error
    plus, on block ``rank`` only, the reduced block's stage-2 error; the
    two-tier form's is the node-reduced block's error on the rank's place
    in its node (slices of consecutive ranks, 2x2)."""
    n = worker.WIRE_N
    hs = [torch.from_numpy(worker.wire_vector(r)) for r in range(WORLD)]
    C = 2 if hierarchical else WORLD
    k = -(-n // C)
    blocks = [torch.nn.functional.pad(h, (0, k * C - n)).reshape(C, k) for h in hs]
    out = []
    if hierarchical:
        red_s = {(s, c): torch.sum(torch.stack([blocks[s * C + q][c] for q in range(C)]), dim=0)
                 for s in range(WORLD // C) for c in range(C)}
        red_g = [torch.sum(torch.stack([_rt(red_s[(s, c)][None], mode)[0] for s in range(WORLD // C)]), dim=0)
                 for c in range(C)]
        total = torch.cat(red_g)[:n]
        for r in range(WORLD):
            resid = torch.zeros(k * C)
            c = r % C
            resid[c * k:(c + 1) * k] = red_s[(r // C, c)] - _rt(red_s[(r // C, c)][None], mode)[0]
            out.append((total, resid[:n]))
        return out
    stage1 = [(b - _rt(b, mode)).reshape(-1) for b in blocks]
    reds = [torch.sum(_rt(torch.stack([b[r] for b in blocks]), mode), dim=0) for r in range(WORLD)]
    total = torch.cat([_rt(red[None], mode)[0] for red in reds])[:n]
    for r in range(WORLD):
        resid = stage1[r].clone()
        resid[r * k:(r + 1) * k] += reds[r] - _rt(reds[r][None], mode)[0]
        out.append((total, resid[:n]))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("form", ["flat", "hierarchical"])
def test_world_allreduce_residual_is_both_stages_errors_bit_for_bit(ranks, mode, form):
    """At p = 4 each rank's residual is the codec's error at both stages,
    written out from the inputs with the same codec (:func:`_port_allreduce`),
    bit for bit, and so is the sum: the residual is the error-feedback
    carry heat_tpu keeps, stage 1 plus stage 2, on the right block."""
    key = "hier_" if form == "hierarchical" else ""
    for r, (res, (total, resid)) in enumerate(zip(_result(ranks, f"wire_allreduce_{mode}"),
                                                  _port_allreduce(form == "hierarchical", mode))):
        np.testing.assert_array_equal(res[key + "resid"].view(np.uint32), resid.numpy().view(np.uint32))
        np.testing.assert_array_equal(res[key + "sum"].view(np.uint32), total.numpy().view(np.uint32))


def _wrong_block(resid: np.ndarray, r: int, mode: str) -> np.ndarray:
    """``resid`` with its stage-2 error moved from block ``r`` to block
    ``r + 1``: the carry kept on another rank's block."""
    blocks = [torch.from_numpy(np.pad(worker.wire_vector(q), (0, -worker.WIRE_N % WORLD))).reshape(WORLD, -1)
              for q in range(WORLD)]
    k = blocks[0].shape[1]
    stage1 = (blocks[r] - _rt(blocks[r], mode)).reshape(-1).numpy()[: worker.WIRE_N]
    stage2 = resid - stage1
    out = stage1.copy()
    src, dst = r * k, ((r + 1) % WORLD) * k
    moved = np.zeros(WORLD * k, np.float32)
    moved[dst:dst + k] = np.pad(stage2, (0, WORLD * k - worker.WIRE_N))[src:src + k]
    return out + moved[: worker.WIRE_N]


@pytest.mark.parametrize("fault", ["zeroed", "negated", "wrong_block"])
@pytest.mark.parametrize("mode", MODES)
def test_world_allreduce_check_refuses_a_wrong_residual(ranks, jcomm, mode, fault):
    """The element-wise check of the residual fails on a zeroed residual,
    a sign-flipped one, and one whose stage-2 error sits on another
    rank's block (so each of those faults in the port would fail
    test_world_quantized_allreduces_match_heat_tpu)."""
    want_sum, want_resid = _j_allreduce(mode, False)
    results = [dict(res) for res in _result(ranks, f"wire_allreduce_{mode}")]
    for r, res in enumerate(results):
        res["resid"] = {"zeroed": np.zeros_like(res["resid"]), "negated": -res["resid"],
                        "wrong_block": _wrong_block(res["resid"], r, mode)}[fault]
    with pytest.raises(AssertionError):
        _check_allreduce(results, "", want_sum, want_resid, mode)


@pytest.mark.parametrize("wire", ["1", "bf16", "0"])
@pytest.mark.parametrize("topology", worker.WIRE_TOPOLOGIES)
def test_world_quantized_resplit_matches_heat_tpu(ranks, jcomm, wire, topology, monkeypatch):
    """A split 0 -> 1 move under the codec and the topology, each rank's
    shard against heat_tpu's on 4 devices: bit for bit on the exact and the
    bf16 wire, within one int8 scale step on the int8 wire (see
    tests/test_torch_topology.py); the collectives the plan counts."""
    from heat_tpu.redistribution import executor as jexecutor, planner as jplanner

    monkeypatch.setenv("HEAT_TPU_WIRE_QUANT", wire)
    monkeypatch.setenv("HEAT_TPU_TOPOLOGY", topology)
    monkeypatch.setattr(jplanner, "QUANT_MIN_WIRE_BYTES", worker.WIRE_MIN_GROUP)
    jplanner.clear_plan_cache()
    jexecutor.clear_program_cache()
    a = worker.wire_matrix(worker.WIRE_RESPLIT, 1)
    try:
        ref = jht.array(a, split=0, comm=jcomm).resplit(1).numpy()
    finally:
        jplanner.clear_plan_cache()
        jexecutor.clear_program_cache()
    step = np.max(np.abs(a)) / 126 if wire == "1" else 0.0
    for r, res in enumerate(_result(ranks, f"wire_resplit_{wire}_{topology}")):
        want = ref[jcomm.chunk(a.shape, 1, rank=r)[2]]
        assert res["quant"] == {"1": "int8", "bf16": "bf16", "0": None}[wire]
        assert res["strategy"] == ("hierarchical-a2a" if topology == "2x2" else "all-to-all")
        assert res["counts"] == res["plan_counts"]
        if step:
            np.testing.assert_allclose(res["local"], want, rtol=0, atol=step)
        else:
            np.testing.assert_array_equal(res["local"].view(np.uint32), np.ascontiguousarray(want).view(np.uint32))


_DP_REFERENCE = {}


def _j_dp(mode: str, topology: str):
    """heat_tpu's three quantized steps on 4 devices: (losses, params, carry
    rows) a step."""
    import heat_tpu.nn as jnn
    import heat_tpu.optim as jopt

    key = (mode, topology)
    if key not in _DP_REFERENCE:
        import os

        old = os.environ.get("HEAT_TPU_TOPOLOGY")
        os.environ["HEAT_TPU_TOPOLOGY"] = topology
        try:
            x, y = worker.train_data("mlp", 30)
            comm = _jcomm()
            jm = jnn.DataParallel(worker.train_mlp(jnn), comm=comm, key=13)
            jo = jopt.DataParallelOptimizer(worker.train_optimizer(jopt, "sgd"), jm, wire_quant=mode)
            X, Y = jht.array(x, split=0, comm=comm), jht.array(y, split=0, comm=comm)
            steps = []
            for _ in range(worker.WIRE_DP_STEPS):
                loss = float(jo.step(X, Y))
                steps.append((loss, _order(jm.params), np.asarray(jo._ef_carry)))
        finally:
            if old is None:
                os.environ.pop("HEAT_TPU_TOPOLOGY")
            else:
                os.environ["HEAT_TPU_TOPOLOGY"] = old
        _DP_REFERENCE[key] = steps
    return _DP_REFERENCE[key]


def _order(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in _order(t)]
    return [np.asarray(tree[k]) for k in ("weight", "bias") if k in tree]


def _check_dp(results, ref, mode: str) -> None:
    """Each step of each rank against heat_tpu's, element by element
    (:func:`_assert_codec_agrees`). The scale is the codec's input, h =
    gradient + carry, its absmax m over the ranks: the carry tight at
    1e-6·p·m (float32 gradients and p-term sums in other orders), a flipped
    code by one step of the stage-2 value p·m; the parameters tight at 1e-6
    (they are about 0.3 and the update's float32 error is far below that),
    a flipped code moving one by the learning rate 0.05 times a step over
    the 30 rows, once a step so far. The carry moves a parameter by about
    lr·max|carry|/30, which is above the tight bound, so a wrong carry
    fails on the parameters as well."""
    lr, rows = 0.05, 30
    for k, (loss, params, carry) in enumerate(ref):
        m = max(float(np.max(np.abs(res["steps"][k]["h"]))) for res in results)
        step = _codec_step(mode, WORLD * m)
        for r, res in enumerate(results):
            got = res["steps"][k]
            assert abs(got["loss"] - loss) <= 1e-5 * abs(loss) + 1e-6
            _assert_codec_agrees(got["carry"], carry[r], 1e-6 * WORLD * m, step)
            _assert_codec_agrees(np.concatenate([g.ravel() for g in got["params"]]),
                                 np.concatenate([w.ravel() for w in params]), 1e-6, (k + 1) * lr * step / rows)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("topology", worker.WIRE_TOPOLOGIES)
def test_world_quantized_training_matches_heat_tpu(ranks, jcomm, mode, topology):
    """Three SGD steps of the MLP with dropout on 30 rows (8, 8, 8, 6 a rank;
    heat_tpu's last device pads to 8) through the codec with error
    feedback, flat and at 2x2, against heat_tpu on 4 devices: the loss
    within test_torch_train.py's bound (rtol 1e-5, atol 1e-6: float32 sums
    in other orders); each rank's carry and the parameters element by
    element (:func:`_check_dp`), the carry in heat_tpu's flat order. Every
    rank holds the same parameters bit for bit; a checkpoint's carry rows
    give each rank its carry back."""
    ref = _j_dp(mode, topology)
    results = _result(ranks, f"wire_dp_{mode}_{topology}")
    _check_dp(results, ref, mode)
    for res in results:
        for got in res["steps"]:
            want_counts = {"all-to-all": 1, "all-gather": 2 if topology == "2x2" else 1, "all-reduce": 1}
            assert got["counts"] == want_counts
        np.testing.assert_array_equal(res["restored"], res["steps"][-1]["carry"])
        assert res["ef_rows"].shape[0] == WORLD
    for k in range(worker.WIRE_DP_STEPS):
        for q in range(1, WORLD):
            for a, b in zip(results[q]["steps"][k]["params"], results[0]["steps"][k]["params"]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fault", ["zeroed", "negated"])
@pytest.mark.parametrize("mode", MODES)
def test_world_training_check_refuses_a_wrong_carry(ranks, jcomm, mode, fault):
    """The element-wise check of the carry fails on a zeroed carry and on a
    sign-flipped one (so a port that kept either would fail
    test_world_quantized_training_matches_heat_tpu)."""
    ref = _j_dp(mode, "flat")
    results = []
    for res in _result(ranks, f"wire_dp_{mode}_flat"):
        steps = [dict(got, carry=np.zeros_like(got["carry"]) if fault == "zeroed" else -got["carry"])
                 for got in res["steps"]]
        results.append(dict(res, steps=steps))
    with pytest.raises(AssertionError, match="elements differ"):
        _check_dp(results, ref, mode)
