"""heat_tpu_torch's local sort family (``ht.sort``, ``ht.unique``,
``ht.topk``) and kernel K4 against heat_tpu at world size 1.

Here, without a card, K4's plain version is held against heat_tpu's Pallas
block kernel in interpret mode, its XLA radix formulation and ``lax.sort``
per row. Everything here is integer or bit-level work, so every comparison
is exact: the key transforms bit for bit, indices exactly, values under the
sort's comparator (a value that comes back through the transform is +0.0
for −0.0 and the quiet NaN for any NaN), ``unique``'s representatives bit
for bit. The kernel itself runs only on a card: the ``cuda`` test compares
it with the plain version there.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu.kernels import sort as jsort
from heat_tpu_torch.kernels import sort as ks

KINDS = ["random", "sorted", "reverse", "const", "fewuniq", "nan"]
DTYPES = ["float32", "int32", "float64", "int64", "bool", "complex64"]
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])  # heat_tpu turns x64 on for the CPU with its first array


def _real(kind: str, n: int, dtype, rng) -> np.ndarray:
    if np.issubdtype(dtype, np.floating):
        x = rng.standard_normal(n).astype(dtype)
    elif dtype == np.bool_:
        x = rng.random(n) < 0.5
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    if kind == "sorted":
        x = np.sort(x)
    elif kind == "reverse":
        x = np.sort(x)[::-1].copy()
    elif kind == "const":
        x = np.full(n, x.flat[0])
    elif kind == "fewuniq":
        x = x[rng.integers(0, 7, n)]
    elif kind == "nan" and np.issubdtype(dtype, np.floating):
        x[rng.random(n) < 0.15] = np.nan
    return x


def _adversarial(kind: str, n: int, dtype) -> np.ndarray:
    """The kinds of tests/test_kernels_sort.py, for any dtype; complex
    draws both parts (NaNs in the real part)."""
    dtype = np.dtype(dtype).type
    rng = np.random.default_rng(KINDS.index(kind))
    if dtype == np.complex64:
        re = _real(kind, n, np.float32, rng)
        im = rng.standard_normal(n).astype(np.float32)
        if kind in ("const", "fewuniq"):
            im = np.where(np.isnan(re), im, np.float32(1.0))
        return (re + 1j * im).astype(np.complex64)
    return _real(kind, n, dtype, rng)


def _assert_same_under_comparator(got, ref):
    """Equal, with NaN slots matched as NaN (payloads may differ) and −0.0
    equal to +0.0."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if np.iscomplexobj(ref):
        _assert_same_under_comparator(got.real, ref.real)
        _assert_same_under_comparator(got.imag, ref.imag)
    elif np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_array_equal(got[~np.isnan(ref)], ref[~np.isnan(ref)])
    else:
        np.testing.assert_array_equal(got, ref)


def _assert_bits_equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if ref.dtype.kind == "f":
        got, ref = got.view(_UINT[ref.itemsize]), ref.view(_UINT[ref.itemsize])
    np.testing.assert_array_equal(got, ref)


def _u32(rng, n, high=2**32):
    return rng.integers(0, high, n, dtype=np.uint64).astype(np.uint32)


def _words(u: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u.view(np.int32).copy())


def _unsigned(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(_UINT[t.element_size()])


# --------------------------------------------------------------------- #
# key transforms                                                        #
# --------------------------------------------------------------------- #
F32_SPECIALS = np.array(
    [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF,
     0xFFFFFFFF, 0x00000001, 0x007FFFFF, 0x00800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x3F800000, 0xBF800000],
    dtype=np.uint32,
)


def _transform_inputs(name: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if name == "float32":
        return np.concatenate([F32_SPECIALS.view(np.float32), rng.standard_normal(300).astype(np.float32),
                               (rng.standard_normal(50) * 1e-42).astype(np.float32)])
    if name in ("float16", "float64"):
        dt = np.dtype(name)
        info = np.finfo(dt)
        u = _UINT[dt.itemsize]
        sign = u(1) << u(dt.itemsize * 8 - 1)
        exp_all = u(((1 << (dt.itemsize * 8 - 1 - info.nmant)) - 1) << info.nmant)
        specials = np.array([0, sign, exp_all, sign | exp_all, exp_all | (u(1) << u(info.nmant - 1)),
                             sign | exp_all | u(1), ~u(0), u(1), sign | u(1)], dtype=u)
        return np.concatenate([specials.view(dt), rng.standard_normal(300).astype(dt)])
    info = np.iinfo(name)
    edges = np.array([info.min, info.min + 1, -1 if info.min < 0 else 0, 0, 1, info.max - 1, info.max], dtype=name)
    return np.concatenate([edges, rng.integers(info.min, info.max, 500, dtype=name, endpoint=True)])


@pytest.mark.parametrize("name", ["float32", "int32", "int8", "int16", "uint8", "float16", "float64"])
def test_to_sortable_matches_heat_tpu_bit_for_bit(name):
    x = _transform_inputs(name)
    u = ks.to_sortable(torch.from_numpy(x))
    ref = np.asarray(jsort.to_sortable(jnp.asarray(x)))
    assert u.element_size() == x.itemsize
    np.testing.assert_array_equal(_unsigned(u), ref)
    back = ks.from_sortable(u, torch.from_numpy(x).dtype)
    ref_back = np.asarray(jsort.from_sortable(jnp.asarray(ref), x.dtype))
    _assert_bits_equal(back.numpy(), ref_back)
    # the order of the unsigned word is the comparator's (which, flushing
    # subnormals to zero on the CPU, ties them with 0: leave them out)
    if x.dtype.kind == "f":
        x = x[~((x != 0) & (np.abs(x) < np.finfo(x.dtype).tiny))]
    u = ks.to_sortable(torch.from_numpy(x))
    np.testing.assert_array_equal(np.argsort(_unsigned(u), kind="stable"),
                                  np.asarray(jax.lax.sort((jnp.asarray(x), jnp.arange(len(x))), num_keys=1)[1]))


def test_bfloat16_transform_matches_heat_tpu():
    bits = np.concatenate([np.array([0, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0xFFC1, 1, 0x3F80], np.uint16),
                           np.random.default_rng(3).integers(0, 2**16, 300, dtype=np.uint16)])
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    ref = np.asarray(jsort.to_sortable(jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)))
    np.testing.assert_array_equal(_unsigned(ks.to_sortable(x)), ref)
    back = ks.from_sortable(ks.to_sortable(x), torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    ref_back = np.asarray(jax.lax.bitcast_convert_type(jsort.from_sortable(jnp.asarray(ref), jnp.bfloat16), jnp.uint16))
    np.testing.assert_array_equal(back, ref_back)


def test_transformable_dtypes():
    assert all(ks.transformable(t) for t in (torch.float32, torch.int32, torch.float64, torch.uint8, torch.bfloat16))
    assert not any(ks.transformable(t) for t in (torch.bool, torch.complex64))
    with pytest.raises(TypeError):
        ks.to_sortable(torch.zeros(3, dtype=torch.complex64))


def test_total_order_key_is_ieee_total_order():
    """topk's key ranks +0 above −0 and a sign-bit NaN below −inf, and is
    a bijection (no tie classes), for the word and the int64 forms."""
    x = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, -np.nan, np.nan], np.float32)
    assert np.signbit(x[6]) and not np.signbit(x[7])
    expect = [6, 3, 5, 1, 0, 4, 2, 7]  # -NaN, -inf, -1, -0, +0, 1, inf, NaN
    for t in (torch.from_numpy(x), torch.from_numpy(x.astype(np.float64))):
        key = ks.sort_key(t, total=True)
        words = _unsigned(key) if key.dtype == torch.int32 else key.numpy()
        np.testing.assert_array_equal(np.argsort(words, kind="stable"), expect)
        assert len(np.unique(words)) == len(x)


# --------------------------------------------------------------------- #
# K4's plain version against heat_tpu's radix engines                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", KINDS)
def test_pair_sort_plain_matches_pallas_block_kernel(kind):
    """Position payload at pay_bytes=0 against the TPU kernel's iota at
    pay_bytes=2 (its passes over the iota are no-ops), in interpret mode."""
    n = 509
    u = np.asarray(jsort.to_sortable(jnp.asarray(_adversarial(kind, n, np.float32))))
    ref_k, ref_p = jsort._pallas_pair_sort(jnp.asarray(u), jnp.arange(n, dtype=jnp.uint32), pay_bytes=2)
    got_k, got_p = ks.pair_sort_plain(_words(u))
    np.testing.assert_array_equal(_unsigned(got_k), np.asarray(ref_k))
    np.testing.assert_array_equal(_unsigned(got_p), np.asarray(ref_p))


@pytest.mark.parametrize("n, distinct", [(512, 5), (300, 2**32)])
def test_pair_sort_plain_full_payload_matches_pallas_block_kernel(n, distinct):
    rng = np.random.default_rng(n)
    keys, pays = _u32(rng, n, distinct), _u32(rng, n)
    ref_k, ref_p = jsort._pallas_pair_sort(jnp.asarray(keys), jnp.asarray(pays), pay_bytes=4)
    got_k, got_p = ks.pair_sort_plain(_words(keys), _words(pays), pay_bytes=4)
    np.testing.assert_array_equal(_unsigned(got_k), np.asarray(ref_k))
    np.testing.assert_array_equal(_unsigned(got_p), np.asarray(ref_p))


@pytest.mark.parametrize("pay_bytes", [0, 1, 4])
def test_pair_sort_plain_matches_xla_radix(pay_bytes):
    rng = np.random.default_rng(4 + pay_bytes)
    n = 4096
    keys = _u32(rng, n, 300)
    pays = _u32(rng, n) if pay_bytes else np.arange(n, dtype=np.uint32)
    # the XLA formulation orders by the payload's low pay_bytes bytes; with
    # pay_bytes=0 the position payload is already in order
    ref_k, ref_p = jsort._radix_sort_xla((0, 1), (jnp.asarray(keys), jnp.asarray(pays)), (4, pay_bytes))
    got_k, got_p = ks.pair_sort_plain(_words(keys), _words(pays) if pay_bytes else None, pay_bytes=pay_bytes)
    np.testing.assert_array_equal(_unsigned(got_k), np.asarray(ref_k))
    np.testing.assert_array_equal(_unsigned(got_p), np.asarray(ref_p))


@pytest.mark.parametrize("rows, seg_len", [(40, 7), (6, 512), (3, 777), (2, ks.SEG_MAX)])
@pytest.mark.parametrize("with_pays", [False, True])
def test_pair_sort_plain_segments_match_lax_sort_per_row(rows, seg_len, with_pays):
    rng = np.random.default_rng(seg_len)
    keys = _u32(rng, rows * seg_len, 50)
    k2 = jnp.asarray(keys.reshape(rows, seg_len))
    if with_pays:
        pays = _u32(rng, rows * seg_len)
        ref = jax.lax.sort((k2, jnp.asarray(pays.reshape(rows, seg_len))), dimension=1, num_keys=2)
    else:
        iota = jax.lax.broadcasted_iota(jnp.uint32, (rows, seg_len), 1)
        ref = jax.lax.sort((k2, iota), dimension=1, num_keys=1, is_stable=True)
    got = ks.pair_sort(_words(keys), _words(pays) if with_pays else None, seg_len=seg_len,
                       pay_bytes=4 if with_pays else 0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_unsigned(g).reshape(rows, seg_len), np.asarray(r))


def test_pair_sort_checks_its_arguments():
    k = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(TypeError):
        ks.pair_sort(k.to(torch.int64))
    with pytest.raises(TypeError):
        ks.pair_sort(k, k.to(torch.int64))
    with pytest.raises(ValueError):
        ks.pair_sort(k, seg_len=5)
    with pytest.raises(ValueError):
        ks.pair_sort(k.reshape(3, 4))
    with pytest.raises(ValueError):
        ks.pair_sort(k, pay_bytes=2)  # orders by a payload it was not given
    with pytest.raises(ValueError):
        ks.pair_sort(k, k, pay_bytes=5)
    long = torch.zeros(2 * (ks.SEG_MAX + 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        ks.pair_sort(long, seg_len=ks.SEG_MAX + 1)
    sk, sp = ks.pair_sort(torch.zeros(0, dtype=torch.int32))
    assert sk.shape == sp.shape == (0,)
    sk, sp = ks.pair_sort(torch.tensor([-5], dtype=torch.int32))
    assert sk.tolist() == [-5] and sp.tolist() == [0]


def test_cuda_tensors_launch_or_raise_never_compute_on_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensors below would be launched")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA operand reached the plain version")

    monkeypatch.setattr(ks, "pair_sort_plain", refuse)
    launches = ks.SORT_LAUNCHES
    host = torch.zeros(64, dtype=torch.int32)
    with FakeTensorMode():
        k = torch.empty(64, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError):  # nothing here can build or launch the kernel
            ks.pair_sort(k)
        with pytest.raises(ValueError):  # operands on two devices
            ks.pair_sort(k, host)
        with pytest.raises(TypeError):  # the kernel takes int32 words only
            ks.pair_sort(k.to(torch.int64))
    assert ks.SORT_LAUNCHES == launches


@pytest.mark.parametrize(
    "shape, dtype, axis, k4",
    [
        ((1000,), torch.float32, 0, True),
        ((5000,), torch.int32, -1, True),
        ((64, ks.SEG_MAX), torch.float32, 1, True),
        ((ks.SEG_MAX, 64), torch.float32, 0, True),
        ((4, ks.SEG_MAX + 1), torch.float32, -1, False),
        ((1, 10_000), torch.int32, 1, True),
        ((1000,), torch.float64, 0, False),
        ((1000,), torch.float16, 0, False),
        ((1000,), torch.bool, 0, False),
        ((0,), torch.float32, 0, False),
        ((), torch.float32, 0, False),
    ],
)
def test_sort_serviceable(shape, dtype, axis, k4):
    assert ks.sort_serviceable(shape, dtype, axis) is k4


def test_sort_plan_bytes():
    """The one-sweep model: histogram 4, pass 1 4 + 8, passes 2-3 8 + 8,
    pass 4 8 + 12 B a pair; the row sort reads and writes once."""
    n = 1 << 27
    b = ks.sort_plan(n)
    assert b["path"] == "radix_b" and b["passes"] == 4 and b["floor_bytes"] == 16 * n
    assert b["hbm_bytes"] == 68 * n == 9_126_805_504
    assert b["lookback_bytes"] == 4 * 3 * 8 * 256 * (n // 4096)
    a = ks.sort_plan(n, seg_len=512)
    assert a["path"] == "radix_a" and a["hbm_bytes"] == 16 * n == a["floor_bytes"]
    assert ks.sort_plan(n, torch.float64)["path"] == "torch"
    assert ks.sort_plan(2 * 5000, seg_len=5000)["path"] == "torch"  # long rows of an N-D array


# --------------------------------------------------------------------- #
# K4's fused entry: the key transforms in its first and last passes     #
# --------------------------------------------------------------------- #
I32_EXTREMES = np.array([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], np.int32)
FUSED_KINDS = ["specials", "sorted", "reverse", "fewuniq", "nan"]
FUSED_LAYOUTS = {"one_segment": (2 * ks.SEG_MAX + 3,), "rows_of_512": (6, 512)}


def _fused_input(kind: str, shape, dtype: str, subnormals: bool = True) -> np.ndarray:
    """The kinds of ``_adversarial``, and ``specials``: randn or random
    int32 with half the elements drawn from the special bit patterns (NaNs
    with payloads and either sign bit, ±0, subnormals, ±inf, ±max; the
    int32 extremes). Without ``subnormals`` the pool has none: heat_tpu's
    CPU sort flushes them to zero, where the port orders them strictly."""
    n = int(np.prod(shape))
    if kind != "specials":
        return _adversarial(kind, n, dtype).reshape(shape)
    rng = np.random.default_rng(n)
    x = _adversarial("random", n, dtype)
    pool = F32_SPECIALS.view(np.float32) if dtype == "float32" else I32_EXTREMES
    if not subnormals:
        pool = pool[~((pool != 0) & (np.abs(pool) < np.finfo(np.float32).tiny))]
    pick = rng.random(n) < 0.5
    x[pick] = pool[rng.integers(0, len(pool), int(pick.sum()))]
    return x.reshape(shape)


def _fused(x: np.ndarray, **kwargs):
    """``ks.fused_sort`` of ``x`` along its last axis, reshaped back."""
    v, i = ks.fused_sort(torch.from_numpy(x.reshape(-1).copy()), seg_len=x.shape[-1], **kwargs)
    return (None if v is None else v.numpy().reshape(x.shape)), i.numpy().reshape(x.shape)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("layout", list(FUSED_LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("kind", FUSED_KINDS)
def test_fused_sort_plain_matches_heat_tpu_sort(kind, dtype, layout, descending):
    """The fused route's plain version (what a CPU tensor takes) against
    ``heat_tpu.sort``: indices exactly, values under the comparator and
    canonical in its tie classes."""
    x = _fused_input(kind, FUSED_LAYOUTS[layout], dtype, subnormals=False)
    v, i = _fused(x, descending=descending)
    ref_v, ref_i = jht.sort(jht.array(x), axis=-1, descending=descending)
    np.testing.assert_array_equal(i, ref_i.numpy())
    _assert_same_under_comparator(v, ref_v.numpy())
    if dtype == "float32":
        bits = v.view(np.uint32)
        assert not (bits == 0x80000000).any() and (bits[np.isnan(v)] == 0x7FC00000).all()
    else:
        np.testing.assert_array_equal(v, np.take_along_axis(x, i, -1))


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("layout", list(FUSED_LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_fused_sort_plain_total_order_matches_heat_tpu_topk(dtype, layout, largest):
    """totalOrder (``topk``'s key): the values come back bit for bit, the
    prefix is ``heat_tpu.topk``'s, and the index-only output is the same."""
    x = _fused_input("specials", FUSED_LAYOUTS[layout], dtype)
    if dtype == "int32" and not largest:
        x[x == np.iinfo(np.int32).min] = 0  # heat_tpu negates for the smallest: keep clear of overflow
    v, i = _fused(x, total=True, descending=largest)
    _assert_bits_equal(v, np.take_along_axis(x, i, -1))
    k = 37
    ref_v, ref_i = jht.topk(jht.array(x), k, dim=-1, largest=largest)
    np.testing.assert_array_equal(i[..., :k], ref_i.numpy())
    _assert_bits_equal(v[..., :k], ref_v.numpy())
    none, only = _fused(x, total=True, descending=largest, out=None)
    assert none is None
    np.testing.assert_array_equal(only, i)


@pytest.mark.parametrize("n", [2 * ks.SEG_MAX + 3, 500])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("kind", ["specials", "fewuniq"])
def test_fused_sort_plain_words_match_heat_tpu_unique(kind, dtype, n):
    """The key words (``unique``'s output): grouped on, they give
    ``heat_tpu.unique``'s values and inverse."""
    x = _fused_input(kind, (n,), dtype, subnormals=False)
    words, perm = _fused(x, out="words")
    np.testing.assert_array_equal(words, ks.sort_key(torch.from_numpy(x)).numpy()[perm])
    start = np.r_[True, words[1:] != words[:-1]]
    inverse = np.empty(n, np.int64)
    inverse[perm] = np.cumsum(start) - 1
    values = x[perm[start]]
    ref_v, ref_inv = (t.numpy() for t in jht.unique(jht.array(x), return_inverse=True))
    if dtype == "float32":
        nan = np.isnan(ref_v)
        np.testing.assert_array_equal(np.isnan(values), nan)
        _assert_bits_equal(values[~nan], ref_v[~nan])
    else:
        np.testing.assert_array_equal(values, ref_v)
    np.testing.assert_array_equal(inverse, ref_inv)


def _total_key(x: np.ndarray) -> np.ndarray:
    s = x.view(np.int32)
    return (s ^ ((s >> 31) | np.int32(-(2**31)))).view(np.uint32)


@pytest.mark.parametrize("seg_len", [None, 500])
@pytest.mark.parametrize("total", [False, True])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_fused_sort_plain_is_heat_tpus_transform_composition(dtype, descending, total, seg_len):
    """Bit for bit, subnormals included: heat_tpu's ``to_sortable`` (or the
    totalOrder bijection), complemented when descending, numpy's stable
    argsort per segment, and heat_tpu's ``from_sortable`` (or the bits of
    the input in that order)."""
    x = _fused_input("specials", (3000,), dtype)
    if total and dtype == "float32":
        key = _total_key(x)
    else:
        key = np.asarray(jsort.to_sortable(jnp.asarray(x)))
    key = ~key if descending else key
    seg = seg_len or len(x)
    order = np.argsort(key.reshape(-1, seg), axis=1, kind="stable").reshape(-1)
    rows = np.repeat(np.arange(len(x) // seg) * seg, seg)
    t = torch.from_numpy(x)
    v, i = ks.fused_sort(t, seg_len=seg_len, total=total, descending=descending)
    np.testing.assert_array_equal(i.numpy(), order)
    sk = key[rows + order]
    if total:
        _assert_bits_equal(v.numpy(), x[rows + order])
    else:
        ref = np.asarray(jsort.from_sortable(jnp.asarray(~sk if descending else sk), x.dtype))
        _assert_bits_equal(v.numpy(), ref)
    words, _ = ks.fused_sort(t, seg_len=seg_len, total=total, descending=descending, out="words")
    np.testing.assert_array_equal(_unsigned(words), sk)


def test_fused_sort_checks_its_arguments():
    x = torch.zeros(12)
    with pytest.raises(TypeError):
        ks.fused_sort(x.double())
    with pytest.raises(ValueError):
        ks.fused_sort(x.reshape(3, 4))
    with pytest.raises(ValueError):
        ks.fused_sort(x, out="keys")
    with pytest.raises(ValueError):
        ks.fused_sort(x, seg_len=5)
    with pytest.raises(ValueError):
        ks.fused_sort(torch.zeros(2 * (ks.SEG_MAX + 1)), seg_len=ks.SEG_MAX + 1)
    v, i = ks.fused_sort(torch.zeros(0))
    assert v.shape == i.shape == (0,) and i.dtype == torch.int64


@pytest.mark.parametrize("seg_len, pay_bytes", [(None, 0), (777, 4), (2 * ks.SEG_MAX + 1, 2)])
def test_first_design_helper_is_the_pair_sort_on_cpu(seg_len, pay_bytes):
    rng = np.random.default_rng(7)
    n = 3 * 777 if seg_len in (None, 777) else seg_len
    keys, pays = _words(_u32(rng, n, 40)), _words(_u32(rng, n))
    p = pays if pay_bytes else None
    for g, r in zip(ks._pair_sort_pr3(keys, p, seg_len, pay_bytes), ks.pair_sort(keys, p, seg_len, pay_bytes)):
        assert torch.equal(g, r)


def test_cuda_sorts_reach_the_fused_entry_with_no_elementwise_transform(monkeypatch):
    """On CUDA tensors, ``ht.sort``, ``ht.topk`` and ``ht.unique`` of
    float32 and int32 call K4's fused entry once, with the transform,
    order and output flags of their route, and run no transform and no
    elementwise kernel over the array: every op that makes a tensor of the
    array's size is an allocation or a view."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensors below would be launched")
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from heat_tpu_torch.core.dndarray import DNDarray

    class Stop(Exception):
        pass

    calls, made = [], []
    stop_at_entry = [False]

    class Lib:
        def heat_radix_scratch_words(self, n_seg, seg_len):
            return 0 if seg_len <= ks.SEG_MAX else 2 * seg_len + 4096

        def heat_radix_sort(self, keys, pays, out_v, out_i, scratch, n_seg, seg_len, pay_bytes, mode, descending,
                            words, idx64, device, stream):
            calls.append((n_seg, seg_len, pays is None, pay_bytes, mode, descending, out_v is not None, words, idx64))
            if stop_at_entry[0]:
                raise Stop
            return 0

        def heat_radix_error_string(self, code):
            return b"none"

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            made.extend((str(func), t.numel()) for t in tree_leaves(out) if isinstance(t, torch.Tensor))
            return out

    def refuse(*args, **kwargs):
        raise AssertionError("a transform or plain version ran on a CUDA operand")

    for name in ("to_sortable", "from_sortable", "sort_key", "sort_keys", "_from_total", "pair_sort_plain",
                 "fused_sort_plain"):
        monkeypatch.setattr(ks, name, refuse)
    monkeypatch.setattr(ks, "_lib", Lib)
    monkeypatch.setattr(ks, "_stream", lambda dev: 0)
    views = ("aten.view", "aten.permute", "aten.detach", "aten.slice", "aten.empty", "aten.alias", "prim.")
    ref = ht.zeros(1)
    n = 3 * ks.SEG_MAX + 5
    launches = ks.SORT_LAUNCHES
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # FakeTensor.data_ptr() is deprecated
        with FakeTensorMode():
            for dtype, mode in ((torch.float32, 1), (torch.int32, 3)):
                for shape, seg in (((n,), n), ((64, 512), 512)):
                    x = torch.empty(shape, dtype=dtype, device="cuda")
                    a = DNDarray(x, shape, ht.float32 if dtype == torch.float32 else ht.int32, 0, ref.device,
                                 ref.comm)
                    n_seg = x.numel() // seg
                    total = 3 if dtype == torch.int32 else 2
                    # (call, (mode, descending, values written, words), stop at the entry): the
                    # fake tensors cannot run what follows unique's sort or a row topk's
                    cases = [
                        (lambda: ht.sort(a), (mode, 0, True, 0), False),
                        (lambda: ht.sort(a, descending=True), (mode, 1, True, 0), False),
                        (lambda: ht.topk(a, 5), (total, 1, False, 0), len(shape) > 1),
                        (lambda: ht.topk(a, 5, largest=False), (total, 0, False, 0), len(shape) > 1),
                    ]
                    if len(shape) == 1:
                        cases.append((lambda: ht.unique(a, return_inverse=True), (mode, 0, True, 1), True))
                    for call, flags, stop in cases:
                        calls.clear()
                        made.clear()
                        stop_at_entry[0] = stop
                        with Ops():
                            try:
                                call()
                            except Stop:
                                pass
                        assert calls == [(n_seg, seg, True, 0, *flags, 1)]
                        big = [op for op, numel in made if numel == x.numel() and not op.startswith(views)]
                        assert big == [], big
    assert ks.SORT_LAUNCHES == launches + 12  # the calls that did not stop at the entry


# --------------------------------------------------------------------- #
# ht.sort                                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_sort_matches_heat_tpu(kind, dtype, axis, descending):
    x = _adversarial(kind, 23 * 19, dtype).reshape(23, 19)
    got_v, got_i = ht.sort(ht.array(x, split=0), axis=axis, descending=descending)
    ref_v, ref_i = jht.sort(jht.array(x), axis=axis, descending=descending)
    np.testing.assert_array_equal(got_i.numpy(), ref_i.numpy())
    _assert_same_under_comparator(got_v.numpy(), ref_v.numpy())
    assert got_v.split == 0 and got_i.split == 0
    assert got_v.dtype is getattr(ht, dtype) and got_i.dtype is ht.int64


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("kind", KINDS)
def test_sort_one_long_segment_matches_heat_tpu(kind, dtype, descending):
    """1-D beyond SEG_MAX (regime b's shape) and N-D rows beyond it (the
    library sort) agree with heat_tpu too."""
    x = _adversarial(kind, 2 * ks.SEG_MAX + 3, dtype)
    for arr in (x, x[: 2 * ks.SEG_MAX + 2].reshape(2, -1)):
        got_v, got_i = ht.sort(ht.array(arr), descending=descending)
        ref_v, ref_i = jht.sort(jht.array(arr), descending=descending)
        np.testing.assert_array_equal(got_i.numpy(), ref_i.numpy())
        _assert_same_under_comparator(got_v.numpy(), ref_v.numpy())


@pytest.mark.parametrize("dtype", ["int8", "int16", "uint8", "float16"])
def test_sort_narrow_dtypes_match_heat_tpu(dtype):
    x = _adversarial("nan" if dtype == "float16" else "random", 300, dtype)
    for descending in (False, True):
        got_v, got_i = ht.sort(ht.array(x), descending=descending)
        ref_v, ref_i = jht.sort(jht.array(x), descending=descending)
        np.testing.assert_array_equal(got_i.numpy(), ref_i.numpy())
        _assert_same_under_comparator(got_v.numpy(), ref_v.numpy())


def test_sort_values_are_canonical_in_the_tie_classes():
    x = np.array([-0.0, np.nan, 0.0, -1.0], np.float32)
    x[1] = np.array([0xFFC00001], np.uint32).view(np.float32)[0]  # a negative NaN with a payload
    v, i = ht.sort(ht.array(x))
    assert i.numpy().tolist() == [3, 0, 2, 1]
    np.testing.assert_array_equal(v.numpy().view(np.uint32), [0xBF800000, 0, 0, 0x7FC00000])


def test_sort_method_out_and_launch_count_on_cpu():
    x = ht.array(np.array([[3, 1, 2], [0, 5, 4]], np.int32), split=1)
    launches = ks.SORT_LAUNCHES
    out = ht.zeros((2, 3), dtype=ht.int32)
    v, i = x.sort(axis=1, out=out)
    assert v is out and out.numpy().tolist() == [[1, 2, 3], [0, 4, 5]]
    assert i.numpy().tolist() == [[1, 2, 0], [0, 2, 1]] and i.split == 1
    assert ks.SORT_LAUNCHES == launches  # CPU tensors take the plain version
    v, i = ht.sort(ht.array(np.float32(2.5)))
    assert v.shape == () and i.item() == 0


# --------------------------------------------------------------------- #
# ht.unique                                                             #
# --------------------------------------------------------------------- #
def _assert_unique_equal(got, ref):
    """Representatives bit for bit (NaNs as NaN), inverses exactly."""
    (gv, gi), (rv, ri) = got, ref
    gv, rv = gv.numpy(), rv.numpy()
    assert gv.shape == rv.shape and gv.dtype == rv.dtype
    if gv.dtype.kind in "fc":
        nan = np.isnan(rv)
        np.testing.assert_array_equal(np.isnan(gv), nan)
        np.testing.assert_array_equal(gv[~nan], rv[~nan])
        np.testing.assert_array_equal(np.signbit(gv.real[~nan]), np.signbit(rv.real[~nan]))
    else:
        np.testing.assert_array_equal(gv, rv)
    assert gi.shape == ri.shape
    np.testing.assert_array_equal(gi.numpy(), ri.numpy())


@pytest.mark.parametrize("dtype", DTYPES + ["int16", "float16"])
@pytest.mark.parametrize("kind", ["random", "fewuniq", "nan"])
def test_unique_matches_heat_tpu(kind, dtype):
    x = _adversarial(kind, 12 * 17, dtype).reshape(12, 17)
    if kind == "fewuniq" and np.dtype(dtype).kind == "f":
        x.flat[::5] = -0.0
        x.flat[1::5] = 0.0
    got = ht.unique(ht.array(x, split=0), return_inverse=True)
    ref = jht.unique(jht.array(x), return_inverse=True)
    _assert_unique_equal(got, ref)
    assert got[0].split == 0 and got[1].split is None and got[1].shape == (12, 17)
    np.testing.assert_array_equal(ht.unique(ht.array(x)).numpy().shape, got[0].shape)


@pytest.mark.parametrize("x", [[0.0, -0.0], [-0.0, 0.0], [1.0, np.nan, -0.0, np.nan, 0.0, 1.0]])
def test_unique_keeps_the_first_zero_and_one_nan(x):
    x = np.array(x, np.float32)
    _assert_unique_equal(ht.unique(ht.array(x), return_inverse=True), jht.unique(jht.array(x), return_inverse=True))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "complex64"])
def test_unique_axis_collapses_nan_and_signed_zero_rows(dtype, axis):
    rows = np.array([[1, np.nan, 2], [1, np.nan, 2], [0, 0, 0], [-0.0, 0, 0], [1, 2, 2], [0, 0, 0]])
    if dtype == "int32":
        rows = np.nan_to_num(rows, nan=7)
    x = rows.astype(dtype)
    if axis == 1:
        x = x.T.copy()
    got = ht.unique(ht.array(x), return_inverse=True, axis=axis)
    ref = jht.unique(jht.array(x), return_inverse=True, axis=axis)
    _assert_unique_equal(got, ref)


def test_unique_edge_shapes():
    for x in (np.zeros(0, np.float32), np.zeros((0, 3), np.int32), np.array(5.0, np.float32)):
        _assert_unique_equal(ht.unique(ht.array(x), return_inverse=True), jht.unique(jht.array(x), return_inverse=True))
    x = np.array([[3, 1], [3, 1], [0, 2]], np.int32)
    assert ht.array(x).unique(axis=0).numpy().tolist() == [[0, 2], [3, 1]]


# --------------------------------------------------------------------- #
# ht.topk                                                               #
# --------------------------------------------------------------------- #
def _topk_input(dtype):
    x = np.array([1, np.nan, 3, 3, -0.0, 0, np.nan, 3, -np.inf, np.inf, -0.0, 2], dtype)
    if np.dtype(dtype).kind == "f":
        u = _UINT[np.dtype(dtype).itemsize]
        bits = x.view(u)
        bits[6] |= u(1) << u(8 * np.dtype(dtype).itemsize - 1)  # a NaN with its sign bit set
    return x


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("k", [1, 5, 12])
@pytest.mark.parametrize("dtype", ["float32", "float64", "float16"])
def test_topk_matches_heat_tpu_on_ties_zeros_and_nans(dtype, k, largest):
    x = _topk_input(dtype)
    got_v, got_i = ht.topk(ht.array(x), k, largest=largest)
    ref_v, ref_i = jht.topk(jht.array(x), k, largest=largest)
    np.testing.assert_array_equal(got_i.numpy(), ref_i.numpy())
    _assert_bits_equal(got_v.numpy(), ref_v.numpy())


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "int32", "int64", "float64"])
@pytest.mark.parametrize("kind", ["fewuniq", "nan", "random"])
def test_topk_along_either_dim_matches_heat_tpu(kind, dtype, dim, largest):
    x = _adversarial(kind, 18 * 11, dtype).reshape(18, 11)
    if np.dtype(dtype).kind == "i":
        x[x == np.iinfo(dtype).min] = 0  # heat_tpu negates for the smallest: keep clear of overflow
    got_v, got_i = ht.array(x, split=0).topk(4, dim=dim, largest=largest)
    ref_v, ref_i = jht.topk(jht.array(x), 4, dim=dim, largest=largest)
    np.testing.assert_array_equal(got_i.numpy(), ref_i.numpy())
    _assert_bits_equal(got_v.numpy(), ref_v.numpy())
    assert got_i.dtype is ht.int64 and got_v.split == 0


def test_topk_smallest_is_the_true_order_for_integers():
    """heat_tpu takes the smallest as top_k(-x), which overflows at the
    type's minimum and wraps unsigned values; the port sorts ascending."""
    x = np.array([5, np.iinfo(np.int32).min, 3, np.iinfo(np.int32).max, 3], np.int32)
    assert ht.topk(ht.array(x), 3, largest=False)[1].numpy().tolist() == [1, 2, 4]
    x = np.array([0, 5, 255, 3], np.uint8)
    assert ht.topk(ht.array(x), 2, largest=False)[1].numpy().tolist() == [0, 3]


def test_topk_arguments_and_out():
    a = ht.array(np.arange(6, dtype=np.float32))
    with pytest.raises(ValueError):
        ht.topk(a, 7)
    with pytest.raises(TypeError):
        ht.topk(ht.array(np.ones(3, np.complex64)), 1)
    out = (ht.zeros(3), ht.zeros(3, dtype=ht.int64))
    res = ht.topk(a, 3, sorted=False, out=out)
    assert res is out and out[0].numpy().tolist() == [5, 4, 3] and out[1].numpy().tolist() == [5, 4, 3]


def test_flip_and_moveaxis_match_heat_tpu():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for axis in (None, 1, (0, 2)):
        np.testing.assert_array_equal(ht.flip(ht.array(x), axis).numpy(), jht.flip(jht.array(x), axis).numpy())
    got = ht.moveaxis(ht.array(x, split=2), [0, 1], [2, 0])
    ref = jht.moveaxis(jht.array(x, split=2), [0, 1], [2, 0])
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert got.split == ref.split and got.larray.is_contiguous()
