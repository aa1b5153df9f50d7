"""heat_tpu_torch's attention (kernel K9, ``ring_attention``,
``scaled_dot_product_attention``) against heat_tpu at world size 1.

Here, without a card, K9's plain version is held against heat_tpu's blocked
program (its oracle) and against its splash kernel in interpret mode, from
the same numpy inputs. Tolerances:

* float32 against the blocked program and heat_tpu's ring: rtol 2e-5,
  atol 2e-6, heat_tpu's own kernel-against-oracle bound
  (``tests/test_nn_optim.py:472``): both sides are float32 online
  softmaxes that sum in other orders.
* float32 lse against splash: atol 1e-5 (a log of a float32 sum over 256
  terms).
* bfloat16 against splash from the same bf16 inputs: o atol 1e-2 (splash
  rounds p to bf16 for its second product, the plain version keeps float32;
  both round o to bf16, 2^-8 relative), lse atol 1e-4. At D = 64 the scale
  is a power of two, so splash's pre-scaling of q in bf16 is exact.
* bfloat16 ``ring_attention`` against a float64 dense reference: rtol and
  atol 5e-2, heat_tpu's own bound (``tests/test_types_printing_misc.py:376``).

The kernel itself runs only on a card: the ``cuda`` test compares it with
the plain version there. Here the arithmetic of its float32 Hopper kernel
(3xTF32: each operand split into two TF32 halves, each product three TF32
products, the small terms first) is emulated with numpy on float32 bits and
held against a float64 result at ``chip_smoke.py``'s float32 limits,
|Δo| ≤ 1e-5 max|v| and |Δlse| ≤ 1e-5 (1 + |lse|); one-pass TF32 is shown to
miss them.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu.nn import attention as jatt
from heat_tpu_torch.kernels import attention as ka
from heat_tpu_torch.nn import attention as natt
from tf32_emulation import mm_1xtf32, mm_3xtf32, tf32_rna, tf32_split

RTOL, ATOL = 2e-5, 2e-6


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])  # heat_tpu turns x64 on for the CPU with its first array


def _qkv(shape_q, s_kv, d_v, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(dtype)
    k = rng.standard_normal(shape_q[:-2] + (s_kv, shape_q[-1])).astype(dtype)
    v = rng.standard_normal(shape_q[:-2] + (s_kv, d_v)).astype(dtype)
    return q, k, v


def _dense(q, k, v, causal, scale=None):
    """float64 softmax attention and its lse, numpy."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    scale = 1 / math.sqrt(q.shape[-1]) if scale is None else scale
    s = q @ np.swapaxes(k, -1, -2) * scale
    if causal:
        s = np.where(np.arange(k.shape[-2])[None, :] <= np.arange(q.shape[-2])[:, None], s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    lse = (m + np.log(p.sum(-1, keepdims=True)))[..., 0]
    return p @ v / p.sum(-1, keepdims=True), lse


def _blocked(q, k, v, causal, scale):
    prog = jatt._blocked_attention_program(q.shape, k.shape, v.shape, causal, scale, "float32")
    return np.asarray(prog(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --------------------------------------------------------------------- #
# the plain version of K9                                               #
# --------------------------------------------------------------------- #
SHAPES = [  # (q shape, S_kv, D_v)
    ((1, 2, 33, 8), 33, 8),
    ((2, 1, 70, 16), 50, 8),  # ragged, S_q > S_kv, D_v != D
    ((1, 2, 40, 8), 1500, 4),  # S_q < S_kv over two chunks of 1024
    ((3, 1100, 16), 1100, 16),  # 3-D, two chunks, the second ragged
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape_q,s_kv,d_v", SHAPES)
def test_plain_matches_blocked_program(shape_q, s_kv, d_v, causal):
    q, k, v = _qkv(shape_q, s_kv, d_v, seed=len(shape_q) + s_kv)
    scale = 1 / math.sqrt(shape_q[-1])
    o, lse = ka.flash_attention_plain(*_t(q, k, v), causal, scale)
    np.testing.assert_allclose(o.numpy(), _blocked(q, k, v, causal, scale), rtol=RTOL, atol=ATOL)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32 and lse.shape == shape_q[:-1]
    np.testing.assert_allclose(lse.numpy(), _dense(q, k, v, causal, scale)[1], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_splash_kernel(dtype, causal):
    b, h, s, d = 1, 2, 256, 64
    scale = 1 / math.sqrt(d)
    q, k, v = _qkv((b, h, s, d), s, d, seed=7)
    run = jatt._build_splash_mha(h, s, s, causal, scale, 128, 128, True, True)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(a).astype(jt) for a in (q, k, v))
    o_ref, lse_ref = run(jq, jk, jv)
    tq, tk, tv = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in (jq, jk, jv))
    o, lse = ka.flash_attention_plain(tq, tk, tv, causal, scale)
    assert o.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    o_ref = np.asarray(o_ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(o.numpy(), o_ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(o.float().numpy(), o_ref, rtol=0, atol=1e-2)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("split_at", [1, 512, 1023, 1500])
def test_ring_combine_of_two_halves_is_the_whole(split_at):
    q, k, v = _qkv((2, 3, 64, 8), 2000, 12, seed=split_at)
    tq, tk, tv = _t(q, k, v)
    o1, l1 = ka.flash_attention_plain(tq, tk[..., :split_at, :], tv[..., :split_at, :])
    o2, l2 = ka.flash_attention_plain(tq, tk[..., split_at:, :], tv[..., split_at:, :])
    o, lse = ka.combine_partials(o1, l1, o2, l2)
    o_ref, lse_ref = ka.flash_attention_plain(tq, tk, tv)
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), rtol=1e-6, atol=1e-5)


def test_combine_keeps_rows_without_keys_dead():
    o = torch.ones(1, 3, 2)
    dead = torch.full((1, 3), -math.inf)
    live = torch.tensor([[0.0, 1.0, -math.inf]])
    out, lse = ka.combine_partials(o, dead, 2 * o, live)
    assert torch.equal(out[0, :2], 2 * o[0, :2]) and torch.equal(out[0, 2], torch.zeros(2))
    assert torch.equal(lse, live)


def test_rows_without_valid_keys_and_empty_kv():
    q, k, v = _t(*_qkv((2, 5, 4), 0, 3))
    o, lse = ka.flash_attention(q, k, v, causal=True)
    assert o.shape == (2, 5, 3) and torch.equal(o, torch.zeros(2, 5, 3))
    assert lse.shape == (2, 5) and bool(torch.isneginf(lse).all())
    o, lse = ka.flash_attention(q[:, :0], *_t(*_qkv((2, 5, 4), 6, 3))[1:])
    assert o.shape == (2, 0, 3) and lse.shape == (2, 0)


def test_plain_serves_float64_float16_and_complex():
    q, k, v = _qkv((2, 9, 4), 11, 3, seed=3, dtype=np.float64)
    o, lse = ka.flash_attention_plain(*_t(q, k, v), True)
    assert o.dtype == torch.float64 and lse.dtype == torch.float64
    o_ref, lse_ref = _dense(q, k, v, True)
    np.testing.assert_allclose(o.numpy(), o_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=1e-12, atol=1e-12)
    o16, _ = ka.flash_attention_plain(*(t.half() for t in _t(q, k, v)), True)
    assert o16.dtype == torch.float16
    np.testing.assert_allclose(o16.float().numpy(), o_ref, rtol=0, atol=5e-3)
    # complex: the softmax of complex scores in complex128. heat_tpu shifts
    # by the lexicographic max and keeps a row only where the shifted sum
    # compares > 0, which can zero a row (ROADMAP.md, Queue 3); the port
    # shifts by the real parts' max and divides wherever the sum is not 0
    rng = np.random.default_rng(4)
    qc = (rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))).astype(np.complex64)
    s = qc.astype(np.complex128) @ qc.T.astype(np.complex128) / 2
    ref = np.exp(s) @ qc / np.exp(s).sum(-1, keepdims=True)
    oc, _ = ka.flash_attention_plain(*_t(qc, qc, qc))
    assert oc.dtype == torch.complex64
    np.testing.assert_allclose(oc.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_attention_serviceable():
    for dtype in (torch.float32, torch.bfloat16):
        assert ka.attention_serviceable(dtype, 1, 1)
        assert ka.attention_serviceable(dtype, 64, 64)
        assert ka.attention_serviceable(dtype, 72, 40)
        assert ka.attention_serviceable(dtype, 256, 256)
        assert not ka.attention_serviceable(dtype, 257, 64)
        assert not ka.attention_serviceable(dtype, 64, 257)
        assert not ka.attention_serviceable(dtype, 0, 64)
    for dtype in (torch.float64, torch.float16, torch.complex64, torch.int32):
        assert not ka.attention_serviceable(dtype, 64, 64)


@pytest.mark.parametrize("dtype,d", [(torch.float64, 8), (torch.float32, 300)])
def test_outside_the_predicate_takes_the_plain_version(monkeypatch, dtype, d):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called outside attention_serviceable")

    monkeypatch.setattr(ka, "flash_attention", refuse)
    q, k, v = (t.to(dtype) for t in _t(*_qkv((2, 17, d), 17, d, seed=d)))
    out = natt._single_device_attention(q, k, v, True)
    assert out.dtype == dtype
    np.testing.assert_allclose(out.numpy(), _dense(q.numpy(), k.numpy(), v.numpy(), True)[0], rtol=1e-5, atol=1e-6)


def test_cuda_tensors_launch_or_raise_never_compute_on_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensors below would be launched")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA operand reached the plain version")

    monkeypatch.setattr(ka, "flash_attention_plain", refuse)
    launches = ka.ATTENTION_LAUNCHES
    with FakeTensorMode():
        q = torch.empty(2, 8, 64, 16, device="cuda")
        with pytest.raises(RuntimeError):  # nothing here can build or launch the kernel
            ka.flash_attention(q, q, q, True)
        with pytest.raises(RuntimeError):  # the public route launches too
            natt._single_device_attention(q, q, q, True)
        with pytest.raises(TypeError):  # the kernel takes float32 and bfloat16 only
            ka.flash_attention(q.double(), q.double(), q.double())
        with pytest.raises(TypeError):  # one dtype for all three
            ka.flash_attention(q, q.bfloat16(), q)
        wide = torch.empty(1, 4, 300, device="cuda")
        with pytest.raises(ValueError):  # head dims above 256
            ka.flash_attention(wide, wide, wide)
        with pytest.raises(ValueError):  # k and v disagree on S_kv
            ka.flash_attention(q, q, torch.empty(2, 8, 3, 16, device="cuda"))
    assert ka.ATTENTION_LAUNCHES == launches


def _layout(t):
    """(data pointers, strides) of one operand as the wrapper reads it."""
    t4 = ka._as_bhsd(t)
    return t4.data_ptr(), ka._strides(t4)


def _sm90(dtype, *ts):
    layouts = [_layout(t) for t in ts]
    return ka.sm90_serviceable(dtype, ts[0].shape[-1], ts[-1].shape[-1], [p for p, _ in layouts],
                               [st for _, st in layouts])


def _assert_sm90_accepts(dtype, d):
    q = torch.zeros(2, 4, 100, d, dtype=dtype)
    assert _sm90(dtype, q, q, q)
    assert _sm90(dtype, q[:, :, :1], q, q)  # S_q = 1: a row stride along an extent of 1
    assert _sm90(dtype, q[0], q[0], q[0])  # (H, S, D)
    padded = torch.zeros(2, 4, 100, d + 16 // dtype.itemsize, dtype=dtype)[..., :d]  # rows 16 bytes apart
    assert _sm90(dtype, padded, padded, padded)
    # MultiheadAttention's heads: strided views of the packed projection
    # (nn/modules.py: a row stride of 3 E elements, a head stride of D)
    e, heads = 8 * d, 8
    qkv = torch.zeros(1, 37, 3 * e, dtype=dtype).reshape(1, 37, 3, heads, d)
    hq, hk, hv = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert hq.stride() == (37 * 3 * e, d, 3 * e, 1)
    assert _sm90(dtype, hq, hk, hv)


@pytest.mark.parametrize("d", [64, 128])
def test_sm90_predicate_accepts_aligned_bf16_at_64_and_128(d):
    _assert_sm90_accepts(torch.bfloat16, d)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 256), (torch.float32, 64)])
def test_sm90_predicate_accepts_aligned_bf16_at_256_and_float32_at_64(dtype, d):
    _assert_sm90_accepts(dtype, d)


def test_sm90_predicate_refuses_other_dtypes_dims_and_misaligned_views():
    bf, f32 = torch.bfloat16, torch.float32
    x = torch.zeros(2, 4, 100, 64, dtype=bf)
    assert not _sm90(torch.float16, x.half(), x.half(), x.half())
    for d in (8, 40, 72):
        y = torch.zeros(2, 4, 100, d, dtype=bf)
        assert not _sm90(bf, y, y, y)
    for d in (8, 32, 128, 256):  # float32 takes the Hopper path at D = 64 only
        y = torch.zeros(2, 4, 100, d, dtype=f32)
        assert not _sm90(f32, y, y, y)
    assert not _sm90(bf, x, x, torch.zeros(2, 4, 100, 128, dtype=bf))  # D != D_v
    assert not _sm90(bf, torch.zeros(2, 4, 100, 128, dtype=bf), torch.zeros(2, 4, 100, 128, dtype=bf), x)
    w = torch.zeros(2, 4, 100, 256, dtype=bf)
    assert not _sm90(bf, w, w, x)  # D = 256 with D_v = 64
    xf = x.float()
    assert not _sm90(f32, xf, xf, torch.zeros(2, 4, 100, 32, dtype=f32))  # D != D_v
    flat = torch.zeros(2 * 4 * 100 * 64 + 1, dtype=bf)
    odd = flat[1:].view(2, 4, 100, 64)  # starts 2 bytes past an aligned base
    assert odd.data_ptr() % 16 == 2
    assert not _sm90(bf, odd, x, x) and not _sm90(bf, x, x, odd)
    # a row stride of 65 elements: rows that do not start on 16 bytes
    rows = torch.zeros(2, 4, 100, 65, dtype=bf)[..., :64]
    assert not _sm90(bf, rows, x, x)
    # float32: bases 4, 8 and 12 bytes past 16, and a row stride of 66
    # elements (264 bytes)
    flat = torch.zeros(2 * 4 * 100 * 64 + 3, dtype=f32)
    for off in (1, 2, 3):
        odd = flat[off:off + 2 * 4 * 100 * 64].view(2, 4, 100, 64)
        assert odd.data_ptr() % 16 == 4 * off
        assert not _sm90(f32, odd, xf, xf) and not _sm90(f32, xf, odd, xf) and not _sm90(f32, xf, xf, odd)
    rows = torch.zeros(2, 4, 100, 66, dtype=f32)[..., :64]
    assert not _sm90(f32, rows, xf, xf)


def test_cuda_bf16_at_64_and_128_takes_the_hopper_path_or_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensors below would be launched")
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Sm90(RuntimeError):
        pass

    class AttentionCu(RuntimeError):
        pass

    _fake_libraries(monkeypatch, Sm90, AttentionCu)
    launches, launches_sm90 = ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES
    with FakeTensorMode():
        for d in (64, 128):
            q = torch.empty(2, 8, 64, d, device="cuda", dtype=torch.bfloat16)
            with pytest.raises(Sm90):
                ka.flash_attention(q, q, q, True)
            with pytest.raises(Sm90):  # the public route too
                natt._single_device_attention(q, q, q, True)
            with pytest.raises(AttentionCu):  # the private helper reaches the old kernel on the same shape
                ka._flash_attention_attention_cu(q, q, q, True)
            qf = torch.empty(2, 8, 64, d, device="cuda", dtype=torch.float32)
            # float32 takes the Hopper path at D = 64, the FP32 kernel at 128
            with pytest.raises(Sm90 if d == 64 else AttentionCu):
                ka.flash_attention(qf, qf, qf, True)
        for d in (8, 40, 72):
            q = torch.empty(2, 8, 64, d, device="cuda", dtype=torch.bfloat16)
            with pytest.raises(AttentionCu):
                ka.flash_attention(q, q, q)
        q = torch.empty(2, 8, 64, 256, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(Sm90):  # heads of 256 take the Hopper path
            ka.flash_attention(q, q, q)
        q = torch.empty(2, 8, 64, 128, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(AttentionCu):  # D != D_v
            ka.flash_attention(q, q, torch.empty(2, 8, 64, 64, device="cuda", dtype=torch.bfloat16))
    assert (ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES) == (launches, launches_sm90)


def _fake_libraries(monkeypatch, sm90_error, attention_cu_error):
    """Replace both kernel libraries with loaders that raise, each its own
    error, and the plain version with one that fails the test."""

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA operand reached the plain version")

    def sm90_lib():
        raise sm90_error("the Hopper path was chosen")

    def old_lib():
        raise attention_cu_error("attention.cu was chosen")

    monkeypatch.setattr(ka, "flash_attention_plain", refuse)
    monkeypatch.setattr(ka, "_lib_sm90", sm90_lib)
    monkeypatch.setattr(ka, "_lib", old_lib)


def test_cuda_float32_at_64_and_bf16_at_256_take_the_hopper_path_or_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensors below would be launched")
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Sm90(RuntimeError):
        pass

    class AttentionCu(RuntimeError):
        pass

    _fake_libraries(monkeypatch, Sm90, AttentionCu)
    launches, launches_sm90 = ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES
    with FakeTensorMode():
        for dtype, d in ((torch.float32, 64), (torch.bfloat16, 256)):
            q = torch.empty(2, 8, 300, d, device="cuda", dtype=dtype)
            for causal in (False, True):
                with pytest.raises(Sm90):
                    ka.flash_attention(q, q, q, causal)
                with pytest.raises(Sm90):  # the public route too
                    natt._single_device_attention(q, q, q, causal)
            with pytest.raises(Sm90):  # S_q = 1 against 4096 keys
                kv = torch.empty(2, 8, 4096, d, device="cuda", dtype=dtype)
                ka.flash_attention(torch.empty(2, 8, 1, d, device="cuda", dtype=dtype), kv, kv)
            with pytest.raises(AttentionCu):  # the private helper reaches attention.cu on the same shape
                ka._flash_attention_attention_cu(q, q, q, True)
            # MultiheadAttention's packed heads, read in place: (B, H, S, D)
            # views with a row stride of 3 E elements and a head stride of D
            e = 4 * d
            heads = torch.empty_strided((2, 4, 37, d), (37 * 3 * e, d, 3 * e, 1), device="cuda", dtype=dtype)
            with pytest.raises(Sm90):
                ka.flash_attention(heads, heads, heads, True)
            # rows 8 bytes longer than their data, so that they start off
            # 16 bytes: attention.cu
            stride = d + 8 // dtype.itemsize
            rows = torch.empty_strided((2, 8, 300, d), (8 * 300 * stride, 300 * stride, stride, 1), device="cuda",
                                       dtype=dtype)
            with pytest.raises(AttentionCu):
                ka.flash_attention(rows, q, q, True)
        w = torch.empty(2, 8, 300, 256, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(AttentionCu):  # D = 256 with D_v = 64
            ka.flash_attention(w, w, torch.empty(2, 8, 300, 64, device="cuda", dtype=torch.bfloat16))
        qf = torch.empty(2, 8, 300, 64, device="cuda", dtype=torch.float32)
        with pytest.raises(AttentionCu):  # float32 D != D_v
            ka.flash_attention(qf, qf, torch.empty(2, 8, 300, 32, device="cuda", dtype=torch.float32))
        for d in (8, 128, 256):  # float32 at other head dims
            qf = torch.empty(2, 8, 300, d, device="cuda", dtype=torch.float32)
            with pytest.raises(AttentionCu):
                ka.flash_attention(qf, qf, qf, True)
    assert (ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES) == (launches, launches_sm90)


# --------------------------------------------------------------------- #
# the 3xTF32 arithmetic of the float32 Hopper kernel, emulated          #
# --------------------------------------------------------------------- #
def _kernel_f32_attention(q, k, v, causal, mm, bn=64):
    """The float32 Hopper kernel's arithmetic on one (S, D) slice: tiles of
    ``bn`` keys, the online softmax on the raw scores with the scale in log2
    units and the shift in one fused multiply-add ahead of exp2, both
    products by ``mm``; o and lse in float32."""
    s_q, d = q.shape
    sl2 = np.float32(np.float32(1 / math.sqrt(d)) * np.float32(math.log2(math.e)))
    m = np.full(s_q, -np.inf, np.float32)
    l = np.zeros(s_q, np.float32)
    o = np.zeros((s_q, v.shape[1]), np.float32)
    rows = np.arange(s_q)[:, None]
    for k0 in range(0, k.shape[0], bn):
        s = mm(q, k[k0:k0 + bn].T)
        if causal:
            s = np.where(k0 + np.arange(s.shape[1])[None, :] > rows, np.float32(-np.inf), s)
        m_new = np.maximum(m, s.max(1) * sl2)
        shift = np.where(np.isneginf(m_new), np.float32(0), m_new)
        corr = np.exp2(m - shift)
        with np.errstate(invalid="ignore"):  # -inf - shift on masked scores
            p = np.exp2((s.astype(np.float64) * sl2 - shift[:, None]).astype(np.float32))
        l = l * corr + p.sum(1, dtype=np.float32)
        o = o * corr[:, None] + mm(p, v[k0:k0 + bn])
        m = m_new
    return o / l[:, None], (m + np.log2(l)) * np.float32(math.log(2))


def _f32_limit_shares(mm, mult, causal, seed=11):
    """(max |Δo| / (1e-5 max|v|), max |Δlse| / (1e-5 (1 + |lse|))) of the
    emulated kernel against float64, at D = 64, S = 512, two heads."""
    q, k, v = _qkv((2, 512, 64), 512, 64, seed=seed)
    q = (q * mult).astype(np.float32)
    eo = el = 0.0
    for i in range(q.shape[0]):
        o, lse = _kernel_f32_attention(q[i], k[i], v[i], causal, mm)
        ro, rl = _dense(q[i], k[i], v[i], causal)
        eo = max(eo, float(np.abs(o - ro).max() / (1e-5 * np.abs(v[i]).max())))
        el = max(el, float((np.abs(lse - rl) / (1e-5 * (1 + np.abs(rl)))).max()))
    return eo, el


def test_tf32_rounding_emulation():
    one = np.float32(1)
    ulp = np.float32(2.0**-10)  # TF32's spacing above 1
    x = np.array([1 + 2.0**-11, 1 + 2.0**-12, 1 + 3 * 2.0**-12, -(1 + 2.0**-11), 3.0, 0.0], np.float32)
    np.testing.assert_array_equal(tf32_rna(x), [one + ulp, one, one + ulp, -(one + ulp), 3.0, 0.0])
    r = np.random.default_rng(3).standard_normal(10_000).astype(np.float32) * 1e3
    big, small = tf32_split(r)
    assert not (big.view(np.uint32) & 0x1FFF).any() and not (small.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(r - big) <= 2.0**-11 * np.abs(r)).all()
    assert (np.abs(r.astype(np.float64) - big - small) <= 2.0**-22 * np.abs(r)).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mult", [1.0, 10.0])
def test_3xtf32_attention_stays_within_the_float32_limits(mult, causal):
    eo, el = _f32_limit_shares(mm_3xtf32, mult, causal)
    assert eo <= 1 and el <= 1, (eo, el)


@pytest.mark.parametrize("mult", [1.0, 10.0])
def test_one_pass_tf32_attention_misses_the_float32_limits(mult):
    eo, el = _f32_limit_shares(mm_1xtf32, mult, True)
    assert eo > 1, (eo, el)


def test_gradients_flow_through_the_kernel_route():
    q, k, v = (t.requires_grad_() for t in _t(*_qkv((2, 3, 20, 8), 20, 8, seed=5)))
    out = natt._single_device_attention(q, k, v, True)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    s = (q @ k.transpose(-1, -2)) / math.sqrt(8)
    s = s.masked_fill(torch.ones(20, 20, dtype=torch.bool).triu(1), -math.inf)
    ref = torch.softmax(s, -1) @ v
    for g, r in zip(grads, torch.autograd.grad(ref.square().sum(), (q, k, v))):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------- #
# ring_attention and scaled_dot_product_attention                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("split", [None, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_heat_tpu_float32(causal, split):
    q, k, v = _qkv((2, 3, 40, 8), 40, 8, seed=11)
    jq, jk, jv = (jht.array(a, split=split) for a in (q, k, v))
    ref = jht.nn.ring_attention(jq, jk, jv, causal=causal).numpy()
    tq, tk, tv = (ht.array(a, split=split) for a in (q, k, v))
    out = ht.nn.ring_attention(tq, tk, tv, causal=causal)
    assert out.split == split and out.shape == (2, 3, 40, 8) and out.dtype is ht.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_ring_attention_output_split_and_value_head_dim():
    q, k, v = _qkv((2, 24, 8), 30, 5, seed=12)
    tq, tk, tv = (ht.array(a, split=1) for a in (q, k, v))
    out = ht.nn.ring_attention(tq, tk, tv, scale=0.3)
    assert out.split == 1 and out.gshape == (2, 24, 5)
    jq, jk, jv = (jht.array(a, split=1) for a in (q, k, v))
    np.testing.assert_allclose(
        out.numpy(), jht.nn.ring_attention(jq, jk, jv, scale=0.3).numpy(), rtol=RTOL, atol=ATOL
    )
    self_att = ht.nn.ring_self_attention(tq, causal=True)
    np.testing.assert_allclose(
        self_att.numpy(), jht.nn.ring_self_attention(jq, causal=True).numpy(), rtol=RTOL, atol=ATOL
    )


def test_ring_attention_bfloat16_against_float64():
    rng = np.random.default_rng(9)
    qn = rng.standard_normal((64, 8)).astype(np.float32)
    qbf = ht.array(qn, dtype=ht.bfloat16, split=0)
    out = ht.nn.ring_attention(qbf, qbf, qbf, causal=True)
    assert out.dtype is ht.bfloat16 and out.split == 0
    q64 = qbf.numpy().astype(np.float64)
    np.testing.assert_allclose(out.numpy(), _dense(q64, q64, q64, True)[0], rtol=5e-2, atol=5e-2)


def test_ring_attention_argument_checks_match_heat_tpu():
    x = np.zeros((2, 6, 4), np.float32)
    cases = [
        lambda P, a: P.nn.ring_attention(x, a(x), a(x)),  # not a DNDarray
        lambda P, a: P.nn.ring_attention(a(x[0, 0]), a(x[0, 0]), a(x[0, 0])),  # 1-D
        lambda P, a: P.nn.ring_attention(a(x, split=0), a(x), a(x)),  # split off the sequence axis
        lambda P, a: P.nn.ring_attention(a(x), a(x), a(x[:, :5])),  # k and v disagree on S
        lambda P, a: P.nn.ring_attention(a(x), a(x[..., :3]), a(x)),  # q and k head dims
        lambda P, a: P.nn.ring_attention(a(x), a(x[:1]), a(x[:1])),  # batch dims
    ]
    for case in cases:
        errors = []
        for P in (jht, ht):
            with pytest.raises((TypeError, ValueError)) as info:
                case(P, P.array)
            errors.append(info.type)
        assert errors[0] is errors[1]


BACKWARD_SHAPES = ((7, 5), (5, 9), (3, 1100), (1100, 30))  # (S_q, S_kv): chunks of 1024 crossed both ways
BACKWARD_TOL = {torch.float64: 1e-12, torch.complex128: 1e-12, torch.float32: 1e-5}  # of the largest gradient


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q, s_kv", BACKWARD_SHAPES)
@pytest.mark.parametrize("dtype", list(BACKWARD_TOL), ids=str)
def test_flash_attention_backward_matches_autograd_of_the_plain_version(dtype, s_q, s_kv, causal):
    gen = torch.Generator().manual_seed(s_q + s_kv)
    q, k, v = (torch.randn((2, s, d), generator=gen, dtype=dtype) for s, d in ((s_q, 8), (s_kv, 8), (s_kv, 5)))
    o, lse = ka.flash_attention_plain(q, k, v, causal)
    do = torch.randn(o.shape, generator=gen, dtype=dtype)
    got = ka.flash_attention_backward(q, k, v, o, lse, do, causal)
    qa, ka_, va = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ka.flash_attention_plain(qa, ka_, va, causal)[0], (qa, ka_, va), do)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g - w).abs().max()) <= BACKWARD_TOL[dtype] * float(w.abs().max())


def test_flash_attention_backward_takes_nothing_from_a_row_that_sees_no_key():
    q, k, v = _t(*_qkv((2, 6, 8), 4, 8, seed=3))
    o, lse = ka.flash_attention_plain(q, k, v)
    o[..., 0, :], lse[..., 0] = 0.0, -math.inf
    dq, dk, dv = ka.flash_attention_backward(q, k, v, o, lse, torch.ones_like(o))
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert not bool(dq[..., 0, :].any())
    dq1, dk1, dv1 = ka.flash_attention_backward(q[..., 1:, :], k, v, o[..., 1:, :], lse[..., 1:], torch.ones_like(o[..., 1:, :]))
    assert torch.equal(dq[..., 1:, :], dq1) and torch.allclose(dk, dk1, atol=1e-6) and torch.allclose(dv, dv1, atol=1e-6)


def test_sdpa_both_routes_match_heat_tpu():
    rng = np.random.default_rng(0)
    S, D = 33, 8
    qn, kn, vn = (rng.standard_normal((S, D)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jht.nn.functional.scaled_dot_product_attention(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), is_causal=True))
    F = ht.nn.functional
    out = F.scaled_dot_product_attention(*(ht.array(a, split=0) for a in (qn, kn, vn)), is_causal=True)
    assert isinstance(out, ht.DNDarray) and out.split == 0
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    out2 = F.scaled_dot_product_attention(*_t(qn, kn, vn), is_causal=True)
    assert isinstance(out2, torch.Tensor)
    np.testing.assert_allclose(out2.numpy(), ref, rtol=RTOL, atol=ATOL)
    mixed = F.scaled_dot_product_attention(ht.array(qn, split=0), *_t(kn, vn), is_causal=True)
    assert isinstance(mixed, ht.DNDarray)
    np.testing.assert_allclose(mixed.numpy(), ref, rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError):
        F.scaled_dot_product_attention(*_t(qn, kn, vn), attn_mask=1)


def test_sdpa_promotes_integers_and_default_scale():
    rng = np.random.default_rng(1)
    qi = rng.integers(-3, 4, (10, 4)).astype(np.int32)
    ref = np.asarray(jht.nn.functional.scaled_dot_product_attention(
        jnp.asarray(qi), jnp.asarray(qi), jnp.asarray(qi), is_causal=True))
    out = ht.nn.functional.scaled_dot_product_attention(*_t(qi, qi, qi), is_causal=True)
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    dq = ht.array(qi, split=0)
    assert ht.nn.ring_attention(dq, dq, dq).dtype is ht.float32
    q, k, v = _t(*_qkv((3, 12, 16), 12, 16, seed=2))
    np.testing.assert_allclose(
        ht.nn.functional.scaled_dot_product_attention(q, k, v).numpy(),
        ht.nn.functional.scaled_dot_product_attention(q, k, v, scale=0.25).numpy(),
        rtol=0, atol=0,
    )


@pytest.mark.parametrize("shape_q,s_kv", [((7, 4), 12), ((3, 12, 4), 5), ((2, 1, 2, 9, 4), 9)])
@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_ranks_and_cross_lengths_match_heat_tpu(shape_q, s_kv, causal):
    q, k, v = _qkv(shape_q, s_kv, 4, seed=len(shape_q))
    ref = np.asarray(jht.nn.functional.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=causal))
    out = ht.nn.functional.scaled_dot_product_attention(*_t(q, k, v), is_causal=causal)
    assert out.shape == shape_q
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_sdpa_empty_keys_give_zeros():
    q, k, v = _qkv((2, 5, 4), 0, 4)
    ref = np.asarray(jht.nn.functional.scaled_dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = ht.nn.functional.scaled_dot_product_attention(*_t(q, k, v))
    assert out.shape == ref.shape == (2, 5, 4)
    assert not out.any() and not ref.any()


# --------------------------------------------------------------------- #
# the kernel on a card                                                  #
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,s_q,s_kv,d,d_v", [(6, 1000, 777, 72, 40), (3, 1003, 1003, 64, 64), (2, 1, 300, 256, 256)])
def test_kernel_matches_plain_version_on_card(bh, s_q, s_kv, d, d_v, causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K9 has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(s_q + d)
    dt = getattr(torch, dtype)
    q = torch.randn(bh, s_q, d, device=dev, generator=gen).to(dt)
    k = torch.randn(bh, s_kv, d, device=dev, generator=gen).to(dt)
    v = torch.randn(bh, s_kv, d_v, device=dev, generator=gen).to(dt)
    launches = ka.ATTENTION_LAUNCHES
    o, lse = ka.flash_attention(q, k, v, causal)
    assert ka.ATTENTION_LAUNCHES == launches + 1
    ro, rl = ka.flash_attention_plain(q, k, v, causal)
    tol_o, tol_l = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 1e-4)
    vmax = v.float().abs().amax(dim=(-2, -1), keepdim=True)
    assert bool(((o.float() - ro.float()).abs() <= tol_o * vmax).all())
    assert bool(((lse - rl).abs() <= tol_l * (1 + rl.abs())).all())
    o2, l2 = ka.flash_attention(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, l2)
