"""K9's kernels on a card: the Hopper path (``csrc/attention_sm90.cu``: bfloat16
at D = 64, 128, 256 and float32 at D = 64 in 3xTF32) and ``csrc/attention.cu``
(the ``mma.sync`` kernel for bfloat16, the FP32 kernel for float32), each
against the plain version and against each other on the same inputs.

This module imports neither JAX nor heat_tpu, so that it runs where only
PyTorch and a card are (the repo's ``conftest.py`` imports JAX, so there it
runs as ``python -m pytest --noconftest -m cuda tests/test_torch_attention_card.py``).
Without a card every test skips.

Limits, as in ``chip_smoke.py``: bfloat16 elementwise |Δo| ≤ 3 · 2^-8 (|ro| +
A), A the float32 attention of |v| on the same q and k (p is rounded to bf16
for the second product, o to bf16 on both sides), and |Δlse| ≤ 1e-4 (1 +
|lse|); float32 |Δo| ≤ 1e-5 max|v| of each (batch, head) slice and |Δlse| ≤
1e-5 (1 + |lse|) (both sides sum float32 terms in other orders; 3xTF32 keeps
each product to 2^-22 of its terms); reruns bit for bit.
"""

import pytest
import torch

from heat_tpu_torch.kernels import attention as ka

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K9 has no CPU mode")
    return torch.device("cuda")


def _qkv(bh, s_q, s_kv, d, seed, width=None, dtype=torch.bfloat16, d_v=None, mult=1.0):
    """q, k and v on the card (bf16 unless ``dtype``; v with ``d_v``
    columns if given; q times ``mult``); with ``width``, views of D columns
    that start one element into rows of ``width`` (bases off 16 bytes)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = width or d
    off = 1 if width else 0
    q, k, v = (
        torch.randn(bh + (s, w), device=dev, generator=gen).to(dtype)[..., off:off + d] for s in (s_q, s_kv, s_kv)
    )
    if d_v is not None:
        v = torch.randn(bh + (s_kv, d_v), device=dev, generator=gen).to(dtype)
    return (q * mult).to(dtype), k, v


def _assert_within(o, lse, ro, rl, q, k, v, causal):
    if q.dtype == torch.float32:
        limit = 1e-5 * v.abs().amax(dim=(-2, -1), keepdim=True)
        tol_l = 1e-5
    else:
        a, _ = ka.flash_attention_plain(q.float(), k.float(), v.float().abs(), causal)
        limit = 3 * 2.0**-8 * (ro.float().abs() + a)
        tol_l = 1e-4
    assert bool(((o.float() - ro.float()).abs() <= limit).all())
    assert torch.equal(torch.isneginf(lse), torch.isneginf(rl))
    live = ~torch.isneginf(rl)
    assert bool(((lse - rl).abs()[live] <= tol_l * (1 + rl.abs()[live])).all())


@pytest.mark.parametrize("bh,s_q,s_kv,d,causal", [
    ((2, 3), 1000, 1000, 64, True), ((2, 3), 1000, 1000, 64, False), ((2, 3), 1000, 1000, 128, True),
    ((2, 3), 1000, 1000, 128, False), ((4,), 300, 1003, 64, True), ((4,), 300, 1003, 128, True),
    ((4, 8), 1, 4096, 64, False), ((4, 8), 1, 4096, 128, False), ((4, 8), 4096, 4096, 64, True),
    ((2, 3), 1000, 1000, 256, True), ((2, 3), 1000, 1000, 256, False), ((4,), 300, 1003, 256, True),
    ((4, 8), 1, 4096, 256, False), ((1, 8), 4096, 4096, 256, True),
])
def test_hopper_path_matches_plain_version_and_mma_sync_kernel_on_card(bh, s_q, s_kv, d, causal):
    """The Hopper path against the plain version and against the mma.sync
    kernel, and the mma.sync kernel against the plain version."""
    q, k, v = _qkv(bh, s_q, s_kv, d, s_q + d)
    launches = ka.ATTENTION_SM90_LAUNCHES
    o, lse = ka.flash_attention(q, k, v, causal)
    assert ka.ATTENTION_SM90_LAUNCHES == launches + 1
    ro, rl = ka.flash_attention_plain(q, k, v, causal)
    mo, ml = ka._flash_attention_attention_cu(q, k, v, causal)
    assert ka.ATTENTION_SM90_LAUNCHES == launches + 1
    _assert_within(o, lse, ro, rl, q, k, v, causal)
    _assert_within(mo, ml, ro, rl, q, k, v, causal)
    _assert_within(o, lse, mo, ml, q, k, v, causal)
    o2, l2 = ka.flash_attention(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, l2)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_hopper_path_reads_packed_heads_in_place_on_card(d):
    """MultiheadAttention's strided heads give the bits of contiguous copies."""
    _assert_packed_heads_read_in_place(torch.bfloat16, d)


def test_float32_hopper_kernel_reads_packed_heads_in_place_on_card():
    _assert_packed_heads_read_in_place(torch.float32, 64)


def _assert_packed_heads_read_in_place(dtype, d):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(d)
    qkv = torch.randn(2, 300, 3, 4, d, device=dev, generator=gen).to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    launches = ka.ATTENTION_SM90_LAUNCHES
    o, lse = ka.flash_attention(q, k, v, True)
    oc, lc = ka.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), True)
    assert ka.ATTENTION_SM90_LAUNCHES == launches + 2
    assert torch.equal(o, oc) and torch.equal(lse, lc)


@pytest.mark.parametrize("bh,s_q,s_kv,d,width", [
    ((2, 3), 1003, 1003, 48, None), ((4,), 300, 1003, 48, None), ((2, 3), 1003, 1003, 96, None),
    ((4,), 300, 1003, 96, None), ((2, 3), 1003, 1003, 128, 136),
])
def test_mma_sync_kernel_serves_bf16_shapes_off_the_hopper_path_on_card(bh, s_q, s_kv, d, width):
    """Causal bf16 shapes that the Hopper path refuses (D = 48, D = 96, and
    D = 128 views whose bases are off 16 bytes) launch the mma.sync kernel,
    within the limits of the plain version; reruns bit for bit."""
    q, k, v = _qkv(bh, s_q, s_kv, d, s_q + d, width)
    launches, launches_sm90 = ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES
    o, lse = ka.flash_attention(q, k, v, True)
    assert (ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES) == (launches + 1, launches_sm90)
    _assert_within(o, lse, *ka.flash_attention_plain(q, k, v, True), q, k, v, True)
    o2, l2 = ka.flash_attention(q, k, v, True)
    assert torch.equal(o, o2) and torch.equal(lse, l2)


@pytest.mark.parametrize("bh,s_q,s_kv,causal,mult", [
    ((2, 3), 1000, 1000, True, 1.0), ((2, 3), 1000, 1000, False, 1.0), ((4,), 300, 1003, True, 1.0),
    ((4, 8), 1, 4096, False, 1.0), ((4, 8), 4096, 4096, True, 1.0), ((4, 8), 4096, 4096, False, 1.0),
    ((2, 8), 2048, 2048, True, 10.0),
])
def test_float32_hopper_kernel_matches_plain_version_and_fp32_kernel_on_card(bh, s_q, s_kv, causal, mult):
    """The 3xTF32 Hopper kernel against the plain version and against
    attention.cu's FP32 kernel, and that kernel against the plain version,
    at float32's limits; reruns bit for bit."""
    q, k, v = _qkv(bh, s_q, s_kv, 64, s_q + 7, dtype=torch.float32, mult=mult)
    launches = ka.ATTENTION_SM90_LAUNCHES
    o, lse = ka.flash_attention(q, k, v, causal)
    assert ka.ATTENTION_SM90_LAUNCHES == launches + 1
    ro, rl = ka.flash_attention_plain(q, k, v, causal)
    fo, fl = ka._flash_attention_attention_cu(q, k, v, causal)
    assert ka.ATTENTION_SM90_LAUNCHES == launches + 1
    _assert_within(o, lse, ro, rl, q, k, v, causal)
    _assert_within(fo, fl, ro, rl, q, k, v, causal)
    _assert_within(o, lse, fo, fl, q, k, v, causal)
    o2, l2 = ka.flash_attention(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, l2)


@pytest.mark.parametrize("d,d_v,width", [(128, 128, None), (64, 64, 72), (64, 32, None), (256, 256, None)])
def test_fp32_kernel_serves_float32_shapes_off_the_hopper_path_on_card(d, d_v, width):
    """float32 shapes that the Hopper path refuses (D = 128 and 256, views
    whose bases are off 16 bytes, D != D_v) launch attention.cu's FP32
    kernel, within the limits of the plain version; reruns bit for bit."""
    q, k, v = _qkv((2, 3), 1003, 1003, d, d + d_v, width, torch.float32, None if d_v == d else d_v)
    launches, launches_sm90 = ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES
    o, lse = ka.flash_attention(q, k, v, True)
    assert (ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES) == (launches + 1, launches_sm90)
    _assert_within(o, lse, *ka.flash_attention_plain(q, k, v, True), q, k, v, True)
    o2, l2 = ka.flash_attention(q, k, v, True)
    assert torch.equal(o, o2) and torch.equal(lse, l2)


def _global_mask_reference(q, k, v, delta):
    """(o, lse, the attention of |v|) in float64 with query i seeing key j
    iff j ≤ i + delta: a key block at another global offset than the
    queries', as the ring across ranks meets it."""
    q, k, v = (t.double() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    i = torch.arange(q.shape[-2], device=q.device)[:, None]
    j = torch.arange(k.shape[-2], device=q.device)[None, :]
    s = s.masked_fill(j > i + delta, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    live = ~torch.isneginf(lse)
    w = torch.where(live[..., None], torch.exp(s - torch.where(live, lse, 0.0)[..., None]), 0.0)
    return w @ v, lse, w @ v.abs()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("delta", [-201, -37, 0, 50, 130, 180])
def test_ring_blocks_at_any_offset_through_k9_on_card(dtype, delta):
    """The K9 calls of ``nn.attention._decompose`` (200 queries, a block of
    130 keys ``delta`` below them), combined through ``_fold``, give
    attention under the global causal mask at K9's limits against a float64
    result, every call on the Hopper path."""
    from heat_tpu_torch.nn import attention as natt

    q, k, v = _qkv((2, 4), 200, 130, 64, 31 + delta, dtype=dtype)
    calls = natt._decompose(200, 130, delta, True)
    launches = ka.ATTENTION_SM90_LAUNCHES
    acc = None
    for r0, k0, k1, masked in calls:
        acc = natt._fold(acc, r0, *ka.flash_attention(q[..., r0:, :], k[..., k0:k1, :], v[..., k0:k1, :], masked))
    assert ka.ATTENTION_SM90_LAUNCHES == launches + len(calls)
    ro, rl, a = _global_mask_reference(q, k, v, delta)
    if acc is None:
        assert bool(torch.isneginf(rl).all())
        return
    o, lse = acc
    limit = 1e-5 * v.float().abs().amax() if dtype == torch.float32 else 3 * 2.0**-8 * (ro.abs() + a)
    tol_l = 1e-5 if dtype == torch.float32 else 1e-4
    assert bool(((o.double() - ro).abs() <= limit).all())
    assert torch.equal(torch.isneginf(lse), torch.isneginf(rl))
    live = ~torch.isneginf(rl)
    assert bool(((lse.double() - rl).abs()[live] <= tol_l * (1 + rl.abs()[live])).all())
