"""Kernel K4 on a card (``csrc/radix_sort.cu``): both entries against their
plain versions, bit for bit.

``pair_sort`` (u32 words) against ``pair_sort_plain``, and ``fused_sort``
(float32 or int32 values, the key transforms in the kernel's first and
last passes) against ``fused_sort_plain``, the composition of ``sort_key``,
``pair_sort_plain`` and ``from_sortable``: in every transform mode and both
orders, at the tile boundaries of the one-sweep regime, on keys whose digit
places are constant (passes the kernel skips), and on reruns; the pair
sort at the shapes of the distributed networks' local steps, and
``block_sort`` on the card against its route on the CPU. K4 moves
integers, so every comparison is exact.

This module imports neither JAX nor heat_tpu, so that it runs where only
PyTorch and a card are (the repo's ``conftest.py`` imports JAX, so there it
runs as ``python -m pytest --noconftest -m cuda tests/test_torch_sort_card.py``).
Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from heat_tpu_torch.kernels import sort as ks

pytestmark = pytest.mark.cuda

TILE = 4096  # pairs of a one-sweep tile (csrc/radix_sort.cu)
F32_SPECIALS = np.array(
    [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF,
     0xFFFFFFFF, 0x00000001, 0x807FFFFF, 0x007FFFFF, 0x00800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x3F800000],
    dtype=np.uint32,
)
I32_EXTREMES = np.array([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], np.int32)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 has no CPU mode")
    return torch.device("cuda")


def _u32(rng, n, high=2**32):
    return rng.integers(0, high, n, dtype=np.uint64).astype(np.uint32)


def _words(u: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u.view(np.int32).copy())


def _values(kind: str, n: int, dtype: str, seed: int) -> np.ndarray:
    """randn or random int32; ``specials`` replaces half of them with the
    special bit patterns (NaNs with payloads and either sign bit, ±0,
    subnormals, ±inf, ±max; the int32 extremes)."""
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        x = rng.standard_normal(n).astype(np.float32)
        pool = F32_SPECIALS.view(np.float32)
    else:
        x = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
        pool = I32_EXTREMES
    if kind == "specials":
        pick = rng.random(n) < 0.5
        x[pick] = pool[rng.integers(0, len(pool), int(pick.sum()))]
    elif kind == "sorted":
        x = np.sort(x)
    elif kind == "const":
        x = np.full(n, x[0])
    elif kind == "fewuniq":
        x = x[rng.integers(0, 7, n)]
    return x


def _same(got, ref) -> None:
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.dtype == r.dtype and torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                                                      r.view(torch.int32) if r.dtype == torch.float32 else r)


def _check_fused(x: torch.Tensor, seg_len=None, **kwargs) -> None:
    launches = ks.SORT_LAUNCHES
    got = ks.fused_sort(x, seg_len, **kwargs)
    assert ks.SORT_LAUNCHES == launches + 1
    _same(got, ks.fused_sort_plain(x, seg_len, **kwargs))
    _same(got, ks.fused_sort(x, seg_len, **kwargs))  # a rerun gives the same bits


@pytest.mark.parametrize("n, seg_len, pay_bytes", [(1 << 16, None, 0), (30 * 777, 777, 4), (ks.SEG_MAX + 1, None, 0)])
def test_kernel_matches_plain_version_on_card(n, seg_len, pay_bytes):
    dev = _card()
    rng = np.random.default_rng(n)
    keys = _words(_u32(rng, n, 1000)).to(dev)
    pays = _words(_u32(rng, n)).to(dev) if pay_bytes else None
    launches = ks.SORT_LAUNCHES
    got = ks.pair_sort(keys, pays, seg_len, pay_bytes)
    ref = ks.pair_sort_plain(keys, pays, seg_len, pay_bytes)
    assert ks.SORT_LAUNCHES == launches + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("out", ["values", "words", None])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("total", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("kind", ["specials", "sorted", "fewuniq"])
@pytest.mark.parametrize("n, seg_len", [(3 * TILE + 5, None), (64 * 512, 512), (20 * 3000, 3000), (300 * 100, 100)])
def test_fused_entry_matches_plain_composition_on_card(n, seg_len, kind, dtype, total, descending, out):
    """Every transform (comparator, totalOrder, int32), both orders and
    every output, in the one-sweep regime and at segment lengths that take
    one warp (100), two (512) or a group of eight (3000)."""
    dev = _card()
    x = torch.from_numpy(_values(kind, n, dtype, n + len(kind))).to(dev)
    _check_fused(x, seg_len, total=total, descending=descending, out=out)


@pytest.mark.parametrize("n", [ks.SEG_MAX + 1, 2 * TILE - 1, 2 * TILE, 2 * TILE + 1, 3_000_017])
def test_one_sweep_tile_boundaries_on_card(n):
    """Both entries at tile boundaries and at an odd size of many tiles,
    with a generated and with a given payload (pay_bytes 0 and 3)."""
    dev = _card()
    rng = np.random.default_rng(n)
    keys = _words(_u32(rng, n)).to(dev)
    pays = _words(_u32(rng, n)).to(dev)
    for p, pay_bytes in ((None, 0), (pays, 0), (pays, 3)):
        got = ks.pair_sort(keys, p, None, pay_bytes)
        _same(got, ks.pair_sort_plain(keys, p, None, pay_bytes))
        _same(got, ks.pair_sort(keys, p, None, pay_bytes))
    _check_fused(keys.view(torch.float32), descending=True)
    # an input that starts off 16 bytes: the scalar loads
    _check_fused(keys[1:].view(torch.float32))


@pytest.mark.parametrize("case", ["all_equal", "top_byte_only", "randint_1000", "low_byte_constant"])
def test_constant_digit_places_on_card(case):
    """Keys whose digit is the same at some (or every) place: the kernel
    skips those passes and must still land the output, with the inverse
    transform, in the output."""
    dev = _card()
    n = 5 * TILE + 123
    rng = np.random.default_rng(5)
    if case == "all_equal":
        u = np.full(n, 0x3F800000, np.uint32)
    elif case == "top_byte_only":
        u = (rng.integers(0, 256, n, dtype=np.uint64).astype(np.uint32) << np.uint32(24)) | np.uint32(0x123456)
    elif case == "randint_1000":
        u = rng.integers(0, 1000, n).astype(np.uint32)
    else:
        u = (_u32(rng, n) & np.uint32(0xFFFFFF00)) | np.uint32(7)
    words = _words(u).to(dev)
    for dtype in (torch.float32, torch.int32):
        for descending in (False, True):
            for out in ("values", "words"):
                _check_fused(words.view(dtype), descending=descending, out=out)
    got = ks.pair_sort(words)
    _same(got, ks.pair_sort_plain(words))
    pays = _words(np.full(n, 0x01020304, np.uint32)).to(dev)
    _same(ks.pair_sort(words, pays, None, 4), ks.pair_sort_plain(words, pays, None, 4))


@pytest.mark.parametrize("n, seg_len", [(1 << 20, None), (2048 * 512, 512), (37 * 4096, 4096)])
def test_new_design_matches_first_design_on_card(n, seg_len):
    """The new kernels and the first design's on the same words, and reruns of both."""
    dev = _card()
    words = _words(_u32(np.random.default_rng(n), n)).to(dev)
    new = ks.pair_sort(words, None, seg_len)
    old = ks._pair_sort_pr3(words, None, seg_len)
    _same(new, old)
    _same(new, ks.pair_sort(words, None, seg_len))
    _same(old, ks._pair_sort_pr3(words, None, seg_len))


def _network_keys(n: int, seed: int):
    """float32 keys of the distributed networks' local steps: heavy ties
    (100 values) and 10% NaN."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-50, 50, n).astype(np.float32)
    x[rng.random(n) < 0.1] = np.nan
    return x, rng


@pytest.mark.parametrize("pay_bytes", [2, 4])
@pytest.mark.parametrize("n, seg_len", [(1 << 25, None), (2 * ((1 << 25) + 1), None), (1000 * 3000, 3000)])
def test_network_steps_match_plain_version_on_card(n, seg_len, pay_bytes):
    """K4 at the shapes of the distributed sort networks' local steps: a
    columnsort step of sort_1gb over 4 ranks (2^25 pairs), an odd-even
    merge of its ragged twin (2(2^25 + 1) pairs) and batch lanes of 2B;
    the global index as payload, ordered by its low 2 or 4 bytes."""
    dev = _card()
    x, rng = _network_keys(n, n + pay_bytes)
    pays = rng.permutation(n).astype(np.int32)
    if pay_bytes == 2:
        pays &= 0xFFFF
    keys, pays = ks.sort_key(torch.from_numpy(x)).to(dev), torch.from_numpy(pays).to(dev)
    got = ks.pair_sort(keys, pays, seg_len, pay_bytes)
    _same(got, ks.pair_sort_plain(keys, pays, seg_len, pay_bytes))


@pytest.mark.parametrize("num_keys", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("shape, dim", [((2 * 4097,), 0), ((3000, 5), 0), ((5, 2 * 1500), 1)])
def test_block_sort_launches_k4_and_equals_its_cpu_route_on_card(shape, dim, dtype, num_keys):
    """``block_sort`` on CUDA tensors launches K4 once and gives, bit for
    bit, what it gives on CPU copies (K4's plain version there)."""
    dev = _card()
    n = int(np.prod(shape))
    x, rng = _network_keys(n, n)
    if dtype == "int32":  # the NaNs become type-max, the sentinel's value
        x = np.where(np.isnan(x), 0, x).astype(np.int32) | np.where(np.isnan(x), 2**31 - 1, 0).astype(np.int32)
    x = x.reshape(shape)
    pos = np.broadcast_to(np.expand_dims(rng.permutation(70_000)[: shape[dim]], 1 - dim) if len(shape) == 2
                          else rng.permutation(70_000)[:n], shape)
    ops = [torch.from_numpy(x), torch.from_numpy(pos.astype(np.int64).copy())][:num_keys]
    launches = ks.SORT_LAUNCHES
    got = ks.block_sort([t.to(dev) for t in ops], dim, num_keys, extent=70_000)
    assert ks.SORT_LAUNCHES == launches + 1
    want = ks.block_sort(ops, dim, num_keys, extent=70_000)
    _same([g.cpu() for g in got], want)
