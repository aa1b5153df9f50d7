"""K8's kernels on a card: the Hopper kernel (``csrc/sddmm_sm90.cu``, 3xTF32
``wgmma``, TMA-fed) and ``csrc/spmm.cu``'s FP32 kernel, each against the
plain version and against each other on the same inputs.

This module imports neither JAX nor heat_tpu, so that it runs where only
PyTorch and a card are (the repo's ``conftest.py`` imports JAX, so there it
runs as ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_spmm_card.py``). Without a card every test skips.

Limit, as in ``chip_smoke.py``: |Δ| ≤ 1e-5 of |s|·(|u|·|v|ᵀ) elementwise
against the plain version in float64 (3xTF32 keeps each product to 2^-22
of its terms; float32 sums in another order stay within a few ulps of that
scale), and a rerun repeats the bits.
"""

import pytest
import torch

from heat_tpu_torch.kernels import spmm as ks

pytestmark = pytest.mark.cuda

TOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 has no CPU mode")
    return torch.device("cuda")


def _slab(m, n, bricks, seed, cols=None):
    """``bricks`` distinct random bricks of an (m, n) matrix on the card, in
    slab order (brow, then bcol), restricted to the brick columns ``cols``
    if given; returns (sdata, brow, bcol, corder, colptr, longest)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(seed)
    mb, nb = -(-m // 8), -(-n // 128)
    colset = torch.arange(nb, device=dev) if cols is None else torch.tensor(cols, device=dev)
    lin = torch.sort(torch.randperm(mb * len(colset), device=dev, generator=gen)[:bricks]).values
    brow, bcol = (lin // len(colset)).to(torch.int32), colset[lin % len(colset)].to(torch.int32)
    sdata = torch.randn(bricks, 8, 128, device=dev, generator=gen)
    cs, order = torch.sort(bcol, stable=True)
    colptr = torch.searchsorted(cs, torch.arange(nb + 1, dtype=torch.int32, device=dev), out_int32=True)
    longest = int((colptr[1:] - colptr[:-1]).max())
    return sdata, brow, bcol, order.to(torch.int32), colptr, longest


def _uv(m, n, d, seed, mult=1.0):
    gen = torch.Generator(device=_card()).manual_seed(seed)
    return (torch.randn(m, d, device="cuda", generator=gen) * mult,
            torch.randn(n, d, device="cuda", generator=gen) * mult)


def _check(slab, u, v, hopper):
    """K8 on the route its predicate picks (its counters must show which)
    against the plain version in float64 and against itself on a rerun; on
    the Hopper kernel spmm.cu's kernel too, on the same inputs."""
    sdata, brow, bcol, corder, colptr, longest = slab
    assert ks.sddmm_sm90_serviceable(u.shape[1], u.shape[0], (u.data_ptr(), v.data_ptr(), sdata.data_ptr())) is hopper
    launches, sm90 = ks.SDDMM_LAUNCHES, ks.SDDMM_SM90_LAUNCHES
    out = ks.brick_sddmm(sdata, brow, bcol, corder, colptr, longest, u, v)
    assert (ks.SDDMM_LAUNCHES, ks.SDDMM_SM90_LAUNCHES) == (launches + 1, sm90 + int(hopper))
    ref = ks.brick_sddmm_plain(sdata.double(), brow, bcol, u.double(), v.double())
    scale = ks.brick_sddmm_plain(sdata.double().abs(), brow, bcol, u.double().abs(), v.double().abs())
    assert bool(((out.double() - ref).abs() <= TOL * scale).all())
    assert torch.equal(out, ks.brick_sddmm(sdata, brow, bcol, corder, colptr, longest, u, v))
    if hopper:
        old = ks._brick_sddmm_spmm_cu(sdata, brow, bcol, corder, colptr, longest, u, v)
        assert bool(((old.double() - ref).abs() <= TOL * scale).all())
        assert bool(((out - old).abs().double() <= 2 * TOL * scale).all())


@pytest.mark.parametrize("mult", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("d", [4, 8, 60, 64, 72, 128])
def test_hopper_kernel_at_ragged_shapes(d, mult):
    # rows past m in the last brick row (1003 = 125 * 8 + 3), columns past n
    _check(_slab(1003, 777, 300, seed=d), *_uv(1003, 777, d, seed=d + 1, mult=mult), hopper=True)


def test_hopper_kernel_with_empty_brick_columns():
    # bricks only in brick columns 0, 3 and 6 of 8: the rest have no run
    _check(_slab(2048, 1024, 400, seed=3, cols=[0, 3, 6]), *_uv(2048, 1024, 64, seed=4), hopper=True)


def test_hopper_kernel_on_a_column_run_longer_than_a_block_slice():
    # 6000 bricks of one brick column: every block's slice lies inside it
    _check(_slab(6000 * 8, 128, 6000, seed=5), *_uv(6000 * 8, 128, 64, seed=6), hopper=True)


def test_hopper_kernel_on_one_brick_and_on_pad_bricks():
    sdata, brow, bcol, corder, colptr, longest = _slab(45, 300, 1, seed=7)
    _check((sdata, brow, bcol, corder, colptr, longest), *_uv(45, 300, 64, seed=8), hopper=True)
    pads = torch.zeros(3, 8, 128, device="cuda")
    zero = torch.zeros(3, dtype=torch.int32, device="cuda")
    sdata, brow, bcol = torch.cat([sdata, pads]), torch.cat([brow, zero]), torch.cat([bcol, zero])
    cs, order = torch.sort(bcol, stable=True)
    colptr = torch.searchsorted(cs, torch.arange(4, dtype=torch.int32, device="cuda"), out_int32=True)
    _check((sdata, brow, bcol, order.to(torch.int32), colptr, int((colptr[1:] - colptr[:-1]).max())),
           *_uv(45, 300, 64, seed=9), hopper=True)


@pytest.mark.parametrize("d", [1, 30, 66])
def test_d_off_a_multiple_of_4_takes_spmm_cu(d):
    _check(_slab(1003, 777, 300, seed=d), *_uv(1003, 777, d, seed=d), hopper=False)


@pytest.mark.parametrize("which", ["u", "v", "sdata"])
def test_operands_off_16_bytes_take_spmm_cu(which):
    slab = list(_slab(1003, 777, 300, seed=10))
    u, v = _uv(1003, 777, 64, seed=11)
    ops = {"u": u, "v": v, "sdata": slab[0]}
    t = ops[which]
    buf = torch.empty(t.numel() + 1, device="cuda")
    moved = buf[1:].view(t.shape)  # contiguous, 4 bytes past 16
    moved.copy_(t)
    ops[which] = moved
    slab[0] = ops["sdata"]
    _check(tuple(slab), ops["u"], ops["v"], hopper=False)
