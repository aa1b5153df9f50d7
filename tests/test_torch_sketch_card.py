"""K1's and K2's kernels on a card: the Hopper kernels (``csrc/sketch_sm90.cu``,
3xTF32 ``wgmma``, TMA-fed) and ``csrc/sketch.cu``'s FP32 kernels, each
against the plain version and against each other on the same inputs.

This module imports neither JAX nor heat_tpu, so that it runs where only
PyTorch and a card are (the repo's ``conftest.py`` imports JAX, so there it
runs as ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_sketch_card.py``). Without a card every test skips.

Limits, as in ``chip_smoke.py``: w and y within relative Frobenius error
1e-5 and the norm within relative error 1e-6 of the plain version in
float64, and a rerun repeats the bits.
"""

import pytest
import torch

from heat_tpu_torch.core.linalg import _cuda_sketch as cs

pytestmark = pytest.mark.cuda

TOL_W, TOL_NORM = 1e-5, 1e-6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 have no CPU mode")
    return torch.device("cuda")


def _inputs(m, n, l, k, seed, mult=1.0):
    gen = torch.Generator(device=_card()).manual_seed(seed)
    a = torch.randn(m, n, device="cuda", generator=gen) * mult
    return a, torch.randn(l, m, device="cuda", generator=gen), torch.randn(n, k, device="cuda", generator=gen)


def _rel(x, ref) -> float:
    return float((x.double() - ref).norm() / ref.norm().clamp_min(1e-300))


def _within(got, ref):
    w, y, norm = got
    rw, ry, rn = ref
    return _rel(w, rw) <= TOL_W and _rel(y, ry) <= TOL_W and abs(float(norm) - float(rn)) <= TOL_NORM * float(rn)


def _check(a, g, omega, hopper):
    """K2 on the route its predicate picks (its counters must show which)
    against the plain version in float64 and against itself on a rerun; on
    the Hopper kernel sketch.cu's kernel too, on the same inputs."""
    assert cs.dual_sketch_sm90_serviceable(g.shape[0], omega.shape[1], a) is hopper
    launches, sm90 = cs.DUAL_LAUNCHES, cs.DUAL_SM90_LAUNCHES
    got = cs.dual_sketch_with_norm(g, omega, a)
    assert (cs.DUAL_LAUNCHES, cs.DUAL_SM90_LAUNCHES) == (launches + 1, sm90 + int(hopper))
    ref = cs.dual_sketch_with_norm_plain(g.double(), omega.double(), a.double())
    assert _within(got, ref)
    assert all(map(torch.equal, got, cs.dual_sketch_with_norm(g, omega, a)))
    if hopper:
        assert _within(cs._dual_sketch_with_norm_sketch_cu(g, omega, a), ref)


@pytest.mark.parametrize("mult", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("l, k", [(1, 1), (7, 3), (25, 24), (59, 24), (59, 25), (64, 32)])
def test_hopper_kernel_at_ragged_shapes(l, k, mult):
    # 1003 rows (past the last 64-row band), 776 columns (past a 512-column block)
    _check(*_inputs(1003, 776, l, k, seed=l + k, mult=mult), hopper=True)


@pytest.mark.parametrize("m, n", [(1, 4), (64, 512), (130, 8), (5000, 2048)])
def test_hopper_kernel_at_block_edges(m, n):
    _check(*_inputs(m, n, 59, 24, seed=m + n), hopper=True)


def test_hopper_kernel_at_the_main_shape():
    # 65536 x 8192: row splits of 8192 rows, the longest sums of the kernel
    _check(*_inputs(65536, 8192, 59, 24, seed=12), hopper=True)


@pytest.mark.parametrize("n", [777, 1001, 3])
def test_columns_off_a_multiple_of_4_take_sketch_cu(n):
    _check(*_inputs(1000, n, 59, 24, seed=n), hopper=False)


def test_a_off_16_bytes_takes_sketch_cu():
    a, g, omega = _inputs(1000, 776, 59, 24, seed=13)
    buf = torch.empty(a.numel() + 1, device="cuda")
    moved = buf[1:].view(a.shape)  # contiguous, 4 bytes past 16
    moved.copy_(a)
    _check(moved, g, omega, hopper=False)


def _check_k1(a, g, hopper):
    """K1 on the route its predicate picks (its counters must show which)
    against the plain version in float64 and against itself on a rerun; on
    the Hopper kernel sketch.cu's kernel too, on the same inputs."""
    assert cs.sketch_sm90_serviceable(g.shape[0], a) is hopper
    launches, sm90 = cs.SKETCH_LAUNCHES, cs.SKETCH_SM90_LAUNCHES
    w, norm = cs.sketch_with_norm(g, a)
    assert (cs.SKETCH_LAUNCHES, cs.SKETCH_SM90_LAUNCHES) == (launches + 1, sm90 + int(hopper))
    rw, rn = cs.sketch_with_norm_plain(g.double(), a.double())
    assert _rel(w, rw) <= TOL_W and abs(float(norm) - float(rn)) <= TOL_NORM * float(rn)
    assert all(map(torch.equal, (w, norm), cs.sketch_with_norm(g, a)))
    if hopper:
        ow, on = cs._sketch_with_norm_sketch_cu(g, a)
        assert _rel(ow, rw) <= TOL_W and abs(float(on) - float(rn)) <= TOL_NORM * float(rn)


@pytest.mark.parametrize("mult", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("l", [1, 7, 25, 32])
def test_k1_hopper_kernel_at_ragged_shapes(l, mult):
    # 1003 rows (past the last 64-row band), 776 columns (past a block of columns)
    a, g, _ = _inputs(1003, 776, l, 1, seed=100 + l, mult=mult)
    _check_k1(a, g, hopper=True)


@pytest.mark.parametrize("m, n", [(1, 4), (64, 512), (130, 8), (5000, 2048)])
def test_k1_hopper_kernel_at_block_edges(m, n):
    a, g, _ = _inputs(m, n, 25, 1, seed=m + n + 1)
    _check_k1(a, g, hopper=True)


def test_k1_hopper_kernel_at_the_main_shape():
    # 65536 x 8192 at the 2-pass hSVD's l = 25
    a, g, _ = _inputs(65536, 8192, 25, 1, seed=14)
    _check_k1(a, g, hopper=True)


def test_k1_off_the_hopper_rules_takes_sketch_cu():
    a, g, _ = _inputs(1000, 777, 25, 1, seed=15)
    _check_k1(a, g, hopper=False)
    a, g, _ = _inputs(1000, 776, 25, 1, seed=16)
    buf = torch.empty(a.numel() + 1, device="cuda")
    moved = buf[1:].view(a.shape)  # contiguous, 4 bytes past 16
    moved.copy_(a)
    _check_k1(moved, g, hopper=False)


@pytest.mark.parametrize("rows, m", [(65536, 8192), (1003, 776), (248, 256)])
def test_k1_in_the_swapped_roles_of_a_split_0_shard(rows, m):
    # pass 2 of the distributed 2-pass level 0 on a shard S (rows x m):
    # z = Sᵀ·qw = (qwᵀ·S)ᵀ, K1 with g = qwᵀ (25 x rows) over S, as
    # svdtools._sketched_uds_swapped calls it (qw orthonormal columns)
    gen = torch.Generator(device=_card()).manual_seed(rows + m)
    s = torch.randn(rows, m, device="cuda", generator=gen)
    qw, _ = torch.linalg.qr(torch.randn(rows, 25, device="cuda", generator=gen))
    _check_k1(s, qw.T.contiguous(), hopper=True)


def test_k1_and_k2_at_the_level_0_shape_of_the_world():
    # 8192 x 65536: a split-1 shard's 2-pass level 0 (K1, l = 25) and the
    # one-view level 0 on a split-0 shard's copied Sᵀ (K2, l = 59, k = 24)
    a, g, omega = _inputs(8192, 65536, 59, 24, seed=16)
    _check(a, g, omega, hopper=True)
    _check_k1(a, g[:25].contiguous(), hopper=True)
