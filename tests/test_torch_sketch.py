"""Kernels K1 and K2 of heat_tpu_torch (``csrc/sketch.cu``).

Here, without a card, their plain versions are held against heat_tpu's
tiled streams (``_pass1_tiles`` plus the ``_pass2_tiles`` norm carry for
K1, ``_oneview_tiles`` for K2; with x64 on, heat_tpu's own Pallas entries
decline and those streams are its oracle). Float32 throughout: ``w`` and
``y`` agree within relative Frobenius error 1e-5 and the norm within
relative error 1e-6, the rounding of two float32 summation orders over at
most 1536 terms. The kernels themselves run only on a card: the ``cuda``
test compares them with the plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu.core.linalg.svdtools as jsvd
import heat_tpu_torch as ht
from heat_tpu_torch.core.linalg import _cuda_sketch as cs

SHAPES = [(1536, 640), (1000, 777)]  # ragged tails against the 512 grain
DUAL_WIDTHS = (59, 24)  # (ℓ + 10, k̂) of hsvd_rank(A, 10, single_pass=True)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")


def _rel(x, ref) -> float:
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _inputs(shape, rows, cols=None, seed=0):
    rng = np.random.default_rng(seed)
    m, n = shape
    a = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal((rows, m)).astype(np.float32)
    omega = None if cols is None else rng.standard_normal((n, cols)).astype(np.float32)
    return a, g, omega


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("l", [7, 25])
def test_sketch_plain_matches_pass_tiles(shape, l):
    a, g, _ = _inputs(shape, l, seed=l)
    w, norm = cs.sketch_with_norm_plain(torch.from_numpy(g), torch.from_numpy(a))
    jw = jsvd._pass1_tiles(jnp.asarray(g), jnp.asarray(a))
    qw = jnp.zeros((shape[1], 1), jnp.float32)
    _, jnorm = jsvd._pass2_tiles(jnp.asarray(a), qw, jnp.zeros((), jnp.float32))
    assert w.dtype == torch.float32 and tuple(w.shape) == (l, shape[1])
    assert norm.dtype == torch.float32 and norm.ndim == 0
    assert _rel(w, jw) <= 1e-5
    assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)


@pytest.mark.parametrize("shape", SHAPES)
def test_dual_sketch_plain_matches_oneview_tiles(shape):
    l, k = DUAL_WIDTHS
    a, g, omega = _inputs(shape, l, k, seed=1)
    w, y, norm = cs.dual_sketch_with_norm_plain(
        torch.from_numpy(g), torch.from_numpy(omega), torch.from_numpy(a)
    )
    jw, jy, jnorm = jsvd._oneview_tiles(
        jnp.asarray(g), jnp.asarray(omega), jnp.asarray(a),
        jnp.zeros((shape[0], k), jnp.float32), jnp.zeros((), jnp.float32),
    )
    assert tuple(w.shape) == (l, shape[1]) and tuple(y.shape) == (shape[0], k)
    assert _rel(w, jw) <= 1e-5
    assert _rel(y, jy) <= 1e-5
    assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    a, g, omega = (torch.from_numpy(x) for x in _inputs((700, 530), 59, 24))
    launches = (cs.SKETCH_LAUNCHES, cs.DUAL_LAUNCHES)
    for got, want in (
        (cs.sketch_with_norm(g[:25], a), cs.sketch_with_norm_plain(g[:25], a)),
        (cs.dual_sketch_with_norm(g, omega, a), cs.dual_sketch_with_norm_plain(g, omega, a)),
    ):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (cs.SKETCH_LAUNCHES, cs.DUAL_LAUNCHES) == launches


def test_cuda_tensors_launch_or_raise_never_compute_on_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensors below would be launched")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*args):
        raise AssertionError("a CUDA operand reached the plain version")

    monkeypatch.setattr(cs, "sketch_with_norm_plain", refuse)
    monkeypatch.setattr(cs, "dual_sketch_with_norm_plain", refuse)
    launches = (cs.SKETCH_LAUNCHES, cs.DUAL_LAUNCHES)
    host_g = torch.zeros((7, 64))
    with FakeTensorMode():
        a = torch.empty((64, 48), device="cuda")
        g = torch.empty((7, 64), device="cuda")
        omega = torch.empty((48, 5), device="cuda")
        with pytest.raises(RuntimeError):  # nothing here can build or launch the kernel
            cs.sketch_with_norm(g, a)
        with pytest.raises(RuntimeError):
            cs.dual_sketch_with_norm(g, omega, a)
        with pytest.raises(ValueError):  # operands on two devices
            cs.sketch_with_norm(host_g, a)
        with pytest.raises(TypeError):  # the kernels take float32 only
            cs.sketch_with_norm(g.double(), a.double())
    assert (cs.SKETCH_LAUNCHES, cs.DUAL_LAUNCHES) == launches


@pytest.mark.parametrize(
    "l, k, dtype, cuda, k1, k2",
    [
        (25, 24, torch.float32, True, True, True),
        (32, 32, torch.float32, True, True, True),
        (33, 24, torch.float32, True, False, True),
        (65, 24, torch.float32, True, False, False),
        (59, 33, torch.float32, True, False, False),
        (25, 24, torch.float64, True, False, False),
        (25, 24, torch.float32, False, False, False),
    ],
)
def test_dispatch_predicates(l, k, dtype, cuda, k1, k2):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a = torch.empty((1000, 777), dtype=dtype, device="cuda" if cuda else "cpu")
        assert cs.sketch_serviceable(l, a) is k1
        assert cs.dual_sketch_serviceable(l, k, a) is k2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_versions_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    l, k = DUAL_WIDTHS
    dev = torch.device("cuda")
    a, g, omega = (torch.from_numpy(x).to(dev) for x in _inputs(shape, l, k, seed=2))
    w, norm = cs.sketch_with_norm(g[:25].contiguous(), a)
    pw, pnorm = cs.sketch_with_norm_plain(g[:25], a)
    assert _rel(w.cpu(), pw.cpu()) <= 1e-5
    assert abs(float(norm) - float(pnorm)) <= 1e-6 * float(pnorm)
    w, y, norm = cs.dual_sketch_with_norm(g, omega, a)
    pw, py, pnorm = cs.dual_sketch_with_norm_plain(g, omega, a)
    assert _rel(w.cpu(), pw.cpu()) <= 1e-5 and _rel(y.cpu(), py.cpu()) <= 1e-5
    assert abs(float(norm) - float(pnorm)) <= 1e-6 * float(pnorm)
