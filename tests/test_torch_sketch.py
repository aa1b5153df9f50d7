"""Kernels K1 and K2 of heat_tpu_torch (``csrc/sketch.cu``).

Here, without a card, their plain versions are held against heat_tpu's
tiled streams (``_pass1_tiles`` plus the ``_pass2_tiles`` norm carry for
K1, ``_oneview_tiles`` for K2; with x64 on, heat_tpu's own Pallas entries
decline and those streams are its oracle). Float32 throughout: ``w`` and
``y`` agree within relative Frobenius error 1e-5 and the norm within
relative error 1e-6, the rounding of two float32 summation orders over at
most 1536 terms. The kernels themselves run only on a card: the ``cuda``
test compares them with the plain versions there
(``tests/test_torch_sketch_card.py`` holds K2's Hopper kernel against
both). Here the 3xTF32 arithmetic of that kernel is emulated with numpy on
float32 bits, in its blocking (row splits of 64-row bands, each band's row
sketch a fresh sum added to a float32 running one, the column sketch over a
warpgroup's 256 columns, the two warpgroups and the 512-column blocks added
in order) and held against float64 at ``chip_smoke.py``'s limits, relative
Frobenius error 1e-5 for w and y and relative error 1e-6 for the norm;
one-pass TF32 is shown to miss them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu.core.linalg.svdtools as jsvd
import heat_tpu_torch as ht
from heat_tpu_torch.core.linalg import _cuda_sketch as cs
from tf32_emulation import mm_1xtf32_steps, mm_3xtf32_stepwise

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


# --------------------------------------------------------------------- #
# the 3xTF32 arithmetic of K2's Hopper kernel, emulated                 #
# --------------------------------------------------------------------- #
TOL_W, TOL_NORM = 1e-5, 1e-6  # chip_smoke.py's limits
BAND, WG_COLS, SMS = 64, 256, 132  # rows of a band, columns of a consumer warpgroup, an H100's SMs


def _dual_sm90_emulated(g, omega, a, mm, splits=None):
    """K2's Hopper kernel on numpy arrays: ``mm(x, y, acc=...)`` multiplies
    in steps of 8 along K. Row splits as the wrapper chooses them for an
    H100 (or ``splits``), each band's row sketch a fresh sum added to the
    split's float32 one, the splits added in order; the column sketch of a
    band over each warpgroup's 256 columns, warpgroup 0's sum plus warpgroup
    1's, the 512-column blocks added in order; the norm in float32 over a
    64 x 64 tile and float64 across tiles."""
    (m, n), l, k = a.shape, g.shape[0], omega.shape[1]
    bands, cblocks = -(-m // BAND), -(-n // (2 * WG_COLS))
    splits = splits or max(1, min(bands, SMS // cblocks))
    rows = -(-bands // splits) * BAND
    ap = np.zeros((bands * BAND, cblocks * 2 * WG_COLS), np.float32)
    ap[:m, :n] = a
    gp = np.zeros((l, bands * BAND), np.float32)
    gp[:, :m] = g
    op = np.zeros((cblocks * 2 * WG_COLS, k), np.float32)
    op[:n] = omega
    w = yt = None
    norm = 0.0
    for r0 in range(0, m, rows):
        wsum = np.zeros((ap.shape[1], l), np.float32)
        for b0 in range(r0, min(m, r0 + rows), BAND):
            band = ap[b0 : b0 + BAND]
            wsum = wsum + mm(band.T, gp[:, b0 : b0 + BAND].T)
            ysum = None
            for c0 in range(0, ap.shape[1], 2 * WG_COLS):
                wg0, wg1 = (mm(band[:, c : c + WG_COLS], op[c : c + WG_COLS]) for c in (c0, c0 + WG_COLS))
                ysum = wg0 + wg1 if ysum is None else ysum + (wg0 + wg1)
            yt = ysum if yt is None else np.concatenate([yt, ysum])
            for c0 in range(0, ap.shape[1], 64):
                norm += float(np.square(band[:, c0 : c0 + 64]).sum(dtype=np.float32))
        w = wsum if w is None else w + wsum
    return w.T[:, :n], yt[:m], norm


def _dual_errors(shape, l, k, mult, mm, splits=None, seed=0):
    a, g, omega = _inputs(shape, l, k, seed=seed)
    a = (a * mult).astype(np.float32)
    w, y, norm = _dual_sm90_emulated(g, omega, a, mm, splits)
    a64 = a.astype(np.float64)
    return (_rel(w, g.astype(np.float64) @ a64), _rel(y, a64 @ omega.astype(np.float64)),
            abs(norm - float(np.square(a64).sum())) / float(np.square(a64).sum()))


# (shape, ℓ, k̂, scale, row splits): ragged rows and columns, ℓ and k̂ at
# their ends, the main path's widths, inputs scaled by 1e±3, and one split
# of 8192 rows (the main shape's) over 512 columns
DUAL_SM90_CASES = [
    ((1000, 776), 59, 24, 1.0, None),
    ((1003, 776), 1, 1, 1.0, None),
    ((1000, 776), 64, 32, 1e3, None),
    ((1000, 776), 25, 25, 1e-3, None),
    ((130, 8), 7, 3, 1.0, None),
    ((1003, 1032), 59, 24, 1.0, 1),
    ((8192, 512), 59, 24, 1.0, 1),
]


@pytest.mark.parametrize("shape, l, k, mult, splits", DUAL_SM90_CASES)
def test_dual_sketch_3xtf32_stays_within_the_limits(shape, l, k, mult, splits):
    ew, ey, en = _dual_errors(shape, l, k, mult, mm_3xtf32_stepwise, splits)
    assert ew <= TOL_W and ey <= TOL_W and en <= TOL_NORM, (ew, ey, en)


@pytest.mark.parametrize("shape, l, k", [((1000, 776), 59, 24), ((1003, 776), 1, 1)])
def test_dual_sketch_one_pass_tf32_misses_the_limits(shape, l, k):
    ew, ey, _ = _dual_errors(shape, l, k, 1.0, mm_1xtf32_steps)
    assert ew > TOL_W and ey > TOL_W, (ew, ey)


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
