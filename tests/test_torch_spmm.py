"""heat_tpu_torch's brick engine (kernels K7 and K8) against heat_tpu at
world size 1.

Here, without a card, the plain versions are held against heat_tpu's
Pallas brick kernels in interpret mode, called directly (outside
``shard_map``), and against its XLA oracles ``_contrib_xla``,
``_local_spmm(path="xla")`` and ``_sddmm_xla``, from the same numpy bricks.
Both sides compute in float32 and sum in different orders (torch.bmm and
``index_add_`` against XLA's dot and segment-sum), so each result must lie
within 1e-5 of the reference relative to its own magnitude scale,
|A|·|x| for SpMM and |s|·(|u|·|v|ᵀ) for SDDMM, elementwise: float32
rounding of a sum grows with the sum of the absolute terms, and 1e-5 is
about 80 float32 ulps of it. The kernels themselves run only on a card:
the ``cuda`` tests compare them with the plain versions there
(``tests/test_torch_spmm_card.py`` holds K8's Hopper kernel against both).
Here the 3xTF32 arithmetic of that kernel (each operand split into two
TF32 halves, three TF32 products in K8's pass order, passes of 64 along d
added in float32, then the scale by sdata) is emulated with numpy on
float32 bits and held against a float64 result at ``chip_smoke.py``'s
limit, 1e-5 of |s|·(|u|·|v|ᵀ) elementwise; one-pass TF32 is shown to miss
it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu.kernels import spmm as jspmm
from heat_tpu_torch.kernels import spmm as ks
from tf32_emulation import mm_1xtf32_steps, mm_3xtf32_passes

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])  # heat_tpu turns x64 on for the CPU with its first array


def _bricks(m, n, nreal, pads=0, zero_bricks=0, rows=None, seed=0, dtype=np.float32):
    """A slab of ``nreal`` distinct random bricks of an (m, n) matrix in BSR
    order, zero outside the matrix, ``zero_bricks`` of them all zero, then
    ``pads`` pad bricks; ``rows`` restricts the brick rows that hold
    bricks. Returns numpy (bdata, bcol, brow, bmask)."""
    rng = np.random.default_rng(seed)
    mb, nb = -(-max(m, 1) // 8), -(-max(n, 1) // 128)
    rows = np.arange(mb) if rows is None else np.asarray(rows)
    lin = np.sort(rng.choice(len(rows) * nb, nreal, replace=False))
    brow = rows[lin // nb].astype(np.int32)
    bcol = (lin % nb).astype(np.int32)
    order = np.lexsort((bcol, brow))
    brow, bcol = brow[order], bcol[order]
    dense_rows = brow[:, None] * 8 + np.arange(8)
    dense_cols = bcol[:, None] * 128 + np.arange(128)
    inside = (dense_rows < m)[:, :, None] & (dense_cols < n)[:, None, :]
    bdata = (rng.standard_normal((nreal, 8, 128)) * inside).astype(dtype)
    bdata[rng.choice(nreal, zero_bricks, replace=False)] = 0
    bmask = dense_rows < max(m, 1)
    z = np.zeros
    return (
        np.concatenate([bdata, z((pads, 8, 128), dtype)]),
        np.concatenate([bcol, z(pads, np.int32)]),
        np.concatenate([brow, z(pads, np.int32)]),
        np.concatenate([bmask, z((pads, 8), bool)]),
    )


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_within(got, ref, scale):
    got, ref, scale = (np.asarray(a, dtype=np.float64) for a in (got, ref, scale))
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert np.all(err <= TOL * scale + 1e-30), float(np.max(err / np.maximum(scale, 1e-30)))


def _xb(x, nb):
    xp = np.zeros((nb * 128, x.shape[1]), x.dtype)
    xp[: x.shape[0]] = x
    return xp.reshape(nb, 128, -1)


# --------------------------------------------------------------------- #
# K7: brick products and the masked row sums                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("k", [1, 2, 4, 64])
def test_contrib_plain_matches_interpret_kernel_and_xla(k):
    bdata, bcol, _, _ = _bricks(40, 300, 10, seed=k)
    nb = 3
    xb = np.random.default_rng(k + 100).standard_normal((nb, 128, k)).astype(np.float32)
    got = ks.brick_contrib_plain(*_t(bdata, bcol, xb)).numpy()
    scale = np.abs(bdata).astype(np.float64) @ np.abs(xb[bcol]).astype(np.float64)
    kernel = jspmm._brick_spmm_call(len(bcol), nb, k, "float32", True)(
        jnp.asarray(bcol), jnp.asarray(bdata), jnp.asarray(xb)
    )
    oracle = jspmm._contrib_xla(jnp.asarray(bdata), jnp.asarray(xb), jnp.asarray(bcol), jnp.float32)
    _assert_within(got, np.asarray(kernel), scale)
    _assert_within(got, np.asarray(oracle), scale)


SPMM_CASES = {
    # m % 8 != 0, n % 128 != 0, a pad brick
    "ragged": dict(m=45, n=300, nreal=12, pads=1),
    # brick rows 1, 2 and 4 hold no brick; a matrix row past every brick
    "empty_rows": dict(m=48, n=256, nreal=5, pads=0, rows=[0, 3, 5]),
    # stored bricks that are all zero, and three pad bricks
    "zero_and_pad_bricks": dict(m=30, n=500, nreal=9, pads=3, zero_bricks=4),
}


@pytest.mark.parametrize("k", [1, 2, 4, 64])
@pytest.mark.parametrize("case", sorted(SPMM_CASES))
def test_spmm_plain_matches_local_spmm(case, k):
    spec = SPMM_CASES[case]
    m, n = spec["m"], spec["n"]
    bdata, bcol, brow, bmask = _bricks(seed=k, **spec)
    x = np.random.default_rng(k + 7).standard_normal((n, k)).astype(np.float32)
    got = ks.brick_spmm_plain(*_t(bdata, bcol, brow, bmask, x), m).numpy()
    scale = ks.brick_spmm_plain(*_t(np.abs(bdata).astype(np.float64), bcol, brow, bmask,
                                    np.abs(x).astype(np.float64)), m).numpy()
    nb, B = -(-n // 128), len(bcol)
    ref = jspmm._local_spmm(
        jnp.asarray(bdata), jnp.asarray(bcol), jnp.asarray(brow), jnp.asarray(bmask), jnp.asarray(x), 0,
        nb=nb, B=B, c=max(m, 1), jt=jnp.dtype(jnp.float32), acc=jnp.dtype(jnp.float32), path="xla",
    )[:m]
    _assert_within(got, np.asarray(ref), scale)
    dense = np.zeros((-(-m // 8) * 8, nb * 128))
    for t in range(B):
        if bmask[t].any():
            dense[8 * brow[t] : 8 * brow[t] + 8, 128 * bcol[t] : 128 * bcol[t] + 128] += bdata[t] * bmask[t][:, None]
    _assert_within(got, dense[:m, :n] @ x.astype(np.float64), scale)


def test_spmm_plain_drops_masked_rows_entirely():
    """A masked row adds nothing, not even a NaN or inf of its data."""
    bdata, bcol, brow, bmask = _bricks(13, 128, 2, seed=3)
    bdata[:, 5:] = np.nan  # rows 5..7 of brick row 1 are past m = 13
    bdata[0, 5:] = np.inf
    bmask[0, 5:] = False
    x = np.ones((128, 2), np.float32)
    y = ks.brick_spmm_plain(*_t(bdata, bcol, brow, bmask, x), 13).numpy()
    assert np.isfinite(y[:5]).all() and np.isfinite(y[8:13]).all()


# --------------------------------------------------------------------- #
# K8: the sampled product                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [1, 8, 64])
def test_sddmm_plain_matches_interpret_kernel_and_xla(d):
    m, n = 45, 300
    sdata, bcol, brow, _ = _bricks(m, n, 11, pads=2, zero_bricks=1, seed=d)
    rng = np.random.default_rng(d + 1)
    u = rng.standard_normal((m, d)).astype(np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32)
    got = ks.brick_sddmm_plain(*_t(sdata, brow, bcol, u, v)).numpy()
    scale = ks.brick_sddmm_plain(*_t(np.abs(sdata).astype(np.float64), brow, bcol,
                                     np.abs(u).astype(np.float64), np.abs(v).astype(np.float64))).numpy()
    mb, nb, B = -(-m // 8), -(-n // 128), len(bcol)
    ub = np.zeros((mb * 8, d), np.float32)
    ub[:m] = u
    ub = ub.reshape(mb, 8, d)
    vb = _xb(v, nb)
    kernel = jspmm._brick_sddmm_call(B, mb, nb, d, "float32", True)(
        jnp.asarray(brow), jnp.asarray(bcol), jnp.asarray(sdata), jnp.asarray(ub), jnp.asarray(vb)
    )
    oracle = jspmm._sddmm_xla(
        jnp.asarray(sdata), jnp.asarray(ub), jnp.asarray(vb), jnp.asarray(brow), jnp.asarray(bcol), jnp.float32
    )
    _assert_within(got, np.asarray(kernel), scale)
    _assert_within(got, np.asarray(oracle), scale)
    assert not got[B - 2 :].any()  # pad bricks come out zero


# --------------------------------------------------------------------- #
# the 3xTF32 arithmetic of K8's Hopper kernel, emulated                 #
# --------------------------------------------------------------------- #
def _sddmm_sm90_emulated(sdata, brow, bcol, u, v, mm):
    """K8's Hopper kernel on numpy bricks: per brick outᵀ = v-brick @
    u-brickᵀ, d in passes of 64 each multiplied by ``mm`` in steps of 8,
    the passes added in float32, then scaled by sdata; u and v read as zero
    past their last rows."""
    d = u.shape[1]
    ub = np.zeros((-(-u.shape[0] // 8) * 8, d), np.float32)
    ub[: u.shape[0]] = u
    vb = np.zeros((-(-v.shape[0] // 128) * 128, d), np.float32)
    vb[: v.shape[0]] = v
    U, V = ub.reshape(-1, 8, d)[brow], vb.reshape(-1, 128, d)[bcol]
    out = None
    for j0 in range(0, d, 64):
        part = mm(V[..., j0 : j0 + 64], U[..., j0 : j0 + 64].transpose(0, 2, 1))
        out = part if out is None else out + part
    return sdata * out.transpose(0, 2, 1)


def _sddmm_limit_share(d, mult, mm, seed=0):
    """max |emulated − float64| / (1e-5 |s|·(|u|·|v|ᵀ)) on a ragged slab
    (45 x 300: rows past m in the last brick row, a zero brick, pad bricks)."""
    m, n = 45, 300
    sdata, bcol, brow, _ = _bricks(m, n, 11, pads=2, zero_bricks=1, seed=d)
    rng = np.random.default_rng(seed + d)
    u = (rng.standard_normal((m, d)) * mult).astype(np.float32)
    v = (rng.standard_normal((n, d)) * mult).astype(np.float32)
    got = _sddmm_sm90_emulated(sdata, brow, bcol, u, v, mm)
    ref = ks.brick_sddmm_plain(*_t(sdata.astype(np.float64), brow, bcol, u.astype(np.float64),
                                   v.astype(np.float64))).numpy()
    scale = ks.brick_sddmm_plain(*_t(np.abs(sdata).astype(np.float64), brow, bcol, np.abs(u).astype(np.float64),
                                     np.abs(v).astype(np.float64))).numpy()
    assert not got[-2:].any()  # pad bricks come out zero
    err = np.abs(got - ref)
    assert (err[scale == 0] == 0).all()
    return float((err[scale > 0] / (TOL * scale[scale > 0])).max())


@pytest.mark.parametrize("mult", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("d", [4, 8, 60, 64, 72, 128])
def test_sddmm_3xtf32_stays_within_the_sparse_limit(d, mult):
    share = _sddmm_limit_share(d, mult, mm_3xtf32_passes)
    assert share <= 1, share


@pytest.mark.parametrize("d", [4, 64, 128])
def test_sddmm_one_pass_tf32_misses_the_sparse_limit(d):
    share = _sddmm_limit_share(d, 1.0, mm_1xtf32_steps)
    assert share > 1, share


# --------------------------------------------------------------------- #
# predicates, dispatch and the wrappers on the CPU                      #
# --------------------------------------------------------------------- #
F32, BF16, F16, F64, I32 = torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int32


@pytest.mark.parametrize(
    "a, x, k, expect",
    [
        (F32, F32, 1, True),
        (F32, F32, 64, True),
        (BF16, F32, 4, True),
        (F16, BF16, 4, True),
        (F32, F32, 0, False),
        (F64, F32, 4, False),
        (F32, F64, 4, False),
        (I32, F32, 4, False),
        (I32, I32, 1, False),
        (torch.complex64, F32, 1, False),
    ],
)
def test_spmm_serviceable_table(a, x, k, expect):
    assert ks.spmm_serviceable(a, x, k) is expect


@pytest.mark.parametrize(
    "s, u, v, d, expect",
    [
        (F32, F32, F32, 1, True),
        (F32, F32, F32, 64, True),
        (BF16, BF16, F32, 8, True),
        (F32, F32, F32, 0, False),
        (F64, F32, F32, 8, False),
        (F32, F32, F64, 8, False),
        (I32, F32, F32, 8, False),
    ],
)
def test_sddmm_serviceable_table(s, u, v, d, expect):
    assert ks.sddmm_serviceable(s, u, v, d) is expect


@pytest.mark.parametrize(
    "d, m, ptrs, expect",
    [
        (64, 131072, (0, 16, 4096), True),
        (4, 1, (16, 32, 48), True),
        (72, 1003, (0, 0, 0), True),
        (128, 45, (0, 0, 0), True),
        (60, 45, (0, 0, 0), True),
        (30, 45, (0, 0, 0), False),  # rows of u off 16 bytes: no tensor map
        (1, 45, (0, 0, 0), False),
        (64, 0, (0, 0, 0), False),  # no rows of u
        (64, 45, (4, 0, 0), False),  # u off 16 bytes
        (64, 45, (0, 8, 0), False),  # v off 16 bytes
        (64, 45, (0, 0, 4), False),  # sdata off 16 bytes
    ],
)
def test_sddmm_sm90_serviceable_table(d, m, ptrs, expect):
    assert ks.sddmm_sm90_serviceable(d, m, ptrs) is expect


def test_sddmm_dispatch_picks_the_kernel_up_front(monkeypatch):
    """On (fake) CUDA tensors the route is chosen before any launch: the
    Hopper kernel's library for d % 4 == 0 on aligned operands, spmm.cu's
    for the rest and whenever the Hopper kernel is shut off."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensors below would be launched")
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Loaded(Exception):
        pass

    def loader(name):
        def load():
            raise Loaded(name)

        return load

    monkeypatch.setattr(ks, "_lib_sm90", loader("sddmm_sm90"))
    monkeypatch.setattr(ks, "_lib", loader("spmm"))
    with FakeTensorMode():
        dev = "cuda"
        sdata = torch.empty(4, 8, 128, device=dev)
        idx = torch.zeros(4, dtype=torch.int32, device=dev)
        colptr = torch.zeros(2, dtype=torch.int32, device=dev)
        for d, want in ((64, "sddmm_sm90"), (4, "sddmm_sm90"), (72, "sddmm_sm90"), (30, "spmm"), (1, "spmm")):
            u, v = torch.empty(8, d, device=dev), torch.empty(128, d, device=dev)
            with pytest.raises(Loaded, match=want):
                ks.brick_sddmm(sdata, idx, idx, idx, colptr, 4, u, v)
            with pytest.raises(Loaded, match="spmm"):
                ks._brick_sddmm_spmm_cu(sdata, idx, idx, idx, colptr, 4, u, v)


def test_acc_dtype():
    assert ks.acc_dtype(BF16) is F32 and ks.acc_dtype(F16) is F32
    assert ks.acc_dtype(F32) is F32 and ks.acc_dtype(F64) is F64 and ks.acc_dtype(I32) is I32


def test_cpu_wrappers_take_the_plain_versions_without_launching():
    m, n = 45, 300
    bdata, bcol, brow, bmask = _bricks(m, n, 12, pads=1, seed=4)
    A = ht.sparse.DBCSR_matrix(*_t(bdata, bcol, brow, bmask), ((0, 6, 12),), 1, 12, (m, n), ht.float32, None,
                               ht.cpu, ht.get_comm())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((n, 3)).astype(np.float32))
    u, v = torch.ones(m, 4), torch.ones(n, 4)
    launches = ks.SPMM_LAUNCHES, ks.SDDMM_LAUNCHES
    y = ks.brick_spmm(*_t(bdata, bcol, brow, bmask), A._brick_rowptr, x, m)
    assert torch.equal(y, ks.brick_spmm_plain(*_t(bdata, bcol, brow, bmask), x, m))
    out = ks.brick_sddmm(*_t(bdata, brow, bcol), *A._brick_colorder, u, v)
    assert torch.equal(out, ks.brick_sddmm_plain(*_t(bdata, brow, bcol), u, v))
    assert (ks.SPMM_LAUNCHES, ks.SDDMM_LAUNCHES) == launches


def test_brick_colorder_groups_every_brick_by_column():
    m, n = 48, 700
    bdata, bcol, brow, bmask = _bricks(m, n, 13, pads=3, seed=7)
    A = ht.sparse.DBCSR_matrix(*_t(bdata, bcol, brow, bmask), ((0, 6, 13),), 1, 13, (m, n), ht.float32, 0,
                               ht.cpu, ht.get_comm())
    order, colptr, longest = A._brick_colorder
    order, colptr = order.numpy(), colptr.numpy()
    assert order.dtype == colptr.dtype == np.int32 and colptr.shape == (A.nb + 1,)
    assert sorted(order) == list(range(16)) and colptr[-1] == 16
    for c in range(A.nb):
        run = order[colptr[c] : colptr[c + 1]]
        assert (bcol[run] == c).all() and (np.diff(run) > 0).all()  # stable: slab order within a column
    assert longest == int(np.bincount(bcol).max())
    bad = bcol.copy()
    bad[0] = A.nb
    with pytest.raises(ValueError):
        ht.sparse.DBCSR_matrix(*_t(bdata, bad, brow, bmask), ((0, 6, 13),), 1, 13, (m, n), ht.float32, 0,
                               ht.cpu, ht.get_comm())._brick_colorder


def test_brick_rowptr_delimits_each_rows_run():
    m, n = 48, 256
    bdata, bcol, brow, bmask = _bricks(m, n, 5, pads=2, rows=[0, 3, 5], seed=6)
    A = ht.sparse.DBCSR_matrix(*_t(bdata, bcol, brow, bmask), ((0, 6, 5),), 1, 5, (m, n), ht.float32, 0,
                               ht.cpu, ht.get_comm())
    ptr = A._brick_rowptr.numpy()
    assert ptr.dtype == np.int32 and ptr.shape == (7,) and ptr[0] == 0 and ptr[-1] == 5
    for g in range(6):
        assert (brow[ptr[g] : ptr[g + 1]] == g).all()


def test_cuda_tensors_launch_or_raise_never_compute_on_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the fake CUDA tensors below would be launched")
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA operand reached the plain version")

    monkeypatch.setattr(ks, "brick_spmm_plain", refuse)
    monkeypatch.setattr(ks, "brick_sddmm_plain", refuse)
    launches = ks.SPMM_LAUNCHES, ks.SDDMM_LAUNCHES
    with FakeTensorMode():
        dev = "cuda"
        bdata = torch.empty(4, 8, 128, device=dev)
        idx = torch.zeros(4, dtype=torch.int32, device=dev)
        bmask = torch.ones(4, 8, dtype=torch.bool, device=dev)
        rowptr = torch.zeros(2, dtype=torch.int32, device=dev)
        x = torch.empty(128, 2, device=dev)
        with pytest.raises(RuntimeError):  # nothing here can build or launch the kernel
            ks.brick_spmm(bdata, idx, idx, bmask, rowptr, x, 8)
        with pytest.raises(TypeError):  # the kernel takes float32 only
            ks.brick_spmm(bdata.double(), idx, idx, bmask, rowptr, x, 8)
        with pytest.raises(ValueError):  # m past the brick rows
            ks.brick_spmm(bdata, idx, idx, bmask, rowptr, x, 9)
        u = torch.empty(8, 3, device=dev)
        v = torch.empty(128, 3, device=dev)
        with pytest.raises(RuntimeError):
            ks.brick_sddmm(bdata, idx, idx, idx, rowptr, 4, u, v)
        with pytest.raises(ValueError):  # inner dims differ
            ks.brick_sddmm(bdata, idx, idx, idx, rowptr, 4, u, x)
        with pytest.raises(ValueError):  # a run longer than the slab
            ks.brick_sddmm(bdata, idx, idx, idx, rowptr, 5, u, v)
    assert (ks.SPMM_LAUNCHES, ks.SDDMM_LAUNCHES) == launches


# --------------------------------------------------------------------- #
# the kernels on a card                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 64])
def test_spmm_kernel_matches_plain_version_on_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 has no CPU mode")
    dev = torch.device("cuda")
    m, n = 1003, 777
    bdata, bcol, brow, bmask = (t.to(dev) for t in _t(*_bricks(m, n, 300, pads=2, zero_bricks=5, seed=k)))
    A = ht.sparse.DBCSR_matrix(bdata, bcol, brow, bmask, ((0, 126, 300),), 1, 300, (m, n), ht.float32, 0,
                               ht.gpu, ht.get_comm())
    x = torch.randn(n, k, device=dev)
    launches = ks.SPMM_LAUNCHES
    y = ks.brick_spmm(bdata, bcol, brow, bmask, A._brick_rowptr, x, m)
    ref = ks.brick_spmm_plain(bdata, bcol, brow, bmask, x, m)
    scale = ks.brick_spmm_plain(bdata.abs(), bcol, brow, bmask, x.abs(), m)
    assert ks.SPMM_LAUNCHES == launches + 1
    assert bool(((y - ref).abs() <= TOL * scale).all())
    assert torch.equal(y, ks.brick_spmm(bdata, bcol, brow, bmask, A._brick_rowptr, x, m))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 64, 100])
def test_sddmm_kernel_matches_plain_version_on_card(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 has no CPU mode")
    dev = torch.device("cuda")
    m, n = 1003, 777
    sdata, bcol, brow, bmask = (t.to(dev) for t in _t(*_bricks(m, n, 300, pads=2, seed=d)))
    S = ht.sparse.DBCSR_matrix(sdata, bcol, brow, bmask, ((0, 126, 300),), 1, 300, (m, n), ht.float32, 0,
                               ht.gpu, ht.get_comm())
    u, v = torch.randn(m, d, device=dev), torch.randn(n, d, device=dev)
    launches = ks.SDDMM_LAUNCHES
    out = ks.brick_sddmm(sdata, brow, bcol, *S._brick_colorder, u, v)
    ref = ks.brick_sddmm_plain(sdata, brow, bcol, u, v)
    scale = ks.brick_sddmm_plain(sdata.abs(), brow, bcol, u.abs(), v.abs())
    assert ks.SDDMM_LAUNCHES == launches + 1
    assert bool(((out - ref).abs() <= TOL * scale).all())
    assert torch.equal(out, ks.brick_sddmm(sdata, brow, bcol, *S._brick_colorder, u, v))
