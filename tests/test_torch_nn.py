"""heat_tpu_torch's nn modules (``Linear``, ``MultiheadAttention``,
``LayerNorm``, ``Embedding``), ``nn.functional`` and the tiny transformer
block against heat_tpu, with the same parameters.

A heat_tpu module's ``init`` gives its parameters; they go to the port's
module through ``core.interop.nn_params_from_numpy``, and both packages run
the same numpy input. Both compute in float32 and sum in other orders
(XLA's dot and reductions against torch's), so results must agree to
rtol 2e-5, atol 2e-6, heat_tpu's kernel-against-oracle bound
(``tests/test_nn_optim.py:472``); ``MultiheadAttention`` against
``torch.nn.MultiheadAttention`` keeps heat_tpu's own bound for that
comparison, rtol 2e-4, atol 2e-5 (``tests/test_nn_optim.py:899-940``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as jht
import heat_tpu_torch as ht
from heat_tpu.nn import modules as jm
from heat_tpu_torch.core._threefry import seed_key
from heat_tpu_torch.core.interop import nn_params_from_numpy

RTOL, ATOL = 2e-5, 2e-6


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])  # heat_tpu turns x64 on for the CPU with its first array


def _params(module, seed):
    return {k: np.asarray(v) for k, v in module.init(jax.random.PRNGKey(seed)).items()}


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------- #
# modules against heat_tpu                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches_heat_tpu(bias):
    jl = jm.Linear(12, 5, bias=bias)
    p = _params(jl, 0)
    tl = nn_params_from_numpy(ht.nn.Linear(12, 5, bias=bias), p)
    x = _x((3, 4, 12))
    ref = np.asarray(jl.apply(p, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(tl(torch.from_numpy(x)).numpy(), ref, rtol=RTOL, atol=ATOL)
    assert tuple(tl.weight.shape) == (12, 5)


@pytest.mark.parametrize("shape", [8, (5, 8)])
def test_layernorm_matches_heat_tpu(shape):
    jl = jm.LayerNorm(shape)
    p = {"weight": _x(jl.normalized_shape, 1), "bias": _x(jl.normalized_shape, 2)}
    tl = nn_params_from_numpy(ht.nn.LayerNorm(shape), p)
    x = _x((3, 5, 8), 3) * 4 + 1
    ref = np.asarray(jl.apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(tl(torch.from_numpy(x)).numpy(), ref, rtol=RTOL, atol=ATOL)
    bare = ht.nn.LayerNorm(8, elementwise_affine=False)
    assert list(bare.parameters()) == []
    np.testing.assert_allclose(
        bare(torch.from_numpy(x)).numpy(), np.asarray(jm.LayerNorm(8, elementwise_affine=False).apply({}, x)),
        rtol=RTOL, atol=ATOL,
    )


def test_layernorm_shape_mismatch_raises():
    with pytest.raises(ValueError):
        ht.nn.LayerNorm(8)(torch.zeros(3, 5, 1))
    with pytest.raises(ValueError):
        ht.nn.LayerNorm((5, 8), elementwise_affine=False)(torch.zeros(3, 4, 8))


def test_embedding_matches_heat_tpu_and_raises_out_of_range():
    je = jm.Embedding(10, 4)
    p = _params(je, 1)
    te = nn_params_from_numpy(ht.nn.Embedding(10, 4), p)
    idx = np.array([[0, 3, 9], [3, 3, 1]], np.int32)
    ref = np.asarray(je.apply(p, jnp.asarray(idx)))
    np.testing.assert_array_equal(te(torch.from_numpy(idx)).detach().numpy(), ref)
    for bad in ([3, 10], [-1]):
        with pytest.raises(IndexError):
            je.apply(p, jnp.asarray(bad))
        with pytest.raises(IndexError):
            te(torch.tensor(bad))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 12, 16), (9, 16)])
def test_multihead_attention_matches_heat_tpu(shape, causal):
    jmha = jm.MultiheadAttention(16, 4, causal=causal)
    p = _params(jmha, 2)
    p["in_bias"], p["out_bias"] = _x((48,), 4), _x((16,), 5)  # non-zero biases
    tmha = nn_params_from_numpy(ht.nn.MultiheadAttention(16, 4, causal=causal), p)
    x = _x(shape, 6)
    ref = np.asarray(jmha.apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    with torch.no_grad():
        out = tmha(torch.from_numpy(x))
    assert out.shape == shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def _from_torch_mha(t_mha, causal=False):
    mha = ht.nn.MultiheadAttention(t_mha.embed_dim, t_mha.num_heads, causal=causal)
    return nn_params_from_numpy(mha, {
        "in_proj": t_mha.in_proj_weight.detach().numpy().T,
        "in_bias": t_mha.in_proj_bias.detach().numpy(),
        "out_proj": t_mha.out_proj.weight.detach().numpy().T,
        "out_bias": t_mha.out_proj.bias.detach().numpy(),
    })


def test_multihead_attention_matches_torch_batched():
    torch.manual_seed(0)
    B, S, E, H = 2, 12, 16, 4
    x = torch.from_numpy(_x((B, S, E)))
    t_mha = torch.nn.MultiheadAttention(E, H, bias=True, batch_first=True)
    with torch.no_grad():
        ref, _ = t_mha(x, x, x, need_weights=False)
        out = _from_torch_mha(t_mha)(x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4, atol=2e-5)


def test_multihead_attention_matches_torch_causal_unbatched():
    torch.manual_seed(1)
    S, E, H = 9, 8, 2
    x = torch.from_numpy(_x((S, E), 1))
    t_mha = torch.nn.MultiheadAttention(E, H, bias=True, batch_first=True)
    mask = torch.triu(torch.ones(S, S, dtype=torch.bool), diagonal=1)
    with torch.no_grad():
        ref, _ = t_mha(x[None], x[None], x[None], attn_mask=mask, need_weights=False)
        out = _from_torch_mha(t_mha, causal=True)(x)
    assert out.shape == (S, E)
    np.testing.assert_allclose(out.numpy(), ref.numpy()[0], rtol=2e-4, atol=2e-5)


def test_multihead_attention_checks_and_gradients():
    with pytest.raises(ValueError):
        ht.nn.MultiheadAttention(10, 3)
    mha = ht.nn.MultiheadAttention(8, 2, causal=True, key=seed_key(0))
    assert sorted(n for n, _ in mha.named_parameters()) == ["in_bias", "in_proj", "out_bias", "out_proj"]
    assert tuple(mha.in_proj.shape) == (8, 24) and tuple(mha.out_proj.shape) == (8, 8)
    x = torch.from_numpy(_x((2, 5, 8), 7))
    mha(x).square().sum().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in mha.parameters())
    assert float(mha.in_proj.grad.abs().sum()) > 0


# --------------------------------------------------------------------- #
# initialization, placement and interop                                 #
# --------------------------------------------------------------------- #
def test_initialization_from_a_generator():
    def make(seed):
        k = seed_key(seed)
        return ht.nn.Linear(64, 32, key=k), ht.nn.MultiheadAttention(16, 4, key=k), ht.nn.Embedding(50, 8, key=k)

    a, b, c = make(3), make(3), make(4)
    for ma, mb, mc in zip(a, b, c):
        for (name, pa), pb, pc in zip(ma.named_parameters(), mb.parameters(), mc.parameters()):
            assert torch.equal(pa, pb)
            assert name.endswith("bias") and not pa.any() or not torch.equal(pa, pc)
    lin, mha, emb = (m.requires_grad_(False) for m in a)
    assert float(lin.weight.abs().max()) <= 1 / 8 and float(lin.bias.abs().max()) <= 1 / 8
    assert float(mha.in_proj.abs().max()) <= (6 / 64) ** 0.5 and float(mha.out_proj.abs().max()) <= 0.25
    assert 0.7 < float(emb.weight.std()) < 1.3  # N(0, 1) rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_module_inits_from_a_key_are_heat_tpus_bit_for_bit(dtype):
    """``Linear`` and ``MultiheadAttention`` built with ``key=`` hold
    heat_tpu's ``init(key)`` parameters bit for bit; ``Embedding``'s normal
    rows bit for bit in bfloat16 and within the normal draws' limit of
    tests/test_torch_random.py (4 ulp in float32, 32 in float64, relative)
    in the wider types."""
    jht.zeros(1)  # heat_tpu's policy (x64 on the CPU) before any key is made
    jdt, tdt = getattr(jnp, dtype), getattr(ht, dtype)
    for seed in (0, 5):
        jk, tk = jax.random.PRNGKey(seed), seed_key(seed)
        pairs = ((jm.Linear(13, 6, dtype=jdt).init(jk), ht.nn.Linear(13, 6, dtype=tdt, key=tk)),
                 (jm.Linear(4, 9, bias=False, dtype=jdt).init(jk), ht.nn.Linear(4, 9, bias=False, dtype=tdt, key=tk)),
                 (jm.MultiheadAttention(16, 4, dtype=jdt).init(jk), ht.nn.MultiheadAttention(16, 4, dtype=tdt, key=tk)),
                 (jm.Embedding(11, 5, dtype=jdt).init(jk), ht.nn.Embedding(11, 5, dtype=tdt, key=tk)))
        for ref, module in pairs:
            got = dict(module.named_parameters())
            assert sorted(got) == sorted(ref)
            for name, value in ref.items():
                want = np.asarray(value)
                have = got[name].detach()
                if dtype == "bfloat16":
                    assert np.array_equal(have.view(torch.int16).numpy(), want.view(np.int16)), name
                elif isinstance(module, ht.nn.Embedding):
                    ulps = {"float32": 4, "float64": 32}[dtype]
                    np.testing.assert_allclose(have.numpy(), want, rtol=ulps * np.finfo(want.dtype).eps, atol=0)
                else:
                    assert np.array_equal(have.numpy(), want), name


def test_a_module_without_a_key_takes_the_global_streams_next():
    ht.random.seed(4)
    a = ht.nn.Linear(6, 3)
    assert ht.random.get_state()[2] == 6 * 3 + 3  # the counter advanced by the elements drawn
    b = ht.nn.Linear(6, 3)
    ht.random.seed(4)
    c = ht.nn.Linear(6, 3, key=ht.random._next_key(21))
    assert torch.equal(a.weight, c.weight) and not torch.equal(a.weight, b.weight)


def test_modules_take_device_and_dtype():
    for m in (ht.nn.Linear(4, 3, dtype=ht.bfloat16), ht.nn.MultiheadAttention(8, 2, dtype=torch.bfloat16),
              ht.nn.LayerNorm(4, dtype=ht.bfloat16), ht.nn.Embedding(5, 4, dtype=ht.bfloat16, device="cpu")):
        assert all(p.dtype == torch.bfloat16 and p.device.type == "cpu" for p in m.parameters())
    out = ht.nn.MultiheadAttention(8, 2, dtype=ht.bfloat16)(torch.zeros(3, 8, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and out.shape == (3, 8)


def test_nn_params_from_numpy_checks_names_and_shapes():
    lin = ht.nn.Linear(3, 2)
    with pytest.raises(KeyError):
        nn_params_from_numpy(lin, {"weight": np.zeros((3, 2), np.float32)})
    with pytest.raises(ValueError):
        nn_params_from_numpy(lin, {"weight": np.zeros((2, 3), np.float32), "bias": np.zeros(2, np.float32)})
    jl = jm.Linear(3, 2, dtype=jnp.bfloat16)
    p = _params(jl, 5)
    tl = nn_params_from_numpy(ht.nn.Linear(3, 2, dtype=ht.bfloat16), p)
    np.testing.assert_array_equal(tl.weight.float().detach().numpy(), p["weight"].astype(np.float32))


def test_functional_aliases_and_delegation():
    F = ht.nn.functional
    assert ht.nn.F is F
    x = torch.from_numpy(_x((4, 6)))
    w, b = torch.from_numpy(_x((6, 3), 1)), torch.from_numpy(_x((3,), 2))
    np.testing.assert_allclose(
        F.linear(x, w, b).numpy(), np.asarray(jht.nn.functional.linear(x.numpy(), w.numpy(), b.numpy())),
        rtol=RTOL, atol=ATOL,
    )
    for name in ("relu", "sigmoid", "tanh", "softplus", "elu", "leaky_relu"):
        np.testing.assert_allclose(
            getattr(F, name)(x).numpy(), np.asarray(getattr(jht.nn.functional, name)(jnp.asarray(x.numpy()))),
            rtol=1e-5, atol=1e-6,
        )
    # gelu's default is jax.nn.gelu's (heat_tpu's) tanh form; approximate=False the exact one
    grid = torch.linspace(-6.0, 6.0, 100_001, dtype=torch.float32)
    ref = np.asarray(jht.nn.functional.gelu(jnp.asarray(grid.numpy())))
    assert np.abs(F.gelu(grid).numpy() - ref).max() <= 1e-6
    np.testing.assert_allclose(
        F.gelu(grid, approximate=False).numpy(),
        np.asarray(jht.nn.functional.gelu(jnp.asarray(grid.numpy()), approximate=False)), rtol=1e-5, atol=2e-6,
    )
    labels = np.array([0, 2, 5, -1, 1])
    hot, jhot = F.one_hot(torch.from_numpy(labels), 3), np.asarray(jht.nn.functional.one_hot(jnp.asarray(labels), 3))
    assert str(hot.dtype).removeprefix("torch.") == jhot.dtype.name
    np.testing.assert_array_equal(hot.numpy(), jhot)
    np.testing.assert_allclose(
        F.softmax(x, -1).numpy(), np.asarray(jht.nn.functional.softmax(jnp.asarray(x.numpy()))), rtol=1e-5, atol=1e-6
    )
    assert F.conv2d is torch.nn.functional.conv2d and F.mse_loss is torch.nn.functional.mse_loss
    # the names heat_tpu.nn defines are the port's own; the others fall through to torch.nn
    assert ht.nn.Conv2d is ht.nn.modules.Conv2d and ht.nn.Dropout is ht.nn.modules.Dropout
    assert ht.nn.BatchNorm2d is torch.nn.BatchNorm2d
    with pytest.raises(AttributeError):
        F.no_such_function
    with pytest.raises(AttributeError):
        ht.nn.NoSuchLayer


# --------------------------------------------------------------------- #
# the tiny transformer block (tests/test_nn_optim.py:857)               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [False, True])
def test_tiny_transformer_block_matches_heat_tpu(causal):
    S, D = 64, 8
    tokens = np.random.default_rng(2).integers(0, 16, size=S).astype(np.int32)
    j_emb, j_ln, j_proj = jm.Embedding(16, D), jm.LayerNorm(D), jm.Linear(D, D)
    pe, pp = _params(j_emb, 3), _params(j_proj, 4)
    pl = {"weight": _x((D,), 5), "bias": _x((D,), 6)}
    h = j_ln.apply(pl, j_emb.apply(pe, jnp.asarray(tokens)))
    hd = jht.array(np.asarray(h), split=0)
    ref = np.asarray(j_proj.apply(pp, jht.nn.ring_attention(hd, hd, hd, causal=causal).larray))

    emb = nn_params_from_numpy(ht.nn.Embedding(16, D), pe)
    ln = nn_params_from_numpy(ht.nn.LayerNorm(D), pl)
    proj = nn_params_from_numpy(ht.nn.Linear(D, D), pp)
    with torch.no_grad():
        th = ht.array(ln(emb(torch.from_numpy(tokens))), split=0)
        att = ht.nn.ring_attention(th, th, th, causal=causal)
        out = proj(att.larray)
    assert att.split == 0 and out.shape == (S, D)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
