"""Neural-network modules (port of the attention building blocks of
``heat_tpu.nn.modules``: ``Linear``, ``MultiheadAttention``, ``LayerNorm``,
``Embedding``).

``heat_tpu``'s modules are stateless (``init(key)`` returns a parameter
dict, ``apply(params, x)`` is pure) because JAX is. Here they are
``torch.nn.Module``s whose parameters carry ``heat_tpu``'s names and
layouts, so that a ``heat_tpu`` parameter dict loads into them as it is
(``core.interop.nn_params_from_numpy``): weights stored (in, out);
``MultiheadAttention``'s ``in_proj`` (E, 3E), ``in_bias``, ``out_proj``
(E, E), ``out_bias``. Each module takes ``device=`` (default
``ht.get_device()``, the card) and ``dtype=``, and draws its initial values
from the Threefry key it is given (``key=``, a key of
``core._threefry``: ``seed_key``, ``split``, ``fold_in``) as ``heat_tpu``'s
``init(key)`` draws them, bit for bit, on the module's device (kernel R1
on a card); without a key it takes the next key of the global stream
(``ht.random``), which then advances by the elements drawn.
The other modules of ``heat_tpu.nn.modules`` wait for ROADMAP.md Queue 1,
item 8.
"""

from __future__ import annotations

import math
import torch

from ..core import _threefry, random as ht_random, types
from ..core.devices import sanitize_device
from ..kernels import threefry as _r1

__all__ = ["Embedding", "LayerNorm", "Linear", "MultiheadAttention"]


def _placement(device, dtype):
    return sanitize_device(device).torch_device, types.canonical_heat_type(dtype).torch_type()


def _key(key, numel: int):
    """The module's key: the one given, or the global stream's next."""
    return ht_random._next_key(numel) if key is None else key


def _uniform(key, shape, device, dtype, bound: float) -> torch.nn.Parameter:
    """``jax.random.uniform(key, shape, minval=-bound, maxval=bound, dtype)``."""
    chunk = _threefry.Chunk.whole(shape)
    return torch.nn.Parameter(_r1.draw("uniform", key, chunk, dtype, device, (-bound, bound)))


class Linear(torch.nn.Module):
    """Affine layer y = x W + b (``heat_tpu``'s ``Linear``, ``:77``): the
    weight stored (in_features, out_features); torch.nn.Linear's
    Kaiming-uniform bound 1/sqrt(in_features) for weight and bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=types.float32,
                 device=None, key=None):
        super().__init__()
        self.in_features, self.out_features = int(in_features), int(out_features)
        dev, dt = _placement(device, dtype)
        bound = 1.0 / math.sqrt(self.in_features)
        wkey, bkey = _threefry.split(_key(key, (self.in_features + bias) * self.out_features))
        self.weight = _uniform(wkey, (self.in_features, self.out_features), dev, dt, bound)
        self.bias = _uniform(bkey, (self.out_features,), dev, dt, bound) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight
        return y + self.bias if self.bias is not None else y


class MultiheadAttention(torch.nn.Module):
    """Multi-head self-attention (``heat_tpu``'s ``MultiheadAttention``,
    ``:184``; torch.nn.MultiheadAttention with batch_first, self-attention
    form): x @ in_proj → (B, S, 3, H, D) → three (B, H, S, D) views →
    ``scaled_dot_product_attention`` (one launch of K9 on a card, reading
    the views in place) → merge → out_proj. Unbatched (S, E) input works.
    ``in_proj`` is torch's ``in_proj_weight`` transposed, ``out_proj``
    torch's ``out_proj.weight`` transposed; xavier-uniform and
    1/sqrt(E) bounds as ``heat_tpu`` draws them, zero biases."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True, causal: bool = False,
                 dtype=types.float32, device=None, key=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed_dim ({embed_dim}) must be divisible by num_heads ({num_heads})")
        self.embed_dim, self.num_heads = int(embed_dim), int(num_heads)
        self.head_dim = self.embed_dim // self.num_heads
        self.causal = bool(causal)
        dev, dt = _placement(device, dtype)
        e = self.embed_dim
        k_in, k_out = _threefry.split(_key(key, 4 * e * e))
        self.in_proj = _uniform(k_in, (e, 3 * e), dev, dt, math.sqrt(6.0 / (e + 3 * e)))
        self.out_proj = _uniform(k_out, (e, e), dev, dt, 1.0 / math.sqrt(e))
        if bias:
            self.in_bias = torch.nn.Parameter(torch.zeros(3 * e, device=dev, dtype=dt))
            self.out_bias = torch.nn.Parameter(torch.zeros(e, device=dev, dtype=dt))
        else:
            self.in_bias = self.out_bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from .functional import scaled_dot_product_attention

        squeeze = x.ndim == 2
        if squeeze:
            x = x[None]
        b, s, e = x.shape
        h, d = self.num_heads, self.head_dim
        qkv = x @ self.in_proj
        if self.in_bias is not None:
            qkv = qkv + self.in_bias
        qkv = qkv.reshape(b, s, 3, h, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = scaled_dot_product_attention(q, k, v, is_causal=self.causal)
        out = out.transpose(1, 2).reshape(b, s, e) @ self.out_proj
        if self.out_bias is not None:
            out = out + self.out_bias
        return out[0] if squeeze else out


class LayerNorm(torch.nn.Module):
    """Normalization over the trailing ``normalized_shape`` dims with
    learnable scale and shift (``heat_tpu``'s ``LayerNorm``, ``:296``);
    a mismatched trailing shape raises ``ValueError``."""

    def __init__(self, normalized_shape, eps: float = 1e-5, elementwise_affine: bool = True,
                 dtype=types.float32, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(n) for n in normalized_shape)
        self.eps = float(eps)
        dev, dt = _placement(device, dtype)
        if elementwise_affine:
            self.weight = torch.nn.Parameter(torch.ones(self.normalized_shape, device=dev, dtype=dt))
            self.bias = torch.nn.Parameter(torch.zeros(self.normalized_shape, device=dev, dtype=dt))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tail = tuple(x.shape[x.ndim - len(self.normalized_shape):])
        if tail != self.normalized_shape:
            raise ValueError(f"expected input with trailing shape {self.normalized_shape}, got {tail}")
        dims = tuple(range(x.ndim - len(self.normalized_shape), x.ndim))
        mean = x.mean(dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dims, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * self.weight + self.bias if self.weight is not None else y


class Embedding(torch.nn.Module):
    """Lookup table with N(0, 1) initial rows (``heat_tpu``'s
    ``Embedding``, ``:334``); an id outside [0, num_embeddings) raises
    ``IndexError``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, dtype=types.float32, device=None, key=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = int(num_embeddings), int(embedding_dim)
        dev, dt = _placement(device, dtype)
        shape = (self.num_embeddings, self.embedding_dim)
        weight = _r1.draw("normal", _key(key, math.prod(shape)), _threefry.Chunk.whole(shape), dt, dev, (0.0, 1.0))
        self.weight = torch.nn.Parameter(weight)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=self.weight.device)
        if ids.numel() and bool(((ids < 0) | (ids >= self.num_embeddings)).any()):
            raise IndexError(f"index out of range in Embedding({self.num_embeddings}, {self.embedding_dim})")
        return self.weight[ids.long()]
