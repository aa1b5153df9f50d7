"""Neural-network modules (port of ``heat_tpu.nn.modules``).

``heat_tpu``'s modules are stateless (``init(key)`` returns a parameter
dict, ``apply(params, x, train=..., key=...)`` is pure) because JAX is.
Here they are ``torch.nn.Module``s (``Module``) whose parameters carry
``heat_tpu``'s names and layouts, so that a ``heat_tpu`` parameter dict
loads into them as it is (``core.interop.nn_params_from_numpy``; a
``Sequential``'s tuple of dicts too): weights stored (in, out), ``Conv2d``'s
OIHW; ``MultiheadAttention``'s ``in_proj`` (E, 3E), ``in_bias``,
``out_proj`` (E, E), ``out_bias``. Each module takes ``device=`` (default
``ht.get_device()``, the card) and ``dtype=``, and draws its values from
the Threefry key it is given (``key=``, a key of ``core._threefry``:
``seed_key``, ``split``, ``fold_in``) as ``heat_tpu``'s ``init(key)``
draws them, bit for bit, on the module's device (kernel R1 on a card);
without a key it takes the next key of the global stream (``ht.random``),
which then advances by the parameters' element count (``heat_tpu``'s
modules draw nothing until ``init``). ``init(key)`` draws them again from
``key``, following ``heat_tpu``'s split tree (``Sequential`` splits its key
into one key a module), which is what ``DataParallel(module, key=)``
calls.

Training follows torch: ``module.train()``/``eval()`` and
``loss.backward()``. ``forward(x, key=None, batch=None)``: dropout layers
in training mode need ``key`` (``heat_tpu``'s ``apply(train=True,
key=...)`` raises without one) and draw the mask as
``jax.random.bernoulli(key, 1 - p, shape)`` does, a float64 uniform (the
x64 policy) below 1 - p, through R1; ``batch=(start, total)`` places x's
rows at ``start`` of a global batch of ``total`` rows, so that a rank
draws its rows of the one global mask. Float32 convolutions run in full
FP32 forward and backward (cuDNN's TF32 switched off around each call).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as _F

from ..core import _threefry, random as ht_random, types
from ..core.devices import sanitize_device
from ..kernels import threefry as _r1

__all__ = [
    "AvgPool2d",
    "Conv2d",
    "CrossEntropyLoss",
    "Dropout",
    "Dropout2d",
    "Embedding",
    "Flatten",
    "GELU",
    "LayerNorm",
    "Linear",
    "LogSoftmax",
    "MSELoss",
    "MaxPool2d",
    "Module",
    "MultiheadAttention",
    "NLLLoss",
    "ReLU",
    "Sequential",
    "Sigmoid",
    "Softmax",
    "Tanh",
    "scalar_dndarray",
]


def _placement(device, dtype):
    return sanitize_device(device).torch_device, types.canonical_heat_type(dtype).torch_type()


def _key(key, numel: int):
    """The module's key: the one given, or the global stream's next."""
    return ht_random._next_key(numel) if key is None else key


def _uniform(key, shape, device, dtype, bound: float) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=-bound, maxval=bound, dtype)``."""
    return _r1.draw("uniform", key, _threefry.Chunk.whole(shape), dtype, device, (-bound, bound))


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        a, b = v
        return int(a), int(b)
    return int(v), int(v)


class Module(torch.nn.Module):
    """Base class of the port's layers: a ``torch.nn.Module`` with
    ``heat_tpu``'s ``init(key)``, which draws the parameters again from
    ``key`` (in place, so optimizers holding them see the new values),
    and ``forward(x, key=None, batch=None)``."""

    def init(self, key) -> "Module":
        """Draw this module's parameters from ``key`` (none here)."""
        return self

    def _set(self, name: str, value: torch.Tensor) -> None:
        """Parameter ``name`` takes ``value``: in place when it exists."""
        own = getattr(self, name, None)
        if isinstance(own, torch.nn.Parameter) and own.shape == value.shape:
            with torch.no_grad():
                own.copy_(value)
        else:
            setattr(self, name, torch.nn.Parameter(value))

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        raise NotImplementedError


class Linear(Module):
    """Affine layer y = x W + b (``heat_tpu``'s ``Linear``, ``:77``): the
    weight stored (in_features, out_features); torch.nn.Linear's
    Kaiming-uniform bound 1/sqrt(in_features) for weight and bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=types.float32,
                 device=None, key=None):
        super().__init__()
        self.in_features, self.out_features = int(in_features), int(out_features)
        self._device, self._dtype = _placement(device, dtype)
        self.bias = None
        self._has_bias = bool(bias)
        self.init(_key(key, (self.in_features + bias) * self.out_features))

    def init(self, key) -> "Linear":
        bound = 1.0 / math.sqrt(self.in_features)
        wkey, bkey = _threefry.split(key)
        self._set("weight", _uniform(wkey, (self.in_features, self.out_features), self._device, self._dtype, bound))
        if self._has_bias:
            self._set("bias", _uniform(bkey, (self.out_features,), self._device, self._dtype, bound))
        return self

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        y = x @ self.weight
        return y + self.bias if self.bias is not None else y


class MultiheadAttention(Module):
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
        self._device, self._dtype = _placement(device, dtype)
        self.in_bias = self.out_bias = None
        self._has_bias = bool(bias)
        self.init(_key(key, 4 * self.embed_dim * self.embed_dim))

    def init(self, key) -> "MultiheadAttention":
        e, dev, dt = self.embed_dim, self._device, self._dtype
        k_in, k_out = _threefry.split(key)
        self._set("in_proj", _uniform(k_in, (e, 3 * e), dev, dt, math.sqrt(6.0 / (e + 3 * e))))
        self._set("out_proj", _uniform(k_out, (e, e), dev, dt, 1.0 / math.sqrt(e)))
        if self._has_bias:
            self._set("in_bias", torch.zeros(3 * e, device=dev, dtype=dt))
            self._set("out_bias", torch.zeros(e, device=dev, dtype=dt))
        return self

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
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


class LayerNorm(Module):
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
        self._device, self._dtype = _placement(device, dtype)
        self.weight = self.bias = None
        self._affine = bool(elementwise_affine)
        self.init(None)

    def init(self, key) -> "LayerNorm":
        """Ones and zeros, as ``heat_tpu``'s ``init`` gives whatever the key."""
        if self._affine:
            self._set("weight", torch.ones(self.normalized_shape, device=self._device, dtype=self._dtype))
            self._set("bias", torch.zeros(self.normalized_shape, device=self._device, dtype=self._dtype))
        return self

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        tail = tuple(x.shape[x.ndim - len(self.normalized_shape):])
        if tail != self.normalized_shape:
            raise ValueError(f"expected input with trailing shape {self.normalized_shape}, got {tail}")
        dims = tuple(range(x.ndim - len(self.normalized_shape), x.ndim))
        mean = x.mean(dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dims, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * self.weight + self.bias if self.weight is not None else y


class Embedding(Module):
    """Lookup table with N(0, 1) initial rows (``heat_tpu``'s
    ``Embedding``, ``:334``); an id outside [0, num_embeddings) raises
    ``IndexError``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, dtype=types.float32, device=None, key=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = int(num_embeddings), int(embedding_dim)
        self._device, self._dtype = _placement(device, dtype)
        self.init(_key(key, self.num_embeddings * self.embedding_dim))

    def init(self, key) -> "Embedding":
        shape = (self.num_embeddings, self.embedding_dim)
        chunk = _threefry.Chunk.whole(shape)
        self._set("weight", _r1.draw("normal", key, chunk, self._dtype, self._device, (0.0, 1.0)))
        return self

    def forward(self, ids: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=self.weight.device)
        if ids.numel() and bool(((ids < 0) | (ids >= self.num_embeddings)).any()):
            raise IndexError(f"index out of range in Embedding({self.num_embeddings}, {self.embedding_dim})")
        return self.weight[ids.long()]


# --------------------------------------------------------------------- #
# convolution and pooling                                               #
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def _full_fp32():
    """cuDNN's TF32 off for the calls inside (restored after), so float32
    convolutions round as FP32 does on the card as on the CPU."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


class _Conv(torch.autograd.Function):
    """``conv2d(x, w)`` (no bias, no padding) whose forward and backward
    both run with cuDNN's TF32 off: autograd runs the backward after the
    forward's context has closed."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _full_fp32():
            return _F.conv2d(x, w, None, stride)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _full_fp32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                grad, x, w, None, list(ctx.stride), [0, 0], [1, 1], False, [0, 0], 1, mask
            )
        return gx, gw, None


class Conv2d(Module):
    """2-D convolution over NCHW inputs (``heat_tpu``'s ``Conv2d``,
    ``:115``; torch.nn.Conv2d's Kaiming-uniform bound 1/sqrt(fan_in)):
    weight (out, in, kh, kw), bias added after the contraction.
    ``padding`` is ints or ``"valid"``/``"same"``; ``"same"`` (stride 1
    only) puts the odd element of an even kernel's padding on the high
    side, as torch and ``heat_tpu`` (``:133-147``) do. Float32 runs in full
    FP32, forward and backward."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding=0, bias: bool = True,
                 dtype=types.float32, device=None, key=None):
        super().__init__()
        self.in_channels, self.out_channels = int(in_channels), int(out_channels)
        self.kernel_size, self.stride = _pair(kernel_size), _pair(stride)
        kh, kw = self.kernel_size
        if isinstance(padding, str):
            pad = padding.lower()
            if pad == "valid":
                self.padding = ((0, 0), (0, 0))
            elif pad == "same":
                if self.stride != (1, 1):
                    raise ValueError("padding='same' is not supported for strided convolutions")
                self.padding = (((kh - 1) // 2, kh - 1 - (kh - 1) // 2), ((kw - 1) // 2, kw - 1 - (kw - 1) // 2))
            else:
                raise ValueError(f"padding must be 'same', 'valid' or ints, got {padding!r}")
        else:
            ph, pw = _pair(padding)
            self.padding = ((ph, ph), (pw, pw))
        self._device, self._dtype = _placement(device, dtype)
        self.bias = None
        self._has_bias = bool(bias)
        self.init(_key(key, (self.in_channels * kh * kw + bias) * self.out_channels))

    def init(self, key) -> "Conv2d":
        kh, kw = self.kernel_size
        bound = 1.0 / math.sqrt(self.in_channels * kh * kw)
        wkey, bkey = _threefry.split(key)
        shape = (self.out_channels, self.in_channels, kh, kw)
        self._set("weight", _uniform(wkey, shape, self._device, self._dtype, bound))
        if self._has_bias:
            self._set("bias", _uniform(bkey, (self.out_channels,), self._device, self._dtype, bound))
        return self

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        (top, bottom), (left, right) = self.padding
        if top or bottom or left or right:
            x = _F.pad(x, (left, right, top, bottom))
        y = _Conv.apply(x, self.weight, self.stride)
        return y + self.bias[None, :, None, None] if self.bias is not None else y


class _Pool2d(Module):
    def __init__(self, kernel_size, stride=None):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None else self.kernel_size


class MaxPool2d(_Pool2d):
    """Max over windows of NCHW, no padding (``heat_tpu``'s ``MaxPool2d``,
    ``:257``); integer inputs keep their type."""

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        if x.is_floating_point():
            return _F.max_pool2d(x, self.kernel_size, self.stride)
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        return x.unfold(2, kh, sh).unfold(3, kw, sw).amax((-2, -1))


class AvgPool2d(_Pool2d):
    """Mean over windows of NCHW, no padding (``heat_tpu``'s ``AvgPool2d``,
    ``:286``)."""

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        return _F.avg_pool2d(x, self.kernel_size, self.stride)


# --------------------------------------------------------------------- #
# activations, reshapes and dropout                                     #
# --------------------------------------------------------------------- #
class ReLU(Module):
    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        return torch.relu(x)


class GELU(Module):
    """``jax.nn.gelu``'s tanh form, ``heat_tpu``'s ``GELU``."""

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        return _F.gelu(x, approximate="tanh")


class Tanh(Module):
    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        return torch.tanh(x)


class Sigmoid(Module):
    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        return torch.sigmoid(x)


class LogSoftmax(Module):
    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        return _F.log_softmax(x, self.dim)


class Softmax(Module):
    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        return _F.softmax(x, self.dim)


class Flatten(Module):
    def __init__(self, start_dim: int = 1):
        super().__init__()
        self.start_dim = start_dim

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        return x.reshape(tuple(x.shape[: self.start_dim]) + (-1,))


class Dropout(Module):
    """Zero each element with probability p in training mode and scale the
    rest by 1/(1 - p) (``heat_tpu``'s ``Dropout``, ``:404``). The mask is
    ``jax.random.bernoulli(key, 1 - p, shape)``: a float64 uniform below
    1 - p, drawn for this tensor's rows of the global batch ``batch``
    (one R1 launch on a card)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout probability must be in [0, 1], got {p}")
        self.p = float(p)

    def _mask_shape(self, x: torch.Tensor):
        return tuple(x.shape)

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        if key is None:
            raise ValueError(f"{type(self).__name__} in training mode requires a PRNG key")
        keep = 1.0 - self.p
        shape = self._mask_shape(x)
        start, total = (0, shape[0]) if batch is None else batch
        chunk = _threefry.Chunk((int(total),) + shape[1:], 0, int(start), shape[0])
        mask = _r1.draw("uniform", key, chunk, torch.float64, x.device, (0.0, 1.0)) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout2d(Dropout):
    """Channel-wise dropout over NCHW (``heat_tpu``'s ``Dropout2d``,
    ``:436``): whole feature maps are zeroed together."""

    def _mask_shape(self, x: torch.Tensor):
        return tuple(x.shape[:2]) + (1,) * (x.ndim - 2)


class Sequential(Module):
    """A chain of modules (``heat_tpu``'s ``Sequential``, ``:443``), named
    "0", "1", ... as torch.nn.Sequential names them. ``init(key)`` gives
    module i the i-th key of ``split(key, len)``; a forward with a key
    gives each module the i-th key of its split the same way."""

    def __init__(self, *modules: torch.nn.Module):
        super().__init__()
        for i, m in enumerate(modules):
            self.add_module(str(i), m)

    def init(self, key) -> "Sequential":
        for m, k in zip(self.children(), _threefry.split(key, max(len(self._modules), 1))):
            if isinstance(m, Module):
                m.init(k)
        return self

    def forward(self, x: torch.Tensor, key=None, batch=None) -> torch.Tensor:
        n = len(self._modules)
        keys = _threefry.split(key, max(n, 1)) if key is not None else [None] * n
        for m, k in zip(self.children(), keys):
            x = m(x, key=k, batch=batch) if isinstance(m, Module) else m(x)
        return x


# --------------------------------------------------------------------- #
# losses                                                                #
# --------------------------------------------------------------------- #
def scalar_dndarray(val: torch.Tensor, comm, device):
    """A 0-d tensor as a replicated DNDarray (the losses' and the
    optimizers' results)."""
    from ..core.dndarray import DNDarray

    val = val.reshape(())
    return DNDarray(val, (), types.canonical_heat_type(val.dtype), None, device, comm)


def aligned_rows(y, x) -> torch.Tensor:
    """``y``'s rows (axis 0) that match this rank's rows of ``x``: its shard
    when both are split 0 over the same rows, else the rows taken from a
    copy moved to ``x``'s counts, or sliced from the whole ``y``."""
    from ..core.dndarray import DNDarray

    if not isinstance(y, DNDarray):
        return torch.as_tensor(y)
    if not (isinstance(x, DNDarray) and x.is_distributed() and x.split == 0):
        return y.resplit(None).larray if y.is_distributed() else y.larray
    counts = np.asarray(x.lshape_map[:, 0])
    if y.split == 0 and y.is_distributed():
        if np.array_equal(np.asarray(y.lshape_map[:, 0]), counts):
            return y.larray
        twin = y.copy()
        target = np.array(twin.lshape_map)
        target[:, 0] = counts
        twin.redistribute_(target_map=target)
        return twin.larray
    whole = y.resplit(None).larray if y.is_distributed() else y.larray
    start = int(counts[: x.comm.rank].sum())
    return whole[start : start + int(counts[x.comm.rank])]


class _Loss:
    """A loss: ``raw(output, target, weight)`` on tensors is the weighted
    mean (the contract the optimizers rely on); calling it on DNDarrays
    gives the mean over the global batch as a replicated 0-d DNDarray (a
    batch split along axis 0: the sums all-reduced)."""

    def raw(self, output: torch.Tensor, target, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        per = self._per_sample(output, target)
        if weight is not None:
            return torch.sum(per * weight) / torch.clamp_min(torch.sum(weight), 1.0)
        return torch.mean(per)

    def _per_sample(self, output: torch.Tensor, target) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, output, target):
        from ..core.dndarray import DNDarray

        if not isinstance(output, DNDarray):
            return self.raw(output, target)
        per = self._per_sample(output.larray, aligned_rows(target, output).to(output.larray.device))
        if output.is_distributed() and output.split == 0:
            total = output.comm.allreduce(torch.stack([per.sum(), per.new_tensor(per.shape[0])]))
            val = total[0] / torch.clamp_min(total[1], 1.0)
        else:
            val = torch.mean(per)
        return scalar_dndarray(val, output.comm, output.device)


class MSELoss(_Loss):
    def _per_sample(self, output, target):
        d = (output - torch.as_tensor(target, device=output.device).to(output.dtype)) ** 2
        return d.reshape(d.shape[0], -1).mean(dim=1) if d.ndim > 1 else d


class NLLLoss(_Loss):
    """Negative log likelihood over log-probabilities."""

    def _per_sample(self, output, target):
        idx = torch.as_tensor(target, device=output.device).long()[:, None]
        return -torch.take_along_dim(output, idx, dim=1)[:, 0]


class CrossEntropyLoss(_Loss):
    """Softmax cross entropy over raw logits."""

    def _per_sample(self, output, target):
        idx = torch.as_tensor(target, device=output.device).long()[:, None]
        return -torch.take_along_dim(_F.log_softmax(output, -1), idx, dim=1)[:, 0]
