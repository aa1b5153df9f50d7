"""Pseudo-random number generation.

Port of ``heat_tpu.core.random`` (Heat reference: heat/core/random.py): its
15 exports, drawing ``heat_tpu``'s stream, JAX's partitionable
Threefry-2x32 (``core/_threefry.py``). A global (seed, counter) pair gives
each draw its key, ``fold_in(fold_in(key(seed), lo), hi)`` of the counter's
words, and the counter then advances by the elements drawn, as in
``heat_tpu`` (random.py:67-79). A seeded draw therefore gives ``heat_tpu``'s
values (normals within a few ulp: the erf⁻¹ polynomial's log1p and
rounding are torch's), and ``set_state(heat_tpu.random.get_state())``
continues ``heat_tpu``'s stream; the state's algorithm is ``"Threefry"``.

Every element's random bits depend only on the key and its global flat
index, so a split draw makes only this rank's chunk: on a card one launch
of kernel R1 (``kernels/threefry.py``) of the chunk's element count, none
for an empty chunk. A permutation is computed whole on every rank, as
``heat_tpu`` does.

``heat_tpu`` is one controller over its mesh and so has one stream. The
port runs a process per rank, so a seed taken from the clock is rank 0's,
broadcast to every rank (``seed()``); an explicit ``seed(n)`` stays
rank-local and issues no collective.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Tuple, Type, Union

import numpy as np
import torch

from . import _threefry, types
from ..kernels import threefry as _r1
from .communication import get_comm, sanitize_comm
from .devices import get_device, sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "get_state",
    "normal",
    "permutation",
    "rand",
    "ranf",
    "randint",
    "random_integer",
    "randn",
    "random",
    "random_sample",
    "randperm",
    "sample",
    "seed",
    "set_state",
    "standard_normal",
]

#: name of the stream in the state tuple, ``heat_tpu``'s
ALGORITHM = "Threefry"

__seed: Optional[int] = None
__counter: int = 0

_FLOATS = (types.float16, types.bfloat16, types.float32, types.float64)
_INTS = (types.int8, types.int16, types.int32, types.int64, types.uint8)


def seed(seed: Optional[int] = None) -> None:
    """Seed the generator (reference: random.py seed). Without a seed the
    clock gives one; in a world of more than one rank it is rank 0's,
    broadcast through the default communicator, so every rank must call
    (the first draw or ``get_state`` of an unseeded stream calls it on
    every rank alike)."""
    global __seed, __counter
    if seed is None:
        seed = int(time.time() * 1000) % (2**32)
        comm = get_comm()
        if comm.is_distributed():
            mine = torch.tensor([seed], dtype=torch.int64, device=get_device().torch_device)
            seed = int(comm.bcast(mine, root=0).item())
    __seed = int(seed)
    __counter = 0


def get_state() -> Tuple[str, int, int, int, float]:
    """The generator's state ``("Threefry", seed, counter, 0, 0.0)``, as
    ``heat_tpu``'s (reference: random.py get_state)."""
    if __seed is None:
        seed()
    return (ALGORITHM, __seed, __counter, 0, 0.0)


def set_state(state: Tuple[str, int, int, int, float]) -> None:
    """Set the generator's state from a 3- or 5-tuple (reference: random.py
    set_state); a ``heat_tpu`` state continues its stream. The algorithm
    must be ``"Threefry"``."""
    global __seed, __counter
    if not isinstance(state, tuple) or len(state) not in (3, 5):
        raise ValueError("state needs to be a 3- or 5-tuple")
    if state[0] != ALGORITHM:
        raise ValueError(f"algorithm must be {ALGORITHM!r}, got {state[0]!r}")
    __seed = int(state[1])
    __counter = int(state[2])


def _next_key(numel: int) -> _threefry.Key:
    """The key of the next draw: both 32-bit words of the counter folded
    into the seed's key (``heat_tpu`` random.py:67); the counter then
    advances by ``numel``."""
    global __counter
    if __seed is None:
        seed()
    key = _threefry.seed_key(__seed)
    key = _threefry.fold_in(key, __counter & 0xFFFFFFFF)
    key = _threefry.fold_in(key, (__counter >> 32) & 0xFFFFFFFF)
    __counter += int(numel)
    return key


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


def _draw(mode: str, shape, dtype, split, device, comm, args=()) -> DNDarray:
    """One draw of global ``shape``: this rank makes its chunk alone."""
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    shape = tuple(int(s) for s in shape)
    split = sanitize_axis(shape, split)
    key = _next_key(_numel(shape))
    chunk = _threefry.Chunk.of(shape, split, comm)
    data = _r1.draw(mode, key, chunk, dtype.torch_type(), device.torch_device, args)
    return DNDarray(data, shape, dtype, split, device, comm)


def _float_type(dtype):
    dtype = types.canonical_heat_type(dtype)
    if dtype not in _FLOATS:
        raise ValueError(f"dtype must be a float type, got {dtype}")
    return dtype


def normal(
    mean=0.0,
    std=1.0,
    shape: Optional[Tuple[int, ...]] = None,
    dtype: Type[types.datatype] = types.float32,
    split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """Normal samples with the given mean and standard deviation
    (reference: random.py normal): ``jax.random.normal(key) * std + mean``.
    ``mean`` and ``std`` are numbers, or DNDarrays that broadcast against
    the draw (any split: the binary-op machinery aligns them with the
    draw's shards), as ``heat_tpu`` takes them (random.py:200-207);
    without ``shape`` the draw takes the moments' shape."""
    if shape is None:
        shape = getattr(mean, "shape", None) or getattr(std, "shape", None) or ()
    shape = sanitize_shape(shape) if shape != () else ()
    dtype = _float_type(dtype)
    if isinstance(mean, DNDarray) or isinstance(std, DNDarray):
        from . import arithmetics

        base = _draw("normal", shape, dtype, split, device, comm, (0.0, 1.0))
        # the moments broadcast against the draw, which keeps its split
        return arithmetics.add(arithmetics.mul(base, std), mean).astype(dtype, copy=False)
    return _draw("normal", shape, dtype, split, device, comm, (float(mean), float(std)))


def permutation(x) -> DNDarray:
    """A random permutation of arange(x), or a copy of ``x`` with its rows
    (axis 0) shuffled (reference: random.py permutation). The permutation
    is computed whole on every rank; a split-0 array then moves its rows
    with one all-to-all, any other array takes them locally."""
    if isinstance(x, (int, np.integer)):
        return randperm(int(x))
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected int or DNDarray, got {type(x)}")
    n = x.shape[0] if x.ndim else 1
    perm = _r1.shuffle(_next_key(n), n, x.larray.device)
    if x.split != 0 or not x.comm.is_distributed():
        values = torch.index_select(x.larray, 0, perm)
        return DNDarray(values, x.shape, x.dtype, x.split, x.device, x.comm)
    return _permute_rows(x, perm)


def _permute_rows(x: DNDarray, perm: torch.Tensor) -> DNDarray:
    """``x[perm]`` of a split-0 ``x``, each rank keeping its chunk: row i of
    the result is global row perm[i], which its owner sends in one
    all-to-all."""
    comm, dev = x.comm, perm.device
    counts, displs = x.counts_displs()  # where the rows lie now
    r_counts, r_displs, r_lshape = comm.counts_displs_shape(x.shape, 0)  # where the result's rows go
    owner = torch.searchsorted(torch.tensor(np.cumsum(counts), device=dev), perm, right=True)
    dest = torch.searchsorted(torch.tensor(np.cumsum(r_counts), device=dev), torch.arange(x.shape[0], device=dev),
                              right=True)
    # the rows this rank sends, by destination rank and then by their place
    # in the result (nonzero is ascending; the stable sort keeps that order)
    out_pos = torch.nonzero(owner == comm.rank).reshape(-1)
    out_pos = out_pos[torch.sort(dest[out_pos], stable=True).indices]
    send = x.larray[perm[out_pos] - displs[comm.rank]]
    send_counts = torch.bincount(dest[out_pos], minlength=comm.size).tolist()
    # the rows this rank receives: its result rows, grouped by their owner
    src = owner[r_displs[comm.rank] : r_displs[comm.rank] + r_counts[comm.rank]]
    recv_counts = torch.bincount(src, minlength=comm.size).tolist()
    got = comm.alltoall(send.contiguous(), send_counts, recv_counts)
    values = x.larray.new_empty(r_lshape)
    values[torch.sort(src, stable=True).indices] = got
    return DNDarray(values, x.shape, x.dtype, 0, x.device, comm)


def rand(*args, dtype=types.float32, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Uniform [0, 1) samples of the given shape (reference: random.py rand)."""
    shape = sanitize_shape(args) if args else ()
    return _draw("uniform", shape, _float_type(dtype), split, device, comm, (0.0, 1.0))


def randint(
    low: int,
    high: Optional[int] = None,
    size: Optional[Union[int, Tuple[int, ...]]] = None,
    dtype=types.int32,
    split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """Random integers in [low, high) (reference: random.py randint)."""
    if high is None:
        low, high = 0, low
    shape = sanitize_shape(size) if size is not None and size != () else ()
    if low >= high:
        raise ValueError(f"low >= high ({low} >= {high})")
    dtype = types.canonical_heat_type(dtype if dtype is not None else types.int32)
    if dtype not in _INTS:
        raise ValueError(f"dtype must be an integer type, got {dtype}")
    return _draw("randint", shape, dtype, split, device, comm, (int(low), int(high)))


random_integer = randint


def randn(*args, dtype=types.float32, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples of the given shape (reference: random.py randn)."""
    shape = sanitize_shape(args) if args else ()
    return _draw("normal", shape, _float_type(dtype), split, device, comm, (0.0, 1.0))


def random_sample(shape=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform [0, 1) samples (reference: random.py random_sample); the
    default shape is (1,)."""
    shape = sanitize_shape(shape if shape is not None else (1,))
    return rand(*shape, dtype=dtype, split=split, device=device, comm=comm)


random = random_sample
ranf = random_sample
sample = random_sample


def randperm(n: int, dtype=types.int64, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Random permutation of arange(n) (reference: random.py randperm),
    computed whole on every rank (``jax.random.permutation``'s sort rounds,
    K4 on a card); the counter advances by n."""
    if not isinstance(n, (int, np.integer)):
        raise TypeError(f"n must be an integer, got {type(n)}")
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    data = _r1.shuffle(_next_key(int(n)), int(n), device.torch_device).to(dtype.torch_type())
    split = sanitize_axis(data.shape, split)
    if split is not None and comm.is_distributed():
        _, _, slices = comm.chunk(data.shape, split)
        data = data[slices].clone()
    return DNDarray(data, (int(n),), dtype, split, device, comm)


def standard_normal(shape=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples (reference: random.py standard_normal); the
    default shape is (1,)."""
    shape = sanitize_shape(shape if shape is not None else (1,))
    return randn(*shape, dtype=dtype, split=split, device=device, comm=comm)
