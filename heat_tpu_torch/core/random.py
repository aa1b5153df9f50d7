"""Pseudo-random number generation.

Port of the draws of ``heat_tpu.core.random`` that the ported slices
need (Heat reference: heat/core/random.py): ``seed``, ``get_state``,
``set_state``, ``randn``, ``rand``, ``normal``, ``randint`` and
``randperm``. A global (seed, counter) pair advances by the number of
elements each draw takes, as in ``heat_tpu``; each draw runs on its own
``torch.Generator`` on the target device, seeded from that pair. A split
draw makes the whole array on every rank and keeps this rank's chunk, so
its global values do not depend on the world size (drawing only the
chunk waits for a counter-based stream, ROADMAP.md Queue 1, item 5). The
values are torch's stream for that device (Philox on CUDA, MT19937 on the
CPU), not ``heat_tpu``'s Threefry stream: porting Threefry is ROADMAP.md
Queue 1. The state names the port's stream as ``"TorchGenerator"``.

``heat_tpu`` is one controller over its mesh and so has one stream. The
port runs a process per rank, so a seed taken from the clock is rank 0's,
broadcast to every rank (``seed()``); an explicit ``seed(n)`` stays
rank-local and issues no collective.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple, Type, Union

import numpy as np
import torch

from . import types
from .communication import get_comm, sanitize_comm
from .devices import get_device, sanitize_device
from .dndarray import DNDarray
from .factories import _wrap
from .stride_tricks import sanitize_shape

__all__ = ["get_state", "normal", "rand", "randint", "randn", "randperm", "seed", "set_state"]

#: name of the port's stream in the state tuple (``heat_tpu``'s is "Threefry")
ALGORITHM = "TorchGenerator"

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
    """The generator's state ``(ALGORITHM, seed, counter, 0, 0.0)``, in the
    shape of ``heat_tpu``'s (reference: random.py get_state)."""
    if __seed is None:
        seed()
    return (ALGORITHM, __seed, __counter, 0, 0.0)


def set_state(state: Tuple[str, int, int, int, float]) -> None:
    """Set the generator's state from a 3- or 5-tuple (reference: random.py
    set_state). The algorithm must be the port's own: a ``"Threefry"``
    state of ``heat_tpu`` names another stream."""
    global __seed, __counter
    if not isinstance(state, tuple) or len(state) not in (3, 5):
        raise ValueError("state needs to be a 3- or 5-tuple")
    if state[0] != ALGORITHM:
        raise ValueError(f"algorithm must be {ALGORITHM!r}, got {state[0]!r}")
    __seed = int(state[1])
    __counter = int(state[2])


def _next_generator(numel: int, device: torch.device) -> torch.Generator:
    """A generator for the next draw, seeded from (seed, counter); the
    counter then advances by ``numel``."""
    global __counter
    if __seed is None:
        seed()
    gen = torch.Generator(device=device)
    gen.manual_seed((__seed * 0x9E3779B97F4A7C15 + __counter) % 2**63)
    __counter += int(numel)
    return gen


def _draw(kind: str, shape, dtype, split, device, comm, mean=0.0, std=1.0) -> DNDarray:
    dtype = types.canonical_heat_type(dtype)
    if dtype not in _FLOATS:
        raise ValueError(f"dtype must be a float type, got {dtype}")
    device = sanitize_device(device)
    tdev = device.torch_device
    shape = tuple(shape)
    gen = _next_generator(int(np.prod(shape)) if shape else 1, tdev)
    sampler = torch.randn if kind == "normal" else torch.rand
    data = sampler(shape, generator=gen, dtype=dtype.torch_type(), device=tdev)
    if kind == "normal" and (mean != 0.0 or std != 1.0):
        data = data * std + mean
    return _wrap(data, dtype, split, device, sanitize_comm(comm))


def normal(
    mean: float = 0.0,
    std: float = 1.0,
    shape: Optional[Tuple[int, ...]] = None,
    dtype: Type[types.datatype] = types.float32,
    split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """Normal samples with the given mean and standard deviation
    (reference: random.py normal)."""
    shape = sanitize_shape(shape) if shape is not None else ()
    return _draw("normal", shape, dtype, split, device, comm, float(mean), float(std))


def rand(*args, dtype=types.float32, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Uniform [0, 1) samples of the given shape (reference: random.py rand)."""
    return _draw("uniform", sanitize_shape(args) if args else (), dtype, split, device, comm)


def randn(*args, dtype=types.float32, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples of the given shape (reference: random.py randn)."""
    return _draw("normal", sanitize_shape(args) if args else (), dtype, split, device, comm)


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
    device = sanitize_device(device)
    tdev = device.torch_device
    gen = _next_generator(int(np.prod(shape)) if shape else 1, tdev)
    data = torch.randint(int(low), int(high), shape, generator=gen, dtype=dtype.torch_type(), device=tdev)
    return _wrap(data, dtype, split, device, sanitize_comm(comm))


def randperm(n: int, dtype=types.int64, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Random permutation of arange(n) (reference: random.py randperm); the
    counter advances by n, as in ``heat_tpu``."""
    if not isinstance(n, (int, np.integer)):
        raise TypeError(f"n must be an integer, got {type(n)}")
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    tdev = device.torch_device
    gen = _next_generator(int(n), tdev)
    data = torch.randperm(int(n), generator=gen, device=tdev).to(dtype.torch_type())
    return _wrap(data, dtype, split, device, sanitize_comm(comm))
