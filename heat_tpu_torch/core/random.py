"""Pseudo-random number generation.

Port of the draws of ``heat_tpu.core.random`` that this slice needs
(Heat reference: heat/core/random.py): ``seed``, ``randn``, ``rand`` and
``normal``. A global (seed, counter) pair advances by the number of
elements each draw takes, as in ``heat_tpu``; each draw runs on its own
``torch.Generator`` on the target device, seeded from that pair. The
values are torch's Philox stream, not ``heat_tpu``'s Threefry stream:
porting Threefry is ROADMAP.md Queue 1, later.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple, Type

import numpy as np
import torch

from . import types
from .communication import sanitize_comm
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = ["normal", "rand", "randn", "seed"]

__seed: Optional[int] = None
__counter: int = 0

_FLOATS = (types.float16, types.bfloat16, types.float32, types.float64)


def seed(seed: Optional[int] = None) -> None:
    """Seed the generator (reference: random.py seed)."""
    global __seed, __counter
    if seed is None:
        seed = int(time.time() * 1000) % (2**32)
    __seed = int(seed)
    __counter = 0


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
    return DNDarray(data, shape, dtype, sanitize_axis(shape, split), device, sanitize_comm(comm))


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
