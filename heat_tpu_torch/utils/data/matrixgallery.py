"""Test and benchmark matrices (port of
``heat_tpu.utils.data.matrixgallery``; Heat reference:
heat/utils/data/matrixgallery.py): ``hermitian``, ``parter``,
``random_orthogonal``, ``random_known_singularvalues`` and
``random_known_rank``.

They draw through ``ht.random`` (``heat_tpu``'s Threefry stream, kernel R1
on a card), so under one seed they are ``heat_tpu``'s matrices, up to the
column signs that ``qr`` chooses. Each rank computes its own shard.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ...core import factories, random as ht_random, types
from ...core.dndarray import DNDarray
from ...core.linalg import matmul, qr, transpose
from ...core.stride_tricks import sanitize_axis

__all__ = [
    "hermitian",
    "parter",
    "random_orthogonal",
    "random_known_singularvalues",
    "random_known_rank",
]


def hermitian(n: int, dtype=types.complex64, split=None, device=None, comm=None) -> DNDarray:
    """A random hermitian n x n matrix, symmetric for a real ``dtype``:
    (A + Aᴴ) / 2 of a standard-normal A (complex: two draws, the real and
    the imaginary part; ``heat_tpu`` matrixgallery.py:30)."""
    dtype = types.canonical_heat_type(dtype)
    if types.heat_type_is_complexfloating(dtype):
        real = ht_random.randn(n, n, split=split, device=device, comm=comm)
        imag = ht_random.randn(n, n, split=split, device=device, comm=comm)
        a = DNDarray(torch.complex(real.larray, imag.larray).to(dtype.torch_type()), (n, n), dtype, real.split,
                     real.device, real.comm, real.lshape_map)
    else:
        a = ht_random.randn(n, n, split=split, device=device, comm=comm, dtype=dtype)
    return (a + transpose(a).conj()) / 2


def parter(n: int, split=None, device=None, comm=None, dtype=types.float32) -> DNDarray:
    """The Parter matrix, the Cauchy matrix 1 / (i − j + 1/2) in float32,
    whose singular values cluster near π (``heat_tpu``
    matrixgallery.py:60): each rank computes its chunk."""
    dtype = types.canonical_heat_type(dtype)
    split = sanitize_axis((n, n), split)
    ii = factories.arange(n, dtype=types.float32, split=None, device=device, comm=comm)
    start, lshape, _ = ii.comm.chunk((n, n), split)
    rows, cols = ii.larray, ii.larray
    if split == 0:
        rows = rows[start: start + lshape[0]]
    elif split == 1:
        cols = cols[start: start + lshape[1]]
    local = (1.0 / (rows[:, None] - cols[None, :] + 0.5)).to(dtype.torch_type())
    return DNDarray(local, (n, n), dtype, split, ii.device, ii.comm)


def random_orthogonal(m: int, n: int, split=None, device=None, comm=None, dtype=types.float32) -> DNDarray:
    """A random m x n matrix with orthonormal columns, m ≥ n: Q of a
    standard-normal draw (``heat_tpu`` matrixgallery.py:76)."""
    if m < n:
        raise ValueError(f"m >= n required, got {m} < {n}")
    a = ht_random.randn(m, n, dtype=types.canonical_heat_type(dtype), split=split, device=device, comm=comm)
    q, _ = qr(a)
    return q


def random_known_singularvalues(
    m: int, n: int, singular_values, split=None, device=None, comm=None, dtype=types.float32
) -> Tuple[DNDarray, Tuple[DNDarray, DNDarray, DNDarray]]:
    """A random m x n matrix with the given singular values: A = U·diag(s)·Vᵀ
    of two ``random_orthogonal`` factors (``heat_tpu``
    matrixgallery.py:86). Returns (A, (U, s, V)), A split ``split``."""
    if isinstance(singular_values, DNDarray):
        s = singular_values.resplit(None) if singular_values.is_distributed() else singular_values
    else:
        s = factories.array(np.asarray(singular_values), device=device, comm=comm)
    k = s.shape[0]
    if k > min(m, n):
        raise ValueError(f"number of singular values {k} exceeds min(m, n)={min(m, n)}")
    U = random_orthogonal(m, k, split=split, device=device, comm=comm, dtype=dtype)
    V = random_orthogonal(n, k, split=split, device=device, comm=comm, dtype=dtype)
    A = matmul(U * s, transpose(V))
    split = sanitize_axis((m, n), split)
    if A.split != split:
        A = A.resplit(split)
    dtype = types.canonical_heat_type(dtype)
    if A.dtype is not dtype:
        A = A.astype(dtype)
    return A, (U, factories.array(s.numpy(), device=device, comm=comm), V)


def random_known_rank(
    m: int,
    n: int,
    r: int,
    quantile_function: Callable = lambda x: -np.log(x),
    split=None,
    device=None,
    comm=None,
    dtype=types.float32,
) -> Tuple[DNDarray, Tuple[DNDarray, DNDarray, DNDarray]]:
    """A random m x n matrix of rank r whose singular values are
    ``quantile_function`` of r uniform draws from ``ht.random`` taken in
    descending order (with the default −log, the values ascend; ``heat_tpu``
    matrixgallery.py:115)."""
    if r > min(m, n):
        raise ValueError(f"rank {r} exceeds min(m, n)={min(m, n)}")
    u = np.sort(np.asarray(ht_random.rand(r, device=device, comm=comm).numpy()))[::-1]
    s = np.asarray([quantile_function(x) for x in u], dtype=np.float32)
    return random_known_singularvalues(m, n, s, split=split, device=device, comm=comm, dtype=dtype)
