"""Synthetic spherical cluster data.

Port of ``heat_tpu.utils.data.spherical`` (Heat reference:
heat/utils/data/spherical.py, ``create_spherical_dataset``): four 3-D
clusters at ±offset and ±2·offset on the diagonal, the data of the
reference's clustering benchmark (benchmarks/cb/cluster.py).
"""

from __future__ import annotations

import torch

from ...core import factories, random as ht_random, types
from ...core.dndarray import DNDarray

__all__ = ["create_spherical_dataset"]


def create_spherical_dataset(
    num_samples_cluster: int,
    radius: float = 1.0,
    offset: float = 4.0,
    dtype=types.float32,
    random_state: int = 1,
) -> DNDarray:
    """Four spherical clusters of ``num_samples_cluster`` 3-D points each,
    uniform inside spheres of the given ``radius`` centered at
    (s·offset, s·offset, s·offset) for s = −2, −1, 1, 2, in that order,
    split along axis 0 (each rank keeps its chunk). Reseeds the global stream with ``random_state``,
    as ``heat_tpu`` does, and draws ``heat_tpu``'s values from it."""
    ht_random.seed(random_state)
    dtype = types.canonical_heat_type(dtype)
    n = int(num_samples_cluster)
    parts = []
    for sign in (-2.0, -1.0, 1.0, 2.0):
        # uniform inside the sphere: gaussian direction × U^(1/3) radius
        direction = ht_random.randn(n, 3, dtype=dtype)
        u = ht_random.rand(n, 1, dtype=dtype)
        d_arr = direction.larray
        unit = d_arr / torch.clamp_min(torch.linalg.vector_norm(d_arr, dim=1, keepdim=True), 1e-30)
        parts.append(unit * (u.larray ** (1.0 / 3.0)) * radius + sign * offset)
    data = torch.cat(parts, dim=0)
    return factories.array(data, dtype=dtype, split=0, device=direction.device, comm=direction.comm)
