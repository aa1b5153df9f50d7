"""Hand-written kernels not tied to one algorithm module, and the build
support for the port's CUDA sources (``csrc/``).

``sort`` holds the local sort engine under ``ht.sort``, ``ht.unique`` and
``ht.topk`` with its radix pair-sort kernel K4 (``csrc/radix_sort.cu``).
"""

from . import sort
from .sort import (
    from_sortable,
    local_sort,
    pair_sort,
    sort_plan,
    to_sortable,
)

__all__ = [
    "sort",
    "from_sortable",
    "local_sort",
    "pair_sort",
    "sort_plan",
    "to_sortable",
]
