"""Hand-written kernels not tied to one algorithm module, and the build
support for the port's CUDA sources (``csrc/``).

``sort`` holds the local sort engine under ``ht.sort``, ``ht.unique`` and
``ht.topk`` with its radix pair-sort kernel K4 (``csrc/radix_sort.cu``).
``spmm`` holds the brick engine of the DBCSR format with its SpMM kernel K7
and SDDMM kernel K8 (``csrc/spmm.cu``).
"""

from . import sort, spmm
from .sort import (
    from_sortable,
    local_sort,
    pair_sort,
    sort_plan,
    to_sortable,
)
from .spmm import (
    brick_sddmm,
    brick_spmm,
    sddmm_serviceable,
    spmm_serviceable,
)

__all__ = [
    "sort",
    "spmm",
    "from_sortable",
    "local_sort",
    "pair_sort",
    "sort_plan",
    "to_sortable",
    "brick_sddmm",
    "brick_spmm",
    "sddmm_serviceable",
    "spmm_serviceable",
]
