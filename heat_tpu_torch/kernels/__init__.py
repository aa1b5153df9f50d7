"""Hand-written kernels not tied to one algorithm module, and the build
support for the port's CUDA sources (``csrc/``).

``sort`` holds the local sort engine under ``ht.sort``, ``ht.unique`` and
``ht.topk`` with its radix sort kernel K4 (``csrc/radix_sort.cu``): the
pair sort of u32 words and the fused sort of float32 and int32 values.
``spmm`` holds the brick engine of the DBCSR format with its SpMM kernel K7
and SDDMM kernel K8 (``csrc/spmm.cu``). ``attention`` holds exact softmax
attention with its flash-attention forward kernel K9 (``csrc/attention.cu``)
under ``ht.nn``. ``relayout`` holds the packed pivot's pack and unpack
copies K5 and K6 (``csrc/relayout.cu``) under ``ht.redistribution``.
``threefry`` holds kernel R1 (``csrc/threefry.cu``), which draws
``heat_tpu``'s Threefry-2x32 stream on a card under ``ht.random`` and every
seeded draw of the port (the hSVD sketch operators, k-means++ seeding,
module inits) through its one entry point ``threefry.draw`` (and
``threefry.shuffle`` for permutations), one launch a draw of this rank's
chunk; it replaces no Pallas kernel. The launch counts stay on their modules (for example
``attention.ATTENTION_LAUNCHES``): a name imported here would not follow them.
"""

from . import attention, relayout, sort, spmm, threefry
from .attention import (
    attention_serviceable,
    flash_attention,
    flash_attention_plain,
)
from .relayout import (
    lane_fill,
    pack_rows,
    unpack_rows,
)
from .sort import (
    block_sort,
    from_sortable,
    fused_sort,
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
    "attention",
    "relayout",
    "sort",
    "spmm",
    "threefry",
    "block_sort",
    "from_sortable",
    "fused_sort",
    "local_sort",
    "pair_sort",
    "sort_plan",
    "to_sortable",
    "brick_sddmm",
    "brick_spmm",
    "sddmm_serviceable",
    "spmm_serviceable",
    "attention_serviceable",
    "flash_attention",
    "flash_attention_plain",
    "lane_fill",
    "pack_rows",
    "unpack_rows",
]
