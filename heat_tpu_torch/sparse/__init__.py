"""Sparse layer of heat_tpu_torch (port of ``heat_tpu.sparse``).

Parity with the Heat reference's ``heat/sparse``: ``DCSR_matrix``,
``sparse_csr_matrix``, ``sparse_add``/``sparse_mul``, ``to_dense``/
``to_sparse``. Beyond it, as in ``heat_tpu``: ``matmul`` (SpMV/SpMM), the
block-CSR format ``DBCSR_matrix`` with fixed (8, 128) bricks
(``sparse_dbcsr_matrix``/``to_dbcsr``), and ``sddmm`` on the brick format.
The brick products run the hand-written kernels K7 and K8 on a card
(kernels/spmm.py)."""

from .dcsr_matrix import DCSR_matrix
from .dbcsr_matrix import BRICK_SHAPE, DBCSR_matrix, sparse_dbcsr_matrix, to_dbcsr
from .factories import sparse_csr_matrix
from .arithmetics import add, mul
from .arithmetics import add as sparse_add, mul as sparse_mul
from .manipulations import to_dense, to_sparse
from .linalg import matmul, sddmm

__all__ = [
    "BRICK_SHAPE",
    "DBCSR_matrix",
    "DCSR_matrix",
    "sparse_csr_matrix",
    "sparse_dbcsr_matrix",
    "to_dbcsr",
    "add",
    "mul",
    "sparse_add",
    "sparse_mul",
    "to_dense",
    "to_sparse",
    "matmul",
    "sddmm",
]
