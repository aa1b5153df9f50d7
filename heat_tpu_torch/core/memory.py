"""Memory layout utilities.

Port of ``heat_tpu.core.memory`` (Heat reference: heat/core/memory.py,
``copy`` :13, ``sanitize_memory_layout`` :42). Shards are C-ordered torch
tensors, so the layout check validates its argument and returns it.
"""

from __future__ import annotations

from .dndarray import DNDarray
from .sanitation import sanitize_in

__all__ = ["copy", "sanitize_memory_layout"]


def copy(a: DNDarray) -> DNDarray:
    """A copy of ``a`` with its own shards (``heat_tpu`` memory.py:17)."""
    sanitize_in(a)
    return a.copy()


def sanitize_memory_layout(x, order: str = "C"):
    """``x`` in the memory layout ``order`` (``heat_tpu`` memory.py:29):
    the shards are C-ordered, so ``x`` as it is."""
    if order not in ("C", "F", "K"):
        raise ValueError(f"expected order to be 'C', 'F' or 'K', got {order}")
    return x
