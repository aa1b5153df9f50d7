"""Input validation (port of ``heat_tpu.core.sanitation``; Heat reference:
heat/core/sanitation.py, ``sanitize_in`` at :158)."""

from __future__ import annotations

__all__ = ["sanitize_in"]


def sanitize_in(x) -> None:
    """Verify ``x`` is a DNDarray (reference: sanitation.py:158)."""
    from .dndarray import DNDarray

    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
