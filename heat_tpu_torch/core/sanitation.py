"""Input validation (port of ``heat_tpu.core.sanitation``; Heat reference:
heat/core/sanitation.py, ``sanitize_in`` at :158, ``sanitize_out`` at :254)."""

from __future__ import annotations

__all__ = ["sanitize_in", "sanitize_out"]


def sanitize_in(x) -> None:
    """Verify ``x`` is a DNDarray (reference: sanitation.py:158)."""
    from .dndarray import DNDarray

    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")


def sanitize_out(out, output_shape) -> None:
    """Verify that ``out`` is a DNDarray of the output's shape (``heat_tpu``
    sanitation.py:95)."""
    from .dndarray import DNDarray

    if not isinstance(out, DNDarray):
        raise TypeError(f"expected out buffer to be a DNDarray, but was {type(out)}")
    if tuple(out.shape) != tuple(output_shape):
        raise ValueError(f"Expecting output buffer of shape {tuple(output_shape)}, got {tuple(out.shape)}")
