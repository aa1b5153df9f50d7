"""Carrying state from ``heat_tpu`` into the port.

``heat_tpu`` holds its arrays as sharded ``jax.Array``s; what carries
across is their logical value, taken with ``DNDarray.numpy()``, with its
split and dtype. The same goes for operators ``heat_tpu`` draws itself,
such as the hSVD sketch operators ``g`` and ``Ω`` (``svdtools.py:308`` and
``:417``): the port's own draws come from ``torch.Generator``s and differ,
so a caller that needs identical factors hands the drawn values across
and passes them to ``svdtools._sketched_uds_both(..., g=)`` /
``_one_view_uds_both(..., g=, omega=)``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np

from .dndarray import DNDarray
from .factories import array

__all__ = ["from_numpy_state"]


def from_numpy_state(
    values: Mapping[str, np.ndarray],
    split: Union[None, int, Mapping[str, Optional[int]]] = None,
    device=None,
) -> Dict[str, DNDarray]:
    """One DNDarray per entry of ``values``, with the entry's dtype (no
    64→32-bit narrowing) on ``device``.

    ``split`` is one split axis for every entry, or a mapping from entry
    name to its split axis (entries it does not name get None)."""
    out = {}
    for name, value in values.items():
        value = np.asarray(value)
        axis = split.get(name) if isinstance(split, Mapping) else split
        out[name] = array(value, dtype=value.dtype, split=axis, device=device)
    return out
