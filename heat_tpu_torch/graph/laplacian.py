"""Graph Laplacian.

Port of ``heat_tpu.graph.laplacian`` (Heat reference:
heat/graph/laplacian.py, ``Laplacian`` :39-141): the similarity graph
(fully connected or ε-neighbourhood) and its simple or symmetrically
normalized Laplacian.

A similarity matrix split along axis 0 keeps each rank's rows: the
self-loops removed and the ε-mask's diagonal are this rank's band of the
diagonal (its rows at its global row offset), a row's degree is local,
and the normalized Laplacian's ``D^{-1/2}`` of the columns takes one
all-gather of the n degrees. A matrix split along axis 1 is resplit to 0
for the Laplacian and back.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in

__all__ = ["Laplacian"]


def _band(A: DNDarray, arr: torch.Tensor):
    """(rows, columns) of the diagonal entries in this rank's rows of the
    (n, n) ``A`` (``arr`` its shard, split 0 or whole)."""
    offset = 0
    if A.is_distributed():
        offset = int(A.lshape_map[: A.comm.rank, 0].sum())
    rows = torch.arange(arr.shape[0], device=arr.device)
    return rows, rows + offset


def _rows_of(A: DNDarray) -> DNDarray:
    return A.resplit(0) if A.is_distributed() and A.split != 0 else A


def _like(A: DNDarray, L: torch.Tensor, split) -> DNDarray:
    """``L`` (this rank's rows of a result shaped like ``A``) with ``A``'s
    split and map, resplit to ``split``."""
    out = DNDarray(L, A.gshape, A.dtype, A.split, A.device, A.comm, A.lshape_map if A.is_distributed() else None)
    return out.resplit(split) if split != out.split else out


class Laplacian:
    """Graph Laplacian of a similarity structure (reference:
    laplacian.py:14).

    Parameters follow the reference: ``similarity`` is a callable mapping
    the data X to a pairwise similarity matrix S; ``definition`` selects
    ``'simple'`` (L = D − A) or ``'norm_sym'`` (L = I − D^-1/2 A D^-1/2);
    ``mode`` selects ``'fully_connected'`` or ``'eNeighbour'`` adjacency;
    thresholding per ``threshold_key``/``threshold_value``.
    """

    def __init__(
        self,
        similarity: Callable,
        weighted: bool = True,
        definition: str = "norm_sym",
        mode: str = "fully_connected",
        threshold_key: str = "upper",
        threshold_value: float = 1.0,
        neighbours: int = 10,
    ):
        self.similarity_metric = similarity
        self.weighted = weighted
        if definition not in ("simple", "norm_sym"):
            raise NotImplementedError(
                "Only simple and normalized symmetric graph laplacians are supported at the moment"
            )
        if mode not in ("eNeighbour", "fully_connected"):
            raise NotImplementedError(
                "Only eNeighborhood and fully-connected graphs supported at the moment."
            )
        self.definition = definition
        self.mode = mode
        self.epsilon = (threshold_key, threshold_value)
        self.neighbours = neighbours

    def _normalized_symmetric_L(self, A: DNDarray) -> DNDarray:
        """L = I − D^−1/2 A D^−1/2 (reference: laplacian.py:90)."""
        split = A.split
        A = _rows_of(A)
        arr = A.larray
        degree = torch.sum(arr, dim=1)
        zero = torch.zeros((), dtype=degree.dtype, device=degree.device)
        d_inv_sqrt = torch.where(degree > 0, 1.0 / torch.sqrt(degree), zero)
        d_cols = A.comm.allgather(d_inv_sqrt, 0, A.lshape_map[:, 0]) if A.is_distributed() else d_inv_sqrt
        L = -arr * d_inv_sqrt[:, None]
        L *= d_cols[None, :]
        L[_band(A, arr)] += 1
        return _like(A, L, split)

    def _simple_L(self, A: DNDarray) -> DNDarray:
        """L = D − A (reference: laplacian.py:118)."""
        split = A.split
        A = _rows_of(A)
        arr = A.larray
        L = -arr
        L[_band(A, arr)] += torch.sum(arr, dim=1)
        return _like(A, L, split)

    def construct(self, X: DNDarray) -> DNDarray:
        """Similarity graph + Laplacian of the data (reference:
        laplacian.py:126)."""
        sanitize_in(X)
        S = _rows_of(self.similarity_metric(X))
        arr = S.larray.clone()
        band = _band(S, arr)
        # no self-loops
        arr[band] -= S.larray[band]
        if self.mode == "eNeighbour":
            key, value = self.epsilon
            mask = S.larray < value if key == "upper" else S.larray > value
            mask[band] = False
            arr = torch.where(mask, arr if self.weighted else torch.ones_like(arr), torch.zeros((), dtype=arr.dtype))
        A = DNDarray(arr, S.gshape, S.dtype, S.split, S.device, S.comm, S.lshape_map if S.is_distributed() else None)
        if self.definition == "simple":
            return self._simple_L(A)
        return self._normalized_symmetric_L(A)
