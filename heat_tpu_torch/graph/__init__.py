"""Graph algorithms (port of ``heat_tpu.graph``).

``Laplacian`` builds the similarity graph's Laplacian (:mod:`.laplacian`);
on the sparse engine, PageRank is an SpMV fixpoint (:func:`pagerank`) and
:func:`spectral_embedding` feeds the DBCSR Laplacian to the Lanczos
solver, one brick SpMM (kernel K7 on a card) per step. ``heat_tpu``'s
``pagerank_stream`` is still to port (ROADMAP.md Queue 1, item 7)."""

from .laplacian import *
from .pagerank import PageRankResult, pagerank
from .spectral import spectral_embedding

__all__ = ["Laplacian", "PageRankResult", "pagerank", "spectral_embedding"]
