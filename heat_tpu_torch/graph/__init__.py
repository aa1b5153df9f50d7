"""Graph algorithms (port of ``heat_tpu.graph``).

``Laplacian`` builds the similarity graph's Laplacian (:mod:`.laplacian`);
on the sparse engine, PageRank is an SpMV fixpoint (:func:`pagerank`) and
:func:`spectral_embedding` feeds the DBCSR Laplacian to the Lanczos
solver, one brick SpMM (kernel K7 on a card) per step;
:func:`pagerank_stream` streams an edge list in host memory through the
card instead."""

from .laplacian import *
from .pagerank import PageRankResult, pagerank, pagerank_stream
from .spectral import spectral_embedding

__all__ = ["Laplacian", "PageRankResult", "pagerank", "pagerank_stream", "spectral_embedding"]
