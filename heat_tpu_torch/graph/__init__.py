"""Graph algorithms on the sparse engine (port of ``heat_tpu.graph``).

So far PageRank as an SpMV fixpoint (:func:`pagerank`), one brick SpMM
(kernel K7 on a card) per iteration. ``heat_tpu``'s ``pagerank_stream``,
``spectral_embedding`` and ``Laplacian`` are still to port (ROADMAP.md,
Queue 1)."""

from .pagerank import PageRankResult, pagerank

__all__ = ["PageRankResult", "pagerank"]
