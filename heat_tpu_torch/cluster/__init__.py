"""Clustering (port of ``heat_tpu.cluster``): KMeans, KMedians and
KMedoids at world size 1. ``heat_tpu``'s ``Spectral`` is not ported yet
(ROADMAP.md Queue 1)."""

from .kmeans import *
from .kmedians import *
from .kmedoids import *
