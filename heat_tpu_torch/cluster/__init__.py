"""Clustering (port of ``heat_tpu.cluster``): KMeans, KMedians, KMedoids
and Spectral, at world size 1 and on an operand split along axis 0 across
ranks."""

from .kmeans import *
from .kmedians import *
from .kmedoids import *
from .spectral import *
