"""Data utilities (port of ``heat_tpu.utils.data``): so far the spherical
cluster data of the clustering benchmark."""

from . import spherical
from .spherical import create_spherical_dataset
