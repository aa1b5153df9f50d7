"""Data utilities (port of ``heat_tpu.utils.data``): the spherical cluster
data of the clustering benchmark, ``Dataset``/``DataLoader`` with their
shuffles, and ``MNISTDataset``. ``PartialH5Dataset`` (HDF5) and
``matrixgallery`` are ROADMAP.md Queue 1 items 10 and 11."""

from . import datatools
from . import mnist
from . import spherical
from .datatools import DataLoader, Dataset, dataset_ishuffle, dataset_shuffle
from .mnist import MNISTDataset
from .spherical import create_spherical_dataset
