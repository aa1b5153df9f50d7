"""Data utilities (port of ``heat_tpu.utils.data``): the spherical cluster
data of the clustering benchmark, ``Dataset``/``DataLoader`` with their
shuffles, ``MNISTDataset``, and the test matrices of ``matrixgallery``.
``PartialH5Dataset`` (HDF5) is ROADMAP.md Queue 1 item 10."""

from . import datatools
from . import matrixgallery
from . import mnist
from . import spherical
from .datatools import DataLoader, Dataset, dataset_ishuffle, dataset_shuffle
from .mnist import MNISTDataset
from .spherical import create_spherical_dataset
