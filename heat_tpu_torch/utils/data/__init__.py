"""Data utilities (port of ``heat_tpu.utils.data``): the spherical cluster
data of the clustering benchmark, ``Dataset``/``DataLoader`` with their
shuffles, ``MNISTDataset``, the test matrices of ``matrixgallery`` and the
streaming ``PartialH5Dataset`` (needs h5py)."""

from . import datatools
from . import matrixgallery
from . import mnist
from . import partial_dataset
from . import spherical
from .datatools import DataLoader, Dataset, dataset_ishuffle, dataset_shuffle
from .mnist import MNISTDataset
from .partial_dataset import PartialH5Dataset
from .spherical import create_spherical_dataset
