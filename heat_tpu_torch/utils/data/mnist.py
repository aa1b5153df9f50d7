"""MNIST over the ranks (port of ``heat_tpu.utils.data.mnist``).

The standard IDX files (plain or ``.gz``) are read from a local directory
with numpy, as ``heat_tpu`` reads them: no download.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from ...core import factories
from .datatools import Dataset

__all__ = ["MNISTDataset"]

_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _read_idx(path: str) -> np.ndarray:
    """An IDX file (optionally .gz): big-endian magic, dims, then uint8 data."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(root: str, name: str) -> str:
    for cand in (
        os.path.join(root, name),
        os.path.join(root, name + ".gz"),
        os.path.join(root, "MNIST", "raw", name),
        os.path.join(root, "MNIST", "raw", name + ".gz"),
    ):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"MNIST file {name}(.gz) not found under {root} (expected the standard IDX layout, e.g. "
        f"<root>/MNIST/raw/{name}); nothing is downloaded"
    )


class MNISTDataset(Dataset):
    """MNIST as a Dataset (``heat_tpu`` mnist.py:56; Heat reference
    mnist.py:16): images as float32 in [0, 1], labels int32, split along
    the samples (``split`` 0 or None). ``transform`` and
    ``target_transform`` are host callables applied once to the numpy
    arrays."""

    def __init__(self, root: str, train: bool = True, transform=None, target_transform=None, ishuffle: bool = False,
                 test_set: Optional[bool] = None, split: Optional[int] = 0):
        if split not in (None, 0):
            raise ValueError(f"MNISTDataset supports split 0 or None, got {split}")
        img_name, lbl_name = _FILES[bool(train)]
        images = _read_idx(_find(root, img_name)).astype(np.float32) / 255.0
        labels = _read_idx(_find(root, lbl_name)).astype(np.int32)
        if transform is not None:
            images = np.asarray(transform(images))
        if target_transform is not None:
            labels = np.asarray(target_transform(labels))
        super().__init__(
            factories.array(images, split=split), targets=factories.array(labels, split=split), ishuffle=ishuffle,
            test_set=(not train) if test_set is None else bool(test_set),
        )
        self.train = bool(train)
