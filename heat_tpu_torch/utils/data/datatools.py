"""Dataset and DataLoader over arrays split along the sample axis (port of
``heat_tpu.utils.data.datatools``).

A ``Dataset`` holds DNDarrays split along axis 0 (or replicated); a batch
is a slice of the global array, moved to even chunks so that every rank
holds its share of the batch. A shuffle is ``heat_tpu``'s: one
permutation of the samples from ``ht.random.randperm`` (the global stream,
kernel R1 and, on a card, K4's sort), shared by every attribute; a split-0
attribute moves its rows across the ranks in one all-to-all
(``core.random._permute_rows``), a replicated one gathers them locally.
``dataset_ishuffle`` is the same shuffle: torch's launches are already
asynchronous on a card.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Union

import torch

from ...core import random as ht_random
from ...core.dndarray import DNDarray

__all__ = ["DataLoader", "Dataset", "dataset_shuffle", "dataset_ishuffle"]


def _shuffled(array: DNDarray, perm: torch.Tensor) -> DNDarray:
    """``array[perm]`` along axis 0, keeping the split."""
    perm = perm.to(array.larray.device)
    if array.is_distributed() and array.split == 0:
        return ht_random._permute_rows(array, perm)
    return DNDarray(torch.index_select(array.larray, 0, perm), array.shape, array.dtype, array.split, array.device,
                    array.comm)


class Dataset:
    """Samples (and targets) over the ranks (``heat_tpu`` datatools.py:62;
    Heat reference datatools.py:143).

    ``array``: the samples, split along axis 0 or replicated; ``targets``:
    labels of the same leading extent; ``ishuffle``: shuffle with
    ``Ishuffle``; ``test_set``: never shuffled. Indexing returns DNDarray
    slices of the global arrays."""

    def __init__(self, array: DNDarray, targets: Optional[DNDarray] = None, ishuffle: bool = False,
                 test_set: bool = False):
        if not isinstance(array, DNDarray):
            raise TypeError(f"array must be a DNDarray, got {type(array)}")
        if array.split not in (None, 0):
            raise ValueError("Dataset requires the sample axis (0) as split")
        if targets is not None and targets.shape[0] != array.shape[0]:
            raise ValueError(f"targets leading extent {targets.shape[0]} != samples {array.shape[0]}")
        self.htdata = array
        self.httargets = targets
        self.comm = array.comm
        self.ishuffle = bool(ishuffle)
        self.test_set = bool(test_set)

    def __len__(self) -> int:
        return self.htdata.shape[0]

    def __getitem__(self, index) -> Union[DNDarray, tuple]:
        if self.httargets is None:
            return self.htdata[index]
        return self.htdata[index], self.httargets[index]

    def Shuffle(self) -> None:
        """Shuffle the samples over every rank (reference datatools.py:229)."""
        dataset_shuffle(self, self._default_attrs())

    def Ishuffle(self) -> None:
        """The same shuffle (reference :237)."""
        dataset_ishuffle(self, self._default_attrs())

    def _default_attrs(self) -> List[List[str]]:
        attrs = [["htdata", None]]
        if self.httargets is not None:
            attrs.append(["httargets", None])
        return attrs


def dataset_shuffle(dataset, attrs: List[list]) -> None:
    """Shuffle the named DNDarray attributes of ``dataset`` with one shared
    permutation of their samples (``heat_tpu`` datatools.py:127;
    reference :246)."""
    n = getattr(dataset, attrs[0][0]).shape[0]
    perm = ht_random.randperm(n).larray
    for att in attrs:
        arr = getattr(dataset, att[0])
        if arr.shape[0] != n:
            raise ValueError(
                f"attribute {att[0]} has leading extent {arr.shape[0]}, expected {n} (all shuffled attrs must share "
                "the sample axis)"
            )
        setattr(dataset, att[0], _shuffled(arr, perm))


def dataset_ishuffle(dataset, attrs: List[list]) -> None:
    """``dataset_shuffle`` (reference datatools.py:301's non-blocking form:
    the launches on a card are asynchronous already)."""
    dataset_shuffle(dataset, attrs)


def _even(batch: DNDarray) -> DNDarray:
    if batch.is_distributed():
        batch.balance_()
    return batch


class DataLoader:
    """Global batches of a Dataset or DNDarray (``heat_tpu``
    datatools.py:153): ``batch_size`` is the GLOBAL batch (the Heat
    reference's per-rank size times the ranks). Each batch is a DNDarray
    slice moved to even chunks of its rows; ``shuffle`` shuffles the
    dataset before each epoch unless it is a test set."""

    def __init__(self, dataset: Union[Dataset, DNDarray], batch_size: int = 1, drop_last: bool = True,
                 shuffle: bool = False, ishuffle: Optional[bool] = None):
        if isinstance(dataset, DNDarray):
            dataset = Dataset(dataset)
        if not isinstance(dataset, Dataset) and not hasattr(dataset, "__iter__"):
            raise TypeError(f"dataset must be a Dataset or DNDarray, got {type(dataset)}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)
        self.shuffle = bool(shuffle)
        if self.shuffle and not isinstance(dataset, Dataset):
            raise ValueError("shuffle=True requires a Dataset; streaming datasets own their shuffling")
        if ishuffle is not None and isinstance(dataset, Dataset):
            dataset.ishuffle = bool(ishuffle)

    def __len__(self) -> int:
        if not isinstance(self.dataset, Dataset):
            return len(self.dataset)
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        ds = self.dataset
        if not isinstance(ds, Dataset):
            yield from ds
            return
        if self.shuffle and not ds.test_set:
            ds.Shuffle()
        n = len(ds)
        for b in range(len(self)):
            start = b * self.batch_size
            item = ds[start : min(start + self.batch_size, n)]
            yield tuple(_even(t) for t in item) if isinstance(item, tuple) else _even(item)
