"""Streaming dataset for HDF5 files larger than memory (port of
``heat_tpu.utils.data.partial_dataset``; Heat reference:
heat/utils/data/partial_dataset.py, ``PartialH5Dataset`` at :32).

``initial_load`` samples are resident at a time: a background thread reads
the next chunk of the file with h5py while the current chunk's batches are
consumed. Each yielded batch is a DNDarray split 0 across the ranks: every
rank reads the chunk and keeps the rows of its part of each batch. Within-
chunk shuffling uses one permutation stream on every rank, seeded from
rank 0 (one broadcast when an iterator starts), so that the ranks' rows
stay parts of the same batch. It needs ``h5py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Union

import numpy as np
import torch

from ...core import factories, types
from ...core.communication import sanitize_comm
from ...core.devices import sanitize_device
from ...core.dndarray import DNDarray

__all__ = ["PartialH5Dataset", "PartialH5DataLoaderIter"]


class PartialH5Dataset:
    """Stream a large HDF5 dataset in chunks (reference
    partial_dataset.py:32).

    Parameters
    ----------
    file : str
        HDF5 file path.
    dataset_names : str or list of str
        Dataset keys to stream jointly (reference: ``dataset_names``).
    batch_size : int
        Global batch size of the yielded DNDarrays.
    initial_load : int
        Samples resident at a time (the reference's ``initial_load``).
    use_gpu_prefetch : bool
        Kept for API parity.
    shuffle_within_chunk : bool
        Permute samples inside each resident chunk (a streaming pass cannot
        shuffle globally without a second copy on disk).
    """

    def __init__(
        self,
        file: str,
        dataset_names: Union[str, List[str]] = "data",
        batch_size: int = 64,
        initial_load: int = 4096,
        use_gpu_prefetch: bool = True,
        shuffle_within_chunk: bool = False,
        dtype=types.float32,
        device=None,
        comm=None,
    ):
        import h5py

        self.file = file
        self.dataset_names = [dataset_names] if isinstance(dataset_names, str) else list(dataset_names)
        self.batch_size = int(batch_size)
        self.initial_load = int(initial_load)
        self.shuffle_within_chunk = bool(shuffle_within_chunk)
        self.dtype = types.canonical_heat_type(dtype)
        self.device = sanitize_device(device)
        self.comm = sanitize_comm(comm)
        with h5py.File(file, "r") as f:
            lengths = {name: f[name].shape[0] for name in self.dataset_names}
            if len(set(lengths.values())) != 1:
                raise ValueError(f"datasets disagree on sample count: {lengths}")
            self.total_size = next(iter(lengths.values()))
            self.shapes = {name: tuple(f[name].shape[1:]) for name in self.dataset_names}

    def __len__(self) -> int:
        return self.total_size // self.batch_size

    def _read_chunk(self, start: int, stop: int) -> dict:
        import h5py

        with h5py.File(self.file, "r") as f:
            return {name: np.asarray(f[name][start:stop]) for name in self.dataset_names}

    def _wrap(self, host: np.ndarray) -> DNDarray:
        """A global batch as a DNDarray split 0: this rank keeps its rows."""
        store = np.float32 if self.dtype is types.bfloat16 else torch.empty(
            (), dtype=self.dtype.torch_type()).numpy().dtype
        return factories.array(host.astype(store), dtype=self.dtype, split=0, device=self.device, comm=self.comm)

    def __iter__(self) -> Iterator:
        return PartialH5DataLoaderIter(self)

    def Shuffle(self) -> None:
        """Within-chunk shuffling toggle (reference partial_dataset.py:157
        notes full shuffling is unsupported for partial datasets too)."""
        self.shuffle_within_chunk = True

    def Ishuffle(self) -> None:
        raise NotImplementedError(
            "PartialH5Dataset does not support global ishuffle (reference "
            "partial_dataset.py:166 raises likewise)"
        )


class PartialH5DataLoaderIter:
    """Iterator with a background prefetch thread (reference
    partial_dataset.py:224): chunk N+1 is read from disk while chunk N's
    batches are consumed."""

    def __init__(self, loader: PartialH5Dataset):
        self._loader = loader
        self._queue: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        if loader.shuffle_within_chunk:  # one permutation stream on every rank, seeded by rank 0
            seed = torch.tensor([int(np.random.default_rng().integers(0, 2**62))], device=loader.device.torch_device)
            self._rng = np.random.default_rng(int(loader.comm.bcast(seed, root=0).item()))
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        self._current: Optional[dict] = None
        self._pos = 0
        self._exhausted = False

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer is gone: an
        abandoned iterator must not leak a thread parked in Queue.put."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        ld = self._loader
        try:
            for start in range(0, ld.total_size, ld.initial_load):
                if self._stop.is_set():
                    return
                stop = min(start + ld.initial_load, ld.total_size)
                if not self._put(("chunk", ld._read_chunk(start, stop))):
                    return
        except Exception as exc:  # surface reader errors at the consumer
            self._put(("error", exc))
        finally:
            self._put(("done", None))

    def close(self) -> None:
        """Stop the prefetch thread and release queued chunks."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        ld = self._loader
        while True:
            if self._current is not None:
                n = next(iter(self._current.values())).shape[0]
                if self._pos + ld.batch_size <= n:
                    start, stop = self._pos, self._pos + ld.batch_size
                    self._pos = stop
                    out = [ld._wrap(arr[start:stop]) for arr in self._current.values()]
                    return out[0] if len(out) == 1 else tuple(out)
                self._current = None  # a tail smaller than a batch is dropped (as in the reference)
            if self._exhausted:
                self.close()
                raise StopIteration
            kind, payload = self._queue.get()
            if kind == "error":
                raise payload
            if kind == "done":
                self._exhausted = True
                continue
            if ld.shuffle_within_chunk:
                prm = self._rng.permutation(next(iter(payload.values())).shape[0])
                payload = {k: v[prm] for k, v in payload.items()}
            self._current = payload
            self._pos = 0
