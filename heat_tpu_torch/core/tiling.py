"""Tile maps over a DNDarray (port of ``heat_tpu.core.tiling``; Heat
reference: heat/core/tiling.py, ``SplitTiles`` :16, ``SquareDiagTiles``
:331).

Both are views of the array: indexing a tile (or a contiguous run of
tiles) returns its values, a tensor on the array's device and the same on
every rank (the global getitem of the tile's slice, its rows gathered from
their owners); assigning to a tile writes through to the array, each rank
writing the part of the tile in its own rows. Every rank calls them with
the same key.

The split axis's tile boundaries come from the array's own ``lshape_map``,
so an uneven layout (a slice, ``redistribute_``) gives tiles that follow
its shards. ``local_get``, ``local_set`` and ``local_to_global`` address
this rank's band of tiles by default (``comm.rank``), the Heat reference's
meaning; ``heat_tpu``, one controller over the mesh, defaults to device 0.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .dndarray import DNDarray
from .manipulations import _starts

__all__ = ["SplitTiles", "SquareDiagTiles"]


def _values(arr: DNDarray, slices) -> torch.Tensor:
    """The values of ``arr[slices]`` on every rank: the global slice, its
    rows gathered from the ranks that hold them."""
    from ._operations import _whole

    return _whole(arr[tuple(slices)])


class SplitTiles:
    """Tiles along every axis, one a rank: along the split axis each rank's
    shard, along the others the chunks the split would give them
    (``heat_tpu`` tiling.py:41; reference :16). ``tile_dimensions[d]`` holds
    the tiles' extents along axis d."""

    def __init__(self, arr: DNDarray):
        if not isinstance(arr, DNDarray):
            raise TypeError(f"arr must be a DNDarray, got {type(arr)}")
        self.__arr = arr
        size = arr.comm.size
        dims = []
        for d in range(arr.ndim):
            if d == arr.split:
                dims.append(arr.lshape_map[:, d].astype(np.int64))
            else:
                dims.append(np.array([arr.comm.chunk(arr.gshape, d, rank=r)[1][d] for r in range(size)],
                                     dtype=np.int64))
        self.__tile_dimensions = dims
        self.__tile_locations = self.set_tile_locations(split=arr.split, tile_dims=dims, arr=arr)

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def lshape_map(self) -> np.ndarray:
        """The (size, ndim) map of shard shapes (``heat_tpu`` tiling.py:71)."""
        return self.__arr.lshape_map

    @property
    def tile_dimensions(self) -> List[np.ndarray]:
        return self.__tile_dimensions

    @property
    def tile_ends_g(self) -> np.ndarray:
        """The global end of every tile along every axis, (ndim, size)
        (``heat_tpu`` tiling.py:80)."""
        return np.stack([np.cumsum(t) for t in self.__tile_dimensions])

    @property
    def tile_locations(self) -> np.ndarray:
        return self.__tile_locations

    @staticmethod
    def set_tile_locations(split: Optional[int], tile_dims: List[np.ndarray], arr: DNDarray) -> np.ndarray:
        """The rank that holds each tile (``heat_tpu`` tiling.py:90): its
        index along the split axis; rank 0 for every tile of an array that
        is not split."""
        shape = tuple(len(t) for t in tile_dims)
        locations = np.zeros(shape, dtype=np.int64)
        if split is None:
            return locations
        idx = [slice(None)] * len(shape)
        for r in range(arr.comm.size):
            idx[split] = r
            locations[tuple(idx)] = r
        return locations

    def _slices(self, key) -> Tuple[slice, ...]:
        """The global slices of a tile key: an int or a contiguous slice of
        tiles an axis, the axes left out whole."""
        starts = [_starts(t) for t in self.__tile_dimensions]
        if not isinstance(key, tuple):
            key = (key,)
        out = []
        for d in range(self.__arr.ndim):
            if d >= len(key):
                out.append(slice(None))
                continue
            k = key[d]
            if isinstance(k, slice):
                lo, hi, step = k.indices(len(self.__tile_dimensions[d]))
                if step != 1:
                    raise ValueError("tile slices must be contiguous (step 1)")
                out.append(slice(int(starts[d][lo]), int(starts[d][max(lo, hi)])))
            else:
                k = int(k)
                out.append(slice(int(starts[d][k]), int(starts[d][k + 1])))
        return tuple(out)

    def __getitem__(self, key) -> torch.Tensor:
        """The values of a tile (or a run of tiles) on every rank (``heat_tpu``
        tiling.py:124 returns them as numpy)."""
        return _values(self.__arr, self._slices(key))

    def __setitem__(self, key, value) -> None:
        """Assign to a tile: a write through to the array (``heat_tpu``
        tiling.py:130; reference :299)."""
        self.__arr[self._slices(key)] = value


class SquareDiagTiles:
    """Square tiles along the diagonal of a 2-D array (``heat_tpu``
    tiling.py:136; reference :331): each rank's band of the split axis cut
    into ``tiles_per_proc`` row tiles, the column boundaries those of the
    rows up to the last column. The addressing of the Heat reference's
    tiled QR."""

    def __init__(self, arr: DNDarray, tiles_per_proc: int = 2):
        if not isinstance(arr, DNDarray):
            raise TypeError(f"arr must be a DNDarray, got {type(arr)}")
        if arr.ndim != 2:
            raise ValueError("Arr must be 2 dimensional")
        if not isinstance(tiles_per_proc, int) or tiles_per_proc < 1:
            raise ValueError(f"tiles_per_proc must be a positive int, got {tiles_per_proc}")
        self.__arr = arr
        m, n = arr.gshape
        split = arr.split if arr.split is not None else 0
        row_per_proc, row_starts = [], [0]
        for c in self._band_extents(arr, split):
            base, rem = divmod(int(c), tiles_per_proc)
            sizes = [s for s in (base + (1 if i < rem else 0) for i in range(tiles_per_proc)) if s > 0]
            row_per_proc.append(len(sizes))
            for s in sizes:
                row_starts.append(row_starts[-1] + s)
        col_bounds = [b for b in row_starts if b <= n]
        if col_bounds[-1] != n:
            col_bounds.append(n)
        self.__split = split
        self.__row_starts = np.array(row_starts, dtype=np.int64)
        self.__col_starts = np.array(col_bounds, dtype=np.int64)
        self.__tile_rows_per_process = row_per_proc
        self.__tile_columns = len(self.__col_starts) - 1
        self.__tile_rows = len(self.__row_starts) - 1

    @staticmethod
    def _band_extents(arr: DNDarray, split: int) -> np.ndarray:
        """Each rank's extent along ``split``: its shard's where the array is
        split there, else the chunk geometry's."""
        if arr.split == split:
            return arr.lshape_map[:, split]
        return arr.comm.lshape_map(arr.gshape, split)[:, split]

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def lshape_map(self) -> np.ndarray:
        """The (size, 2) map of shard shapes (``heat_tpu`` tiling.py:186)."""
        return self.__arr.lshape_map

    @property
    def last_diagonal_process(self) -> int:
        """The rank whose band holds the diagonal's last entry (``heat_tpu``
        tiling.py:191)."""
        m, n = self.__arr.gshape
        tile = int(np.searchsorted(self.__row_starts, min(m, n) - 1, side="right") - 1)
        return int(self.tile_map[min(tile, self.__tile_rows - 1), 0])

    @property
    def tile_columns(self) -> int:
        return self.__tile_columns

    @property
    def tile_columns_per_process(self) -> List[int]:
        """Every rank sees every tile column (``heat_tpu`` tiling.py:206)."""
        return [self.__tile_columns] * self.__arr.comm.size

    @property
    def tile_map(self) -> np.ndarray:
        """(tile_rows, tile_columns): the rank whose band holds each tile
        (``heat_tpu`` tiling.py:212)."""
        owners = np.zeros((self.__tile_rows, self.__tile_columns), dtype=np.int64)
        bands = np.cumsum([0] + self.__tile_rows_per_process)
        for r in range(self.__arr.comm.size):
            owners[bands[r]: bands[r + 1], :] = r
        return owners

    @property
    def tile_rows(self) -> int:
        return self.__tile_rows

    @property
    def tile_rows_per_process(self) -> List[int]:
        return list(self.__tile_rows_per_process)

    @property
    def row_indices(self) -> List[int]:
        return self.__row_starts[:-1].tolist()

    @property
    def col_indices(self) -> List[int]:
        return self.__col_starts[:-1].tolist()

    def get_tile_size(self, key: Tuple[int, int]) -> Tuple[int, int]:
        """(rows, columns) of tile ``key``."""
        i, j = key
        return (int(self.__row_starts[i + 1] - self.__row_starts[i]),
                int(self.__col_starts[j + 1] - self.__col_starts[j]))

    def get_start_stop(self, key: Tuple[int, int]) -> Tuple[int, int, int, int]:
        """(row start, row stop, column start, column stop) of tile ``key``
        (``heat_tpu`` tiling.py:249)."""
        return self._bounds(key)

    def _bounds(self, key) -> Tuple[int, int, int, int]:
        if not isinstance(key, tuple):
            key = (key, slice(None))
        out = []
        for k, starts, count in ((key[0], self.__row_starts, self.__tile_rows),
                                 (key[1], self.__col_starts, self.__tile_columns)):
            if isinstance(k, slice):
                lo, hi, step = k.indices(count)
                if step != 1:
                    raise ValueError("tile slices must be contiguous (step 1)")
                out += [int(starts[lo]), int(starts[max(lo, hi)])]
            else:
                out += [int(starts[int(k)]), int(starts[int(k) + 1])]
        return tuple(out)

    def __getitem__(self, key) -> torch.Tensor:
        """The values of a tile (or a run of tiles) on every rank."""
        rs, re, cs, ce = self._bounds(key)
        return _values(self.__arr, (slice(rs, re), slice(cs, ce)))

    def __setitem__(self, key, value) -> None:
        """Assign to a tile: a write through to the array (``heat_tpu``
        tiling.py:281)."""
        rs, re, cs, ce = self._bounds(key)
        self.__arr[rs:re, cs:ce] = value

    # ------------------------------------------------------------------ #
    # this rank's band                                                   #
    # ------------------------------------------------------------------ #
    def local_to_global(self, key: Tuple[int, int], rank: Optional[int] = None) -> Tuple[int, int]:
        """The global index of tile ``key`` of ``rank``'s band (default this
        rank's; ``heat_tpu`` tiling.py:290, reference :1018)."""
        rank = self.__arr.comm.rank if rank is None else rank
        i, j = key
        return int(np.sum(self.__tile_rows_per_process[:rank])) + int(i), int(j)

    def _local_slices(self, key, rank: Optional[int]):
        """Slices of this rank's shard that hold tile ``key`` of ``rank``'s
        band, which must be this rank's and hold the whole tile."""
        comm = self.__arr.comm
        rank = comm.rank if rank is None else rank
        if rank != comm.rank:
            raise ValueError(f"rank {rank}'s band is not on rank {comm.rank}")
        rs, re, cs, ce = self._bounds(self.local_to_global(key, rank))
        at = [[rs, re], [cs, ce]]
        split = self.__arr.split
        if split is not None and self.__arr.is_distributed():
            lo = int(_starts(self.__arr.lshape_map[:, split])[comm.rank])
            at[split] = [at[split][0] - lo, at[split][1] - lo]
            if at[split][0] < 0 or at[split][1] > self.__arr.lshape[split]:
                raise ValueError(f"tile {key} of rank {rank}'s band is not in its shard")
        return slice(*at[0]), slice(*at[1])

    def local_get(self, key: Tuple[int, int], rank: Optional[int] = None) -> torch.Tensor:
        """Tile ``key`` of this rank's band, a view of its shard (``heat_tpu``
        tiling.py:298; reference :935)."""
        return self.__arr.larray[self._local_slices(key, rank)]

    def local_set(self, key: Tuple[int, int], value, rank: Optional[int] = None) -> None:
        """Write tile ``key`` of this rank's band in its shard (``heat_tpu``
        tiling.py:303; reference :955)."""
        t = self.__arr.larray
        if isinstance(value, DNDarray):
            value = value.larray
        t[self._local_slices(key, rank)] = torch.as_tensor(value, dtype=t.dtype, device=t.device)

    def match_tiles(self, tiles_to_match: "SquareDiagTiles") -> None:
        """Take the row and column boundaries of another tile map, clipped to
        this array's extents, so that the two arrays are addressed tile by
        tile together (``heat_tpu`` tiling.py:308; reference :1080)."""
        if not isinstance(tiles_to_match, SquareDiagTiles):
            raise TypeError(f"tiles_to_match must be SquareDiagTiles, got {type(tiles_to_match)}")
        m, n = self.__arr.gshape
        rows = [b for b in tiles_to_match.__row_starts.tolist() if b <= m]
        if rows[-1] != m:
            rows.append(m)
        cols = [b for b in tiles_to_match.__col_starts.tolist() if b <= n]
        if cols[-1] != n:
            cols.append(n)
        self.__row_starts = np.array(rows, dtype=np.int64)
        self.__col_starts = np.array(cols, dtype=np.int64)
        self.__tile_rows = len(rows) - 1
        self.__tile_columns = len(cols) - 1
        band_ends = np.cumsum(self._band_extents(self.__arr, self.__split))
        self.__tile_rows_per_process = [
            int(np.sum((self.__row_starts[:-1] >= (band_ends[r - 1] if r else 0))
                       & (self.__row_starts[:-1] < band_ends[r])))
            for r in range(self.__arr.comm.size)
        ]
