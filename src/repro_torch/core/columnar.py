"""Columnar block layout for container partitions.

Row-major array objects force every scan to read the whole block even
when the query touches two of twenty columns.  A *colblock* stores each
column as a contiguous typed run starting on a block boundary, so a
reader fetches exactly the columns it needs with ranged block reads
(``ObjectStore.read(oid, start_block, nblocks)``) — the layout-aware
data path SAGE's move-compute-to-data bet needs to pay off (paper §4.1;
the companion paper arXiv:1807.03632 makes the same point).

Wire format (one object):

    [col 0 bytes .. pad to block][col 1 bytes .. pad to block] ...

with the directory in object attrs::

    kind      = "colblock"
    shape     = [rows, ncols]
    dtype     = common/promoted dtype name (compaction merge signature)
    coldtypes = per-column dtype names (columns may differ)
    colblocks = [[start_block, nblocks], ...] per column
    size      = total payload bytes

``ColumnBatch`` is the in-memory shape of a pruned read: a mapping of
*original* column index -> 1-D array, so downstream operators keep
their column numbering without materialising the dropped columns.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

COLBLOCK_KIND = "colblock"
# small power-of-two so per-column padding waste stays bounded while
# ranged reads remain block-granular (store blocks carry per-block CRCs)
DEFAULT_COL_BLOCK = 1 << 12


class ColumnBatch:
    """A pruned columnar read: ``cols`` maps original column index to a
    1-D array of ``rows`` values.  Supports enough of the row-array
    protocol for the fused kernel path; ``to_rows`` rebuilds a full
    (rows, ncols) array and therefore requires every column."""

    def __init__(self, cols: Dict[int, np.ndarray], rows: int, ncols: int):
        self.cols = cols
        self.rows = int(rows)
        self.ncols = int(ncols)

    def col(self, i: int) -> np.ndarray:
        return self.cols[i]

    def __contains__(self, i: int) -> bool:
        return i in self.cols

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.cols.values())

    def to_rows(self) -> np.ndarray:
        """Rebuild the row-major array (promoted dtype when columns
        differ).  Only valid when every column is present."""
        if len(self.cols) != self.ncols:
            missing = sorted(set(range(self.ncols)) - set(self.cols))
            raise ValueError(f"ColumnBatch is pruned (missing columns "
                             f"{missing}); cannot rebuild rows")
        return self.stack(list(range(self.ncols)))

    def stack(self, order: Sequence[int]) -> np.ndarray:
        """Stack the named columns (which must be present) into a
        (rows, len(order)) array — the pruned-scan materialisation."""
        sel = [self.cols[i] for i in order]
        dtype = np.result_type(*[c.dtype for c in sel]) if sel \
            else np.float64
        out = np.empty((self.rows, len(sel)), dtype)
        for j, c in enumerate(sel):
            out[:, j] = c
        return out


def _as_columns(data) -> List[np.ndarray]:
    """Normalise a 2-D row array or a sequence of 1-D columns."""
    if isinstance(data, (list, tuple)):
        cols = [np.ascontiguousarray(np.asarray(c).reshape(-1))
                for c in data]
        if cols and any(c.shape[0] != cols[0].shape[0] for c in cols):
            raise ValueError("columns must share a row count")
        return cols
    arr = np.asarray(data)
    if arr.ndim != 2:
        raise ValueError("colblock wants a 2-D row array or column list")
    return [np.ascontiguousarray(arr[:, i]) for i in range(arr.shape[1])]


def encode_columns(data, block_size: int = DEFAULT_COL_BLOCK
                   ) -> Tuple[bytes, Dict]:
    """Serialise to (payload, attrs).  Each column starts on a block
    boundary so it can be fetched with one ranged read."""
    cols = _as_columns(data)
    rows = cols[0].shape[0] if cols else 0
    payload = bytearray()
    colblocks: List[List[int]] = []
    for c in cols:
        start = len(payload) // block_size
        raw = c.tobytes()
        nblocks = max(1, -(-len(raw) // block_size))
        colblocks.append([start, nblocks])
        payload += raw
        payload += b"\0" * (nblocks * block_size - len(raw))
    common = (np.result_type(*[c.dtype for c in cols]) if cols
              else np.dtype(np.float64))
    attrs = {"kind": COLBLOCK_KIND,
             "shape": [rows, len(cols)],
             "dtype": np.dtype(common).name,
             "coldtypes": [c.dtype.name for c in cols],
             "colblocks": colblocks,
             "size": len(payload)}
    return bytes(payload), attrs


def column_nbytes(attrs: Dict, cols: Optional[Sequence[int]] = None) -> int:
    """Logical bytes of the selected columns (ranged-read accounting:
    what a pruned scan actually pulls, before block-pad rounding)."""
    rows, ncols = attrs["shape"]
    names = attrs["coldtypes"]
    sel = range(ncols) if cols is None else cols
    return sum(rows * np.dtype(names[c]).itemsize for c in sel
               if 0 <= c < ncols)


def read_column(store, oid: str, c: int, attrs: Dict,
                _notify: bool = True) -> np.ndarray:
    """One column via a ranged block read."""
    rows, ncols = attrs["shape"]
    if not 0 <= c < ncols:
        raise IndexError(f"{oid}: column {c} out of range (ncols={ncols})")
    start, nblocks = attrs["colblocks"][c]
    raw = store.read(oid, start, nblocks, _notify=_notify)
    dtype = np.dtype(attrs["coldtypes"][c])
    return np.frombuffer(raw, dtype=dtype)[:rows].copy()
