"""(row, column) pair iterators (reference iterator.go:24-194).

The reference threads these through its block-merge and import paths;
our equivalents of those paths are vectorized (set/ndarray based, see
parallel/cluster.py sync and core/fragment.py bulk import), so these
classes exist as the public streaming surface over pair data — parity
with the reference's iterator API for callers that consume fragments
pair-at-a-time without materializing full position arrays.

Iterator protocol: ``seek(row_id, col_id)`` positions at the first pair
>= (row_id, col_id) in (row, col) lexicographic order; ``next_pair()``
returns ``(row_id, col_id, eof)`` with ``eof=True`` once exhausted.
"""

from __future__ import annotations

from typing import Optional

from pilosa_tpu_torch import SHARD_WIDTH


class SliceIterator:
    """Iterate over parallel row/column id lists (reference
    sliceIterator, iterator.go:86-124). Input must already be sorted by
    (row, col)."""

    def __init__(self, row_ids, column_ids) -> None:
        if len(row_ids) != len(column_ids):
            raise ValueError("row/column slice length mismatch")
        self.row_ids = row_ids
        self.column_ids = column_ids
        self.i = 0

    def seek(self, row_id: int, col_id: int) -> None:
        lo, hi = 0, len(self.row_ids)
        while lo < hi:
            mid = (lo + hi) // 2
            pair = (self.row_ids[mid], self.column_ids[mid])
            if pair < (row_id, col_id):
                lo = mid + 1
            else:
                hi = mid
        self.i = lo

    def next_pair(self):
        if self.i >= len(self.row_ids):
            return 0, 0, True
        r, c = self.row_ids[self.i], self.column_ids[self.i]
        self.i += 1
        return int(r), int(c), False

    def __iter__(self):
        while True:
            r, c, eof = self.next_pair()
            if eof:
                return
            yield r, c


class LimitIterator:
    """Cap an iterator at n pairs (reference limitIterator,
    iterator.go:126-151)."""

    def __init__(self, itr, limit: int) -> None:
        self.itr = itr
        self.limit = limit
        self.n = 0

    def seek(self, row_id: int, col_id: int) -> None:
        self.itr.seek(row_id, col_id)

    def next_pair(self):
        if self.n >= self.limit:
            return 0, 0, True
        r, c, eof = self.itr.next_pair()
        if not eof:
            self.n += 1
        return r, c, eof

    def __iter__(self):
        while True:
            r, c, eof = self.next_pair()
            if eof:
                return
            yield r, c


class BufIterator:
    """Single-slot pushback wrapper (reference bufIterator,
    iterator.go:29-84): ``unread()`` pushes the last pair back so the
    next ``next_pair()`` re-returns it; ``peek()`` is next+unread."""

    def __init__(self, itr) -> None:
        self.itr = itr
        self._buf: Optional[tuple] = None
        self._full = False

    def seek(self, row_id: int, col_id: int) -> None:
        self._full = False
        self.itr.seek(row_id, col_id)

    def next_pair(self):
        if self._full:
            self._full = False
            return self._buf
        self._buf = self.itr.next_pair()
        return self._buf

    def peek(self):
        out = self.next_pair()
        self.unread()
        return out

    def unread(self) -> None:
        if self._full:
            raise RuntimeError("BufIterator: buffer full")
        self._full = True

    def __iter__(self):
        while True:
            r, c, eof = self.next_pair()
            if eof:
                return
            yield r, c


class RoaringIterator:
    """Iterate a fragment-layout roaring bitmap as (row, col) pairs
    (reference roaringIterator, iterator.go:153-194): position
    ``pos = row * SHARD_WIDTH + col`` (fragment.go:1935)."""

    def __init__(self, bitmap) -> None:
        # Materialized positions stay sorted, giving (row, col) order
        # for free; fragments cap rows so this is block-merge sized.
        self._pos = bitmap.slice_all()
        self.i = 0

    def seek(self, row_id: int, col_id: int) -> None:
        import numpy as np

        target = row_id * SHARD_WIDTH + col_id
        self.i = int(np.searchsorted(self._pos, target, side="left"))

    def next_pair(self):
        if self.i >= len(self._pos):
            return 0, 0, True
        v = int(self._pos[self.i])
        self.i += 1
        return v // SHARD_WIDTH, v % SHARD_WIDTH, False

    def __iter__(self):
        while True:
            r, c, eof = self.next_pair()
            if eof:
                return
            yield r, c
