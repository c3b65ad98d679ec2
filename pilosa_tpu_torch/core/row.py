"""Row — a cross-shard query-result bitmap (L2).

Mirrors the reference's Row/RowSegment (reference row.go:27-35,309-324):
a sorted list of per-shard segments, each a roaring bitmap holding
*absolute* column positions for one shard of 2^20 columns. Set algebra
pairs up segments by shard (reference's merge-iterator, row.go:436-478).
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from pilosa_tpu_torch import SHARD_WIDTH
from pilosa_tpu_torch.roaring import Bitmap


class Row:
    """Query-result bitmap spanning shards."""

    __slots__ = ("segments", "_count", "attrs", "keys")

    def __init__(self, *columns: int) -> None:
        # shard -> Bitmap of absolute column positions within that shard
        self.segments: dict[int, Bitmap] = {}
        self._count: Optional[int] = None
        self.attrs: dict = {}
        self.keys: list[str] = []
        for c in columns:
            self.set_bit(c)

    @classmethod
    def from_segment(cls, shard: int, bitmap: Bitmap) -> "Row":
        r = cls()
        r.segments[shard] = bitmap
        return r

    # -- mutation (used when materialising rows / merging) --

    def set_bit(self, col: int) -> bool:
        shard = col // SHARD_WIDTH
        seg = self.segments.get(shard)
        if seg is None:
            seg = Bitmap()
            self.segments[shard] = seg
        changed = seg.add_no_oplog(col)
        if changed:
            self._count = None
        return changed

    def clear_bit(self, col: int) -> bool:
        shard = col // SHARD_WIDTH
        seg = self.segments.get(shard)
        if seg is None:
            return False
        changed = seg.remove_no_oplog(col)
        if changed:
            self._count = None
        return changed

    def invalidate_count(self) -> None:
        self._count = None

    # -- set algebra (segment-pairwise, reference row.go:87-237) --

    def intersect(self, other: "Row") -> "Row":
        out = Row()
        for shard in self.segments.keys() & other.segments.keys():
            out.segments[shard] = self.segments[shard].intersect(other.segments[shard])
        return out

    def union(self, other: "Row") -> "Row":
        out = Row()
        for shard in self.segments.keys() | other.segments.keys():
            a = self.segments.get(shard)
            b = other.segments.get(shard)
            if a is None:
                out.segments[shard] = b.clone()
            elif b is None:
                out.segments[shard] = a.clone()
            else:
                out.segments[shard] = a.union(b)
        return out

    def difference(self, other: "Row") -> "Row":
        out = Row()
        for shard, a in self.segments.items():
            b = other.segments.get(shard)
            out.segments[shard] = a.clone() if b is None else a.difference(b)
        return out

    def xor(self, other: "Row") -> "Row":
        out = Row()
        for shard in self.segments.keys() | other.segments.keys():
            a = self.segments.get(shard)
            b = other.segments.get(shard)
            if a is None:
                out.segments[shard] = b.clone()
            elif b is None:
                out.segments[shard] = a.clone()
            else:
                out.segments[shard] = a.xor(b)
        return out

    def intersection_count(self, other: "Row") -> int:
        n = 0
        for shard in self.segments.keys() & other.segments.keys():
            n += self.segments[shard].intersection_count(other.segments[shard])
        return n

    # -- accessors --

    def count(self) -> int:
        if self._count is None:
            self._count = sum(s.count() for s in self.segments.values())
        return self._count

    def any(self) -> bool:
        return any(s.any() for s in self.segments.values())

    def columns(self) -> np.ndarray:
        """All set columns as a sorted uint64 array."""
        parts = [
            self.segments[shard].slice_all() for shard in sorted(self.segments)
        ]
        parts = [p for p in parts if p.size]
        if not parts:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(parts)

    def includes_column(self, col: int) -> bool:
        seg = self.segments.get(col // SHARD_WIDTH)
        return seg is not None and seg.contains(col)

    def shard_segment(self, shard: int) -> Optional[Bitmap]:
        return self.segments.get(shard)

    def merge(self, other: "Row") -> None:
        """In-place union used by the executor's cross-shard reduce
        (reference Row.Merge, row.go:251)."""
        for shard, seg in other.segments.items():
            mine = self.segments.get(shard)
            if mine is None:
                self.segments[shard] = seg
            else:
                self.segments[shard] = mine.union(seg)
        self._count = None

    def __eq__(self, other) -> bool:
        if not isinstance(other, Row):
            return NotImplemented
        return self.columns().tolist() == other.columns().tolist()

    def __repr__(self) -> str:
        return f"Row(count={self.count()}, shards={sorted(self.segments)})"


def union_rows(rows: Iterable[Row]) -> Row:
    """n-ary union (reference Union(rows []*Row), row.go:301)."""
    out = Row()
    for r in rows:
        out = out.union(r)
    return out
