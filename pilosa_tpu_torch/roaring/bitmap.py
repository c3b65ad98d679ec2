"""64-bit roaring bitmap — the CPU source-of-truth bitmap engine.

Re-implements the semantics of the reference's roaring package
(reference roaring/roaring.go): a bitmap over 64-bit positions stored as
containers keyed by the high 48 bits, each container holding up to 2^16
bit positions in one of three forms:

  * array  — sorted uint16 positions (small cardinality)
  * bitmap — 1024 x uint64 packed words (dense)
  * run    — RLE [start, last] inclusive intervals (clustered)

Unlike the reference's per-type-pair Go loops (reference
roaring/roaring.go:1951+), operations here are vectorised with numpy:
mixed-form operands are normalised to packed words and combined with
word-wise boolean ops + popcount — the same layout the TPU kernels in
``pilosa_tpu_torch.ops`` use, so the CPU engine doubles as the oracle for the
device path.

Serialization (``write_to`` / ``unmarshal_binary``) implements the
reference's file format byte-for-byte (magic 12348, 12-byte descriptive
headers, 4-byte offsets, container blobs, trailing op log — reference
roaring/roaring.go:543-705) so data produced by the reference Go binary
can be ingested directly and vice versa.
"""

from __future__ import annotations

import struct
from typing import Callable, Iterator, Optional

import numpy as np

# -- constants (reference roaring/roaring.go:29-64) --------------------------

MAGIC_NUMBER = 12348
STORAGE_VERSION = 0
COOKIE = MAGIC_NUMBER + (STORAGE_VERSION << 16)
HEADER_BASE_SIZE = 8
RUN_COUNT_HEADER_SIZE = 2
INTERVAL16_SIZE = 4
BITMAP_N = (1 << 16) // 64  # 1024 words per container

CONTAINER_ARRAY = 1
CONTAINER_BITMAP = 2
CONTAINER_RUN = 3

ARRAY_MAX_SIZE = 4096
RUN_MAX_SIZE = 2048  # beyond this many runs a bitmap container is smaller

MAX_CONTAINER_VAL = 0xFFFF

_BIT = np.uint64(1)
_WORD_INDEX = np.uint64(6)
_WORD_MASK = np.uint64(63)


def highbits(v: int) -> int:
    return v >> 16


def lowbits(v: int) -> int:
    return v & 0xFFFF


# -- container ---------------------------------------------------------------


class Container:
    """One 2^16-position block, in array / bitmap / run form.

    ``n`` (cardinality) is kept eagerly, matching the reference's
    ``container.n`` bookkeeping.
    """

    __slots__ = ("typ", "array", "bitmap", "runs", "n")

    def __init__(self) -> None:
        self.typ = CONTAINER_ARRAY
        self.array: np.ndarray = _EMPTY_U16
        self.bitmap: Optional[np.ndarray] = None
        self.runs: Optional[np.ndarray] = None  # shape (k, 2): [start, last]
        self.n = 0

    # -- constructors --

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "Container":
        c = cls()
        c.typ = CONTAINER_ARRAY
        c.array = np.ascontiguousarray(arr, dtype=np.uint16)
        c.n = int(arr.size)
        return c

    @classmethod
    def from_words(cls, words: np.ndarray, n: Optional[int] = None) -> "Container":
        """Build from 1024 packed uint64 words, choosing array vs bitmap form."""
        if n is None:
            n = int(np.bitwise_count(words).sum())
        c = cls()
        if n <= ARRAY_MAX_SIZE:
            c.typ = CONTAINER_ARRAY
            c.array = words_to_positions(words)
            c.n = n
        else:
            c.typ = CONTAINER_BITMAP
            c.bitmap = words
            c.n = n
        return c

    @classmethod
    def from_runs(cls, runs: np.ndarray) -> "Container":
        c = cls()
        c.typ = CONTAINER_RUN
        c.runs = np.ascontiguousarray(runs, dtype=np.uint16).reshape(-1, 2)
        if c.runs.size:
            c.n = int(
                (c.runs[:, 1].astype(np.int64) - c.runs[:, 0].astype(np.int64) + 1).sum()
            )
        else:
            c.n = 0
        return c

    # -- form conversion --

    def words(self) -> np.ndarray:
        """Packed uint64[1024] view of this container (copy for array/run)."""
        if self.typ == CONTAINER_BITMAP:
            return self.bitmap
        if self.typ == CONTAINER_ARRAY:
            return positions_to_words(self.array)
        # run form
        w = np.zeros(BITMAP_N, dtype=np.uint64)
        if self.runs is not None and self.runs.size:
            mask = np.zeros(1 << 16, dtype=bool)
            for s, l in self.runs:
                mask[int(s) : int(l) + 1] = True
            w = np.packbits(mask, bitorder="little").view(np.uint64).copy()
        return w

    def positions(self) -> np.ndarray:
        """Sorted uint16 positions."""
        if self.typ == CONTAINER_ARRAY:
            return self.array
        if self.typ == CONTAINER_RUN:
            if self.runs is None or not self.runs.size:
                return _EMPTY_U16
            parts = [
                np.arange(int(s), int(l) + 1, dtype=np.uint16) for s, l in self.runs
            ]
            return np.concatenate(parts) if parts else _EMPTY_U16
        return words_to_positions(self.bitmap)

    def to_bitmap_form(self) -> None:
        if self.typ != CONTAINER_BITMAP:
            w = self.words()
            self.bitmap = w.copy() if self.typ == CONTAINER_BITMAP else w
            self.typ = CONTAINER_BITMAP
            self.array = _EMPTY_U16
            self.runs = None

    def run_count(self) -> int:
        """Number of RLE runs in this container (for Optimize heuristics)."""
        if self.typ == CONTAINER_RUN:
            return 0 if self.runs is None else int(self.runs.shape[0])
        p = self.positions()
        if not p.size:
            return 0
        return int((np.diff(p.astype(np.int64)) > 1).sum()) + 1

    def optimize(self) -> None:
        """Convert to the smallest serialized form (reference Optimize:499)."""
        if self.n == 0:
            return
        runs = self.run_count()
        run_size = RUN_COUNT_HEADER_SIZE + runs * INTERVAL16_SIZE
        array_size = 2 * self.n
        bitmap_size = 8 * BITMAP_N
        best = min(run_size, array_size, bitmap_size)
        if best == run_size and self.typ != CONTAINER_RUN:
            p = self.positions().astype(np.int64)
            breaks = np.nonzero(np.diff(p) > 1)[0]
            starts = np.concatenate(([0], breaks + 1))
            ends = np.concatenate((breaks, [p.size - 1]))
            rr = np.empty((starts.size, 2), dtype=np.uint16)
            rr[:, 0] = p[starts]
            rr[:, 1] = p[ends]
            self.runs = rr
            self.typ = CONTAINER_RUN
            self.array = _EMPTY_U16
            self.bitmap = None
        elif best == array_size and self.typ != CONTAINER_ARRAY:
            self.array = self.positions()
            self.typ = CONTAINER_ARRAY
            self.bitmap = None
            self.runs = None
        elif best == bitmap_size and self.typ != CONTAINER_BITMAP:
            self.to_bitmap_form()

    # -- point ops --

    def contains(self, v: int) -> bool:
        if self.typ == CONTAINER_ARRAY:
            i = int(np.searchsorted(self.array, np.uint16(v)))
            return i < self.array.size and int(self.array[i]) == v
        if self.typ == CONTAINER_BITMAP:
            return bool((int(self.bitmap[v >> 6]) >> (v & 63)) & 1)
        if self.runs is None or not self.runs.size:
            return False
        i = int(np.searchsorted(self.runs[:, 0], np.uint16(v), side="right")) - 1
        return i >= 0 and int(self.runs[i, 0]) <= v <= int(self.runs[i, 1])

    def add(self, v: int) -> bool:
        """Set bit v; returns True if it changed. May change form."""
        if self.contains(v):
            return False
        if self.typ == CONTAINER_ARRAY:
            if self.n >= ARRAY_MAX_SIZE:
                self.to_bitmap_form()
                self.bitmap[v >> 6] |= _BIT << np.uint64(v & 63)
            else:
                i = int(np.searchsorted(self.array, np.uint16(v)))
                self.array = np.insert(self.array, i, np.uint16(v))
        elif self.typ == CONTAINER_BITMAP:
            self.bitmap[v >> 6] |= _BIT << np.uint64(v & 63)
        else:
            self.to_bitmap_form()
            self.bitmap[v >> 6] |= _BIT << np.uint64(v & 63)
        self.n += 1
        return True

    def remove(self, v: int) -> bool:
        if not self.contains(v):
            return False
        if self.typ == CONTAINER_ARRAY:
            i = int(np.searchsorted(self.array, np.uint16(v)))
            self.array = np.delete(self.array, i)
        elif self.typ == CONTAINER_BITMAP:
            self.bitmap[v >> 6] &= ~(_BIT << np.uint64(v & 63))
        else:
            self.to_bitmap_form()
            self.bitmap[v >> 6] &= ~(_BIT << np.uint64(v & 63))
        self.n -= 1
        return True

    # -- serialization (container blob only) --

    def size(self) -> int:
        """Serialized byte size (reference container.size)."""
        if self.typ == CONTAINER_ARRAY:
            return 2 * self.n
        if self.typ == CONTAINER_RUN:
            k = 0 if self.runs is None else self.runs.shape[0]
            return RUN_COUNT_HEADER_SIZE + k * INTERVAL16_SIZE
        return 8 * BITMAP_N

    def write_blob(self) -> bytes:
        if self.typ == CONTAINER_ARRAY:
            return self.array.astype("<u2").tobytes()
        if self.typ == CONTAINER_RUN:
            k = 0 if self.runs is None else self.runs.shape[0]
            return struct.pack("<H", k) + self.runs.astype("<u2").tobytes()
        return self.bitmap.astype("<u8").tobytes()

    def clone(self) -> "Container":
        c = Container()
        c.typ = self.typ
        c.n = self.n
        c.array = self.array.copy() if self.array is not None else _EMPTY_U16
        c.bitmap = None if self.bitmap is None else self.bitmap.copy()
        c.runs = None if self.runs is None else self.runs.copy()
        return c


_EMPTY_U16 = np.empty(0, dtype=np.uint16)


def words_to_positions(words: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint16)


def positions_to_words(pos: np.ndarray) -> np.ndarray:
    """pos must be sorted (the array-container invariant). Grouped
    bitwise_or.reduceat beats ufunc.at by ~10x — this is the staging
    expansion's inner loop."""
    w = np.zeros(BITMAP_N, dtype=np.uint64)
    if pos.size:
        a = pos.astype(np.uint64)
        wi = (a >> _WORD_INDEX).astype(np.int64)
        vals = _BIT << (a & _WORD_MASK)
        uniq, starts = np.unique(wi, return_index=True)
        w[uniq] = np.bitwise_or.reduceat(vals, starts)
    return w


# -- bitmap ------------------------------------------------------------------


# Swappable container-store seam (the reference flips SliceContainers →
# enterprise B+tree by reassigning roaring.NewFileBitmap under the
# `enterprise` build tag, enterprise/enterprise.go:30-32). The default
# dict store wins for typical container counts; swap in
# pilosa_tpu_torch.roaring.btree.BTreeContainers for ordered-scan-heavy
# bitmaps with millions of containers.
_default_container_store = dict


def set_default_container_store(factory) -> None:
    global _default_container_store
    _default_container_store = factory


def get_default_container_store():
    return _default_container_store


class Bitmap:
    """64-bit roaring bitmap (reference roaring.Bitmap).

    Containers live in a mapping keyed by the high 48 bits (dict by
    default — the reference's SliceContainers analog; see
    set_default_container_store for the B+tree alternative).
    """

    __slots__ = ("containers", "op_writer", "op_n")

    def __init__(self, *bits: int) -> None:
        self.containers = _default_container_store()
        self.op_writer = None  # file-like; when set, add/remove append ops
        self.op_n = 0
        for b in bits:
            self.add_no_oplog(b)

    @classmethod
    def from_sorted(cls, values: np.ndarray) -> "Bitmap":
        """Bulk-build from a sorted uint64 array of positions."""
        b = cls()
        values = np.asarray(values, dtype=np.uint64)
        if not values.size:
            return b
        keys = (values >> np.uint64(16)).astype(np.uint64)
        split = np.nonzero(np.diff(keys))[0] + 1
        starts = np.concatenate(([0], split))
        ends = np.concatenate((split, [values.size]))
        for s, e in zip(starts, ends):
            key = int(keys[s])
            low = (values[s:e] & np.uint64(0xFFFF)).astype(np.uint16)
            if low.size > ARRAY_MAX_SIZE:
                b.containers[key] = Container.from_words(
                    positions_to_words(low), n=int(low.size)
                )
            else:
                b.containers[key] = Container.from_array(low)
        return b

    # -- bookkeeping --

    def _get_or_create(self, key: int) -> Container:
        store = self.containers
        mutate = getattr(store, "mutate", None)
        c = mutate(key) if mutate is not None else store.get(key)
        if c is None:
            c = Container()
            store[key] = c
        return c

    def sorted_keys(self) -> list[int]:
        return list(self._iter_keys_sorted())

    def _iter_keys_sorted(self, lo: Optional[int] = None, hi: Optional[int] = None):
        """Sorted key iteration over [lo, hi); O(log N + touched) on
        range-indexed stores (mmapstore), O(N log N) on plain dicts."""
        store = self.containers
        f = getattr(store, "iter_keys", None)
        if f is not None:
            yield from f(lo, hi)
            return
        for k in sorted(store):
            if lo is not None and k < lo:
                continue
            if hi is not None and k >= hi:
                break
            yield k

    def max_key(self) -> Optional[int]:
        """Largest container key, or None when empty."""
        f = getattr(self.containers, "max_key", None)
        if f is not None:
            return f()
        return max(self.containers) if self.containers else None

    def keys_and_counts(self) -> tuple[np.ndarray, np.ndarray]:
        """(sorted u64 container keys, u32 cardinalities) — the bulk
        occupancy index used for cache recounts and sparse staging."""
        f = getattr(self.containers, "keys_and_counts", None)
        if f is not None:
            return f()
        keys = sorted(self.containers)
        ks = np.fromiter(keys, dtype=np.uint64, count=len(keys))
        ns = np.fromiter(
            (self.containers[k].n for k in keys), dtype=np.uint32, count=len(keys)
        )
        return ks, ns

    def occupancy(self) -> tuple[np.ndarray, np.ndarray]:
        """(sorted container keys, exclusive prefix sum of counts);
        cached on mmap stores, computed on the fly for dict stores."""
        f = getattr(self.containers, "occupancy", None)
        if f is not None:
            return f()
        keys, ns = self.keys_and_counts()
        return keys, np.concatenate(([0], np.cumsum(ns, dtype=np.int64)))

    # -- point ops --

    def add_no_oplog(self, v: int) -> bool:
        return self._get_or_create(highbits(v)).add(lowbits(v))

    def remove_no_oplog(self, v: int) -> bool:
        store = self.containers
        mutate = getattr(store, "mutate", None)
        c = mutate(highbits(v)) if mutate is not None else store.get(highbits(v))
        if c is None:
            return False
        changed = c.remove(lowbits(v))
        if c.n == 0:
            del store[highbits(v)]
        return changed

    def add(self, *values: int) -> bool:
        """Set bits; returns True if any changed. Appends to the op log
        (reference Bitmap.Add / writeOp, roaring.go:146-165,707)."""
        changed = False
        for v in values:
            if self.add_no_oplog(v):
                changed = True
                self._write_op(OP_ADD, v)
        return changed

    def remove(self, *values: int) -> bool:
        changed = False
        for v in values:
            if self.remove_no_oplog(v):
                changed = True
                self._write_op(OP_REMOVE, v)
        return changed

    def contains(self, v: int) -> bool:
        c = self.containers.get(highbits(v))
        return c is not None and c.contains(lowbits(v))

    # -- counting --

    def count(self) -> int:
        f = getattr(self.containers, "total_count", None)
        if f is not None:
            return f()
        return sum(c.n for c in self.containers.values())

    def count_range(self, start: int, end: int) -> int:
        """Count of set bits in [start, end) (reference CountRange:228)."""
        if end <= start:
            return 0
        n = 0
        hi0, lo0 = highbits(start), lowbits(start)
        hi1, lo1 = highbits(end), lowbits(end)
        for key in self._iter_keys_sorted(hi0, hi1 + 1):
            c = self.containers[key]
            if hi0 == hi1:
                if key == hi0:
                    p = c.positions()
                    n += int(
                        np.searchsorted(p, lo1, side="left")
                        - np.searchsorted(p, lo0, side="left")
                    )
                continue
            if key == hi0 and lo0 > 0:
                p = c.positions()
                n += int(p.size - np.searchsorted(p, lo0, side="left"))
            elif key == hi1:
                if lo1 > 0:
                    p = c.positions()
                    n += int(np.searchsorted(p, lo1, side="left"))
            else:
                n += c.n
        return n

    # -- materialization --

    def slice_all(self) -> np.ndarray:
        """All set positions as a sorted uint64 array."""
        out = []
        for key in self.sorted_keys():
            c = self.containers[key]
            if c.n:
                out.append(
                    (np.uint64(key << 16) + c.positions().astype(np.uint64))
                )
        if not out:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(out)

    def slice_range(self, start: int, end: int) -> np.ndarray:
        """Set positions in [start, end) — touches only in-range
        containers (the anti-entropy block_data path on tall bitmaps)."""
        if end <= start:
            return np.empty(0, dtype=np.uint64)
        hi0, hi1 = highbits(start), highbits(end - 1) + 1
        out = []
        for key in self._iter_keys_sorted(hi0, hi1):
            c = self.containers[key]
            if not c.n:
                continue
            p = (np.uint64(key << 16) + c.positions().astype(np.uint64))
            if key == hi0 or key == hi1 - 1:
                p = p[(p >= np.uint64(start)) & (p < np.uint64(end))]
            if p.size:
                out.append(p)
        if not out:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(out)

    def for_each(self, fn: Callable[[int], None]) -> None:
        for v in self.slice_all():
            fn(int(v))

    def __iter__(self) -> Iterator[int]:
        return iter(int(v) for v in self.slice_all())

    # -- set algebra (container-parallel, vectorised) --

    def intersect(self, other: "Bitmap") -> "Bitmap":
        out = Bitmap()
        keys = self.containers.keys() & other.containers.keys()
        for key in keys:
            a, b = self.containers[key], other.containers[key]
            c = _intersect_containers(a, b)
            if c.n:
                out.containers[key] = c
        return out

    def union(self, other: "Bitmap") -> "Bitmap":
        out = Bitmap()
        for key in self.containers.keys() | other.containers.keys():
            a = self.containers.get(key)
            b = other.containers.get(key)
            if a is None:
                out.containers[key] = b.clone()
            elif b is None:
                out.containers[key] = a.clone()
            else:
                c = _union_containers(a, b)
                if c.n:
                    out.containers[key] = c
        return out

    def difference(self, other: "Bitmap") -> "Bitmap":
        out = Bitmap()
        for key, a in self.containers.items():
            b = other.containers.get(key)
            if b is None or b.n == 0:
                if a.n:
                    out.containers[key] = a.clone()
            else:
                c = _difference_containers(a, b)
                if c.n:
                    out.containers[key] = c
        return out

    def xor(self, other: "Bitmap") -> "Bitmap":
        out = Bitmap()
        for key in self.containers.keys() | other.containers.keys():
            a = self.containers.get(key)
            b = other.containers.get(key)
            if a is None:
                out.containers[key] = b.clone()
            elif b is None:
                out.containers[key] = a.clone()
            else:
                w = a.words() ^ b.words()
                c = Container.from_words(w)
                if c.n:
                    out.containers[key] = c
        return out

    def intersection_count(self, other: "Bitmap") -> int:
        """Popcount of the intersection without materialising it
        (reference IntersectionCount:344). Container-pair dispatch:
        array×array via sorted-merge, small-array×any via probes, dense
        pairs via the native word kernel."""
        from pilosa_tpu_torch import native_bridge

        n = 0
        keys = self.containers.keys() & other.containers.keys()
        for key in keys:
            a, b = self.containers[key], other.containers[key]
            if a.typ == CONTAINER_ARRAY and b.typ == CONTAINER_ARRAY:
                n += native_bridge.intersection_count_sorted_u16(a.array, b.array)
            elif a.typ == CONTAINER_ARRAY and a.n <= 64:
                p = a.array
                n += sum(1 for v in p if b.contains(int(v)))
            elif b.typ == CONTAINER_ARRAY and b.n <= 64:
                p = b.array
                n += sum(1 for v in p if a.contains(int(v)))
            else:
                n += native_bridge.intersection_count_words(a.words(), b.words())
        return n

    def any(self) -> bool:
        return any(c.n for c in self.containers.values())

    def flip(self, start: int, end: int) -> "Bitmap":
        """New bitmap with bits in [start, end] flipped (reference
        Flip:764, inclusive range) — container-wise: each in-range
        container XORs a range mask in one vector op instead of the
        reference's per-bit iterator walk."""
        if end < start:
            return self.clone()
        out = Bitmap()
        hi0, hi1 = highbits(start), highbits(end)
        for key in self._iter_keys_sorted(None, hi0):
            out.containers[key] = self.containers[key].clone()
        for key in range(hi0, hi1 + 1):
            lo = lowbits(start) if key == hi0 else 0
            hi = lowbits(end) if key == hi1 else MAX_CONTAINER_VAL
            mask = np.zeros(BITMAP_N, dtype=np.uint64)
            first_w, last_w = lo >> 6, hi >> 6
            mask[first_w : last_w + 1] = ~np.uint64(0)
            mask[first_w] &= ~np.uint64(0) << np.uint64(lo & 63)
            if (hi & 63) != 63:
                mask[last_w] &= (np.uint64(1) << np.uint64((hi & 63) + 1)) - np.uint64(1)
            c = self.containers.get(key)
            words = (c.words() if c is not None and c.n else np.zeros(BITMAP_N, dtype=np.uint64)) ^ mask
            flipped = Container.from_words(words)
            if flipped.n:
                out.containers[key] = flipped
        for key in self._iter_keys_sorted(hi1 + 1, None):
            out.containers[key] = self.containers[key].clone()
        return out

    def offset_range(self, offset: int, start: int, end: int) -> "Bitmap":
        """Container-level slice [start, end) re-keyed to offset
        (reference OffsetRange:311). All args must be multiples of 2^16."""
        if lowbits(offset) or lowbits(start) or lowbits(end):
            raise ValueError("offset/start/end must not contain low bits")
        off, hi0, hi1 = highbits(offset), highbits(start), highbits(end)
        out = Bitmap()
        for key in self._iter_keys_sorted(hi0, hi1):
            # NOTE: the reference shares the container; we share too (copy-on-
            # write discipline is the caller's job, as in the reference).
            out.containers[off + (key - hi0)] = self.containers[key]
        return out

    def clone(self) -> "Bitmap":
        out = Bitmap()
        for key, c in self.containers.items():
            out.containers[key] = c.clone()
        return out

    # -- packed-word export (TPU staging format) --

    def to_words_range(self, start: int, end: int) -> np.ndarray:
        """Dense packed uint64 words for positions [start, end).

        This is the HBM staging format: bit p (start <= p < end) lands in
        word (p-start)>>6 bit (p-start)&63. start/end must be multiples
        of 2^16 so containers align to word boundaries.
        """
        if lowbits(start) or lowbits(end):
            raise ValueError("start/end must be container-aligned")
        nwords = (end - start) // 64
        out = np.zeros(nwords, dtype=np.uint64)
        hi0, hi1 = highbits(start), highbits(end)
        for key in self._iter_keys_sorted(hi0, hi1):
            c = self.containers[key]
            if c.n:
                base = (key - hi0) * (BITMAP_N)
                out[base : base + BITMAP_N] = c.words()
        return out

    @classmethod
    def from_words_range(cls, words: np.ndarray, start: int = 0) -> "Bitmap":
        """Inverse of to_words_range."""
        if lowbits(start):
            raise ValueError("start must be container-aligned")
        b = cls()
        nc = words.size // BITMAP_N
        for i in range(nc):
            w = words[i * BITMAP_N : (i + 1) * BITMAP_N]
            n = int(np.bitwise_count(w).sum())
            if n:
                b.containers[highbits(start) + i] = Container.from_words(w.copy(), n=n)
        return b

    # -- serialization (reference format) --

    def optimize(self) -> None:
        for c in self.containers.values():
            c.optimize()

    def _iter_serialized(self):
        """(key, typ, n, payload-bytes) stream in key order. Mmap-backed
        stores pass base payloads through as buffer slices (no decode)."""
        f = getattr(self.containers, "iter_serialized", None)
        if f is not None:
            yield from f()
            return
        for k in sorted(self.containers):
            c = self.containers[k]
            if c.n > 0:
                c.optimize()
                yield k, c.typ, c.n, c.write_blob()

    def write_to(self, w) -> int:
        """Serialize in the reference's file format (roaring.go:543-613)."""
        fast = getattr(self.containers, "serialize_clean", None)
        if fast is not None:
            n = fast(w)
            if n is not None:
                return n
        metas = []
        blobs = []
        for key, typ, cn, blob in self._iter_serialized():
            metas.append((key, typ, cn))
            blobs.append(blob)
        count = len(metas)
        header = bytearray()
        header += struct.pack("<II", COOKIE, count)
        for key, typ, cn in metas:
            header += struct.pack("<QHH", key, typ, cn - 1)
        offset = HEADER_BASE_SIZE + count * (8 + 2 + 2 + 4)
        for blob in blobs:
            header += struct.pack("<I", offset)
            offset += len(blob)
        n = w.write(bytes(header))
        for blob in blobs:
            n += w.write(blob)
        return n

    def to_bytes(self) -> bytes:
        import io

        buf = io.BytesIO()
        self.write_to(buf)
        return buf.getvalue()

    @classmethod
    def unmarshal_binary(cls, data: bytes) -> "Bitmap":
        """Parse the reference file format incl. trailing op log
        (reference UnmarshalBinary:616)."""
        b = cls()
        b._unmarshal_into(data)
        return b

    @classmethod
    def open_mmap_file(cls, path: str) -> "Bitmap":
        """Mmap a roaring file and parse it lazily (empty file → empty
        bitmap). Shared by the fragment open path and the check/inspect
        CLI — one place for the open semantics. The map stays alive for
        as long as the returned bitmap references it."""
        import mmap as _mmap
        import os as _os

        if _os.path.getsize(path) == 0:
            return cls()
        with open(path, "rb") as f:
            mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
            # fstat of the fd the map came from: the file identity the
            # mapped bytes actually belong to. A later snapshot that
            # REPLACES the file cannot change this — which is what
            # makes it the sound .occ sidecar stamp (occupancy() would
            # otherwise stat the path at compute time and could stamp
            # OLD-map occupancy with the NEW file's identity)
            st = _os.fstat(f.fileno())
        b = cls.unmarshal_mmap(mm)
        # knowing the backing path enables the .occ occupancy sidecar
        # (mmapstore.occupancy) — first touch becomes a page-in
        from pilosa_tpu_torch.roaring.mmapstore import MmapContainers

        if isinstance(b.containers, MmapContainers):
            b.containers.path = path
            b.containers.open_stat = st
        return b

    @classmethod
    def unmarshal_mmap(cls, buf) -> "Bitmap":
        """Lazy-parse the reference file format over a buffer (mmap):
        the header becomes numpy views over the map, payloads decode on
        demand, and the trailing op log replays into the mutation
        overlay — the zero-copy open the reference does with
        syscall.Mmap + UnmarshalBinary (reference fragment.go:167-224).
        Resident memory is O(ops + touched containers)."""
        from pilosa_tpu_torch.roaring.mmapstore import MmapContainers

        b = cls()
        store, ops_offset = MmapContainers.parse(buf)
        b.containers = store
        mv = memoryview(buf)
        off = ops_offset
        total = len(buf)
        while off < total:
            ops, off = read_op_record(mv, off)
            for op_typ, value in ops:
                if op_typ == OP_ADD:
                    b.add_no_oplog(value)
                else:
                    b.remove_no_oplog(value)
                b.op_n += 1
        return b

    def is_mmap_backed(self) -> bool:
        from pilosa_tpu_torch.roaring.mmapstore import MmapContainers

        return isinstance(self.containers, MmapContainers)

    # -- bulk position merge (vectorised, O(touched containers)) -------------

    def merge_positions(self, add=None, remove=None) -> None:
        """Bulk add/remove sorted-unique u64 position arrays, applied
        per container (removals before adds, so a position in both ends
        set). Bypasses the op log — callers snapshot afterwards, like
        the reference's bulkImport (fragment.go:1296-1397). Unlike a
        whole-bitmap union/difference this touches only the containers
        the positions land in, which is what keeps imports O(batch) on
        mmap-backed tall fragments."""

        def groups(vals):
            if vals is None:
                return {}
            vals = np.asarray(vals, dtype=np.uint64)
            if not vals.size:
                return {}
            keys = vals >> np.uint64(16)
            idx = np.nonzero(np.diff(keys))[0] + 1
            starts = np.concatenate(([0], idx))
            ends = np.concatenate((idx, [vals.size]))
            return {
                int(keys[s]): (vals[s:e] & np.uint64(0xFFFF)).astype(np.uint16)
                for s, e in zip(starts, ends)
            }

        adds = groups(add)
        removes = groups(remove)
        for key in sorted(adds.keys() | removes.keys()):
            a = adds.get(key)
            r = removes.get(key)
            c = self.containers.get(key)
            if c is None:
                if a is None or not a.size:
                    continue
                if a.size > ARRAY_MAX_SIZE:
                    self.containers[key] = Container.from_words(
                        positions_to_words(a), n=int(a.size)
                    )
                else:
                    self.containers[key] = Container.from_array(a)
                continue
            p = c.positions()
            if r is not None and r.size and p.size:
                i = np.searchsorted(r, p)
                i_c = np.minimum(i, r.size - 1)
                hit = (i < r.size) & (r[i_c] == p)
                p = p[~hit]
            if a is not None and a.size:
                p = np.union1d(p, a)
            if not p.size:
                del self.containers[key]
            elif p.size > ARRAY_MAX_SIZE:
                self.containers[key] = Container.from_words(
                    positions_to_words(p), n=int(p.size)
                )
            else:
                self.containers[key] = Container.from_array(p)

    def _unmarshal_into(self, data: bytes) -> None:
        if len(data) < HEADER_BASE_SIZE:
            raise ValueError("data too small")
        file_magic = struct.unpack_from("<H", data, 0)[0]
        file_version = struct.unpack_from("<H", data, 2)[0]
        if file_magic != MAGIC_NUMBER:
            raise ValueError(f"invalid roaring file, magic number {file_magic}")
        if file_version != STORAGE_VERSION:
            raise ValueError(f"wrong roaring version {file_version}")
        key_n = struct.unpack_from("<I", data, 4)[0]
        self.containers.clear()
        metas = []
        off = HEADER_BASE_SIZE
        for _ in range(key_n):
            key, typ, n_minus_1 = struct.unpack_from("<QHH", data, off)
            metas.append((key, typ, n_minus_1 + 1))
            off += 12
        ops_offset = off + 4 * key_n
        for i, (key, typ, n) in enumerate(metas):
            c_off = struct.unpack_from("<I", data, off + 4 * i)[0]
            if c_off >= len(data):
                raise ValueError(f"offset out of bounds: off={c_off}")
            c = Container()
            c.n = n
            if typ == CONTAINER_RUN:
                run_count = struct.unpack_from("<H", data, c_off)[0]
                raw = np.frombuffer(
                    data,
                    dtype="<u2",
                    count=run_count * 2,
                    offset=c_off + RUN_COUNT_HEADER_SIZE,
                )
                c.typ = CONTAINER_RUN
                c.runs = raw.reshape(-1, 2).copy()
                ops_offset = (
                    c_off + RUN_COUNT_HEADER_SIZE + run_count * INTERVAL16_SIZE
                )
            elif typ == CONTAINER_ARRAY:
                c.typ = CONTAINER_ARRAY
                c.array = np.frombuffer(data, dtype="<u2", count=n, offset=c_off).copy()
                ops_offset = c_off + 2 * n
            elif typ == CONTAINER_BITMAP:
                c.typ = CONTAINER_BITMAP
                c.bitmap = np.frombuffer(
                    data, dtype="<u8", count=BITMAP_N, offset=c_off
                ).copy()
                ops_offset = c_off + 8 * BITMAP_N
            else:
                raise ValueError(f"unknown container type {typ}")
            self.containers[key] = c
        # Replay trailing op log (skipping the digest trailer when the
        # snapshot carries one).
        off = ops_offset
        if has_digest_trailer(data, off):
            off += DIGEST_TRAILER_SIZE
        while off < len(data):
            ops, off = read_op_record(data, off)
            for op_typ, value in ops:
                if op_typ == OP_ADD:
                    self.add_no_oplog(value)
                else:
                    self.remove_no_oplog(value)
                self.op_n += 1

    # -- op log --

    def _write_op(self, typ: int, value: int) -> None:
        if self.op_writer is None:
            return
        self.op_writer.write(marshal_op(typ, value))
        self.op_n += 1


# -- op log entries (reference roaring.go:2892-2952) -------------------------

OP_ADD = 0
OP_REMOVE = 1
OP_BATCH = 2  # group-commit record: many add/remove ops, one checksum
OP_SIZE = 1 + 8 + 4
# batch record layout: typ u8 + count u32, then count x (op u8 + value
# u64), then one fnv32a u32 over header+payload — length-framed by the
# count, so a torn tail is detected by bounds before the checksum runs
OP_BATCH_HEADER_SIZE = 1 + 4
OP_BATCH_ENTRY_SIZE = 1 + 8


def _fnv32a(data: bytes) -> int:
    h = 0x811C9DC5
    for byte in data:
        h ^= byte
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


# -- snapshot digest trailer (checksummed snapshot format) -------------------
#
# Layout: [snapshot base][magic u32][blake2b-128 of the base][op log].
# The trailer sits between the base and the op log so the ONE atomic
# os.replace in fragment.snapshot() covers it — a sidecar file would
# reintroduce the torn-write window the rename exists to close. The
# magic's first byte (0xd7) can never be a valid op type (0/1/2), so a
# trailer is unambiguous from op records; files written before this
# format (no trailer) parse unchanged, with verification skipped.

DIGEST_MAGIC = b"\xd7IG1"
DIGEST_SIZE = 16  # blake2b digest_size=16, same as block checksums
DIGEST_TRAILER_SIZE = len(DIGEST_MAGIC) + DIGEST_SIZE


def base_digest(base) -> bytes:
    """blake2b-128 over the serialized snapshot base bytes."""
    import hashlib

    return hashlib.blake2b(bytes(base), digest_size=DIGEST_SIZE).digest()


def make_digest_trailer(base) -> bytes:
    return DIGEST_MAGIC + base_digest(base)


def has_digest_trailer(data, base_end: int) -> bool:
    return (
        len(data) >= base_end + DIGEST_TRAILER_SIZE
        and bytes(data[base_end : base_end + len(DIGEST_MAGIC)]) == DIGEST_MAGIC
    )


def verify_digest_trailer(data, base_end: int) -> bool:
    """True when the stored trailer digest matches the base bytes.
    Only meaningful when ``has_digest_trailer(data, base_end)``."""
    want = bytes(data[base_end + len(DIGEST_MAGIC) : base_end + DIGEST_TRAILER_SIZE])
    return base_digest(memoryview(data)[:base_end]) == want


def marshal_op(typ: int, value: int) -> bytes:
    body = struct.pack("<BQ", typ, value)
    return body + struct.pack("<I", _fnv32a(body))


def unmarshal_op(data: bytes) -> tuple[int, int]:
    if len(data) < OP_SIZE:
        raise ValueError(f"op data out of bounds: len={len(data)}")
    typ, value = struct.unpack_from("<BQ", data, 0)
    chk = struct.unpack_from("<I", data, 9)[0]
    want = _fnv32a(data[0:9])
    if chk != want:
        raise ValueError(f"checksum mismatch: exp={want:08x}, got={chk:08x}")
    if typ not in (OP_ADD, OP_REMOVE):
        raise ValueError(f"invalid op type: {typ}")
    return typ, value


def marshal_op_batch(ops) -> bytes:
    """One length-framed, checksummed group-commit record for a whole
    write wave: N ops land with ONE checksum and (caller-side) ONE
    fsync, instead of N x 13-byte singles."""
    body = bytearray(struct.pack("<BI", OP_BATCH, len(ops)))
    for typ, value in ops:
        if typ not in (OP_ADD, OP_REMOVE):
            raise ValueError(f"invalid op type in batch: {typ}")
        body += struct.pack("<BQ", typ, value)
    return bytes(body) + struct.pack("<I", _fnv32a(bytes(body)))


def read_op_record(buf, off: int = 0) -> tuple[list[tuple[int, int]], int]:
    """Parse ONE op-log record (single op or batch) at ``buf[off:]``.
    Returns ``(ops, next_off)`` with ops as [(typ, value), ...]; raises
    ValueError on a truncated, corrupt, or unknown-typed record —
    the torn-tail signal recovery keys on."""
    total = len(buf)
    if off >= total:
        raise ValueError("op data out of bounds: empty")
    typ = buf[off]
    if typ in (OP_ADD, OP_REMOVE):
        t, v = unmarshal_op(bytes(buf[off : off + OP_SIZE]))
        return [(t, v)], off + OP_SIZE
    if typ == OP_BATCH:
        if off + OP_BATCH_HEADER_SIZE > total:
            raise ValueError("op batch header out of bounds")
        count = struct.unpack_from("<I", buf, off + 1)[0]
        size = OP_BATCH_HEADER_SIZE + count * OP_BATCH_ENTRY_SIZE
        if off + size + 4 > total:
            raise ValueError(
                f"op batch out of bounds: need {size + 4}, have {total - off}"
            )
        body = bytes(buf[off : off + size])
        chk = struct.unpack_from("<I", buf, off + size)[0]
        want = _fnv32a(body)
        if chk != want:
            raise ValueError(
                f"batch checksum mismatch: exp={want:08x}, got={chk:08x}"
            )
        ops = []
        p = OP_BATCH_HEADER_SIZE
        for _ in range(count):
            t, v = struct.unpack_from("<BQ", body, p)
            if t not in (OP_ADD, OP_REMOVE):
                raise ValueError(f"invalid op type in batch: {t}")
            ops.append((t, v))
            p += OP_BATCH_ENTRY_SIZE
        return ops, off + size + 4
    raise ValueError(f"invalid op type: {typ}")


def snapshot_base_end(data) -> int:
    """End of the serialized snapshot base (header + meta/offset tables
    + container payloads), computed from the header, meta, and offset
    tables alone (plus one 2-byte run-count read for a trailing run
    container) — no payload decode, so the crash-recovery scan can
    bound the snapshot prefix before anything mmaps the file. The
    digest trailer (when present) and the op log follow this offset."""
    if len(data) < HEADER_BASE_SIZE:
        raise ValueError("data too small")
    file_magic = struct.unpack_from("<H", data, 0)[0]
    file_version = struct.unpack_from("<H", data, 2)[0]
    if file_magic != MAGIC_NUMBER:
        raise ValueError(f"invalid roaring file, magic number {file_magic}")
    if file_version != STORAGE_VERSION:
        raise ValueError(f"wrong roaring version {file_version}")
    key_n = struct.unpack_from("<I", data, 4)[0]
    tables_end = HEADER_BASE_SIZE + key_n * (12 + 4)
    if tables_end > len(data):
        raise ValueError("container tables out of bounds")
    if key_n == 0:
        return HEADER_BASE_SIZE
    # offsets are written ascending (write_to), so the LAST container's
    # end is the op-log start
    _, typ, n_minus_1 = struct.unpack_from(
        "<QHH", data, HEADER_BASE_SIZE + (key_n - 1) * 12
    )
    c_off = struct.unpack_from(
        "<I", data, HEADER_BASE_SIZE + key_n * 12 + (key_n - 1) * 4
    )[0]
    if typ == CONTAINER_RUN:
        if c_off + RUN_COUNT_HEADER_SIZE > len(data):
            raise ValueError("run container out of bounds")
        run_count = struct.unpack_from("<H", data, c_off)[0]
        end = c_off + RUN_COUNT_HEADER_SIZE + run_count * INTERVAL16_SIZE
    elif typ == CONTAINER_ARRAY:
        end = c_off + 2 * (n_minus_1 + 1)
    elif typ == CONTAINER_BITMAP:
        end = c_off + 8 * BITMAP_N
    else:
        raise ValueError(f"unknown container type {typ}")
    if end > len(data):
        raise ValueError("container payload out of bounds")
    return end


def ops_offset_of(data) -> int:
    """Offset where the trailing op log begins: the snapshot base end,
    plus the digest trailer when the file carries one (checksummed
    snapshot format). Legacy files without a trailer parse unchanged."""
    end = snapshot_base_end(data)
    if has_digest_trailer(data, end):
        end += DIGEST_TRAILER_SIZE
    return end


def scan_op_log(data, ops_offset: int) -> tuple[int, int]:
    """Walk the op-log tail record by record, validating length framing
    and checksums. Returns ``(valid_end, n_ops)`` — the byte offset
    just past the last fully valid record and the op count it holds.
    A torn or corrupt tail stops the scan instead of raising: callers
    truncate the file to valid_end and every acknowledged (fsynced)
    record before the tear survives."""
    off = ops_offset
    n_ops = 0
    total = len(data)
    while off < total:
        try:
            ops, nxt = read_op_record(data, off)
        except ValueError:
            break
        off = nxt
        n_ops += len(ops)
    return off, n_ops


# -- container pair ops ------------------------------------------------------


def _intersect_containers(a: Container, b: Container) -> Container:
    if a.typ == CONTAINER_ARRAY and b.typ == CONTAINER_ARRAY:
        from pilosa_tpu_torch import native_bridge

        return Container.from_array(
            native_bridge.intersect_sorted_u16(a.array, b.array)
        )
    if a.typ == CONTAINER_ARRAY:
        keep = np.fromiter(
            (b.contains(int(v)) for v in a.array), dtype=bool, count=a.array.size
        ) if a.array.size else np.empty(0, dtype=bool)
        return Container.from_array(a.array[keep])
    if b.typ == CONTAINER_ARRAY:
        return _intersect_containers(b, a)
    return Container.from_words(a.words() & b.words())


def _union_containers(a: Container, b: Container) -> Container:
    if a.typ == CONTAINER_ARRAY and b.typ == CONTAINER_ARRAY:
        if a.n + b.n <= ARRAY_MAX_SIZE:
            return Container.from_array(np.union1d(a.array, b.array))
    return Container.from_words(a.words() | b.words())


def _difference_containers(a: Container, b: Container) -> Container:
    if a.typ == CONTAINER_ARRAY:
        if b.typ == CONTAINER_ARRAY:
            return Container.from_array(
                np.setdiff1d(a.array, b.array, assume_unique=True)
            )
        keep = np.fromiter(
            (not b.contains(int(v)) for v in a.array), dtype=bool, count=a.array.size
        ) if a.array.size else np.empty(0, dtype=bool)
        return Container.from_array(a.array[keep])
    return Container.from_words(a.words() & ~b.words())
