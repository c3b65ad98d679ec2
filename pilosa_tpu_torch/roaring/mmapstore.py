"""Mmap-backed columnar container store — memory-scalable roaring.

The reference opens fragments by mmapping the roaring file and
unmarshalling *onto* the map zero-copy (reference fragment.go:167-224,
roaring/roaring.go:616-705): container headers become slices into the
map and payloads are touched only when read. This module is the
TPU-rebuild equivalent: instead of one Python ``Container`` object per
container (impossible at the 1B-row scale — ~10^9 containers), the
store keeps the file's own header block as numpy views over the mmap:

  * ``metas``   — structured view [(key u64, typ u16, n-1 u16)] * N
  * ``offsets`` — u32[N] payload offsets (the file's offset table)

and decodes individual container payloads on demand. Point lookups are
O(log N) bisects over the key column that touch only O(log N) pages;
bulk scans stream. Resident memory is O(touched), not O(containers).

Mutations never write the map: a mutated (or new) container is
materialised into a small ``overlay`` dict and deletions are
tombstoned, so the store is a frozen base + delta — the same
snapshot + op-log split the on-disk format itself uses.
"""

from __future__ import annotations

import struct
from collections.abc import Set
from typing import Iterator, Optional

import numpy as np

from pilosa_tpu_torch.roaring.bitmap import (
    BITMAP_N,
    CONTAINER_ARRAY,
    CONTAINER_BITMAP,
    CONTAINER_RUN,
    INTERVAL16_SIZE,
    RUN_COUNT_HEADER_SIZE,
    Container,
)

META_DTYPE = np.dtype([("key", "<u8"), ("typ", "<u2"), ("n", "<u2")])
HEADER_BASE_SIZE = 8


class _KeysView(Set):
    """Lazy set-like view over a store's keys. The abc.Set mixin gives
    ``&``/``|`` implementations that iterate the *other* operand and
    membership-test this one, so intersecting a huge mmap store with a
    small dict-backed row never materialises the big key set."""

    def __init__(self, store: "MmapContainers") -> None:
        self._store = store

    def __contains__(self, key) -> bool:
        return key in self._store

    def __iter__(self):
        return iter(self._store)

    def __len__(self) -> int:
        return len(self._store)

    @classmethod
    def _from_iterable(cls, it):
        return set(it)


class MmapContainers:
    """dict-compatible container mapping over a frozen mmapped roaring
    file plus a mutation overlay."""

    __slots__ = (
        "buf",
        "metas",
        "offsets",
        "overlay",
        "_deleted",
        "_n_new",
        "_base_n",
        "_kc_cache",
        "ops_offset",
        "path",
        "open_stat",
    )

    def __init__(
        self, buf, metas: np.ndarray, offsets: np.ndarray, ops_offset: int = 0
    ) -> None:
        self.buf = buf
        self.metas = metas
        self.offsets = offsets
        self.overlay: dict[int, Container] = {}
        self._deleted: set[int] = set()
        self._n_new = 0  # overlay keys not present in base
        self._base_n = int(metas.shape[0])
        self._kc_cache: Optional[tuple[np.ndarray, np.ndarray]] = None
        # backing file path (set by the mmap open path); enables the
        # .occ occupancy sidecar
        self.path: Optional[str] = None
        # fstat of the fd the mmap was created from (set by the mmap
        # open path): the identity of the bytes this store actually
        # reads — the sound sidecar stamp even when the file on disk
        # is later replaced by a snapshot
        self.open_stat = None
        # byte offset of the trailing op log = end of the serialized
        # snapshot region; an unmutated store serializes by copying
        # buf[:ops_offset] verbatim (see serialize_clean)
        self.ops_offset = ops_offset

    # -- construction --------------------------------------------------------

    @classmethod
    def parse(cls, buf) -> tuple["MmapContainers", int]:
        """Parse a roaring file header from a buffer (bytes / mmap).

        Returns (store, ops_offset) where ops_offset is the byte offset
        of the trailing op log. The payloads are NOT decoded.

        When the file carries a digest trailer (checksummed snapshot
        format), the RETURNED ops_offset skips it — op replay starts
        past the trailer — but ``store.ops_offset`` stays at the base
        end: serialize_clean's verbatim copy must emit the bare base
        (fragment.snapshot appends a fresh trailer itself), and the
        .occ sidecar stamp compares against the same base-end value.
        """
        if len(buf) < HEADER_BASE_SIZE:
            raise ValueError("data too small")
        from pilosa_tpu_torch.roaring.bitmap import MAGIC_NUMBER, STORAGE_VERSION

        file_magic = struct.unpack_from("<H", buf, 0)[0]
        file_version = struct.unpack_from("<H", buf, 2)[0]
        if file_magic != MAGIC_NUMBER:
            raise ValueError(f"invalid roaring file, magic number {file_magic}")
        if file_version != STORAGE_VERSION:
            raise ValueError(f"wrong roaring version {file_version}")
        key_n = struct.unpack_from("<I", buf, 4)[0]
        metas = np.frombuffer(buf, dtype=META_DTYPE, count=key_n, offset=HEADER_BASE_SIZE)
        offsets = np.frombuffer(
            buf, dtype="<u4", count=key_n, offset=HEADER_BASE_SIZE + 12 * key_n
        )
        if key_n == 0:
            ops_offset = HEADER_BASE_SIZE
        else:
            last = key_n - 1
            off = int(offsets[last])
            typ = int(metas["typ"][last])
            n = int(metas["n"][last]) + 1
            if typ == CONTAINER_RUN:
                run_count = struct.unpack_from("<H", buf, off)[0]
                ops_offset = off + RUN_COUNT_HEADER_SIZE + run_count * INTERVAL16_SIZE
            elif typ == CONTAINER_ARRAY:
                ops_offset = off + 2 * n
            elif typ == CONTAINER_BITMAP:
                ops_offset = off + 8 * BITMAP_N
            else:
                raise ValueError(f"unknown container type {typ}")
            if ops_offset > len(buf):
                raise ValueError(f"offset out of bounds: off={ops_offset}")
        store = cls(buf, metas, offsets, ops_offset=ops_offset)
        from pilosa_tpu_torch.roaring.bitmap import DIGEST_TRAILER_SIZE, has_digest_trailer

        replay_offset = ops_offset
        if has_digest_trailer(buf, ops_offset):
            replay_offset += DIGEST_TRAILER_SIZE
        return store, replay_offset

    # -- base access ---------------------------------------------------------

    def _bisect(self, key: int) -> int:
        """Index of key in the base key column, or -1. Touches O(log N)
        mmap pages (no array copy)."""
        keys = self.metas["key"]
        lo, hi = 0, self._base_n
        while lo < hi:
            mid = (lo + hi) // 2
            if int(keys[mid]) < key:
                lo = mid + 1
            else:
                hi = mid
        if lo < self._base_n and int(keys[lo]) == key:
            return lo
        return -1

    def _bisect_left(self, key: int) -> int:
        keys = self.metas["key"]
        lo, hi = 0, self._base_n
        while lo < hi:
            mid = (lo + hi) // 2
            if int(keys[mid]) < key:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _decode(self, i: int) -> Container:
        """Decode base container i into a fresh Container (payload
        copied out of the map so its arrays outlive the mmap)."""
        typ = int(self.metas["typ"][i])
        n = int(self.metas["n"][i]) + 1
        off = int(self.offsets[i])
        c = Container()
        c.n = n
        if typ == CONTAINER_ARRAY:
            c.typ = CONTAINER_ARRAY
            c.array = np.frombuffer(self.buf, dtype="<u2", count=n, offset=off).copy()
        elif typ == CONTAINER_BITMAP:
            c.typ = CONTAINER_BITMAP
            c.bitmap = np.frombuffer(
                self.buf, dtype="<u8", count=BITMAP_N, offset=off
            ).copy()
        elif typ == CONTAINER_RUN:
            run_count = struct.unpack_from("<H", self.buf, off)[0]
            c.typ = CONTAINER_RUN
            c.runs = (
                np.frombuffer(
                    self.buf,
                    dtype="<u2",
                    count=run_count * 2,
                    offset=off + RUN_COUNT_HEADER_SIZE,
                )
                .copy()
                .reshape(-1, 2)
            )
        else:
            raise ValueError(f"unknown container type {typ}")
        return c

    def raw_blob(self, i: int) -> tuple[int, int, int, memoryview]:
        """(key, typ, n, payload bytes) for base container i without
        decoding — snapshot streaming reuses the original payload."""
        typ = int(self.metas["typ"][i])
        n = int(self.metas["n"][i]) + 1
        off = int(self.offsets[i])
        if typ == CONTAINER_ARRAY:
            size = 2 * n
        elif typ == CONTAINER_BITMAP:
            size = 8 * BITMAP_N
        else:
            run_count = struct.unpack_from("<H", self.buf, off)[0]
            size = RUN_COUNT_HEADER_SIZE + run_count * INTERVAL16_SIZE
        return int(self.metas["key"][i]), typ, n, memoryview(self.buf)[off : off + size]

    # -- mapping API ---------------------------------------------------------

    def get(self, key: int, default=None) -> Optional[Container]:
        c = self.overlay.get(key)
        if c is not None:
            return c
        if key in self._deleted:
            return default
        i = self._bisect(key)
        if i < 0:
            return default
        return self._decode(i)

    def mutate(self, key: int) -> Optional[Container]:
        """Like get(), but pins the container into the overlay so
        in-place mutations persist (ephemeral decodes from get() do
        not)."""
        self._kc_cache = None  # caller is about to mutate occupancy
        c = self.overlay.get(key)
        if c is not None:
            return c
        if key in self._deleted:
            return None
        i = self._bisect(key)
        if i < 0:
            return None
        c = self._decode(i)
        self.overlay[key] = c
        return c

    def __getitem__(self, key: int) -> Container:
        c = self.get(key)
        if c is None:
            raise KeyError(key)
        return c

    def __setitem__(self, key: int, c: Container) -> None:
        in_base = self._bisect(key) >= 0
        if key in self._deleted:
            self._deleted.discard(key)
        elif not in_base and key not in self.overlay:
            self._n_new += 1
        self.overlay[key] = c
        self._kc_cache = None

    def __delitem__(self, key: int) -> None:
        self._kc_cache = None
        had_overlay = self.overlay.pop(key, None) is not None
        in_base = self._bisect(key) >= 0
        if in_base:
            if key in self._deleted:
                raise KeyError(key)
            self._deleted.add(key)
        elif had_overlay:
            self._n_new -= 1
        else:
            raise KeyError(key)

    def pop(self, key: int, *default):
        try:
            c = self[key]
        except KeyError:
            if default:
                return default[0]
            raise
        del self[key]
        return c

    def __contains__(self, key: int) -> bool:
        if key in self.overlay:
            return True
        if key in self._deleted:
            return False
        return self._bisect(key) >= 0

    def __len__(self) -> int:
        return self._base_n - len(self._deleted) + self._n_new

    def __iter__(self) -> Iterator[int]:
        return self.iter_keys()

    def iter_keys(self, lo: Optional[int] = None, hi: Optional[int] = None):
        """Merged sorted key iteration over [lo, hi) (None = unbounded)."""
        keys = self.metas["key"]
        i = self._bisect_left(lo) if lo is not None else 0
        ov = sorted(
            k
            for k in self.overlay
            if (lo is None or k >= lo) and (hi is None or k < hi)
        )
        j = 0
        n = self._base_n
        while i < n or j < len(ov):
            bk = int(keys[i]) if i < n else None
            if bk is not None and hi is not None and bk >= hi:
                bk = None
                i = n
                continue
            ok = ov[j] if j < len(ov) else None
            if bk is not None and (ok is None or bk < ok):
                i += 1
                if bk in self._deleted or bk in self.overlay:
                    continue  # overlay key emitted from ov side
                yield bk
            elif ok is not None:
                j += 1
                yield ok

    def keys(self):
        return _KeysView(self)

    def items(self):
        for k in self.iter_keys():
            yield k, self.get(k)

    def values(self):
        for k in self.iter_keys():
            yield self.get(k)

    def clear(self) -> None:
        self.metas = np.empty(0, dtype=META_DTYPE)
        self.offsets = np.empty(0, dtype="<u4")
        self._base_n = 0
        self.overlay.clear()
        self._deleted.clear()
        self._n_new = 0
        self._kc_cache = None
        self.ops_offset = 0  # base gone; serialize_clean must not fire

    # -- bulk fast paths -----------------------------------------------------

    def total_count(self) -> int:
        """Sum of container cardinalities without decoding payloads.
        Lockless-reader safe: overlay/deleted are snapshotted with
        single C-level copies before iteration (a concurrent writer
        holds the fragment lock, readers do not)."""
        ns = self.metas["n"].astype(np.int64) + 1
        total = int(ns.sum())
        deleted = tuple(self._deleted)
        if deleted:
            for k in deleted:
                i = self._bisect(k)
                if i >= 0:
                    total -= int(ns[i])
        for k, c in dict(self.overlay).items():
            i = self._bisect(k)
            if i >= 0:
                total -= int(ns[i])
            total += c.n
        return total

    def keys_and_counts(self) -> tuple[np.ndarray, np.ndarray]:
        """(sorted u64 keys, u32 per-container cardinalities) for the
        merged store — one streaming pass, O(N) transient."""
        keys = np.ascontiguousarray(self.metas["key"])
        ns = self.metas["n"].astype(np.uint32) + 1
        # one atomic snapshot each — lockless readers race writers, and
        # building keys/counts from the LIVE dict in separate passes
        # could yield arrays of different lengths
        ov = dict(self.overlay)
        deleted = set(self._deleted)
        if deleted or ov:
            # mask out deleted + shadowed base entries
            shadow = deleted | set(ov)
            if shadow:
                mask = ~np.isin(keys, np.fromiter(shadow, dtype=np.uint64))
                keys, ns = keys[mask], ns[mask]
            if ov:
                ok = np.fromiter(ov.keys(), dtype=np.uint64)
                on = np.fromiter(
                    (c.n for c in ov.values()), dtype=np.uint32
                )
                keys = np.concatenate([keys, ok])
                ns = np.concatenate([ns, on])
                order = np.argsort(keys, kind="stable")
                keys, ns = keys[order], ns[order]
        return keys, ns

    def occupancy(self) -> tuple[np.ndarray, np.ndarray]:
        """(sorted container keys, exclusive-prefix-sum of cardinalities)
        — the per-query index behind sparse staging and vectorised row
        recounts. Cached until the next mutation, with dtypes downcast
        to u32 when they fit: at the 1B-row scale (~15.6M containers per
        fragment × 64 fragments) the resident cost is what decides
        whether the north-star config fits in host RAM.

        For a PURE base (no overlay/tombstones — the serving steady
        state) the downcast keys + prefix sum are persisted to a
        ``.occ`` sidecar and mmapped on later opens: first touch of a
        64-fragment 1B index drops from ~0.6 s/fragment of
        copy+cumsum to a page-in, and residency becomes page cache
        (evictable) instead of anonymous RAM. The sidecar is stamped
        with (base_n, ops_offset) plus the roaring file's
        (size, mtime_ns): a snapshot can rewrite the base to the SAME
        size and container count (balanced clear/set pairs), so only
        the mtime makes staleness detection sound — and
        Fragment.snapshot additionally unlinks the sidecar outright."""
        if self._kc_cache is not None:
            return self._kc_cache
        pure = not (self.overlay or self._deleted)
        if pure:
            got = self._occ_sidecar_load()
            if got is not None:
                self._kc_cache = got
                return got
        # stamp with the identity of the mmapped bytes (fstat captured
        # when the map was established — mmapstore.open_stat): a
        # snapshot replacing the file any time after open would
        # otherwise let us stamp OLD-map occupancy with the NEW file's
        # (size, mtime_ns) — exactly the staleness the stamp exists to
        # catch (the balanced clear/set case where base_n/ops_offset
        # coincide). write_occ_sidecar re-stats the path at save time
        # and refuses when (size, mtime_ns, inode) differs.
        st_before = getattr(self, "open_stat", None)
        keys, cs = occ_arrays(*self.keys_and_counts())
        # re-check purity AFTER computing: a writer racing this lockless
        # reader may have grown the overlay mid-pass, and persisting
        # overlay-inclusive counts as the "pure base" sidecar would
        # poison every future open of this fragment on disk
        if pure and not (self.overlay or self._deleted):
            self._occ_sidecar_save(keys, cs, stamp_stat=st_before)
        self._kc_cache = (keys, cs)
        return self._kc_cache

    # -- occupancy sidecar ---------------------------------------------------
    # format: magic u64 | base_n u64 | ops_offset u64 | nkeys u64 |
    #         file_size u64 | file_mtime_ns u64 |
    #         keys_code u8 | cs_code u8 | pad[6] | keys | cs
    _OCC_MAGIC = 0x50544F43_32000000  # "PTOC2"

    def _occ_path(self) -> Optional[str]:
        return self.path + ".occ" if getattr(self, "path", None) else None

    def _occ_sidecar_load(self) -> Optional[tuple[np.ndarray, np.ndarray]]:
        p = self._occ_path()
        if not p:
            return None
        import mmap as _mmap

        try:
            with open(p, "rb") as f:
                mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        except (OSError, ValueError):
            return None
        try:
            hdr = np.frombuffer(mm, dtype="<u8", count=6)
            if int(hdr[0]) != self._OCC_MAGIC:
                return None
            if int(hdr[1]) != self._base_n or int(hdr[2]) != self.ops_offset:
                return None  # base region changed (snapshot): stale
            st = _os_stat(self.path)
            if st is None or int(hdr[4]) != st.st_size or int(hdr[5]) != st.st_mtime_ns:
                return None  # file rewritten since the sidecar was cut
            nkeys = int(hdr[3])
            codes = np.frombuffer(mm, dtype="<u1", count=2, offset=48)
            kdt = np.uint32 if codes[0] == 4 else np.uint64
            cdt = np.uint32 if codes[1] == 4 else np.int64
            koff = 56
            coff = koff + nkeys * np.dtype(kdt).itemsize
            # np.frombuffer itself raises ValueError (caught below) when
            # either array would run past the buffer
            keys = np.frombuffer(mm, dtype=kdt, count=nkeys, offset=koff)
            cs = np.frombuffer(mm, dtype=cdt, count=nkeys + 1, offset=coff)
            return keys, cs
        except (ValueError, IndexError):
            return None

    def _occ_sidecar_save(
        self, keys: np.ndarray, cs: np.ndarray, stamp_stat=None
    ) -> None:
        p = self._occ_path()
        if p:
            write_occ_sidecar(
                p,
                keys,
                cs,
                self._base_n,
                self.ops_offset,
                roaring_path=self.path,
                stamp_stat=stamp_stat,
            )

    def expand_base_blocks(
        self, sel: np.ndarray, out: np.ndarray, snapshot_len: Optional[int] = None
    ) -> bool:
        """Expand base containers (by BASE index) into dense 1024-word
        blocks via the native kernel, decoding straight from the mmap —
        the staging pack's hot loop without a Python iteration per
        container. Only valid for a PURE store (no overlay/tombstones)
        whose occupancy indices equal base indices; callers that
        computed ``sel`` against an occupancy SNAPSHOT must pass that
        snapshot's length — a snapshot taken while an overlay key
        existed has a different length than the base, and using its
        indices against the base would stage wrong containers (or read
        past the offsets array into the C++ kernel). Returns False when
        impure, stale, out of bounds, or the native library is absent
        (caller falls back to the per-container Python decode)."""
        if self.overlay or self._deleted or self._base_n == 0:
            return False
        if snapshot_len is not None and snapshot_len != self._base_n:
            return False  # sel indexes a different (stale) key universe
        if sel.size and (int(sel.max()) >= self._base_n or int(sel.min()) < 0):
            return False
        from pilosa_tpu_torch import native_bridge

        head = np.frombuffer(self.buf, dtype=np.uint8, count=1)
        return native_bridge.expand_blocks(
            head.ctypes.data,
            len(self.buf),
            self.metas.ctypes.data,
            self.offsets,
            sel,
            out,
        )

    def max_key(self) -> Optional[int]:
        best = max(self.overlay) if self.overlay else None
        i = self._base_n - 1
        keys = self.metas["key"]
        while i >= 0:
            k = int(keys[i])
            if k not in self._deleted:
                if best is None or k > best:
                    best = k
                break
            i -= 1
        return best

    def serialize_clean(self, w) -> Optional[int]:
        """Fast serialization for an UNMUTATED store: the snapshot
        region of the original file (header + offsets + payloads,
        everything before the op log) is already the exact serialized
        form — stream it verbatim instead of re-encoding millions of
        containers through Python (a 280 MB / 15.6M-container fragment
        backs up at memcpy speed; the slow path takes minutes). Returns
        bytes written, or None when the overlay/tombstones make the
        base stale (caller falls back to the generic writer)."""
        if self.overlay or self._deleted or self.ops_offset < HEADER_BASE_SIZE:
            # mutated, cleared, or constructed without a parsed base —
            # the base region is not the current serialized form
            return None
        return w.write(memoryview(self.buf)[: self.ops_offset])

    def iter_serialized(self):
        """(key, typ, n, payload) merged sorted stream for write_to —
        base containers stream their original payload bytes (no
        decode); overlay containers encode."""
        keys = self.metas["key"]
        i = 0
        ov = sorted(self.overlay)
        j = 0
        n = self._base_n
        while i < n or j < len(ov):
            bk = int(keys[i]) if i < n else None
            ok = ov[j] if j < len(ov) else None
            if bk is not None and (ok is None or bk < ok):
                i += 1
                if bk in self._deleted or bk in self.overlay:
                    continue
                yield self.raw_blob(i - 1)
            elif ok is not None:
                j += 1
                c = self.overlay[ok]
                if c.n > 0:
                    c.optimize()
                    yield ok, c.typ, c.n, c.write_blob()


def _os_stat(path):
    import os as _os

    try:
        return _os.stat(path)
    except OSError:
        return None


def occ_arrays(keys: np.ndarray, ns: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(downcast keys, exclusive prefix sum) — the occupancy shape the
    sidecar stores and queries consume (one implementation shared by
    the live path and the fragment builder). The u32 key downcast
    keeps a one-row-span margin so query-side clamping can never
    collide with a real key (see Fragment._row_key_spans)."""
    cs = np.concatenate(([0], np.cumsum(ns, dtype=np.int64)))
    if keys.size and int(keys[-1]) <= 0xFFFFFFFF - 16:
        keys = keys.astype(np.uint32)
    if cs.size and int(cs[-1]) <= 0xFFFFFFFF:
        cs = cs.astype(np.uint32)
    return keys, cs


def write_occ_sidecar(
    occ_path: str,
    keys: np.ndarray,
    cs: np.ndarray,
    base_n: int,
    ops_offset: int,
    roaring_path: Optional[str] = None,
    stamp_stat=None,
) -> None:
    """Atomically write a .occ occupancy sidecar (format documented on
    MmapContainers.occupancy), stamped with the roaring file's current
    (size, mtime_ns). When ``stamp_stat`` (the file's stat captured
    BEFORE the occupancy was computed) is given, the save is refused if
    the file's (size, mtime_ns, inode) has since changed — a snapshot
    replacing the file mid-compute must not get old occupancy stamped
    with its new identity. Failures are swallowed — the sidecar is a
    pure accelerator; the roaring file stays the source of truth."""
    import os as _os

    if roaring_path is None:
        roaring_path = occ_path[:-4] if occ_path.endswith(".occ") else occ_path
    st = _os_stat(roaring_path)
    if st is None:
        return
    if stamp_stat is not None and (
        st.st_size != stamp_stat.st_size
        or st.st_mtime_ns != stamp_stat.st_mtime_ns
        or st.st_ino != stamp_stat.st_ino
    ):
        return  # file replaced since the occupancy was computed
    tmp = occ_path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(
                np.array(
                    [
                        MmapContainers._OCC_MAGIC,
                        base_n,
                        ops_offset,
                        keys.size,
                        st.st_size,
                        st.st_mtime_ns,
                    ],
                    dtype="<u8",
                ).tobytes()
            )
            f.write(
                np.array(
                    [keys.dtype.itemsize, cs.dtype.itemsize, 0, 0, 0, 0, 0, 0],
                    dtype="<u1",
                ).tobytes()
            )
            f.write(np.ascontiguousarray(keys).tobytes())
            f.write(np.ascontiguousarray(cs).tobytes())
        _os.replace(tmp, occ_path)
    except OSError:
        try:
            _os.unlink(tmp)
        except OSError:
            pass
