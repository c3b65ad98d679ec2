"""Streaming roaring file builder — write reference-format fragment
files from sorted position streams without materialising containers.

The eager build path (Bitmap.from_sorted → write_to) holds one Python
Container per 2^16-block; at the north-star scale (1B rows ⇒ ~10^9
containers across the holder, SURVEY.md §7 hard part 2) that is not a
memory plan. This builder streams: each chunk of globally-sorted
positions is split into containers with pure numpy, payload bytes are
appended to a temp file, and only the columnar header (key/typ/n per
container) is retained until the final header+offset-table write — the
same file format the reference serialises (reference
roaring/roaring.go:543-613), readable by both the eager and mmap
decoders.

Array containers' payloads are literally the low 16 bits of the input
slice, so a chunk whose containers are all arrays is written with one
``tobytes`` — the builder runs at numpy memcpy speed, which is what
makes building a 1B-position data dir on one core practical.
"""

from __future__ import annotations

import os
import shutil
import struct
from typing import Iterable, Optional

import numpy as np

from pilosa_tpu_torch.roaring.bitmap import (
    ARRAY_MAX_SIZE,
    BITMAP_N,
    CONTAINER_ARRAY,
    CONTAINER_BITMAP,
    COOKIE,
    HEADER_BASE_SIZE,
    positions_to_words,
)


class _HeaderAccum:
    def __init__(self) -> None:
        self.keys: list[np.ndarray] = []
        self.typs: list[np.ndarray] = []
        self.ns: list[np.ndarray] = []

    def extend(self, keys, typs, ns) -> None:
        self.keys.append(keys)
        self.typs.append(typs)
        self.ns.append(ns)

    def concat(self):
        if not self.keys:
            return (
                np.empty(0, np.uint64),
                np.empty(0, np.uint8),
                np.empty(0, np.uint32),
            )
        return (
            np.concatenate(self.keys),
            np.concatenate(self.typs),
            np.concatenate(self.ns),
        )


def _write_chunk(vals: np.ndarray, payload, accum: _HeaderAccum) -> None:
    """Split one sorted-unique u64 position chunk into containers and
    append payloads; all-numpy except one short loop over *bitmap-form*
    containers (rare in sparse data)."""
    keys = vals >> np.uint64(16)
    low = (vals & np.uint64(0xFFFF)).astype("<u2")
    idx = np.nonzero(np.diff(keys))[0] + 1
    starts = np.concatenate(([0], idx)).astype(np.int64)
    ends = np.concatenate((idx, [vals.size])).astype(np.int64)
    ns = (ends - starts).astype(np.uint32)
    ckeys = keys[starts]
    typs = np.where(ns <= ARRAY_MAX_SIZE, CONTAINER_ARRAY, CONTAINER_BITMAP).astype(
        np.uint8
    )
    accum.extend(ckeys, typs, ns)
    dense = np.nonzero(typs == CONTAINER_BITMAP)[0]
    if not dense.size:
        payload.write(low.tobytes())
        return
    prev = 0
    for di in dense:
        s, e = int(starts[di]), int(ends[di])
        if s > prev:
            payload.write(low[prev:s].tobytes())
        payload.write(positions_to_words(low[s:e]).astype("<u8").tobytes())
        prev = e
    if prev < vals.size:
        payload.write(low[prev:].tobytes())


def write_roaring_file(
    path: str, chunks: Iterable[np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """Stream chunks of globally-sorted, duplicate-free uint64 positions
    into a reference-format roaring file at ``path``.

    Caller contract: concatenated chunks are sorted ascending with no
    duplicates (each chunk may end mid-container; the boundary container
    is healed across chunks here).

    Returns (container_keys u64[N], container_counts u32[N]) — the
    occupancy index, which callers use to build the TopN .cache without
    re-reading the file.
    """
    accum = _HeaderAccum()
    tmp_payload = path + ".payload"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        return _write_roaring_file(path, chunks, accum, tmp_payload)
    except BaseException:
        # never leave multi-GB temp files behind a failed build
        for p in (tmp_payload, path + ".building"):
            try:
                os.unlink(p)
            except OSError:
                pass
        raise


def _write_roaring_file(path, chunks, accum, tmp_payload):
    carry: Optional[np.ndarray] = None
    with open(tmp_payload, "wb") as payload:
        for chunk in chunks:
            vals = np.asarray(chunk, dtype=np.uint64)
            if not vals.size:
                continue
            if carry is not None:
                vals = np.concatenate([carry, vals])
                carry = None
            # hold back the trailing container in case the next chunk
            # continues it
            last_key = vals[-1] >> np.uint64(16)
            cut = int(np.searchsorted(vals, np.uint64(last_key << np.uint64(16))))
            if cut > 0:
                _write_chunk(vals[:cut], payload, accum)
                carry = vals[cut:]
            else:
                carry = vals
        if carry is not None and carry.size:
            _write_chunk(carry, payload, accum)

    keys, typs, ns = accum.concat()
    count = keys.size
    sizes = np.where(typs == CONTAINER_ARRAY, 2 * ns.astype(np.int64), 8 * BITMAP_N)
    offsets_start = HEADER_BASE_SIZE + count * (12 + 4)
    offsets = offsets_start + np.concatenate(
        ([0], np.cumsum(sizes[:-1]))
    ) if count else np.empty(0, np.int64)

    if count and int(offsets[-1] + sizes[-1]) > 0xFFFFFFFF:
        # the reference format's offset table is u32 — same limit there
        raise ValueError("fragment file exceeds the format's 4 GiB offset limit")

    metas = np.empty(count, dtype=[("key", "<u8"), ("typ", "<u2"), ("n", "<u2")])
    metas["key"] = keys
    metas["typ"] = typs
    metas["n"] = (ns - 1).astype("<u2")

    tmp = path + ".building"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<II", COOKIE, count))
        f.write(metas.tobytes())
        f.write(offsets.astype("<u4").tobytes())
        with open(tmp_payload, "rb") as pf:
            shutil.copyfileobj(pf, f, length=16 << 20)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    os.unlink(tmp_payload)
    return keys, ns


def build_fragment_file(
    frag_path: str,
    chunks: Iterable[np.ndarray],
    shard_width_containers: int = 16,
    cache_size: int = 50000,
    write_cache_file: bool = True,
) -> dict:
    """Build one fragment's roaring file plus its TopN ``.cache`` from a
    sorted position stream.

    The .cache holds the ids of the top ``cache_size`` rows by bit
    count — computed from the container occupancy index (row r spans
    container keys [r*16, (r+1)*16)), no second file pass. Mirrors what
    the reference accumulates through rankCache.BulkAdd during import
    (reference fragment.go:1343-1350, cache.go:136-233).
    """
    from pilosa_tpu_torch.core import cache as cache_mod

    keys, ns = write_roaring_file(frag_path, chunks)
    stats = {"containers": int(keys.size), "bits": int(ns.sum())}
    # the keys/cardinalities are in hand: emit the .occ occupancy
    # sidecar now so the FIRST open mmaps it instead of paying the
    # copy+cumsum pass (mmapstore.occupancy)
    from pilosa_tpu_torch.roaring.mmapstore import occ_arrays, write_occ_sidecar

    okeys, ocs = occ_arrays(keys.astype(np.uint64), ns.astype(np.uint32))
    write_occ_sidecar(
        frag_path + ".occ", okeys, ocs, int(keys.size),
        os.path.getsize(frag_path),
    )
    rows = (keys // np.uint64(shard_width_containers)).astype(np.uint64)
    if rows.size:
        row_idx = np.nonzero(np.concatenate(([True], np.diff(rows) > 0)))[0]
        row_ids = rows[row_idx]
        row_counts = np.add.reduceat(ns.astype(np.int64), row_idx)
        stats["rows"] = int(row_ids.size)
        if write_cache_file:
            if row_ids.size > cache_size:
                top = np.argpartition(-row_counts, cache_size)[:cache_size]
                cache_ids = np.sort(row_ids[top])
            else:
                cache_ids = row_ids
            cache_mod.write_cache(
                frag_path + ".cache", [int(r) for r in cache_ids]
            )
            stats["cached_rows"] = int(cache_ids.size)
    else:
        stats["rows"] = 0
    return stats
