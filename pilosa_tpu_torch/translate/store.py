"""Durable key↔id space store: an append-only CRC-framed fsync'd log.

One ``SpaceStore`` holds ONE key space — a column-key partition of an
index, or the row keys of one field. The on-disk format follows the
ingest plane's OP_BATCH group-commit discipline (roaring/bitmap.py):
every record is length-framed and checksummed, appends are group
committed (one fsync per ``assign`` batch, which the callers batch per
ingest wave / query resolution), and ``open()`` truncates any torn
trailing frame before replaying the intact prefix.

    frame   := u32 body_len | u32 crc32(body) | body
    body    := utils/translate LogEntry (uvarint entry length | type |
               index | field | pair count | (uvarint id, uvarint
               keylen, key bytes)*)

The body reuses the reference LogEntry codec (translate.go:548-723 via
``utils/translate.TranslateStore.encode_entry``), so frames are
self-describing: replication can ship raw frames and the receiver
routes each entry to the right local space without trusting the store
name in the URL.

Memory: the forward map (key → id) is an in-memory dict rebuilt at
open; key BYTES for the reverse direction stay on disk — ``read_key``
preads them back by the offset recorded at replay, and the hot-path
cache for that lives one level up (``translator.Translator``'s bounded
LRU).

Id assignment: ``id = ordinal * stride + lane + 1`` with a per-store
dense ordinal. A row store is ``stride=1, lane=0`` (dense 1..n, the
reference's row semantics); the P column partitions of an index use
``stride=P, lane=p``, so each partition mints from a disjoint residue
class and the union stays compact (ids ≤ n + P for n keys). Id 0 is
never minted: unknown read keys resolve to 0, which matches nothing.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from pilosa_tpu_torch.utils import metrics
from pilosa_tpu_torch.utils.translate import (
    LOG_ENTRY_INSERT_COLUMN,
    LOG_ENTRY_INSERT_ROW,
    TranslateStore as _Codec,
)

_FRAME = struct.Struct("<II")  # body length, crc32(body)


def _uvlen(n: int) -> int:
    """Byte length of n's uvarint encoding — decode_entry's ``rel``
    points at the key-LENGTH prefix; the key bytes start after it."""
    return 1 if n == 0 else (n.bit_length() + 6) // 7


class SpaceStore:
    """One durable key space: CRC-framed append-only log + in-memory
    hash. Thread-safe; the Translator serializes minting per store."""

    def __init__(
        self,
        path: Optional[str],
        index: str,
        field: str = "",
        stride: int = 1,
        lane: int = 0,
    ) -> None:
        self.path = path
        self.index = index
        self.field = field
        self.stride = max(1, int(stride))
        self.lane = int(lane) % self.stride
        self.mu = threading.RLock()
        self._key_to_id: Dict[str, int] = {}
        # id -> (absolute file offset, length) of the key bytes; in
        # memory-mode (path=None) the str itself is stored instead
        self._id_to_loc: Dict[int, Tuple[int, int]] = {}
        self._id_to_key_mem: Dict[int, str] = {}
        self._next_ordinal = 0
        self._offset = 0  # durable bytes (== file size after recovery)
        self._log = None
        self._read_fd: Optional[int] = None
        # memory-mode frame buffer: read_from must serve the same
        # framed stream either way, so replication (and tests) see one
        # contract regardless of backing
        self._mem_log: Optional[bytearray] = bytearray() if path is None else None
        self.truncated_bytes = 0  # torn tail dropped at the last open
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._recover()
            self._log = open(path, "ab")
            self._read_fd = os.open(path, os.O_RDONLY)

    # -- recovery ---------------------------------------------------------

    def _recover(self) -> None:
        """Replay intact frames; truncate the file at the first torn or
        corrupt one. Runs before the append handle opens, so a repaired
        tail can never be appended past."""
        path = self.path
        assert path is not None
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        good = self._replay(data)
        if good < len(data):
            self.truncated_bytes = len(data) - good
            metrics.count(
                metrics.TRANSLATE_RECOVERY_TRUNCATED_BYTES, self.truncated_bytes
            )
            with open(path, "r+b") as f:
                f.truncate(good)
        self._offset = good

    def _replay(self, data: bytes, base: int = 0) -> int:
        """Insert every intact frame's pairs; returns the byte length
        of the intact prefix."""
        at = 0
        n = len(data)
        while at + _FRAME.size <= n:
            body_len, crc = _FRAME.unpack_from(data, at)
            body_at = at + _FRAME.size
            if body_at + body_len > n:
                break  # torn tail: frame announced more than the file holds
            body = data[body_at : body_at + body_len]
            if zlib.crc32(body) != crc:
                break  # corrupt frame: truncate here, not a failed open
            try:
                got = _Codec.decode_entry(body, 0)
            except ValueError:
                break
            if got is None:
                break
            _end, _index, _field, pairs = got
            for id_, key, rel in pairs:
                self._insert(
                    key.decode(),
                    int(id_),
                    base + body_at + rel + _uvlen(len(key)),
                    len(key),
                )
            at = body_at + body_len
        return at

    def _insert(self, key: str, id_: int, key_off: int, key_len: int) -> None:
        """Register one (key, id) pair; first write wins (idempotent
        by key), and the ordinal high-water mark advances so a minted
        id is never reassigned — even across adopt/replay."""
        if key in self._key_to_id:
            return
        self._key_to_id[key] = id_
        if self.path is None:
            self._id_to_key_mem[id_] = key
        else:
            self._id_to_loc[id_] = (key_off, key_len)
        rel = id_ - 1 - self.lane
        if rel >= 0 and rel % self.stride == 0:
            self._next_ordinal = max(self._next_ordinal, rel // self.stride + 1)

    # -- lookups ----------------------------------------------------------

    def lookup(self, keys: Sequence[str]) -> List[Optional[int]]:
        with self.mu:
            return [self._key_to_id.get(k) for k in keys]

    def read_key(self, id_: int) -> Optional[str]:
        """Reverse translation: pread the key bytes back from the log
        (the Translator's LRU fronts this)."""
        with self.mu:
            if self.path is None:
                return self._id_to_key_mem.get(int(id_))
            loc = self._id_to_loc.get(int(id_))
            if loc is None or self._read_fd is None:
                return None
            off, ln = loc
            return os.pread(self._read_fd, ln, off).decode()

    def __len__(self) -> int:
        with self.mu:
            return len(self._key_to_id)

    def offset(self) -> int:
        with self.mu:
            return self._offset

    # -- assignment -------------------------------------------------------

    def assign(
        self, keys: Sequence[str], ids: Optional[Sequence[int]] = None
    ) -> Dict[str, int]:
        """Durably record key→id assignments: one CRC-framed append +
        ONE fsync for the whole batch (group commit). ``ids=None``
        mints fresh ids on this store's residue class — the owning
        node's sole-allocator path; explicit ids adopt another node's
        (or a replicated/forwarded) assignment. Already-present keys
        keep their existing id (by-key idempotent). Returns key → id
        for every input key."""
        with self.mu:
            resolved: Dict[str, int] = {}
            fresh_keys: List[str] = []
            fresh_ids: List[int] = []
            for i, k in enumerate(keys):
                have = self._key_to_id.get(k)
                if have is not None:
                    resolved[k] = have
                    continue
                if k in resolved:
                    continue  # duplicate within the batch
                if ids is None:
                    id_ = self._next_ordinal * self.stride + self.lane + 1
                    self._next_ordinal += 1
                else:
                    id_ = int(ids[i])
                resolved[k] = id_
                fresh_keys.append(k)
                fresh_ids.append(id_)
            if not fresh_keys:
                return resolved
            typ = LOG_ENTRY_INSERT_ROW if self.field else LOG_ENTRY_INSERT_COLUMN
            kb = [k.encode() for k in fresh_keys]
            body = _Codec.encode_entry(typ, self.index, self.field, fresh_ids, kb)
            frame = _FRAME.pack(len(body), zlib.crc32(body)) + body
            body_at = self._offset + _FRAME.size
            if self._log is not None:
                self._log.write(frame)
                self._log.flush()
                os.fsync(self._log.fileno())
            elif self._mem_log is not None:
                self._mem_log += frame
            # offsets come from the shared decoder — one source of
            # truth for key-offset arithmetic with recovery/replication
            _end, _i, _f, pairs = _Codec.decode_entry(body, 0)
            for (id_, key, rel), k in zip(pairs, fresh_keys):
                self._insert(
                    k, int(id_), body_at + rel + _uvlen(len(key)), len(key)
                )
            self._offset += len(frame)
            return resolved

    # -- replication ------------------------------------------------------

    def read_from(self, offset: int) -> Tuple[bytes, int]:
        """Raw framed bytes from ``offset`` (replica pull). Byte
        offsets are stable across restarts: the log is append-only and
        only ever truncated at its torn tail."""
        with self.mu:
            end = self._offset
            if offset >= end:
                return b"", end
            if self._read_fd is None:
                if self._mem_log is None:
                    return b"", end
                return bytes(self._mem_log[offset:end]), end
            return os.pread(self._read_fd, end - offset, offset), end

    def apply_frames(self, data: bytes) -> int:
        """Apply frames pulled from a peer's store: complete, intact
        frames only (a partial or corrupt tail is left for the next
        pull). Entries are re-appended LOCALLY so replicated mappings
        survive a restart even when the peer is down; application is
        by-key idempotent. Returns the bytes consumed."""
        at = 0
        n = len(data)
        with self.mu:
            while at + _FRAME.size <= n:
                body_len, crc = _FRAME.unpack_from(data, at)
                body_at = at + _FRAME.size
                if body_at + body_len > n:
                    break
                body = data[body_at : body_at + body_len]
                if zlib.crc32(body) != crc:
                    break
                try:
                    got = _Codec.decode_entry(body, 0)
                except ValueError:
                    break
                if got is None:
                    break
                _end, _index, _field, pairs = got
                fresh = [
                    (int(id_), key.decode())
                    for id_, key, _rel in pairs
                    if key.decode() not in self._key_to_id
                ]
                if fresh:
                    self.assign([k for _, k in fresh], [i for i, _ in fresh])
                at = body_at + body_len
        return at

    # -- lifecycle --------------------------------------------------------

    def stats(self) -> dict:
        with self.mu:
            return {
                "keys": len(self._key_to_id),
                "bytes": self._offset,
                "truncatedBytes": self.truncated_bytes,
            }

    def close(self) -> None:
        with self.mu:
            if self._log is not None:
                self._log.close()
                self._log = None
            if self._read_fd is not None:
                os.close(self._read_fd)
                self._read_fd = None
