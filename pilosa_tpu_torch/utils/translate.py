"""Key ↔ id translation store (reference translate.go).

A copy of ``pilosa_tpu/utils/translate.py`` (the LogEntry codec the
translate plane's logs share), with its varints from the port's own
``utils/protometa.py``.

Maps string keys to dense uint64 ids per index (columns) and per
(index, field) (rows), at north-star scale (10^8–10^9 keys) with
bounded memory:

* **Append-only binary WAL** in the reference's LogEntry wire format
  (uvarint entry length | type byte | index | field | pair count |
  (uvarint id, uvarint keylen, key bytes)* — translate.go:548-723).
  The WAL doubles as the replication stream: replicas pull raw bytes
  by offset and apply complete entries, exactly like the reference's
  primary/replica offset reader (translate.go:259-310, 902-991).
* **Key bytes never live on the heap.** Each space (index or
  index+field) keeps an open-addressing hash table in NumPy arrays —
  hash u64 / key-offset i64 / id u64, 24 bytes per slot at a 0.85
  load cap — whose entries point into the WAL; lookups confirm
  candidate slots by reading the key bytes back via pread (the
  reference mmaps and walks a robin-hood table, translate.go:733-899;
  same economics, insert-only linear probing since keys are never
  deleted).
* **Dense ids → array reverse index.** Ids are minted 1..n per space,
  so id→key is a growable int64 offset array (8 B/key), not a dict.

Batch translate calls hash and probe vectorized across the batch; the
per-key Python work is only the byte-compare on candidate hits.

Cluster semantics: exactly ONE node mints
(the translate primary); followers forward missing keys and also
receive minted pairs via WAL streaming, with by-key idempotent apply.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

LOG_ENTRY_INSERT_COLUMN = 1  # reference translate.go:22
LOG_ENTRY_INSERT_ROW = 2  # reference translate.go:23

_LOAD_FACTOR = 85  # percent, reference defaultLoadFactor=90 (translate.go:730)
_EMPTY = np.uint64(0)


# one uvarint writer for the whole codebase (protometa's; same codec
# the reference's binary.PutUvarint produces)
from pilosa_tpu_torch.utils.protometa import _write_varint as _uvarint  # noqa: E402


# one uvarint reader for the whole codebase: protometa's, which raises
# ValueError on truncation AND on overlong input (>10 bytes) — corrupt
# WAL bytes become catchable errors, never an IndexError 500
from pilosa_tpu_torch.utils.protometa import _read_varint as _read_uvarint  # noqa: E402


def _hash_key(key: bytes) -> int:
    """FNV-1a 64 (THE fnv64a from parallel/hashing.py — one
    implementation repo-wide), forced nonzero: 0 marks an empty slot
    (reference hashKey, translate.go:885-891 does the same with
    xxhash)."""
    from pilosa_tpu_torch.parallel.hashing import fnv64a

    return fnv64a(key) or 1


# keys longer than this hash via the scalar loop; the vector path pads
# a batch into an (n, maxlen) byte matrix, and one huge key must not
# turn a 10k-key batch into a multi-GB allocation
_VECTOR_HASH_MAX_LEN = 256


def _hash_keys(keys: Sequence[bytes]) -> np.ndarray:
    """Vectorized FNV-1a 64 over a batch: keys padded into a byte
    matrix, then one masked xor-multiply round per byte COLUMN — the
    whole batch hashes in max-key-length vector ops instead of
    total-bytes Python ops. Bit-identical to ``_hash_key``; keys longer
    than _VECTOR_HASH_MAX_LEN take the scalar loop so the pad matrix
    stays bounded by n × 256 bytes."""
    n = len(keys)
    out = np.zeros(n, dtype=np.uint64)
    if n == 0:
        return out
    lens = np.fromiter((len(k) for k in keys), dtype=np.int64, count=n)
    long_idx = np.nonzero(lens > _VECTOR_HASH_MAX_LEN)[0]
    for i in long_idx:
        out[i] = _hash_key(keys[i])
    short = np.nonzero(lens <= _VECTOR_HASH_MAX_LEN)[0]
    if short.size == 0:
        return out
    slens = lens[short]
    m = int(slens.max())
    buf = np.zeros((short.size, max(m, 1)), dtype=np.uint8)
    for row, i in enumerate(short):
        k = keys[i]
        if k:
            buf[row, : len(k)] = np.frombuffer(k, dtype=np.uint8)
    h = np.full(short.size, 0xCBF29CE484222325, dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    for j in range(m):
        active = slens > j
        h[active] = (h[active] ^ buf[active, j].astype(np.uint64)) * prime
    h[h == 0] = 1
    out[short] = h
    return out


class _Space:
    """One key space (columns of an index, or rows of a field):
    insert-only open-addressing table over WAL key offsets."""

    __slots__ = ("hash", "off", "ids", "n", "mask", "threshold", "by_id", "seq")

    def __init__(self, cap: int = 1024) -> None:
        self._alloc(cap)
        self.n = 0
        self.seq = 0  # last minted id (ids are 1..seq, dense)
        # id -> key offset; -1 = unassigned (0 is a VALID WAL offset)
        self.by_id = np.full(1024, -1, dtype=np.int64)

    def _alloc(self, cap: int) -> None:
        self.hash = np.zeros(cap, dtype=np.uint64)
        self.off = np.zeros(cap, dtype=np.int64)
        self.ids = np.zeros(cap, dtype=np.uint64)
        self.mask = cap - 1
        self.threshold = cap * _LOAD_FACTOR // 100

    # -- lookups ---------------------------------------------------------

    def find_batch(
        self,
        keys: Sequence[bytes],
        read_key: Callable[[int], bytes],
        h: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """ids for keys (0 = absent), probing the whole batch in
        lockstep: each round compares every still-unresolved key's
        current slot vectorized; only hash-equal candidates pay a
        byte-compare. Pass precomputed hashes ``h`` to skip rehashing
        (callers on the mint/replication paths hash once per batch)."""
        nk = len(keys)
        out = np.zeros(nk, dtype=np.uint64)
        if nk == 0 or self.n == 0:
            return out
        if h is None:
            h = _hash_keys(keys)
        pos = h & np.uint64(self.mask)
        alive = np.arange(nk)
        while alive.size:
            cur = pos[alive]
            th = self.hash[cur]
            done = th == _EMPTY  # miss: chain ended at an empty slot
            hit = th == h[alive]
            for j in np.nonzero(hit)[0]:
                if read_key(int(self.off[cur[j]])) == keys[alive[j]]:
                    out[alive[j]] = self.ids[cur[j]]
                    done[j] = True
            alive = alive[~done]
            if alive.size:
                pos[alive] = (pos[alive] + np.uint64(1)) & np.uint64(self.mask)
        return out

    def key_offset(self, id_: int) -> int:
        """WAL offset of the key for an id, or -1. An id inside 1..seq
        can still be unassigned on a follower that adopted a sparse
        forwarded subset — the -1 sentinel covers it (0 would alias the
        first WAL entry)."""
        if 1 <= id_ <= self.seq and id_ < len(self.by_id):
            return int(self.by_id[id_])
        return -1

    # -- inserts ---------------------------------------------------------

    def _ensure_by_id(self, top: int) -> None:
        if top >= len(self.by_id):
            grow = len(self.by_id)
            while top >= grow:
                grow *= 2
            nb = np.full(grow, -1, dtype=np.int64)
            nb[: len(self.by_id)] = self.by_id
            self.by_id = nb

    def insert_batch(
        self, h: np.ndarray, off: np.ndarray, ids: np.ndarray
    ) -> None:
        """Batch insert of DISTINCT absent keys: one vectorized
        parallel-probing pass (same machinery as rehash) instead of a
        Python loop per key."""
        if len(h) == 0:
            return
        while self.n + len(h) > self.threshold:
            self._grow()
        self._bulk_place(h, off, ids)
        top = int(ids.max())
        if top > self.seq:
            self.seq = top
        self._ensure_by_id(top)
        self.by_id[ids] = off

    def _grow(self) -> None:
        live = self.hash != _EMPTY
        h, off, ids = self.hash[live], self.off[live], self.ids[live]
        self._alloc(len(self.hash) * 2)
        self.n = 0  # _bulk_place re-counts the re-inserted entries
        self._bulk_place(h, off, ids)

    def _bulk_place(self, h: np.ndarray, off: np.ndarray, ids: np.ndarray) -> None:
        """Vectorized parallel linear probing for a batch of DISTINCT
        keys (rehash path): per round, each distinct probe position
        admits one key if free; everyone else advances. The no-delete
        invariant (a stored key's probe chain has no empty slots)
        holds because a passed-over slot was occupied or was claimed by
        that round's winner."""
        pending = np.arange(len(h))
        pos = (h & np.uint64(self.mask)).astype(np.int64)
        one = np.int64(1)
        while pending.size:
            p = pos[pending]
            order = np.argsort(p, kind="stable")
            ps = p[order]
            first = np.ones(ps.size, dtype=bool)
            first[1:] = ps[1:] != ps[:-1]
            winners = order[first]  # positions into `pending`
            wpos = p[winners]
            free = self.hash[wpos] == _EMPTY
            placed_rows = pending[winners[free]]
            fill = wpos[free]
            self.hash[fill] = h[placed_rows]
            self.off[fill] = off[placed_rows]
            self.ids[fill] = ids[placed_rows]
            keep = np.ones(pending.size, dtype=bool)
            keep[winners[free]] = False
            pending = pending[keep]
            if pending.size:
                pos[pending] = (pos[pending] + one) & np.int64(self.mask)
        self.n += len(h)

    def rss_bytes(self) -> int:
        return (
            self.hash.nbytes + self.off.nbytes + self.ids.nbytes + self.by_id.nbytes
        )


class TranslateStore:
    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self.mu = threading.RLock()
        # Cluster mode: exactly ONE node may mint ids (the translate
        # primary) — independent minting on every node assigns the same
        # id to different keys (observed split-brain: Row(likes="pizza")
        # returning a different user per node). Followers set this to a
        # callable forwarding (index, field, missing_keys) -> ids to the
        # primary; minted pairs also arrive via WAL replication, and
        # application by key is idempotent for that overlap.
        self.forward = None
        # read position in the PRIMARY's WAL stream (replica pull);
        # distinct from _offset, which indexes this store's own file
        self.replica_offset = 0
        self._spaces: dict[tuple[str, str], _Space] = {}
        self._offset = 0  # logical end of the local WAL
        self._log = None  # append handle
        self._read_fd: Optional[int] = None
        self._mem = bytearray()  # WAL body when path=None (tests)
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._maybe_migrate_jsonl()
            self._log = open(path, "ab")
            self._read_fd = os.open(path, os.O_RDONLY)
            self._replay()

    # -- raw WAL access --------------------------------------------------

    def _read_at(self, off: int, n: int) -> bytes:
        if self._read_fd is not None:
            return os.pread(self._read_fd, n, off)
        return bytes(self._mem[off : off + n])

    def _read_key(self, off: int) -> bytes:
        """Key bytes at a WAL offset pointing at the uvarint length
        prefix (reference lookupKey, translate.go:852-859)."""
        head = self._read_at(off, 10)
        ln, i = _read_uvarint(head, 0)
        if len(head) - i >= ln:
            return head[i : i + ln]
        return self._read_at(off + i, ln)

    def _append(self, blob: bytes) -> int:
        """Append raw bytes; returns the offset the blob landed at."""
        at = self._offset
        if self._log is not None:
            self._log.write(blob)
            self._log.flush()
        else:
            self._mem.extend(blob)
        self._offset = at + len(blob)
        return at

    # -- entry codec (reference LogEntry, translate.go:548-723) ----------

    @staticmethod
    def encode_entry(
        typ: int, index: str, field: str, ids: Sequence[int], keys: Sequence[bytes]
    ) -> bytes:
        body = bytearray()
        body.append(typ)
        ib = index.encode()
        fb = field.encode()
        _uvarint(body, len(ib))
        body.extend(ib)
        _uvarint(body, len(fb))
        body.extend(fb)
        _uvarint(body, len(ids))
        for id_, key in zip(ids, keys):
            _uvarint(body, id_)
            _uvarint(body, len(key))
            body.extend(key)
        out = bytearray()
        _uvarint(out, len(body))
        out.extend(body)
        return bytes(out)

    @staticmethod
    def decode_entry(data: bytes, at: int):
        """Pure parse of one entry starting at ``at``. Returns
        ``(end, index, field, pairs)`` where pairs are
        ``(id, key_bytes, key_rel_off)`` with ``key_rel_off`` the
        offset of the key's uvarint length prefix RELATIVE to
        ``data[0]`` — or ``None`` when the entry is incomplete.
        Raises ValueError on a structurally corrupt complete entry."""
        try:
            length, i = _read_uvarint(data, at)
        except ValueError as e:
            if "truncated" in str(e):
                return None  # incomplete: wait for more bytes
            raise  # overlong varint: corrupt entry
        end = i + length
        if end > len(data):
            return None
        try:
            typ = data[i]
            j = i + 1
            iln, j = _read_uvarint(data, j)
            index = data[j : j + iln].decode()
            j += iln
            fln, j = _read_uvarint(data, j)
            field = data[j : j + fln].decode()
            j += fln
            count, j = _read_uvarint(data, j)
            if typ == LOG_ENTRY_INSERT_COLUMN:
                field = ""
            pairs = []
            for _ in range(count):
                id_, j = _read_uvarint(data, j)
                key_rel = j  # uvarint keylen prefix position
                kln, j = _read_uvarint(data, j)
                if j + kln > end:
                    raise ValueError("key runs past entry")
                pairs.append((id_, bytes(data[j : j + kln]), key_rel))
                j += kln
        except (IndexError, UnicodeDecodeError) as e:
            raise ValueError(f"corrupt translate log entry: {e}") from e
        return end, index, field, pairs

    def _insert_pairs(self, index: str, field: str, pairs, wal_base: int) -> None:
        """Insert decoded pairs with key offsets ``wal_base + rel``;
        by-key idempotent (replica re-pull / forwarded mints arriving
        twice). One batched membership probe + one batched insert for
        the whole entry — the replay/replication hot path."""
        if not pairs:
            return
        space = self._space(index, field)
        first: dict[bytes, tuple[int, int]] = {}
        for id_, key, rel in pairs:
            if key not in first:
                first[key] = (id_, wal_base + rel)
        keys = list(first.keys())
        h = _hash_keys(keys)  # once; sliced for the insert below
        present = space.find_batch(keys, self._read_key, h=h)
        take = [i for i, v in enumerate(present) if v == 0]
        if not take:
            return
        off = np.fromiter(
            (first[keys[i]][1] for i in take), dtype=np.int64, count=len(take)
        )
        ids = np.fromiter(
            (first[keys[i]][0] for i in take), dtype=np.uint64, count=len(take)
        )
        space.insert_batch(h[take], off, ids)

    def _space(self, index: str, field: str) -> _Space:
        k = (index, field)
        sp = self._spaces.get(k)
        if sp is None:
            sp = self._spaces[k] = _Space()
        return sp

    # -- open / migrate --------------------------------------------------

    @property
    def _ckpt_path(self) -> str:
        return self.path + ".ckpt"

    def _save_checkpoint(self) -> None:
        """Persist the hash tables + WAL offset so the next open
        replays only the WAL tail — keyed warm open is O(new keys),
        not O(all keys). Atomic (tmp + rename); the WAL stays the
        source of truth, a stale/corrupt checkpoint just falls back
        to a full replay."""
        if not self.path:
            return
        import json as _json

        arrs = {"wal_offset": np.array([self._offset], dtype=np.int64)}
        names = []
        for i, ((index, field), sp) in enumerate(self._spaces.items()):
            names.append([index, field])
            arrs[f"h{i}"] = sp.hash
            arrs[f"o{i}"] = sp.off
            arrs[f"i{i}"] = sp.ids
            arrs[f"b{i}"] = sp.by_id
            arrs[f"m{i}"] = np.array([sp.n, sp.seq], dtype=np.int64)
        arrs["names"] = np.frombuffer(
            _json.dumps(names).encode(), dtype=np.uint8
        )
        tmp = self._ckpt_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)
        os.replace(tmp, self._ckpt_path)

    def _load_checkpoint(self) -> int:
        """Restore tables from the checkpoint; returns the WAL offset
        to resume replay from, or 0 (full replay) when absent/invalid."""
        import json as _json

        try:
            with np.load(self._ckpt_path, allow_pickle=False) as z:
                wal_off = int(z["wal_offset"][0])
                if wal_off > os.path.getsize(self.path):
                    return 0  # WAL shrank behind the checkpoint: distrust it
                names = _json.loads(bytes(z["names"].tobytes()).decode())
                spaces: dict[tuple[str, str], _Space] = {}
                for i, (index, field) in enumerate(names):
                    sp = _Space.__new__(_Space)
                    sp.hash = z[f"h{i}"].copy()
                    sp.off = z[f"o{i}"].copy()
                    sp.ids = z[f"i{i}"].copy()
                    sp.by_id = z[f"b{i}"].copy()
                    n, seq = (int(v) for v in z[f"m{i}"])
                    sp.n = n
                    sp.seq = seq
                    cap = len(sp.hash)
                    if cap & (cap - 1) or not cap:
                        return 0
                    sp.mask = cap - 1
                    sp.threshold = cap * _LOAD_FACTOR // 100
                    spaces[(index, field)] = sp
        except (OSError, KeyError, ValueError, IndexError):
            return 0
        self._spaces = spaces
        return wal_off

    def _replay(self) -> None:
        size = os.path.getsize(self.path)
        self._offset = 0
        chunk = 1 << 22
        buf = b""
        base = self._load_checkpoint()  # WAL offset of buf[0]
        replay_start = base
        corrupt = False
        with open(self.path, "rb") as f:
            f.seek(base)
            while not corrupt:
                more = f.read(chunk)
                buf += more
                at = 0
                while at < len(buf):
                    try:
                        got = self.decode_entry(buf, at)
                    except ValueError:
                        # corrupt complete entry: stop at the last good
                        # one, like a torn tail
                        corrupt = True
                        break
                    if got is None:
                        break  # incomplete: need more bytes (or torn tail)
                    end, index, field, pairs = got
                    self._insert_pairs(index, field, pairs, base)
                    at = end
                base += at
                buf = buf[at:]
                if not more:
                    break
        if base != size:
            # torn tail from a crashed writer: keep the valid prefix,
            # truncate the rest (reference validLogEntriesLen semantics)
            if self._log:
                self._log.truncate(base)
        self._offset = base
        if base - replay_start > (1 << 20):
            # a long tail was replayed: refresh the checkpoint so the
            # NEXT open is cheap (also written on clean close)
            self._save_checkpoint()

    def _maybe_migrate_jsonl(self) -> None:
        """Older stores wrote a JSONL WAL; rewrite it into the binary
        LogEntry format once, atomically."""
        try:
            with open(self.path, "rb") as f:
                head = f.readline(1 << 20)
        except FileNotFoundError:
            return
        if not head.startswith(b"{"):
            return
        # '{' alone is not proof: a BINARY WAL whose first entry-length
        # uvarint happens to be 0x7B ('{') would be destroyed by a
        # mistaken migration. Only migrate when the first line actually
        # parses as an older JSONL record.
        import json

        try:
            rec = json.loads(head.decode())
            if not (isinstance(rec, dict) and "id" in rec and "key" in rec):
                return
        except (ValueError, UnicodeDecodeError):
            return

        tmp = self.path + ".migrate"
        with open(self.path) as src, open(tmp, "wb") as dst:
            for line in src:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                field = e.get("field", "")
                typ = LOG_ENTRY_INSERT_ROW if field else LOG_ENTRY_INSERT_COLUMN
                dst.write(
                    self.encode_entry(
                        typ, e["index"], field, [e["id"]], [e["key"].encode()]
                    )
                )
        os.replace(tmp, self.path)

    def close(self) -> None:
        # under the lock: a concurrent writer (replication loop,
        # in-flight mint) mutating the tables while np.savez serializes
        # them would produce a checkpoint that passes validation but is
        # internally inconsistent — silently losing mappings on the
        # next open
        with self.mu:
            if self._log:
                try:
                    self._save_checkpoint()
                except OSError:
                    pass  # WAL remains the source of truth
                self._log.close()
                self._log = None
            if self._read_fd is not None:
                os.close(self._read_fd)
                self._read_fd = None

    # -- translate -------------------------------------------------------

    def _translate(
        self,
        index: str,
        field: str,
        keys: Sequence[str],
        create: bool,
        allow_forward: bool = True,
    ) -> List[Optional[int]]:
        kb = [k.encode() for k in keys]
        h_all = _hash_keys(kb)  # hashed ONCE per call, threaded through
        with self.mu:
            space = self._space(index, field)
            found = space.find_batch(kb, self._read_key, h=h_all)
        if not create:
            return [int(v) if v else None for v in found]
        # de-dup the misses, preserving order (keeping each first
        # occurrence's index so hashes can be sliced, not recomputed)
        miss_keys: list[str] = []
        miss_idx: list[int] = []
        seen = set()
        for i, v in enumerate(found):
            if v == 0 and keys[i] not in seen:
                seen.add(keys[i])
                miss_keys.append(keys[i])
                miss_idx.append(i)
        if not miss_keys:
            return [int(v) for v in found]
        h_miss = h_all[miss_idx]
        forward = self.forward if allow_forward else None
        if forward is not None:
            # network call OUTSIDE the lock; the primary mints
            minted = forward(index, field, miss_keys)
            if len(minted) != len(miss_keys):
                # a short/empty answer must fail the write loudly,
                # not silently leave keys unminted
                raise ValueError(
                    f"translate primary answered {len(minted)} ids "
                    f"for {len(miss_keys)} keys"
                )
            with self.mu:
                resolved = self._adopt(
                    index, field, miss_keys, [int(m) for m in minted], h=h_miss
                )
        else:
            with self.mu:
                resolved = self._adopt(index, field, miss_keys, None, h=h_miss)
        out: List[Optional[int]] = []
        for i, v in enumerate(found):
            out.append(int(v) if v else resolved[keys[i]])
        return out

    def _adopt(
        self,
        index: str,
        field: str,
        keys: Sequence[str],
        ids: Optional[Sequence[int]],
        h: Optional[np.ndarray] = None,
    ) -> dict[str, int]:
        """Record (key, id) pairs under the caller-held lock; returns
        key → id for every input key. ``ids=None`` mints dense ids —
        assigned AFTER the under-lock absence re-check, so a concurrent
        mint of an overlapping batch can never skip an id (the dense-id
        invariant by_id relies on). With explicit ids (primary-minted,
        arriving via forward) the primary owns density; already-present
        keys keep their existing id. One WAL entry per call; by-key
        idempotent."""
        space = self._space(index, field)
        kb = [k.encode() for k in keys]
        if h is None:
            h = _hash_keys(kb)
        fresh = space.find_batch(kb, self._read_key, h=h)
        resolved = {
            keys[i]: int(v) for i, v in enumerate(fresh) if v != 0
        }
        take = [i for i, v in enumerate(fresh) if v == 0]
        if not take:
            return resolved
        new_kb = [kb[i] for i in take]
        if ids is None:
            new_ids = [space.seq + 1 + j for j in range(len(take))]
        else:
            new_ids = [int(ids[i]) for i in take]
        typ = LOG_ENTRY_INSERT_ROW if field else LOG_ENTRY_INSERT_COLUMN
        blob = self.encode_entry(typ, index, field, new_ids, new_kb)
        at = self._append(blob)
        # insert directly: the keys are distinct and known-absent, so
        # no second membership probe; hashes are sliced from the batch
        # hash, not recomputed. Offsets come from the shared decoder —
        # one source of truth for key-offset arithmetic with the
        # replay/replication paths.
        _, _, _, pairs = self.decode_entry(blob, 0)
        space.insert_batch(
            h[take],
            np.fromiter((at + rel for _, _, rel in pairs), dtype=np.int64,
                        count=len(pairs)),
            np.asarray(new_ids, dtype=np.uint64),
        )
        for i, id_ in zip(take, new_ids):
            resolved[keys[i]] = id_
        return resolved

    # -- interface (reference translate.go:38-48) ------------------------

    def translate_columns_to_ids(
        self, index: str, keys: Sequence[str], create: bool = True
    ):
        return self._translate(index, "", keys, create)

    def translate_column_to_string(self, index: str, id_: int) -> Optional[str]:
        with self.mu:
            sp = self._spaces.get((index, ""))
            if sp is None:
                return None
            off = sp.key_offset(int(id_))
            return self._read_key(off).decode() if off >= 0 else None

    def translate_rows_to_ids(
        self, index: str, field: str, keys: Sequence[str], create: bool = True
    ):
        return self._translate(index, field, keys, create)

    def mint(self, index: str, field: str, keys: Sequence[str]) -> list:
        """Authoritative local minting — NEVER forwards. The primary's
        /internal/translate/keys endpoint must use this: a node whose
        bind address doesn't match its advertised URI would otherwise
        forward the request back to itself forever."""
        return self._translate(index, field, keys, create=True, allow_forward=False)

    def translate_row_to_string(
        self, index: str, field: str, id_: int
    ) -> Optional[str]:
        with self.mu:
            sp = self._spaces.get((index, field))
            if sp is None:
                return None
            off = sp.key_offset(int(id_))
            return self._read_key(off).decode() if off >= 0 else None

    def rss_bytes(self) -> int:
        """Resident bytes of the translation tables (the WAL stays on
        disk) — the memory-scalability contract under test."""
        with self.mu:
            return sum(sp.rss_bytes() for sp in self._spaces.values())

    # -- replication streaming (reference monitorReplication:259-310) ----

    def offset(self) -> int:
        return self._offset

    def read_from(self, offset: int) -> tuple[bytes, int]:
        """Raw WAL bytes from offset (for replica pull)."""
        if self._read_fd is None and not self._mem:
            return b"", self._offset
        end = self._offset
        if offset >= end:
            return b"", end
        data = self._read_at(offset, end - offset)
        return data, offset + len(data)

    def apply_log(self, data: bytes) -> int:
        """Apply WAL bytes pulled from a primary; returns the number of
        BYTES consumed (complete entries only — a partial trailing
        entry is left for the next pull). The replica stream has its
        own offset (``replica_offset``): the primary's file and this
        store's local WAL are different files. Entries are re-appended
        LOCALLY so replicated mappings survive a restart even when the
        primary is down; application is by-key idempotent."""
        at = 0
        with self.mu:
            while at < len(data):
                try:
                    got = self.decode_entry(data, at)
                except ValueError:
                    break  # corrupt entry: stop consuming, re-pull later
                if got is None:
                    break  # incomplete trailing entry
                end, index, field, pairs = got
                # append ONLY when the entry carries something new: a
                # replica restart re-pulls from offset 0 (replica_offset
                # is in-memory), and unconditionally re-appending would
                # grow the local WAL by a full primary copy per restart.
                # One hash + one probe decides both the append and the
                # insert (no second membership pass).
                space = self._space(index, field)
                first: dict[bytes, tuple[int, int]] = {}
                for id_, key, rel in pairs:
                    if key not in first:
                        first[key] = (id_, rel - at)
                keys = list(first.keys())
                h = _hash_keys(keys)
                present = space.find_batch(keys, self._read_key, h=h)
                take = [i for i, v in enumerate(present) if v == 0]
                if take:
                    blob = bytes(data[at:end])
                    local_at = self._append(blob)
                    off = np.fromiter(
                        (local_at + first[keys[i]][1] for i in take),
                        dtype=np.int64, count=len(take),
                    )
                    ids = np.fromiter(
                        (first[keys[i]][0] for i in take),
                        dtype=np.uint64, count=len(take),
                    )
                    space.insert_batch(h[take], off, ids)
                at = end
        return at
