"""Federated key↔id translation: partitioned durable stores + consistent
assignment across the cluster.

The port of ``pilosa_tpu/translate/translator.py``. The cluster seams
below are wired by the multi-device plane (ROADMAP A8); until then the
server leaves them None and the translator mints every key locally.

The ``Translator`` is what the server hands the executor and API layer
(duck-type compatible with ``utils/translate.TranslateStore``): the
same ``translate_columns_to_ids`` / ``translate_rows_to_ids`` /
``translate_column_to_string`` / ``translate_row_to_string`` / ``mint``
surface, backed by per-space ``SpaceStore`` logs:

    <dir>/<index>/columns.<p>.log     column keys, partition p of P
    <dir>/<index>/rows.<field>.log    row keys of one field

**Consistent assignment.** A column key's partition is
``fnv64a(key) % P`` (the ``parallel/hashing.py`` plane); each
partition — and each field's whole row space — is owned by exactly one
cluster node (``owner_resolver``, jump-hash over the member list, wired
by the server). The owner is the sole id allocator for its space:
non-owners forward minting there (``forward_to`` → ``InternalClient``
with the cluster's retry policy) and durably adopt the returned ids, so
every node agrees on key→id with NO coordinator round-trip on the read
path — reads are local-only (an unknown key resolves to id 0, which is
never minted and matches nothing).

**Replication.** Locally-minted assignments fan out through
``on_assign`` (the server broadcasts them over the existing gang
descriptor + cluster message planes); the per-store pull loop
(``stores()`` / ``read_store`` / ``apply_frames``) is the catch-up
backstop for nodes that missed a broadcast.

**Hot reverse translation.** Key bytes live on disk; id→key reads go
through a bounded LRU (``translate-cache-bytes``) with
``translate.cache_hits`` / ``translate.cache_misses`` accounting.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from pilosa_tpu_torch.parallel.hashing import fnv64a
from pilosa_tpu_torch.translate.store import SpaceStore
from pilosa_tpu_torch.utils import metrics


class _KeyLRU:
    """Bounded id→key cache; byte-costed so ``translate-cache-bytes``
    is a real ceiling, not an entry count."""

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = max(0, int(max_bytes))
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self._d: "OrderedDict[tuple, str]" = OrderedDict()
        self.mu = threading.Lock()

    @staticmethod
    def _cost(key: tuple, value: str) -> int:
        # tuple slots + string payload + dict/link overhead estimate
        return 64 + len(value) + sum(len(str(p)) for p in key)

    def get(self, key: tuple) -> Optional[str]:
        with self.mu:
            v = self._d.get(key)
            if v is None:
                self.misses += 1
                metrics.count(metrics.TRANSLATE_CACHE_MISSES)
                return None
            self._d.move_to_end(key)
            self.hits += 1
            metrics.count(metrics.TRANSLATE_CACHE_HITS)
            return v

    def put(self, key: tuple, value: str) -> None:
        if self.max_bytes <= 0:
            return
        with self.mu:
            if key in self._d:
                return
            self._d[key] = value
            self.bytes += self._cost(key, value)
            while self.bytes > self.max_bytes and self._d:
                k, v = self._d.popitem(last=False)
                self.bytes -= self._cost(k, v)

    def stats(self) -> dict:
        with self.mu:
            total = self.hits + self.misses
            return {
                "entries": len(self._d),
                "bytes": self.bytes,
                "maxBytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hitRatio": (self.hits / total) if total else None,
            }


class Translator:
    """Partitioned, federated key↔id translation store."""

    def __init__(
        self,
        path: Optional[str],
        partitions: int = 16,
        cache_bytes: int = 1 << 20,
    ) -> None:
        self.path = path
        self.partitions = max(1, int(partitions))
        self.mu = threading.RLock()
        self._stores: Dict[str, SpaceStore] = {}
        self.cache = _KeyLRU(cache_bytes)
        # server-wired seams (all optional; None = standalone):
        # owner_resolver(index, field, partition) -> owner URI, "" = self
        self.owner_resolver: Optional[Callable[[str, str, int], str]] = None
        # forward_to(owner_uri, index, field, keys) -> ids (InternalClient)
        self.forward_to: Optional[Callable[[str, str, str, list], list]] = None
        # legacy single-primary forward(index, field, keys) -> ids
        self.forward: Optional[Callable[[str, str, list], list]] = None
        # on_assign(index, field, keys, ids): locally-MINTED pairs only
        # (adopted/replicated pairs never re-broadcast)
        self.on_assign: Optional[Callable[[str, str, list, list], None]] = None
        self.forwards = 0
        self.minted = 0
        self.adopted = 0
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._open_existing()

    # -- store addressing -------------------------------------------------

    @staticmethod
    def key_partition(key: str, partitions: int) -> int:
        return fnv64a(key.encode()) % partitions

    def _column_store_name(self, index: str, p: int) -> str:
        return f"{index}/columns.{p:04d}"

    def _row_store_name(self, index: str, field: str) -> str:
        return f"{index}/rows.{field}"

    def _store_path(self, name: str) -> Optional[str]:
        return None if self.path is None else os.path.join(self.path, name + ".log")

    def _store(self, name: str) -> SpaceStore:
        with self.mu:
            st = self._stores.get(name)
            if st is not None:
                return st
            index, tail = name.split("/", 1)
            if tail.startswith("columns."):
                p = int(tail[len("columns.") :])
                st = SpaceStore(
                    self._store_path(name), index, "", self.partitions, p
                )
            else:
                field = tail[len("rows.") :]
                st = SpaceStore(self._store_path(name), index, field)
            self._stores[name] = st
            return st

    def _open_existing(self) -> None:
        assert self.path is not None
        for index in sorted(os.listdir(self.path)):
            d = os.path.join(self.path, index)
            if not os.path.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                if not fn.endswith(".log"):
                    continue
                self._store(f"{index}/{fn[:-4]}")

    # -- space grouping ---------------------------------------------------

    def _group(
        self, index: str, field: str, keys: Sequence[str]
    ) -> Dict[str, List[int]]:
        """store name -> indices into ``keys``. Row spaces are one
        store; column keys spread over the index's partitions."""
        if field:
            return {self._row_store_name(index, field): list(range(len(keys)))}
        groups: Dict[str, List[int]] = {}
        for i, k in enumerate(keys):
            p = self.key_partition(k, self.partitions)
            groups.setdefault(self._column_store_name(index, p), []).append(i)
        return groups

    def _owner(self, index: str, field: str, name: str) -> str:
        if self.owner_resolver is None:
            return ""
        if field:
            return self.owner_resolver(index, field, -1)
        p = int(name.rsplit(".", 1)[1])
        return self.owner_resolver(index, "", p)

    # -- translate interface (reference translate.go:38-48) ---------------

    def _translate(
        self,
        index: str,
        field: str,
        keys: Sequence[str],
        create: bool,
        allow_forward: bool = True,
    ) -> List[Optional[int]]:
        keys = [str(k) for k in keys]
        groups = self._group(index, field, keys)
        out: List[Optional[int]] = [None] * len(keys)
        for name, idxs in groups.items():
            st = self._store(name)
            found = st.lookup([keys[i] for i in idxs])
            misses = [i for i, v in zip(idxs, found) if v is None]
            for i, v in zip(idxs, found):
                out[i] = v
            if not create or not misses:
                continue
            miss_keys = list(dict.fromkeys(keys[i] for i in misses))
            owner = self._owner(index, field, name) if allow_forward else ""
            if owner:
                # network call outside any store lock; the owner mints
                forward = self.forward_to or (
                    lambda _uri, i_, f_, ks: self.forward(i_, f_, ks)  # noqa: E731
                    if self.forward is not None
                    else None
                )
                minted = forward(owner, index, field, miss_keys)
                if minted is None or len(minted) != len(miss_keys):
                    raise ValueError(
                        f"translate owner {owner} answered "
                        f"{0 if minted is None else len(minted)} ids for "
                        f"{len(miss_keys)} keys"
                    )
                self.forwards += 1
                metrics.count(metrics.TRANSLATE_FORWARDS)
                resolved = st.assign(miss_keys, [int(m) for m in minted])
                self.adopted += len(miss_keys)
                metrics.count(metrics.TRANSLATE_ADOPTED, len(miss_keys))
            else:
                resolved = st.assign(miss_keys)
                self.minted += len(miss_keys)
                metrics.count(metrics.TRANSLATE_MINTED, len(miss_keys))
                if self.on_assign is not None:
                    mk = list(resolved.keys())
                    self.on_assign(index, field, mk, [resolved[k] for k in mk])
            for i in misses:
                out[i] = resolved[keys[i]]
        return out

    def translate_columns_to_ids(
        self, index: str, keys: Sequence[str], create: bool = True
    ) -> List[Optional[int]]:
        return self._translate(index, "", keys, create)

    def translate_rows_to_ids(
        self, index: str, field: str, keys: Sequence[str], create: bool = True
    ) -> List[Optional[int]]:
        return self._translate(index, field, keys, create)

    def mint(self, index: str, field: str, keys: Sequence[str]) -> list:
        """Authoritative local minting — NEVER forwards. The owner's
        /internal/translate/keys endpoint must use this: a node whose
        bind address doesn't match its advertised URI would otherwise
        forward the request back to itself forever."""
        return self._translate(index, field, keys, create=True, allow_forward=False)

    def adopt(
        self, index: str, field: str, keys: Sequence[str], ids: Sequence[int]
    ) -> None:
        """Durably record assignments minted elsewhere (broadcast
        receive / replication). By-key idempotent; never re-broadcast."""
        keys = [str(k) for k in keys]
        groups = self._group(index, field, keys)
        n = 0
        for name, idxs in groups.items():
            st = self._store(name)
            st.assign([keys[i] for i in idxs], [int(ids[i]) for i in idxs])
            n += len(idxs)
        self.adopted += n
        metrics.count(metrics.TRANSLATE_ADOPTED, n)

    def misowned(self, index: str, field: str, keys: Sequence[str]) -> str:
        """URI of the first key's owner when that owner is NOT this
        node ("" = every key is locally owned). The internal mint
        endpoint 409s on a non-empty answer: minting there would fork
        the cluster id space."""
        for name in self._group(index, field, [str(k) for k in keys]):
            owner = self._owner(index, field, name)
            if owner:
                return owner
        return ""

    # -- reverse ----------------------------------------------------------

    def _reverse(self, name: str, cache_key: tuple, id_: int) -> Optional[str]:
        if id_ <= 0:
            return None
        hit = self.cache.get(cache_key)
        if hit is not None:
            return hit
        with self.mu:
            st = self._stores.get(name)
        if st is None:
            return None
        key = st.read_key(id_)
        if key is not None:
            self.cache.put(cache_key, key)
        return key

    def translate_column_to_string(self, index: str, id_: int) -> Optional[str]:
        id_ = int(id_)
        if id_ <= 0:
            return None
        p = (id_ - 1) % self.partitions
        name = self._column_store_name(index, p)
        return self._reverse(name, (index, "", id_), id_)

    def translate_row_to_string(
        self, index: str, field: str, id_: int
    ) -> Optional[str]:
        id_ = int(id_)
        name = self._row_store_name(index, field)
        return self._reverse(name, (index, field, id_), id_)

    # -- replication ------------------------------------------------------

    def stores(self) -> List[dict]:
        """Durable stores with their current byte offsets — the pull
        replication listing."""
        with self.mu:
            names = sorted(self._stores)
        return [
            {"name": n, "offset": self._stores[n].offset()} for n in names
        ]

    def read_store(self, name: str, offset: int) -> bytes:
        if "/" not in name or ".." in name or name.startswith(("/", "\\")):
            raise ValueError(f"bad translate store name: {name!r}")
        with self.mu:
            st = self._stores.get(name)
        if st is None:
            return b""
        data, _end = st.read_from(int(offset))
        return data

    def apply_frames(self, data: bytes) -> int:
        """Apply raw frames pulled from a peer: each frame's body names
        its index/field, and column keys re-partition by the SAME hash
        locally, so frames land in the right local spaces regardless of
        which store they were read from. Returns bytes consumed."""
        import zlib as _zlib

        from pilosa_tpu_torch.translate.store import _FRAME
        from pilosa_tpu_torch.utils.translate import TranslateStore as _Codec

        at = 0
        n = len(data)
        while at + _FRAME.size <= n:
            body_len, crc = _FRAME.unpack_from(data, at)
            body_at = at + _FRAME.size
            if body_at + body_len > n:
                break
            body = data[body_at : body_at + body_len]
            if _zlib.crc32(body) != crc:
                break
            try:
                got = _Codec.decode_entry(body, 0)
            except ValueError:
                break
            if got is None:
                break
            _end, index, field, pairs = got
            self.adopt(
                index,
                field,
                [key.decode() for _id, key, _rel in pairs],
                [int(_id) for _id, _key, _rel in pairs],
            )
            at = body_at + body_len
        return at

    # legacy single-stream compat (old TranslateStore surface): the
    # partitioned plane replicates per store, so the combined stream is
    # intentionally empty — callers iterate stores() instead
    def read_from(self, offset: int) -> Tuple[bytes, int]:
        return b"", 0

    def apply_log(self, data: bytes) -> int:
        return self.apply_frames(data)

    # -- introspection / lifecycle ----------------------------------------

    def rss_bytes(self) -> int:
        # dict-of-str forward maps; a rough resident estimate for
        # debug surfaces (the contract-grade accounting lives in the
        # old store's numpy tables)
        with self.mu:
            return sum(
                sum(len(k) + 96 for k in st._key_to_id) for st in self._stores.values()
            )

    def stats(self) -> dict:
        with self.mu:
            stores = {n: st.stats() for n, st in sorted(self._stores.items())}
        total_keys = sum(s["keys"] for s in stores.values())
        total_bytes = sum(s["bytes"] for s in stores.values())
        metrics.gauge(metrics.TRANSLATE_STORE_BYTES, total_bytes)
        return {
            "partitions": self.partitions,
            "stores": stores,
            "keys": total_keys,
            "bytes": total_bytes,
            "truncatedBytes": sum(s["truncatedBytes"] for s in stores.values()),
            "minted": self.minted,
            "adopted": self.adopted,
            "forwards": self.forwards,
            "cache": self.cache.stats(),
        }

    # -- backup/restore ---------------------------------------------------

    def store_files(self) -> List[Tuple[str, bytes]]:
        """(store name, raw log bytes) for every durable store — the
        backup archive's translate members."""
        out: List[Tuple[str, bytes]] = []
        for entry in self.stores():
            data, _end = self._stores[entry["name"]].read_from(0)
            out.append((entry["name"], data))
        return out

    def restore_stores(self, blobs: Dict[str, bytes]) -> int:
        """Replace this node's translate logs with the archive's
        (verified by the caller): close, rewrite, reopen. Returns the
        number of stores restored. Accepts a name→bytes mapping or the
        ``store_files()`` pair list."""
        blobs = dict(blobs)
        for name in blobs:
            if "/" not in name or ".." in name or name.startswith(("/", "\\")):
                raise ValueError(f"bad translate store name: {name!r}")
        if self.path is None:
            for name, data in blobs.items():
                self.apply_frames(data)
            return len(blobs)
        with self.mu:
            for st in self._stores.values():
                st.close()
            self._stores.clear()
            # the restored holder resolves exactly the archive's keys:
            # stale logs from the pre-restore state are dropped
            assert self.path is not None
            for root, _dirs, files in os.walk(self.path):
                for fn in files:
                    if fn.endswith(".log"):
                        os.unlink(os.path.join(root, fn))
            for name, data in blobs.items():
                path = self._store_path(name)
                assert path is not None
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
            self._open_existing()
        return len(blobs)

    def close(self) -> None:
        with self.mu:
            for st in self._stores.values():
                st.close()
            self._stores.clear()
