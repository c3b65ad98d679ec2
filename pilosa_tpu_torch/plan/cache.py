"""Generation-stamped query result cache — bounded, byte-accounted LRU.

The port of ``pilosa_tpu/plan/cache.py``.

The serving pipeline's singleflight only coalesces *concurrent*
duplicates; repeated workloads (dashboards, Zipf-skewed TopN traffic)
re-pay full executor cost on every arrival. This cache closes that gap
the way prefix/KV caches do for inference serving: results persist
across requests, and validity is *proved* rather than guessed —

* an entry is keyed by ``(index, canonical subtree hash, shard set,
  exec-option bits)`` — the index name matters: the cache is
  process-wide and generation vectors carry no index identity, so
  same-schema indexes would otherwise collide — and stamped with the
  **fragment-generation vector** observed
  before its build: one ``(field, view, shard, generation)`` entry per
  fragment that could contribute to the result;
* a lookup recomputes the current vector and serves the entry only on
  an exact match. Every write path (set/clear/bulk import/value
  import/block merge/restore) already bumps the fragment generation
  (core/fragment.py), so invalidation is free and exact — no TTL
  heuristics, no stale reads;
* the vector is captured BEFORE the build, so a write racing a build
  can only over-invalidate (the entry records a pre-write vector and
  mismatches on the next lookup), never serve post-write data as
  pre-write or vice versa.

Values are stored *encoded* (per-shard row segments for bitmap results,
scalars for Count/Sum/Min/Max, id/count pairs for TopN) and decoded
into fresh objects on every hit, so callers can mutate what they get
back (key translation, cross-shard merges) without corrupting the
cache. Builds are singleflighted per key; ``epoch_reset`` (wired to the
device-health restore path next to ``DeviceStager.reset_after_wedge``)
drops everything and fences out builders that started before the wedge.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

from pilosa_tpu_torch.analysis.locks import OrderedLock
from pilosa_tpu_torch.utils import metrics

DEFAULT_MAX_BYTES = 256 << 20


class _Entry:
    __slots__ = ("value", "nbytes", "genvec")

    def __init__(self, value, nbytes: int, genvec) -> None:
        self.value = value
        self.nbytes = nbytes
        self.genvec = genvec


# -- value codec ------------------------------------------------------------
# Encoded forms are immutable-by-convention tuples; Row segments are
# cloned INTO the cache at insert and OUT of it on every hit, so no
# live object is ever shared between the cache and a caller.


def encode_result(result) -> Optional[tuple[tuple, int]]:
    """(encoded, nbytes) or None when the result type isn't cacheable.
    nbytes is an accounting estimate (LRU budget), not an allocation."""
    from pilosa_tpu_torch.core.row import Row
    from pilosa_tpu_torch.executor.executor import ValCount

    if isinstance(result, Row):
        segs = tuple(
            (shard, seg.clone()) for shard, seg in sorted(result.segments.items())
        )
        nbytes = 128 + sum(64 + 8 * seg.count() for _, seg in segs)
        return ("row", segs), nbytes
    if isinstance(result, bool):
        return None  # write results are never cached
    if isinstance(result, int):
        return ("int", result), 64
    if isinstance(result, ValCount):
        return ("valcount", (result.val, result.count)), 64
    if result is None:
        return ("none", None), 32
    if isinstance(result, list) and all(
        isinstance(p, dict) and set(p) == {"id", "count"} for p in result
    ):
        pairs = tuple((p["id"], p["count"]) for p in result)
        return ("pairs", pairs), 64 + 16 * len(pairs)
    return None


def decode_result(enc: tuple):
    """A FRESH result object from an encoded entry."""
    from pilosa_tpu_torch.core.row import Row
    from pilosa_tpu_torch.executor.executor import ValCount

    tag, payload = enc
    if tag == "row":
        r = Row()
        for shard, seg in payload:
            r.segments[shard] = seg.clone()
        return r
    if tag == "int":
        return payload
    if tag == "valcount":
        return ValCount(payload[0], payload[1])
    if tag == "none":
        return None
    if tag == "pairs":
        return [{"id": i, "count": c} for i, c in payload]
    raise ValueError(f"unknown plan-cache entry tag: {tag!r}")


class PlanCache:
    """Process-wide result cache. One instance per server (the executor
    holds it); bare executors default to none, so tests and benches opt
    in explicitly."""

    def __init__(
        self,
        max_bytes: int = DEFAULT_MAX_BYTES,
        min_cost: float = 0.0,
    ) -> None:
        self.max_bytes = int(max_bytes)
        # builds cheaper than this (seconds) aren't stored: caching a
        # 50 us Count costs more in bookkeeping + eviction pressure
        # than it saves. 0 caches everything (the tested default).
        self.min_cost = float(min_cost)
        self._mu = OrderedLock("plancache.mu")
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._building: dict[tuple, threading.Event] = {}
        self.bytes = 0
        self.epoch = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0
        self.inserts = 0

    # -- lookups -------------------------------------------------------------

    def _lookup_locked(self, key, genvec) -> Optional[_Entry]:
        """Entry for ``key`` valid at ``genvec``, counting hit or
        invalidation; None on absence (NOT counted — probe-only callers
        must not skew the miss rate). Caller holds _mu."""
        e = self._entries.get(key)
        if e is None:
            return None
        if e.genvec != genvec:
            self._remove_locked(key, e)
            self.invalidations += 1
            metrics.count(metrics.PLANCACHE_INVALIDATIONS)
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        metrics.count(metrics.PLANCACHE_HITS)
        return e

    def contains(self, key) -> bool:
        """Presence probe WITHOUT generation validation — a cheap
        pre-filter so tree walks don't compute a generation vector per
        node. A True answer may still invalidate at lookup time."""
        with self._mu:
            return key in self._entries

    def get(self, key, genvec_fn: Callable[[], tuple]) -> Optional[Any]:
        """Probe-only lookup: decoded value on a valid hit, else None
        (no miss counted, no build). The planner uses this to feed
        already-cached subtree rows into parent ops without forcing a
        build of every unique subtree it walks."""
        if not self.contains(key):
            return None
        genvec = genvec_fn()
        with self._mu:
            e = self._lookup_locked(key, genvec)
            if e is None:
                return None
            value = e.value
        return decode_result(value)

    def get_or_build(
        self, key, genvec_fn: Callable[[], tuple], build: Callable[[], Any]
    ) -> Any:
        """Serve ``key`` from cache or build it exactly once across
        concurrent callers (singleflight). The builder's exceptions
        propagate to the leader; followers retry (and usually become
        the next leader) rather than inheriting a failure that might
        have been the leader's deadline, not theirs."""
        while True:
            genvec = genvec_fn()
            with self._mu:
                e = self._lookup_locked(key, genvec)
                if e is not None:
                    value = e.value
                    return decode_result(value)
                ev = self._building.get(key)
                if ev is None:
                    ev = self._building[key] = threading.Event()
                    leader = True
                else:
                    leader = False
            if not leader:
                ev.wait()
                continue
            try:
                epoch0 = self.epoch
                t0 = time.monotonic()
                result = build()
                cost = time.monotonic() - t0
                self._maybe_insert(key, result, genvec, cost, epoch0)
                return result
            finally:
                # miss accounting lives here, under _mu, so concurrent
                # leaders don't race the increment and a build that
                # raises still counts as a miss (it did the work)
                with self._mu:
                    self.misses += 1
                    self._building.pop(key, None)
                metrics.count(metrics.PLANCACHE_MISSES)
                ev.set()

    # -- inserts / eviction --------------------------------------------------

    def put(self, key, genvec, result, cost: float = 0.0, epoch0=None) -> None:
        """Insert a result computed OUTSIDE the singleflight (the fused
        whole-query path executes many calls in one launch, so there is
        no per-call build closure to route through ``get_or_build``).
        ``genvec`` must be the vector captured BEFORE the fused build —
        preserving the over-invalidation-only race direction documented
        in the module docstring — and ``epoch0`` the epoch observed then
        (defaults to the current epoch), so a device wedge mid-build
        fences the insert exactly as it fences ``get_or_build``'s."""
        self._maybe_insert(
            key, result, genvec, cost, self.epoch if epoch0 is None else epoch0
        )

    def _maybe_insert(self, key, result, genvec, cost: float, epoch0: int) -> None:
        if cost < self.min_cost:
            return
        enc = encode_result(result)
        if enc is None:
            return
        value, nbytes = enc
        if nbytes > self.max_bytes:
            return
        with self._mu:
            if self.epoch != epoch0:
                # an epoch reset (device wedge) happened mid-build: the
                # result may reflect pre-wedge device state — drop it
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old.nbytes
            self._entries[key] = _Entry(value, nbytes, genvec)
            self.bytes += nbytes
            self.inserts += 1
            while self.bytes > self.max_bytes and self._entries:
                k, e = self._entries.popitem(last=False)
                self.bytes -= e.nbytes
                self.evictions += 1
                metrics.count(metrics.PLANCACHE_EVICTIONS)
            metrics.gauge(metrics.PLANCACHE_BYTES, self.bytes)

    def _remove_locked(self, key, e: _Entry) -> None:
        del self._entries[key]
        self.bytes -= e.nbytes
        metrics.gauge(metrics.PLANCACHE_BYTES, self.bytes)

    # -- lifecycle -----------------------------------------------------------

    def epoch_reset(self) -> None:
        """Drop everything and fence out in-flight builders. Wired next
        to ``DeviceStager.reset_after_wedge`` (executor device-health
        restore) — results computed by a wedged accelerator must not
        outlive it — and to the recalculate-caches admin op, whose rank
        reorders can change TopN candidate walks without a generation
        bump."""
        with self._mu:
            self._entries.clear()
            self.bytes = 0
            self.epoch += 1
            metrics.gauge(metrics.PLANCACHE_BYTES, 0)

    def stats(self) -> dict:
        """The /debug/plancache snapshot."""
        with self._mu:
            total = self.hits + self.misses
            return {
                "enabled": True,
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "min_cost": self.min_cost,
                "hits": self.hits,
                "misses": self.misses,
                "hit_ratio": round(self.hits / total, 4) if total else None,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "inserts": self.inserts,
                "building": len(self._building),
                "epoch": self.epoch,
            }


class DevicePlanCache:
    """HBM-resident companion to PlanCache for bitmap-valued subtrees:
    entries hold the packed u32[S, W] device stack a ``__cached``
    placeholder lowers to, so a plan-cache hit on the device path stops
    round-tripping through host Row decode + re-pack + re-upload
    (``executor._cached_words`` per shard) — the device re-ingesting
    what it just produced.

    Same validity model as PlanCache — generation-vector stamped at
    insert, exact-match validated at lookup, so every write path
    invalidates for free — but byte-accounted against a dedicated HBM
    budget (``plan-cache-device-bytes``) with LRU eviction: device
    memory is the scarcer resource and is shared with the staging
    cache. ``epoch_reset`` is wired to the device-health restore next
    to ``DeviceStager.reset_after_wedge``: arrays produced by a wedged
    runtime must not outlive it. Values are immutable by contract: each
    is its own storage (never a view of a stager entry, which a word-delta
    refresh may patch in place) and nothing writes it, so hits return the
    resident tensor without a copy."""

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = int(max_bytes)
        self._mu = OrderedLock("plancache.device_mu")
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self.bytes = 0
        self.epoch = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0
        self.inserts = 0
        # process-wide HBM governor (executor/hbm.py): when attached,
        # max_bytes becomes this cache's tenant SHARE of the global
        # ledger and the cache is the FIRST relief tier — pure derived
        # state, cheapest thing on the chip to rebuild
        self.governor = None

    def set_governor(self, governor) -> None:
        self.governor = governor
        if governor is None:
            return
        governor.register(
            "device_cache",
            share_bytes=self.max_bytes,
            evict_fn=self._evict_lru,
            tier=0,
        )
        with self._mu:
            current = self.bytes
        if current:
            governor.reserve("device_cache", current)

    @staticmethod
    def _index_of(key) -> str:
        """The tenant index a cache key belongs to — device-cache keys
        are ``(index, subtree_hash, shards)`` (executor.py), so the
        first element is the attribution handle for per-tenant HBM
        quotas. Defensive for non-conforming keys (direct tests)."""
        if isinstance(key, tuple) and key and isinstance(key[0], str):
            return key[0]
        return ""

    def _evict_lru(self, need: int, prefer=None) -> int:
        """Governor relief tier 0: drop LRU entries until ``need``
        bytes are freed. Called WITHOUT the governor lock held.

        ``prefer`` narrows eviction to the listed tenant indexes
        (quota enforcement: an over-quota tenant sheds only its own
        plans); None keeps the classic global LRU sweep."""
        freed = 0
        freed_by: dict = {}
        with self._mu:
            if prefer is not None:
                want = set(prefer)
                victims = [
                    k for k in self._entries if self._index_of(k) in want
                ]
                for k in victims:
                    if freed >= need:
                        break
                    e = self._entries.pop(k)
                    self.bytes -= e.nbytes
                    freed += e.nbytes
                    freed_by[self._index_of(k)] = (
                        freed_by.get(self._index_of(k), 0) + e.nbytes
                    )
                    self.evictions += 1
                    metrics.count(metrics.PLANCACHE_DEVICE_EVICTIONS)
            else:
                while freed < need and self._entries:
                    k, e = self._entries.popitem(last=False)
                    self.bytes -= e.nbytes
                    freed += e.nbytes
                    idx = self._index_of(k)
                    freed_by[idx] = freed_by.get(idx, 0) + e.nbytes
                    self.evictions += 1
                    metrics.count(metrics.PLANCACHE_DEVICE_EVICTIONS)
            if freed:
                metrics.gauge(metrics.PLANCACHE_DEVICE_BYTES, self.bytes)
        if freed and self.governor is not None:
            for idx, n in freed_by.items():
                self.governor.release("device_cache", n, index=idx)
        return freed

    def get(self, key, genvec_fn: Callable[[], tuple]):
        """The resident device array for ``key`` valid at the CURRENT
        generation vector, or None (miss / invalidated). Probe-and-pack
        is the caller's job — uploads are too heavyweight to
        singleflight here, and concurrent misses for one key just
        upload the same immutable content twice."""
        genvec = genvec_fn()
        freed = 0
        try:
            with self._mu:
                e = self._entries.get(key)
                if e is None:
                    self.misses += 1
                    return None
                if e.genvec != genvec:
                    del self._entries[key]
                    self.bytes -= e.nbytes
                    freed = e.nbytes
                    self.invalidations += 1
                    self.misses += 1
                    metrics.count(metrics.PLANCACHE_INVALIDATIONS)
                    metrics.gauge(metrics.PLANCACHE_DEVICE_BYTES, self.bytes)
                    return None
                self._entries.move_to_end(key)
                self.hits += 1
                metrics.count(metrics.PLANCACHE_DEVICE_HITS)
                return e.value
        finally:
            if freed and self.governor is not None:
                self.governor.release(
                    "device_cache", freed, index=self._index_of(key)
                )

    def put(self, key, genvec, value, nbytes: int, epoch0=None) -> None:
        """Insert a device array stamped with the generation vector
        captured BEFORE its content was materialized (same race
        direction as PlanCache: a write racing the pack can only
        over-invalidate). ``epoch0`` fences inserts built before a
        device wedge."""
        nbytes = int(nbytes)
        if nbytes > self.max_bytes:
            return
        # reserve OUTSIDE _mu: the governor's relief sweep may evict
        # cold stager blocks, and those callbacks take the stager lock
        # (lock order: tenant lock → governor lock, never the reverse)
        gov = self.governor
        tenant = self._index_of(key)
        if gov is not None:
            gov.reserve("device_cache", nbytes, index=tenant)
        # per-tenant return ledger: evicted entries credit back to the
        # index that owned them, not the inserting tenant
        gov_return: dict = {}
        returned = 0
        with self._mu:
            if epoch0 is not None and self.epoch != epoch0:
                gov_return[tenant] = nbytes
            else:
                old = self._entries.pop(key, None)
                if old is not None:
                    self.bytes -= old.nbytes
                    gov_return[tenant] = gov_return.get(tenant, 0) + old.nbytes
                    returned += old.nbytes
                self._entries[key] = _Entry(value, nbytes, genvec)
                self.bytes += nbytes
                self.inserts += 1
                while (
                    self.bytes > self.max_bytes
                    or (gov is not None and gov.over_budget() > returned)
                ) and self._entries:
                    k, e = self._entries.popitem(last=False)
                    self.bytes -= e.nbytes
                    idx = self._index_of(k)
                    gov_return[idx] = gov_return.get(idx, 0) + e.nbytes
                    returned += e.nbytes
                    self.evictions += 1
                    metrics.count(metrics.PLANCACHE_DEVICE_EVICTIONS)
                metrics.gauge(metrics.PLANCACHE_DEVICE_BYTES, self.bytes)
        if gov is not None:
            for idx, n in gov_return.items():
                gov.release("device_cache", n, index=idx)

    def epoch_reset(self) -> None:
        """Drop every resident array and fence out packs that started
        before the wedge (their epoch0 no longer matches)."""
        with self._mu:
            self._entries.clear()
            self.bytes = 0
            self.epoch += 1
            metrics.gauge(metrics.PLANCACHE_DEVICE_BYTES, 0)
        # the epoch fence extends to the governor ledger
        if self.governor is not None:
            self.governor.reset("device_cache")

    def stats(self) -> dict:
        """Merged into the /debug/fusion snapshot."""
        with self._mu:
            total = self.hits + self.misses
            return {
                "enabled": True,
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_ratio": round(self.hits / total, 4) if total else None,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "inserts": self.inserts,
                "epoch": self.epoch,
            }
