"""Tiered block staging — device memory oversubscribed.

Counterpart of ``pilosa_tpu/executor/tiering.py``. The stager's LRU
(executor/stager.py) is tier 0: packed words resident on the card. When
the hot set outgrows the stager's budget, every re-entry of an evicted
block costs a fragment walk (roaring → dense pack) and a 128 KiB-a-row
upload. Two layers make that cheaper:

* **Tier 1** (``Tier1Cache``) — a host-RAM cache of the *roaring
  container payloads* per (fragment, row set): the array / run / bitmap
  payloads a dense block is built from, at a fraction of its bytes. A
  tier-0 miss that hits tier 1 skips the fragment walk and rebuilds (or
  compressed-uploads) straight from the payloads. Admission is
  cost-modelled: a candidate's value is ``(1 + heat) × rebuild_cost /
  bytes`` (EWMA heat from utils/heat.py, the measured walk seconds, the
  payload bytes), and it only displaces LRU entries that score no
  better.

* **Tier 2** — the mmapped fragment itself, reached through
  ``Fragment.container_blocks``.

The compressed upload (stager ``_compressed_upload``) rides tier 1: when
the dense/payload ratio clears ``compressed_min_ratio``, the payloads
cross to the card and ``ops.expand_blocks`` (kernel K6) expands them to
packed words there.

The plan-driven ``PrefetchScheduler`` of the JAX module is not here: its
only caller is the dispatch engine's wave builder, which comes with
ROADMAP A11. ``set_governor`` mirrors the tier's bytes into an HBM
governor's host-domain tenant; it stays unused until the governor is
ported (ROADMAP A5).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from pilosa_tpu_torch import SHARD_WIDTH
from pilosa_tpu_torch.analysis.locks import OrderedLock
from pilosa_tpu_torch.utils import heat, metrics


class _T1Entry:
    __slots__ = ("entries", "nbytes", "gen", "cost", "cell")

    def __init__(self, entries, nbytes: int, gen, cost: float, cell) -> None:
        self.entries = entries  # [(row_pos, slot, typ, payload), ...]
        self.nbytes = nbytes  # payload bytes (host RAM footprint)
        self.gen = gen  # fragment generation the payloads reflect
        self.cost = cost  # measured fragment-walk seconds
        self.cell = cell  # (index, field, shard) for heat lookups


def _value(nbytes: int, cost: float, cell) -> float:
    """Admission/retention score: seconds of fragment-walk work saved
    per byte of host RAM, scaled by how hot the cell runs. The +1 keeps
    the model meaningful on an idle ledger."""
    score = heat.LEDGER.score(*cell) if cell is not None else 0.0
    return (1.0 + score) * cost / max(nbytes, 1)


class Tier1Cache:
    """Host-RAM compressed tier between the stager's device LRU and the
    mmapped fragment. Thread-safe; keys mirror the stager's
    ``(id(frag), row_ids)`` identity (no strong fragment references —
    validation gets the fragment from the caller)."""

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = int(max_bytes)
        self._mu = OrderedLock("tiering.t1_mu")
        self._cache: OrderedDict[tuple, _T1Entry] = OrderedDict()
        self._bytes = 0
        self.governor = None
        self.hits = 0
        self.misses = 0
        self.admitted = 0
        self.rejected = 0
        self.evicted = 0

    # -- internal ------------------------------------------------------------

    @staticmethod
    def _key(frag, row_ids) -> tuple:
        return (id(frag), tuple(int(r) for r in row_ids))

    def _evict_locked(self, ent: _T1Entry) -> int:
        self._bytes -= ent.nbytes
        self.evicted += 1
        metrics.count(metrics.TIER1_EVICTED)
        return ent.nbytes

    def _gauge_locked(self) -> None:
        metrics.gauge(metrics.TIER1_BYTES, self._bytes)

    # -- API -----------------------------------------------------------------

    def get(self, frag, row_ids):
        """Container payloads for ``(frag, row_ids)`` or None. A stale
        entry is revalidated through the fragment's delta log: deltas
        since the entry's generation that miss every cached row leave
        the payloads exact (generation refreshed); a truncated log or a
        delta landing in a cached row evicts."""
        key = self._key(frag, row_ids)
        with self._mu:
            ent = self._cache.get(key)
        if ent is None:
            self.misses += 1
            metrics.count(metrics.TIER1_MISSES)
            return None
        fresh_gen = None
        if frag.generation != ent.gen:
            d = frag.deltas_since(ent.gen)
            stale = d is None
            if not stale:
                pos, _is_set, fresh_gen = d
                if pos.size:
                    rows = np.unique((pos // np.uint64(SHARD_WIDTH)).astype(np.int64))
                    stale = bool(np.isin(rows, np.asarray(key[1], np.int64)).any())
            if stale:
                freed = 0
                with self._mu:
                    if self._cache.get(key) is ent:
                        del self._cache[key]
                        freed = self._evict_locked(ent)
                        self._gauge_locked()
                if freed and self.governor is not None:
                    self.governor.release("tier1", freed, index=ent.cell[0])
                self.misses += 1
                metrics.count(metrics.TIER1_MISSES)
                return None
        with self._mu:
            if self._cache.get(key) is ent:
                self._cache.move_to_end(key)
                if fresh_gen is not None:
                    ent.gen = fresh_gen
        self.hits += 1
        metrics.count(metrics.TIER1_HITS)
        return ent.entries

    def put(self, frag, row_ids, entries, nbytes: int, gen, cost: float) -> bool:
        """Offer a freshly walked payload set. Admitted when it fits,
        evicting only LRU entries whose retention score is no better
        than the candidate's; a candidate that would displace hotter
        work is rejected (TIER1_REJECTED)."""
        nbytes = int(nbytes)
        if nbytes <= 0 or nbytes > self.max_bytes:
            self.rejected += 1
            metrics.count(metrics.TIER1_REJECTED)
            return False
        cell = (frag.index, frag.field, frag.shard)
        cand = _value(nbytes, cost, cell)
        key = self._key(frag, row_ids)
        # evicted payloads credit back to the index that owned them
        freed_by: dict = {}
        with self._mu:
            old = self._cache.pop(key, None)
            if old is not None:
                n = self._evict_locked(old)
                t = old.cell[0] if old.cell else ""
                freed_by[t] = freed_by.get(t, 0) + n
            while self._bytes + nbytes > self.max_bytes:
                k, ent = next(iter(self._cache.items()))
                if _value(ent.nbytes, ent.cost, ent.cell) > cand:
                    self._gauge_locked()
                    admitted = False
                    break
                del self._cache[k]
                n = self._evict_locked(ent)
                t = ent.cell[0] if ent.cell else ""
                freed_by[t] = freed_by.get(t, 0) + n
            else:
                self._cache[key] = _T1Entry(entries, nbytes, gen, cost, cell)
                self._bytes += nbytes
                self._gauge_locked()
                admitted = True
        if admitted:
            self.admitted += 1
            metrics.count(metrics.TIER1_ADMITTED)
        else:
            self.rejected += 1
            metrics.count(metrics.TIER1_REJECTED)
        gov = self.governor
        if gov is not None:
            if admitted:
                gov.reserve("tier1", nbytes, index=cell[0])
            for t, n in freed_by.items():
                gov.release("tier1", n, index=t)
        return admitted

    def set_governor(self, governor) -> None:
        """Mirror the tier's byte ledger into a host-domain governor
        tenant (visible in the governor's stats, outside the device
        budget). Nothing in the port attaches one until ROADMAP A5."""
        self.governor = governor
        if governor is None:
            return
        governor.register("tier1", share_bytes=self.max_bytes, tier=9, domain="host")
        with self._mu:
            current = self._bytes
        if current:
            governor.reserve("tier1", current)

    def clear(self) -> None:
        with self._mu:
            freed_by: dict = {}
            for ent in self._cache.values():
                t = ent.cell[0] if ent.cell else ""
                freed_by[t] = freed_by.get(t, 0) + ent.nbytes
            self._cache.clear()
            self._bytes = 0
            self._gauge_locked()
        if self.governor is not None:
            for t, n in freed_by.items():
                self.governor.release("tier1", n, index=t)

    def stats(self) -> dict:
        with self._mu:
            n, b = len(self._cache), self._bytes
        return {
            "entries": n,
            "bytes": b,
            "max_bytes": self.max_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "evicted": self.evicted,
        }
