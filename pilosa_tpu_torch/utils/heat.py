"""Workload heat ledger (ISSUE 16) — where does load actually land?

The fleet can trace a query and attribute its latency, but nothing
records *placement*: which (index, field, shard) cells absorb the
reads, the write waves, the staging bytes. Every remaining roadmap item
that moves data around — tiered staging admission, tenant QoS, live
shard rebalancing — needs exactly that curve, so this module is the
process-global ledger behind ``GET /debug/heat``.

A cell is one (index, field, shard) triple. Each cell carries:

* raw monotone counters per dimension — ``reads`` (executor per-shard
  map legs), ``writes`` (ingest write-wave mutations applied on this
  rank), ``bytes_staged`` (device bytes uploaded for the cell),
  ``stager_hits`` / ``stager_misses``, and ``waves`` (dispatch-engine
  wave memberships). Counters are exact integers — the federated skew
  oracle in dryrun_federation.py is asserted against them.
* one EWMA ``heat`` score with half-life decay (``heat-decay-halflife``
  seconds): each read and each written bit contributes 1.0, decayed by
  ``0.5 ** (dt / halflife)`` between touches. Decay-to-now is applied
  at snapshot time, so an idle cell cools without anyone touching it.

Skew statistics are computed on read, never maintained: the snapshot
aggregates cells by (index, shard), ranks the top-K hot shards, and
reports ``imbalance_ratio = max / mean`` over the aggregated scores —
1.0 is a perfectly balanced placement, N is "one shard does N times
the mean".

Overhead contract (CI-gated like the ISSUE 12 attribution gate): the
read hook is one module-level call per shard map leg — a single
``enabled`` branch when the ledger is off, and one lock + one list
update when on; no allocation beyond the first touch of a cell. The
executor micro with the ledger enabled must stay within 5% of
disabled (tests/test_heat.py).

Federation rides the PR 9 fleet plane: every member answers
``GET /internal/fleet/heat`` with its gang-local ``[[label, snapshot],
...]`` list, and ``/debug/heat?fleet=true`` on a gang/federation
leader aggregates the whole fleet in the same two hops as the metric
scrape.
"""

from __future__ import annotations

import threading
import time

from pilosa_tpu_torch.utils import metrics

# cell value layout (a list, not a dict/dataclass: one allocation per
# cell lifetime, constant-index updates on the hot path)
_HEAT = 0  # EWMA score
_LAST = 1  # monotonic time of the last score update
_READS = 2
_WRITES = 3
_BYTES = 4
_HITS = 5
_MISSES = 6
_WAVES = 7

DIMS = ("reads", "writes", "bytes_staged", "stager_hits", "stager_misses", "waves")
_DIM_SLOT = {
    "heat": _HEAT,
    "reads": _READS,
    "writes": _WRITES,
    "bytes_staged": _BYTES,
    "stager_hits": _HITS,
    "stager_misses": _MISSES,
    "waves": _WAVES,
}


class HeatLedger:
    """Process-global per-(index, field, shard) workload heat."""

    def __init__(self, halflife: float = 300.0) -> None:
        self.enabled = True
        self.halflife = float(halflife)
        self._mu = threading.Lock()
        # (index, field, shard) -> [heat, last, reads, writes, bytes,
        # hits, misses, waves]
        self._cells: dict[tuple, list] = {}

    def configure(self, enabled: bool, halflife: float) -> None:
        self.enabled = bool(enabled)
        if halflife > 0:
            self.halflife = float(halflife)

    # -- recording (hot paths) ----------------------------------------------

    def _cell(self, key: tuple) -> list:
        c = self._cells.get(key)
        if c is None:
            c = [0.0, time.monotonic(), 0, 0, 0, 0, 0, 0]
            self._cells[key] = c
        return c

    def _bump(self, c: list, weight: float, now: float) -> None:
        dt = now - c[_LAST]
        if dt > 0.0:
            c[_HEAT] *= 0.5 ** (dt / self.halflife)
            c[_LAST] = now
        c[_HEAT] += weight

    def record_read(self, index: str, field: str, shard: int, n: int = 1) -> None:
        """One executor per-shard map leg (n legs when batched)."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._mu:
            c = self._cell((index, field, shard))
            c[_READS] += n
            self._bump(c, float(n), now)

    def record_write(self, index: str, field: str, shard: int, n: int) -> None:
        """``n`` write-wave mutations applied to the cell on this rank."""
        if not self.enabled or n <= 0:
            return
        now = time.monotonic()
        with self._mu:
            c = self._cell((index, field, shard))
            c[_WRITES] += n
            self._bump(c, float(n), now)

    def record_stage(
        self, index: str, field: str, shard: int, nbytes: int, hit: bool
    ) -> None:
        """One stager lookup for the cell: a hit costs nothing on
        device, a miss uploaded ``nbytes``. Neither moves the EWMA —
        staging traffic is a *consequence* of reads/writes, and double
        counting it would skew the placement score toward cold-start
        noise."""
        if not self.enabled:
            return
        with self._mu:
            c = self._cell((index, field, shard))
            if hit:
                c[_HITS] += 1
            else:
                c[_MISSES] += 1
                c[_BYTES] += int(nbytes)

    def record_wave(self, index: str, field: str, shard: int, n: int = 1) -> None:
        """Dispatch-engine wave membership (and fused launches riding
        a wave): ``n`` items admitted for the cell."""
        if not self.enabled:
            return
        with self._mu:
            c = self._cell((index, field, shard))
            c[_WAVES] += n

    # -- reading -------------------------------------------------------------

    def _decayed(self, c: list, now: float) -> float:
        dt = now - c[_LAST]
        if dt <= 0.0:
            return c[_HEAT]
        return c[_HEAT] * 0.5 ** (dt / self.halflife)

    def score(self, index: str, field: str, shard: int) -> float:
        """Decayed EWMA heat of one cell, 0.0 when untracked — the T1
        admission cost model reads this on every candidate, so it is
        one dict probe + one decay under the lock."""
        if not self.enabled:
            return 0.0
        now = time.monotonic()
        with self._mu:
            c = self._cells.get((index, field, shard))
            if c is None:
                return 0.0
            return self._decayed(c, now)

    def snapshot(
        self, index: str = "", dim: str = "heat", top_k: int = 10
    ) -> dict:
        """The /debug/heat body: per-cell counters + decayed scores,
        the top-K hot (index, shard) aggregates, and the imbalance
        ratio, all computed at read time. ``index`` scopes to one
        index; ``dim`` picks the ranking dimension (``heat`` — the
        decayed EWMA — or any raw counter in ``DIMS``, which makes the
        skew stats exact integers for oracle checks)."""
        slot = _DIM_SLOT.get(dim)
        if slot is None:
            raise ValueError(f"unknown heat dim: {dim!r} (want heat|{'|'.join(DIMS)})")
        now = time.monotonic()
        with self._mu:
            items = [
                (key, list(c))
                for key, c in self._cells.items()
                if not index or key[0] == index
            ]
            total = len(self._cells)
        # refreshed at read/scrape time, like the uptime gauge — the
        # record path never touches the metric registry
        metrics.gauge(metrics.HEAT_CELLS, float(total))
        cells = []
        for (idx, field, shard), c in items:
            cells.append(
                {
                    "index": idx,
                    "field": field,
                    "shard": shard,
                    "heat": round(self._decayed(c, now), 6),
                    "reads": c[_READS],
                    "writes": c[_WRITES],
                    "bytes_staged": c[_BYTES],
                    "stager_hits": c[_HITS],
                    "stager_misses": c[_MISSES],
                    "waves": c[_WAVES],
                }
            )
        return {
            "enabled": self.enabled,
            "halflife": self.halflife,
            "dim": dim,
            "cells": cells,
            "skew": compute_skew(cells, dim=dim, top_k=top_k),
        }

    def clear(self) -> None:
        with self._mu:
            self._cells.clear()


def compute_skew(cells: list[dict], dim: str = "heat", top_k: int = 10) -> dict:
    """Aggregate cell dicts by (index, shard) and report placement
    skew on ``dim``: the top-K hottest shards and max/mean imbalance.
    Module-level (not a method) so the fleet branch can run it over
    cells merged from MANY instances' snapshots."""
    if dim not in _DIM_SLOT:
        raise ValueError(f"unknown heat dim: {dim!r}")
    by_shard: dict[tuple, float] = {}
    for c in cells:
        key = (c["index"], c["shard"])
        by_shard[key] = by_shard.get(key, 0.0) + float(c.get(dim, 0.0))
    loaded = {k: v for k, v in by_shard.items() if v > 0.0}
    top = sorted(loaded.items(), key=lambda kv: (-kv[1], kv[0]))[: max(0, top_k)]
    if not loaded:
        return {"shards": 0, "top": [], "imbalance_ratio": 1.0}
    mean = sum(loaded.values()) / len(loaded)
    peak = top[0][1] if top else 0.0
    return {
        "shards": len(loaded),
        "top": [
            {"index": idx, "shard": shard, dim: round(v, 6)}
            for (idx, shard), v in top
        ],
        "imbalance_ratio": round(peak / mean, 6) if mean > 0 else 1.0,
    }


def tenant_rollup(cells: list[dict]) -> dict:
    """Aggregate cell dicts by *index* — the tenant boundary
    (server/tenancy.py). One row per tenant: decayed heat plus every
    raw counter summed over the tenant's cells, so /debug/tenancy and
    the fleet scrape answer "who is generating the load" without a
    second ledger. Module-level (like ``compute_skew``) so the fleet
    branch can run it over merged multi-instance cells."""
    out: dict[str, dict] = {}
    for c in cells:
        row = out.get(c["index"])
        if row is None:
            row = out[c["index"]] = {
                "heat": 0.0,
                "cells": 0,
                **{d: 0 for d in DIMS},
            }
        row["heat"] += float(c.get("heat", 0.0))
        row["cells"] += 1
        for d in DIMS:
            row[d] += int(c.get(d, 0))
    for row in out.values():
        row["heat"] = round(row["heat"], 6)
    return out


def merge_fleet(pairs: list, dim: str = "heat", top_k: int = 10) -> dict:
    """Fleet aggregation for ``/debug/heat?fleet=true``: ``pairs`` is
    ``[(label, snapshot), ...]`` from every reachable instance. Cells
    are summed across instances (the same cell may be hot on every
    gang rank — replay heat is real heat), then skew is recomputed
    over the merged set."""
    merged: list[dict] = []
    instances = []
    for label, snap in pairs:
        cells = snap.get("cells", []) if isinstance(snap, dict) else []
        instances.append({"instance": label, "cells": len(cells)})
        merged.extend(cells)
    return {
        "instances": instances,
        "cells": merged,
        "skew": compute_skew(merged, dim=dim, top_k=top_k),
    }


# process-global ledger, mirroring metrics.REGISTRY / events.JOURNAL
LEDGER = HeatLedger()
record_read = LEDGER.record_read
record_write = LEDGER.record_write
record_stage = LEDGER.record_stage
record_wave = LEDGER.record_wave
snapshot = LEDGER.snapshot
