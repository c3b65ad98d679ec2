"""Durable streaming ingest: write-ahead queue + group commit.

The interactive path mutates one bit at a time — one op-log append, one
gang broadcast, one plan-cache/stager invalidation per bit — and bulk
imports sit at the other extreme, resetting the delta log and forcing a
full re-stage. This module is the middle the roadmap called out:
streaming writes that are batched, backpressured, durable, and
recoverable.

Submitters enqueue mutations into a bounded queue (its own admission
class beside interactive/bulk — overflow is a 429 + Retry-After, never
an unbounded buffer) and block until their wave is durable. A single
committer thread coalesces the queue into **write waves**; per wave and
per touched fragment the commit is:

  * one length-framed, checksummed OP_BATCH group-commit append +
    ONE fsync to the fragment op log (roaring/bitmap.py wire format),
  * one generation bump, so the plan cache and device stager
    invalidate once and absorb the whole wave as a single coalesced
    scatter (ops/delta.py),
  * one gang descriptor (KIND_WRITE_WAVE) across the collective plane,
    so a thousand sets replay on followers as a single frame and reach
    rejoined followers through the existing anti-entropy catch-up.

The ack contract: ``submit()`` returning means the mutation's wave was
group-committed and fsynced — it survives SIGKILL (fragment ``open()``
truncates any torn trailing record and replays the intact prefix, so
every acknowledged write is recovered). A raised error means the wave
was NOT acknowledged and left no in-memory mutation (the fragment logs
before it applies), so retrying it is safe and re-logs the identical
ops; a ``DeadlineExceeded`` is the one indeterminate outcome — the
wave may still commit after the caller stopped waiting.

Staleness is bounded by the coalesce window (``ingest-wave-interval``)
plus one wave's commit latency — readers on this node see a wave the
moment it commits (same-process holder), gang followers after the
descriptor applies.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from pilosa_tpu_torch.server.deadline import DeadlineExceeded
from pilosa_tpu_torch.server.pipeline import Overloaded
from pilosa_tpu_torch.utils import events, metrics


class _Batch:
    """One submitter's mutations, acked as part of a wave."""

    __slots__ = ("index", "field", "rows", "cols", "sets", "done", "error")

    def __init__(self, index, field, rows, cols, sets) -> None:
        self.index = index
        self.field = field
        self.rows = rows
        self.cols = cols
        self.sets = sets
        self.done = threading.Event()
        self.error: Optional[BaseException] = None


class IngestQueue:
    """Bounded write-ahead queue coalescing mutations into group-committed
    write waves (one fsync + one generation bump + one gang frame per
    wave, not per bit)."""

    def __init__(
        self,
        api,
        queue_limit: int = 8192,
        wave_max: int = 2048,
        wave_interval: float = 0.002,
        retry_after: float = 0.25,
    ) -> None:
        self.api = api
        self.queue_limit = queue_limit
        self.wave_max = wave_max
        self.wave_interval = wave_interval
        self.retry_after = retry_after
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._queue: list[_Batch] = []
        self._depth = 0  # pending mutations (not batches)
        self._closed = False
        # counters for /debug/ingest (metrics carry the histories;
        # these are the cheap point-in-time snapshot)
        self._waves = 0
        self._acked = 0
        self._shed = 0
        self._nacked = 0
        self._last_wave_size = 0
        self._last_commit_seconds = 0.0
        self._thread = threading.Thread(
            target=self._run, name="ingest-committer", daemon=True
        )
        self._thread.start()

    # -- submitter side -----------------------------------------------------

    def submit(
        self, index: str, field: str, row_ids, column_ids, sets=None, deadline=None
    ) -> int:
        """Enqueue mutations and block until their wave is durable
        (group commit fsynced + gang-dispatched). Returns the number of
        acknowledged mutations. Raises ``Overloaded`` (429) when the
        queue is full, (503) when draining; re-raises the wave's commit
        error when the wave could not be made durable. ``deadline`` (a
        ``server.deadline.Deadline``) bounds the wait: when the wave
        has not committed in time, ``DeadlineExceeded`` (504) is raised
        — the write's outcome is then INDETERMINATE (its wave may still
        commit after the caller gave up), like any timed-out write."""
        rows = [int(r) for r in row_ids]
        cols = [int(c) for c in column_ids]
        if len(rows) != len(cols):
            raise ValueError("row_ids and column_ids length mismatch")
        if sets is None:
            flags = [True] * len(rows)
        else:
            flags = [bool(s) for s in sets]
            if len(flags) != len(rows):
                raise ValueError("sets length mismatch")
        if not rows:
            return 0
        n = len(rows)
        b = _Batch(index, field, rows, cols, flags)
        with self._cv:
            if deadline is not None and deadline.expired():
                raise DeadlineExceeded("ingest-admission")
            if self._closed:
                raise Overloaded("ingest queue draining", status=503)
            if self._depth + n > self.queue_limit:
                self._shed += n
                metrics.count(metrics.INGEST_SHEDS, n)
                events.record(
                    events.INGEST_SHED, index=index, field=field, n=n,
                    depth=self._depth,
                )
                # 429 (not the pipeline's queue-full 503): ingest
                # backpressure is flow control on THIS producer — back
                # off and resend; the server is not otherwise unhealthy
                raise Overloaded(
                    "ingest queue full", retry_after=self.retry_after,
                    status=429,
                )
            self._queue.append(b)
            self._depth += n
            metrics.gauge(metrics.INGEST_QUEUE_DEPTH, self._depth)
            self._cv.notify()
        if deadline is None:
            b.done.wait()
        elif not b.done.wait(timeout=max(0.0, deadline.remaining())):
            # the batch stays queued and its wave may still commit —
            # the caller's 504 means "outcome unknown", not "nacked"
            raise DeadlineExceeded(
                "ingest-commit", "ingest wave did not commit before the deadline"
            )
        if b.error is not None:
            if isinstance(b.error, OSError):
                # a storage-layer commit failure (fsync EIO, ENOSPC,
                # torn append) nacked the whole wave BEFORE apply: the
                # write did not happen, repair already re-opened the
                # log, and a retry is safe — that is a 503, not a 500
                raise Overloaded(
                    f"write wave aborted: {b.error}", status=503
                ) from b.error
            raise b.error
        return n

    # -- committer side -----------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
            # coalesce window: let concurrent submitters pile into the
            # wave before it commits (group commit amortizes the fsync)
            if self.wave_interval > 0:
                time.sleep(self.wave_interval)
            with self._cv:
                wave: list[_Batch] = []
                size = 0
                while self._queue and (not wave or size < self.wave_max):
                    b = self._queue.pop(0)
                    wave.append(b)
                    size += len(b.rows)
                self._depth -= size
            # NOTHING outside _commit_wave's own guards may kill this
            # thread: a dead committer leaves every submitter blocked
            # on done.wait() and wedges all future ingest. Unexpected
            # errors nack the wave instead.
            try:
                metrics.gauge(metrics.INGEST_QUEUE_DEPTH, self._depth)
                self._commit_wave(wave, size)
            except BaseException as e:
                for b in wave:
                    if b.error is None:
                        b.error = e
                    b.done.set()

    def _commit_wave(self, wave: list[_Batch], size: int) -> None:
        t0 = time.monotonic()
        try:
            # group by (index, field): one apply — one op-log group
            # commit per touched fragment, one generation bump, one
            # gang frame
            groups: dict[tuple[str, str], list[_Batch]] = {}
            for b in wave:
                groups.setdefault((b.index, b.field), []).append(b)
            acked = 0
            failed = 0
            for (index, field), batches in sorted(groups.items()):
                rows: list[int] = []
                cols: list[int] = []
                flags: list[bool] = []
                for b in batches:
                    rows += b.rows
                    cols += b.cols
                    flags += b.sets
                try:
                    self.api.apply_write_wave(index, field, rows, cols, flags)
                except BaseException as e:  # nack the group, keep committing
                    for b in batches:
                        b.error = e
                    failed += len(rows)
                else:
                    acked += len(rows)
            dt = time.monotonic() - t0
            with self._mu:
                self._waves += 1
                self._acked += acked
                self._nacked += failed
                self._last_wave_size = size
                self._last_commit_seconds = dt
            metrics.observe(metrics.INGEST_WAVE_SIZE, size)
            metrics.observe(metrics.INGEST_WAVE_COMMIT_SECONDS, dt)
            if acked:
                metrics.count(metrics.INGEST_ACKED, acked)
            events.record(
                events.INGEST_WAVE,
                size=size,
                groups=len(groups),
                acked=acked,
                nacked=failed,
                seconds=round(dt, 6),
            )
        except BaseException as e:
            # errors land BEFORE the finally wakes the waiters — a
            # batch whose group never applied must not read as acked
            for b in wave:
                if b.error is None:
                    b.error = e
            raise
        finally:
            # submitters block on done.wait() with no other wake-up:
            # every batch MUST resolve even when metrics/journal code
            # above raises
            for b in wave:
                b.done.set()

    # -- lifecycle / introspection ------------------------------------------

    def close(self) -> None:
        """Stop admitting, drain queued waves to durability, join."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=30.0)

    def stats(self) -> dict:
        with self._mu:
            return {
                "depth": self._depth,
                "queueLimit": self.queue_limit,
                "waveMax": self.wave_max,
                "waveIntervalSeconds": self.wave_interval,
                "waves": self._waves,
                "acked": self._acked,
                "nacked": self._nacked,
                "shed": self._shed,
                "lastWaveSize": self._last_wave_size,
                "lastCommitSeconds": self._last_commit_seconds,
                "draining": self._closed,
            }
