"""Fleet lifecycle event journal (ISSUE 10, durable since ISSUE 16) —
structured gang/federation state-machine transitions, degrades,
re-forms, and retry-exhaustion events.

Post-morteming a kill/re-form cycle used to mean scraping logs across
processes; the journal keeps the machine-readable record in-process:
every entry carries a monotonically increasing sequence number, a wall
timestamp, the event kind, and whatever identifies the actor — gang,
rank, epoch, state edge, trace id of the request that observed it.
Export: ``GET /debug/events`` and ``pilosa_tpu events``.

The ring is process-global (like the metric registry): producers call
``record()`` from any thread; a full ring drops the oldest entry.
Recording must never fail or block the caller meaningfully — one lock,
one append.

Durable backing (``open_backing``): the ring becomes a write-through
cache over segmented append-only files (``events-<firstseq>.log``
under ``journal-dir``). Each record is length-framed with an FNV-1a
checksum — the ingest op-log framing style — and written buffered +
flushed (no fsync: a SIGKILL can only tear the final frame, which the
next open detects by checksum and truncates away; an acked record
survives anything short of the kernel dying with it). Sequence numbers
resume monotonically across restart from the highest durable seq, and
retention drops whole oldest segments once the directory exceeds
``journal-max-bytes``. IO failures are counted (journal.errors) and
demote the journal to ring-only — recording still never raises.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from collections import deque
from typing import Optional

from pilosa_tpu_torch.utils import metrics, trace

# event kinds (the journal is open-ended; these are the producers wired
# in-tree — gang lifecycle edges and cross-gang RPC retry exhaustion)
GANG_TRANSITION = "gang.transition"
GANG_DEGRADE = "gang.degrade"
GANG_REFORM = "gang.reform"
CLIENT_RETRY_EXHAUSTED = "client.retry_exhausted"
# durable streaming ingest (server/ingest.py + core/fragment.py):
# write-wave group commits, queue-overflow sheds, crash-recovery
# op-log truncation at fragment open, injected storage faults
INGEST_WAVE = "ingest.wave"
INGEST_SHED = "ingest.shed"
INGEST_RECOVERY = "ingest.recovery"
INGEST_FAULT = "ingest.fault"
# performance attribution (ISSUE 12): device-telemetry watermarks,
# recompile-storm detections, SLO error-budget burns
PROFILER_HBM_WATERMARK = "profiler.hbm_watermark"
PROFILER_RECOMPILE_STORM = "profiler.recompile_storm"
SLO_BURN = "slo.burn"
# device robustness (ISSUE 14): OOM capture/recovery at the device
# boundaries, injected device faults, and chaos-window transitions
DEVICE_OOM = "device.oom"
DEVICE_OOM_RECOVERED = "device.oom_recovered"
DEVICE_FAULT = "device.fault"
CHAOS_WINDOW = "chaos.window"
# data integrity (ISSUE 15): scrub findings, quarantine/repair
# lifecycle, anti-entropy sweep failures, refused restores
SCRUB_CORRUPTION = "scrub.corruption"
SCRUB_QUARANTINE = "scrub.quarantine"
SCRUB_REPAIR = "scrub.repair"
SCRUB_UNRECOVERABLE = "scrub.unrecoverable"
ANTI_ENTROPY_ERROR = "antientropy.error"
RESTORE_REFUSED = "restore.refused"
# tiered block staging (ISSUE 17): the stage-ahead loop's first error
# per reason — the loop itself survives and counts every error
STAGER_AHEAD_ERROR = "stager.ahead_error"

# kind → one-line description; the docs/administration.md event-kind
# catalog is sync-tested against this registry both directions, so a
# new producer can't ship an undocumented kind
EVENT_KINDS: dict = {
    GANG_TRANSITION: "gang lifecycle state-machine edge (from → to)",
    GANG_DEGRADE: "gang lost a member and degraded below full strength",
    GANG_REFORM: "gang re-formed at a new epoch after a degrade",
    CLIENT_RETRY_EXHAUSTED: "cross-gang RPC gave up after all retries",
    INGEST_WAVE: "durable-ingest write wave group-committed",
    INGEST_SHED: "durable-ingest queue overflow shed a write",
    INGEST_RECOVERY: "crash recovery truncated the op log at fragment open",
    INGEST_FAULT: "injected storage fault (fault-injection harness)",
    PROFILER_HBM_WATERMARK: "device memory crossed hbm-watermark-pct of its limit",
    PROFILER_RECOMPILE_STORM: "XLA compile burst exceeded the storm window",
    SLO_BURN: "error-budget burn rate over threshold on both SLO windows",
    DEVICE_OOM: "device allocation failure caught at a kernel/fusion/batcher boundary",
    DEVICE_OOM_RECOVERED: "device OOM recovered via governor eviction + retry or CPU degrade",
    DEVICE_FAULT: "injected device fault (fault-injection harness)",
    CHAOS_WINDOW: "chaos harness fault window installed or cleared",
    SCRUB_CORRUPTION: "scrub (or open-time verification) detected fragment corruption",
    SCRUB_QUARANTINE: "corrupt fragment quarantined — reads fail 503 until repaired",
    SCRUB_REPAIR: "quarantined fragment repaired from a healthy replica",
    SCRUB_UNRECOVERABLE: "corrupt fragment has no healthy replica to repair from",
    ANTI_ENTROPY_ERROR: "anti-entropy sweep failed against a replica",
    RESTORE_REFUSED: "backup archive failed checksum verification; restore refused",
    STAGER_AHEAD_ERROR: "a stage-ahead prefetch thunk raised (first per reason)",
}


# -- durable segment framing ------------------------------------------------
#
# <u32 payload_len><u32 fnv1a(payload)><payload: compact JSON utf-8>
# — the same length + FNV-1a frame the fragment op log uses, local copy
# because roaring's checksum is a storage-layer private.

_HDR = struct.Struct("<II")
_SEG_PREFIX = "events-"
_SEG_SUFFIX = ".log"
# hard ceiling on one frame: a journal record is a small dict; anything
# larger at scan time is framing corruption, not data
_MAX_FRAME = 1 << 20


def _fnv32a(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def _seg_path(directory: str, first_seq: int) -> str:
    return os.path.join(directory, f"{_SEG_PREFIX}{first_seq:016d}{_SEG_SUFFIX}")


def _scan_segment(path: str) -> tuple[list[dict], int]:
    """Parse one segment; returns (records, clean_length). Scanning
    stops at the first short/garbled frame — everything from there on
    is the torn tail a mid-append kill leaves behind."""
    out: list[dict] = []
    clean = 0
    with open(path, "rb") as f:
        data = f.read()
    n = len(data)
    while clean + _HDR.size <= n:
        ln, crc = _HDR.unpack_from(data, clean)
        end = clean + _HDR.size + ln
        if ln > _MAX_FRAME or end > n:
            break
        payload = data[clean + _HDR.size : end]
        if _fnv32a(payload) != crc:
            break
        try:
            out.append(json.loads(payload))
        except ValueError:
            break
        clean = end
    return out, clean


class EventJournal:
    """Bounded ring of structured lifecycle events, optionally
    write-through to a segmented on-disk backing."""

    def __init__(self, ring_size: int = 256) -> None:
        self._ring: deque[dict] = deque(maxlen=ring_size)
        self._mu = threading.Lock()
        self._seq = 0
        # fleet identity stamped into every event (gang, rank) — set
        # once at server boot, like trace.TRACER.tags
        self.tags: dict = {}
        # durable backing state (open_backing); None handle = ring-only
        self._dir = ""
        self._max_bytes = 0
        self._max_age = 0.0
        self._seg_f = None
        self._seg_size = 0
        self._segments: list[tuple[str, int]] = []  # (path, bytes), oldest first
        # export tap (telemetry_export): called OUTSIDE the lock with
        # the finished record; None = disabled (zero-cost branch)
        self.on_record = None

    # -- durable backing -----------------------------------------------------

    def open_backing(
        self, directory: str, max_bytes: int, max_age: float = 0.0
    ) -> None:
        """Attach the on-disk backing: replay existing segments
        (truncating any torn tail), resume ``seq`` monotonically past
        the highest durable record, and start appending. ``max_bytes``
        <= 0 is a no-op (ring-only). Safe to call on a journal that
        already holds ring entries — like the tracer knobs, the last
        in-process server to boot owns the backing."""
        if max_bytes <= 0 or not directory:
            return
        with self._mu:
            self._close_backing_locked()
            try:
                os.makedirs(directory, exist_ok=True)
                self._dir = directory
                self._max_bytes = int(max_bytes)
                self._max_age = float(max_age)
                max_seq = 0
                self._segments = []
                for name in sorted(os.listdir(directory)):
                    if not (
                        name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)
                    ):
                        continue
                    path = os.path.join(directory, name)
                    recs, clean = _scan_segment(path)
                    if clean < os.path.getsize(path):
                        # torn tail from a mid-append kill: drop it so
                        # the append handle never writes after garbage
                        with open(path, "ab") as f:
                            f.truncate(clean)
                    for r in recs:
                        s = int(r.get("seq", 0))
                        if s > max_seq:
                            max_seq = s
                    self._segments.append((path, clean))
                self._seq = max(self._seq, max_seq)
                # resume the newest segment if it has headroom, else
                # start a fresh one at the next seq
                if self._segments and self._segments[-1][1] < self._roll_bytes():
                    path, size = self._segments.pop()
                    self._seg_f = open(path, "ab")
                    self._seg_size = size
                    self._segments.append((path, size))
                else:
                    self._open_segment_locked()
                self._prune_locked()
                self._publish_gauges_locked()
            except OSError:
                metrics.count(metrics.JOURNAL_ERRORS, op="open")
                self._close_backing_locked()

    def close_backing(self) -> None:
        with self._mu:
            self._close_backing_locked()

    @property
    def durable(self) -> bool:
        return self._seg_f is not None

    def _roll_bytes(self) -> int:
        # ~8 segments per retention budget keeps pruning granular
        return max(64 << 10, self._max_bytes // 8)

    def _close_backing_locked(self) -> None:
        if self._seg_f is not None:
            try:
                self._seg_f.close()
            except OSError:
                pass
        self._seg_f = None
        self._seg_size = 0
        self._segments = []
        self._dir = ""
        self._max_bytes = 0

    def _open_segment_locked(self) -> None:
        path = _seg_path(self._dir, self._seq + 1)
        self._seg_f = open(path, "ab")
        self._seg_size = 0
        self._segments.append((path, 0))

    def _prune_locked(self) -> None:
        """Drop whole oldest segments past the byte (and optional age)
        budget; the active segment is never dropped."""
        try:
            now = time.time()
            while len(self._segments) > 1:
                path, size = self._segments[0]
                total = sum(s for _, s in self._segments)
                over_bytes = total > self._max_bytes
                over_age = (
                    self._max_age > 0
                    and now - os.path.getmtime(path) > self._max_age
                )
                if not (over_bytes or over_age):
                    break
                os.unlink(path)
                self._segments.pop(0)
        except OSError:
            metrics.count(metrics.JOURNAL_ERRORS, op="prune")

    def _publish_gauges_locked(self) -> None:
        metrics.gauge(
            metrics.JOURNAL_BYTES, float(sum(s for _, s in self._segments))
        )
        metrics.gauge(metrics.JOURNAL_SEGMENTS, float(len(self._segments)))

    def _append_locked(self, d: dict) -> None:
        payload = json.dumps(
            d, separators=(",", ":"), sort_keys=True, default=str
        ).encode()
        frame = _HDR.pack(len(payload), _fnv32a(payload)) + payload
        self._seg_f.write(frame)
        # flush (no fsync): the record reaches the kernel, so a SIGKILL
        # cannot tear it — only a frame mid-write at the kill instant
        # is at risk, and the open-time scan truncates exactly that
        self._seg_f.flush()
        self._seg_size += len(frame)
        self._segments[-1] = (self._segments[-1][0], self._seg_size)
        if self._seg_size >= self._roll_bytes():
            self._seg_f.close()
            self._open_segment_locked()
            self._prune_locked()
        self._publish_gauges_locked()

    def _read_disk(self) -> list[dict]:
        with self._mu:
            if self._seg_f is None:
                return []
            try:
                self._seg_f.flush()
            except OSError:
                pass
            paths = [p for p, _ in self._segments]
        out: list[dict] = []
        for p in paths:
            try:
                recs, _clean = _scan_segment(p)
            except OSError:
                continue
            out.extend(recs)
        return out

    # -- recording / reading -------------------------------------------------

    def record(self, kind: str, **fields) -> dict:
        d = {"seq": 0, "t": time.time(), "kind": kind}
        if self.tags:
            d.update(self.tags)
        d.update(fields)
        ctx = trace.current_ctx()
        if ctx is not None and "trace_id" not in d:
            d["trace_id"] = ctx[0]
        with self._mu:
            self._seq += 1
            d["seq"] = self._seq
            self._ring.append(d)
            if self._seg_f is not None:
                try:
                    self._append_locked(d)
                except (OSError, ValueError):
                    # durable leg failed: demote to ring-only rather
                    # than ever raising into a producer
                    metrics.count(metrics.JOURNAL_ERRORS, op="append")
                    self._close_backing_locked()
        metrics.count(metrics.EVENTS_RECORDED, kind=kind)
        cb = self.on_record
        if cb is not None:
            cb(d)
        return d

    def snapshot(
        self, kind: Optional[str] = None, since_seq: int = 0, limit: int = 0
    ) -> list[dict]:
        """Matching entries oldest-first; a positive ``limit`` keeps only
        the newest that many after filtering. With a durable backing the
        read merges disk segments under the ring (dedup by seq), so
        ``since_seq`` pages arbitrarily far back instead of only across
        the ring's last 256 entries."""
        with self._mu:
            entries = list(self._ring)
            durable = self._seg_f is not None
        if durable:
            by_seq = {e["seq"]: e for e in self._read_disk()}
            # ring entries win: they may predate the backing, and for
            # shared seqs they're the same record
            by_seq.update({e["seq"]: e for e in entries})
            entries = [by_seq[s] for s in sorted(by_seq)]
        if kind:
            entries = [e for e in entries if e["kind"] == kind]
        if since_seq:
            entries = [e for e in entries if e["seq"] > since_seq]
        if limit > 0:
            entries = entries[-limit:]
        return entries

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()


# process-global journal, mirroring metrics.REGISTRY / trace.TRACER
JOURNAL = EventJournal()
record = JOURNAL.record
snapshot = JOURNAL.snapshot
