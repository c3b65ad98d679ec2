"""Telemetry export pipeline — push the process's story out before the
process dies with it.

The port of ``pilosa_tpu/utils/telemetry_export.py``. Every other signal
leaves the node by pull: Prometheus scrapes /metrics, an operator curls
/debug/traces. This module is the push side: a single
:class:`BatchingExporter` fans journal events, completed trace spans,
and periodic metric snapshots out to pluggable sinks — a JSONL file
(ship it with any log collector) and an OTLP-compatible HTTP/JSON
endpoint (stdlib urllib only; no new dependencies).

Hot-path contract: producers reach the exporter only through the
``on_record`` / ``on_export`` taps on the journal and tracer, which
are ``None`` unless exporting is configured — the disabled path is one
attribute load + one ``is not None`` branch, zero allocations. When
enabled, ``enqueue`` is one lock + one deque append; a full queue
DROPS the record and counts it (export.dropped) — telemetry must never
apply backpressure to the thing it observes.

Delivery is at-most-once by design: batches that fail a sink write are
dropped and counted (export.errors). The durable journal (events.py)
is the at-least-once story; the exporter is the live feed.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import deque
from typing import Optional

from pilosa_tpu_torch.utils import metrics

# record streams (the "stream" label on export metrics)
STREAM_EVENTS = "events"
STREAM_SPANS = "spans"
STREAM_METRICS = "metrics"


class JsonlFileSink:
    """One JSON object per line: ``{"stream": ..., "t": ..., "record":
    ...}``. Append-only, flushed per batch — a collector can tail it."""

    name = "jsonl"

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "a", encoding="utf-8")

    def write_batch(self, batch: list[dict]) -> None:
        for rec in batch:
            self._f.write(json.dumps(rec, separators=(",", ":"), default=str))
            self._f.write("\n")
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


class OtlpHttpSink:
    """OTLP/HTTP JSON shape, stdlib only. Spans post to ``<url>/v1/traces``
    as resourceSpans, journal events to ``<url>/v1/logs`` as logRecords,
    and metric snapshots to ``<url>/v1/metrics`` as gauge datapoints.
    A full OTLP encoder needs the protobuf schema; this sink emits the
    JSON mapping's subset that collectors accept on the OTLP/HTTP JSON
    listener."""

    name = "otlp"

    def __init__(self, url: str, timeout: float = 5.0, service: str = "pilosa_tpu_torch"):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self._resource = {
            "attributes": [
                {"key": "service.name", "value": {"stringValue": service}}
            ]
        }

    @staticmethod
    def _attrs(d: dict) -> list[dict]:
        out = []
        for k, v in d.items():
            if isinstance(v, bool):
                val = {"boolValue": v}
            elif isinstance(v, int):
                val = {"intValue": str(v)}
            elif isinstance(v, float):
                val = {"doubleValue": v}
            else:
                val = {"stringValue": str(v)}
            out.append({"key": str(k), "value": val})
        return out

    def _post(self, path: str, body: dict) -> None:
        req = urllib.request.Request(
            self.url + path,
            data=json.dumps(body, default=str).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout):
            pass

    def _span_records(self, spans: list[dict]) -> list[dict]:
        """``spans`` are enqueue wrappers {stream, t, record}; record is
        the ring's root-span dict (relative start_ms/duration_ms), so
        wall times anchor on the enqueue timestamp — completed spans
        enqueue at completion, making the skew the tap latency."""
        out = []
        for w in spans:
            s = w["record"]
            dur = (s.get("duration_ms") or 0.0) / 1000.0
            end = w["t"]
            out.append(
                {
                    "traceId": (s.get("trace_id") or "").replace("-", "")[:32],
                    "spanId": (s.get("span_id") or "")[:16],
                    "name": s.get("name", ""),
                    "startTimeUnixNano": str(int((end - dur) * 1e9)),
                    "endTimeUnixNano": str(int(end * 1e9)),
                    "attributes": self._attrs(s.get("meta", {}) or {}),
                }
            )
        return out

    def write_batch(self, batch: list[dict]) -> None:
        spans = [r for r in batch if r["stream"] == STREAM_SPANS]
        events = [r for r in batch if r["stream"] == STREAM_EVENTS]
        snaps = [r for r in batch if r["stream"] == STREAM_METRICS]
        if spans:
            self._post(
                "/v1/traces",
                {
                    "resourceSpans": [
                        {
                            "resource": self._resource,
                            "scopeSpans": [
                                {"spans": self._span_records(spans)}
                            ],
                        }
                    ]
                },
            )
        if events:
            self._post(
                "/v1/logs",
                {
                    "resourceLogs": [
                        {
                            "resource": self._resource,
                            "scopeLogs": [
                                {
                                    "logRecords": [
                                        {
                                            "timeUnixNano": str(
                                                int(r["record"].get("t", 0) * 1e9)
                                            ),
                                            "body": {
                                                "stringValue": r["record"].get(
                                                    "kind", ""
                                                )
                                            },
                                            "attributes": self._attrs(r["record"]),
                                        }
                                        for r in events
                                    ]
                                }
                            ],
                        }
                    ]
                },
            )
        if snaps:
            gauges = []
            for r in snaps:
                ts = str(int(r["t"] * 1e9))
                for key, val in r["record"].items():
                    if not isinstance(val, (int, float)) or isinstance(val, bool):
                        continue
                    gauges.append(
                        {
                            "name": key,
                            "gauge": {
                                "dataPoints": [
                                    {"timeUnixNano": ts, "asDouble": float(val)}
                                ]
                            },
                        }
                    )
            self._post(
                "/v1/metrics",
                {
                    "resourceMetrics": [
                        {
                            "resource": self._resource,
                            "scopeMetrics": [{"metrics": gauges}],
                        }
                    ]
                },
            )

    def close(self) -> None:
        pass


class BatchingExporter:
    """Bounded-queue batching fan-out to one or more sinks.

    ``enqueue`` never blocks: a full queue drops the record and bumps
    export.dropped. A daemon loop flushes every ``interval`` seconds
    (and on ``close``); when a ``metrics_fn`` is given, each flush also
    samples one metric snapshot into the batch, giving crashed-node
    forensics a trailing metrics feed without a scrape target."""

    def __init__(
        self,
        sinks: list,
        queue_max: int = 1024,
        interval: float = 5.0,
        metrics_fn=None,
    ) -> None:
        self.sinks = list(sinks)
        self.queue_max = int(queue_max)
        self.interval = float(interval)
        self.metrics_fn = metrics_fn
        self._q: deque[dict] = deque()
        self._mu = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.enqueued = 0
        self.dropped = 0
        self.flushed = 0

    # -- producer side -------------------------------------------------------

    def enqueue(self, stream: str, record: dict) -> bool:
        with self._mu:
            if len(self._q) >= self.queue_max:
                self.dropped += 1
                metrics.count(metrics.EXPORT_DROPPED, stream=stream)
                return False
            self._q.append({"stream": stream, "t": time.time(), "record": record})
            self.enqueued += 1
        metrics.count(metrics.EXPORT_ENQUEUED, stream=stream)
        return True

    # journal/tracer tap shapes
    def tap_event(self, d: dict) -> None:
        self.enqueue(STREAM_EVENTS, d)

    def tap_span(self, d: dict) -> None:
        self.enqueue(STREAM_SPANS, d)

    # -- flush side ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="telemetry-export", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval)
            self._wake.clear()
            self.flush()

    def flush(self) -> int:
        """Drain the queue into one batch per sink; returns records
        shipped. Sink failures drop the batch for that sink only."""
        if self.metrics_fn is not None:
            try:
                self.enqueue(STREAM_METRICS, self.metrics_fn())
            except Exception:
                pass
        with self._mu:
            if not self._q:
                return 0
            batch = list(self._q)
            self._q.clear()
        for sink in self.sinks:
            try:
                sink.write_batch(batch)
                metrics.count(metrics.EXPORT_FLUSHES, sink=sink.name)
            except Exception:
                metrics.count(metrics.EXPORT_ERRORS, sink=sink.name)
        with self._mu:
            self.flushed += len(batch)
        return len(batch)

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        self.flush()
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:
                pass

    def stats(self) -> dict:
        with self._mu:
            return {
                "enqueued": self.enqueued,
                "dropped": self.dropped,
                "flushed": self.flushed,
                "queued": len(self._q),
                "sinks": [s.name for s in self.sinks],
                "interval": self.interval,
                "queue_max": self.queue_max,
            }


def build_exporter(
    path: str = "",
    url: str = "",
    queue_max: int = 1024,
    interval: float = 5.0,
    metrics_fn=None,
) -> Optional[BatchingExporter]:
    """Config-driven constructor: returns None (exporting off, taps
    stay unset) unless at least one sink is configured."""
    sinks: list = []
    if path:
        sinks.append(JsonlFileSink(path))
    if url:
        sinks.append(OtlpHttpSink(url))
    if not sinks:
        return None
    return BatchingExporter(
        sinks, queue_max=queue_max, interval=interval, metrics_fn=metrics_fn
    )
