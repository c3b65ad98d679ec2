"""Always-on performance attribution: waterfall aggregation, device
memory telemetry, compile tracking, and a continuous thread-stack
sampler. The port of ``pilosa_tpu/utils/profiler.py``.

Every component here is cheap enough to leave running, bounded in
memory, and safe on any backend: absence of a device API degrades to
"no samples", never an error.

Four components, all process-global singletons mirroring
``metrics.REGISTRY`` / ``events.JOURNAL``:

* ``WATERFALL`` — aggregates per-query waterfall dicts (built by the
  ``trace.attrib_*`` layer) into per-class/per-stage summaries, a ring
  of recent waterfalls for ``/debug/latency``, and the live
  ``executor.rtt_fraction`` EMA gauge.
* ``COMPILES`` — counts compiles and compile-seconds per signature
  (bounded), detecting recompile storms.
* ``SAMPLER`` — the continuous profiler: samples every thread's stack
  at a configurable Hz into a bounded top-frames table.
* ``TELEMETRY`` — publishes the stager's share of the device budget;
  its device-memory gauges wait for ROADMAP A7, as does the on-demand
  profile capture (``capture_status`` reports none running).
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Optional

from pilosa_tpu_torch.utils import events, metrics, trace


def _current_frames():  # patch point for tests
    return sys._current_frames()


# -- waterfall aggregation ----------------------------------------------------


class WaterfallAggregator:
    """Fold per-query attribution dicts into the metric registry and a
    bounded ring of recent waterfalls.

    ``record()`` runs once per served query on the HTTP handler thread
    after the response is built — a handful of metric observes and one
    deque append."""

    # buckets that count as device-side for rtt_fraction
    DEVICE_STAGES = (trace.WF_DEVICE_COMPUTE, trace.WF_TRANSFER_DECODE)

    def __init__(self, ring_size: int = 64, ema_alpha: float = 0.1) -> None:
        self._ring: deque[dict] = deque(maxlen=ring_size)
        self._mu = threading.Lock()
        self.ema_alpha = ema_alpha
        self._rtt_ema: Optional[float] = None
        self.recorded = 0
        # per-tenant waterfall rollup (tenant = index, server/tenancy.py):
        # stage-ms sums + query count per tenant, read by /debug/tenancy
        # and the fleet scrape — who spends their latency where
        self._by_tenant: dict[str, dict] = {}

    @staticmethod
    def summarize(stages: dict, total_s: float) -> dict:
        """One waterfall dict → the response/ring form: per-stage ms in
        taxonomy order, the synthetic ``other`` remainder, total, and
        the device+transfer share."""
        out_stages: dict = {}
        measured = 0.0
        device = 0.0
        for name in trace.WATERFALL_STAGES:
            if name == trace.WF_OTHER:
                continue
            v = stages.get(name, 0.0)
            if v <= 0.0:
                continue
            out_stages[name] = round(v * 1000.0, 3)
            measured += v
            if name in WaterfallAggregator.DEVICE_STAGES:
                device += v
        other = max(0.0, total_s - measured)
        if other > 0.0:
            out_stages[trace.WF_OTHER] = round(other * 1000.0, 3)
        frac = min(1.0, device / total_s) if total_s > 0.0 else 0.0
        out = {
            "total_ms": round(total_s * 1000.0, 3),
            "stages": out_stages,
            "rtt_fraction": round(frac, 4),
        }
        wave = stages.get("_wave")
        if wave:
            out["wave"] = wave
        return out

    def record(
        self,
        cls: str,
        total_s: float,
        stages: Optional[dict],
        tenant: str = "",
    ) -> Optional[dict]:
        """Aggregate one served query from a raw attribution dict;
        returns the summary (also appended to the ring), or None when no
        attribution ran."""
        if stages is None:
            return None
        return self.record_summary(cls, self.summarize(stages, total_s), tenant=tenant)

    def record_summary(self, cls: str, summary: dict, tenant: str = "") -> dict:
        """Aggregate an already-summarized waterfall (the form api.query
        attaches to the response as ``_waterfall``). ``tenant`` (the
        query's index) additionally folds the waterfall into the
        per-tenant rollup and the tenant-labelled stage summary."""
        for name, ms in summary["stages"].items():
            metrics.observe(
                metrics.LATENCY_STAGE_SECONDS, ms / 1000.0, cls=cls, stage=name
            )
            if tenant:
                metrics.observe(
                    metrics.TENANT_STAGE_SECONDS,
                    ms / 1000.0,
                    tenant=tenant,
                    stage=name,
                )
        frac = summary["rtt_fraction"]
        with self._mu:
            self._rtt_ema = (
                frac
                if self._rtt_ema is None
                else self._rtt_ema + self.ema_alpha * (frac - self._rtt_ema)
            )
            ema = self._rtt_ema
            entry = {"cls": cls, **summary}
            if tenant:
                entry["tenant"] = tenant
                row = self._by_tenant.get(tenant)
                if row is None:
                    row = self._by_tenant[tenant] = {
                        "queries": 0,
                        "total_ms": 0.0,
                        "stages": {},
                    }
                row["queries"] += 1
                row["total_ms"] += summary["total_ms"]
                for name, ms in summary["stages"].items():
                    row["stages"][name] = row["stages"].get(name, 0.0) + ms
            self._ring.append(entry)
            self.recorded += 1
        metrics.gauge(metrics.EXECUTOR_RTT_FRACTION, round(ema, 4))
        return summary

    def tenant_waterfalls(self) -> dict:
        """{tenant: {queries, total_ms, stages: {stage: ms}}} — the
        per-tenant latency waterfall rollup for /debug/tenancy."""
        with self._mu:
            return {
                t: {
                    "queries": row["queries"],
                    "total_ms": round(row["total_ms"], 3),
                    "stages": {n: round(v, 3) for n, v in row["stages"].items()},
                }
                for t, row in self._by_tenant.items()
            }

    def rtt_fraction(self) -> Optional[float]:
        with self._mu:
            return self._rtt_ema

    def snapshot(self, limit: int = 0) -> dict:
        with self._mu:
            recent = list(self._ring)
            ema = self._rtt_ema
        if limit > 0:
            recent = recent[-limit:]
        return {
            "stages": {n: trace.WATERFALL[n] for n in trace.WATERFALL_STAGES},
            "rtt_fraction": None if ema is None else round(ema, 4),
            "recorded": self.recorded,
            "recent": recent,
        }

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()
            self._rtt_ema = None
            self.recorded = 0
            self._by_tenant.clear()


# -- XLA compile tracking -----------------------------------------------------


class CompileTracker:
    """Per-canonical-plan-signature compile counts and compile-seconds,
    observed at the jit entry points (``executor._timed_kernel`` calls
    ``note()`` on every cold invocation). Bounded: beyond ``max_sigs``
    distinct signatures, new ones fold into an overflow row. A burst of
    ``storm_threshold`` compiles inside ``storm_window_s`` journals one
    ``profiler.recompile_storm`` event (edge-triggered — the storm must
    quiesce before it can fire again)."""

    def __init__(
        self,
        max_sigs: int = 256,
        storm_threshold: int = 8,
        storm_window_s: float = 30.0,
    ) -> None:
        self.max_sigs = max_sigs
        self.storm_threshold = storm_threshold
        self.storm_window_s = storm_window_s
        self._mu = threading.Lock()
        # sig key -> {"kind", "compiles", "seconds", "last_t"}
        self._sigs: dict = {}
        self._recent: deque[float] = deque()
        self._in_storm = False
        self.total_compiles = 0
        self.total_seconds = 0.0
        self.storms = 0

    def note(self, kind: str, signature: Optional[object], seconds: float) -> None:
        """Record one compile of ``kind`` for ``signature``."""
        metrics.count(metrics.PROFILER_COMPILES, kind=kind)
        key = f"{kind}:{signature!r}" if signature is not None else kind
        now = time.monotonic()
        storm = False
        with self._mu:
            self.total_compiles += 1
            self.total_seconds += seconds
            row = self._sigs.get(key)
            if row is None:
                if len(self._sigs) >= self.max_sigs:
                    key = "(overflow)"
                    row = self._sigs.get(key)
                if row is None:
                    row = self._sigs[key] = {
                        "kind": kind,
                        "compiles": 0,
                        "seconds": 0.0,
                        "last_t": 0.0,
                    }
            row["compiles"] += 1
            row["seconds"] = round(row["seconds"] + seconds, 6)
            row["last_t"] = time.time()
            self._recent.append(now)
            horizon = now - self.storm_window_s
            while self._recent and self._recent[0] < horizon:
                self._recent.popleft()
            if len(self._recent) >= self.storm_threshold:
                if not self._in_storm:
                    self._in_storm = True
                    self.storms += 1
                    storm = True
            else:
                self._in_storm = False
        if storm:
            metrics.count(metrics.PROFILER_RECOMPILE_STORMS)
            events.record(
                events.PROFILER_RECOMPILE_STORM,
                compiles=len(self._recent),
                window_s=self.storm_window_s,
                jit_kind=kind,
            )

    def snapshot(self, top: int = 20) -> dict:
        with self._mu:
            rows = sorted(
                (
                    {"signature": k, **v}
                    for k, v in self._sigs.items()
                ),
                key=lambda r: (-r["compiles"], -r["seconds"]),
            )
            return {
                "total_compiles": self.total_compiles,
                "total_seconds": round(self.total_seconds, 6),
                "storms": self.storms,
                "signatures": rows[:top],
            }

    def clear(self) -> None:
        with self._mu:
            self._sigs.clear()
            self._recent.clear()
            self._in_storm = False
            self.total_compiles = 0
            self.total_seconds = 0.0
            self.storms = 0


# -- continuous thread-stack sampler ------------------------------------------


class StackSampler:
    """Always-on wall-clock profiler: a daemon thread wakes ``hz`` times
    a second, snapshots every thread's stack via
    ``sys._current_frames()``, and aggregates the innermost
    ``frame_depth`` frames into a bounded counts table. At default 10 Hz
    the per-sample cost is a few dozen microseconds per thread — the CI
    overhead gate keeps the total under 5% of executor micro time."""

    def __init__(self, hz: float = 10.0, max_keys: int = 512, frame_depth: int = 3) -> None:
        self.hz = hz
        self.max_keys = max_keys
        self.frame_depth = frame_depth
        self._mu = threading.Lock()
        self._counts: dict = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.samples = 0

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        if self.hz <= 0 or self.running:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="pilosa-stack-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _loop(self) -> None:
        interval = 1.0 / max(self.hz, 0.01)
        me = threading.get_ident()
        while not self._stop.wait(interval):
            self.sample_once(skip_ident=me)

    def sample_once(self, skip_ident: Optional[int] = None) -> None:
        try:
            frames = _current_frames()
        except Exception:
            return
        keys = []
        for ident, frame in frames.items():
            if ident == skip_ident:
                continue
            parts = []
            f = frame
            for _ in range(self.frame_depth):
                if f is None:
                    break
                code = f.f_code
                parts.append(f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
                f = f.f_back
            if parts:
                keys.append(";".join(parts))
        with self._mu:
            for key in keys:
                if key not in self._counts and len(self._counts) >= self.max_keys:
                    key = "(other)"
                self._counts[key] = self._counts.get(key, 0) + 1
            self.samples += 1
            nkeys = len(self._counts)
        metrics.count(metrics.PROFILER_SAMPLES)
        metrics.gauge(metrics.PROFILER_STACK_KEYS, nkeys)

    def top(self, n: int = 25) -> list[dict]:
        with self._mu:
            rows = sorted(self._counts.items(), key=lambda kv: -kv[1])[:n]
            total = self.samples
        return [
            {
                "frames": key,
                "count": cnt,
                "fraction": round(cnt / total, 4) if total else 0.0,
            }
            for key, cnt in rows
        ]

    def snapshot(self, top: int = 25) -> dict:
        return {
            "running": self.running,
            "hz": self.hz,
            "samples": self.samples,
            "keys": len(self._counts),
            "top": self.top(top),
        }

    def clear(self) -> None:
        with self._mu:
            self._counts.clear()
            self.samples = 0


# -- device (HBM) telemetry ---------------------------------------------------


class DeviceTelemetry:
    """Poll ``device.memory_stats()`` into HBM gauges. The CPU backend
    returns None (or lacks the method entirely); absence leaves the
    gauges unset rather than erroring, so the poller is safe to run in
    every test process. Watermark events are edge-triggered per device:
    one journal entry per excursion above ``watermark_pct``."""

    def __init__(self, watermark_pct: float = 0.9, interval_s: float = 5.0) -> None:
        self.watermark_pct = watermark_pct
        self.interval_s = interval_s
        self._above: set = set()
        self._peak: dict = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # optional callable returning (stager_bytes, stager_limit); the
        # server wires the executor's stager in so the stager share of
        # HBM is a gauge, not a ratio dashboards must derive
        self.stager_probe = None
        self.polls = 0
        self.last: dict = {}

    def _device_stats(self) -> list:
        """[(device_label, stats_dict)] for devices that expose memory
        stats. Empty in the port until device telemetry reads
        ``torch.cuda.memory_stats`` (ROADMAP A7): the poller then
        publishes only the stager share."""
        return []

    def poll_once(self) -> dict:
        self.polls += 1
        snap: dict = {"devices": {}}
        for label, stats in self._device_stats():
            in_use = stats.get("bytes_in_use")
            limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
            peak = stats.get("peak_bytes_in_use")
            if in_use is None:
                continue
            if peak is None:
                peak = max(self._peak.get(label, 0), in_use)
            self._peak[label] = peak
            metrics.gauge(metrics.HBM_BYTES_IN_USE, in_use, device=label)
            metrics.gauge(metrics.HBM_PEAK_BYTES, peak, device=label)
            dev = {"bytes_in_use": in_use, "peak_bytes": peak}
            if limit:
                metrics.gauge(metrics.HBM_BYTES_LIMIT, limit, device=label)
                dev["bytes_limit"] = limit
                frac = in_use / limit
                dev["fraction"] = round(frac, 4)
                if frac >= self.watermark_pct:
                    if label not in self._above:
                        self._above.add(label)
                        events.record(
                            events.PROFILER_HBM_WATERMARK,
                            device=label,
                            bytes_in_use=in_use,
                            bytes_limit=limit,
                            fraction=round(frac, 4),
                            watermark_pct=self.watermark_pct,
                        )
                else:
                    self._above.discard(label)
            snap["devices"][label] = dev
        probe = self.stager_probe
        if probe is not None:
            try:
                staged, limit = probe()
            except Exception:
                staged, limit = 0, 0
            if limit:
                frac = round(staged / limit, 4)
                metrics.gauge(metrics.HBM_STAGER_FRACTION, frac)
                snap["stager"] = {"bytes": staged, "limit": limit, "fraction": frac}
        self.last = snap
        return snap

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="pilosa-hbm-poller", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:
                pass  # telemetry must never kill its own loop

    def snapshot(self) -> dict:
        return {
            "running": self.running,
            "polls": self.polls,
            "watermark_pct": self.watermark_pct,
            **self.last,
        }


# -- on-demand device profile capture ------------------------------------------

# The reference captures a jax.profiler trace here; the port's capture
# (torch.profiler over the card) comes with device telemetry (ROADMAP
# A7). Until then the HTTP route answers 501 and the status says so.
CAPTURE_ITEM = "A7 (device telemetry)"


def capture_status() -> dict:
    return {"running": False, "dir": None}


# process-global singletons; the server applies config knobs
# (profiler-hz, hbm-watermark-pct) and starts/stops the threads
WATERFALL = WaterfallAggregator()
COMPILES = CompileTracker()
SAMPLER = StackSampler()
TELEMETRY = DeviceTelemetry()
