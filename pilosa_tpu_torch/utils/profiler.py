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
  (bounded), detecting recompile storms. The port's compiles are the
  kernel builds: ``ops/_build.py`` notes each ``nvcc`` it runs.
* ``SAMPLER`` — the continuous profiler: samples every thread's stack
  at a configurable Hz into a bounded top-frames table.
* ``TELEMETRY`` — polls ``torch.cuda.memory_stats`` of the card the
  server runs on into HBM gauges, journals high-watermark crossings,
  and publishes the stager's share of the device budget.

An on-demand ``torch.profiler`` capture (``start_capture`` /
``stop_capture``) covers the deep dives the always-on layer can't.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

from pilosa_tpu_torch.analysis.locks import OrderedLock
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


# -- compile tracking ---------------------------------------------------------


class CompileTracker:
    """Per-signature compile counts and compile-seconds: in the port,
    each kernel source that ``ops/_build.py`` compiles (kind ``"nvcc"``,
    signature its name and source hash; a library loaded from the build
    directory is not a compile). Bounded: beyond ``max_sigs``
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
        try:
            keys = self._stack_keys(frames, skip_ident)
        finally:
            # the dict holds this thread's own frame, which holds the
            # dict: a reference cycle that would keep every sampled frame,
            # and the tensors its locals hold, alive until a garbage
            # collection, after those frames finished
            frames.clear()
        with self._mu:
            for key in keys:
                if key not in self._counts and len(self._counts) >= self.max_keys:
                    key = "(other)"
                self._counts[key] = self._counts.get(key, 0) + 1
            self.samples += 1
            nkeys = len(self._counts)
        metrics.count(metrics.PROFILER_SAMPLES)
        metrics.gauge(metrics.PROFILER_STACK_KEYS, nkeys)

    def _stack_keys(self, frames: dict, skip_ident: Optional[int]) -> list[str]:
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
        return keys

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
    """Poll the card's memory statistics into HBM gauges. The device is
    the one the server runs on (``device``, set by the server; the
    telemetry never picks one): on the CPU, or with no CUDA, or when a
    call raises (a dead context), there is nothing to poll and the
    gauges stay unset rather than erroring, so the poller is safe to run
    in every test process. Watermark events are edge-triggered per
    device: one journal entry per excursion above ``watermark_pct``."""

    def __init__(self, watermark_pct: float = 0.9, interval_s: float = 5.0) -> None:
        self.watermark_pct = watermark_pct
        self.interval_s = interval_s
        # the torch.device the server runs on; None polls nothing
        self.device = None
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
        """[(device_label, stats_dict)] of the card in ``device``:
        ``bytes_in_use`` and ``peak_bytes_in_use`` are the caching
        allocator's allocated bytes (every live tensor of the process,
        the governor's ledger or not), ``bytes_limit`` the card's total
        memory, ``bytes_reserved`` what the allocator holds. [] on the
        CPU, without CUDA, or when a call raises; never initializes
        CUDA in a process that did not."""
        dev = self.device
        if dev is None or getattr(dev, "type", None) != "cuda":
            return []
        try:
            import torch

            if not torch.cuda.is_available() or not torch.cuda.is_initialized():
                return []
            index = dev.index if dev.index is not None else torch.cuda.current_device()
            stats = torch.cuda.memory_stats(index)
            _free, total = torch.cuda.mem_get_info(index)
        except Exception:
            return []
        return [
            (
                f"cuda:{index}",
                {
                    "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                    "bytes_limit": int(total),
                    "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
                },
            )
        ]

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


# -- on-demand torch.profiler capture ------------------------------------------

_capture_mu = OrderedLock("profiler.capture_mu")
_capture: Optional[dict] = None

# A capture reports itself started only once the profiler records the
# card's work, and its stop says whether it did. Late in a long process,
# torch.profiler (torch 2.11, CUPTI) has recorded none of a session's
# kernels for up to ~1 s after it started, and a short session before it
# did not predict the next one's loss (PERF.md §7). So the capture's own
# session launches marker kernels (``torch.cuda._sleep``'s
# ``spin_kernel``) every CAPTURE_MARKER_GAP_S for the settle time before
# the start returns, then one every CAPTURE_HEARTBEAT_S until the stop;
# the stop counts the markers its trace kept (the lost ones are the
# first) and fails if one launched after the settle is missing. A loss
# seen once lengthens the next capture's settle to twice that loss.
CAPTURE_MARKER = "spin_kernel"
CAPTURE_MARKER_GAP_S = 0.01
CAPTURE_HEARTBEAT_S = 0.1
CAPTURE_SETTLE_S = 3.0
_capture_lost_s = 0.0  # the largest loss a capture of this process saw


def _marker(device) -> None:
    import torch

    with torch.cuda.device(device):
        torch.cuda._sleep(1000)


def _device_sync(device) -> None:
    """Wait for the card's work, so a capture's stop sees every kernel
    launched before it."""
    import torch

    torch.cuda.synchronize(device)


def trace_kernel_count(path: str, needle: str) -> int:
    """Device kernels in a Chrome trace whose name holds ``needle``."""
    with open(path) as f:
        evs = json.load(f).get("traceEvents", [])
    return sum(1 for e in evs if e.get("cat") == "kernel" and needle in e.get("name", ""))


def capture_loss(offsets: list, kept: int, settled: int) -> dict:
    """What a capture's trace says of its markers: ``offsets`` are their
    launches in seconds from the session's start, ``kept`` how many the
    trace holds (the lost ones are the first), ``settled`` how many were
    launched before the start returned. ``lost_s`` is the first kept
    marker's offset (all of them when none was kept); the recording is
    verified when no marker after the settle was lost."""
    lost = len(offsets) - min(kept, len(offsets))
    lost_s = 0.0 if not lost else offsets[lost] if lost < len(offsets) else offsets[-1]
    return {"markers": len(offsets), "kept": kept, "lost": lost, "lost_s": lost_s, "verified": lost <= settled and kept > 0}


def _capture_loop(state: dict) -> None:
    """The capture's own thread: the profiler runs from its start to its
    stop on one thread (torch.profiler's state is per thread), records
    every thread's operators where the installed torch can
    (``profile_all_threads``; else only this thread's), and every
    kernel on the card (CUPTI), then writes the Chrome trace. On the
    card it launches the markers (see CAPTURE_MARKER) and waits for the
    card's work before it stops."""
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if state["cuda"]:
            acts.append(ProfilerActivity.CUDA)
        kw: dict = {}
        try:
            kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            state["all_threads"] = True
        except Exception:
            state["all_threads"] = False
        offsets: list = []
        with profile(activities=acts, **kw) as prof:
            if state["cuda"]:
                t0 = time.perf_counter()
                while not offsets or time.perf_counter() - t0 < state["settle_s"]:
                    offsets.append(time.perf_counter() - t0)
                    _marker(state["device"])
                    time.sleep(CAPTURE_MARKER_GAP_S)
                _device_sync(state["device"])
                state["settled"] = len(offsets)
                state["started"].set()
                while not state["stop"].wait(CAPTURE_HEARTBEAT_S):
                    offsets.append(time.perf_counter() - t0)
                    _marker(state["device"])
                offsets.append(time.perf_counter() - t0)
                _marker(state["device"])
                _device_sync(state["device"])
            else:
                state["started"].set()
                state["stop"].wait()
        os.makedirs(state["dir"], exist_ok=True)
        path = os.path.join(state["dir"], f"trace-{os.getpid()}-{int(time.time() * 1000)}.json")
        prof.export_chrome_trace(path)
        state["trace"] = path
        if state["cuda"]:
            state["markers"] = capture_loss(offsets, trace_kernel_count(path, CAPTURE_MARKER), state["settled"])
    except Exception as e:  # noqa: BLE001 - report, never raise
        state["error"] = f"{type(e).__name__}: {e}"
    finally:
        state["started"].set()


def start_capture(log_dir: str) -> dict:
    """Begin a ``torch.profiler`` capture, CPU operators and (on a CUDA
    server) the card's kernels, written as a Chrome trace into
    ``log_dir`` when it stops. On the card it returns after the settle
    (markers launched for ``settle_s``; see CAPTURE_MARKER). Returns a
    status dict; never raises — the profiler may be unavailable or
    already running."""
    global _capture
    device = TELEMETRY.device
    state = {
        "dir": log_dir,
        "cuda": getattr(device, "type", None) == "cuda",
        "device": device,
        "settle_s": max(CAPTURE_SETTLE_S, 2 * _capture_lost_s),
        "started": threading.Event(),
        "stop": threading.Event(),
    }
    with _capture_mu:
        if _capture is not None:
            return {"ok": False, "error": "capture already running", "dir": _capture["dir"]}
        _capture = state
        state["thread"] = threading.Thread(
            target=_capture_loop, args=(state,), name="pilosa-profile-capture", daemon=True
        )
        state["thread"].start()
    if not state["started"].wait(60.0 + state["settle_s"]):
        state["error"] = "the profiler did not start within 60 s"
        state["stop"].set()
    if "error" in state:
        with _capture_mu:
            if _capture is state:
                _capture = None
        return {"ok": False, "error": state["error"]}
    out = {"ok": True, "dir": log_dir, "cuda": state["cuda"], "all_threads": state.get("all_threads", False)}
    if state["cuda"]:
        out.update(settle_s=state["settle_s"], settle_markers=state["settled"])
    return out


def stop_capture() -> dict:
    """Stop the running capture and write its trace; ``ok: False`` when
    none runs, the trace could not be written, or (on the card) the
    trace lost a marker launched after the start returned — the
    profiler did not record all of the capture. Never raises."""
    global _capture, _capture_lost_s
    with _capture_mu:
        state, _capture = _capture, None
    if state is None:
        return {"ok": False, "error": "no capture running"}
    state["stop"].set()
    state["thread"].join(120.0)
    if "error" in state or "trace" not in state:
        return {"ok": False, "error": state.get("error", "trace not written"), "dir": state["dir"]}
    out = {"ok": True, "dir": state["dir"], "trace": state["trace"]}
    markers = state.get("markers")
    if markers is not None:
        with _capture_mu:
            _capture_lost_s = max(_capture_lost_s, markers["lost_s"] if markers["lost"] else 0.0)
        out["markers"] = markers
        if not markers["verified"]:
            out.update(
                ok=False,
                error=f"the profiler recorded the card's work only from {markers['lost_s']:.3f} s "
                f"after the capture began (settle {state['settle_s']:.3f} s)",
            )
    return out


def capture_status() -> dict:
    with _capture_mu:
        return {"running": _capture is not None, "dir": _capture["dir"] if _capture is not None else None}


# process-global singletons; the server applies config knobs
# (profiler-hz, hbm-watermark-pct) and starts/stops the threads
WATERFALL = WaterfallAggregator()
COMPILES = CompileTracker()
SAMPLER = StackSampler()
TELEMETRY = DeviceTelemetry()
