"""Server runtime (L7) — wires holder/executor/API/HTTP + background
loops (reference server.go / server/server.go Command).

The port of ``pilosa_tpu/server/server.py`` for one node. The executor
runs on ``config.device``, resolved as the executor resolves it: CUDA
unless the configuration asks for ``"cpu"``, and an error when CUDA is
absent and the CPU was not asked for. There is no mesh. Serving
deployments get the device health gate and the HBM governor. On a CUDA
device ``open()`` builds the kernels before the listener answers, so
the first guarded query does not spend the gate's deadline compiling.

The plan cache and whole-query fusion are on by default, as in the
reference (``plan-cache-enabled``, ``fusion-enabled``). The holder has
attribute stores and the executor a key translator over
``<data-dir>/translate`` (``translate-partitions``,
``translate-cache-bytes``), one node's: it owns and mints every key.

The durable event journal is on by default, as in the reference
(``journal-max-bytes`` 8 MiB under ``<data-dir>/.events``, a directory
the holder skips); ``export-path`` / ``export-url`` start the telemetry
exporter; ``device-faults`` installs the device fault schedule and
``chaos-enabled`` opens ``POST /debug/chaos``. The device telemetry
polls the card the server runs on.

Not constructed here, with the ROADMAP item that ports each: the
cluster, multihost gangs, the fleet collector, the integrity scrubber,
and the translate plane's forwarding and replication (A8), the
dispatch engine and autotune (A6). ``Config.check_ported`` refuses a
configuration that turns one on, and their HTTP routes answer 501.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import torch

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.executor import DeviceStager, Executor, resolve_device
from pilosa_tpu_torch.executor.devicehealth import DeviceHealth
from pilosa_tpu_torch.executor.hbm import HbmGovernor
from pilosa_tpu_torch.plan.cache import PlanCache
from pilosa_tpu_torch.server.api import A8, API
from pilosa_tpu_torch.server.config import Config
from pilosa_tpu_torch.server.http_handler import Handler, make_http_server
from pilosa_tpu_torch.server.ingest import IngestQueue
from pilosa_tpu_torch.server.pipeline import QueryPipeline, make_query_combiner
from pilosa_tpu_torch.server.tenancy import TenancyManager
from pilosa_tpu_torch.translate import Translator
from pilosa_tpu_torch.utils import chaos, events, heat, metrics, profiler, slo, telemetry_export, trace
from pilosa_tpu_torch.utils.attrstore import new_attr_store
from pilosa_tpu_torch.utils.diagnostics import DiagnosticsCollector
from pilosa_tpu_torch.utils.gcnotify import GCNotifier
from pilosa_tpu_torch.utils.logger import NOP_LOGGER, StandardLogger
from pilosa_tpu_torch.utils.stats import (
    ExpvarStatsClient,
    MultiStatsClient,
    NOP_STATS,
    StatsDClient,
)


class Server:
    def __init__(self, config: Optional[Config] = None, cluster=None) -> None:
        if cluster is not None:
            raise NotImplementedError(
                f"clusters are not ported to pilosa_tpu_torch yet (ROADMAP {A8})"
            )
        self.config = config or Config()
        self.config.check_ported()
        self.device = resolve_device(self.config.device)
        data_dir = os.path.expanduser(self.config.data_dir)
        self.logger = (
            StandardLogger(verbose=self.config.verbose)
            if self.config.log_path != "nop"
            else NOP_LOGGER
        )
        # reference server/server.go:353-364 (expvar/statsd/none selection;
        # unknown names error there too). An in-process ExpvarStatsClient
        # is ALWAYS kept so /debug/vars and /metrics have a snapshot:
        # with the statsd sink, stats fan out to both.
        self._expvar = ExpvarStatsClient()
        if self.config.metric == "expvar":
            self.stats = self._expvar
        elif self.config.metric == "statsd":
            self.stats = MultiStatsClient(
                self._expvar, StatsDClient(host=self.config.metric_host)
            )
        elif self.config.metric in ("none", "nop", ""):
            self.stats = NOP_STATS
        else:
            raise ValueError(f"invalid metric service: {self.config.metric!r}")
        # tracer knobs (process-global tracer: the last server configured
        # in-process wins — one server per process in any real deployment)
        tracer = trace.TRACER
        tracer.sample_rate = self.config.trace_sample_rate
        tracer.slow_threshold = self.config.slow_query_time
        if self.config.slow_query_time > 0:
            import json as _json

            logger = self.logger

            def _log_slow(tree: dict) -> None:
                logger.printf(
                    "%.3fs SLOW QUERY trace %s",
                    tree.get("duration_ms", 0.0) / 1000.0,
                    _json.dumps(tree),
                )

            tracer.on_slow = _log_slow
        else:
            tracer.on_slow = None
        # workload heat ledger knobs (process-global like the tracer)
        heat.LEDGER.configure(
            self.config.heat_enabled, self.config.heat_decay_halflife
        )
        # durable event journal backing: the ring becomes a
        # write-through cache over segments in journal-dir (default
        # <data-dir>/.events); 0 bytes keeps the ring-only journal
        if self.config.journal_max_bytes > 0:
            events.JOURNAL.open_backing(
                self.config.journal_dir or os.path.join(data_dir, ".events"),
                self.config.journal_max_bytes,
            )
        # telemetry export pipeline: with no sink configured this is
        # None and the journal/tracer taps stay unset — the disabled
        # hot path pays one is-not-None branch, no allocations
        self.exporter = telemetry_export.build_exporter(
            path=self.config.export_path,
            url=self.config.export_url,
            queue_max=self.config.export_queue,
            interval=self.config.export_interval,
            metrics_fn=metrics.snapshot,
        )
        if self.exporter is not None:
            events.JOURNAL.on_record = self.exporter.tap_event
            trace.TRACER.on_export = self.exporter.tap_span
        # only hook gc.callbacks when someone consumes the counter
        self.gc_notifier = GCNotifier() if self.stats is not NOP_STATS else None
        self.holder = Holder(data_dir, new_attr_store=new_attr_store)
        # key translation (translate/): partitioned durable key <-> id
        # logs under <data>/translate, which the holder does not open as
        # an index
        self.translate_store = Translator(
            os.path.join(data_dir, "translate"),
            partitions=self.config.translate_partitions,
            cache_bytes=self.config.translate_cache_bytes,
        )
        self.stager = DeviceStager(
            self.device,
            budget_bytes=self.config.stager_budget_bytes,
            delta_enabled=self.config.stager_delta_enabled,
            delta_max_ratio=self.config.stager_delta_max_ratio,
            tier1_max_bytes=self.config.tier1_max_bytes,
            compressed_min_ratio=self.config.compressed_upload_min_ratio,
        )
        # the delta log capacity, the bulk-import cliff and storage fault
        # injection ride on the fragment class (fragments are created
        # deep inside the holder tree; process-wide is the right scope
        # for a process-wide stager)
        from pilosa_tpu_torch.core import fragment as fragment_mod

        fragment_mod.DELTA_LOG_MAX = self.config.stager_delta_log_max
        fragment_mod.DELTA_MAX_BATCH = self.config.ingest_delta_max_batch
        fragment_mod.install_storage_faults(self.config.storage_faults)
        # device fault injection (utils/chaos.py) is process-wide for
        # the same reason; the chaos endpoint re-installs at runtime
        chaos.install_device_faults(self.config.device_faults)
        # serving deployments get the device health gate: a wedged card
        # degrades reads to the CPU roaring path instead of hanging them,
        # and a background probe on this server's device restores the
        # device path when it answers again
        health = None
        if self.config.device_policy != "never" and self.config.device_timeout > 0:
            health = DeviceHealth(
                timeout_s=self.config.device_timeout,
                logger=self.logger,
                device=self.device,
            )
        # plan result cache (plan/cache.py): the executor consults it
        # around call dispatch and the planner substitutes cached subtrees
        self.plan_cache = None
        if self.config.plan_cache_enabled:
            self.plan_cache = PlanCache(
                max_bytes=self.config.plan_cache_max_bytes,
                min_cost=self.config.plan_cache_min_cost,
            )
        self.executor = Executor(
            self.holder,
            device=self.device,
            stager=self.stager,
            device_policy=self.config.device_policy,
            max_writes_per_request=self.config.max_writes_per_request,
            health=health,
            governor=HbmGovernor(budget_bytes=self.config.hbm_budget_bytes),
            analytics_max_groups=self.config.analytics_max_groups,
            auto_min_containers=(
                self.config.auto_device_min_containers
                if self.config.auto_device_min_containers > 0
                else None
            ),
            plan_cache=self.plan_cache,
            fusion_enabled=self.config.fusion_enabled,
            fusion_max_calls=self.config.fusion_max_calls,
            plan_cache_device_bytes=self.config.plan_cache_device_bytes,
            translate_store=self.translate_store,
        )
        self.api = API(self.holder, self.executor, server=self)
        # multi-tenant QoS (server/tenancy.py): per-index admission
        # buckets, weighted-fair scheduling, HBM quotas, per-tenant
        # SLOs. Disabled (zero-cost passthrough) when no tenant-* knob
        # is configured — the single-tenant default stays bit-identical
        self.tenancy = TenancyManager(
            weights=self.config.tenant_weights,
            qps=self.config.tenant_qps,
            hbm_quota=self.config.tenant_hbm_quota,
            inflight_bytes=self.config.tenant_inflight_bytes,
            objectives=self.config.tenant_objectives,
        )
        if self.tenancy.enabled and (
            self.tenancy.hbm_quotas() or self.tenancy.default_hbm_quota
        ):
            self.executor.governor.set_index_quotas(
                self.tenancy.hbm_quotas(),
                default=self.tenancy.default_hbm_quota,
            )
        # serving pipeline (server/pipeline.py): every query/import
        # request flows through bounded per-class admission queues with
        # deadline scheduling, singleflight coalescing, and
        # cross-request batching into the executor's scorers
        self.pipeline = None
        if self.config.pipeline_enabled:
            self.pipeline = QueryPipeline(
                workers={
                    "interactive": self.config.pipeline_interactive_workers,
                    "bulk": self.config.pipeline_bulk_workers,
                    "internal": self.config.pipeline_internal_workers,
                },
                queue_limits={
                    "interactive": self.config.pipeline_interactive_queue,
                    "bulk": self.config.pipeline_bulk_queue,
                    "internal": self.config.pipeline_internal_queue,
                },
                combine_fn=make_query_combiner(self.api),
                batch_max=self.config.pipeline_batch_max,
                batch_window=self.config.pipeline_batch_window,
                shed_retry_after=self.config.pipeline_shed_retry_after,
                drain_timeout=self.config.pipeline_drain_timeout,
                tenancy=self.tenancy,
            )
        # durable ingest queue (server/ingest.py): its own admission
        # class beside interactive/bulk — bounded write-ahead queue,
        # group-committed write waves, acks only after fsync
        self.ingest = None
        if self.config.ingest_enabled:
            self.ingest = IngestQueue(
                self.api,
                queue_limit=self.config.ingest_queue_limit,
                wave_max=self.config.ingest_wave_max,
                wave_interval=self.config.ingest_wave_interval,
                retry_after=self.config.ingest_retry_after,
            )
        self.handler = Handler(
            self.api,
            logger=self.logger,
            stats=self.stats,
            long_query_time=self.config.cluster.long_query_time,
            pipeline=self.pipeline,
            default_timeout=self.config.pipeline_default_timeout,
            analytics_timeout=self.config.analytics_timeout,
            ingest=self.ingest,
            tenancy=self.tenancy,
        )
        self.diagnostics = DiagnosticsCollector(
            host=getattr(self.config, "diagnostics_host", ""),
            version=__version__,
            logger=self.logger,
        )
        self.httpd = None
        self._serve_thread: Optional[threading.Thread] = None
        self.node_id: str = ""
        self.started_at = 0.0
        self.build_seconds = 0.0
        self._closed = threading.Event()

    # -- lifecycle (reference Server.Open:312) --

    def open(self) -> None:
        tls = self.config.tls
        if bool(tls.certificate_path) != bool(tls.certificate_key_path):
            # half-configured TLS must not silently serve plaintext
            raise ValueError(
                "TLS misconfigured: both certificate-path and "
                "certificate-key-path are required"
            )
        self._set_file_limit()
        self.logger.printf(
            "pilosa_tpu_torch %s starting on %s, data=%s",
            __version__,
            self.device,
            self.holder.path,
        )
        if self.device.type == "cuda":
            # every kernel built before the listener answers: a first
            # query that compiled inside the health guard could spend
            # device-timeout on nvcc and trip a healthy card
            from pilosa_tpu_torch.ops import cuda

            t0 = time.monotonic()
            cuda.build_kernels()
            self.build_seconds = time.monotonic() - t0
            self.logger.printf("kernels built in %.1fs", self.build_seconds)
        self.holder.open()
        self.node_id = self.holder.load_node_id()
        self.httpd = make_http_server(
            self.handler, self.config.host, self.config.port
        )
        if self.config.tls.enabled:
            # TLS on the listener (reference server/server.go:166-240)
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(
                os.path.expanduser(self.config.tls.certificate_path),
                os.path.expanduser(self.config.tls.certificate_key_path),
            )
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket, server_side=True)
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._serve_thread.start()
        self.logger.printf(
            "pilosa_tpu_torch server listening on %s://%s:%d", self.scheme, *self.address()
        )
        # build_info gauge: one constant-1 sample whose labels identify
        # this process in a scrape (version, torch, device type)
        metrics.gauge(
            metrics.BUILD_INFO,
            1.0,
            version=__version__,
            torch=torch.__version__,
            backend=self.device.type,
            pid=str(os.getpid()),
            gang="",
            rank="0",
            leader="true",
        )
        # uptime/start-time gauges, SLO objectives from config, and the
        # always-on samplers; all of it degrades to no-ops when the
        # knobs disable it — serving never depends on the observers
        self.started_at = time.time()
        metrics.gauge(metrics.PROCESS_START_TIME_SECONDS, round(self.started_at, 3))
        metrics.gauge(metrics.UPTIME_SECONDS, 0.0)
        slo.MONITOR.configure(
            objectives=slo.parse_objectives(self.config.slo_objectives),
            burn_threshold=self.config.slo_burn_threshold,
        )
        # per-tenant SLOs ride the same monitor as tenant:<index>
        # classes (server/tenancy.py)
        if self.tenancy.enabled:
            slo.MONITOR.merge(self.tenancy.slo_objectives())
        profiler.TELEMETRY.watermark_pct = self.config.hbm_watermark_pct
        # the telemetry polls this server's card (and a capture traces
        # its kernels); it never picks a device itself
        profiler.TELEMETRY.device = self.device
        stager = self.stager

        def _stager_probe() -> tuple[int, int]:
            return stager._bytes, stager.budget_bytes

        profiler.TELEMETRY.stager_probe = _stager_probe
        profiler.TELEMETRY.start()
        if self.exporter is not None:
            self.exporter.start()
        if self.config.profiler_hz > 0:
            profiler.SAMPLER.hz = self.config.profiler_hz
            profiler.SAMPLER.start()
        self._start_background_loops()

    def _set_file_limit(self) -> None:
        """Raise RLIMIT_NOFILE toward the reference's 262,144 target
        (holder.setFileLimit, holder.go:40,470) — one mmapped file per
        fragment adds up. Best-effort: capped at the hard limit."""
        try:
            import resource

            target = 262_144
            soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
            want = min(target, hard) if hard != resource.RLIM_INFINITY else target
            if soft < want:
                resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
                self.logger.printf("raised open-file limit to %d", want)
        except (ImportError, ValueError, OSError) as e:
            self.logger.printf("could not raise file limit: %s", e)

    def _start_background_loops(self) -> None:
        """reference server.go: monitorCacheFlush (holder.go:425),
        monitorRuntime:683, monitorDiagnostics:633."""

        def cache_flush_loop():
            # persist every OPENED fragment's TopN cache periodically so
            # a crash loses at most one interval of ranking state
            interval = self.config.cache_flush_interval
            if interval <= 0:
                return
            while not self._closed.wait(interval):
                try:
                    for idx in list(self.holder.indexes.values()):
                        for fld in list(idx.fields.values()):
                            for view in list(fld.views.values()):
                                for frag in list(view.fragments.values()):
                                    if frag._open:
                                        frag.flush_cache()
                except Exception as e:
                    self.logger.printf("cache flush error: %s", e)

        def runtime_monitor_loop():
            import gc

            while not self._closed.wait(10.0):
                try:
                    import resource

                    usage = resource.getrusage(resource.RUSAGE_SELF)
                    self.stats.gauge(metrics.MAX_RSS_KB, usage.ru_maxrss)
                    self.stats.gauge(metrics.THREADS, threading.active_count())
                    counts = gc.get_count()
                    self.stats.gauge(metrics.GC_GEN0, counts[0])
                    cycles = (
                        self.gc_notifier.poll() if self.gc_notifier else 0
                    )
                    if cycles:
                        # reference server.go:702-704 via gcnotify
                        self.stats.count(metrics.GARBAGE_COLLECTION, cycles)
                    self.stats.gauge(metrics.OPEN_FRAGMENTS, self._count_fragments())
                except Exception:
                    pass

        def diagnostics_loop():
            if self.diagnostics.host == "":
                return
            while not self._closed.wait(3600.0):
                self.diagnostics.enrich_with_os_info()
                self.diagnostics.enrich_with_schema(self.holder)
                self.diagnostics.flush()

        def slo_tick_loop():
            # evaluate burn-rate windows even when nobody scrapes, and
            # keep the uptime gauge at most 5 s stale
            while not self._closed.wait(5.0):
                try:
                    metrics.gauge(
                        metrics.UPTIME_SECONDS,
                        round(time.time() - self.started_at, 3),
                    )
                    slo.MONITOR.tick()
                except Exception as e:
                    self.logger.printf("slo tick error: %s", e)

        for fn in (cache_flush_loop, runtime_monitor_loop, diagnostics_loop, slo_tick_loop):
            threading.Thread(target=fn, daemon=True).start()

    def _count_fragments(self) -> int:
        n = 0
        for idx in self.holder.indexes.values():
            for f in idx.fields.values():
                for v in f.views.values():
                    n += len(v.fragments)
        return n

    def address(self) -> tuple[str, int]:
        if self.httpd is None:
            return (self.config.host, self.config.port)
        return self.httpd.server_address[:2]

    @property
    def scheme(self) -> str:
        return "https" if self.config.tls.enabled else "http"

    @property
    def uri(self) -> str:
        host, port = self.address()
        return f"{self.scheme}://{host}:{port}"

    def close(self) -> None:
        self._closed.set()
        # drain the ingest queue to durability first: every queued wave
        # group-commits and its submitters ack before we take down the
        # layers a wave needs (new submits answer 503)
        if self.ingest is not None:
            self.ingest.close()
        # graceful drain: stop admitting (new requests get 503), complete
        # queued + in-flight work within the drain budget
        if self.pipeline is not None:
            clean = self.pipeline.close()
            if not clean:
                self.logger.printf(
                    "pipeline drain timed out after %.1fs; remaining work failed 503",
                    self.config.pipeline_drain_timeout,
                )
        if self.gc_notifier is not None:
            self.gc_notifier.close()
        # observer planes stop after the workers they observe
        profiler.SAMPLER.stop()
        profiler.TELEMETRY.stop()
        # a profile capture left running stops (its trace is written)
        if profiler.capture_status()["running"]:
            profiler.stop_capture()
        if self.exporter is not None:
            # detach the taps before the final flush so late producers
            # can't race a closed queue, then flush-on-close (compare
            # the bound method's receiver: ``x.m is x.m`` is False)
            if getattr(events.JOURNAL.on_record, "__self__", None) is self.exporter:
                events.JOURNAL.on_record = None
            if getattr(trace.TRACER.on_export, "__self__", None) is self.exporter:
                trace.TRACER.on_export = None
            self.exporter.close()
        events.JOURNAL.close_backing()
        self.stats.close()
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        self.executor.close()
        if self.executor.health is not None:
            self.executor.health.close()
        self.holder.close()
        self.translate_store.close()
