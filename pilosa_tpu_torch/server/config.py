"""Server configuration (reference server/config.go).

The port of ``pilosa_tpu/server/config.py``: the same keys, TOML names
and ``generate-config`` output, plus the port's own ``device`` ("cuda",
or "cpu" to run the kernels' plain versions). The subsystems this port
has not reached default to off here, and ``check_ported`` refuses a
configuration that turns one on, naming its ROADMAP item, instead of
ignoring the key.

Three-tier precedence (CLI flags > env PILOSA_TPU_* > TOML file) is
implemented in the CLI layer; this module is the canonical option set.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11
    import tomli as tomllib


@dataclass
class ClusterConfig:
    disabled: bool = True  # single-node static cluster by default
    coordinator: bool = False
    # coordinator address a joining node announces to (the analog of the
    # reference's gossip seed)
    coordinator_host: str = ""
    replicas: int = 1
    hosts: list[str] = field(default_factory=list)
    long_query_time: float = 0.0
    # liveness probing (reference gossip probe/suspicion tunables,
    # gossip/gossip.go:431-494); 0 disables the probe loop
    probe_interval: float = 2.0
    probe_timeout: float = 2.0
    down_after: int = 3  # consecutive probe failures → DOWN
    # periodic NodeStatus (schema + maxShards) exchange (reference
    # server.go:565-630); 0 disables
    status_interval: float = 60.0


@dataclass
class TLSConfig:
    """reference server/config.go:42-143 TLS block + server.go:166-240."""

    certificate_path: str = ""
    certificate_key_path: str = ""
    skip_verify: bool = False  # clients skip peer verification

    @property
    def enabled(self) -> bool:
        return bool(self.certificate_path and self.certificate_key_path)


@dataclass
class Config:
    data_dir: str = "~/.pilosa_tpu"
    bind: str = "localhost:10101"
    max_writes_per_request: int = 5000
    log_path: str = ""
    verbose: bool = False
    # the torch device the executor stages on and launches kernels on:
    # "cuda", or "cpu" for the kernels' plain versions
    device: str = "cuda"
    # device execution
    device_policy: str = "auto"  # never | auto | always
    stager_budget_bytes: int = 8 << 30
    # incremental delta staging (snapshot + delta model): on a fragment
    # generation bump the stager patches resident HBM blocks with
    # scatter-update kernels instead of rebuilding + re-uploading them
    stager_delta_enabled: bool = True
    # full-rebuild crossover: a delta batch touching more than this
    # fraction of a staged block's words re-stages instead (the scatter
    # stops winning once it rewrites much of the block)
    stager_delta_max_ratio: float = 0.25
    # per-fragment delta log capacity (single-bit mutations kept since
    # the oldest replayable snapshot); staged entries older than the
    # truncation floor full-rebuild on next use
    stager_delta_log_max: int = 4096
    # device health gate: reads slower than this fall back to the CPU
    # roaring path and gate the device off until a probe answers
    # (executor/devicehealth.py); 0 disables the gate. The server builds
    # the kernels before it listens, so no first query compiles under it.
    device_timeout: float = 120.0
    # auto-policy crossover, in estimated touched containers; 0 = keep
    # the executor default (the port does not measure its own crossover
    # yet: ROADMAP A6)
    auto_device_min_containers: int = 0
    # The multi-device plane is not ported (ROADMAP A8): the keys below
    # keep the JAX package's names and TOML spellings, and a value that
    # turns one on is refused by check_ported. mesh-devices: devices to
    # mesh the shard axis over (0/1 = one device).
    mesh_devices: int | str = 0
    # multihost serving over one global mesh across processes
    distributed_enabled: bool = False
    distributed_coordinator: str = ""
    distributed_process_id: int = -1
    distributed_num_processes: int = 0
    distributed_gloo: bool = True
    distributed_frame_bytes: int = 65536
    distributed_idle_interval: float = 2.0
    distributed_dispatch_timeout: float = 30.0
    distributed_leader_timeout: float = 120.0
    distributed_faults: str = ""
    # federation: gangs composed with the cluster plane
    federation_rejoin: str = ""
    federation_leader: bool = False
    federation_reform_budget: float = 30.0
    # cross-node RPC retry policy
    client_retries: int = 2
    client_retry_backoff: float = 0.05
    # cluster
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    # TLS on the listener + internal client (reference server.go:166-240)
    tls: TLSConfig = field(default_factory=TLSConfig)
    anti_entropy_interval: float = 600.0  # reference server.go:238 (10m)
    cache_flush_interval: float = 60.0  # reference holder.go:37 (1m)
    metric: str = "expvar"  # expvar | statsd | none
    metric_host: str = "127.0.0.1:8125"  # statsd UDP address
    # observability (utils/trace.py): fraction of queries traced into
    # the /debug/traces ring buffer (0 = off; profile=true always traces)
    trace_sample_rate: float = 0.0
    # seconds; > 0 traces EVERY query and logs the full span tree of any
    # query over the threshold (0 = off). Complementary to
    # cluster.long-query-time, which logs only the query text.
    slow_query_time: float = 0.0
    # serving pipeline (server/pipeline.py): the admission/scheduling
    # layer between HTTP and the executor. Per-class bounded queues +
    # dedicated worker pools; a full queue sheds 429 + Retry-After.
    pipeline_enabled: bool = True
    pipeline_interactive_workers: int = 8
    pipeline_bulk_workers: int = 2
    pipeline_internal_workers: int = 8
    pipeline_interactive_queue: int = 64
    pipeline_bulk_queue: int = 16
    pipeline_internal_queue: int = 128
    # cross-request batching: max homogeneous queued queries combined
    # into one executor call (1 disables), and an OPTIONAL artificial
    # wait (seconds) for peers — 0 (default) batches purely from
    # backlog, so an uncontended query pays no added latency
    pipeline_batch_max: int = 16
    pipeline_batch_window: float = 0.0
    # default per-request deadline in seconds when the client sends
    # neither a `timeout` param nor an X-Request-Deadline header
    # (0 = unbounded)
    pipeline_default_timeout: float = 0.0
    # Retry-After seconds on a 429 shed
    pipeline_shed_retry_after: float = 1.0
    # graceful-drain budget at shutdown: queued + in-flight work gets
    # this long to complete before being failed 503
    pipeline_drain_timeout: float = 10.0
    # durable streaming ingest (server/ingest.py): bounded write-ahead
    # queue coalescing mutations into group-committed write waves (one
    # fsync + one generation bump + one gang frame per wave). Acked
    # writes survive SIGKILL; queue overflow sheds 429 + Retry-After.
    ingest_enabled: bool = True
    # max pending mutations (bits, not requests) before submits shed
    ingest_queue_limit: int = 8192
    # max mutations coalesced into one write wave
    ingest_wave_max: int = 2048
    # coalesce window (seconds) the committer waits before sealing a
    # wave — bounds write-visibility staleness alongside commit latency
    ingest_wave_interval: float = 0.002
    # Retry-After seconds on an ingest queue-full 429
    ingest_retry_after: float = 0.25
    # bulk-import cliff threshold: import_block_pairs / bulk_import
    # batches at or under this many bits apply through the batched
    # delta path (one generation bump, delta log extended) instead of
    # resetting the delta log and forcing a full re-stage
    ingest_delta_max_batch: int = 512
    # storage fault injection (tests/dryruns only, core/fragment.py):
    # "fsync_fail_every=N,torn_at=N,enospc_after=N,corrupt_at=K,
    # bitrot=N,snapshot_kill=pre|post" — see fragment.StorageFaultSpec;
    # "" disables
    storage_faults: str = ""
    # background integrity scrubber (server/scrub.py): a low-priority
    # loop re-verifying owned fragments at rest — snapshot digest,
    # op-log CRC walk, and (scrub-deep) in-memory blocks vs an on-disk
    # re-read. Corrupt fragments quarantine (reads 503) and repair from
    # a healthy replica. 0 disables the loop; /debug/scrub still works.
    scrub_interval: float = 0.0  # not ported yet: see _UNPORTED
    # sleep between fragments within a sweep — bounds the scrubber's
    # IO/CPU share so it never competes with serving
    scrub_throttle: float = 0.05
    # include the expensive deep check (full file re-read + block
    # checksum compare against live memory) in every sweep
    scrub_deep: bool = True
    # repair quarantined fragments automatically from a healthy replica
    # (federated/replicated clusters); off leaves them quarantined for
    # operator action
    scrub_repair: bool = True
    # continuous-batching dispatch engine (executor/dispatch.py): the
    # async executor↔device boundary. Callers submit futures; a
    # persistent loop admits queued queries into in-flight waves grouped
    # by canonical plan signature, so heterogeneous plans coexist in one
    # wave and wave N+1 stages while wave N executes.
    dispatch_enabled: bool = False  # not ported yet: see _UNPORTED
    # max queries admitted into one wave
    dispatch_max_wave: int = 16
    # concurrent waves in flight (double/triple buffering depth)
    dispatch_max_inflight: int = 2
    # how many waves ahead the stager prefetches operand rows (0 = off)
    dispatch_stage_ahead: int = 1
    # tiered block staging (executor/tiering.py): host-RAM byte budget
    # for T1, the compressed roaring-container tier between device LRU
    # (T0) and the mmapped fragment (T2). A T0 miss that hits T1 skips
    # the fragment walk; admission is cost-modeled (heat × rebuild cost
    # per byte). 0 disables the tier.
    tier1_max_bytes: int = 256 << 20
    # plan-driven speculative prefetch: the dispatch engine hands queued
    # waves' plans to a scheduler that promotes their Row blocks
    # T1/T2 → T0 ahead of compute, with used-vs-evicted accuracy
    # accounting (replaces the thunk-based advisory warm)
    prefetch_enabled: bool = False  # not ported yet: see _UNPORTED
    # how many waves ahead the prefetcher looks in the dispatch queue
    prefetch_depth: int = 2
    # compressed-upload crossover: when a block's dense bytes are at
    # least this multiple of its container payload bytes, the payloads
    # cross the wire and a device kernel expands them to packed words
    # (ops.expand_blocks); 0 always uploads dense
    compressed_upload_min_ratio: float = 4.0
    # plan result cache (plan/cache.py): generation-stamped cross-request
    # result cache between parsing and execution. Entries are keyed by
    # canonical plan hash + shard set and validated against fragment
    # generations, so every write path invalidates exactly — no TTLs.
    plan_cache_enabled: bool = True
    # LRU byte budget for cached results (per-shard row segments +
    # scalars); 0 effectively disables storage
    plan_cache_max_bytes: int = 256 << 20
    # minimum build cost (seconds) for a result to be stored: filters
    # out sub-threshold queries whose recompute is cheaper than the
    # cache bookkeeping. 0 caches everything.
    plan_cache_min_cost: float = 0.0
    # whole-query / wave fusion (executor/fusion.py): multi-call read
    # queries lower to ONE jitted device program per plan signature so
    # intermediates never leave HBM — one host↔device round trip per
    # query (or per combined dispatch wave) instead of one per call
    fusion_enabled: bool = True
    # calls above this per query fall back to per-call execution (each
    # distinct call mix compiles its own fused program; bounding the
    # mix bounds compile-cache growth)
    fusion_max_calls: int = 64
    # device-resident analytics (executor/analytics.py): cap on the
    # cross-product group count K of one GroupBy panel — a panel whose
    # dims multiply past this fails with a clear error instead of
    # allocating an unbounded [K, shards·words] device transient
    analytics_max_groups: int = 10000
    # default per-request deadline (seconds) for analytic queries
    # (GroupBy / Distinct / Percentile) when the client sends neither a
    # `timeout` param nor an X-Request-Deadline header — they run in
    # the BULK pipeline class with its own SLO objective, so they get
    # their own budget instead of pipeline-default-timeout (0 =
    # unbounded, same convention)
    analytics_timeout: float = 10.0
    # HBM byte budget for the device-resident plan cache: __cached
    # subtree bitmap stacks pinned on device so repeated subtrees stop
    # re-uploading. 0 disables (host plan cache still works)
    plan_cache_device_bytes: int = 64 << 20
    # global HBM budget for the governor ledger (executor/hbm.py):
    # every device-resident tenant (stager blocks, device plan cache,
    # batcher pad scratch, fused-launch transients) reserves against
    # ONE byte budget. 0 = the sum of the tenant shares (each subsystem
    # capped at its own knob, as before); > 0 pins the global total
    # BELOW that sum — the fix for the budgets jointly overcommitting
    # the chip
    hbm_budget_bytes: int = 0
    # device fault injection (tests/dryruns only, utils/chaos.py):
    # "oom_every=N,stall_every=N,stall_s=S,poison_every=N,after=K" —
    # see chaos.DeviceFaultSpec; "" disables
    device_faults: str = ""
    # gate for the runtime chaos-window endpoint (POST /debug/chaos):
    # installs/clears storage+device+distributed fault schedules on a
    # LIVE server. Off by default — a production server must not expose
    # a fault injector
    chaos_enabled: bool = False
    # performance attribution (utils/profiler.py, utils/slo.py):
    # continuous thread-stack sampler frequency in Hz (0 disables)
    profiler_hz: float = 10.0
    # HBM occupancy fraction above which the device-telemetry poller
    # journals a profiler.hbm_watermark event (edge-triggered)
    hbm_watermark_pct: float = 0.9
    # per-class SLOs: "cls=latency_ms@availability_target,..." — a query
    # is good when it succeeds within latency_ms; burn rate is measured
    # against 1 - target over 5m/1h windows
    slo_objectives: str = "interactive=250@0.999,bulk=2000@0.99,internal=500@0.999"
    # burn-rate alert threshold (fires when BOTH windows exceed it);
    # 14.4 = the SRE-workbook fast-burn page (budget gone in ~2 days)
    slo_burn_threshold: float = 14.4
    # workload heat ledger (utils/heat.py): per-(index, field, shard)
    # read/write/staging accounting behind GET /debug/heat; the hooks
    # collapse to one branch per shard when disabled
    heat_enabled: bool = True
    # EWMA half-life (seconds) for the per-cell heat score decay
    heat_decay_halflife: float = 300.0
    # durable event journal (utils/events.py): directory for the
    # segmented append-only backing; "" defaults to <data-dir>/.events
    # when journal-max-bytes > 0
    journal_dir: str = ""
    # on-disk retention budget in bytes across journal segments;
    # 0 disables the durable backing (in-memory ring only)
    journal_max_bytes: int = 8 << 20
    # telemetry export pipeline (utils/telemetry_export.py): JSONL file
    # sink path and/or OTLP-compatible HTTP/JSON endpoint URL; both
    # empty = exporter not started (zero hot-path cost)
    export_path: str = ""
    export_url: str = ""
    # background flush interval (seconds) and bounded queue depth; a
    # full queue DROPS (counted) rather than blocking producers
    export_interval: float = 5.0
    export_queue: int = 1024
    # multi-tenant QoS (server/tenancy.py) — the index is the tenant.
    # All five default to "" = tenancy disabled: single-tenant servers
    # keep the exact FIFO/unlimited behavior, bit-for-bit.
    # "index=weight,..." relative weighted-fair shares; "*" sets the
    # default for unlisted tenants (1.0 when absent)
    tenant_weights: str = ""
    # "index=qps,..." admission token-bucket rates; "*" sets a default
    # scaled by each tenant's weight; 0/absent = unlimited
    tenant_qps: str = ""
    # "index=bytes,..." HBM-domain byte quotas enforced by the governor
    # (stager + device plan cache attribution); "*" = default quota
    tenant_hbm_quota: str = ""
    # "index=bytes,..." in-flight request-byte caps (admission ledger)
    tenant_inflight_bytes: str = ""
    # "index=latency_ms@target,..." per-tenant SLOs, monitored as
    # tenant:<index> classes next to the per-class set; "*" lazily
    # registers every tenant at first query
    tenant_objectives: str = ""
    # opt-in diagnostics phone-home endpoint (reference diagnostics.go);
    # empty = disabled
    diagnostics_host: str = ""
    # translate-store primary (reference TranslateFile primary/replica
    # streaming, translate.go:259-310). LEGACY override: when set, that
    # one node owns every key space. Unset (the default), ownership is
    # partitioned — each column-key partition / row space is owned by
    # the jump-hash-selected cluster node.
    translate_primary_url: str = ""
    # key translation (translate/): column-key
    # partition count per index (fixed for the life of the data dir —
    # ids encode their partition) and the byte budget of the hot
    # id→key reverse-translation LRU
    translate_partitions: int = 16
    translate_cache_bytes: int = 1 << 20

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` naming the ROADMAP item when
        this configuration turns on a subsystem the port lacks."""
        for key, (on, item) in _UNPORTED.items():
            if on(self):
                raise NotImplementedError(
                    f"configuration {key!r}: that subsystem is not ported to "
                    f"pilosa_tpu_torch yet (ROADMAP {item})"
                )

    @property
    def host(self) -> str:
        return self.bind.rsplit(":", 1)[0] or "localhost"

    @property
    def port(self) -> int:
        parts = self.bind.rsplit(":", 1)
        return int(parts[1]) if len(parts) == 2 and parts[1] else 10101

    @classmethod
    def from_toml(cls, path: str) -> "Config":
        with open(path, "rb") as f:
            raw = tomllib.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        cfg = cls()
        for k, v in raw.items():
            key = k.replace("-", "_")
            if key == "cluster" and isinstance(v, dict):
                for ck, cv in v.items():
                    cattr = ck.replace("-", "_")
                    if hasattr(cfg.cluster, cattr):
                        setattr(cfg.cluster, cattr, cv)
            elif key == "tls" and isinstance(v, dict):
                for tk, tv in v.items():
                    tattr = tk.replace("-", "_")
                    if hasattr(cfg.tls, tattr):
                        setattr(cfg.tls, tattr, tv)
            elif hasattr(cfg, key):
                setattr(cfg, key, v)
            else:
                raise ValueError(f"unknown config key: {k}")
        return cfg

    def apply_env(self, env=None) -> None:
        """PILOSA_TPU_* environment overrides (reference PILOSA_* env)."""
        env = env if env is not None else os.environ
        for f in dataclasses.fields(self):
            if f.name in ("cluster", "tls"):
                continue
            key = "PILOSA_TPU_" + f.name.upper()
            if key in env:
                v: object = env[key]
                if f.type in ("int",):
                    v = int(v)  # type: ignore[arg-type]
                elif f.type in ("float",):
                    v = float(v)  # type: ignore[arg-type]
                elif f.type in ("bool",):
                    v = str(v).lower() in ("1", "true", "yes")
                setattr(self, f.name, v)

    def to_toml(self) -> str:
        lines = [
            f'data-dir = "{self.data_dir}"',
            f'bind = "{self.bind}"',
            f"max-writes-per-request = {self.max_writes_per_request}",
            f'device = "{self.device}"',
            f'device-policy = "{self.device_policy}"',
            f"stager-delta-enabled = {'true' if self.stager_delta_enabled else 'false'}",
            f"stager-delta-max-ratio = {self.stager_delta_max_ratio}",
            f"stager-delta-log-max = {self.stager_delta_log_max}",
            f"mesh-devices = {self.mesh_devices!r}"
            if isinstance(self.mesh_devices, str)
            else f"mesh-devices = {self.mesh_devices}",
            f"distributed-enabled = {'true' if self.distributed_enabled else 'false'}",
            f'distributed-coordinator = "{self.distributed_coordinator}"',
            f"distributed-num-processes = {self.distributed_num_processes}",
            f"distributed-dispatch-timeout = {self.distributed_dispatch_timeout}",
            f'federation-rejoin = "{self.federation_rejoin}"',
            f"federation-leader = {'true' if self.federation_leader else 'false'}",
            f"federation-reform-budget = {self.federation_reform_budget}",
            f"client-retries = {self.client_retries}",
            f"client-retry-backoff = {self.client_retry_backoff}",
            f'metric = "{self.metric}"',
            f"trace-sample-rate = {self.trace_sample_rate}",
            f"slow-query-time = {self.slow_query_time}",
            f"anti-entropy-interval = {self.anti_entropy_interval}",
            f"pipeline-enabled = {'true' if self.pipeline_enabled else 'false'}",
            f"pipeline-interactive-workers = {self.pipeline_interactive_workers}",
            f"pipeline-interactive-queue = {self.pipeline_interactive_queue}",
            f"pipeline-batch-max = {self.pipeline_batch_max}",
            f"pipeline-default-timeout = {self.pipeline_default_timeout}",
            f"pipeline-drain-timeout = {self.pipeline_drain_timeout}",
            f"ingest-enabled = {'true' if self.ingest_enabled else 'false'}",
            f"ingest-queue-limit = {self.ingest_queue_limit}",
            f"ingest-wave-max = {self.ingest_wave_max}",
            f"ingest-wave-interval = {self.ingest_wave_interval}",
            f"ingest-retry-after = {self.ingest_retry_after}",
            f"ingest-delta-max-batch = {self.ingest_delta_max_batch}",
            f'storage-faults = "{self.storage_faults}"',
            f"scrub-interval = {self.scrub_interval}",
            f"scrub-throttle = {self.scrub_throttle}",
            f"scrub-deep = {'true' if self.scrub_deep else 'false'}",
            f"scrub-repair = {'true' if self.scrub_repair else 'false'}",
            f"dispatch-enabled = {'true' if self.dispatch_enabled else 'false'}",
            f"dispatch-max-wave = {self.dispatch_max_wave}",
            f"dispatch-max-inflight = {self.dispatch_max_inflight}",
            f"dispatch-stage-ahead = {self.dispatch_stage_ahead}",
            f"tier1-max-bytes = {self.tier1_max_bytes}",
            f"prefetch-enabled = {'true' if self.prefetch_enabled else 'false'}",
            f"prefetch-depth = {self.prefetch_depth}",
            f"compressed-upload-min-ratio = {self.compressed_upload_min_ratio}",
            f"plan-cache-enabled = {'true' if self.plan_cache_enabled else 'false'}",
            f"plan-cache-max-bytes = {self.plan_cache_max_bytes}",
            f"plan-cache-min-cost = {self.plan_cache_min_cost}",
            f"fusion-enabled = {'true' if self.fusion_enabled else 'false'}",
            f"fusion-max-calls = {self.fusion_max_calls}",
            f"analytics-max-groups = {self.analytics_max_groups}",
            f"analytics-timeout = {self.analytics_timeout}",
            f"plan-cache-device-bytes = {self.plan_cache_device_bytes}",
            f"hbm-budget-bytes = {self.hbm_budget_bytes}",
            f'device-faults = "{self.device_faults}"',
            f"chaos-enabled = {'true' if self.chaos_enabled else 'false'}",
            f"profiler-hz = {self.profiler_hz}",
            f"hbm-watermark-pct = {self.hbm_watermark_pct}",
            f'slo-objectives = "{self.slo_objectives}"',
            f"slo-burn-threshold = {self.slo_burn_threshold}",
            f'tenant-weights = "{self.tenant_weights}"',
            f'tenant-qps = "{self.tenant_qps}"',
            f'tenant-hbm-quota = "{self.tenant_hbm_quota}"',
            f'tenant-inflight-bytes = "{self.tenant_inflight_bytes}"',
            f'tenant-objectives = "{self.tenant_objectives}"',
            f"heat-enabled = {'true' if self.heat_enabled else 'false'}",
            f"heat-decay-halflife = {self.heat_decay_halflife}",
            f'journal-dir = "{self.journal_dir}"',
            f"journal-max-bytes = {self.journal_max_bytes}",
            f'export-path = "{self.export_path}"',
            f'export-url = "{self.export_url}"',
            f"export-interval = {self.export_interval}",
            f"export-queue = {self.export_queue}",
            "",
            "[cluster]",
            f"disabled = {'true' if self.cluster.disabled else 'false'}",
            f"coordinator = {'true' if self.cluster.coordinator else 'false'}",
            f"replicas = {self.cluster.replicas}",
            f"hosts = {self.cluster.hosts!r}",
            f"long-query-time = {self.cluster.long_query_time}",
            f"probe-interval = {self.cluster.probe_interval}",
            f"probe-timeout = {self.cluster.probe_timeout}",
            f"down-after = {self.cluster.down_after}",
            f"status-interval = {self.cluster.status_interval}",
            "",
            "[tls]",
            f'certificate-path = "{self.tls.certificate_path}"',
            f'certificate-key-path = "{self.tls.certificate_key_path}"',
            f"skip-verify = {'true' if self.tls.skip_verify else 'false'}",
        ]
        return "\n".join(lines) + "\n"


def _mesh_on(cfg: Config) -> bool:
    want = cfg.mesh_devices
    if isinstance(want, str):
        want = want.strip().lower()
        return want not in ("", "0", "1", "none")
    return want not in (0, 1)


_A6 = "A6 (dispatch and autotune)"
_A8 = "A8 (the multi-device plane)"

# the setting, as TOML spells it -> (is it turned on?, the ROADMAP
# item that ports its subsystem)
_UNPORTED = {
    "dispatch-enabled = true": (lambda c: c.dispatch_enabled, _A6),
    "prefetch-enabled = true": (lambda c: c.prefetch_enabled, _A6),
    "mesh-devices > 1": (_mesh_on, _A8),
    "distributed-enabled = true": (lambda c: c.distributed_enabled, _A8),
    "distributed-coordinator": (lambda c: bool(c.distributed_coordinator), _A8),
    "distributed-faults": (lambda c: bool(c.distributed_faults), _A8),
    "federation-rejoin": (lambda c: bool(c.federation_rejoin), _A8),
    "federation-leader = true": (lambda c: c.federation_leader, _A8),
    "[cluster] disabled = false": (lambda c: not c.cluster.disabled, _A8),
    "[cluster] hosts": (lambda c: bool(c.cluster.hosts), _A8),
    "[cluster] coordinator-host": (lambda c: bool(c.cluster.coordinator_host), _A8),
    "scrub-interval > 0": (lambda c: c.scrub_interval > 0, _A8),
    # forwards every mint to another node: the cluster's translate plane
    "translate-primary-url": (lambda c: bool(c.translate_primary_url), _A8),
}
