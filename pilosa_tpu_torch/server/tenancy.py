"""Multi-tenant QoS — the index as the unit of isolation.

ROADMAP item 3 ("millions of users for real") needs more than key
translation: every index shares the pipeline class queues, the
HbmGovernor budgets by *subsystem* (stager / plan cache / scratch), and
one abusive dashboard can starve everyone's interactive p50. This module
is the policy layer that closes that gap; the mechanisms live where the
resources live and take their tenant policy from here:

* **Admission** (`TenancyManager.admit`): a token bucket per tenant —
  sustained rate from ``tenant-qps`` (explicit, else the default rate
  scaled by the tenant's weight) — plus an in-flight byte cap from
  ``tenant-inflight-bytes``. An exhausted tenant gets a clean
  ``TenantThrottled`` (HTTP 429 + an accurate ``Retry-After`` computed
  from its own refill rate) instead of a global ``Overloaded``: the
  abuser backs off, everyone else never notices. Internal legs of
  distributed queries are exempt — the origin node already charged the
  owning tenant, and throttling the cluster data plane mid-query would
  turn one tenant's burst into fleet-wide 500s.

* **Scheduling** (``weight``): each pipeline class queue dequeues
  weighted-fair across tenants (virtual-time WFQ, server/pipeline.py
  ``_TenantFairQueue``) using the weights configured here
  (``tenant-weights``, Ghodsi-style dominant-resource shares collapsed
  to one dimension — queue slots). A tenant's burst queues behind its
  own weight, not the fleet.

* **Memory** (``hbm_quota`` / ``over_hbm_quota``): per-tenant byte
  quotas enforced as HbmGovernor *sub-tenant* accounts — stager, T1,
  and device-plan-cache charges carry the index, relief sweeps prefer
  over-quota tenants first, and a tenant at quota degrades only its own
  queries (its blocks are the first evicted, including by its own
  inserts).

* **Attribution** (``slo_objectives`` + ``observe``): per-tenant SLO
  objectives (``tenant-objectives``) registered into the process
  ``slo.MONITOR`` under ``tenant:<index>`` keys so burn alerts and the
  existing gauge tick export per-tenant burn state through ``/metrics``
  and the fleet scrape; latency waterfalls grow a tenant dimension in
  utils/profiler.py.

Default config (no tenant keys set) must cost nothing and change
nothing: ``TenancyManager.enabled`` is False, ``admit`` returns without
taking a lock, and the pipeline keeps plain FIFO order — the gauntlet
stays bit-identical single-tenant.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from pilosa_tpu_torch.server.pipeline import CLASS_INTERNAL, Overloaded
from pilosa_tpu_torch.utils import metrics
from pilosa_tpu_torch.utils import slo as slo_mod

# objectives registered into the shared SLOMonitor use this prefix so
# per-tenant burn state coexists with the per-class objectives in one
# monitor (one tick, one scrape) without key collisions
TENANT_SLO_PREFIX = "tenant:"

# weights below this are clamped: a zero/negative weight would starve a
# tenant forever (and divide by zero in the WFQ virtual-time arithmetic)
MIN_WEIGHT = 1e-3


class TenantThrottled(Overloaded):
    """Per-tenant admission refused: the tenant's own token bucket (or
    in-flight byte cap) is exhausted. Always HTTP 429 with a
    ``Retry-After`` derived from the tenant's refill rate — distinct
    from a genuinely overloaded server (``Overloaded`` status 503), so
    well-behaved clients back off per-tenant while the rest of the
    fleet sees no error at all."""

    def __init__(self, message: str, retry_after: float = 1.0) -> None:
        super().__init__(message, retry_after=retry_after, status=429)


def parse_tenant_map(spec: str) -> tuple[dict[str, float], Optional[float]]:
    """``index=value[,...]`` → ({index: value}, default). The ``*`` key
    sets the default applied to unlisted tenants. Malformed entries are
    skipped — a telemetry/QoS knob must not fail the boot."""
    out: dict[str, float] = {}
    default: Optional[float] = None
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, rhs = part.partition("=")
        try:
            val = float(rhs.strip())
        except ValueError:
            continue
        if val < 0:
            continue
        name = name.strip()
        if name == "*":
            default = val
        elif name:
            out[name] = val
    return out, default


def parse_tenant_objectives(spec: str) -> tuple[dict, Optional[tuple]]:
    """``index=latency_ms@target[,...]`` → ({index: (latency_s,
    target)}, default-or-None). Same grammar as slo.parse_objectives
    plus the ``*`` default key."""
    parsed = slo_mod.parse_objectives(spec) if (spec or "").strip() else {}
    default = parsed.pop("*", None)
    return parsed, default


class _Bucket:
    """One tenant's admission state: a token bucket (qps) plus an
    in-flight byte ledger. Mutated under the manager lock only."""

    __slots__ = ("tokens", "t_refill", "inflight_bytes", "throttled", "admitted")

    def __init__(self, burst: float) -> None:
        self.tokens = burst
        self.t_refill = time.monotonic()
        self.inflight_bytes = 0
        self.throttled = 0
        self.admitted = 0


class TenancyManager:
    """Per-index QoS policy: weights, admission buckets, HBM quotas,
    SLO objectives. One instance per server, threaded into the pipeline
    (scheduling + admission), the HBM governor (quotas), and the
    handler (attribution)."""

    def __init__(
        self,
        weights: str = "",
        qps: str = "",
        hbm_quota: str = "",
        inflight_bytes: str = "",
        objectives: str = "",
        default_qps: float = 0.0,
        burst_s: float = 2.0,
    ) -> None:
        self._weights, wdef = parse_tenant_map(weights)
        self.default_weight = max(MIN_WEIGHT, wdef if wdef is not None else 1.0)
        self._weights = {
            k: max(MIN_WEIGHT, v) for k, v in self._weights.items()
        }
        self._qps, qdef = parse_tenant_map(qps)
        # unlisted tenants: explicit * default, else the global default
        # rate scaled by the tenant's weight (0 = no rate limit)
        self.default_qps = qdef if qdef is not None else float(default_qps)
        self._quotas_f, quota_def = parse_tenant_map(hbm_quota)
        self.default_hbm_quota = int(quota_def) if quota_def else 0
        self._inflight, idef = parse_tenant_map(inflight_bytes)
        self.default_inflight_bytes = int(idef) if idef else 0
        self.tenant_objectives, self.default_objective = (
            parse_tenant_objectives(objectives)
        )
        # a burst of ``burst_s`` seconds at the sustained rate: absorbs
        # a dashboard redraw without tripping, still bounds the abuser
        self.burst_s = float(burst_s)
        # enabled only when some per-tenant policy is configured — the
        # single-tenant default must stay a zero-cost passthrough
        self.enabled = bool(
            self._weights
            or wdef is not None
            or self._qps
            or self.default_qps > 0
            or self._quotas_f
            or self.default_hbm_quota
            or self._inflight
            or self.default_inflight_bytes
            or self.tenant_objectives
            or self.default_objective is not None
        )
        self._mu = threading.Lock()
        self._buckets: dict[str, _Bucket] = {}

    # -- scheduling weight ----------------------------------------------------

    def weight(self, index: str) -> float:
        return self._weights.get(index, self.default_weight)

    # -- HBM quota ------------------------------------------------------------

    def hbm_quota(self, index: str) -> int:
        """Byte quota for one tenant's total HBM-domain footprint
        (stager blocks + device plan cache). 0 = unlimited."""
        q = self._quotas_f.get(index)
        return int(q) if q is not None else self.default_hbm_quota

    def hbm_quotas(self) -> dict[str, int]:
        return {k: int(v) for k, v in self._quotas_f.items()}

    # -- admission ------------------------------------------------------------

    def _rate(self, index: str) -> float:
        r = self._qps.get(index)
        if r is not None:
            return r
        if self.default_qps <= 0:
            return 0.0
        return self.default_qps * (self.weight(index) / self.default_weight)

    def _inflight_limit(self, index: str) -> int:
        lim = self._inflight.get(index)
        return int(lim) if lim is not None else self.default_inflight_bytes

    def admit(self, index: str, cls: str, nbytes: int = 0) -> None:
        """Charge one request against ``index``'s bucket; raises
        ``TenantThrottled`` (HTTP 429) when the tenant is over its own
        rate or byte cap. Internal legs are exempt (see module doc).
        Every admit must be paired with ``release`` — the pipeline does
        this in ``submit``'s finally."""
        if not self.enabled or cls == CLASS_INTERNAL:
            return
        rate = self._rate(index)
        limit = self._inflight_limit(index)
        if rate <= 0 and limit <= 0:
            return
        now = time.monotonic()
        with self._mu:
            b = self._buckets.get(index)
            if b is None:
                b = self._buckets[index] = _Bucket(
                    burst=max(1.0, rate * self.burst_s)
                )
            if rate > 0:
                burst = max(1.0, rate * self.burst_s)
                b.tokens = min(burst, b.tokens + (now - b.t_refill) * rate)
                b.t_refill = now
                if b.tokens < 1.0:
                    b.throttled += 1
                    retry = (1.0 - b.tokens) / rate
                    metrics.count(
                        metrics.TENANT_THROTTLED, tenant=index, reason="qps"
                    )
                    raise TenantThrottled(
                        f"tenant {index!r} over its query rate "
                        f"({rate:g}/s); retry later",
                        retry_after=max(0.001, retry),
                    )
            if limit > 0 and nbytes > 0 and (
                b.inflight_bytes + nbytes > limit and b.inflight_bytes > 0
            ):
                b.throttled += 1
                metrics.count(
                    metrics.TENANT_THROTTLED, tenant=index, reason="bytes"
                )
                raise TenantThrottled(
                    f"tenant {index!r} over its in-flight byte cap "
                    f"({b.inflight_bytes}/{limit}); retry later",
                    retry_after=0.05,
                )
            if rate > 0:
                b.tokens -= 1.0
            b.inflight_bytes += int(nbytes)
            b.admitted += 1
            inflight = b.inflight_bytes
        metrics.gauge(metrics.TENANT_INFLIGHT_BYTES, inflight, tenant=index)

    def release(self, index: str, cls: str, nbytes: int = 0) -> None:
        if not self.enabled or cls == CLASS_INTERNAL or nbytes <= 0:
            return
        with self._mu:
            b = self._buckets.get(index)
            if b is None:
                return
            b.inflight_bytes = max(0, b.inflight_bytes - int(nbytes))
            inflight = b.inflight_bytes
        metrics.gauge(metrics.TENANT_INFLIGHT_BYTES, inflight, tenant=index)

    # -- SLO attribution ------------------------------------------------------

    def slo_objectives(self) -> dict:
        """Objectives to merge into the process SLOMonitor, keyed
        ``tenant:<index>``. Explicitly listed tenants only — tenants
        covered by the ``*`` default are registered lazily on first
        ``observe`` (their names are not known at boot)."""
        return {
            TENANT_SLO_PREFIX + idx: obj
            for idx, obj in self.tenant_objectives.items()
        }

    def observe(self, index: str, duration_s: float, ok: bool) -> None:
        """Record one served query against the tenant's SLO objective
        (lazily registering ``*``-default tenants) and its latency
        summary metric."""
        if not self.enabled or not index:
            return
        key = TENANT_SLO_PREFIX + index
        mon = slo_mod.MONITOR
        if not mon.has_class(key):
            obj = self.tenant_objectives.get(index) or self.default_objective
            if obj is None:
                return
            mon.ensure_class(key, obj)
        mon.record(key, duration_s, ok=ok)

    # -- observability --------------------------------------------------------

    def snapshot(self) -> dict:
        with self._mu:
            buckets = {
                idx: {
                    "admitted": b.admitted,
                    "throttled": b.throttled,
                    "inflight_bytes": b.inflight_bytes,
                    "tokens": round(b.tokens, 3),
                }
                for idx, b in self._buckets.items()
            }
        known = set(self._weights) | set(self._qps) | set(buckets)
        return {
            "enabled": self.enabled,
            "default_weight": self.default_weight,
            "default_qps": self.default_qps,
            "default_hbm_quota": self.default_hbm_quota,
            "tenants": {
                idx: {
                    "weight": self.weight(idx),
                    "qps": self._rate(idx),
                    "hbm_quota": self.hbm_quota(idx),
                    **buckets.get(idx, {}),
                }
                for idx in sorted(known)
            },
        }
