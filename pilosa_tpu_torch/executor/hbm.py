"""HBM-pressure governance and OOM recovery.

The port of ``pilosa_tpu/executor/hbm.py``, the ledger and the recovery
policy as they are; ``classify_device_error`` also knows CUDA's errors
(``torch.cuda.OutOfMemoryError`` is an allocation failure, a CUDA
runtime error a wedge, and a launch the port's own kernel refused,
``ops.cuda.LaunchError``, no device error at all). ``_telemetry_relief``
reads the card's allocated bytes from ``profiler.TELEMETRY`` and, where
the reference asks for ledger headroom (inert while the ledger is under
its budget by more than the device's excess, which a budget of a tenth
of the card always is), frees the excess itself, once per telemetry
sample (ROADMAP C8).

In the reference, staging made HBM load-bearing: staged fragment blocks, device-resident
plan-cache entries, batcher pad scratch, and fused whole-query launches
all compete for the same accelerator memory — previously under three
*independent* byte budgets that could jointly overcommit the chip, and
with no handling at all for an allocation failure (``RESOURCE_EXHAUSTED``
surfaced as an unhandled 500). Two pieces fix that:

* ``HbmGovernor`` — one process-wide byte ledger every HBM tenant
  reserves against. The old per-subsystem knobs survive as per-tenant
  *shares* of the global budget; the global budget is the sum of shares
  unless pinned smaller by ``hbm-budget-bytes``. When the ledger runs
  over (or live ``DeviceTelemetry`` gauges show real HBM pressure), the
  governor relieves in tiers: the device plan cache first (pure derived
  state, cheapest to rebuild), then cold stager blocks. Fused launches
  consult ``admit()`` with their estimated transient peak BEFORE
  launching, so a wave that cannot fit is split or routed to the classic
  per-call path instead of launched into an OOM.

* ``OomRecovery`` — the policy applied at the device-call boundaries
  (``_timed_kernel``, the fused launch, the batched scorers): classify
  the failure (allocation vs. wedge), journal ``device.oom``, then for
  an allocation failure evict through the governor tiers and retry the
  call ONCE; if the retry also fails (or the error is a wedge-class
  runtime fault) the call degrades to the CPU roaring leg by raising
  ``DeviceOom`` — a ``DeviceDown`` subclass, so the executor's existing
  fallback path serves the query from host bitmaps. ``DeviceHealth``
  trips only on REPEAT unrecovered failures inside a short window —
  never a wedged process, never a wrong answer, and a single transient
  OOM never gates a healthy device off.

Lock discipline: the governor's ledger lock is never held across a
tenant eviction callback (those take the stager/plan-cache locks), and
tenants never call back into the governor while holding their own locks
in a way that re-enters ``relieve`` on themselves — ``reserve`` excludes
the requesting tenant from the budget relief sweep; the tenant's own LRU
loop handles its share. The telemetry sweep takes every tier, the
reserving tenant's too (no tenant reserves under its own lock: the
stager and the device plan cache reserve outside theirs).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from pilosa_tpu_torch.analysis.locks import OrderedLock
from pilosa_tpu_torch.executor.devicehealth import DeviceDown
from pilosa_tpu_torch.ops.cuda import LaunchError
from pilosa_tpu_torch.utils import events, metrics


class DeviceOom(DeviceDown):
    """An unrecovered device allocation failure. Subclasses DeviceDown
    so the executor's existing guarded-call fallback serves the query
    from the CPU roaring path; the health gate is NOT tripped (that is
    OomRecovery's call, and only on repeat failure)."""


# -- error classification -----------------------------------------------------

# substrings that mark an allocation failure (XLA RESOURCE_EXHAUSTED,
# PJRT "out of memory", CUDA's "CUDA out of memory", injected faults)
_ALLOC_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory", "OOM")
# exception type names raised by device runtime failures: jax/XLA's,
# and torch's for a CUDA error outside an allocation
_RUNTIME_TYPES = ("XlaRuntimeError", "JaxRuntimeError", "AcceleratorError")
_WEDGE_MARKERS = (
    "INTERNAL:",
    "DATA_LOSS",
    "FAILED_PRECONDITION",
    "ABORTED",
    # CUDA runtime errors (an illegal address, a launch failure): after
    # one the context is dead for the life of the process
    "CUDA error",
    "cudaError",
)


def classify_device_error(exc: BaseException) -> Optional[str]:
    """``"alloc"`` for an allocation failure (eviction + retry can
    help), ``"wedge"`` for a non-allocation device runtime fault
    (retry is pointless; degrade and let repeat failures trip the
    health gate), ``None`` for anything that is not a device error —
    those propagate untouched (a shape bug must stay a loud bug)."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "alloc"
    if isinstance(exc, LaunchError):
        # the port's own kernel refused its launch: a bug to see, not a
        # card to degrade
        return None
    text = f"{type(exc).__name__}: {exc}"
    if any(m in text for m in _ALLOC_MARKERS):
        return "alloc"
    if type(exc).__name__ in _RUNTIME_TYPES:
        return "wedge"
    if any(m in text for m in _WEDGE_MARKERS):
        return "wedge"
    return None


# -- the byte ledger ----------------------------------------------------------


class _Tenant:
    __slots__ = (
        "name", "share", "evict_fn", "tier", "domain", "used",
        "by_index", "prefer_ok",
    )

    def __init__(
        self, name: str, share: int, evict_fn, tier: int, domain: str = "hbm"
    ) -> None:
        self.name = name
        self.share = share
        self.evict_fn = evict_fn
        self.tier = tier
        # "hbm" tenants hold device memory and count against the global
        # budget; "host" tenants (the T1 container tier) ride the same
        # ledger for visibility and stats but never trigger — or are
        # swept by — device pressure relief
        self.domain = domain
        self.used = 0
        # sub-tenant accounting: bytes by owning INDEX —
        # "tenant" in the multi-tenant sense, vs this class which is a
        # registered SUBSYSTEM account. Only charges that name an index
        # land here; used - sum(by_index) is unattributed scratch.
        self.by_index: dict[str, int] = {}
        # whether evict_fn accepts the quota-relief ``prefer=`` kwarg
        self.prefer_ok = False


class HbmGovernor:
    """One process-wide HBM byte ledger with tiered pressure relief.

    Tenants register with a *share* (their old standalone budget — the
    per-tenant cap) and optionally an ``evict_fn(need_bytes) -> freed``
    callback plus a *tier* (lower tiers evict first). ``reserve`` /
    ``release`` keep the ledger; a reserve that pushes the TOTAL over
    the global budget triggers a relief sweep over the OTHER tenants'
    tiers (the requester's own LRU loop handles its share), and reports
    whether the ledger is back under budget. ``admit`` answers the
    fused-launch admission question: does an estimated transient peak
    fit in current headroom (relieving first if not)?
    """

    # fraction of the live telemetry limit above which a reserve/admit
    # opportunistically relieves pressure even when the ledger itself
    # is under budget (mirrors the profiler's hbm-watermark default)
    TELEMETRY_WATERMARK = 0.9

    def __init__(self, budget_bytes: int = 0) -> None:
        # the telemetry sample (TELEMETRY.last) the watermark relief last
        # acted on: one sweep per sample above the watermark
        self._relieved_sample = None
        # 0 = derive from the sum of registered shares (the compatible
        # default: each tenant capped at its old knob, total capped at
        # their sum); > 0 pins the global budget below that sum — the
        # double-budget overcommit fix
        self.budget_bytes = int(budget_bytes)
        self._mu = OrderedLock("hbm.governor_mu")
        self._tenants: dict[str, _Tenant] = {}
        # per-INDEX byte quotas (tenant-hbm-quota): caps one
        # tenant's total footprint across all hbm-domain subsystems;
        # 0 / absent = unlimited
        self._index_quotas: dict[str, int] = {}
        self._default_index_quota = 0

    # -- registration ---------------------------------------------------------

    def register(
        self,
        name: str,
        share_bytes: int = 0,
        evict_fn: Optional[Callable[[int], int]] = None,
        tier: int = 99,
        domain: str = "hbm",
    ) -> None:
        prefer_ok = False
        if evict_fn is not None:
            try:
                import inspect

                prefer_ok = "prefer" in inspect.signature(evict_fn).parameters
            except (TypeError, ValueError):
                prefer_ok = False
        with self._mu:
            t = self._tenants.get(name)
            if t is None:
                t = _Tenant(name, int(share_bytes), evict_fn, tier, domain)
                self._tenants[name] = t
            else:
                t.share = int(share_bytes)
                t.evict_fn = evict_fn
                t.tier = tier
                t.domain = domain
            t.prefer_ok = prefer_ok

    def set_index_quotas(
        self, quotas: dict[str, int], default: int = 0
    ) -> None:
        """Install per-index byte quotas (server wiring, from
        ``tenant-hbm-quota``). A reserve that pushes an index past its
        quota triggers a targeted sweep of THAT index's blocks only."""
        with self._mu:
            self._index_quotas = {k: int(v) for k, v in quotas.items()}
            self._default_index_quota = int(default)

    # -- accounting -----------------------------------------------------------

    def budget(self) -> int:
        with self._mu:
            return self._budget_locked()

    def _budget_locked(self) -> int:
        if self.budget_bytes > 0:
            return self.budget_bytes
        return sum(
            t.share for t in self._tenants.values() if t.domain == "hbm"
        ) or (8 << 30)

    def used(self, name: Optional[str] = None) -> int:
        with self._mu:
            if name is not None:
                t = self._tenants.get(name)
                return t.used if t is not None else 0
            return sum(t.used for t in self._tenants.values())

    def headroom(self) -> int:
        with self._mu:
            return self._budget_locked() - sum(
                t.used for t in self._tenants.values() if t.domain == "hbm"
            )

    def over_budget(self) -> int:
        """Bytes the ledger currently exceeds the global budget by
        (0 when under). Tenants consult this in their own LRU-evict
        loops so evicting their entries converges the global ledger,
        not just their share."""
        return max(0, -self.headroom())

    def reserve(self, name: str, nbytes: int, index: str = "") -> bool:
        """Record ``nbytes`` against ``name``'s account (and, when the
        charge names its owning ``index``, that tenant's sub-account).
        Always records (the bytes are already being uploaded — the
        ledger must reflect reality); returns False when the ledger
        remains over budget after relieving the OTHER tenants, in which
        case the caller evicts its own LRU entries (its loop also
        checks ``over_budget``)."""
        nbytes = int(nbytes)
        quota_excess = 0
        with self._mu:
            t = self._tenants.get(name)
            if t is None:
                t = _Tenant(name, 0, None, 99)
                self._tenants[name] = t
            t.used += nbytes
            used = t.used
            if index:
                t.by_index[index] = t.by_index.get(index, 0) + nbytes
                idx_used = self._index_used_locked(index)
                quota = self._index_quota_locked(index)
                if quota > 0 and idx_used > quota:
                    quota_excess = idx_used - quota
        metrics.gauge(metrics.HBM_GOVERNOR_BYTES, used, tenant=name)
        if index:
            metrics.gauge(
                metrics.TENANT_HBM_BYTES, self.index_used(index), tenant=index
            )
        if quota_excess > 0:
            # over ITS quota, not the global budget: sweep only this
            # index's blocks — a tenant at quota degrades only its own
            # queries
            self.relieve_index(index, quota_excess)
        if self.over_budget() > 0:
            self.relieve(exclude=name)
        self._telemetry_relief()
        return self.over_budget() <= 0

    def release(self, name: str, nbytes: int, index: str = "") -> None:
        with self._mu:
            t = self._tenants.get(name)
            if t is None:
                return
            t.used = max(0, t.used - int(nbytes))
            used = t.used
            if index and index in t.by_index:
                left = t.by_index[index] - int(nbytes)
                if left > 0:
                    t.by_index[index] = left
                else:
                    del t.by_index[index]
        metrics.gauge(metrics.HBM_GOVERNOR_BYTES, used, tenant=name)
        if index:
            metrics.gauge(
                metrics.TENANT_HBM_BYTES, self.index_used(index), tenant=index
            )

    def reset(self, name: Optional[str] = None) -> None:
        """Zero an account (or every account): the wedge-recovery /
        epoch-fence path — the arrays the ledger tracked died with the
        device context, so the ledger must not remember them."""
        with self._mu:
            tenants = (
                [self._tenants[name]] if name in self._tenants else []
            ) if name is not None else list(self._tenants.values())
            for t in tenants:
                t.used = 0
                t.by_index.clear()
        for t in tenants:
            metrics.gauge(metrics.HBM_GOVERNOR_BYTES, 0, tenant=t.name)

    # -- per-index (multi-tenant) accounting ----------------------------------

    def _index_quota_locked(self, index: str) -> int:
        return self._index_quotas.get(index, self._default_index_quota)

    def _index_used_locked(self, index: str, domain: str = "hbm") -> int:
        return sum(
            t.by_index.get(index, 0)
            for t in self._tenants.values()
            if t.domain == domain
        )

    def index_used(self, index: str) -> int:
        """One tenant's total HBM-domain bytes across subsystems."""
        with self._mu:
            return self._index_used_locked(index)

    def index_over_quota(self, index: str) -> int:
        """Bytes ``index`` currently exceeds its quota by (0 when under
        or unlimited)."""
        with self._mu:
            quota = self._index_quota_locked(index)
            if quota <= 0:
                return 0
            return max(0, self._index_used_locked(index) - quota)

    def over_quota_indexes(self) -> list[str]:
        """Indexes above their quota, worst offender first — the
        relief sweep's preference list."""
        with self._mu:
            excess = {}
            for t in self._tenants.values():
                if t.domain != "hbm":
                    continue
                for idx, used in t.by_index.items():
                    excess[idx] = excess.get(idx, 0) + used
            out = []
            for idx, used in excess.items():
                quota = self._index_quota_locked(idx)
                if quota > 0 and used > quota:
                    out.append((used - quota, idx))
        return [idx for _, idx in sorted(out, reverse=True)]

    def relieve_index(self, index: str, need: int) -> int:
        """Targeted quota sweep: free ``need`` bytes belonging to ONE
        index, walking the tiers with ``prefer=[index]`` so only that
        tenant's blocks are touched. Callbacks run without the
        governor lock."""
        with self._mu:
            tiers = sorted(
                (
                    t
                    for t in self._tenants.values()
                    if t.evict_fn is not None
                    and t.domain == "hbm"
                    and t.prefer_ok
                ),
                key=lambda t: t.tier,
            )
        freed_total = 0
        for t in tiers:
            deficit = int(need) - freed_total
            if deficit <= 0:
                break
            try:
                freed = int(t.evict_fn(deficit, prefer=[index]) or 0)
            except Exception:
                freed = 0
            if freed > 0:
                freed_total += freed
                metrics.count(metrics.HBM_GOVERNOR_EVICTIONS, tier=t.name)
                metrics.count(
                    metrics.TENANT_HBM_EVICTIONS, tenant=index, tier=t.name
                )
        return freed_total

    # -- admission + relief ---------------------------------------------------

    def admit(self, nbytes: int) -> bool:
        """Fused-launch admission: does an estimated transient peak of
        ``nbytes`` fit in current headroom? Relieves the tiers first
        when it would not — admission prefers evicting rebuildable
        cache state over refusing a launch."""
        nbytes = int(nbytes)
        if nbytes <= self.headroom():
            return True
        self.relieve(need=nbytes)
        return nbytes <= self.headroom()

    def relieve(self, need: int = 0, exclude: Optional[str] = None) -> int:
        """Evict through the tiers (device plan cache first, then cold
        stager blocks) until the ledger has ``need`` bytes of headroom
        (or, with ``need=0``, is back under budget). When some index is
        over its byte quota the sweep walks the tiers TWICE: first
        constrained to the over-quota tenants' blocks (prefer pass),
        then classic LRU for whatever deficit remains — an under-quota
        tenant loses a block only after every over-quota tenant's
        excess is gone. Callbacks run WITHOUT the governor lock — they
        take their owners' locks and call ``release`` re-entrantly.
        Returns bytes freed."""
        with self._mu:
            tiers = sorted(
                (
                    t
                    for t in self._tenants.values()
                    if t.evict_fn is not None and t.domain == "hbm"
                ),
                key=lambda t: t.tier,
            )
            have_quotas = bool(self._index_quotas or self._default_index_quota)
        freed_total = 0
        passes = [None]
        if have_quotas:
            prefer = self.over_quota_indexes()
            if prefer:
                passes = [prefer, None]
        for prefer in passes:
            for t in tiers:
                deficit = (
                    max(0, int(need) - self.headroom())
                    if need
                    else self.over_budget()
                )
                if deficit <= 0:
                    return freed_total
                if t.name == exclude:
                    continue
                try:
                    if prefer is not None:
                        if not t.prefer_ok:
                            continue
                        freed = int(t.evict_fn(deficit, prefer=prefer) or 0)
                    else:
                        freed = int(t.evict_fn(deficit) or 0)
                except Exception:
                    freed = 0
                if freed > 0:
                    freed_total += freed
                    metrics.count(metrics.HBM_GOVERNOR_EVICTIONS, tier=t.name)
        return freed_total

    def relieve_for_oom(self, need: Optional[int] = None) -> int:
        """The aggressive post-OOM sweep: a real RESOURCE_EXHAUSTED
        means the chip is out of memory regardless of what the ledger
        believed (XLA scratch and fusion intermediates are invisible to
        it), so skip the deficit arithmetic and ask every tier to free
        everything it can before the single retry. With ``need`` (the
        telemetry relief), stop once that many bytes are freed.
        Callbacks run without the governor lock. Returns bytes freed."""
        with self._mu:
            tiers = sorted(
                (
                    t
                    for t in self._tenants.values()
                    if t.evict_fn is not None and t.domain == "hbm"
                ),
                key=lambda t: t.tier,
            )
            budget = self._budget_locked()
        freed_total = 0
        for t in tiers:
            if need is not None and freed_total >= need:
                break
            try:
                freed = int(t.evict_fn(budget if need is None else need - freed_total) or 0)
            except Exception:
                freed = 0
            if freed > 0:
                freed_total += freed
                metrics.count(metrics.HBM_GOVERNOR_EVICTIONS, tier=t.name)
        return freed_total

    def _telemetry_relief(self) -> None:
        """Pressure relief driven by live device-memory gauges: when the
        newest telemetry sample shows the card's allocated bytes above
        the watermark, free that excess through the tiers even though
        the ledger itself is under budget (the ledger only sees OUR
        tenants; the allocator sees every tensor). One sweep per sample:
        the gauges move only when the poller samples again, and a sweep
        per reserve would empty the caches while one sample stands."""
        try:
            from pilosa_tpu_torch.utils import profiler

            last = profiler.TELEMETRY.last or {}
            devices = last.get("devices") or {}
        except Exception:
            return
        for dev in devices.values():
            in_use = dev.get("bytes_in_use") or 0
            limit = dev.get("bytes_limit") or 0
            if limit and in_use > limit * self.TELEMETRY_WATERMARK:
                with self._mu:
                    if self._relieved_sample is last:
                        return
                    self._relieved_sample = last
                self.relieve_for_oom(need=int(in_use - limit * self.TELEMETRY_WATERMARK))
                return

    def stats(self) -> dict:
        with self._mu:
            by_index: dict[str, int] = {}
            for t in self._tenants.values():
                if t.domain != "hbm":
                    continue
                for idx, used in t.by_index.items():
                    by_index[idx] = by_index.get(idx, 0) + used
            out = {
                "budget_bytes": self._budget_locked(),
                "used_bytes": sum(
                    t.used for t in self._tenants.values() if t.domain == "hbm"
                ),
                # "domain" only on off-device tenants (e.g. the tier1
                # host cache) — device tenants keep the classic shape
                "tenants": {
                    t.name: {
                        "used": t.used,
                        "share": t.share,
                        "tier": t.tier,
                        **({"domain": t.domain} if t.domain != "hbm" else {}),
                        **(
                            {"by_index": dict(t.by_index)}
                            if t.by_index
                            else {}
                        ),
                    }
                    for t in self._tenants.values()
                },
            }
            if self._index_quotas or self._default_index_quota:
                out["index_quotas"] = {
                    "default": self._default_index_quota,
                    **self._index_quotas,
                }
            if by_index:
                out["index_used"] = by_index
        return out


# -- OOM recovery at the device-call boundaries -------------------------------


class OomRecovery:
    """Evict → retry once → degrade-to-CPU, with health tripped only on
    repeat failure. One instance per executor, shared by ``_timed_kernel``
    closures, the fused launcher, and the batched scorers."""

    def __init__(
        self,
        governor: Optional[HbmGovernor] = None,
        health=None,
        on_degrade: Optional[Callable[[], None]] = None,
        trip_after: int = 2,
        window_s: float = 30.0,
    ) -> None:
        self.governor = governor
        self.health = health
        self.on_degrade = on_degrade
        self.trip_after = trip_after
        self.window_s = window_s
        self._mu = threading.Lock()
        self._failures: list[float] = []  # monotonic stamps of degrades
        # telemetry (read by stats/tests)
        self.ooms = 0
        self.recovered = 0
        self.degraded = 0

    def run(self, fn: Callable, kind: str = "kernel"):
        """Run a device call under the recovery policy. Raises
        ``DeviceOom`` when the call must degrade to the CPU leg;
        re-raises non-device errors untouched."""
        try:
            return fn()
        except Exception as e:
            cls = classify_device_error(e)
            if cls is None:
                raise
            with self._mu:
                self.ooms += 1
            metrics.count(metrics.DEVICE_OOM, kind=kind, cls=cls)
            events.record(
                events.DEVICE_OOM, boundary=kind, cls=cls, error=str(e)[:200]
            )
            if cls == "alloc":
                if self.governor is not None:
                    self.governor.relieve_for_oom()
                try:
                    out = fn()
                except Exception as e2:
                    if classify_device_error(e2) is None:
                        raise
                else:
                    with self._mu:
                        self.recovered += 1
                        self._failures.clear()
                    metrics.count(metrics.DEVICE_OOM_RECOVERED, path="retry")
                    events.record(
                        events.DEVICE_OOM_RECOVERED, boundary=kind, path="retry"
                    )
                    return out
            # allocation retry failed too, or a wedge-class fault:
            # degrade this call to the CPU leg and remember the failure
            self._degrade(kind, e)

    def _degrade(self, kind: str, cause: BaseException) -> None:
        now = time.monotonic()
        with self._mu:
            self.degraded += 1
            self._failures = [
                t for t in self._failures if now - t < self.window_s
            ]
            self._failures.append(now)
            repeat = len(self._failures) >= self.trip_after
        metrics.count(metrics.DEVICE_OOM_CPU_DEGRADES)
        metrics.count(metrics.DEVICE_OOM_RECOVERED, path="cpu")
        events.record(events.DEVICE_OOM_RECOVERED, boundary=kind, path="cpu")
        cb = self.on_degrade
        if cb is not None:
            try:
                cb()
            except Exception:
                pass
        if repeat and self.health is not None:
            # repeat unrecovered failures inside the window: this is no
            # longer a transient — gate the device and let the probe
            # loop + restore callback rebuild the device-side machinery
            try:
                self.health.trip("repeated unrecovered device OOM")
            except Exception:
                pass
        raise DeviceOom(f"device {kind} failed after OOM recovery") from cause

    def stats(self) -> dict:
        with self._mu:
            return {
                "ooms": self.ooms,
                "recovered": self.recovered,
                "degraded": self.degraded,
                "recent_failures": len(self._failures),
            }
