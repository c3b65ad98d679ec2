"""SLO burn-rate monitoring — multi-window error-budget
burn alerts in the Google SRE workbook style.

Per request class (interactive / bulk / internal) the config declares a
latency threshold and an availability target, e.g.
``interactive=250@0.999``: 99.9% of interactive queries should complete
OK within 250 ms. A query is *good* when it succeeds AND meets the
latency threshold; everything else consumes error budget
(``1 − target``).

Burn rate over a trailing window is ``bad_fraction / budget`` — 1.0
burns the budget exactly at the end of the nominal 30-day period, 14.4
burns it in two days. An alert fires only when BOTH the short (5m) and
long (1h) windows exceed ``slo-burn-threshold``: the long window proves
it matters, the short window proves it's still happening. Firing is
edge-triggered per class with a cooldown, journaling one ``slo.burn``
event per episode and bumping the ``slo.burns`` counter.

Implementation: a ring of 10-second buckets per class covering the long
window — bounded memory, O(window/10s) to read, lock-cheap to write.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from pilosa_tpu_torch.utils import events, metrics

BUCKET_S = 10.0
SHORT_WINDOW_S = 5 * 60.0
LONG_WINDOW_S = 60 * 60.0

WINDOWS = (("5m", SHORT_WINDOW_S), ("1h", LONG_WINDOW_S))

DEFAULT_OBJECTIVES = "interactive=250@0.999,bulk=2000@0.99,internal=500@0.999"


def parse_objectives(spec: str) -> dict:
    """``cls=latency_ms@target[,...]`` → {cls: (latency_s, target)}.
    Malformed entries are skipped (config must not fail the boot over a
    telemetry knob); an empty result falls back to the defaults."""
    out: dict = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        cls, _, rhs = part.partition("=")
        lat_ms, _, target = rhs.partition("@")
        try:
            lat_s = float(lat_ms) / 1000.0
            tgt = float(target) if target else 0.999
        except ValueError:
            continue
        if lat_s <= 0.0 or not (0.0 < tgt < 1.0):
            continue
        out[cls.strip()] = (lat_s, tgt)
    if not out and spec != "":
        return parse_objectives(DEFAULT_OBJECTIVES)
    return out


class _ClassState:
    __slots__ = ("buckets", "latency_s", "target", "last_burn_t", "firing")

    def __init__(self, latency_s: float, target: float) -> None:
        self.latency_s = latency_s
        self.target = target
        # bucket index -> [good, bad]; dict keyed by absolute bucket
        # number, pruned to the long window on write
        self.buckets: dict = {}
        self.last_burn_t = 0.0
        self.firing = False


class SLOMonitor:
    """Per-class good/bad sample accounting + multi-window burn rate."""

    def __init__(
        self,
        objectives: Optional[dict] = None,
        burn_threshold: float = 14.4,
        cooldown_s: float = 300.0,
    ) -> None:
        self._mu = threading.Lock()
        self.burn_threshold = burn_threshold
        self.cooldown_s = cooldown_s
        self._classes: dict = {}
        self.configure(objectives or parse_objectives(DEFAULT_OBJECTIVES))

    def configure(self, objectives: dict, burn_threshold: Optional[float] = None) -> None:
        with self._mu:
            if burn_threshold is not None:
                self.burn_threshold = burn_threshold
            self._classes = {
                cls: _ClassState(lat, tgt) for cls, (lat, tgt) in objectives.items()
            }

    def has_class(self, cls: str) -> bool:
        with self._mu:
            return cls in self._classes

    def ensure_class(self, cls: str, objective: tuple) -> None:
        """Register one objective without touching the rest — the
        lazy-registration path for ``tenant:<index>`` keys covered by a
        ``*`` default (server/tenancy.py): tenant names are not known
        at configure time, only at first query."""
        lat, tgt = objective
        with self._mu:
            if cls not in self._classes:
                self._classes[cls] = _ClassState(lat, tgt)

    def merge(self, objectives: dict) -> None:
        """Add/replace objectives, keeping existing ones — used to lay
        per-tenant objectives over the per-class set."""
        with self._mu:
            for cls, (lat, tgt) in objectives.items():
                self._classes[cls] = _ClassState(lat, tgt)

    def record(self, cls: str, duration_s: float, ok: bool, now: Optional[float] = None) -> None:
        """Account one served query. Unknown classes are ignored (no
        objective → no budget to burn)."""
        t = time.monotonic() if now is None else now
        with self._mu:
            st = self._classes.get(cls)
            if st is None:
                return
            good = ok and duration_s <= st.latency_s
            b = int(t / BUCKET_S)
            row = st.buckets.get(b)
            if row is None:
                row = st.buckets[b] = [0, 0]
                horizon = b - int(LONG_WINDOW_S / BUCKET_S) - 1
                for k in [k for k in st.buckets if k < horizon]:
                    del st.buckets[k]
            row[0 if good else 1] += 1

    def _window_bad_fraction(self, st: _ClassState, window_s: float, now: float) -> Optional[float]:
        lo = int((now - window_s) / BUCKET_S)
        good = bad = 0
        for b, (g, e) in st.buckets.items():
            if b > lo:
                good += g
                bad += e
        total = good + bad
        if total == 0:
            return None
        return bad / total

    def burn_rates(self, now: Optional[float] = None) -> dict:
        """{cls: {window: burn_rate}} over both windows; a window with
        no samples reports 0.0 (no traffic burns no budget)."""
        t = time.monotonic() if now is None else now
        out: dict = {}
        with self._mu:
            for cls, st in self._classes.items():
                budget = 1.0 - st.target
                rates = {}
                for wname, wsec in WINDOWS:
                    bf = self._window_bad_fraction(st, wsec, t)
                    rates[wname] = 0.0 if bf is None else round(bf / budget, 3)
                out[cls] = rates
        return out

    def tick(self, now: Optional[float] = None) -> list[dict]:
        """Refresh the SLO gauges and fire burn alerts; returns the
        events fired this tick. Called periodically by the server loop
        and at scrape time (cheap: O(classes × buckets))."""
        t = time.monotonic() if now is None else now
        fired = []
        with self._mu:
            items = list(self._classes.items())
        for cls, st in items:
            budget = 1.0 - st.target
            rates = {}
            with self._mu:
                for wname, wsec in WINDOWS:
                    bf = self._window_bad_fraction(st, wsec, t)
                    rates[wname] = 0.0 if bf is None else bf / budget
                long_bf = self._window_bad_fraction(st, LONG_WINDOW_S, t)
            for wname, _ in WINDOWS:
                metrics.gauge(
                    metrics.SLO_BURN_RATE, round(rates[wname], 3), cls=cls, window=wname
                )
            # budget spent over the long window, as a fraction of budget
            spent = 0.0 if long_bf is None else min(1.0, long_bf / budget)
            metrics.gauge(
                metrics.SLO_BUDGET_REMAINING, round(1.0 - spent, 4), cls=cls
            )
            over = all(rates[w] >= self.burn_threshold for w, _ in WINDOWS)
            if over:
                if not st.firing and (t - st.last_burn_t) >= self.cooldown_s:
                    st.firing = True
                    st.last_burn_t = t
                    metrics.count(metrics.SLO_BURNS, cls=cls)
                    ev = events.record(
                        events.SLO_BURN,
                        cls=cls,
                        burn_5m=round(rates["5m"], 3),
                        burn_1h=round(rates["1h"], 3),
                        threshold=self.burn_threshold,
                        target=st.target,
                        latency_ms=round(st.latency_s * 1000.0, 3),
                    )
                    fired.append(ev)
            else:
                st.firing = False
        return fired

    def snapshot(self, now: Optional[float] = None) -> dict:
        t = time.monotonic() if now is None else now
        rates = self.burn_rates(t)
        out: dict = {"burn_threshold": self.burn_threshold, "classes": {}}
        with self._mu:
            for cls, st in self._classes.items():
                budget = 1.0 - st.target
                bf = self._window_bad_fraction(st, LONG_WINDOW_S, t)
                spent = 0.0 if bf is None else min(1.0, bf / budget)
                good = bad = 0
                for g, e in st.buckets.values():
                    good += g
                    bad += e
                out["classes"][cls] = {
                    "latency_ms": round(st.latency_s * 1000.0, 3),
                    "target": st.target,
                    "burn": rates.get(cls, {}),
                    "budget_remaining": round(1.0 - spent, 4),
                    "samples": {"good": good, "bad": bad},
                    "firing": st.firing,
                }
        return out

    def clear(self) -> None:
        with self._mu:
            for st in self._classes.values():
                st.buckets.clear()
                st.firing = False
                st.last_burn_t = 0.0


# process-global monitor, defaults active even without a server (bare
# handler tests); the server re-configures it from config knobs
MONITOR = SLOMonitor()
