"""Stats clients (reference stats.go): count/gauge/histogram/set/timing
with tag propagation. Expvar-style in-process aggregation plus nop and
multi fan-out implementations."""

from __future__ import annotations

import threading
from typing import Optional

from pilosa_tpu_torch.utils.metrics import LogHistogram


class NopStatsClient:
    def tags(self) -> list[str]:
        return []

    def with_tags(self, *tags: str) -> "NopStatsClient":
        return self

    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None:
        pass

    def gauge(self, name: str, value: float, rate: float = 1.0) -> None:
        pass

    def histogram(self, name: str, value: float, rate: float = 1.0) -> None:
        pass

    def set(self, name: str, value: str, rate: float = 1.0) -> None:
        pass

    def timing(self, name: str, value: float, rate: float = 1.0) -> None:
        pass

    def close(self) -> None:
        pass


NOP_STATS = NopStatsClient()


class ExpvarStatsClient:
    """In-process aggregation exposed at /debug/vars (reference
    stats.go:86-163)."""

    def __init__(self, tags: Optional[list[str]] = None, root: Optional[dict] = None) -> None:
        self._tags = tags or []
        self._root = root if root is not None else {}
        self._mu = threading.Lock()

    def tags(self) -> list[str]:
        return self._tags

    def with_tags(self, *tags: str) -> "ExpvarStatsClient":
        return ExpvarStatsClient(sorted(set(self._tags) | set(tags)), self._root)

    def _key(self, name: str) -> str:
        if self._tags:
            return f"{name};{','.join(self._tags)}"
        return name

    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None:
        with self._mu:
            k = self._key(name)
            self._root[k] = self._root.get(k, 0) + value

    def gauge(self, name: str, value: float, rate: float = 1.0) -> None:
        with self._mu:
            self._root[self._key(name)] = value

    def histogram(self, name: str, value: float, rate: float = 1.0) -> None:
        with self._mu:
            # .hist rides on the NAME (before the tag suffix), so
            # "name.timing.hist;tag" parses as base name + labels
            k = self._key(name + ".hist")
            h = self._root.get(k)
            if not isinstance(h, LogHistogram):
                h = self._root[k] = LogHistogram()
            h.observe(value)

    def set(self, name: str, value: str, rate: float = 1.0) -> None:
        with self._mu:
            self._root[self._key(name)] = value

    def timing(self, name: str, value: float, rate: float = 1.0) -> None:
        self.histogram(name + ".timing", value, rate)

    def snapshot(self) -> dict:
        """JSON-safe view: histograms render as count/sum/min/max plus
        estimated p50/p95/p99 from the fixed log-spaced buckets, so
        .timing metrics are actionable beyond min/max."""
        with self._mu:
            return {
                k: (v.summary() if isinstance(v, LogHistogram) else v)
                for k, v in self._root.items()
            }

    def close(self) -> None:
        pass


class MultiStatsClient:
    def __init__(self, *clients) -> None:
        self.clients = list(clients)

    def tags(self) -> list[str]:
        return self.clients[0].tags() if self.clients else []

    def with_tags(self, *tags: str) -> "MultiStatsClient":
        return MultiStatsClient(*(c.with_tags(*tags) for c in self.clients))

    def count(self, name, value=1, rate=1.0):
        for c in self.clients:
            c.count(name, value, rate)

    def gauge(self, name, value, rate=1.0):
        for c in self.clients:
            c.gauge(name, value, rate)

    def histogram(self, name, value, rate=1.0):
        for c in self.clients:
            c.histogram(name, value, rate)

    def set(self, name, value, rate=1.0):
        for c in self.clients:
            c.set(name, value, rate)

    def timing(self, name, value, rate=1.0):
        for c in self.clients:
            c.timing(name, value, rate)

    def snapshot(self) -> dict:
        """Merged snapshots of every child that aggregates in-process
        (ExpvarStatsClient); fire-and-forget sinks contribute nothing.
        Keeps /debug/vars lit when the configured sink is statsd."""
        out: dict = {}
        for c in self.clients:
            snap = getattr(c, "snapshot", None)
            if snap is not None:
                out.update(snap())
        return out

    def close(self) -> None:
        for c in self.clients:
            c.close()


class StatsDClient:
    """DataDog-flavored StatsD over UDP (reference statsd/statsd.go:40-128).

    Wire format per datagram: ``pilosa.<name>:<value>|<type>[|@<rate>][|#t1,t2]``
    with types c (count), g (gauge), h (histogram), s (set), ms (timing).
    Sampling is client-side: a metric with rate r is sent with
    probability r and annotated ``|@r`` so the aggregator rescales.
    Fire-and-forget — send errors are swallowed (UDP semantics).
    """

    prefix = "pilosa."

    def __init__(
        self,
        host: str = "127.0.0.1:8125",
        tags: Optional[list[str]] = None,
        _sock=None,
    ) -> None:
        import socket

        h, sep, p = host.rpartition(":")
        if not sep:  # bare hostname → default statsd port
            h, p = host, "8125"
        try:
            port = int(p)
        except ValueError:
            raise ValueError(f"invalid statsd host (metric_host): {host!r}")
        self._addr = (h or "127.0.0.1", port)
        self._tags = tags or []
        self._sock = _sock or socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def tags(self) -> list[str]:
        return self._tags

    def with_tags(self, *tags: str) -> "StatsDClient":
        c = StatsDClient.__new__(StatsDClient)
        c._addr = self._addr
        c._tags = sorted(set(self._tags) | set(tags))
        c._sock = self._sock
        return c

    def _send(self, name: str, value, type_: str, rate: float) -> None:
        if rate < 1.0:
            import random

            if random.random() >= rate:
                return
        msg = f"{self.prefix}{name}:{value}|{type_}"
        if rate < 1.0:
            msg += f"|@{rate}"
        if self._tags:
            msg += "|#" + ",".join(self._tags)
        try:
            self._sock.sendto(msg.encode(), self._addr)
        except OSError:
            pass

    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None:
        self._send(name, value, "c", rate)

    def gauge(self, name: str, value: float, rate: float = 1.0) -> None:
        self._send(name, value, "g", rate)

    def histogram(self, name: str, value: float, rate: float = 1.0) -> None:
        self._send(name, value, "h", rate)

    def set(self, name: str, value: str, rate: float = 1.0) -> None:
        self._send(name, value, "s", rate)

    def timing(self, name: str, value: float, rate: float = 1.0) -> None:
        self._send(name, value, "ms", rate)
