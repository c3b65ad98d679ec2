"""InternalClient — node-to-node data plane over HTTP (reference
http/client.go). JSON instead of protobuf; same endpoint map.

The port of ``pilosa_tpu/parallel/client.py`` for the static cluster:
queries, the owner-side import and ingest legs, control messages, status,
indirect probes, schema and max shards. The reference's fragment-block
and attribute diffs (anti-entropy), fragment streaming (resize), the
translate plane's calls, and the gang and fleet calls come with the
ROADMAP A8 slices that use them."""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable, Optional

from pilosa_tpu_torch.utils import events, metrics, privateproto, trace

# retry backoff cap: one fence window, not a liveness probe interval —
# a leg that can't land in ~2s should fail over, not keep waiting
_BACKOFF_CAP = 2.0


class ClientError(Exception):
    """A failed node-to-node request.

    ``transport`` is True when the node never answered (refused
    connection, DNS, socket timeout) — liveness evidence — and False
    for HTTP-level errors, where the node is provably alive.
    ``status`` carries the HTTP status code when one was received."""

    def __init__(self, msg: str, transport: bool = False, status=None) -> None:
        super().__init__(msg)
        self.transport = transport
        self.status = status


def _retryable(e: ClientError) -> bool:
    """Transient failures worth a retry: the node never answered
    (transport) or answered 503 — a fencing gang leader says exactly
    that during re-formation. Any other HTTP error is deterministic
    (bad query, missing field) and retrying just repeats it."""
    return e.transport or e.status == 503


class InternalClient:
    def __init__(
        self,
        timeout: float = 30.0,
        ssl_context=None,
        retries: int = 0,
        retry_backoff: float = 0.05,
    ) -> None:
        self.timeout = timeout
        # for https:// peers (reference http/client.go builds its
        # transport from the TLS config, server/server.go:166-240);
        # None = system defaults
        self.ssl_context = ssl_context
        # cross-gang RPC retry policy (capped exponential + full
        # jitter); retries=0 preserves one-shot semantics — the probe
        # client and control-plane broadcasts stay one-shot so liveness
        # verdicts and status gossip remain prompt
        self.retries = retries
        self.retry_backoff = retry_backoff

    def _with_retry(self, op: str, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` with up to ``self.retries`` retries on transient
        failures, honoring the ambient request deadline: a retry whose
        backoff cannot fit in the remaining budget is not attempted —
        the caller's failover path (replica re-map) is faster than a
        doomed wait."""
        if self.retries <= 0:
            return fn()
        from pilosa_tpu_torch.server import deadline as _deadline

        attempt = 0
        while True:
            try:
                return fn()
            except ClientError as e:
                if not _retryable(e) or attempt >= self.retries:
                    if attempt:
                        metrics.count(metrics.CLIENT_RETRY_EXHAUSTED, op=op)
                        events.record(
                            events.CLIENT_RETRY_EXHAUSTED,
                            op=op,
                            attempts=attempt + 1,
                            error=str(e),
                        )
                    raise
                delay = min(_BACKOFF_CAP, self.retry_backoff * (2 ** attempt))
                delay *= 0.5 + random.random() * 0.5  # jitter
                dl = _deadline.current()
                if dl is not None and dl.remaining() <= delay:
                    metrics.count(metrics.CLIENT_RETRY_EXHAUSTED, op=op)
                    events.record(
                        events.CLIENT_RETRY_EXHAUSTED,
                        op=op,
                        attempts=attempt + 1,
                        error=f"deadline too close for retry: {e}",
                    )
                    raise
                attempt += 1
                metrics.count(metrics.CLIENT_RETRIES, op=op)
                time.sleep(delay)

    def _request(
        self,
        method: str,
        uri: str,
        path: str,
        body: Optional[bytes] = None,
        query: Optional[dict] = None,
        headers: Optional[dict] = None,
    ):
        url = uri + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
        try:
            with urllib.request.urlopen(
                req, timeout=self.timeout, context=self.ssl_context
            ) as resp:
                data = resp.read()
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:
                msg = str(e)
            raise ClientError(f"{method} {url}: {msg}", status=e.code) from e
        except (urllib.error.URLError, OSError) as e:
            raise ClientError(f"{method} {url}: {e}", transport=True) from e
        return json.loads(data or b"{}")

    # -- query (reference QueryNode, http/client.go:225) --

    def query_node(
        self,
        uri: str,
        index: str,
        query: str,
        shards: Optional[list[int]] = None,
        remote: bool = True,
        trace_ctx: Optional[tuple] = None,
        cache: bool = True,
    ) -> list[dict]:
        q = {"remote": "true" if remote else "false"}
        if shards is not None:
            q["shards"] = ",".join(str(s) for s in shards)
        # a caller that bypasses the plan cache bypasses it on every leg
        if not cache:
            q["cache"] = "false"
        # distributed trace propagation: the remote leg runs under the
        # caller's trace id (traceparent header); a sampled leg answers
        # with its serialized spans and we graft them into the live
        # tree right here — the one place every outbound query passes
        headers = None
        if trace_ctx is not None:
            headers = {"traceparent": trace.format_traceparent(trace_ctx)}
        # safe to retry even for writes: Set/Clear are idempotent and a
        # transport failure means the request may or may not have
        # landed either way — at-least-once is the existing contract
        resp = self._with_retry(
            "query",
            lambda: self._request(
                "POST",
                uri,
                f"/index/{index}/query",
                body=query.encode(),
                query=q,
                headers=headers,
            ),
        )
        spans = resp.get("spans")
        if spans:
            sp = trace.current()
            if sp is not None:
                for d in spans:
                    sp.graft(d)
                metrics.count(
                    metrics.TRACE_REMOTE_SPANS, len(spans), source="envelope"
                )
        return resp.get("results", [])

    # -- imports (reference Import/ImportValue, http/client.go:276,428) --

    def import_bits_local(self, uri, index, field, row_ids, column_ids, timestamps=None):
        body = {"rowIDs": list(row_ids), "columnIDs": list(column_ids), "local": True}
        if timestamps is not None:
            body["timestamps"] = list(timestamps)
        self._with_retry(
            "import",
            lambda: self._request(
                "POST",
                uri,
                f"/index/{index}/field/{field}/import",
                body=json.dumps(body).encode(),
            ),
        )

    def ingest(self, uri, index, field, row_ids, column_ids, sets=None):
        """Owner-side ingest leg: the remote node group-commits the
        batch (one fsynced op-log append per touched fragment) and
        acks only after its fsync, so a 2xx here carries the same
        durability contract as a local ack. The ``local`` marker keeps
        the remote from re-routing the wave back through the cluster
        (with replicas > 1 that ping-pong would deadlock the two
        single-threaded committers against each other). A retry after
        a failed commit is safe: a nacked wave leaves the remote
        fragment unmodified, so the retry re-logs the identical ops.
        Returns the remote's changed-bit count."""
        body = {
            "rowIDs": list(row_ids),
            "columnIDs": list(column_ids),
            "local": True,
        }
        if sets is not None:
            body["sets"] = [bool(s) for s in sets]
        resp = self._with_retry(
            "ingest",
            lambda: self._request(
                "POST",
                uri,
                f"/index/{index}/field/{field}/ingest",
                body=json.dumps(body).encode(),
            ),
        )
        return int(resp.get("changed", len(body["rowIDs"])))

    def import_values_local(self, uri, index, field, column_ids, values):
        body = {"columnIDs": list(column_ids), "values": list(values), "local": True}
        self._with_retry(
            "import",
            lambda: self._request(
                "POST",
                uri,
                f"/index/{index}/field/{field}/import-value",
                body=json.dumps(body).encode(),
            ),
        )

    # -- control messages (reference SendMessage, http/client.go:822) --

    def send_message(self, uri: str, msg: dict) -> None:
        # control plane rides the reference's protobuf envelope
        # (broadcast.go:71-113); JSON remains the debug fallback for
        # message shapes with no wire mapping
        if privateproto.encodable(msg):
            body, headers = (
                privateproto.marshal_message(msg),
                {"Content-Type": privateproto.CONTENT_TYPE},
            )
        else:
            body, headers = json.dumps(msg).encode(), None
        self._request(
            "POST", uri, "/internal/cluster/message", body=body, headers=headers
        )

    # -- misc --

    def status(self, uri: str) -> dict:
        return self._request("GET", uri, "/status")

    def probe_indirect(self, via_uri: str, target_uri: str) -> bool:
        """SWIM ping-req: ask ``via_uri`` to probe ``target_uri`` on our
        behalf (reference memberlist indirect probing, the
        gossip/gossip.go:431-494 tunables). Returns the peer's verdict;
        an unreachable RELAY answers False (no verdict ≠ alive)."""
        out = self._request(
            "POST",
            via_uri,
            "/internal/probe",
            body=json.dumps({"uri": target_uri}).encode(),
        )
        return bool(out.get("alive"))

    def schema(self, uri: str) -> list[dict]:
        return self._request("GET", uri, "/schema").get("indexes", [])

    def max_shards(self, uri: str) -> dict:
        return self._request("GET", uri, "/internal/shards/max").get("standard", {})
