"""HTTP handler (L6) — REST surface over the API (reference
http/handler.go).

The port of ``pilosa_tpu/server/http_handler.py``: every route the
single-node API serves answers with the same status codes and bodies,
JSON and protobuf (``utils/publicproto.py``). A route of a subsystem
this port lacks answers 501 with its ROADMAP item in the body, never
404: the cluster and gang messages, fleet and scrub (A8) and the
dispatch engine (A6). Keyed ingest, ``/debug/translate``,
``/internal/translate/{data,stores,keys}``, the attribute diffs, the
fault-injection windows (``/debug/chaos``) and the on-demand profile
capture (``/debug/profile?capture=``) answer as the reference's single
node does.
"""

from __future__ import annotations

import json
import re
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch.core import Row
from pilosa_tpu_torch.core.fragment import FragmentQuarantinedError
from pilosa_tpu_torch.executor.executor import ValCount
from pilosa_tpu_torch.server import deadline as deadline_mod
from pilosa_tpu_torch.server.api import A8, API, APIError, unported
from pilosa_tpu_torch.server.deadline import DeadlineExceeded
from pilosa_tpu_torch.server import pipeline as pipeline_mod
from pilosa_tpu_torch.server.pipeline import CLASS_BULK, CLASS_INTERNAL, Overloaded
from pilosa_tpu_torch.utils.errors import NotFoundError as ExecNotFound
from pilosa_tpu_torch.utils import events, heat, metrics, profiler, publicproto, slo, trace
from pilosa_tpu_torch.utils.stats import NOP_STATS

A6 = "A6 (dispatch and autotune)"


class GangUnavailable(Exception):
    """A multihost gang that cannot serve (503 + Retry-After). The port
    has no gang yet (ROADMAP A8); the class keeps the handler's error
    mapping whole for when it does."""

    status = 503
    retry_after = 1.0


def _require(body: dict, *keys: str) -> None:
    """400 on missing request-body fields — a malformed client body
    must never surface as an internal KeyError."""
    missing = [k for k in keys if k not in body]
    if missing:
        raise APIError(f"missing required field(s): {', '.join(missing)}", status=400)


def _unported_route(what: str, item: str) -> Callable:
    def handler(req):
        raise unported(what, item)

    return handler


# conservative write detector for coalescing/batching eligibility: any
# hit (even a false positive from a quoted key) just forfeits the
# optimization, never correctness
_WRITE_CALL_RE = re.compile(r"\b(?:Set\w*|Clear)\s*\(")


def _qreq(q: dict, key: str) -> str:
    """Required query parameter, 400 when absent."""
    try:
        return q[key][0]
    except (KeyError, IndexError):
        raise APIError(f"missing required query param: {key}", status=400)


def _decode_proto(fn, body: Optional[bytes]):
    """Protobuf request decode with 400-on-malformed semantics: a
    clipped or corrupt wire body must never execute partially (the
    reference's gogo-proto unmarshal errors map to http 400,
    http/handler.go marshalling errors)."""
    try:
        return fn(body or b"")
    except (ValueError, TypeError, AttributeError, UnicodeDecodeError) as e:
        # TypeError/AttributeError cover wire-type confusion (e.g. the
        # query field sent as a varint): still malformed input, still 400
        raise APIError(f"unmarshalling: {e}", status=400)


def encode_result(r: Any) -> Any:
    """Query result → JSON shape (reference QueryResponse encoding)."""
    if isinstance(r, Row):
        if r.keys:
            return {"attrs": r.attrs, "keys": r.keys}
        return {"attrs": r.attrs, "columns": [int(c) for c in r.columns()]}
    if isinstance(r, ValCount):
        return {"value": r.val, "count": r.count}
    return r


class Route:
    def __init__(self, method: str, pattern: str, fn: Callable) -> None:
        self.method = method
        self.re = re.compile("^" + pattern + "$")
        self.fn = fn


class Handler:
    """Routing table + request glue, served by ThreadingHTTPServer."""

    def __init__(
        self,
        api: API,
        logger=None,
        stats=NOP_STATS,
        long_query_time: float = 0.0,
        pipeline=None,
        default_timeout: float = 0.0,
        analytics_timeout: float = 0.0,
        ingest=None,
        tenancy=None,
    ) -> None:
        self.api = api
        self.logger = logger
        self.stats = stats
        self.long_query_time = long_query_time
        # serving pipeline (server/pipeline.py); None = direct execution
        # (bare handlers in tests, pipeline-enabled = false)
        self.pipeline = pipeline
        self.default_timeout = default_timeout
        # default deadline for analytic bulk queries when the client
        # sends none (config analytics-timeout; 0 = use default_timeout)
        self.analytics_timeout = analytics_timeout
        # durable ingest queue (server/ingest.py); None = waves apply
        # synchronously through the bulk class (ingest-enabled = false)
        self.ingest = ingest
        # multi-tenant QoS policy (server/tenancy.py); None/disabled =
        # single-tenant passthrough
        self.tenancy = tenancy
        a = api
        self.routes = [
            # public (reference handler.go:188-231)
            Route(
                "GET",
                r"/",
                lambda req: {
                    "message": "pilosa_tpu is running; see /schema, /status"
                },
            ),
            Route("POST", r"/index/(?P<index>[^/]+)/query", self.post_query),
            Route("GET", r"/schema", lambda req: {"indexes": a.schema()}),
            Route("GET", r"/status", lambda req: a.status()),
            Route("GET", r"/info", lambda req: a.info()),
            Route("GET", r"/version", lambda req: {"version": a.version()}),
            Route("GET", r"/index", lambda req: {"indexes": a.schema()}),
            Route("GET", r"/index/(?P<index>[^/]+)", self.get_index),
            Route("POST", r"/index/(?P<index>[^/]+)", self.post_index),
            Route("DELETE", r"/index/(?P<index>[^/]+)", self.delete_index),
            Route(
                "POST",
                r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)",
                self.post_field,
            ),
            Route(
                "DELETE",
                r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)",
                self.delete_field,
            ),
            Route(
                "POST",
                r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import",
                self.post_import,
            ),
            Route(
                "POST",
                r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/import-value",
                self.post_import_value,
            ),
            Route(
                "POST",
                r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/ingest",
                self.post_ingest,
            ),
            Route(
                "GET",
                r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/views",
                self.get_views,
            ),
            Route(
                "DELETE",
                r"/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/view/(?P<view>[^/]+)",
                self.delete_view,
            ),
            Route("GET", r"/export", self.get_export),
            Route("POST", r"/recalculate-caches", self.post_recalculate_caches),
            # internal data plane that one node serves too: fragment
            # blocks and archives (backup, restore), shard and fragment
            # inventories
            Route("GET", r"/internal/fragment/blocks", self.get_fragment_blocks),
            Route("GET", r"/internal/fragment/block/data", self.get_block_data),
            Route("GET", r"/internal/fragment/data", self.get_fragment_data),
            Route("POST", r"/internal/fragment/data", self.post_fragment_data),
            Route("GET", r"/internal/shards/max", lambda req: {"standard": a.max_shards()}),
            Route("GET", r"/internal/fragments", lambda req: a.fragment_inventory()),
            # key translation's pull plane and the owner's mint endpoint,
            # and the attribute stores' anti-entropy diffs
            Route("GET", r"/internal/translate/data", self.get_translate_data),
            Route("GET", r"/internal/translate/stores", lambda req: a.translate_stores()),
            Route("POST", r"/internal/translate/keys", self.post_translate_keys),
            Route("POST", r"/internal/index/(?P<index>[^/]+)/attr/diff", self.post_column_attr_diff),
            Route(
                "POST",
                r"/internal/index/(?P<index>[^/]+)/field/(?P<field>[^/]+)/attr/diff",
                self.post_row_attr_diff,
            ),
            Route("GET", r"/metrics", self.get_metrics),
            Route("GET", r"/debug/pipeline", self.get_debug_pipeline),
            Route("GET", r"/debug/fusion", self.get_debug_fusion),
            # device robustness: the governor, OOM recovery, gate trips and
            # the installed fault schedules; POST opens or clears a fault
            # window (chaos-enabled only)
            Route("GET", r"/debug/chaos", self.get_debug_chaos),
            Route("POST", r"/debug/chaos", self.post_debug_chaos),
            Route("GET", r"/debug/plancache", self.get_debug_plancache),
            Route("GET", r"/debug/ingest", self.get_debug_ingest),
            # holder-level checksummed backup/restore
            Route("GET", r"/backup", self.get_backup),
            Route("POST", r"/restore", self.post_restore),
            Route("GET", r"/debug/vars", self.get_debug_vars),
            Route("GET", r"/debug/traces", self.get_debug_traces),
            Route("GET", r"/debug/events", self.get_debug_events),
            # workload heat + forensics bundle
            Route("GET", r"/debug/heat", self.get_debug_heat),
            Route("GET", r"/debug/bundle", self.get_debug_bundle),
            # performance attribution: latency waterfalls, continuous
            # profiler + compile/memory telemetry, SLO burn
            Route("GET", r"/debug/latency", self.get_debug_latency),
            Route("GET", r"/debug/profile", self.get_debug_profile),
            Route("GET", r"/debug/slo", self.get_debug_slo),
            # per-tenant admission / scheduling / HBM / SLO state
            Route("GET", r"/debug/tenancy", self.get_debug_tenancy),
            # key translation: keys, log bytes, minted / adopted /
            # forwarded counts, the reverse LRU
            Route("GET", r"/debug/translate", lambda req: a.translate_debug()),
            # index (with and without trailing slash, as net/http/pprof
            # serves it) plus the thread-dump profile; unknown names 404
            Route("GET", r"/debug/pprof/?", self.get_debug_pprof),
            Route("GET", r"/debug/pprof/goroutine", self.get_debug_pprof),
        ]
        # subsystems not ported yet: 501 naming the ROADMAP item
        for method, pattern, what, item in _UNPORTED_ROUTES:
            self.routes.append(Route(method, pattern, _unported_route(what, item)))

    # -- route handlers --

    def _submit(
        self,
        cls,
        thunk,
        dl,
        signature=None,
        batch=None,
        trace_ctx=None,
        index="",
        nbytes=0,
    ):
        """Run ``thunk`` through the serving pipeline (admission,
        deadline, coalescing, batching) — or directly, deadline still
        honored, when no pipeline is wired. ``index`` is the tenant for
        per-tenant admission + weighted-fair scheduling; ``nbytes``
        charges the tenant's in-flight byte ledger for the request."""
        if self.pipeline is not None:
            return self.pipeline.submit(
                cls,
                thunk,
                deadline=dl,
                signature=signature,
                batch=batch,
                trace_ctx=trace_ctx,
                index=index,
                nbytes=nbytes,
            )
        with deadline_mod.activate(dl):
            return thunk()

    def post_query(self, req) -> dict:
        index = req.params["index"]
        q = req.query
        # protobuf content negotiation (reference handlePostQuery:406 +
        # internal/public.proto QueryRequest)
        if req.is_proto:
            pbreq = _decode_proto(publicproto.decode_query_request, req.body)
            body = pbreq["query"]
            shards = pbreq["shards"]
            remote = pbreq["remote"]
            exclude_row_attrs = pbreq["excludeRowAttrs"]
            exclude_columns = pbreq["excludeColumns"]
            column_attrs = pbreq["columnAttrs"]
        else:
            body = req.body.decode() if req.body else ""
            shards = None
            if "shards" in q:
                shards = [int(s) for s in _qreq(q, "shards").split(",") if s != ""]
            remote = q.get("remote", ["false"])[0] == "true"
            exclude_row_attrs = q.get("excludeRowAttrs", ["false"])[0] == "true"
            exclude_columns = q.get("excludeColumns", ["false"])[0] == "true"
            column_attrs = q.get("columnAttrs", ["false"])[0] == "true"
        # profile=true returns the span tree; profile=waterfall returns
        # the per-stage latency split from the attribution layer
        profile_raw = q.get("profile", ["false"])[0]
        profile = profile_raw == "true"
        waterfall = profile_raw == "waterfall"
        cache = q.get("cache", ["true"])[0] != "false"
        # W3C trace context ingress: a sampled traceparent makes this
        # request a leg of a distributed trace (api.query adopts the
        # id); malformed headers parse to None and never fail the query
        trace_ctx = trace.parse_traceparent(req.headers.get("traceparent"))
        # pipeline classification (pipeline.classify_query): remote legs
        # are internal traffic; analytic bulk queries (GroupBy /
        # Distinct / Percentile) run in the BULK class with their own
        # default deadline budget (analytics-timeout), so a panel burst
        # burns the bulk SLO instead of interactive p50; everything
        # else is interactive. Read-only queries coalesce (singleflight)
        # by CANONICAL plan signature (plan/canon.py) — argument-order-
        # permuted duplicates like Intersect(Row(a),Row(b)) vs
        # Intersect(Row(b),Row(a)) share one execution; unparseable
        # text falls back to the raw bytes so syntax errors still 400
        # individually. Plain whole-index reads additionally gang into
        # combined cross-request executions.
        cls = pipeline_mod.classify_query(body, remote)
        default_t = self.default_timeout
        if cls == CLASS_BULK and self.analytics_timeout > 0:
            default_t = self.analytics_timeout
        dl = deadline_mod.from_request(req.headers, q, default_t)
        signature = None
        batch = None
        # waterfall requests skip cross-request coalescing/batching like
        # profile: a follower served by a leader's execution would report
        # the LEADER's split, not its own
        if not remote and not profile and not waterfall and not _WRITE_CALL_RE.search(body):
            from pilosa_tpu_torch.plan.canon import query_signature

            canon_sig = query_signature(body)
            signature = (
                "q",
                index,
                canon_sig if canon_sig is not None else body,
                tuple(shards) if shards is not None else None,
                exclude_row_attrs,
                exclude_columns,
                column_attrs,
                cache,
            )
            # sampled-trace requests stay out of cross-request batching
            # (a combined execution has no per-request span tree); they
            # still coalesce — the follower records a span link
            if (
                shards is None
                and not column_attrs
                and not (trace_ctx is not None and trace_ctx[2])
            ):
                batch = {
                    "key": (index, exclude_row_attrs, exclude_columns, cache),
                    "index": index,
                    "query": body,
                    "kwargs": {
                        "exclude_row_attrs": exclude_row_attrs,
                        "exclude_columns": exclude_columns,
                        "cache": cache,
                    },
                }

        def thunk():
            return self.api.query(
                index,
                body,
                shards=shards,
                remote=remote,
                exclude_row_attrs=exclude_row_attrs,
                exclude_columns=exclude_columns,
                column_attrs=column_attrs,
                profile=profile,
                cache=cache,
                trace_ctx=trace_ctx,
                waterfall=waterfall,
            )

        t0 = time.monotonic()
        try:
            resp = self._submit(
                cls,
                thunk,
                dl,
                signature=signature,
                batch=batch,
                trace_ctx=trace_ctx,
                index=index,
                nbytes=len(req.body) if req.body else 0,
            )
        except APIError as e:
            # client errors (4xx) don't burn error budget; 5xx does
            dur = time.monotonic() - t0
            slo.MONITOR.record(cls, dur, ok=e.status < 500)
            if self.tenancy is not None and cls != CLASS_INTERNAL:
                self.tenancy.observe(index, dur, ok=e.status < 500)
            raise
        except BaseException:
            # timeouts, sheds, internal failures all consume budget
            dur = time.monotonic() - t0
            slo.MONITOR.record(cls, dur, ok=False)
            if self.tenancy is not None and cls != CLASS_INTERNAL:
                self.tenancy.observe(index, dur, ok=False)
            raise
        dur = time.monotonic() - t0
        slo.MONITOR.record(cls, dur, ok=True)
        if self.tenancy is not None and cls != CLASS_INTERNAL:
            self.tenancy.observe(index, dur, ok=True)
        # always-on waterfall: api.query attaches the summary; pop it
        # (shared dicts from coalesced responses aggregate only once)
        wf_summary = resp.pop("_waterfall", None)
        if wf_summary is not None:
            profiler.WATERFALL.record_summary(cls, wf_summary, tenant=index)
        # slow-query logging (reference handler.go:257-261)
        if self.long_query_time and dur > self.long_query_time and self.logger:
            self.logger.printf("%.3fs SLOW QUERY %s %s", dur, index, body[:500])
            self.stats.count(metrics.SLOW_QUERY, 1)
        self.stats.with_tags(f"index:{index}").timing(metrics.QUERY_TIME, dur)
        out = {"results": [encode_result(r) for r in resp["results"]]}
        if "columnAttrs" in resp:
            out["columnAttrs"] = resp["columnAttrs"]
        if "profile" in resp:
            # JSON-only: the protobuf QueryResponse has no profile field
            out["profile"] = resp["profile"]
        if "spans" in resp:
            # remote-leg envelope: this process's serialized spans ride
            # back so the root process stitches one complete tree
            out["spans"] = resp["spans"]
        if req.accepts_proto:
            return RawResponse(
                publicproto.encode_query_response(
                    out["results"], out.get("columnAttrs")
                ),
                publicproto.CONTENT_TYPE,
            )
        return out

    def get_index(self, req) -> dict:
        for ischema in self.api.schema():
            if ischema["name"] == req.params["index"]:
                return ischema
        raise APIError(f"index not found: {req.params['index']}", status=404)

    def post_index(self, req) -> dict:
        body = json.loads(req.body or b"{}")
        opts = body.get("options", {})
        self.api.create_index(req.params["index"], keys=opts.get("keys", False))
        return {}

    def delete_index(self, req) -> dict:
        self.api.delete_index(req.params["index"])
        return {}

    def post_field(self, req) -> dict:
        body = json.loads(req.body or b"{}")
        self.api.create_field(
            req.params["index"], req.params["field"], body.get("options", {})
        )
        return {}

    def delete_field(self, req) -> dict:
        self.api.delete_field(req.params["index"], req.params["field"])
        return {}

    def post_import(self, req) -> dict:
        if req.is_proto:
            body = _decode_proto(publicproto.decode_import_request, req.body)
            # reference wire timestamps are unix-nanoseconds
            # (Go time.Unix(0, ts)); the API layer expects seconds
            if body.get("timestamps"):
                body["timestamps"] = [
                    t / 1e9 if t else None for t in body["timestamps"]
                ]
        else:
            body = json.loads(req.body or b"{}")
        dl = deadline_mod.from_request(req.headers, req.query, self.default_timeout)
        if body.get("local"):
            # owner-side leg of a routed import: internal traffic
            self._submit(
                CLASS_INTERNAL,
                lambda: self.api.import_bits_local(
                    req.params["index"],
                    req.params["field"],
                    body.get("rowIDs", []),
                    body.get("columnIDs", []),
                    timestamps=body.get("timestamps"),
                ),
                dl,
            )
            return self._import_ok(req)
        self._submit(
            CLASS_BULK,
            lambda: self.api.import_bits(
                req.params["index"],
                req.params["field"],
                body.get("rowIDs", []),
                body.get("columnIDs", []),
                timestamps=body.get("timestamps"),
                row_keys=body.get("rowKeys"),
                column_keys=body.get("columnKeys"),
            ),
            dl,
        )
        return self._import_ok(req)

    def _import_ok(self, req):
        if req.accepts_proto or req.is_proto:
            # empty ImportResponse message (reference handlePostImport)
            return RawResponse(b"", publicproto.CONTENT_TYPE)
        return {}

    def post_ingest(self, req) -> dict:
        """Durable streaming ingest (server/ingest.py): sets AND clears
        in one batch; blocks until the batch's write wave is
        group-committed (fsynced) — a 200 means the writes survive
        SIGKILL. Queue overflow answers 429 + Retry-After; a wave that
        cannot commit before the request deadline answers 504 (the
        write's outcome is then indeterminate)."""
        body = json.loads(req.body or b"{}")
        rows = body.get("rowIDs", [])
        cols = body.get("columnIDs", [])
        sets = body.get("sets")
        row_keys = body.get("rowKeys")
        column_keys = body.get("columnKeys")
        if row_keys or column_keys:
            # keyed ingest: resolve the whole batch to ids BEFORE the
            # queue sees it — write waves (and their routed local legs,
            # which never carry keys) are id-only, and the translate
            # assignments group-commit ahead of the wave's own fsync
            t_rows, t_cols = self.api.translate_ingest_keys(
                req.params["index"], req.params["field"], row_keys, column_keys
            )
            if t_rows is not None:
                rows = t_rows
            if t_cols is not None:
                cols = t_cols
        dl = deadline_mod.from_request(req.headers, req.query, self.default_timeout)
        if body.get("local"):
            # owner-side leg of a routed wave: apply directly (the
            # leader already coalesced it; re-queueing would chain this
            # node's committer behind the caller's) — the group commit
            # below still fsyncs before the 200, so durability holds
            changed = self._submit(
                CLASS_INTERNAL,
                lambda: self.api.apply_write_wave_local(
                    req.params["index"], req.params["field"], rows, cols, sets
                ),
                dl,
            )
            return {"acked": len(rows), "changed": changed}
        if self.ingest is not None:
            # the queue is its own admission class — no pipeline leg,
            # but the request deadline still bounds the commit wait (a
            # stalled committer must not pin HTTP workers forever)
            acked = self.ingest.submit(
                req.params["index"],
                req.params["field"],
                rows,
                cols,
                sets,
                deadline=dl,
            )
            return {"acked": acked}
        changed = self._submit(
            CLASS_BULK,
            lambda: self.api.apply_write_wave(
                req.params["index"], req.params["field"], rows, cols, sets
            ),
            dl,
        )
        return {"acked": len(rows), "changed": changed}

    def get_translate_data(self, req):
        q = req.query
        data = self.api.get_translate_data(int(q.get("offset", ["0"])[0]), q.get("store", [""])[0])
        return RawResponse(data, "application/octet-stream")

    def post_translate_keys(self, req) -> dict:
        """The owner's mint endpoint for forwarded keys."""
        body = json.loads(req.body or b"{}")
        _require(body, "index")
        ids = self.api.translate_keys(body["index"], body.get("field", ""), body.get("keys", []))
        return {"ids": ids}

    def post_column_attr_diff(self, req) -> dict:
        body = json.loads(req.body or b"{}")
        return {"attrs": self.api.column_attr_diff(req.params["index"], body.get("blocks", []))}

    def post_row_attr_diff(self, req) -> dict:
        body = json.loads(req.body or b"{}")
        return {
            "attrs": self.api.row_attr_diff(req.params["index"], req.params["field"], body.get("blocks", []))
        }

    def get_debug_ingest(self, req) -> dict:
        """Ingest write-ahead queue snapshot: depth/limit, wave and
        acked/shed counters, last wave size + commit latency."""
        if self.ingest is None:
            return {"enabled": False}
        out = self.ingest.stats()
        out["enabled"] = True
        return out

    def post_import_value(self, req) -> dict:
        if req.is_proto:
            body = _decode_proto(publicproto.decode_import_value_request, req.body)
        else:
            body = json.loads(req.body or b"{}")
        dl = deadline_mod.from_request(req.headers, req.query, self.default_timeout)
        if body.get("local"):
            self._submit(
                CLASS_INTERNAL,
                lambda: self.api.import_values_local(
                    req.params["index"],
                    req.params["field"],
                    body.get("columnIDs", []),
                    body.get("values", []),
                ),
                dl,
            )
            return self._import_ok(req)
        self._submit(
            CLASS_BULK,
            lambda: self.api.import_values(
                req.params["index"],
                req.params["field"],
                body.get("columnIDs", []),
                body.get("values", []),
                column_keys=body.get("columnKeys"),
            ),
            dl,
        )
        return self._import_ok(req)

    def get_views(self, req) -> dict:
        return {"views": self.api.views(req.params["index"], req.params["field"])}

    def delete_view(self, req) -> dict:
        self.api.delete_view(
            req.params["index"], req.params["field"], req.params["view"]
        )
        return {}

    def get_export(self, req):
        q = req.query
        csv_bytes = self.api.export_csv(
            _qreq(q, "index"), _qreq(q, "field"), int(_qreq(q, "shard"))
        )
        return RawResponse(csv_bytes, "text/csv")

    def post_recalculate_caches(self, req) -> dict:
        self.api.recalculate_caches()
        return {}

    def get_fragment_blocks(self, req) -> dict:
        q = req.query
        return {
            "blocks": self.api.fragment_blocks(
                _qreq(q, "index"),
                _qreq(q, "field"),
                int(_qreq(q, "shard")),
                view=q.get("view", ["standard"])[0],
            )
        }

    def get_block_data(self, req) -> dict:
        q = req.query
        return self.api.fragment_block_data(
            _qreq(q, "index"),
            _qreq(q, "field"),
            q.get("view", ["standard"])[0],
            int(_qreq(q, "shard")),
            int(_qreq(q, "block")),
        )

    def get_fragment_data(self, req):
        q = req.query
        data = self.api.marshal_fragment(
            _qreq(q, "index"),
            _qreq(q, "field"),
            q.get("view", ["standard"])[0],
            int(_qreq(q, "shard")),
        )
        return RawResponse(data, "application/octet-stream")

    def post_fragment_data(self, req) -> dict:
        q = req.query
        # resize/backup streaming: heavy internal data-plane work, so it
        # rides the internal admission queue
        self._submit(
            CLASS_INTERNAL,
            lambda: self.api.unmarshal_fragment(
                _qreq(q, "index"),
                _qreq(q, "field"),
                q.get("view", ["standard"])[0],
                int(_qreq(q, "shard")),
                req.body,
            ),
            deadline_mod.from_request(req.headers, q, self.default_timeout),
        )
        return {}

    def _expvar_snapshot(self) -> dict:
        """The server's in-process stats snapshot: prefer the always-kept
        ExpvarStatsClient (lit even when the configured sink is statsd),
        falling back to whatever snapshot the handler's stats offer."""
        server = getattr(self.api, "server", None)
        ev = getattr(server, "_expvar", None)
        if ev is not None:
            return ev.snapshot()
        if hasattr(self.stats, "snapshot"):
            return self.stats.snapshot()
        return {}

    def get_debug_vars(self, req) -> dict:
        out = self._expvar_snapshot()
        # process-global registry (executor routing, batcher, stager,
        # caches, device health, cluster fan-out)
        out["metrics"] = metrics.snapshot()
        health = getattr(self.api.executor, "health", None)
        if health is not None:
            out["device_health"] = {
                "healthy": health.healthy,
                "trips": health.trips,
                "restores": health.restores,
                "slow_calls": health.slow_calls,
                "saturations": health.saturations,
                "restore_failures": health.restore_failures,
            }
        return out

    def get_metrics(self, req):
        """Prometheus text exposition: the process-global registry
        merged with this server's expvar snapshot plus scrape-time
        freshness gauges (device health, HBM staging residency).
        ``?fleet=true`` on a fleet collector (gang/federation leader)
        returns the AGGREGATED view instead: every registered rank's
        registry snapshot, each sample tagged ``instance=<label>``."""
        if req.query.get("fleet", ["false"])[0] == "true":
            raise unported("fleet metrics", A8)
        health = getattr(self.api.executor, "health", None)
        if health is not None:
            metrics.gauge(
                metrics.DEVICEHEALTH_HEALTHY, 1.0 if health.healthy else 0.0
            )
        stager = getattr(self.api.executor, "stager", None)
        if stager is not None:
            metrics.gauge(metrics.STAGER_BYTES, stager._bytes)
        # scrape-time freshness: uptime companion to build_info, and the
        # SLO gauges re-derived from the sample windows so the scrape
        # never reads a stale burn rate between server ticks
        srv = getattr(self.api, "server", None)
        started = getattr(srv, "started_at", None)
        if started:
            metrics.gauge(metrics.UPTIME_SECONDS, round(time.time() - started, 3))
        slo.MONITOR.tick()
        text = metrics.render_prometheus(
            extra_snapshots=[self._expvar_snapshot()]
        )
        return RawResponse(
            text.encode(), "text/plain; version=0.0.4; charset=utf-8"
        )

    def get_debug_pipeline(self, req) -> dict:
        """Serving-pipeline snapshot: per-class queue depth/limit,
        busy workers, admissions, sheds, coalesce/batch counters."""
        if self.pipeline is None:
            return {"enabled": False}
        return self.pipeline.stats()

    def get_debug_plancache(self, req) -> dict:
        """Plan result-cache snapshot: entries/bytes, hit ratio,
        invalidations, evictions, epoch (plan/cache.py)."""
        pc = getattr(self.api.executor, "plan_cache", None)
        if pc is None:
            return {"enabled": False}
        return pc.stats()

    def get_debug_fusion(self, req) -> dict:
        """Whole-query fusion snapshot: fused launches, calls per launch,
        bytes returned, bypass reasons, program count, and the
        device-resident plan cache (entries/bytes/hit ratio)."""
        fuser = getattr(self.api.executor, "fuser", None)
        if fuser is None:
            return {"enabled": False}
        return fuser.stats()

    def get_backup(self, req):
        """Full-holder backup archive (tar): MANIFEST.json with per-entry
        blake2b checksums, schema.json, and every fragment's roaring
        bytes. ``pilosa_tpu backup`` streams this to a file."""
        return RawResponse(self.api.backup(), "application/x-tar")

    def post_restore(self, req) -> dict:
        """Restore a holder backup. The whole archive is verified
        against its manifest (and every fragment parsed) before any
        byte is applied; a tampered archive is refused with 400."""
        return self.api.restore(req.body)

    def get_debug_traces(self, req) -> dict:
        """Recent completed query traces (the tracer's ring buffer) as
        JSON span trees, newest last; stitched with any remote spans
        pushed for their trace ids. Filters: ``?trace_id=``,
        ``?min_ms=``, ``?gang=``."""
        q = req.query
        min_ms = q.get("min_ms", [None])[0]
        try:
            min_ms_f = float(min_ms) if min_ms is not None else None
        except ValueError:
            raise APIError(f"invalid min_ms: {min_ms!r}", status=400)
        return {
            "traces": trace.TRACER.recent(
                trace_id=q.get("trace_id", [None])[0],
                min_ms=min_ms_f,
                gang=q.get("gang", [None])[0],
            )
        }

    def get_debug_events(self, req) -> dict:
        """The lifecycle event journal (utils/events.py): gang state
        transitions, degrades, re-forms, retry exhaustion, profiler and
        SLO alerts — bounded, ordered by seq. Filters: ``?kind=``,
        ``?since=<seq>``, ``?limit=<n>`` (newest n after filtering)."""
        q = req.query
        try:
            since = int(q.get("since", ["0"])[0])
            limit = int(q.get("limit", ["0"])[0])
        except ValueError:
            raise APIError("invalid since/limit: must be an integer", status=400)
        return {
            "events": events.snapshot(
                kind=q.get("kind", [None])[0], since_seq=since, limit=limit
            )
        }

    def get_debug_latency(self, req) -> dict:
        """Latency waterfalls: the stage taxonomy, the live
        rtt_fraction EMA, recent per-query waterfalls, and the
        per-class/per-stage summaries from the metric registry.
        ``?limit=<n>`` bounds the recent ring."""
        q = req.query
        try:
            limit = int(q.get("limit", ["0"])[0])
        except ValueError:
            raise APIError("invalid limit: must be an integer", status=400)
        out = profiler.WATERFALL.snapshot(limit=limit)
        snap = metrics.snapshot()
        prefix = metrics.LATENCY_STAGE_SECONDS
        out["summary"] = {
            k: v
            for k, v in snap.items()
            # flat keys carry aggregation suffixes (.hist etc.)
            if k.split(";", 1)[0].startswith(prefix)
        }
        return out

    def get_debug_profile(self, req) -> dict:
        """Continuous-profiler surface: stack-sampler top frames,
        per-signature compile table (the kernel builds), device memory
        telemetry, and on-demand ``torch.profiler`` capture control
        (``?capture=start&dir=<path>`` / ``?capture=stop``, which writes
        a Chrome trace into the directory). ``?top=<n>`` sizes the
        tables."""
        q = req.query
        try:
            top = int(q.get("top", ["25"])[0])
        except ValueError:
            raise APIError("invalid top: must be an integer", status=400)
        capture = q.get("capture", [None])[0]
        out: dict = {
            "sampler": profiler.SAMPLER.snapshot(top=top),
            "compiles": profiler.COMPILES.snapshot(top=top),
            "hbm": profiler.TELEMETRY.snapshot(),
            "capture": profiler.capture_status(),
        }
        if capture == "start":
            out["capture"] = profiler.start_capture(
                q.get("dir", ["/tmp/pilosa-profile"])[0]
            )
        elif capture == "stop":
            out["capture"] = profiler.stop_capture()
        elif capture is not None:
            raise APIError("capture must be start or stop", status=400)
        return out

    def get_debug_slo(self, req) -> dict:
        """SLO burn-rate snapshot: per-class objectives, 5m/1h burn
        rates, budget remaining, and firing state. Gauges refresh as a
        side effect, same as the scrape path."""
        slo.MONITOR.tick()
        return slo.MONITOR.snapshot()

    def get_debug_tenancy(self, req) -> dict:
        """Multi-tenant QoS snapshot (server/tenancy.py): per-tenant
        policy + bucket state, pipeline fairness counters, HBM
        attribution and quotas, latency waterfalls, heat rollup, and
        per-tenant SLO burn — the whole tenant story in one body."""
        from pilosa_tpu_torch.server.tenancy import TENANT_SLO_PREFIX

        tn = self.tenancy
        out: dict = (
            tn.snapshot() if tn is not None else {"enabled": False, "tenants": {}}
        )
        if self.pipeline is not None:
            ps = self.pipeline.stats()
            out["pipeline"] = {
                "weighted_fair": ps.get("weighted_fair", False),
                "tenants": ps.get("tenants", {}),
            }
        gov = getattr(self.api.executor, "governor", None)
        if gov is not None:
            gs = gov.stats()
            out["hbm"] = {
                "index_quotas": gs.get("index_quotas", {}),
                "index_used": gs.get("index_used", {}),
            }
        out["waterfalls"] = profiler.WATERFALL.tenant_waterfalls()
        if heat.LEDGER.enabled:
            out["heat"] = heat.tenant_rollup(
                heat.LEDGER.snapshot().get("cells", [])
            )
        # per-tenant SLO burn state (tenant:<index> classes in the
        # shared monitor)
        slo.MONITOR.tick()
        snap = slo.MONITOR.snapshot()
        out["slo"] = {
            cls[len(TENANT_SLO_PREFIX):]: st
            for cls, st in snap.get("classes", {}).items()
            if cls.startswith(TENANT_SLO_PREFIX)
        }
        return out

    def get_debug_chaos(self, req) -> dict:
        """Device-robustness snapshot: the HBM governor ledger, the
        OOM-recovery counters, health-gate trips, and which injected
        fault schedules are currently installed."""
        from pilosa_tpu_torch.core import fragment as fragment_mod
        from pilosa_tpu_torch.utils import chaos as chaos_mod

        ex = self.api.executor
        server = getattr(self.api, "server", None)
        gov = getattr(ex, "governor", None)
        oom = getattr(ex, "_oom", None)
        health = getattr(ex, "health", None)
        return {
            "enabled": bool(
                server is not None
                and getattr(server.config, "chaos_enabled", False)
            ),
            "governor": gov.stats() if gov is not None else None,
            "oom": oom.stats() if oom is not None else None,
            "health_trips": health.trips if health is not None else 0,
            "faults": {
                "storage": bool(fragment_mod.FAULTS),
                "device": bool(chaos_mod.FAULTS),
            },
        }

    def post_debug_chaos(self, req) -> dict:
        """Install or clear fault windows on a LIVE server. Body:
        ``{"storage": "<spec>", "device": "<spec>"}``; an empty/absent
        spec clears that family (distributed faults ride the cluster,
        ROADMAP A8). Gated by ``chaos-enabled``: a production server
        must not expose a fault injector. Each transition journals
        ``chaos.window``."""
        server = getattr(self.api, "server", None)
        if server is None or not getattr(server.config, "chaos_enabled", False):
            raise APIError(
                "chaos endpoint disabled (chaos-enabled = false)", status=403
            )
        from pilosa_tpu_torch.core import fragment as fragment_mod
        from pilosa_tpu_torch.utils import chaos as chaos_mod

        body = json.loads(req.body or b"{}")
        storage = str(body.get("storage") or "")
        device = str(body.get("device") or "")
        try:
            fragment_mod.install_storage_faults(storage)
            chaos_mod.install_device_faults(device)
        except ValueError as e:
            raise APIError(str(e), status=400)
        installed = bool(storage or device)
        events.record(
            events.CHAOS_WINDOW,
            action="install" if installed else "clear",
            storage=storage,
            device=device,
        )
        return {"installed": installed, "storage": storage, "device": device}

    def get_debug_heat(self, req) -> dict:
        """Workload heat ledger (utils/heat.py): per-(index, field,
        shard) read/write/staging counters, decayed EWMA scores, and
        placement-skew stats. Filters: ``?index=``, ``?dim=`` (ranking
        dimension — ``heat`` or a raw counter), ``?top=<k>``.
        ``?fleet=true`` on a fleet collector returns the MERGED view:
        every reachable instance's cells summed, skew recomputed over
        the whole fleet."""
        q = req.query
        dim = q.get("dim", ["heat"])[0]
        index = q.get("index", [""])[0]
        try:
            top = int(q.get("top", ["10"])[0])
        except ValueError:
            raise APIError("invalid top: must be an integer", status=400)
        if q.get("fleet", ["false"])[0] == "true":
            raise unported("fleet heat", A8)
        try:
            return heat.LEDGER.snapshot(index=index, dim=dim, top_k=top)
        except ValueError as e:
            raise APIError(str(e), status=400)

    def get_debug_bundle(self, req):
        """Incident forensics bundle: ONE deterministic tar (fixed
        entry metadata, sorted names, blake2b-128 manifest — the
        backup archive's idiom) capturing config, status, metrics,
        recent traces, the events tail, the heat snapshot, and
        the fuser's, the HBM governor's and OOM recovery's stats and the
        chaos snapshot (the port has no dispatch engine yet). ``debug-bundle`` streams it to
        a file."""
        import hashlib
        import io
        import tarfile

        srv = getattr(self.api, "server", None)
        entries: dict = {}

        def put_json(name: str, obj) -> None:
            entries[name] = json.dumps(
                obj, indent=2, sort_keys=True, default=str
            ).encode()

        if srv is not None and getattr(srv, "config", None) is not None:
            entries["config.toml"] = srv.config.to_toml().encode()
        put_json("status.json", self.api.status())
        entries["metrics.txt"] = metrics.render_prometheus(
            extra_snapshots=[self._expvar_snapshot()]
        ).encode()
        put_json("vars.json", self.get_debug_vars(req))
        put_json("traces.json", {"traces": trace.TRACER.recent()})
        put_json("events.json", {"events": events.snapshot(limit=500)})
        put_json("heat.json", heat.LEDGER.snapshot())
        put_json("fusion.json", self.get_debug_fusion(req))
        put_json("chaos.json", self.get_debug_chaos(req))
        ex = self.api.executor
        put_json(
            "governor.json",
            {"governor": ex.governor.stats(), "oom": ex._oom.stats()},
        )
        manifest = {
            "entries": {
                n: hashlib.blake2b(b, digest_size=16).hexdigest()
                for n, b in sorted(entries.items())
            }
        }
        entries["MANIFEST.json"] = json.dumps(
            manifest, indent=2, sort_keys=True
        ).encode()
        out = io.BytesIO()
        with tarfile.open(fileobj=out, mode="w") as tw:
            for name in sorted(entries):
                blob = entries[name]
                info = tarfile.TarInfo(name)
                info.size = len(blob)
                info.mode = 0o600
                info.mtime = 0
                tw.addfile(info, io.BytesIO(blob))
        return RawResponse(out.getvalue(), "application/x-tar")

    def get_debug_pprof(self, req):
        """Live thread stack dump — the CPython analog of the reference's
        net/http/pprof mount (http/handler.go:195): profiling text an
        operator can curl from a wedged server."""
        import sys
        import threading as _t

        names = {t.ident: t.name for t in _t.enumerate()}
        lines = []
        frames = sys._current_frames()
        try:
            for ident, frame in frames.items():
                lines.append(f"goroutine-analog {names.get(ident, '?')} [{ident}]:")
                lines.extend(
                    line.rstrip() for line in traceback.format_stack(frame)
                )
                lines.append("")
        finally:
            # this thread's own frame is among them: drop the references
            # so no dumped frame outlives the request in a cycle
            frames.clear()
            frame = None
        return RawResponse("\n".join(lines).encode(), "text/plain; charset=utf-8")

    # -- dispatch --

    def handle(
        self,
        method: str,
        path: str,
        query: dict,
        body: bytes,
        headers: Optional[dict] = None,
    ):
        for route in self.routes:
            if route.method != method:
                continue
            m = route.re.match(path)
            if m:
                req = Request(m.groupdict(), query, body, headers)
                return route.fn(req)
        raise APIError(f"no route for {method} {path}", status=404)


class Request:
    def __init__(
        self, params: dict, query: dict, body: bytes, headers: Optional[dict] = None
    ) -> None:
        self.params = params
        self.query = query
        self.body = body
        self.headers = {k.lower(): v for k, v in (headers or {}).items()}

    @property
    def is_proto(self) -> bool:
        return publicproto.CONTENT_TYPE in self.headers.get("content-type", "")

    @property
    def accepts_proto(self) -> bool:
        return publicproto.CONTENT_TYPE in self.headers.get("accept", "")


class RawResponse:
    def __init__(self, data: bytes, content_type: str) -> None:
        self.data = data
        self.content_type = content_type


def make_http_server(handler: Handler, host: str = "127.0.0.1", port: int = 0):
    """Build a ThreadingHTTPServer around the routing table."""

    class _Req(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY: without it, a keep-alive client pays the
        # Nagle + delayed-ACK interaction (~40 ms) on EVERY small
        # response — measured 23 qps vs 1,300+ on this loopback. The
        # reference's Go net/http sets it by default.
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # silence default stderr logging
            if handler.logger:
                handler.logger.debugf(fmt, *args)

        def _run(self, method: str):
            parsed = urlparse(self.path)
            body = b""
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                body = self.rfile.read(length)
            extra_headers = []
            try:
                result = handler.handle(
                    method,
                    parsed.path,
                    parse_qs(parsed.query),
                    body,
                    headers=dict(self.headers),
                )
                if isinstance(result, RawResponse):
                    payload = result.data
                    ctype = result.content_type
                else:
                    payload = json.dumps(result).encode()
                    ctype = "application/json"
                self.send_response(200)
            except Overloaded as e:
                # tenant-throttled (429: only THIS tenant must back
                # off) vs genuinely overloaded (503: class queue full /
                # draining — retry against another node); both carry
                # Retry-After so well-behaved clients come back instead
                # of hammering an overloaded server
                payload, ctype = self._error_payload(str(e))
                extra_headers.append(
                    ("Retry-After", str(max(1, round(e.retry_after))))
                )
                self.send_response(e.status)
            except NotImplementedError as e:
                # a subsystem this port lacks (the message names its
                # ROADMAP item): not implemented, never a client error
                payload, ctype = self._error_payload(str(e))
                self.send_response(501)
            except GangUnavailable as e:
                # multihost gang dead (follower loss): bounded clean
                # failure — the runtime already degraded to the local
                # mesh, so a retry executes locally
                payload, ctype = self._error_payload(str(e))
                extra_headers.append(
                    ("Retry-After", str(max(1, round(e.retry_after))))
                )
                self.send_response(e.status)
            except DeadlineExceeded as e:
                # the request's deadline passed; work was cancelled at a
                # stage boundary — 504, like a gateway timeout
                payload, ctype = self._error_payload(str(e))
                self.send_response(504)
            except FragmentQuarantinedError as e:
                # corrupt fragment under repair: clean 503 + Retry-After
                # (never a wrong answer) — by the time a well-behaved
                # client retries, scrub has usually pulled a replica copy
                payload, ctype = self._error_payload(str(e))
                extra_headers.append(
                    ("Retry-After", str(max(1, round(e.retry_after))))
                )
                self.send_response(e.status)
            except APIError as e:
                payload, ctype = self._error_payload(str(e))
                self.send_response(e.status)
            except ExecNotFound as e:
                # the executor's typed missing-index/field/bsiGroup
                # error — the reference maps exactly those to 404
                # (successResponse.check, http/handler.go:285-310)
                payload, ctype = self._error_payload(str(e).strip("'\""))
                self.send_response(404)
            except KeyError as e:
                # any untyped KeyError is an internal bug: a logged
                # 500, never an invisible not-found
                traceback.print_exc()
                payload, ctype = self._error_payload(
                    f"internal error: {str(e).strip(chr(39))}"
                )
                self.send_response(500)
            except ValueError as e:
                # bad user input (parse-adjacent arg errors, malformed
                # bodies) — 400, like the reference's BadRequest family.
                # A ValueError can also be an internal bug surfacing
                # through this catch; keep the trace reachable without
                # spamming logs on every client typo: debugf always,
                # full traceback when verbose.
                # format_exc is not free — only pay it when debugf
                # will actually emit (verbose logger)
                if handler.logger is not None and getattr(
                    handler.logger, "verbose", False
                ):
                    handler.logger.debugf(
                        "400 %s %s: %s\n%s",
                        method,
                        parsed.path,
                        e,
                        traceback.format_exc(),
                    )
                payload, ctype = self._error_payload(str(e))
                self.send_response(400)
            except Exception as e:  # panic recovery (reference ServeHTTP:239-276)
                traceback.print_exc()
                payload, ctype = self._error_payload(f"internal error: {e}")
                self.send_response(500)
            for name, value in extra_headers:
                self.send_header(name, value)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _error_payload(self, msg: str):
            # Only the query route speaks protobuf errors: clients
            # unmarshal a QueryResponse{Err} there (reference
            # http/error.go). Import/admin routes get plain text, like
            # the reference's http.Error calls (handlePostImport etc.)
            # — a proto ImportResponse has no error field to carry msg.
            # The check below matches exactly the /index/{index}/query
            # route shape — a FIELD named "query"
            # (/index/i/field/query) must not match.
            parts = [p for p in urlparse(self.path).path.split("/") if p]
            is_query = (
                len(parts) == 3 and parts[0] == "index" and parts[2] == "query"
            )
            wants_proto = publicproto.CONTENT_TYPE in (
                self.headers.get("Accept") or ""
            ) or publicproto.CONTENT_TYPE in (self.headers.get("Content-Type") or "")
            if is_query and wants_proto:
                return (
                    publicproto.encode_query_response([], err=msg),
                    publicproto.CONTENT_TYPE,
                )
            if wants_proto:
                return (msg + "\n").encode(), "text/plain; charset=utf-8"
            return json.dumps({"error": msg}).encode(), "application/json"

        def do_GET(self):
            self._run("GET")

        def do_POST(self):
            self._run("POST")

        def do_DELETE(self):
            self._run("DELETE")

    class _Srv(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5: under a closed-loop
        # client fleet (each request a fresh connection) the SYN queue
        # overflows and the kernel RSTs connections before the pipeline
        # can even shed them politely. The pipeline is the admission
        # layer — the transport backlog just needs to be deep enough to
        # hand every arrival to it.
        request_queue_size = 128

    return _Srv((host, port), _Req)


# (method, route, what, ROADMAP item) of the reference's routes whose
# subsystems are not in the port yet
_UNPORTED_ROUTES = (
    ("POST", r"/cluster/resize/set-coordinator", "cluster resize", A8),
    ("POST", r"/cluster/resize/remove-node", "cluster resize", A8),
    ("POST", r"/cluster/resize/abort", "cluster resize", A8),
    ("POST", r"/internal/cluster/message", "cluster messages", A8),
    ("GET", r"/internal/fragment/nodes", "shard ownership", A8),
    ("POST", r"/internal/fragment/block/data", "anti-entropy block merges", A8),
    ("POST", r"/internal/probe", "cluster liveness probes", A8),
    ("POST", r"/internal/gang/apply", "multihost gangs", A8),
    ("POST", r"/internal/gang/rejoin", "multihost gangs", A8),
    ("POST", r"/internal/trace/push", "gang trace push", A8),
    ("POST", r"/internal/fleet/register", "the fleet collector", A8),
    ("GET", r"/internal/fleet/snapshots", "the fleet collector", A8),
    ("GET", r"/internal/fleet/heat", "the fleet collector", A8),
    ("GET", r"/debug/fleet", "the fleet collector", A8),
    ("GET", r"/debug/multihost", "multihost gangs", A8),
    ("GET", r"/debug/scrub", "the integrity scrubber", A8),
    ("POST", r"/debug/scrub", "the integrity scrubber", A8),
    ("GET", r"/debug/dispatch", "the dispatch engine", A6),
)
