"""Serving pipeline — the scheduler between the HTTP transport and the
executor.

Without it every request goes straight from an unbounded
``ThreadingHTTPServer`` thread into ``Executor.execute`` with no queue,
no deadlines and no overload behaviour. Serving systems put a
scheduling layer in exactly this position (Clipper-style adaptive
batching, Orca-style continuous batching); this module is that layer
(the port of ``pilosa_tpu/server/pipeline.py``):

* **Bounded admission, per class.** Requests are classed ``interactive``
  (user queries), ``bulk`` (imports), or ``internal`` (node-to-node
  legs of distributed queries/imports), each with its own bounded queue
  and dedicated worker pool — a flood of user queries cannot starve the
  cluster data plane, and a bulk import cannot starve reads. A full
  queue sheds the request immediately with ``Overloaded`` (HTTP 503 +
  ``Retry-After`` — the server as a whole is out of capacity; distinct
  from the per-tenant 429 below) instead of piling up threads until
  the process falls over.
* **Per-tenant admission + weighted-fair scheduling**. With
  a ``TenancyManager`` attached (server/tenancy.py), ``submit`` first
  charges the request's *index* against that tenant's token bucket —
  an exhausted tenant is refused with ``TenantThrottled`` (HTTP 429 +
  its own ``Retry-After``) while everyone else proceeds — and each
  class queue dequeues weighted-fair across tenants (virtual-time WFQ:
  an entry's virtual finish time advances its tenant's clock by
  ``1/weight``, the queue pops minimum finish time), so a tenant's
  burst queues behind its own weight instead of the whole fleet.
  Deadline expiry and shed semantics are unchanged; without tenancy
  (the single-tenant default) the queue is plain FIFO.
* **Deadline scheduling.** Each entry carries its request deadline
  (server/deadline.py); work whose deadline passed while queued is
  cancelled at dequeue — before the parse, the executor, or any shard
  map runs — so an overloaded server spends its workers only on
  requests that can still be answered in time.
* **Singleflight coalescing.** Equivalent concurrent read-only queries
  (same index and options, same CANONICAL plan hash — plan/canon.py,
  wired in by the HTTP handler's signature) execute ONCE; duplicates
  attach to the in-flight leader and share its result without consuming
  a queue slot or a worker. Keying on the canonical hash instead of raw
  text means argument-order-permuted spellings of one query —
  ``Intersect(Row(a), Row(b))`` vs ``Intersect(Row(b), Row(a))`` —
  coalesce too.
* **Cross-request batching.** When the queue backs up, a worker drains
  every queued entry with the same batch key (same index + options,
  read-only) in one gang and executes them as a single combined
  multi-call query. The executor fans the combined calls through its
  read pool, where the continuous ``BatchedScorer`` (and, when enabled,
  the chain-batch gate) coalesces them into batched kernel launches —
  extending the batching that previously only helped within one HTTP
  request to the whole queue. There is no artificial wait window by
  default (``pipeline-batch-window`` can add one): like the scorer,
  batch width self-tunes to the backlog.
* **Graceful drain.** ``close()`` stops admission (503), completes
  queued + in-flight work within ``drain`` seconds, and fails whatever
  remains — a restart loses no accepted work it had time to finish.

Observability: every decision lands in the process-global metric
registry (queue depth/wait, sheds, coalesce hits, batch width, deadline
expiries — docs/administration.md §Metric reference) and in the
``/debug/pipeline`` snapshot.
"""

from __future__ import annotations

import heapq
import re
import threading
import time
from typing import Any, Callable, Optional

from pilosa_tpu_torch.analysis.locks import OrderedLock
from pilosa_tpu_torch.server import deadline as deadline_mod
from pilosa_tpu_torch.server.deadline import Deadline, DeadlineExceeded
from pilosa_tpu_torch.utils import metrics, trace

CLASS_INTERACTIVE = "interactive"
CLASS_BULK = "bulk"
CLASS_INTERNAL = "internal"
CLASSES = (CLASS_INTERACTIVE, CLASS_BULK, CLASS_INTERNAL)

# analytic bulk-query detector (executor/analytics.py): like the write
# detector in the HTTP layer, a false positive from a quoted key only
# reroutes the request to a stricter class, never breaks it
_ANALYTIC_CALL_RE = re.compile(r"\b(?:GroupBy|Distinct|Percentile)\s*\(")


def classify_query(body: str, remote: bool) -> str:
    """Pipeline class for one /query body. Remote legs of distributed
    queries are internal traffic (their own queue — a user-query flood
    must not shed the cluster data plane). Analytic bulk queries
    (GroupBy / Distinct / Percentile) route to the BULK class: a
    dashboard's panel burst then queues behind the bulk workers and
    burns the bulk SLO budget instead of interactive p50. Everything
    else is interactive."""
    if remote:
        return CLASS_INTERNAL
    if body and _ANALYTIC_CALL_RE.search(body):
        return CLASS_BULK
    return CLASS_INTERACTIVE


class Overloaded(Exception):
    """Admission refused. ``status`` 503 for genuine overload (class
    queue full, server draining or shut down — retry after
    ``retry_after`` seconds, ideally against another node) or 429 for
    a per-tenant refusal (``TenantThrottled``, server/tenancy.py —
    only that tenant must back off)."""

    def __init__(self, message: str, retry_after: float = 1.0, status: int = 503) -> None:
        super().__init__(message)
        self.retry_after = retry_after
        self.status = status


# wait time (seconds) the current pipeline worker's entry spent queued;
# API.query backfills it as a `pipeline.wait` span on the root trace
_entry_wait: "threading.local" = threading.local()


def current_queue_wait() -> float:
    return getattr(_entry_wait, "value", 0.0)


class _Entry:
    __slots__ = (
        "cls",
        "thunk",
        "signature",
        "batch_key",
        "batch_payload",
        "deadline",
        "event",
        "result",
        "error",
        "t_enq",
        "wait_s",
        "trace_ctx",
        "index",
        "seq",
        "vstart",
        "vft",
        "skip",
    )

    def __init__(
        self,
        cls: str,
        thunk: Callable[[], Any],
        signature=None,
        batch_key=None,
        batch_payload=None,
        deadline: Optional[Deadline] = None,
        trace_ctx: Optional[tuple] = None,
        index: str = "",
    ) -> None:
        self.cls = cls
        self.thunk = thunk
        self.signature = signature
        self.batch_key = batch_key
        self.batch_payload = batch_payload
        self.deadline = deadline
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.t_enq = 0.0
        self.wait_s = 0.0
        # distributed trace context (utils/trace.py tuple): carried so
        # a coalesced follower can link the leader's trace
        self.trace_ctx = trace_ctx
        # the tenant: per-tenant counters + WFQ scheduling
        self.index = index
        # _TenantFairQueue bookkeeping: arrival order, virtual
        # start/finish time, and the lazy-removal marker
        self.seq = 0
        self.vstart = 0.0
        self.vft = 0.0
        self.skip = False


class _TenantFairQueue:
    """Virtual-time weighted-fair queue over ``_Entry.index`` with the
    small deque-ish surface the workers use (append / popleft / remove
    / len / iteration in dequeue order).

    Classic WFQ collapsed to unit cost per entry: an arriving entry's
    virtual start is ``max(V, finish[tenant])``, its finish is
    ``start + 1/weight``, and ``popleft`` returns the minimum finish
    time — over any backlogged window each tenant dequeues in
    proportion to its weight, and an idle tenant re-enters at the
    current virtual time V (no banked credit, no starvation). With no
    ``weight_fn`` (the single-tenant default) every entry gets finish
    0 and the seq tie-break makes the queue exactly FIFO — bit-for-bit
    the pre-tenancy order. Callers hold the pipeline lock."""

    __slots__ = ("weight_fn", "_heap", "_len", "_seq", "_vtime", "_finish", "_nq")

    def __init__(self, weight_fn: Optional[Callable[[str], float]] = None) -> None:
        self.weight_fn = weight_fn
        self._heap: list[tuple[float, int, _Entry]] = []
        self._len = 0
        self._seq = 0
        self._vtime = 0.0
        # tenant -> virtual finish of its latest queued entry
        self._finish: dict[str, float] = {}
        # tenant -> live queued entries (prunes _finish when it can)
        self._nq: dict[str, int] = {}

    def __len__(self) -> int:
        return self._len

    def __iter__(self):
        """Live entries in dequeue order — the batch-collection scans
        (_dequeue_gang / _collect_window) see the same order popleft
        would produce."""
        live = sorted(t for t in self._heap if not t[2].skip)
        return iter(e for _, _, e in live)

    def append(self, e: _Entry) -> None:
        e.seq = self._seq
        self._seq += 1
        if self.weight_fn is not None:
            t = e.index
            try:
                w = float(self.weight_fn(t) or 1.0)
            except Exception:
                w = 1.0
            start = max(self._vtime, self._finish.get(t, 0.0))
            e.vstart = start
            e.vft = start + 1.0 / max(1e-3, w)
            self._finish[t] = e.vft
            self._nq[t] = self._nq.get(t, 0) + 1
        heapq.heappush(self._heap, (e.vft, e.seq, e))
        self._len += 1

    def popleft(self) -> _Entry:
        while self._heap:
            _, _, e = heapq.heappop(self._heap)
            if e.skip:
                continue
            self._drop(e)
            # virtual time advances to the dequeued entry's start: a
            # tenant arriving later starts from here, not from zero
            if e.vstart > self._vtime:
                self._vtime = e.vstart
            return e
        raise IndexError("pop from an empty _TenantFairQueue")

    def remove(self, e: _Entry) -> None:
        """Lazy removal: mark; the heap tuple is discarded at pop."""
        if e.skip:
            raise ValueError("entry not in queue")
        e.skip = True
        self._drop(e)

    def _drop(self, e: _Entry) -> None:
        self._len -= 1
        if self.weight_fn is None:
            return
        t = e.index
        n = self._nq.get(t, 1) - 1
        if n > 0:
            self._nq[t] = n
        else:
            self._nq.pop(t, None)
            # the finish stamp only matters while it is ahead of V
            # (recent credit); once V caught up it is dead weight
            if self._finish.get(t, 0.0) <= self._vtime:
                self._finish.pop(t, None)
        if len(self._finish) > 2 * len(self._nq) + 64:
            for k in [
                k
                for k, f in self._finish.items()
                if f <= self._vtime and k not in self._nq
            ]:
                del self._finish[k]


class _ClassQueue:
    """One bounded admission queue + its dedicated workers."""

    __slots__ = (
        "name",
        "limit",
        "workers",
        "q",
        "busy",
        "admitted",
        "sheds",
        "completed",
    )

    def __init__(
        self,
        name: str,
        limit: int,
        workers: int,
        weight_fn: Optional[Callable[[str], float]] = None,
    ) -> None:
        self.name = name
        self.limit = limit
        self.workers = workers
        self.q = _TenantFairQueue(weight_fn)
        self.busy = 0
        self.admitted = 0
        self.sheds = 0
        self.completed = 0


def make_query_combiner(api) -> Callable:
    """Gang executor for homogeneous read-only queries: concatenate the
    members' PQL (PQL is whitespace-separated calls), run ONE
    ``api.query``, and split the results back by each member's call
    count. The combined call list flows through the executor's
    concurrent read pool, where the batched scorers coalesce the
    members' kernel work into single launches — cross-request batching
    through entirely existing machinery. Any error falls back to
    per-entry execution (the pipeline worker handles that), so a bad
    member can never fail its gang-mates."""
    from pilosa_tpu_torch.pql import parse

    def combine(entries: list[_Entry]) -> list[dict]:
        p = entries[0].batch_payload
        texts = [e.batch_payload["query"] for e in entries]
        # per-member call counts; also surfaces a syntax error BEFORE
        # the combined execution so the fallback gives it a proper 400
        counts = [len(parse(t).calls) for t in texts]
        resp = api.query(p["index"], " ".join(texts), **p["kwargs"])
        results = resp["results"]
        out, off = [], 0
        for n in counts:
            out.append({"results": results[off : off + n]})
            off += n
        return out

    return combine


class QueryPipeline:
    """The scheduler. ``submit`` blocks the calling (HTTP) thread until
    its entry is executed by a class worker, shed, or expired — the
    transport thread still writes the response, but execution
    concurrency and queue growth are bounded here."""

    def __init__(
        self,
        workers: Optional[dict[str, int]] = None,
        queue_limits: Optional[dict[str, int]] = None,
        combine_fn: Optional[Callable] = None,
        batch_max: int = 16,
        batch_window: float = 0.0,
        shed_retry_after: float = 1.0,
        drain_timeout: float = 10.0,
        dispatch_handoff: bool = False,
        tenancy=None,
    ) -> None:
        workers = workers or {}
        queue_limits = queue_limits or {}
        defaults_w = {CLASS_INTERACTIVE: 8, CLASS_BULK: 2, CLASS_INTERNAL: 8}
        defaults_q = {CLASS_INTERACTIVE: 64, CLASS_BULK: 16, CLASS_INTERNAL: 128}
        self._mu = OrderedLock("pipeline.mu")
        self._cond = threading.Condition(self._mu)
        # server/tenancy.py TenancyManager (duck-typed: weight / admit /
        # release). None or a disabled manager keeps the pre-tenancy
        # fast path: FIFO queues, no admission charge, no extra lock.
        self.tenancy = tenancy
        weight_fn = (
            tenancy.weight
            if tenancy is not None and getattr(tenancy, "enabled", False)
            else None
        )
        self._classes = {
            c: _ClassQueue(
                c,
                max(1, int(queue_limits.get(c, defaults_q[c]))),
                max(1, int(workers.get(c, defaults_w[c]))),
                weight_fn=weight_fn,
            )
            for c in CLASSES
        }
        self.combine_fn = combine_fn
        self.batch_max = max(1, int(batch_max))
        self.batch_window = float(batch_window)
        self.shed_retry_after = float(shed_retry_after)
        self.drain_timeout = float(drain_timeout)
        # when the executor's continuous-batching dispatch engine owns
        # cross-request combining (it groups heterogeneous plans by
        # canonical signature per wave), workers hand entries off one at
        # a time instead of gang-batching identical queries here —
        # otherwise both layers would contend for the same backlog
        self.dispatch_handoff = bool(dispatch_handoff)
        self._closing = False
        # signature -> leader entry (singleflight)
        self._inflight: dict = {}
        # cross-class counters (ints under _mu; snapshot is consistent)
        self.coalesce_hits = 0
        self.batches = 0
        self.batched_entries = 0
        self.expired = 0
        # per-tenant counters (under mixed load the
        # lumped counters above are misleading — /debug/pipeline and
        # /debug/tenancy break them out by index). Keyed by index, ""
        # excluded (direct submit callers with no tenant context).
        self.tenant_counters: dict[str, dict[str, int]] = {}
        self._threads: list[threading.Thread] = []
        for c, cq in self._classes.items():
            for i in range(cq.workers):
                t = threading.Thread(
                    target=self._worker, args=(cq,), name=f"pipeline-{c}-{i}",
                    daemon=True,
                )
                t.start()
                self._threads.append(t)

    # -- admission -----------------------------------------------------------

    def submit(
        self,
        cls: str,
        thunk: Callable[[], Any],
        deadline: Optional[Deadline] = None,
        signature=None,
        batch: Optional[dict] = None,
        trace_ctx: Optional[tuple] = None,
        index: str = "",
        nbytes: int = 0,
    ) -> Any:
        """Run ``thunk`` through the pipeline and return its result.
        Raises Overloaded (shed / draining / tenant-throttled),
        DeadlineExceeded, or whatever the thunk raised. ``index`` is
        the tenant; ``nbytes`` its in-flight byte charge (the request
        body size — released when submit returns)."""
        tenancy = self.tenancy
        charged = False
        if tenancy is not None:
            # per-tenant token bucket BEFORE the shared queue: raises
            # TenantThrottled (429 + the tenant's own Retry-After)
            try:
                tenancy.admit(index, cls, nbytes)
            except Overloaded:
                if index:
                    with self._mu:
                        self._tenant_counter(index)["throttled"] += 1
                raise
            charged = True
        try:
            return self._submit_admitted(
                cls, thunk, deadline, signature, batch, trace_ctx, index
            )
        finally:
            if charged:
                tenancy.release(index, cls, nbytes)

    def _tenant_counter(self, index: str) -> dict[str, int]:
        """Per-tenant counter row; caller holds _mu."""
        d = self.tenant_counters.get(index)
        if d is None:
            d = self.tenant_counters[index] = {
                "admitted": 0,
                "sheds": 0,
                "throttled": 0,
                "expired": 0,
                "completed": 0,
                "coalesce_hits": 0,
            }
        return d

    def _submit_admitted(
        self,
        cls: str,
        thunk: Callable[[], Any],
        deadline: Optional[Deadline],
        signature,
        batch: Optional[dict],
        trace_ctx: Optional[tuple],
        index: str,
    ) -> Any:
        cq = self._classes[cls]
        entry = _Entry(
            cls,
            thunk,
            signature=signature,
            batch_key=batch["key"] if batch else None,
            batch_payload=batch,
            deadline=deadline,
            trace_ctx=trace_ctx,
            index=index,
        )
        leader: Optional[_Entry] = None
        with self._mu:
            if self._closing:
                raise Overloaded("server is draining", status=503)
            if signature is not None:
                leader = self._inflight.get(signature)
                if leader is not None:
                    # duplicate of an in-flight query: attach, consume
                    # no queue slot, no worker
                    self.coalesce_hits += 1
                    metrics.count(metrics.PIPELINE_COALESCE_HITS)
                    if index:
                        self._tenant_counter(index)["coalesce_hits"] += 1
                else:
                    self._inflight[signature] = entry
            if leader is None:
                if len(cq.q) >= cq.limit:
                    cq.sheds += 1
                    metrics.count(metrics.PIPELINE_SHEDS, cls=cls)
                    if index:
                        self._tenant_counter(index)["sheds"] += 1
                        metrics.count(
                            metrics.TENANT_SHEDS, tenant=index, cls=cls
                        )
                    if signature is not None:
                        self._inflight.pop(signature, None)
                    # 503, not 429: the CLASS queue is full — the server
                    # (not one tenant) is out of capacity, and internal
                    # retry policy treats 503 as retryable-elsewhere
                    raise Overloaded(
                        f"{cls} admission queue full "
                        f"({len(cq.q)}/{cq.limit}); retry later",
                        retry_after=self.shed_retry_after,
                        status=503,
                    )
                entry.t_enq = time.monotonic()
                cq.q.append(entry)
                cq.admitted += 1
                metrics.count(metrics.PIPELINE_ADMITTED, cls=cls)
                if index:
                    self._tenant_counter(index)["admitted"] += 1
                    metrics.count(
                        metrics.TENANT_ADMITTED, tenant=index, cls=cls
                    )
                metrics.gauge(metrics.PIPELINE_QUEUE_DEPTH, len(cq.q), cls=cls)
                self._cond.notify_all()
        if leader is not None and trace_ctx is not None and trace_ctx[2]:
            # singleflight made this request a follower: it never
            # executes, so its trace gets a point entry span-linking
            # the leader's execution (outside _mu — the tracer has its
            # own lock and link recording must not extend admission)
            lctx = leader.trace_ctx
            trace.record_link(
                metrics.STAGE_PIPELINE_COALESCE,
                trace_ctx,
                lctx if lctx is not None else ("", ""),
                cls=cls,
                leader_traced=bool(lctx is not None and lctx[2]),
            )
        # wait OUTSIDE the lock (workers need it to make progress)
        return self._await(leader if leader is not None else entry, deadline)

    def _await(self, entry: _Entry, dl: Optional[Deadline]):
        """Block until ``entry`` resolves; a waiter whose own deadline
        passes first stops waiting (its queued work is skipped by the
        worker's dequeue-time check; a follower simply detaches)."""
        if dl is None:
            entry.event.wait()
        else:
            while not entry.event.is_set():
                rem = dl.remaining()
                if rem <= 0:
                    dl.check("admission")  # raises (and counts)
                entry.event.wait(timeout=min(rem, 0.5))
        if entry.error is not None:
            raise entry.error
        return entry.result

    # -- workers -------------------------------------------------------------

    def _worker(self, cq: _ClassQueue) -> None:
        while True:
            with self._mu:
                while not cq.q and not self._closing:
                    self._cond.wait()
                if not cq.q:
                    return  # closing and drained
                gang = self._dequeue_gang(cq)
                cq.busy += len(gang)
                metrics.gauge(metrics.PIPELINE_QUEUE_DEPTH, len(cq.q), cls=cq.name)
            try:
                self._run_gang(cq, gang)
            finally:
                with self._mu:
                    cq.busy -= len(gang)
                    cq.completed += len(gang)
                    for e in gang:
                        if e.index:
                            self._tenant_counter(e.index)["completed"] += 1

    def _dequeue_gang(self, cq: _ClassQueue) -> list[_Entry]:
        """Pop the head entry plus every queued peer sharing its batch
        key (up to batch_max) — the backlog IS the batching window.
        The batch key carries the index, so a gang is always a single
        tenant's work. Caller holds the lock."""
        head = cq.q.popleft()
        gang = [head]
        if (
            self.dispatch_handoff
            or head.batch_key is None
            or self.batch_max < 2
            or not self.combine_fn
        ):
            return gang
        if cq.q:
            took = [e for e in cq.q if e.batch_key == head.batch_key]
            for e in took[: self.batch_max - 1]:
                cq.q.remove(e)
                gang.append(e)
        return gang

    def _collect_window(self, cq: _ClassQueue, gang: list[_Entry]) -> list[_Entry]:
        """Optional artificial batching window: wait up to
        ``batch_window`` for same-key arrivals before executing. Off by
        default (0) — the continuous design needs no wait under load
        and a lone query must not pay latency for an empty queue."""
        if self.batch_window <= 0 or len(gang) >= self.batch_max:
            return gang
        stop = time.monotonic() + self.batch_window
        key = gang[0].batch_key
        while time.monotonic() < stop and len(gang) < self.batch_max:
            with self._mu:
                took = [e for e in cq.q if e.batch_key == key]
                for e in took[: self.batch_max - len(gang)]:
                    cq.q.remove(e)
                    gang.append(e)
            if len(gang) >= self.batch_max:
                break
            time.sleep(min(0.0005, self.batch_window))
        return gang

    def _run_gang(self, cq: _ClassQueue, gang: list[_Entry]) -> None:
        if gang and gang[0].batch_key is not None:
            gang = self._collect_window(cq, gang)
        now = time.monotonic()
        live: list[_Entry] = []
        for e in gang:
            e.wait_s = now - e.t_enq
            metrics.observe(metrics.PIPELINE_WAIT_SECONDS, e.wait_s, cls=cq.name)
            if e.index:
                metrics.observe(
                    metrics.TENANT_QUEUE_WAIT_SECONDS,
                    e.wait_s,
                    tenant=e.index,
                    cls=cq.name,
                )
            if e.deadline is not None and e.deadline.expired():
                # expired while queued: cancel BEFORE any parse/executor
                # work (its waiter already raised or will immediately)
                with self._mu:
                    self.expired += 1
                    if e.index:
                        self._tenant_counter(e.index)["expired"] += 1
                metrics.count(metrics.PIPELINE_DEADLINE_EXPIRED, stage="queue")
                self._finish(e, error=DeadlineExceeded("queue"))
                continue
            live.append(e)
        if not live:
            return
        if len(live) >= 2 and self.combine_fn is not None:
            with self._mu:
                self.batches += 1
                self.batched_entries += len(live)
            metrics.count(metrics.PIPELINE_BATCHES)
            metrics.observe(metrics.PIPELINE_BATCH_WIDTH, len(live))
            dls = [e.deadline for e in live if e.deadline is not None]
            gang_dl = min(dls, key=lambda d: d.at) if dls else None
            try:
                with deadline_mod.activate(gang_dl):
                    results = self.combine_fn(live)
                for e, r in zip(live, results):
                    self._finish(e, result=r)
                return
            except BaseException:
                # combined execution failed (one bad member, deadline,
                # anything): fall back to per-entry execution so each
                # member gets ITS OWN outcome
                pass
        for e in live:
            self._run_one(e)

    def _run_one(self, e: _Entry) -> None:
        if e.deadline is not None and e.deadline.expired():
            with self._mu:
                self.expired += 1
                if e.index:
                    self._tenant_counter(e.index)["expired"] += 1
            metrics.count(metrics.PIPELINE_DEADLINE_EXPIRED, stage="queue")
            self._finish(e, error=DeadlineExceeded("queue"))
            return
        _entry_wait.value = e.wait_s
        try:
            with deadline_mod.activate(e.deadline):
                self._finish(e, result=e.thunk())
        except BaseException as err:
            self._finish(e, error=err)
        finally:
            _entry_wait.value = 0.0

    def _finish(self, e: _Entry, result=None, error=None) -> None:
        e.result = result
        e.error = error
        if e.signature is not None:
            with self._mu:
                if self._inflight.get(e.signature) is e:
                    del self._inflight[e.signature]
        e.event.set()

    # -- lifecycle -----------------------------------------------------------

    def close(self, drain: Optional[float] = None) -> bool:
        """Graceful drain: stop admission, let the workers complete
        queued + in-flight work, fail the rest after ``drain`` seconds.
        Returns True when everything drained in time."""
        drain = self.drain_timeout if drain is None else drain
        t0 = time.monotonic()
        with self._mu:
            if self._closing:
                return True
            self._closing = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=max(0.0, drain - (time.monotonic() - t0)))
        clean = True
        # pop under the lock, finish outside it: _finish re-acquires
        # _mu to drop the coalescing-inflight entry, so calling it here
        # with _mu held self-deadlocks on any queued signatured request
        leftovers: list[_Entry] = []
        with self._mu:
            for cq in self._classes.values():
                while cq.q:
                    clean = False
                    leftovers.append(cq.q.popleft())
        for e in leftovers:
            self._finish(e, error=Overloaded("server shut down", status=503))
        metrics.observe(metrics.PIPELINE_DRAIN_SECONDS, time.monotonic() - t0)
        return clean and all(not t.is_alive() for t in self._threads)

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        """The /debug/pipeline snapshot."""
        with self._mu:
            return {
                "enabled": True,
                "closing": self._closing,
                "batch_max": self.batch_max,
                "batch_window_s": self.batch_window,
                "dispatch_handoff": self.dispatch_handoff,
                "coalesce_hits": self.coalesce_hits,
                "coalesce_inflight": len(self._inflight),
                "batches": self.batches,
                "batched_entries": self.batched_entries,
                "deadline_expired": self.expired,
                "weighted_fair": any(
                    cq.q.weight_fn is not None for cq in self._classes.values()
                ),
                "tenants": {
                    idx: dict(row)
                    for idx, row in self.tenant_counters.items()
                },
                "classes": {
                    c: {
                        "queue_depth": len(cq.q),
                        "queue_limit": cq.limit,
                        "workers": cq.workers,
                        "busy": cq.busy,
                        "admitted": cq.admitted,
                        "sheds": cq.sheds,
                        "completed": cq.completed,
                    }
                    for c, cq in self._classes.items()
                },
            }
