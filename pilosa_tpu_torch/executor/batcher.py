"""Continuous micro-batching of TopN scoring launches.

The serving throughput lever is batching: one kernel launch scoring Q
query sources against a staged fragment matrix costs little more than
scoring one, because the scan is bound by reading the matrix
(ops.intersection_counts_matrix_batch_list reads it once for all Q). The
reference has no analog — each Go query runs its own heap loop
(fragment.go:985).

Batching is *continuous*: there is no artificial wait window.
Concurrent callers enqueue; the first to find no active dispatcher is
promoted to leader and drains the queue in rounds until it is empty,
launching one batched kernel per staged matrix per round. A lone caller
dispatches immediately. While a round's fetch is in flight, new arrivals
accumulate for the next round, so batch width self-tunes to the fetch
latency.

The coalescing logic is the JAX package's (``pilosa_tpu/executor/
batcher.py``) unchanged; only the kernels and the host fetch differ.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from pilosa_tpu_torch import ops
from pilosa_tpu_torch.utils import metrics, trace


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _trim_device(dev, rows: Optional[int] = None, cols: Optional[int] = None):
    """Slice a still-on-device score tensor down to what callers will
    read, so the subsequent fetch only moves live lanes/columns.
    Anything without an ``ndim`` (or an unexpected rank) passes through
    untouched."""
    try:
        nd = dev.ndim
    except AttributeError:
        return dev
    if nd == 1:
        if rows is not None:
            dev = dev[:rows]
        return dev
    if nd == 2:
        if rows is not None:
            dev = dev[:rows]
        if cols is not None:
            dev = dev[:, :cols]
    return dev


def _to_host(scores) -> np.ndarray:
    """Fetch a score tensor to the host (waits for its kernel)."""
    if isinstance(scores, torch.Tensor):
        return scores.cpu().numpy()
    return np.asarray(scores)


class _Slot:
    __slots__ = ("src", "event", "result", "error", "trim")

    def __init__(self, src, trim: Optional[int] = None) -> None:
        self.src = src
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        # rows of the score vector the caller will actually read (the
        # staged matrix is pow2-padded); set ⇒ _launch trims on device
        # before the fetch so pad lanes never cross the host boundary
        self.trim = trim

    def finish(self, scorer: "BatchedScorer" = None) -> np.ndarray:
        if scorer is None:
            self.event.wait()
        else:
            # bounded wait + rescue: if the queue is orphaned (leader
            # exited in the narrow window between waking its round's
            # waiters and a new arrival promoting itself), any blocked
            # waiter picks the work up within one poll interval
            while not self.event.wait(timeout=0.1):
                scorer._rescue()
        if self.error is not None:
            raise self.error
        return self.result


class BatchedScorer:
    """Coalesces concurrent ``score`` calls with the same key (same
    staged matrix) into batched kernel launches.

    The kernel pair is pluggable: the default scores a dense staged
    matrix; the executor's stacked-sparse TopN path and the chain count
    supply their own kernels (same drain/coalesce machinery, the staged
    operand is opaque to it).
    ``single_fn(src, staged) -> i32[R]``;
    ``batch_fn([src] * Q, staged) -> i32[Q, R]`` — a LIST of sources,
    stacked inside the call.
    """

    def __init__(
        self, max_batch: int = 32, single_fn=None, batch_fn=None, pad_fn=None
    ) -> None:
        self.max_batch = max_batch
        # pow2 padding strategy: None = cached zeros (sources are single
        # tensors; a zero source scores 0 and is sliced off). Callers
        # whose src is NOT one tensor (the chain path's tuple of leaf
        # tensors) supply pad_fn(proto_src) -> pad_src; padding with a
        # repeat of a real source is always semantically safe because
        # pad lanes' results are never assigned to a slot.
        self._pad_fn = pad_fn
        self._single_fn = single_fn or (
            lambda src, staged: ops.intersection_counts_matrix(src, staged)
        )
        self._batch_fn = batch_fn or (
            lambda srcs, staged: ops.intersection_counts_matrix_batch_list(
                srcs, staged
            )
        )
        # pow2 padding zeros, cached per (shape, dtype, device): kernels
        # only read them, so one allocation serves every launch
        self._pad_zeros: dict = {}
        self._lock = threading.Lock()  # protects _pending/_dispatching
        # key -> (staged operand, waiting slots); the operand rides with
        # the queue because the dispatching leader may not be the thread
        # that enqueued this key's work
        self._pending: dict[tuple, tuple] = {}
        self._dispatching = False
        # telemetry (read by tests/smoke; no lock — monotonic counters)
        self.dispatches = 0
        self.batched_queries = 0

    def score(self, key: tuple, mat, src, trim: Optional[int] = None) -> np.ndarray:
        """popcount(src & row) per matrix row → i32[R].

        key MUST be derived from the live staged tensor's identity
        (e.g. ``(id(frag), id(mat))`` — see executor._LazyScores), so
        same key ⇔ same tensor object: keying on mutable metadata like
        frag.generation reintroduces a race where coalesced peers hold
        different matrices.

        Leader-promotion continuous batching: the first caller to find
        no active dispatcher becomes one and drains the WHOLE queue
        (all keys) in rounds until it is empty; everyone else just
        waits on their slot."""
        sp = trace.current()
        attrib = trace.attrib_current()
        t0 = time.monotonic()
        slot = _Slot(src, trim=trim)
        with self._lock:
            ent = self._pending.get(key)
            if ent is None:
                self._pending[key] = (mat, [slot])
            else:
                ent[1].append(slot)
            if self._dispatching:
                lead = False
            else:
                self._dispatching = lead = True
        if lead:
            pre_dev = (
                attrib.get(trace.WF_DEVICE_COMPUTE, 0.0)
                if attrib is not None
                else 0.0
            )
            self._dispatch_loop(own=slot)
        out = slot.finish(self)
        wait = time.monotonic() - t0
        metrics.observe(metrics.BATCHER_SLOT_WAIT_SECONDS, wait)
        if attrib is not None:
            if lead:
                # the leader's wait covers launch + device fetch (and at
                # most one extra round served for peers) — device time.
                # Kernels wrapped by _timed_kernel (chain batch) already
                # attributed their fenced leg; count only the remainder.
                already = attrib.get(trace.WF_DEVICE_COMPUTE, 0.0) - pre_dev
                if wait > already:
                    trace.attrib_add(trace.WF_DEVICE_COMPUTE, wait - already)
            else:
                # a non-lead waiter's slot wait IS device time: its work
                # ran inside the leader's launch
                trace.attrib_add(trace.WF_DEVICE_COMPUTE, wait)
        if sp is not None:
            sp.record(metrics.STAGE_BATCH_SCORE, t0, wait, lead=lead)
        return out

    def _rescue(self) -> None:
        """Adopt an orphaned queue (no active dispatcher but pending
        work) — called by blocked waiters on their poll interval."""
        with self._lock:
            if self._dispatching or not self._pending:
                return
            self._dispatching = True
        metrics.count(metrics.BATCHER_RESCUES)
        self._dispatch_loop(own=None)

    def _dispatch_loop(self, own: Optional[_Slot] = None) -> None:
        """Drain-launch-fetch rounds until the queue is empty or this
        leader's own request has been served. Within a round, every
        key's kernels launch (async) before any key's results are
        fetched. Rounds are double-buffered: round N+1's kernels launch
        before round N's results are fetched. Errors land on the
        affected slots (finish() re-raises them per waiter); one key's
        failure doesn't abandon other keys' work."""
        prev: list = []
        launched_all: list = []

        def fetch(launched_rounds: list) -> None:
            for launched in launched_rounds:
                try:
                    self._finish(launched)
                except BaseException:
                    pass  # every slot of the batch carries the error
        try:
            while True:
                with self._lock:
                    if not self._pending or (own is not None and own.event.is_set()):
                        self._dispatching = False
                        break
                    work = self._pending
                    self._pending = {}
                launched_all = []
                for mat, batch in work.values():
                    try:
                        launched_all.append(self._launch(batch, mat))
                    except BaseException:
                        pass  # every slot of the batch carries the error
                fetch(prev)
                prev = launched_all
            # the final round's results are fetched after the dispatcher
            # flag clears; a new leader draining fresh arrivals touches
            # different slots, so the concurrent _finish is safe
            fetch(prev)
        except BaseException:
            # never leave the scorer wedged, and never leave launched
            # rounds unfetched (their waiters would block forever);
            # _finish is idempotent per slot
            with self._lock:
                self._dispatching = False
            fetch(prev)
            if launched_all is not prev:
                fetch(launched_all)
            raise

    def _launch(self, batch: list[_Slot], mat) -> list[tuple[list[_Slot], object]]:
        """Launch kernels for every chunk of ``batch`` asynchronously;
        returns [(chunk, device_scores)] for _finish to fetch. On error,
        fails EVERY not-yet-finished slot of the batch: a waiter must
        never be left blocked."""
        launched: list[tuple[list[_Slot], object]] = []
        try:
            self.dispatches += 1
            metrics.count(metrics.BATCHER_DISPATCHES)
            metrics.observe(metrics.BATCHER_BATCH_SIZE, len(batch))
            if len(batch) == 1:
                launched.append(
                    (batch, _trim_device(self._single_fn(batch[0].src, mat), rows=batch[0].trim))
                )
                return launched
            for start in range(0, len(batch), self.max_batch):
                chunk = batch[start : start + self.max_batch]
                self.batched_queries += len(chunk)
                # pad Q to a power of two, as the JAX package does; a
                # zero source scores 0 everywhere and is sliced off
                q = _next_pow2(len(chunk))
                srcs = [s.src for s in chunk]
                if q > len(chunk):
                    if self._pad_fn is not None:
                        srcs = srcs + [self._pad_fn(srcs[0])] * (q - len(chunk))
                    else:
                        proto = srcs[0]
                        zkey = (tuple(proto.shape), proto.dtype, proto.device)
                        zero = self._pad_zeros.get(zkey)
                        if zero is None:
                            zero = self._pad_zeros[zkey] = torch.zeros_like(proto)
                        srcs = srcs + [zero] * (q - len(chunk))
                dev = self._batch_fn(srcs, mat)
                # pad query lanes never reach the host, and when every
                # slot declared its read width the score columns trim
                # device-side too
                trims = [s.trim for s in chunk]
                keep = max(trims) if all(t is not None for t in trims) else None
                launched.append((chunk, _trim_device(dev, rows=len(chunk), cols=keep)))
            return launched
        except BaseException as e:
            for s in batch:
                if not s.event.is_set():
                    s.error = e
                    s.event.set()
            raise

    def _finish(self, launched: list[tuple[list[_Slot], object]]) -> None:
        """Fetch launched device results and wake the coalesced slots.
        Runs outside the dispatch lock so fetches pipeline with the next
        batch's launch."""
        try:
            for chunk, dev_scores in launched:
                scores = _to_host(dev_scores)
                if len(chunk) == 1 and scores.ndim == 1:
                    chunk[0].result = scores
                    chunk[0].event.set()
                    continue
                for i, s in enumerate(chunk):
                    s.result = scores[i]
                    s.event.set()
        except BaseException as e:
            # every coalesced peer must see the real error, not None
            for chunk, _ in launched:
                for s in chunk:
                    if not s.event.is_set():
                        s.error = e
                        s.event.set()
            raise
