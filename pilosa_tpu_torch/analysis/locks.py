"""Dynamic lock-order verification — the runtime half of the invariant
checker (see lint.py for the static half).

The serving stack is deeply concurrent: the dispatch engine, serving
pipeline, HBM stager, plan cache, and multihost gang lifecycle each
guard their state with a mutex, and several of those sections call into
each other (a pipeline worker executes through the executor, which
touches the stager and the plan cache; the gang leader loop touches the
pipeline's drain path). Nothing enforced an acquisition ORDER between
those locks — an AB/BA inversion would ship silently and deadlock only
under production interleavings.

``OrderedLock`` is a drop-in ``threading.Lock``/``RLock`` wrapper that
records, per thread, the stack of wrapped locks currently held. When a
thread acquires lock B while holding lock A it records the edge A→B in
a process-global lock graph; an edge that closes a cycle (B→…→A already
recorded) is a lock-order violation:

* under tests (``PYTEST_CURRENT_TEST`` in the environment) or with
  ``PILOSA_LOCK_STRICT=1`` the acquire raises ``LockOrderError``
  BEFORE blocking — the suite fails fast on the inversion instead of
  hanging until a timeout;
* in production the cycle is counted on the ``analysis.lock_cycles``
  gauge (and the edge set size on ``analysis.lock_graph_edges``) and
  execution proceeds — detection must never be the thing that takes
  the server down.

A same-thread re-acquire of a non-reentrant OrderedLock (a guaranteed
self-deadlock when blocking without a timeout) always raises — turning
an infinite hang into a stack trace is strictly better in every mode.

Edges are keyed by lock NAME, not object: names are lock *classes* in
the lockdep sense ("stager.mu", "pipeline.mu"), so the discipline holds
across instances. Same-name pairs are never recorded as edges (two
executors' stager locks nesting across instances is an ownership
question, not an ordering one).

Overhead: the hot path is one tuple-membership probe against an
immutable frozenset (GIL-safe to read without locking) plus a
thread-local list append/pop — the graph mutex is only taken when a
never-before-seen edge appears. Measured on the executor micro-bench
the instrumented build is within noise of bare ``threading.Lock``
(<5%, pinned by tests/test_analysis.py).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from pilosa_tpu_torch.utils import metrics


class LockOrderError(RuntimeError):
    """A lock acquisition that closes a cycle in the global lock graph
    (or re-enters a non-reentrant lock on the same thread)."""


_tls = threading.local()


def _held_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def strict_mode() -> bool:
    """Fail-fast on violations? Explicit ``PILOSA_LOCK_STRICT`` wins
    (``0`` disables even under pytest); otherwise strict exactly when a
    test is running."""
    v = os.environ.get("PILOSA_LOCK_STRICT")
    if v is not None:
        return v != "0"
    return "PYTEST_CURRENT_TEST" in os.environ


class LockGraph:
    """Process-global acquisition-order graph. ``edge a→b`` means some
    thread acquired b while holding a. Cycle detection runs only when a
    new edge appears; known-edge acquisitions stay on the lock-free
    fast path (``known`` is an immutable frozenset, atomically
    replaced)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._edges: dict[str, set[str]] = {}
        self.known: frozenset = frozenset()
        self._cycles: dict[tuple, int] = {}
        self._logged: set[tuple] = set()

    def observe(self, held: tuple, name: str) -> Optional[tuple]:
        """Record edges held[i]→name; return the canonical cycle tuple
        if any new edge closed one, else None."""
        new_cycle: Optional[tuple] = None
        with self._mu:
            for h in held:
                if h == name:
                    continue
                targets = self._edges.setdefault(h, set())
                if name in targets:
                    continue
                path = self._path(name, h)
                targets.add(name)
                if path is not None:
                    # the new h→name edge closes the name→…→h path
                    # (path already ends at h) into a cycle
                    cyc = _canon_cycle(tuple(path))
                    self._cycles[cyc] = self._cycles.get(cyc, 0) + 1
                    new_cycle = cyc
            self.known = frozenset(
                (a, b) for a, bs in self._edges.items() for b in bs
            )
            n_cycles = len(self._cycles)
            n_edges = len(self.known)
        metrics.gauge(metrics.ANALYSIS_LOCK_GRAPH_EDGES, n_edges)
        if new_cycle is not None:
            metrics.gauge(metrics.ANALYSIS_LOCK_CYCLES, n_cycles)
        return new_cycle

    def _path(self, src: str, dst: str) -> Optional[list]:
        """DFS path src→…→dst through recorded edges, or None. Caller
        holds ``_mu``."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def cycles(self) -> dict[tuple, int]:
        with self._mu:
            return dict(self._cycles)

    def edges(self) -> dict[str, set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def reset(self) -> None:
        """Test hook: forget everything (the global graph outlives any
        one test's lock topology)."""
        with self._mu:
            self._edges.clear()
            self.known = frozenset()
            self._cycles.clear()
            self._logged.clear()


GRAPH = LockGraph()


def _canon_cycle(nodes: tuple) -> tuple:
    """Rotation-invariant cycle key: rotate so the smallest name leads,
    so A→B→A and B→A→B count as ONE cycle."""
    i = nodes.index(min(nodes))
    return nodes[i:] + nodes[:i]


class OrderedLock:
    """``threading.Lock``/``RLock`` wrapper that feeds the global lock
    graph. Supports the full lock protocol plus the private trio
    (``_is_owned``/``_release_save``/``_acquire_restore``) so it slots
    into ``threading.Condition`` unchanged."""

    __slots__ = ("name", "reentrant", "_inner", "_graph")

    def __init__(
        self,
        name: str,
        reentrant: bool = False,
        graph: Optional[LockGraph] = None,
    ) -> None:
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._graph = graph if graph is not None else GRAPH

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held_stack()
        if held:
            self._check_order(held, blocking, timeout)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            held = _held_stack()
            held.append(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        if self.reentrant:
            # RLock has no locked() before 3.12; probe non-blocking
            if self._inner.acquire(blocking=False):
                self._inner.release()
                return False
            return True
        return self._inner.locked()

    # -- ordering ------------------------------------------------------------

    def _check_order(self, held: list, blocking: bool, timeout: float) -> None:
        graph = self._graph
        if not self.reentrant and any(x is self for x in held):
            if blocking and (timeout is None or timeout < 0):
                # guaranteed deadlock — raising beats hanging, always
                raise LockOrderError(
                    f"self-deadlock: {self.name!r} re-acquired on the "
                    "thread that already holds it"
                )
            return  # bounded acquire: let it time out naturally
        known = graph.known
        names = []
        for x in held:
            if x is self or x.name == self.name:
                continue
            if (x.name, self.name) not in known:
                names.append(x.name)
        if not names:
            return  # fast path: every edge already vetted
        cycle = graph.observe(tuple(dict.fromkeys(names)), self.name)
        if cycle is not None and strict_mode():
            raise LockOrderError(
                "lock-order cycle: "
                + " -> ".join(cycle + (cycle[0],))
                + f" (acquiring {self.name!r} while holding "
                + ", ".join(repr(n) for n in names)
                + ")"
            )

    # -- threading.Condition integration ------------------------------------

    def _is_owned(self) -> bool:
        if self.reentrant:
            return self._inner._is_owned()
        return any(x is self for x in _held_stack())

    def _release_save(self):
        held = _held_stack()
        n = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                n += 1
        if self.reentrant:
            return (self._inner._release_save(), n)
        self._inner.release()
        return (None, n)

    def _acquire_restore(self, state) -> None:
        inner_state, n = state
        if self.reentrant:
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        held = _held_stack()
        for _ in range(max(1, n)):
            held.append(self)

    def __repr__(self) -> str:
        return f"<OrderedLock {self.name!r} reentrant={self.reentrant}>"


def held_locks() -> tuple:
    """Names of OrderedLocks held by the calling thread, outermost
    first (diagnostics / tests)."""
    return tuple(x.name for x in _held_stack())
