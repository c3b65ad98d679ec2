"""Request deadlines — the cancellation seam of the serving pipeline.

A deadline is set once at admission (from the ``X-Request-Deadline``
header, the ``timeout`` query parameter, or the server's configured
default) and propagates through ``API.query`` into ``Executor.execute``
and the per-shard map via a contextvar, the same pattern the span
tracer uses. Work is cancelled at STAGE BOUNDARIES — before the parse,
before the executor body, before each shard's map leg — rather than
preempted mid-kernel: an expired request stops consuming the worker
pool at the next check instead of computing a result nobody will read.

Like the tracer's span, the deadline does not follow work into thread
pools automatically; pool submitters capture ``current()`` and re-enter
it in the worker via ``activate(dl)``.

This module is deliberately self-contained (stdlib only): the executor
(L4) reaches up into it lazily, and a module-level import of anything
from the server package would recreate the server→executor import
cycle.
"""

from __future__ import annotations

import contextvars
import math
import time
from typing import Optional

_current: contextvars.ContextVar[Optional["Deadline"]] = contextvars.ContextVar(
    "pilosa_tpu_deadline", default=None
)


class DeadlineExceeded(Exception):
    """Raised at a stage boundary once the request's deadline passed.
    ``stage`` names where the work was cancelled (a trace-stage name);
    the HTTP layer maps this to 504."""

    def __init__(self, stage: str = "", message: str = "") -> None:
        self.stage = stage
        super().__init__(
            message or f"deadline exceeded at {stage or 'admission'}"
        )


class Deadline:
    """An absolute point on the monotonic clock. Immutable; cheap to
    check (one ``time.monotonic()`` compare per ``check``)."""

    __slots__ = ("at",)

    def __init__(self, at: float) -> None:
        self.at = at

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + seconds)

    def remaining(self) -> float:
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.at

    def check(self, stage: str) -> None:
        """Raise DeadlineExceeded if the deadline has passed. The
        per-stage cancellation point: call at the top of each unit of
        work, never inside one."""
        if time.monotonic() >= self.at:
            from pilosa_tpu_torch.utils import metrics

            metrics.count(metrics.PIPELINE_DEADLINE_EXPIRED, stage=stage)
            raise DeadlineExceeded(stage)


def current() -> Optional[Deadline]:
    """The active request deadline of this thread/context, or None."""
    return _current.get()


class _Activation:
    __slots__ = ("_dl", "_token")

    def __init__(self, dl: Optional[Deadline]) -> None:
        self._dl = dl
        self._token = None

    def __enter__(self) -> Optional[Deadline]:
        if self._dl is not None:
            self._token = _current.set(self._dl)
        return self._dl

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            _current.reset(self._token)
        return False


def activate(dl: Optional[Deadline]) -> _Activation:
    """Context manager installing ``dl`` as the current deadline
    (no-op for None) — used by pipeline workers and pool submitters to
    carry the deadline across threads."""
    return _Activation(dl)


def from_request(
    headers: dict, query: dict, default_timeout: float = 0.0
) -> Optional[Deadline]:
    """Deadline for one HTTP request, or None when unbounded.

    Precedence: ``timeout`` query parameter (relative seconds) >
    ``X-Request-Deadline`` header (absolute unix-epoch seconds, the
    convention proxies forward unchanged across hops) > the server's
    ``pipeline-default-timeout``. Malformed values raise ValueError —
    the HTTP layer maps that to 400; silently ignoring a typo'd
    deadline would run the request unbounded."""
    tq = query.get("timeout")
    if tq:
        try:
            seconds = float(tq[0])
        except (TypeError, ValueError):
            raise ValueError(f"invalid timeout parameter: {tq[0]!r}")
        if not math.isfinite(seconds) or seconds <= 0:
            raise ValueError(f"timeout must be a positive number: {tq[0]!r}")
        return Deadline.after(seconds)
    hd = headers.get("x-request-deadline", "")
    if hd:
        try:
            epoch = float(hd)
        except (TypeError, ValueError):
            raise ValueError(f"invalid X-Request-Deadline header: {hd!r}")
        if not math.isfinite(epoch):
            raise ValueError(f"invalid X-Request-Deadline header: {hd!r}")
        # translate wall-clock to this process's monotonic clock once,
        # at admission; an already-past deadline still admits and then
        # cancels at the first stage boundary (one consistent path)
        return Deadline.after(epoch - time.time())
    if default_timeout > 0:
        return Deadline.after(default_timeout)
    return None
