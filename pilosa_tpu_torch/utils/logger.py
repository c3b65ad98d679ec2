"""Logger interface (reference logger.go): printf/debugf with nop,
standard, and verbose implementations.

Log correlation: when a span is active or a gang context has
been installed (``set_context_provider``), every StandardLogger record
gains structured ``trace=<id> gang=<g> rank=<r> epoch=<e>`` fields, so
a log line joins its distributed trace and its gang incarnation without
grep archaeology across per-process files.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional

# process-global context provider: returns {"gang":…, "rank":…,
# "epoch":…} (or {}) at emit time — a callable because the epoch moves
# on every re-formation. Installed once by the server at boot.
_context_provider: Optional[Callable[[], dict]] = None


def set_context_provider(fn: Optional[Callable[[], dict]]) -> None:
    global _context_provider
    _context_provider = fn


def _correlation_suffix() -> str:
    """`` [trace=… gang=… rank=… epoch=…]`` for the active span/gang
    context, or "" — never raises (logging must not fail the caller)."""
    parts = []
    try:
        from pilosa_tpu_torch.utils import trace

        ctx = trace.current_ctx()
        if ctx is not None:
            parts.append(f"trace={ctx[0]}")
        wave = trace.current_wave()
        if wave:
            parts.append(f"wave={wave}")
        if _context_provider is not None:
            for k, v in (_context_provider() or {}).items():
                parts.append(f"{k}={v}")
    except Exception:
        return ""
    return (" [" + " ".join(parts) + "]") if parts else ""


class NopLogger:
    def printf(self, fmt: str, *args) -> None:
        pass

    def debugf(self, fmt: str, *args) -> None:
        pass


class StandardLogger:
    def __init__(self, stream=None, verbose: bool = False) -> None:
        self.stream = stream or sys.stderr
        self.verbose = verbose

    def _emit(self, fmt: str, *args) -> None:
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        try:
            msg = (fmt % args) if args else fmt
        except TypeError:
            msg = " ".join([fmt] + [str(a) for a in args])
        self.stream.write(f"{ts} {msg}{_correlation_suffix()}\n")
        self.stream.flush()

    def printf(self, fmt: str, *args) -> None:
        self._emit(fmt, *args)

    def debugf(self, fmt: str, *args) -> None:
        if self.verbose:
            self._emit(fmt, *args)


NOP_LOGGER = NopLogger()
