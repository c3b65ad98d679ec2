"""GC-cycle notification feeding a ``garbage_collection`` counter
(reference gcnotify/gcnotify.go:25-43, consumed at server.go:702-704).

The reference registers for Go GC finish events and bumps a stats
counter from the runtime monitor. CPython exposes the same signal via
``gc.callbacks``: each callback fires with phase "start"/"stop" around
every collection, so we count "stop" events.
"""

from __future__ import annotations

import gc
import threading


class GCNotifier:
    """Counts completed garbage-collection cycles.

    ``close()`` unregisters the callback; instances are independent so a
    server owns one for its lifetime (the reference's AfterGC channel is
    likewise per-server).
    """

    def __init__(self) -> None:
        self._count = 0
        self._mu = threading.Lock()
        self._closed = False
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "stop":
            with self._mu:
                self._count += 1

    def poll(self) -> int:
        """Return the number of GC cycles since the last poll."""
        with self._mu:
            n = self._count
            self._count = 0
        return n

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            gc.callbacks.remove(self._on_gc)
        except ValueError:
            pass
