"""Device health gate: graceful GPU -> CPU degradation.

The port of ``pilosa_tpu/executor/devicehealth.py``. An accelerator can
wedge mid-serving (a hung CUDA call blocks in C and never returns, or
a device-side fault leaves the CUDA context dead). The reference has no analog — its
compute is the serving process — but here every query would otherwise
hang behind a dead device even though the executor carries a complete
CPU roaring path for every call. This gate makes device loss a latency
event instead of an outage:

* read calls run on a guard pool with a deadline measured from the
  moment the call STARTS (queue wait is accounted separately, so a
  busy pool can't fake a dead device);
* a call that blows its deadline does NOT immediately condemn the
  device: the gate first probes it directly. A healthy probe means the
  call was merely slow — the deadline extends and the call keeps
  running. Only a probe that fails or hangs trips the gate;
* while tripped, reads skip the device entirely (the executor's
  device predicates consult ``healthy``, which every thread sees — no
  per-thread state to propagate through map-reduce pools);
* a background probe loop restores the gate when the device answers,
  and fires ``on_restore`` so the owner can replace locks/pools that
  abandoned workers may hold forever (a blocked C call cannot be
  cancelled from Python; the leak is bounded by in-flight calls at the
  moment of the wedge).

The same SUSPECT/DOWN philosophy as node liveness (parallel/cluster.py)
applied to the accelerator itself.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import (
    CancelledError,
    ThreadPoolExecutor,
    TimeoutError as FutureTimeout,
)
from typing import Callable, Optional

import torch

from pilosa_tpu_torch.utils import metrics


class DeviceDown(Exception):
    """Raised to the caller when the device is gated off or a guarded
    call exceeded its deadline; callers fall back to the CPU path."""


def device_probe(device) -> Callable[[], None]:
    """The default probe for ``device``: one tiny round trip (an
    allocation, a kernel, a copy back). It runs on the device it is
    given and never picks one itself; after a sticky CUDA error (an
    illegal address, a launch failure) the context is dead and the
    round trip raises, so the gate stays tripped."""
    dev = torch.device(device)

    def probe() -> None:
        torch.ones(8, dtype=torch.int32, device=dev).add_(1).cpu()

    return probe


class DeviceHealth:
    def __init__(
        self,
        timeout_s: float = 120.0,
        admission_timeout_s: float = 5.0,
        probe_interval_s: float = 15.0,
        probe_timeout_s: float = 20.0,
        probe_fn: Optional[Callable[[], None]] = None,
        max_workers: int = 32,
        on_restore: Optional[Callable[[], None]] = None,
        logger=None,
        device=None,
    ) -> None:
        if probe_fn is None:
            if device is None:
                raise ValueError(
                    "DeviceHealth needs the device to probe (device=) or a probe_fn"
                )
            probe_fn = device_probe(device)
        self.timeout_s = timeout_s
        self.admission_timeout_s = admission_timeout_s
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self._probe_fn = probe_fn
        self._max_workers = max_workers
        self.on_restore = on_restore
        self._logger = logger  # printf-style, like utils/logger.py
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._healthy = True
        self._probing = False
        # telemetry (read by stats/tests)
        self.trips = 0
        self.restores = 0
        self.slow_calls = 0  # deadline passed but the probe cleared the device
        self.saturations = 0  # guard pool full at submit deadline
        self.restore_failures = 0  # on_restore raised; restore retried

    @property
    def healthy(self) -> bool:
        return self._healthy

    def _probe_once(self) -> bool:
        """Run the probe on a side thread with its own deadline; a
        hung probe is abandoned and counts as failure."""
        ok = threading.Event()

        def attempt():
            try:
                self._probe_fn()
                ok.set()
            except Exception:
                pass

        threading.Thread(target=attempt, daemon=True).start()
        return ok.wait(timeout=self.probe_timeout_s)

    def guard(self, fn: Callable, timeout_s: Optional[float] = None):
        """Run ``fn`` under the deadline. Returns its result, or raises
        DeviceDown when the gate is closed or the device is judged
        dead. A slow-but-alive device (deadline passed, probe answers)
        extends the deadline instead of tripping — a long pure-CPU
        stretch inside the call can never condemn a healthy device."""
        if not self._healthy:
            raise DeviceDown("device gated off")
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._max_workers,
                    thread_name_prefix="device-guard",
                )
            pool = self._pool
        timeout = timeout_s or self.timeout_s
        started = threading.Event()

        def run():
            started.set()
            return fn()

        try:
            fut = pool.submit(run)
        except RuntimeError as e:  # pool shut down under us (close())
            raise DeviceDown(str(e))
        # a concurrent _trip may cancel us while queued — wake the
        # started wait immediately instead of sleeping out the deadline
        fut.add_done_callback(lambda f: started.set())
        # queue wait is not runtime — and it gets its OWN, much shorter
        # deadline: a pool that can't ADMIT work within a few seconds is
        # either saturated with hung workers (dead device) or carrying a
        # burst of slow-but-healthy reads. Waiting the full call timeout
        # here would put a 2-minute latency cliff in front of every read
        # during a burst; the probe distinguishes the two cases cheaply:
        # only a failed probe condemns the device, a healthy one degrades
        # just this call to CPU.
        if not started.wait(timeout=min(timeout, self.admission_timeout_s)):
            fut.cancel()
            self.saturations += 1
            metrics.count(metrics.DEVICEHEALTH_SATURATIONS)
            if self._probe_once():
                raise DeviceDown("guard pool saturated (device alive)")
            self._trip("guard pool saturated and probe failed")
            raise DeviceDown("guard pool saturated")
        if fut.cancelled():
            raise DeviceDown("guard pool shut down mid-queue")
        while True:
            try:
                return fut.result(timeout=timeout)
            except CancelledError:
                raise DeviceDown("guard pool shut down mid-queue")
            except FutureTimeout:
                if self._probe_once():
                    # device answers: the call is slow, not stuck —
                    # extend and keep waiting
                    self.slow_calls += 1
                    metrics.count(metrics.DEVICEHEALTH_SLOW_CALLS)
                    continue
                self._trip("device probe failed after call deadline")
                raise DeviceDown("device call timed out and probe failed")

    def trip(self, reason: str) -> None:
        """Gate the device off from outside the guard path. Used by the
        OOM-recovery layer (executor/hbm.py) when allocation failures
        REPEAT after eviction + retry — a single recovered OOM never
        closes the gate, a pattern of them does."""
        self._trip(reason)

    def _log(self, fmt: str, *args) -> None:
        if self._logger is not None:
            try:
                self._logger.printf(fmt, *args)
            except Exception:
                pass

    def _trip(self, reason: str) -> None:
        with self._lock:
            if not self._healthy:
                return
            self._healthy = False
            self.trips += 1
            metrics.count(metrics.DEVICEHEALTH_TRIPS)
            pool, self._pool = self._pool, None
            if not self._probing:
                self._probing = True
                threading.Thread(
                    target=self._probe_loop, name="device-probe", daemon=True
                ).start()
        self._log("device health: gated off (%s)", reason)
        if pool is not None:
            # release the abandoned pool's IDLE workers (they'd block
            # on its queue forever otherwise — N flap cycles must not
            # leak N×max_workers threads); truly hung workers ignore
            # the shutdown, bounding the leak to them alone
            pool.shutdown(wait=False, cancel_futures=True)

    def _probe_loop(self) -> None:
        while True:
            time.sleep(self.probe_interval_s)
            with self._lock:
                if self._healthy:  # restored elsewhere / closed
                    self._probing = False
                    return
            if self._probe_once():
                # replace zombie-locked machinery BEFORE opening the
                # gate: a read passing the healthy check must never see
                # the old scorers/stager whose locks hung workers hold.
                # A failed callback abandons THIS restore attempt (the
                # loop retries) — opening the gate without the reset
                # would re-expose the zombie locks it exists to retire.
                cb = self.on_restore
                if cb is not None:
                    try:
                        cb()
                    except Exception as e:
                        # visible, not silent: a deterministic callback
                        # bug would otherwise keep a healthy device
                        # gated forever with no signal
                        self.restore_failures += 1
                        self._log(
                            "device health: restore callback failed "
                            "(attempt %d): %s", self.restore_failures, e
                        )
                        continue
                with self._lock:
                    self._healthy = True
                    self.restores += 1
                    self._probing = False
                metrics.count(metrics.DEVICEHEALTH_RESTORES)
                self._log("device health: restored (trip #%d)", self.trips)
                return
            # probe hung or failed: thread abandoned, loop again

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
            self._healthy = True  # stops a running probe loop
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
