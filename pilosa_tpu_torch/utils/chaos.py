"""Device fault injection and the cross-layer chaos schedule.

The port of ``pilosa_tpu/utils/chaos.py``. ``DeviceFaultSpec`` makes the
card fail on demand at the executor's device-call boundaries, with the
same deterministic no-RNG contract as ``StorageFaultSpec``
(core/fragment.py): every injection point keeps a call counter, knobs
select every-Nth calls, and injected faults journal ``device.fault`` —
so a failing chaos run replays exactly. An injected allocation failure
carries ``RESOURCE_EXHAUSTED``, which ``executor/hbm.py``'s
``classify_device_error`` reads as ``"alloc"``: the recovery under test
is the production one.

The hooks sit where the reference has them: ``on_kernel`` inside the
attempt that ``OomRecovery`` retries (``executor._timed_kernel`` and the
fused launch), ``on_lowering`` where the fuser builds a new program.

``ChaosSchedule`` composes the fault families — storage
(``PILOSA_TPU_STORAGE_FAULTS``), distributed (``PILOSA_TPU_MH_FAULTS``)
and device (``PILOSA_TPU_DEVICE_FAULTS``) — into a seeded sequence of
fault WINDOWS: each window installs one family's spec, runs mixed load
under it, clears it, and verifies recovery before the next one opens.

Stdlib-only on purpose, as the reference: nothing here imports torch.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Optional

from pilosa_tpu_torch.utils import events, metrics

DEVICE_FAULTS_ENV = "PILOSA_TPU_DEVICE_FAULTS"


class InjectedDeviceOom(RuntimeError):
    """Injected allocation failure. The message carries
    RESOURCE_EXHAUSTED so executor/hbm.py classifies it exactly like a
    real allocation failure — the recovery path under test is the
    production one, not a parallel test-only branch."""


class InjectedPoisonError(RuntimeError):
    """Injected lowering failure (a 'poisoned' fused program): the
    fused path must degrade to the classic per-call path,
    bit-identically."""


class DeviceFaultSpec:
    """Deterministic fault schedule for the device-call boundaries,
    parsed from the ``device-faults`` config knob (or
    ``PILOSA_TPU_DEVICE_FAULTS``): ``oom_every=N`` raises an injected
    RESOURCE_EXHAUSTED on every Nth kernel launch, ``stall_every=N``
    sleeps ``stall_s`` seconds before every Nth launch (a stalled
    transfer — exercises the health gate's slow-call probe, never a
    wrong answer), ``poison_every=N`` fails every Nth fused-program
    lowering, and ``after=K`` arms the schedule only after the first K
    launches (lets a soak warm up clean). No RNG — a failing chaos run
    reproduces exactly. Injected faults journal ``device.fault``."""

    __slots__ = (
        "oom_every",
        "stall_every",
        "stall_s",
        "poison_every",
        "after",
        "injected",
        "_kernels",
        "_lowerings",
        "_mu",
    )

    def __init__(
        self,
        oom_every: int = 0,
        stall_every: int = 0,
        stall_s: float = 0.05,
        poison_every: int = 0,
        after: int = 0,
    ) -> None:
        self.oom_every = oom_every
        self.stall_every = stall_every
        self.stall_s = stall_s
        self.poison_every = poison_every
        self.after = after
        self.injected = 0
        self._kernels = 0
        self._lowerings = 0
        self._mu = threading.Lock()

    @classmethod
    def parse(cls, text: str) -> "DeviceFaultSpec":
        spec = cls()
        for part in (text or "").split(","):
            part = part.strip()
            if not part:
                continue
            key, _, value = part.partition("=")
            key = key.strip()
            if key in ("oom_every", "stall_every", "poison_every", "after"):
                setattr(spec, key, int(value))
            elif key == "stall_s":
                spec.stall_s = float(value)
            else:
                raise ValueError(f"unknown device fault knob: {key!r}")
        return spec

    def __bool__(self) -> bool:
        return bool(self.oom_every or self.stall_every or self.poison_every)

    def _injected(self, fault: str) -> None:
        with self._mu:
            self.injected += 1
        metrics.count(metrics.DEVICE_FAULTS_INJECTED, fault=fault)
        events.record(events.DEVICE_FAULT, fault=fault)

    def on_kernel(self, kind: str) -> None:
        """Fault hook at a kernel-launch boundary (executor
        ``_timed_kernel``). Fires INSIDE the attempted call, so the
        OOM-recovery retry re-consults the counter — with
        ``oom_every=N>1`` the retry passes (recovery proven), with
        ``oom_every=1`` every retry fails too (degrade proven)."""
        with self._mu:
            self._kernels += 1
            n = self._kernels - self.after
        if n <= 0:
            return
        if self.stall_every and n % self.stall_every == 0:
            self._injected("stall")
            time.sleep(self.stall_s)
        if self.oom_every and n % self.oom_every == 0:
            self._injected("oom")
            raise InjectedDeviceOom(
                f"RESOURCE_EXHAUSTED: injected device OOM "
                f"(launch {n}, kind={kind})"
            )

    def on_lowering(self) -> None:
        """Fault hook at the fused-query lowering boundary
        (executor/fusion.py)."""
        with self._mu:
            self._lowerings += 1
            n = self._lowerings - self.after
        if n <= 0:
            return
        if self.poison_every and n % self.poison_every == 0:
            self._injected("poison_jit")
            raise InjectedPoisonError(
                f"injected poisoned jit (lowering {n})"
            )


# Process-wide injected fault schedule (None = clean). Installed by the
# server from the `device-faults` config knob; tests install directly.
FAULTS: Optional[DeviceFaultSpec] = None


def install_device_faults(text: str = "") -> None:
    """Parse and install the process-wide device fault schedule; an
    empty spec (or empty text) clears it."""
    global FAULTS
    text = text or os.environ.get(DEVICE_FAULTS_ENV, "")
    spec = DeviceFaultSpec.parse(text)
    FAULTS = spec if spec else None


# -- the chaos schedule -------------------------------------------------------


class ChaosSchedule:
    """Seeded sequence of fault windows over the three injector
    families. Deterministic from ``seed``: the same seed yields the
    same windows in the same order with the same knobs, so a soak
    failure reproduces from its recorded seed alone.

    Each window is a dict the harness applies verbatim:

    - ``name``: window label for the artifact/journal
    - ``storage`` / ``device`` / ``distributed``: fault-spec strings
      (empty = that family clean this window)
    - ``duration_s``: how long mixed load runs under the window
    """

    FAMILIES = ("storage", "device", "mixed", "bitrot")

    def __init__(
        self, seed: int, windows: int = 4, duration_s: float = 3.0
    ) -> None:
        self.seed = int(seed)
        rng = random.Random(self.seed)
        self.windows: list[dict] = []
        for i in range(int(windows)):
            family = self.FAMILIES[i % len(self.FAMILIES)]
            w = {
                "name": f"w{i}-{family}",
                "storage": "",
                "device": "",
                "distributed": "",
                "duration_s": float(duration_s),
            }
            if family in ("storage", "mixed"):
                w["storage"] = f"fsync_fail_every={rng.randint(2, 5)}"
            if family in ("device", "mixed"):
                w["device"] = f"oom_every={rng.randint(2, 6)}"
            if family == "bitrot":
                # every Nth integrity verification flips a byte of the
                # snapshot base on disk before checking — the scrub /
                # open-time digest pass must detect it
                w["storage"] = f"bitrot={rng.randint(1, 3)}"
            self.windows.append(w)

    def __iter__(self):
        return iter(self.windows)
