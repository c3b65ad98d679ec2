"""The device health gate of both packages: a wedged device degrades
reads to the CPU path (bit-identically) instead of hanging them, and a
succeeding probe restores the device path. The cases of
``tests/test_devicehealth.py`` run on ``pilosa_tpu`` and on
``pilosa_tpu_torch`` (``device="cpu"``); then the port's own: its probe
is a round trip on the device it is given, a failing probe trips the
gate with every read it serves on the CPU counted, only a serving
executor falls back (a bare one, the port's launch failures and a
degraded call under ``always`` raise), and a staged view held across a
guarded read and a write keeps its words."""

import importlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

SHARD_WIDTH = 1 << 20


def _failing_probe():
    raise RuntimeError("device wedged")


@pytest.fixture(params=["pilosa_tpu", "pilosa_tpu_torch"])
def P(request):
    name = request.param
    core = importlib.import_module(f"{name}.core")
    exmod = importlib.import_module(f"{name}.executor.executor")
    dh = importlib.import_module(f"{name}.executor.devicehealth")
    stager = importlib.import_module(f"{name}.executor.stager")
    metrics = importlib.import_module(f"{name}.utils.metrics")
    port = name == "pilosa_tpu_torch"
    extra = {"device": "cpu"} if port else {}
    return SimpleNamespace(
        Holder=core.Holder,
        exmod=exmod,
        Executor=lambda h, **kw: exmod.Executor(h, **extra, **kw),
        DeviceHealth=dh.DeviceHealth,
        DeviceDown=dh.DeviceDown,
        DeviceStager=(lambda: stager.DeviceStager("cpu")) if port else stager.DeviceStager,
        metrics=metrics,
        port=port,
    )


def _holder(P, tmp_path):
    h = P.Holder(str(tmp_path / "d"))
    h.open()
    fld = h.create_index("i").create_field("f")
    rng = np.random.default_rng(5)
    rows, cols = [], []
    for shard in range(2):
        base = shard * SHARD_WIDTH
        for r in range(10):
            k = 200 + 30 * r
            rows += [r] * k
            cols += (base + rng.integers(0, SHARD_WIDTH, size=k)).tolist()
    fld.import_bits(rows, cols)
    return h


class TestDeviceHealthUnit:
    def test_guard_runs_and_times_out(self, P):
        hlth = P.DeviceHealth(timeout_s=0.2, probe_interval_s=3600, probe_timeout_s=0.1, probe_fn=_failing_probe)
        assert hlth.guard(lambda: 41 + 1) == 42
        with pytest.raises(P.DeviceDown):
            hlth.guard(lambda: time.sleep(2))
        assert not hlth.healthy
        assert hlth.trips == 1
        t0 = time.monotonic()
        with pytest.raises(P.DeviceDown):
            hlth.guard(lambda: 1)
        assert time.monotonic() - t0 < 0.1
        hlth.close()

    def test_slow_call_with_live_device_does_not_trip(self, P):
        hlth = P.DeviceHealth(timeout_s=0.15, probe_interval_s=3600, probe_timeout_s=1.0, probe_fn=lambda: None)
        assert hlth.guard(lambda: (time.sleep(0.5), 99)[1]) == 99
        assert hlth.healthy
        assert hlth.trips == 0
        assert hlth.slow_calls >= 1
        hlth.close()

    def test_saturated_pool_with_live_device_degrades_without_trip(self, P):
        hlth = P.DeviceHealth(
            timeout_s=0.2, probe_interval_s=3600, probe_timeout_s=1.0, probe_fn=lambda: None, max_workers=1
        )
        release = threading.Event()
        with ThreadPoolExecutor(max_workers=1) as tp:
            occupier = tp.submit(lambda: hlth.guard(release.wait))
            time.sleep(0.05)
            with pytest.raises(P.DeviceDown):
                hlth.guard(lambda: 1)
            assert hlth.healthy
            assert hlth.trips == 0
            release.set()
            occupier.result(timeout=5)
        hlth.close()

    def test_stager_epoch_blocks_zombie_reinsert(self, P):
        st = P.DeviceStager()
        entered = threading.Event()
        proceed = threading.Event()

        def slow_build():
            entered.set()
            proceed.wait(timeout=10)
            return ("stale-handle", 8, 0)

        out = {}
        t = threading.Thread(target=lambda: out.update(v=st._get_or_build(("k",), 0, slow_build)))
        t.start()
        entered.wait(timeout=5)
        st.reset_after_wedge()
        proceed.set()
        t.join(timeout=5)
        assert out["v"] == "stale-handle"
        assert st._get_or_build(("k",), 0, lambda: ("fresh", 8, 0)) == "fresh"

    def test_probe_restores(self, P):
        hlth = P.DeviceHealth(timeout_s=0.2, probe_interval_s=0.05, probe_timeout_s=1.0, probe_fn=lambda: None)
        hlth._trip("test wedge")
        assert not hlth.healthy
        deadline = time.monotonic() + 5
        while not hlth.healthy and time.monotonic() < deadline:
            time.sleep(0.02)
        assert hlth.healthy
        assert hlth.restores == 1
        assert hlth.guard(lambda: 7) == 7
        hlth.close()


class TestExecutorDegradation:
    def test_wedged_kernel_falls_back_to_cpu(self, P, tmp_path, monkeypatch):
        h = _holder(P, tmp_path)
        cpu = P.Executor(h, device_policy="never")
        hlth = P.DeviceHealth(timeout_s=0.5, probe_interval_s=3600, probe_timeout_s=0.1, probe_fn=_failing_probe)
        dev = P.Executor(h, device_policy="always", health=hlth)
        q = "TopN(f, Row(f=3), n=5)"
        want = cpu.execute("i", q)
        assert dev.execute("i", q) == want

        def hang(*a, **kw):
            time.sleep(5)  # the reference test's 30 s, cut: interpreter exit joins it

        monkeypatch.setattr(P.exmod.ops, "sparse_intersection_counts_stacked", hang)
        monkeypatch.setattr(P.exmod.ops, "sparse_intersection_counts", hang)
        before = P.metrics.snapshot().get(P.metrics.EXECUTOR_DEVICE_DOWN_FALLBACK, 0)
        t0 = time.monotonic()
        got = dev.execute("i", q)
        assert got == want
        assert time.monotonic() - t0 < 3
        assert hlth.trips == 1 and not hlth.healthy
        if P.port:
            # the port counts the call it re-ran on the CPU leg
            assert P.metrics.snapshot().get(P.metrics.EXECUTOR_DEVICE_DOWN_FALLBACK, 0) > before
        t0 = time.monotonic()
        assert dev.execute("i", "Count(Row(f=3))") == cpu.execute("i", "Count(Row(f=3))")
        assert time.monotonic() - t0 < 2
        assert dev.execute("i", "Set(999999, f=3)") == [True]
        dev.close()
        h.close()

    def test_recovery_restores_device_path(self, P, tmp_path):
        h = _holder(P, tmp_path)
        hlth = P.DeviceHealth(timeout_s=0.5, probe_interval_s=0.05, probe_timeout_s=1.0, probe_fn=lambda: None)
        dev = P.Executor(h, device_policy="always", health=hlth)
        cpu = P.Executor(h, device_policy="never")
        q = "Count(Intersect(Row(f=1), Row(f=2)))"
        want = cpu.execute("i", q)
        old_scorer = dev.scorer
        old_stacked = dev.stacked_scorer
        hlth._trip("test wedge")
        assert dev.execute("i", q) == want
        deadline = time.monotonic() + 5
        while not hlth.healthy and time.monotonic() < deadline:
            time.sleep(0.02)
        assert hlth.healthy
        assert dev.scorer is not old_scorer
        assert dev.stacked_scorer is not old_stacked
        assert dev.execute("i", q) == want
        dev.close()
        h.close()


# -- the port's own ------------------------------------------------------------


def test_probe_is_a_round_trip_on_the_given_device():
    from pilosa_tpu_torch.executor.devicehealth import DeviceHealth, device_probe

    device_probe("cpu")()  # answers
    with pytest.raises(ValueError, match="device"):
        DeviceHealth()  # never picks a device by itself
    calls = []
    real_ones = torch.ones

    def spy(*a, **kw):
        calls.append(kw.get("device"))
        return real_ones(*a, **kw)

    hlth = DeviceHealth(device="cpu", probe_timeout_s=5)
    torch.ones = spy
    try:
        assert hlth._probe_once()
    finally:
        torch.ones = real_ones
        hlth.close()
    assert calls == [torch.device("cpu")]


def test_dead_context_keeps_the_gate_tripped(tmp_path):
    """A probe that raises (a CUDA context lost to a sticky error): the
    gate trips, stays tripped, and every read runs on the CPU leg."""
    from pilosa_tpu_torch import Executor
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor.devicehealth import DeviceHealth
    from pilosa_tpu_torch.utils import metrics

    h = Holder(str(tmp_path / "d"))
    h.open()
    h.create_index("i").create_field("f").import_bits([1, 1, 2], [3, SHARD_WIDTH + 4, 5])

    def sticky():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    hlth = DeviceHealth(timeout_s=0.2, probe_interval_s=0.02, probe_timeout_s=0.5, probe_fn=sticky)
    dev = Executor(h, device="cpu", device_policy="always", health=hlth)
    try:
        routed = metrics.snapshot().get(f"{metrics.EXECUTOR_ROUTE_DEVICE};call:Count", 0)
        # the call hangs past its deadline; the probe fails: trip
        with pytest.raises(Exception):
            hlth.guard(lambda: time.sleep(1))
        assert not hlth.healthy
        before = metrics.snapshot().get(metrics.EXECUTOR_DEVICE_DOWN_FALLBACK, 0)
        assert dev.execute("i", "Count(Row(f=1))") == [2]
        time.sleep(0.2)  # several probe rounds: none restores
        assert not hlth.healthy and hlth.restores == 0
        assert dev.execute("i", "Count(Row(f=1))") == [2]
        # reads ran on the CPU leg, none on the device
        assert metrics.snapshot().get(f"{metrics.EXECUTOR_ROUTE_DEVICE};call:Count", 0) == routed
        # and each was counted as a fallback, as /status reports them
        assert metrics.snapshot().get(metrics.EXECUTOR_DEVICE_DOWN_FALLBACK, 0) == before + 2
    finally:
        dev.close()
        hlth.close()
        h.close()


def test_staged_view_held_across_a_guarded_read_and_a_write(tmp_path):
    """A reader's view of a staged entry keeps its words while a guarded
    read on the guard pool and a write refresh the entry: the refresh
    patches a copy, not the held words."""
    from pilosa_tpu_torch import Executor
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor.devicehealth import DeviceHealth

    h = Holder(str(tmp_path / "d"))
    h.open()
    f = h.create_index("i").create_field("f")
    f.import_bits([1] * 50, list(range(0, 5000, 100)))
    hlth = DeviceHealth(device="cpu", timeout_s=30)
    dev = Executor(h, device="cpu", device_policy="always", health=hlth)
    try:
        assert dev.execute("i", "Count(Row(f=1))") == [50]
        frag = h.fragment("i", "f", "standard", 0)
        held = dev.stager.row(frag, 1).view(-1)
        before = held.clone()
        dev.execute("i", "Set(7, f=1)")
        assert dev.execute("i", "Count(Row(f=1))") == [51]
        assert torch.equal(held, before)
        assert dev.stager.delta_routes["copied"] >= 1
        fresh = dev.stager.row(frag, 1)
        assert int(fresh.view(-1)[0]) & (1 << 7)
    finally:
        dev.close()
        hlth.close()
        h.close()


# -- where the fallback applies ------------------------------------------------


def _port_holder(tmp_path):
    from pilosa_tpu_torch.core import Holder

    h = Holder(str(tmp_path / "d"))
    h.open()
    f = h.create_index("i").create_field("f")
    f.import_bits([1, 1, 2, 2, 2], [3, SHARD_WIDTH + 4, 3, 5, SHARD_WIDTH + 4])
    return h


_CHAIN = "Count(Intersect(Row(f=1), Row(f=2)))"


def _tree_count_raising(monkeypatch, exc):
    from pilosa_tpu_torch.executor import executor as exmod

    def boom(*a, **kw):
        raise exc

    # the executor binds its tree-count wrapper at construction
    monkeypatch.setattr(exmod.ops, "tree_count", boom)


def _fallbacks():
    from pilosa_tpu_torch.utils import metrics

    return metrics.snapshot().get(metrics.EXECUTOR_DEVICE_DOWN_FALLBACK, 0)


@pytest.mark.parametrize(
    "exc",
    [
        RuntimeError("CUDA error: an illegal memory access was encountered"),
        torch.cuda.OutOfMemoryError("CUDA out of memory"),
    ],
    ids=["wedge", "alloc"],
)
def test_bare_executor_lets_device_errors_through(tmp_path, monkeypatch, exc):
    """No health gate, no fallback: the caller sees the device error and
    the next read still goes to the device."""
    from pilosa_tpu_torch import Executor
    from pilosa_tpu_torch.executor.hbm import DeviceOom

    h = _port_holder(tmp_path)
    _tree_count_raising(monkeypatch, exc)
    ex = Executor(h, device="cpu", device_policy="always")
    try:
        before = _fallbacks()
        with pytest.raises(DeviceOom) as ei:
            ex.execute("i", _CHAIN)
        assert ei.value.__cause__ is exc
        assert _fallbacks() == before and not ex._cpu_forced()
        with pytest.raises(DeviceOom):  # on the device again
            ex.execute("i", _CHAIN)
        assert ex._oom.stats()["ooms"] == 2
    finally:
        ex.close()
        h.close()


def test_launch_error_is_not_a_device_fault(tmp_path, monkeypatch):
    """A kernel of the port's that refuses its launch reaches the caller
    of a serving executor: no degrade, no trip, no CPU answer."""
    from pilosa_tpu_torch import Executor
    from pilosa_tpu_torch.executor.devicehealth import DeviceHealth
    from pilosa_tpu_torch.ops.cuda import LaunchError

    h = _port_holder(tmp_path)
    _tree_count_raising(monkeypatch, LaunchError("tree_count: CUDA error 9 at launch"))
    hlth = DeviceHealth(device="cpu", timeout_s=30)
    ex = Executor(h, device="cpu", device_policy="auto", auto_min_containers=0, health=hlth)
    try:
        before = _fallbacks()
        with pytest.raises(LaunchError):
            ex.execute("i", _CHAIN)
        assert ex._oom.stats()["ooms"] == 0 and hlth.trips == 0 and hlth.healthy
        assert _fallbacks() == before and not ex._cpu_forced()
    finally:
        ex.close()
        hlth.close()
        h.close()


def test_oom_degrade_moves_auto_reads_to_cpu_but_not_always(tmp_path, monkeypatch):
    """An unrecovered OOM under ``auto``: the call and the reads of the
    cooldown are served on the CPU leg, each counted. Under ``always``
    the degraded call raises and the next read goes to the device."""
    from pilosa_tpu_torch import Executor
    from pilosa_tpu_torch.executor.devicehealth import DeviceHealth
    from pilosa_tpu_torch.executor.hbm import DeviceOom

    h = _port_holder(tmp_path)
    _tree_count_raising(monkeypatch, torch.cuda.OutOfMemoryError("CUDA out of memory"))
    hlth = DeviceHealth(device="cpu", timeout_s=30)
    auto = Executor(h, device="cpu", device_policy="auto", auto_min_containers=0, health=hlth)
    always = Executor(h, device="cpu", device_policy="always", health=hlth)
    try:
        before = _fallbacks()
        assert auto.execute("i", _CHAIN) == [2]
        assert auto._oom.stats()["degraded"] == 1 and auto._cpu_forced()
        assert auto.execute("i", _CHAIN) == [2]  # the cooldown: no launch
        assert auto._oom.stats()["ooms"] == 1
        assert _fallbacks() == before + 2
        with pytest.raises(DeviceOom):
            always.execute("i", _CHAIN)
        assert always._oom.stats()["degraded"] == 1 and not always._cpu_forced()
        assert _fallbacks() == before + 2
        assert hlth.trips == 0
    finally:
        auto.close()
        always.close()
        hlth.close()
        h.close()
