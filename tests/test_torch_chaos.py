"""Device fault injection in the port (``pilosa_tpu_torch/utils/chaos.py``).

The reference's ``TestDeviceFaultSpec`` and ``TestChaosSchedule``
(``tests/test_hbm.py``) run on the port; both packages' schedules and
injections are held to each other; the reference's
``TestDeviceFaultDegrade`` (``tests/test_fusion.py``) runs on the port's
executor (``device="cpu"``: the plain versions) with every answer ``==``
the ``pilosa_tpu`` executor's on the same data; and ``chip_smoke.py``'s
fault windows and profile capture run on the port's server on the CPU at
a small size.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from pilosa_tpu.utils import chaos as ref_chaos

from pilosa_tpu_torch.core import FieldOptions
from pilosa_tpu_torch.core.field import FIELD_TYPE_INT
from pilosa_tpu_torch.executor import Executor as _Executor
from pilosa_tpu_torch.executor.devicehealth import DeviceHealth
from pilosa_tpu_torch.executor.hbm import DeviceOom, classify_device_error
from pilosa_tpu_torch.utils import chaos, metrics
from pilosa_tpu_torch.utils.chaos import (
    ChaosSchedule,
    DeviceFaultSpec,
    InjectedDeviceOom,
    InjectedPoisonError,
    install_device_faults,
)
from test_torch_fusion import GAUNTLET, _Legs, _norm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def Executor(h, **kw):
    """The port's executor on the CPU (the device legs' plain versions)."""
    return _Executor(h, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    chaos.install_device_faults("")
    ref_chaos.install_device_faults("")


# -- the reference's cases (tests/test_hbm.py), on the port ------------------------


class TestDeviceFaultSpec:
    def test_parse_roundtrip_and_unknown_knob(self):
        s = DeviceFaultSpec.parse(
            "oom_every=3,stall_every=5,stall_s=0.01,poison_every=2,after=4"
        )
        assert (s.oom_every, s.stall_every, s.poison_every, s.after) == (3, 5, 2, 4)
        assert s.stall_s == 0.01 and bool(s)
        assert not DeviceFaultSpec.parse("")
        with pytest.raises(ValueError):
            # check: disable=fault-spec (deliberately invalid knob — the ValueError is the assertion)
            DeviceFaultSpec.parse("explode_every=1")

    def test_oom_every_nth_kernel_is_deterministic(self):
        s = DeviceFaultSpec.parse("oom_every=2")
        s.on_kernel("k")  # 1: clean
        with pytest.raises(InjectedDeviceOom) as ei:
            s.on_kernel("k")  # 2: injected
        assert classify_device_error(ei.value) == "alloc"
        s.on_kernel("k")  # 3: clean — a retry right after the OOM passes
        with pytest.raises(InjectedDeviceOom):
            s.on_kernel("k")  # 4
        assert s.injected == 2

    def test_after_arms_late(self):
        s = DeviceFaultSpec.parse("oom_every=1,after=2")
        s.on_kernel("k")
        s.on_kernel("k")  # warmup window
        with pytest.raises(InjectedDeviceOom):
            s.on_kernel("k")

    def test_stall_injects_without_failing(self):
        s = DeviceFaultSpec.parse("stall_every=1,stall_s=0.0")
        s.on_kernel("k")
        assert s.injected == 1  # latency, never an error

    def test_poisoned_lowering(self):
        s = DeviceFaultSpec.parse("poison_every=2")
        s.on_lowering()
        with pytest.raises(InjectedPoisonError):
            s.on_lowering()

    def test_install_and_clear_process_schedule(self):
        install_device_faults("oom_every=7")
        assert chaos.FAULTS is not None and chaos.FAULTS.oom_every == 7
        install_device_faults("")
        assert chaos.FAULTS is None

    def test_injection_counts_metric(self):
        base = metrics.snapshot().get("device.faults_injected;fault:oom", 0)
        s = DeviceFaultSpec.parse("oom_every=1")
        with pytest.raises(InjectedDeviceOom):
            s.on_kernel("k")
        assert metrics.snapshot().get("device.faults_injected;fault:oom", 0) > base


class TestChaosSchedule:
    def test_seeded_schedule_is_reproducible(self):
        a = list(ChaosSchedule(seed=14, windows=6, duration_s=1.0))
        b = list(ChaosSchedule(seed=14, windows=6, duration_s=1.0))
        assert a == b
        assert a != list(ChaosSchedule(seed=15, windows=6, duration_s=1.0))

    def test_windows_cover_all_families_with_parsable_specs(self):
        from pilosa_tpu_torch.core.fragment import StorageFaultSpec

        ws = list(ChaosSchedule(seed=3, windows=8))
        assert [w["name"].split("-", 1)[1] for w in ws] == [
            "storage", "device", "mixed", "bitrot",
            "storage", "device", "mixed", "bitrot",
        ]
        for w in ws:
            StorageFaultSpec.parse(w["storage"])  # empty parses clean too
            DeviceFaultSpec.parse(w["device"])
            if "mixed" in w["name"]:
                assert w["storage"] and w["device"]
            if "bitrot" in w["name"]:
                assert w["storage"].startswith("bitrot=")


# -- parity with the reference ------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 14, 1993])
def test_schedule_windows_equal_the_reference(seed):
    assert list(ChaosSchedule(seed, windows=9, duration_s=2.5)) == list(
        ref_chaos.ChaosSchedule(seed, windows=9, duration_s=2.5)
    )


@pytest.mark.parametrize(
    "spec",
    ["oom_every=3,stall_every=2,stall_s=0,poison_every=2,after=1", "oom_every=1", "poison_every=3,after=2", ""],
)
def test_injections_equal_the_reference(spec):
    """One spec and one sequence of launches and lowerings: both
    packages inject the same fault at the same call."""
    calls = ["k", "k", "l", "k", "l", "l", "k", "k", "k", "l", "k", "l", "k", "k", "l"]

    def outcomes(mod):
        s = mod.DeviceFaultSpec.parse(spec)
        got = []
        for call in calls:
            try:
                s.on_kernel("tree_count") if call == "k" else s.on_lowering()
                got.append(None)
            except mod.InjectedDeviceOom:
                got.append("oom")
            except mod.InjectedPoisonError:
                got.append("poison")
        return got, s.injected, bool(s)

    assert outcomes(chaos) == outcomes(ref_chaos)


def test_install_reads_the_environment_as_the_reference(monkeypatch):
    monkeypatch.setenv(chaos.DEVICE_FAULTS_ENV, "oom_every=5,after=3")
    assert chaos.DEVICE_FAULTS_ENV == ref_chaos.DEVICE_FAULTS_ENV
    install_device_faults("")
    ref_chaos.install_device_faults("")
    assert (chaos.FAULTS.oom_every, chaos.FAULTS.after) == (ref_chaos.FAULTS.oom_every, ref_chaos.FAULTS.after) == (5, 3)


# -- the reference's TestDeviceFaultDegrade (tests/test_fusion.py), on the port ----


class TestDeviceFaultDegrade:
    """The chaos hooks against the port's real fused path: a poisoned
    lowering and an injected launch OOM land on the per-call path (or
    recover in place), every answer == the ``pilosa_tpu`` executor's on
    the same data."""

    def _legs(self):
        legs = _Legs()
        want = _norm(legs.jax.execute("i", GAUNTLET))
        return legs, want

    def test_poisoned_lowering_degrades_to_classic_path(self):
        legs, want = self._legs()
        ex = Executor(legs.th, device_policy="always")
        try:
            chaos.install_device_faults("poison_every=1")
            assert _norm(ex.execute("i", GAUNTLET)) == want
            assert ex.fuser.stats()["fused_launches"] == 0
            assert ex.fuser.bypasses.get("error", 0) >= 1
            assert chaos.FAULTS.injected >= 1
            # clearing the schedule restores the fused path untouched
            chaos.install_device_faults("")
            assert _norm(ex.execute("i", GAUNTLET)) == want
            assert ex.fuser.stats()["fused_launches"] >= 1
        finally:
            ex.close()
            legs.close()

    def test_injected_launch_oom_recovers_via_evict_and_retry(self):
        """oom_every=N>1: the injected RESOURCE_EXHAUSTED fires inside
        the attempted launch, the recovery sweep and single retry
        re-consult the counter and pass — every OOM recovers in place,
        nothing degrades, results stay ==."""
        legs, want = self._legs()
        ex = Executor(legs.th, device_policy="always")
        try:
            base = metrics.snapshot().get("device.oom_recovered;path:retry", 0)
            chaos.install_device_faults("oom_every=2")
            for rep in range(4):
                assert _norm(ex.execute("i", GAUNTLET)) == want, rep
            assert chaos.FAULTS.injected >= 1
            st = ex._oom.stats()
            assert st["ooms"] >= 1 and st["recovered"] == st["ooms"]
            assert st["degraded"] == 0  # no CPU degrade, no health trip
            assert metrics.snapshot().get("device.oom_recovered;path:retry", 0) > base
        finally:
            ex.close()
            legs.close()

    def test_unrecoverable_launch_oom_degrades_to_cpu_leg(self):
        """oom_every=1: the retry OOMs too, so the call degrades to the
        CPU leg (an executor with a health gate, as the server's: a bare
        one raises the degrade) and the cooldown keeps the next query
        off the device entirely — answers still ==."""
        legs, want = self._legs()
        bare = Executor(legs.th, device_policy="always")
        health = DeviceHealth(timeout_s=60.0, device=torch.device("cpu"))
        ex = Executor(legs.th, device_policy="auto", health=health, auto_min_containers=1)
        try:
            chaos.install_device_faults("oom_every=1")
            with pytest.raises(DeviceOom):
                bare.execute("i", GAUNTLET)
            base = metrics.snapshot().get("device.oom_cpu_degrades", 0)
            assert _norm(ex.execute("i", GAUNTLET)) == want
            st = ex._oom.stats()
            assert st["degraded"] >= 1
            assert metrics.snapshot().get("device.oom_cpu_degrades", 0) > base
            assert ex._cpu_forced()  # the cooldown holds the CPU leg
            # and the NEXT query never touches the device at all
            n0 = chaos.FAULTS._kernels
            assert _norm(ex.execute("i", GAUNTLET)) == want
            assert chaos.FAULTS._kernels == n0
        finally:
            bare.close()
            ex.close()
            health.close()
            legs.close()


def test_hooks_fire_only_at_recovered_boundaries():
    """The hook fires where OomRecovery retries (tree counts, the fused
    launch), not in the analytic kernels the reference launches bare:
    under oom_every=1 a bare executor's unfused Sum still answers."""
    legs, _ = TestDeviceFaultDegrade()._legs()
    ex = Executor(legs.th, device_policy="always", fusion_enabled=False)
    try:
        q = 'Sum(Row(f=1), field="v")'
        want = _norm(legs.jax.execute("i", q))
        chaos.install_device_faults("oom_every=1")
        assert _norm(ex.execute("i", q)) == want
        assert chaos.FAULTS._kernels == 0
        with pytest.raises(DeviceOom):
            ex.execute("i", "Count(Intersect(Row(f=1), Row(f=2)))")
        assert chaos.FAULTS._kernels == 2  # the attempt and its retry
    finally:
        ex.close()
        legs.close()


# -- chip_smoke.py's fault windows and capture, on the CPU at a small size ------------


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fault_windows_and_capture_on_the_cpu(tmp_path, monkeypatch):
    from pilosa_tpu_torch.server import Config, Server

    smoke = _smoke()
    monkeypatch.setattr(smoke, "OOM_COOLDOWN_S", 0.5)
    cfg = Config(data_dir=str(tmp_path / "d"), bind="127.0.0.1:0", device="cpu", chaos_enabled=True,
                 auto_device_min_containers=1)
    server = Server(cfg)
    server.open()
    try:
        rng = np.random.default_rng(15)
        idx = server.holder.create_index("t")
        cols = rng.integers(0, 2 << 20, size=4000).tolist()
        idx.create_field("f").import_bits(rng.integers(0, 8, size=4000).tolist(), cols)
        vcols = rng.choice(2 << 20, size=600, replace=False).tolist()
        idx.create_field("v", FieldOptions(type=FIELD_TYPE_INT, min=0, max=900)).import_values(
            vcols, rng.integers(0, 900, size=600).tolist()
        )
        probe = [("t", q) for q in (
            "Count(Intersect(Row(f=1), Row(f=2)))", "Count(Union(Row(f=3), Row(f=4)))",
            "GroupBy(Rows(f), limit=5)", "Count(Row(f=5))",
        )]
        stats = [("t", q) for q in (
            'Min(field="v")', 'Percentile(field="v", nth=50)', 'Distinct(field="v")',
            'Percentile(Row(f=1), field="v", nth=90)',
        )]
        cpu = Executor(server.holder, device_policy="never")
        answers = {(i, q): smoke.wire(cpu.execute(i, q)) for i, q in probe + stats + [("t", "TopN(f, n=3)")]}
        cpu.close()

        def launched():
            return sum(v["count"] for k, v in metrics.snapshot().items()
                       if k.startswith(metrics.SPMD_EXECUTE_SECONDS + ".hist"))

        out = smoke.fault_windows(server, server.address(), answers, probe, stats, launched)
        assert out["fallbacks"] == 2
        assert out["poison_every=1"]["error_bypasses"] >= 1
        assert out["oom_every=2"]["ooms"] >= 1 and out["oom_every=2"]["degraded"] == 0
        assert out["oom_every=1"]["degraded"] == 1 and out["stall_every=4"]["stalls"] >= 1
        assert all(w["chaos"]["enabled"] for k, w in out.items() if k != "fallbacks")
        cap = smoke.capture_arm(server.address(), answers, [("t", "TopN(f, n=3)"), probe[0]], stats,
                                str(tmp_path / "prof"))
        assert cap["trace_bytes"] > 0 and cap["device_kernels"] == 0
    finally:
        server.close()


def test_chip_smoke_maps_trace_kernels_to_the_port_kernels():
    """The capture's exact check counts each port kernel's device kernels
    by the ``__global__`` names in its source: every kernel has at least
    one, no name belongs to two kernels, and the trace's demangled
    signatures reduce to those names."""
    smoke = _smoke()
    symbols = smoke.kernel_symbols()
    from pilosa_tpu_torch.ops import cuda

    assert set(symbols) == {k.name for k in cuda.KERNELS} and all(symbols.values())
    names = [n for s in symbols.values() for n in s]
    assert len(names) == len(set(names))
    assert "dense_scores_kernel" in symbols["dense_scores"] and "tree_count_kernel" in symbols["tree_count"]
    for sig, base in [
        ("void dense_scores_kernel<1, 8>(int const* const*, int const*, int*, int, int, int)", "dense_scores_kernel"),
        ("void (anonymous namespace)::spin_kernel(long)", "spin_kernel"),
        ("void bsi_minmax_kernel<true>(MmParams)", "bsi_minmax_kernel"),
        ("bsi_percentile_kernel(PctParams)", "bsi_percentile_kernel"),
    ]:
        assert smoke.trace_kernel_base(sig) == base
