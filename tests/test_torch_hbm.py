"""The port's HBM governor and OOM recovery (``pilosa_tpu_torch/
executor/hbm.py``) against the JAX package's: the cases of
``tests/test_hbm.py`` that need no plan cache or fault injector (neither
is ported), run on both packages, plus the port's own: CUDA's errors
classify, the stager's entries and tier 1's payloads reach the ledger,
relief frees staged tensors, and a wedge reset empties the stager's
account."""

import importlib
import threading

import numpy as np
import pytest
import torch

from pilosa_tpu_torch import SHARD_WIDTH
from pilosa_tpu_torch.core import FieldOptions, Holder
from pilosa_tpu_torch.core.field import FIELD_TYPE_INT


@pytest.fixture(params=["pilosa_tpu", "pilosa_tpu_torch"])
def hbm(request):
    """The hbm module of either package (DeviceDown rides along)."""
    mod = importlib.import_module(f"{request.param}.executor.hbm")
    mod.DeviceDown = importlib.import_module(f"{request.param}.executor.devicehealth").DeviceDown
    return mod


# -- error classification ----------------------------------------------------


class TestClassify:
    def test_alloc_markers(self, hbm):
        assert hbm.classify_device_error(RuntimeError("RESOURCE_EXHAUSTED: x")) == "alloc"
        assert hbm.classify_device_error(RuntimeError("Out of memory allocating")) == "alloc"

    def test_wedge_by_type_name_and_marker(self, hbm):
        XlaRuntimeError = type("XlaRuntimeError", (RuntimeError,), {})
        assert hbm.classify_device_error(XlaRuntimeError("boom")) == "wedge"
        assert hbm.classify_device_error(RuntimeError("INTERNAL: stream")) == "wedge"
        assert hbm.classify_device_error(RuntimeError("DATA_LOSS on fetch")) == "wedge"

    def test_non_device_errors_stay_loud(self, hbm):
        assert hbm.classify_device_error(ValueError("bad shape")) is None
        assert hbm.classify_device_error(KeyError("f")) is None


def test_cuda_out_of_memory_is_an_allocation_failure():
    from pilosa_tpu_torch.executor.hbm import classify_device_error

    e = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1024.00 GiB")
    assert classify_device_error(e) == "alloc"
    # the class decides, not the text
    assert classify_device_error(torch.cuda.OutOfMemoryError("no text")) == "alloc"


@pytest.mark.parametrize(
    "exc",
    [
        RuntimeError("CUDA error: an illegal memory access was encountered"),
        RuntimeError("launch failed: cudaErrorLaunchFailure"),
        type("AcceleratorError", (RuntimeError,), {})("device-side assert triggered"),
    ],
    ids=["illegal_address", "launch_failure", "accelerator_error"],
)
def test_cuda_runtime_errors_are_wedges(exc):
    from pilosa_tpu_torch.executor.hbm import classify_device_error

    assert classify_device_error(exc) == "wedge"


# -- the byte ledger ---------------------------------------------------------


class TestGovernor:
    def test_budget_is_sum_of_shares_unless_pinned(self, hbm):
        gov = hbm.HbmGovernor()
        gov.register("a", share_bytes=100)
        gov.register("b", share_bytes=50)
        assert gov.budget() == 150
        pinned = hbm.HbmGovernor(budget_bytes=80)
        pinned.register("a", share_bytes=100)
        pinned.register("b", share_bytes=50)
        assert pinned.budget() == 80

    def test_reserve_release_and_headroom(self, hbm):
        gov = hbm.HbmGovernor(budget_bytes=100)
        gov.register("a")
        assert gov.reserve("a", 60) is True
        assert gov.used("a") == 60 and gov.headroom() == 40
        gov.release("a", 25)
        assert gov.used() == 35
        gov.release("a", 10**9)  # floor at zero, never negative
        assert gov.used("a") == 0

    def test_reserve_over_budget_relieves_other_tenants_only(self, hbm):
        gov = hbm.HbmGovernor(budget_bytes=100)
        evicted = []

        def evict(need):
            evicted.append(need)
            gov.release("cache", min(need, gov.used("cache")))
            return need

        gov.register("cache", share_bytes=100, evict_fn=evict, tier=0)
        me_evicted = []
        gov.register("me", share_bytes=100, evict_fn=lambda n: me_evicted.append(n) or 0, tier=1)
        gov.reserve("cache", 90)
        assert gov.reserve("me", 50) is True
        assert evicted and not me_evicted
        assert gov.over_budget() == 0

    def test_tier_order_lower_tier_first(self, hbm):
        gov = hbm.HbmGovernor(budget_bytes=100)
        order = []

        def tier0(need):
            order.append("cache")
            gov.release("cache", 40)
            return 40

        def tier1(need):
            order.append("stager")
            gov.release("stager", need)
            return need

        gov.register("cache", share_bytes=50, evict_fn=tier0, tier=0)
        gov.register("stager", share_bytes=50, evict_fn=tier1, tier=1)
        gov.reserve("cache", 40)
        gov.reserve("stager", 60)
        gov.register("transient")
        gov.reserve("transient", 60)  # 160 total: needs both tiers
        assert order[0] == "cache"
        assert gov.over_budget() == 0

    def test_admit_relieves_then_answers(self, hbm):
        gov = hbm.HbmGovernor(budget_bytes=100)
        gov.register(
            "cache", share_bytes=100, tier=0,
            evict_fn=lambda need: (gov.release("cache", 70), 70)[1],
        )
        gov.reserve("cache", 70)
        assert gov.admit(20) is True
        assert gov.used("cache") == 70
        assert gov.admit(90) is True
        assert gov.used("cache") == 0
        assert gov.admit(10**12) is False

    def test_reset_is_the_epoch_fence(self, hbm):
        gov = hbm.HbmGovernor(budget_bytes=100)
        gov.register("a")
        gov.register("b")
        gov.reserve("a", 30)
        gov.reserve("b", 40)
        gov.reset("a")
        assert gov.used("a") == 0 and gov.used("b") == 40
        gov.reset()
        assert gov.used() == 0

    def test_stats_shape(self, hbm):
        gov = hbm.HbmGovernor(budget_bytes=64)
        gov.register("a", share_bytes=64, tier=3)
        gov.reserve("a", 8)
        st = gov.stats()
        assert st["budget_bytes"] == 64 and st["used_bytes"] == 8
        assert st["tenants"]["a"] == {"used": 8, "share": 64, "tier": 3}

    def test_index_quota_sweeps_only_that_index(self, hbm):
        gov = hbm.HbmGovernor(budget_bytes=1000)
        freed = []

        def evict(need, prefer=None):
            freed.append((need, prefer))
            gov.release("stager", need, index=prefer[0] if prefer else "")
            return need

        gov.register("stager", share_bytes=1000, evict_fn=evict, tier=1)
        gov.set_index_quotas({"a": 100})
        gov.reserve("stager", 80, index="b")
        gov.reserve("stager", 150, index="a")
        assert freed == [(50, ["a"])]
        assert gov.index_used("a") == 100 and gov.index_used("b") == 80
        assert gov.stats()["index_quotas"] == {"default": 0, "a": 100}


# -- OOM recovery policy -----------------------------------------------------


class _FakeHealth:
    def __init__(self):
        self.reasons = []

    def trip(self, reason):
        self.reasons.append(reason)


class TestOomRecovery:
    def test_alloc_failure_evicts_and_retries_once(self, hbm):
        gov = hbm.HbmGovernor(budget_bytes=100)
        swept = []
        gov.register("cache", share_bytes=100, tier=0, evict_fn=lambda need: swept.append(need) or 0)
        rec = hbm.OomRecovery(governor=gov)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("RESOURCE_EXHAUSTED: alloc failed")
            return 42

        assert rec.run(flaky, kind="kernel") == 42
        assert calls["n"] == 2 and swept
        assert rec.stats()["recovered"] == 1
        assert rec.stats()["degraded"] == 0

    def test_persistent_alloc_failure_degrades_to_cpu(self, hbm):
        degraded = []
        health = _FakeHealth()
        rec = hbm.OomRecovery(health=health, on_degrade=lambda: degraded.append(1), trip_after=2)

        def dead():
            raise RuntimeError("RESOURCE_EXHAUSTED: still full")

        with pytest.raises(hbm.DeviceOom) as ei:
            rec.run(dead, kind="fused_query")
        assert isinstance(ei.value, hbm.DeviceDown)
        assert degraded == [1]
        assert health.reasons == []
        assert rec.stats()["degraded"] == 1

    def test_wedge_skips_retry_and_degrades(self, hbm):
        XlaRuntimeError = type("XlaRuntimeError", (RuntimeError,), {})
        calls = {"n": 0}

        def wedged():
            calls["n"] += 1
            raise XlaRuntimeError("INTERNAL: stream executor died")

        rec = hbm.OomRecovery()
        with pytest.raises(hbm.DeviceOom):
            rec.run(wedged)
        assert calls["n"] == 1

    def test_repeat_degrades_trip_health(self, hbm):
        health = _FakeHealth()
        rec = hbm.OomRecovery(health=health, trip_after=2, window_s=30.0)

        def dead():
            raise RuntimeError("RESOURCE_EXHAUSTED")

        for _ in range(2):
            with pytest.raises(hbm.DeviceOom):
                rec.run(dead)
        assert health.reasons

    def test_non_device_errors_propagate_untouched(self, hbm):
        rec = hbm.OomRecovery()
        with pytest.raises(ValueError):
            rec.run(lambda: (_ for _ in ()).throw(ValueError("shape bug")))
        assert rec.stats()["ooms"] == 0

    def test_recovery_is_thread_safe_bookkeeping(self, hbm):
        rec = hbm.OomRecovery()

        def one():
            try:
                rec.run(lambda: (_ for _ in ()).throw(RuntimeError("RESOURCE_EXHAUSTED")))
            except hbm.DeviceOom:
                pass

        ts = [threading.Thread(target=one) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        st = rec.stats()
        assert st["ooms"] == 8 and st["degraded"] == 8


def test_cuda_oom_retry_succeeds_after_relief():
    """The card's own error type: relief frees the stager's tensors and
    the one retry succeeds."""
    from pilosa_tpu_torch.executor.hbm import HbmGovernor, OomRecovery

    gov = HbmGovernor(budget_bytes=1 << 20)
    held = {"n": 4}

    def evict(need):
        n = held["n"]
        held["n"] = 0
        gov.release("stager", n << 10)
        return n << 10

    gov.register("stager", share_bytes=1 << 20, evict_fn=evict, tier=1)
    gov.reserve("stager", 4 << 10)
    rec = OomRecovery(governor=gov)

    def alloc():
        if held["n"]:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return "ok"

    assert rec.run(alloc, kind="kernel") == "ok"
    assert rec.stats() == {"ooms": 1, "recovered": 1, "degraded": 0, "recent_failures": 0}
    assert gov.used("stager") == 0


# -- the port's tenants in the ledger ----------------------------------------


def _holder(shards: int = 2) -> Holder:
    h = Holder()
    h.open()
    rng = np.random.default_rng(5)
    idx = h.create_index("i")
    f = idx.create_field("f")
    v = idx.create_field("v", FieldOptions(type=FIELD_TYPE_INT, min=-50, max=5000))
    f.import_bits(
        rng.integers(0, 10, size=2000).tolist(),
        rng.integers(0, shards * SHARD_WIDTH, size=2000).tolist(),
    )
    vcols = rng.choice(shards * SHARD_WIDTH, size=400, replace=False)
    v.import_values(vcols.tolist(), rng.integers(-50, 5000, size=400).tolist())
    return h


def test_executor_wires_one_ledger_for_the_stager_and_tier1():
    from pilosa_tpu_torch.executor import DeviceStager, Executor
    from pilosa_tpu_torch.executor.hbm import HbmGovernor

    h = _holder(shards=1)  # one shard: rows stage through tier 1
    gov = HbmGovernor(budget_bytes=32 << 20)
    st = DeviceStager("cpu", tier1_max_bytes=1 << 20, compressed_min_ratio=4.0)
    ex = Executor(h, device="cpu", device_policy="always", stager=st, governor=gov)
    try:
        assert ex.governor is gov
        tenants = gov.stats()["tenants"]
        assert {"stager", "tier1", "batcher"} <= set(tenants)
        q = (
            "Count(Intersect(Row(f=1), Row(f=2)))"
            "TopN(f, Intersect(Row(f=1), Row(f=2)), n=5)"
            'Sum(Row(f=3), field="v") Count(Row(f=4))'
        )
        for _ in range(2):
            ex.execute("i", q)
            assert gov.used() <= gov.budget(), gov.stats()
        # the ledger is the stager's resident bytes, by index
        assert gov.used("stager") == st._bytes > 0
        assert gov.stats()["tenants"]["stager"]["by_index"] == {"i": st._bytes}
        # tier 1's host payloads are a host-domain tenant, outside the budget
        t1 = gov.stats()["tenants"]["tier1"]
        assert t1["domain"] == "host" and t1["used"] == st.tier1.stats()["bytes"] > 0
        assert gov.stats()["used_bytes"] == gov.used("stager") + gov.used("batcher")
    finally:
        ex.close()
        h.close()


def test_relief_evicts_staged_entries_and_answers_stay_exact():
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.executor.hbm import HbmGovernor

    h = _holder()
    gov = HbmGovernor()
    ex = Executor(h, device="cpu", device_policy="always", governor=gov)
    cpu = Executor(h, device="cpu", device_policy="never")
    try:
        q = "Count(Row(f=1)) Count(Row(f=2)) TopN(f, n=3) Sum(field=v)"
        want = cpu.execute("i", q)
        assert ex.execute("i", q) == want
        staged = gov.used("stager")
        assert staged > 0
        freed = gov.relieve_for_oom()
        # every entry but the hottest goes; the ledger follows
        assert freed > 0 and gov.used("stager") == ex.stager._bytes == staged - freed
        assert ex.execute("i", q) == want
        ex.stager.reset_after_wedge()
        assert gov.used("stager") == 0 and ex.stager.usage() == (0, 0)
        assert ex.execute("i", q) == want
        assert gov.used("stager") == ex.stager._bytes > 0
    finally:
        ex.close()
        cpu.close()
        h.close()


def test_pinned_budget_bounds_the_stager():
    """A global budget below the stager's share: the stager's LRU loop
    evicts for the ledger, not just for its own share."""
    from pilosa_tpu_torch.executor import DeviceStager, Executor
    from pilosa_tpu_torch.executor.hbm import HbmGovernor

    h = _holder(shards=3)
    row_bytes = SHARD_WIDTH // 8
    gov = HbmGovernor(budget_bytes=4 * row_bytes)
    st = DeviceStager("cpu", budget_bytes=64 * row_bytes, tier1_max_bytes=0)
    ex = Executor(h, device="cpu", device_policy="always", stager=st, governor=gov)
    cpu = Executor(h, device="cpu", device_policy="never")
    try:
        for r in range(10):
            q = f"Count(Row(f={r}))"
            assert ex.execute("i", q) == cpu.execute("i", q)
            assert gov.used() <= gov.budget() or len(st._cache) == 1, gov.stats()
    finally:
        ex.close()
        cpu.close()
        h.close()


def test_wedge_reset_fails_hung_builds_and_fences_their_publish():
    from pilosa_tpu_torch.executor import DeviceStager
    from pilosa_tpu_torch.executor.hbm import HbmGovernor

    st = DeviceStager("cpu", tier1_max_bytes=0)
    gov = HbmGovernor()
    st.set_governor(gov)
    started, release = threading.Event(), threading.Event()
    words = torch.zeros(8, dtype=torch.int32)

    def slow_build():
        started.set()
        release.wait(5)
        return words, 32, 1

    out = {}

    def build_first():
        out["v"] = st._get_or_build(("k", "row"), 1, slow_build)

    def waiter():
        try:
            st._get_or_build(("k", "row"), 1, slow_build)
        except RuntimeError as e:
            out["err"] = str(e)

    t1 = threading.Thread(target=build_first)
    t1.start()
    started.wait(5)
    t2 = threading.Thread(target=waiter)
    t2.start()
    st.reset_after_wedge()
    t2.join(5)
    assert "device wedged" in out["err"]
    release.set()
    t1.join(5)
    # the hung build's value reached its own caller but not the cache
    # or the ledger
    assert out["v"] is words
    assert st.usage() == (0, 0) and gov.used("stager") == 0
