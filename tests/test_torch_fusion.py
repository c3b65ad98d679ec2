"""Whole-query fusion in the port (executor/fusion.py + the device plan
cache): every single-node case of ``tests/test_fusion.py`` run on
``pilosa_tpu_torch`` (``device="cpu"``, so the fused program runs the
kernels' plain versions), then parity with the JAX package.

Parity: the same seeded numpy data goes into a ``pilosa_tpu`` holder and
a port holder; every fusable unit kind (Count, Sum, GroupBy count and
sum, Distinct, Percentile, TopN) and a ``__cached`` subtree run through
``pilosa_tpu``'s executor (fusion on, ``JAX_PLATFORMS=cpu``), the port
fused and the port unfused, and the three answers must be ``==`` — also
after writes that must invalidate the plan cache. The plain versions of
the fused program's Distinct (K9) and TopN head (K2 + a view) are held
against the JAX functions on the same inputs.

Left for later items (ROADMAP): wave fusion through the dispatch engine
(A6: ``test_combined_wave_is_one_fused_launch``,
``test_read_after_write_fresh_through_fused_wave``) and the poisoned
lowering of the fault injector (A7:
``test_poisoned_lowering_degrades_to_classic_path``).
"""

import json
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu import ops as jops
from pilosa_tpu.core import FieldOptions as JaxFieldOptions
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.core.field import FIELD_TYPE_INT as JAX_INT
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.plan.cache import PlanCache as JaxPlanCache

from pilosa_tpu_torch import SHARD_WIDTH, ops
from pilosa_tpu_torch.core import FieldOptions, Holder
from pilosa_tpu_torch.core.field import FIELD_TYPE_INT
from pilosa_tpu_torch.executor import ExecOptions
from pilosa_tpu_torch.executor import Executor as _Executor
from pilosa_tpu_torch.executor.devicehealth import DeviceHealth
from pilosa_tpu_torch.executor.fusion import QueryFuser
from pilosa_tpu_torch.executor.hbm import DeviceOom
from pilosa_tpu_torch.plan.cache import DevicePlanCache, PlanCache
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.utils import metrics


def Executor(h, **kw):
    """The port's executor on the CPU (the device legs' plain versions)."""
    return _Executor(h, device="cpu", **kw)


@pytest.fixture
def holder():
    h = Holder()  # in-memory
    h.open()
    return h


def _mixed_data(n_shards=3):
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 12, size=3000).tolist()
    cols = rng.integers(0, n_shards * SHARD_WIDTH, size=3000).tolist()
    vcols = rng.choice(n_shards * SHARD_WIDTH, size=800, replace=False).tolist()
    vvals = rng.integers(-50, 5000, size=800).tolist()
    return rows, cols, vcols, vvals


def seed_mixed(h, n_shards=3, int_options=None):
    """Multi-shard index with a set field and a BSI field — enough surface
    for every unit kind in one fused launch."""
    rows, cols, vcols, vvals = _mixed_data(n_shards)
    opts = int_options or FieldOptions(type=FIELD_TYPE_INT, min=-50, max=5000)
    idx = h.create_index("i")
    idx.create_field("f").import_bits(rows, cols)
    idx.create_field("v", opts).import_values(vcols, vvals)


# the fusion gauntlet: every fusable unit kind plus 3-op chains, in one
# multi-call query so a single launch covers them all
GAUNTLET = (
    "Count(Row(f=1))"
    "TopN(f, Row(f=3), n=4)"
    'Sum(Row(f=1), field="v")'
    'Sum(field="v")'
    "Count(Intersect(Row(f=1), Row(f=2)))"
    "Count(Union(Row(f=3), Xor(Row(f=4), Row(f=5)), Difference(Row(f=6), Row(f=7))))"
    "Count(Range(v > 100))"
    "TopN(f, Union(Row(f=1), Row(f=2)), n=6)"
)

# every unit kind the port lowers, analytics included
UNITS = GAUNTLET + (
    'Distinct(field="v")'
    'Distinct(Row(f=2), field="v")'
    'Percentile(field="v", nth=50)'
    'Percentile(Row(f=4), field="v", nth=99.9)'
    "GroupBy(Rows(f), limit=5)"
    "GroupBy(Rows(f, ids=[1, 2, 3]), Row(f=3), Sum(field=v))"
)


def oracle_of(h):
    return Executor(h, device_policy="never")


# -- whole-query fusion bit-identity ----------------------------------------


class TestBitIdentity:
    def test_gauntlet_fused_vs_unfused_vs_oracle(self, holder):
        """The full gauntlet in ONE query: fused results match both the
        per-call device path (fusion off) and the CPU oracle exactly."""
        seed_mixed(holder)
        oracle = oracle_of(holder)
        want = oracle.execute("i", GAUNTLET)
        unfused = Executor(holder, device_policy="always", fusion_enabled=False)
        assert unfused.fuser is None
        assert unfused.execute("i", GAUNTLET) == want
        ex = Executor(holder, device_policy="always")
        try:
            got = ex.execute("i", GAUNTLET)
            assert got == want
            st = ex.fuser.stats()
            assert st["fused_launches"] == 1
            assert st["fused_calls"] >= 5
            assert st["bytes_returned"] > 0
            # a repeat reuses the program
            assert ex.execute("i", GAUNTLET) == want
            st2 = ex.fuser.stats()
            assert st2["fused_launches"] >= 2
            assert st2["programs"] == st["programs"]
        finally:
            ex.close()
            unfused.close()
            oracle.close()

    def test_three_op_chains_fuse_into_one_launch(self, holder):
        """Three 3-op chain Counts — the bench's chain shape — cost one
        fused launch, and one tree count at Q = 3 a distinct program."""
        seed_mixed(holder)
        q = (
            "Count(Union(Row(f=1), Intersect(Row(f=2), Row(f=3))))"
            "Count(Difference(Union(Row(f=4), Row(f=5)), Row(f=6)))"
            "Count(Xor(Row(f=7), Union(Row(f=8), Row(f=9))))"
        )
        oracle = oracle_of(holder)
        want = oracle.execute("i", q)
        ex = Executor(holder, device_policy="always")
        try:
            assert ex.execute("i", q) == want
            st = ex.fuser.stats()
            assert st["fused_launches"] == 1 and st["fused_calls"] == 3
        finally:
            ex.close()
            oracle.close()

    def test_cached_subtree_substitution_stays_fresh_and_identical(self, holder):
        """__cached substitution under fusion: a repeated subtree CSEs
        into a __cached node whose stack the device cache pins; repeats
        serve from both caches and writes invalidate exactly."""
        seed_mixed(holder)
        q = "Count(Intersect(Row(f=1), Row(f=2)))TopN(f, Intersect(Row(f=1), Row(f=2)), n=5)"
        oracle = oracle_of(holder)
        ex = Executor(holder, device_policy="always", plan_cache=PlanCache())
        try:
            assert ex.device_cache is not None
            want = oracle.execute("i", q)
            for rep in range(4):
                assert ex.execute("i", q) == want, rep
            dst = ex.device_cache.stats()
            assert dst["inserts"] >= 1 and dst["hits"] >= 1
            assert ex.fuser.stats()["cache_served"] >= 1
            # write -> generation bump -> nothing stale anywhere
            assert ex.execute("i", f"Set({SHARD_WIDTH + 55}, f=1)") == [True]
            assert ex.execute("i", f"Set({SHARD_WIDTH + 55}, f=2)") == [True]
            want2 = oracle.execute("i", q)
            assert want2 != want
            assert ex.execute("i", q) == want2
        finally:
            ex.close()
            oracle.close()

    def test_plan_cache_serves_whole_calls_on_fused_path(self, holder):
        """Whole-call plan-cache hits short-circuit lowering: repeats of a
        cacheable multi-call read stop launching."""
        seed_mixed(holder)
        q = "Count(Row(f=1))Count(Row(f=2))"
        oracle = oracle_of(holder)
        want = oracle.execute("i", q)
        ex = Executor(holder, device_policy="always", plan_cache=PlanCache())
        try:
            for rep in range(4):
                assert ex.execute("i", q) == want, rep
            st = ex.fuser.stats()
            assert st["fused_launches"] == 1  # first execution only
            assert st["cache_served"] >= 4
        finally:
            ex.close()
            oracle.close()


# -- device-resident plan cache ---------------------------------------------


def _words(n):
    return torch.zeros(n, dtype=torch.int32)


class TestDevicePlanCache:
    def test_lru_eviction_under_byte_budget(self):
        gen = ("g", 1)
        dc = DevicePlanCache(max_bytes=1000)
        a = _words(100)  # 400 bytes
        dc.put("a", gen, a, 400)
        dc.put("b", gen, a, 400)
        assert dc.stats()["entries"] == 2 and dc.stats()["bytes"] == 800
        dc.get("a", lambda: gen)  # a is now MRU
        dc.put("c", gen, a, 400)  # over budget -> evict LRU = b
        st = dc.stats()
        assert st["entries"] == 2 and st["bytes"] == 800
        assert st["evictions"] == 1
        assert dc.get("a", lambda: gen) is not None
        assert dc.get("b", lambda: gen) is None
        assert dc.get("c", lambda: gen) is not None

    def test_oversized_value_never_stored(self):
        dc = DevicePlanCache(max_bytes=100)
        dc.put("big", ("g",), _words(1000), 4000)
        assert dc.stats()["entries"] == 0

    def test_generation_mismatch_invalidates(self):
        dc = DevicePlanCache(max_bytes=1000)
        dc.put("k", ("gen", 1), _words(4), 16)
        assert dc.get("k", lambda: ("gen", 1)) is not None
        assert dc.get("k", lambda: ("gen", 2)) is None
        st = dc.stats()
        assert st["invalidations"] == 1 and st["entries"] == 0

    def test_epoch_fence_rejects_pre_reset_builds(self):
        dc = DevicePlanCache(max_bytes=1000)
        epoch0 = dc.epoch
        dc.epoch_reset()  # device restore while a build was in flight
        dc.put("k", ("g",), _words(4), 16, epoch0=epoch0)
        assert dc.stats()["entries"] == 0

    def test_executor_epoch_reset_clears_device_cache(self, holder):
        seed_mixed(holder, n_shards=1)
        ex = Executor(holder, device_policy="always", plan_cache=PlanCache())
        try:
            ex.device_cache.put("k", ("g",), _words(4), 16)
            assert ex.device_cache.stats()["entries"] == 1
            assert ex.governor.used("device_cache") == 16
            ex._on_device_restore()
            st = ex.device_cache.stats()
            assert st["entries"] == 0 and st["epoch"] >= 1
            assert ex.governor.used("device_cache") == 0
        finally:
            ex.close()

    def test_disabled_without_plan_cache_or_budget(self, holder):
        assert Executor(holder, device_policy="always").device_cache is None
        assert (
            Executor(holder, device_policy="always", plan_cache=PlanCache(), plan_cache_device_bytes=0).device_cache
            is None
        )
        assert Executor(holder, device_policy="always", plan_cache=PlanCache()).device_cache is not None

    def test_cached_stacks_are_their_own_storage(self, holder):
        """A device-cache entry is a tensor of its own, never a view of a
        stager entry (which a word-delta refresh may patch in place)."""
        seed_mixed(holder)
        ex = Executor(holder, device_policy="always", plan_cache=PlanCache())
        try:
            q = "Count(Intersect(Row(f=1), Row(f=2)))Count(Union(Intersect(Row(f=1), Row(f=2)), Row(f=5)))"
            ex.execute("i", q)
            ex.execute("i", q)
            staged = {e.value.untyped_storage().data_ptr() for e in ex.stager._cache.values()
                      if isinstance(e.value, torch.Tensor)}
            cached = [e.value for e in ex.device_cache._entries.values()]
            assert cached
            assert all(t.untyped_storage().data_ptr() not in staged for t in cached)
        finally:
            ex.close()


# -- bypass matrix ------------------------------------------------------------


class TestBypassMatrix:
    def _calls(self, q="Count(Row(f=1))Count(Row(f=2))"):
        return parse(q).calls

    def test_opt_and_shard_bypass(self, holder):
        seed_mixed(holder, n_shards=1)
        ex = Executor(holder, device_policy="always")
        try:
            fuser, calls = ex.fuser, self._calls()
            assert fuser.try_execute("i", calls, [0], ExecOptions(remote=True)) is None
            assert fuser.try_execute("i", calls, [0], ExecOptions(serial=True)) is None
            assert fuser.try_execute("i", calls, [], ExecOptions()) is None
            for reason in ("opt", "no_shards"):
                assert fuser.bypasses.get(reason, 0) >= 1, (reason, fuser.bypasses)
            # and after every probe the real path still fuses
            assert fuser.try_execute("i", calls, [0], ExecOptions())
        finally:
            ex.close()

    def test_serial_and_single_call_never_reach_fuser(self, holder):
        seed_mixed(holder)
        oracle = oracle_of(holder)
        ex = Executor(holder, device_policy="always")
        try:
            q = "Count(Row(f=1))Count(Row(f=2))"
            assert ex.execute("i", q, opt=ExecOptions(serial=True)) == oracle.execute("i", q)
            assert ex.execute("i", "Count(Row(f=1))") == oracle.execute("i", "Count(Row(f=1))")
            assert ex.fuser.stats()["fused_launches"] == 0
        finally:
            ex.close()
            oracle.close()

    def test_writes_bypass_fusion(self, holder):
        """A query holding a write runs the per-call serial path: the
        fuser never sees it (cross-call ordering must hold)."""
        seed_mixed(holder)
        ex = Executor(holder, device_policy="always")
        try:
            col = SHARD_WIDTH + 424242
            got = ex.execute("i", f"Set({col}, f=1)Count(Row(f=1))")
            assert got[0] is True
            assert ex.fuser.stats()["fused_launches"] == 0
            oracle = oracle_of(holder)
            assert got[1] == oracle.execute("i", "Count(Row(f=1))")[0]
        finally:
            ex.close()

    def test_cpu_policy_and_max_calls_bypass(self, holder):
        seed_mixed(holder, n_shards=1)
        ex = Executor(holder, device_policy="never")
        try:
            assert ex.fuser.try_execute("i", self._calls(), [0], ExecOptions()) is None
            assert ex.fuser.bypasses.get("cpu", 0) >= 1
        finally:
            ex.close()
        ex2 = Executor(holder, device_policy="always", fusion_max_calls=1)
        try:
            q = "Count(Row(f=1))Count(Row(f=2))"
            oracle = oracle_of(holder)
            assert ex2.execute("i", q) == oracle.execute("i", q)
            assert ex2.fuser.bypasses.get("too_many_calls", 0) >= 1
            assert ex2.fuser.stats()["fused_launches"] == 0
        finally:
            ex2.close()

    def test_lowering_failure_degrades_to_classic_path(self, holder, monkeypatch):
        """A call whose lowering fails on its arguments or data leaves
        the fused launch and takes the per-call path, counted; a fault of
        anything else is not swallowed."""
        seed_mixed(holder)
        oracle = oracle_of(holder)
        ex = Executor(holder, device_policy="always")
        try:
            q = "Count(Row(f=1))Count(Row(f=2))Count(Row(f=3))"
            real = QueryFuser._lower_count

            def flaky(self, index, i, c, shards, opt):
                if i == 1:
                    raise ValueError("malformed")
                return real(self, index, i, c, shards, opt)

            monkeypatch.setattr(QueryFuser, "_lower_count", flaky)
            assert ex.execute("i", q) == oracle.execute("i", q)
            assert ex.fuser.bypasses.get("lowering", 0) == 1
            assert ex.fuser.stats()["fused_launches"] == 1
            monkeypatch.setattr(QueryFuser, "_lower_and_launch", lambda *a, **k: 1 / 0)
            with pytest.raises(ZeroDivisionError):
                ex.execute("i", q)
            assert "error" not in ex.fuser.bypasses
        finally:
            ex.close()
            oracle.close()


# -- device faults at the fused launch ------------------------------------------


class TestDeviceFaultDegrade:
    """An allocation failure inside the fused launch: OOM recovery
    relieves and retries it in place, and one it cannot recover degrades
    the reads to the CPU leg under a health gate — answers always equal
    the oracle's."""

    def _oom_every(self, monkeypatch, n):
        real = QueryFuser._enqueue
        calls = {"n": 0}

        def enqueue(self, program, units):
            calls["n"] += 1
            if calls["n"] % n == 0:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
            return real(self, program, units)

        monkeypatch.setattr(QueryFuser, "_enqueue", enqueue)
        return calls

    def test_injected_launch_oom_recovers_via_evict_and_retry(self, holder, monkeypatch):
        seed_mixed(holder)
        oracle = oracle_of(holder)
        want = oracle.execute("i", GAUNTLET)
        ex = Executor(holder, device_policy="always")
        try:
            base = metrics.snapshot().get("device.oom_recovered;path:retry", 0)
            self._oom_every(monkeypatch, 2)
            for rep in range(4):
                assert ex.execute("i", GAUNTLET) == want, rep
            st = ex._oom.stats()
            assert st["ooms"] >= 1 and st["recovered"] == st["ooms"]
            assert st["degraded"] == 0
            assert metrics.snapshot().get("device.oom_recovered;path:retry", 0) > base
        finally:
            ex.close()
            oracle.close()

    def test_unrecoverable_launch_oom_degrades_to_cpu_leg(self, holder, monkeypatch):
        seed_mixed(holder)
        oracle = oracle_of(holder)
        want = oracle.execute("i", GAUNTLET)
        # a bare executor raises the degrade to its caller
        bare = Executor(holder, device_policy="always")
        health = DeviceHealth(timeout_s=60.0, device=torch.device("cpu"))
        ex = Executor(holder, device_policy="auto", health=health, auto_min_containers=1)
        try:
            self._oom_every(monkeypatch, 1)
            with pytest.raises(DeviceOom):
                bare.execute("i", GAUNTLET)
            base = metrics.snapshot().get("device.oom_cpu_degrades", 0)
            assert ex.execute("i", GAUNTLET) == want
            assert ex._oom.stats()["degraded"] >= 1
            assert ex.fuser.bypasses.get("device", 0) == 1
            assert metrics.snapshot().get("device.oom_cpu_degrades", 0) > base
            assert ex._cpu_forced()  # the cooldown holds the CPU leg
            launches = ex.fuser.stats()["fused_launches"]
            assert ex.execute("i", GAUNTLET) == want
            assert ex.fuser.stats()["fused_launches"] == launches
            assert ex.fuser.bypasses.get("cpu", 0) >= 1
        finally:
            bare.close()
            ex.close()
            health.close()
            oracle.close()


# -- observability ------------------------------------------------------------


class TestObservability:
    def test_fusion_metrics_emitted(self, holder):
        seed_mixed(holder)
        base = metrics.snapshot().get(metrics.FUSION_FUSED_LAUNCHES, 0)
        ex = Executor(holder, device_policy="always")
        try:
            ex.execute("i", "Count(Row(f=1))Count(Row(f=2))")
        finally:
            ex.close()
        snap = metrics.snapshot()
        assert snap.get(metrics.FUSION_FUSED_LAUNCHES, 0) > base
        assert any(k.startswith(metrics.FUSION_BYTES_RETURNED) for k in snap)

    def test_stats_shape(self, holder):
        seed_mixed(holder, n_shards=1)
        ex = Executor(holder, device_policy="always", plan_cache=PlanCache())
        try:
            ex.execute("i", "Count(Row(f=1))Count(Row(f=2))")
            st = ex.fuser.stats()
            for key in (
                "enabled", "max_calls", "fused_launches", "fused_calls",
                "avg_calls_per_launch", "bytes_returned", "cache_served",
                "programs", "bypasses", "device_cache",
            ):
                assert key in st, key
            assert st["device_cache"]["enabled"] is True
            assert st["device_cache"]["max_bytes"] > 0
        finally:
            ex.close()


class TestServerSurface:
    def _mkserver(self, tmp_path, **cfg_kwargs):
        from pilosa_tpu_torch.server import Config, Server

        cfg = Config(
            data_dir=str(tmp_path / "data"),
            bind="127.0.0.1:0",
            metric="expvar",
            device="cpu",
            device_policy="never",
            device_timeout=0,
            **cfg_kwargs,
        )
        s = Server(cfg)
        s.open()
        return s

    def _get(self, s, path):
        with urllib.request.urlopen(s.uri + path) as resp:
            return resp.read()

    def test_debug_fusion_endpoint_and_config_knobs(self, tmp_path):
        s = self._mkserver(tmp_path, fusion_max_calls=32)
        try:
            assert s.executor.fuser is not None
            assert s.executor.fuser.max_calls == 32
            snap = json.loads(self._get(s, "/debug/fusion"))
            assert snap["enabled"] is True
            for key in ("fused_launches", "bypasses", "device_cache"):
                assert key in snap
            toml = s.config.to_toml()
            assert "fusion-enabled = true" in toml
            assert "fusion-max-calls = 32" in toml
            assert "plan-cache-device-bytes" in toml
        finally:
            s.close()

    def test_fusion_disabled_config(self, tmp_path):
        s = self._mkserver(tmp_path, fusion_enabled=False)
        try:
            assert s.executor.fuser is None
            assert json.loads(self._get(s, "/debug/fusion")) == {"enabled": False}
        finally:
            s.close()


def test_docs_document_fusion_knobs_with_current_defaults():
    """docs/configuration.md names every fusion knob with the default the
    port's Config uses (the reference's), and docs/administration.md
    keeps the Device-resident execution section."""
    from pilosa_tpu_torch.server import Config

    cfg = Config(data_dir="x")
    root = os.path.join(os.path.dirname(__file__), "..", "docs")
    with open(os.path.join(root, "configuration.md")) as f:
        conf = f.read()
    for knob, default in (
        ("fusion-enabled", "true" if cfg.fusion_enabled else "false"),
        ("fusion-max-calls", str(cfg.fusion_max_calls)),
        ("plan-cache-device-bytes", str(cfg.plan_cache_device_bytes)),
        ("plan-cache-enabled", "true" if cfg.plan_cache_enabled else "false"),
    ):
        assert f"| `{knob}` | {default} |" in conf, knob
    with open(os.path.join(root, "administration.md")) as f:
        admin = f.read()
    assert "## Device-resident execution" in admin
    assert "/debug/fusion" in admin


# -- parity with the JAX package ------------------------------------------------


def _norm(results):
    """Results in comparable plain shapes: rows as column lists, ValCounts
    as (val, count)."""
    out = []
    for r in results:
        if hasattr(r, "columns"):
            r = [int(c) for c in r.columns()]
        elif hasattr(r, "val") and hasattr(r, "count"):
            r = (r.val, r.count)
        out.append(r)
    return out


class _Legs:
    """The same data in a ``pilosa_tpu`` holder and a port holder, and
    the three executors: the reference fused, the port fused and the port
    unfused (optionally each with a plan cache)."""

    def __init__(self, cached: bool = False) -> None:
        rows, cols, vcols, vvals = _mixed_data()
        self.jh = JaxHolder()
        self.jh.open()
        jidx = self.jh.create_index("i")
        jidx.create_field("f").import_bits(rows, cols)
        jidx.create_field("v", JaxFieldOptions(type=JAX_INT, min=-50, max=5000)).import_values(vcols, vvals)
        self.th = Holder()
        self.th.open()
        seed_mixed(self.th)
        self.jax = JaxExecutor(
            self.jh, device_policy="always", dispatch_enabled=False,
            plan_cache=JaxPlanCache() if cached else None,
        )
        self.fused = Executor(self.th, device_policy="always", plan_cache=PlanCache() if cached else None)
        self.unfused = Executor(
            self.th, device_policy="always", fusion_enabled=False, plan_cache=PlanCache() if cached else None
        )

    def run(self, q):
        return [_norm(ex.execute("i", q)) for ex in (self.jax, self.fused, self.unfused)]

    def write(self, q):
        self.jax.execute("i", q)
        self.fused.execute("i", q)

    def close(self):
        for ex in (self.jax, self.fused, self.unfused):
            ex.close()


@pytest.mark.parametrize(
    "q",
    [
        pytest.param(UNITS, id="every_unit_in_one_launch"),
        pytest.param("Count(Row(f=1))Count(Intersect(Row(f=1), Row(f=2)))", id="count"),
        pytest.param('Sum(Row(f=1), field="v")Sum(field="v")', id="sum"),
        pytest.param("GroupBy(Rows(f), limit=7)", id="groupby_count"),
        pytest.param("GroupBy(Rows(f, ids=[0, 4, 9]), Rows(f, ids=[2, 3]), Sum(field=v))", id="groupby_sum"),
        pytest.param('Distinct(field="v")Distinct(Row(f=6), field="v")', id="distinct"),
        pytest.param('Percentile(field="v", nth=10)Percentile(Row(f=1), field="v", nth=75.5)', id="percentile"),
        pytest.param("TopN(f, Row(f=3), n=4)TopN(f, Union(Row(f=1), Row(f=2)), n=6)TopN(f, Row(f=7))", id="topn"),
    ],
)
def test_unit_kinds_match_the_reference_fused_and_unfused(q):
    legs = _Legs()
    try:
        ref, fused, unfused = legs.run(q)
        assert fused == ref
        assert unfused == ref
        assert legs.fused.fuser.stats()["fused_launches"] == 1
        assert legs.jax.fuser.stats()["fused_launches"] == 1
    finally:
        legs.close()


def test_cached_subtree_and_writes_match_the_reference():
    """A repeated subtree goes through the ``__cached`` rewrite on every
    cached leg; answers stay == across the three legs while writes land
    on the rows it reads (the plan caches must invalidate)."""
    legs = _Legs(cached=True)
    q = (
        "Count(Intersect(Row(f=1), Row(f=2)))"
        "TopN(f, Intersect(Row(f=1), Row(f=2)), n=5)"
        'Sum(Intersect(Row(f=1), Row(f=2)), field="v")'
        'Distinct(Intersect(Row(f=1), Row(f=2)), field="v")'
        "GroupBy(Rows(f, ids=[1, 2, 3]), Intersect(Row(f=1), Row(f=2)))"
    )
    try:
        rng = np.random.default_rng(31)
        first = None
        for step in range(6):
            ref, fused, unfused = legs.run(q)
            assert fused == ref, step
            assert unfused == ref, step
            first = first or ref
            col = int(rng.integers(0, 3 * SHARD_WIDTH))
            legs.write(f"Set({col}, f=1)Set({col}, f=2)")
            legs.write(f'SetValue(col={col}, v={int(rng.integers(-50, 5000))})')
        assert ref != first
        assert legs.fused.plan_cache.stats()["invalidations"] > 0
        assert legs.fused.device_cache.stats()["inserts"] > 0
        assert legs.fused.fuser.stats()["fused_launches"] >= 6
    finally:
        legs.close()


@pytest.mark.parametrize("depth", [0, 3, 6, 9])
@pytest.mark.parametrize("has_filter", [False, True])
def test_distinct_presence_plain_matches_jax(depth, has_filter):
    rng = np.random.default_rng(depth * 2 + has_filter)
    planes = rng.integers(0, 2**32, size=(3, depth + 1, 64), dtype=np.uint32)
    planes[1, depth] = 0
    filt = rng.integers(0, 2**32, size=(3, 64), dtype=np.uint32) & rng.integers(0, 2**32, size=(3, 64), dtype=np.uint32)
    want = np.asarray(
        jops.bsi_distinct_presence(jnp.asarray(planes), jnp.asarray(filt), bit_depth=depth, has_filter=has_filter)
    )
    tp, tf = ops.words_from_numpy(planes, "cpu"), ops.words_from_numpy(filt, "cpu")
    got = ops.bsi_distinct_presence_plain(tp, tf if has_filter else None, depth)
    assert got.numpy().view("<u4").tolist() == want.tolist()
    pub = ops.bsi_distinct_presence(tp, tf, bit_depth=depth, has_filter=has_filter)
    assert pub.numpy().view("<u4").tolist() == want.tolist()


@pytest.mark.parametrize("n_shards,chunk", [(1, 128), (3, 128), (3, 16)])
def test_sparse_stacked_mat_matches_jax(n_shards, chunk):
    rng = np.random.default_rng(n_shards * 100 + chunk)
    w = 4 * 2048
    srcs = rng.integers(0, 2**32, size=(n_shards, w), dtype=np.uint32)
    b = 200
    blocks = rng.integers(0, 2**32, size=(b, 2048), dtype=np.uint32)
    num_rows = n_shards * chunk
    brow = rng.integers(0, num_rows, size=b).astype(np.int32)
    bslot = rng.integers(0, w // 2048, size=b).astype(np.int32)
    bshard = (brow // chunk).astype(np.int32)
    want = np.asarray(
        jops.sparse_intersection_counts_stacked_mat(
            jnp.asarray(srcs), jnp.asarray(blocks), jnp.asarray(brow), jnp.asarray(bslot), jnp.asarray(bshard),
            num_rows=num_rows, n_shards=n_shards, chunk=chunk,
        )
    )
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view("<i4"))  # noqa: E731
    got = ops.sparse_intersection_counts_stacked_mat(
        t(srcs), t(blocks), t(brow), t(bslot), t(bshard), num_rows, n_shards, chunk
    )
    assert got.shape == (n_shards, chunk)
    assert got.numpy().tolist() == want.tolist()
