"""The port's plan result cache (plan/cache.py + plan/planner.py +
executor wiring): every single-node case of ``tests/test_plan_cache.py``
run on ``pilosa_tpu_torch`` — whole-call caching with generation-vector
validity, CSE subtree substitution, singleflight, byte-accounted LRU
eviction, epoch resets, the cache=false opt-out, write-path invalidation
completeness, and the randomized read/write interleaving (cached vs
uncached oracle, 0 mismatches). Executors run on ``device="cpu"``: the
device legs run the kernels' plain versions."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from pilosa_tpu_torch import SHARD_WIDTH
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.executor import ExecOptions
from pilosa_tpu_torch.executor import Executor as _Executor
from pilosa_tpu_torch.plan.cache import PlanCache
from pilosa_tpu_torch.utils import metrics


def Executor(h, **kw):
    """The port's executor on the CPU (the device legs' plain versions)."""
    return _Executor(h, device="cpu", **kw)


@pytest.fixture()
def holder():
    h = Holder()  # in-memory
    h.open()
    return h


def seed(h, index="i", field="f", rows=8, bits=24):
    idx = h.create_index(index)
    fld = idx.create_field(field)
    r_ids, c_ids = [], []
    for r in range(rows):
        for c in range(bits + r):
            r_ids.append(r)
            c_ids.append((c * 131 + r * 17) % (1 << 20))
            r_ids.append(r)
            c_ids.append(SHARD_WIDTH + (c * 151 + r * 19) % (1 << 20))
    fld.import_bits(r_ids, c_ids)
    return fld


def cached_executor(h, **kw):
    pc = PlanCache(**kw)
    return Executor(h, device_policy="never", plan_cache=pc), pc


def norm(r):
    return r.columns().tolist() if hasattr(r, "columns") else r


# -- whole-call caching -----------------------------------------------------


def test_repeat_query_hits_and_stays_bit_identical(holder):
    seed(holder)
    ex, pc = cached_executor(holder)
    oracle = Executor(holder, device_policy="never")
    qs = [
        "Count(Intersect(Row(f=1), Row(f=2)))",
        "TopN(f, Row(f=3), n=4)",
        "Union(Row(f=1), Row(f=4))",
        "Sum(Row(f=2), field=f)",
    ]
    for _ in range(3):
        for q in qs:
            (got,) = ex.execute("i", q)
            (want,) = oracle.execute("i", q)
            assert str(norm(got)) == str(norm(want)), q
    st = pc.stats()
    assert st["misses"] == len(qs)
    assert st["hits"] >= 2 * len(qs)
    assert st["bytes"] > 0


def test_permuted_and_nested_spellings_share_one_entry(holder):
    seed(holder)
    ex, pc = cached_executor(holder)
    ex.execute("i", "Count(Intersect(Row(f=1), Row(f=2)))")
    ex.execute("i", "Count(Intersect(Row(f=2), Row(f=1)))")
    ex.execute("i", "Count(Union(Row(f=1), Union(Row(f=2), Row(f=3))))")
    ex.execute("i", "Count(Union(Row(f=3), Row(f=2), Row(f=1)))")
    st = pc.stats()
    assert st["misses"] == 2 and st["hits"] == 2


def test_same_schema_indexes_never_share_entries(holder):
    """Regression: cache keys carry the index name. Two indexes with
    identical field names and matching generation counts (same-schema
    tenant indexes right after a restart — generations start at 0 per
    process) must never serve each other's results. One bulk import
    each keeps the generation vectors identical while the data differs."""
    holder.create_index("tenant_a").create_field("f").import_bits([1], [10])
    holder.create_index("tenant_b").create_field("f").import_bits([1, 1], [20, 21])
    ex, pc = cached_executor(holder)
    q = "Count(Row(f=1))"
    assert ex.execute("tenant_a", q) == [1]
    assert ex.execute("tenant_b", q) == [2]  # the bug served 1 here
    # and both stay per-index on the hot path
    assert ex.execute("tenant_a", q) == [1]
    assert ex.execute("tenant_b", q) == [2]
    st = pc.stats()
    assert st["hits"] == 2 and st["misses"] == 2 and st["entries"] == 2


def test_failed_build_counts_a_miss(holder):
    pc = PlanCache()

    def build():
        raise ValueError("boom")

    with pytest.raises(ValueError):
        pc.get_or_build(("k",), lambda: ("g",), build)
    st = pc.stats()
    assert st["misses"] == 1 and st["entries"] == 0 and st["building"] == 0


def test_write_invalidates_and_result_reflects_new_state(holder):
    fld = seed(holder)
    ex, pc = cached_executor(holder)
    q = "Count(Row(f=1))"
    (before,) = ex.execute("i", q)
    (hit,) = ex.execute("i", q)
    assert hit == before and pc.stats()["hits"] == 1
    assert fld.set_bit(1, 777_777) is True  # new bit
    (after,) = ex.execute("i", q)
    assert after == before + 1
    assert pc.stats()["invalidations"] == 1
    # the new entry is valid again
    (again,) = ex.execute("i", q)
    assert again == after and pc.stats()["hits"] == 2


def test_cache_false_bypasses_lookup_and_insert(holder):
    seed(holder)
    ex, pc = cached_executor(holder)
    opt = ExecOptions(cache=False)
    ex.execute("i", "Count(Row(f=1))", opt=opt)
    ex.execute("i", "Count(Row(f=1))", opt=opt)
    st = pc.stats()
    assert st["hits"] == 0 and st["misses"] == 0 and st["entries"] == 0


def test_uncacheable_calls_never_insert(holder):
    seed(holder)
    ex, pc = cached_executor(holder)
    # writes never touch the cache
    ex.execute("i", "Set(123, f=1)")
    # attr-filtered TopN depends on attr stores (no generation counter):
    # never cached, and its answer is the uncached executor's
    from pilosa_tpu_torch.utils.attrstore import AttrStore

    fld = holder.field("i", "f")
    fld.row_attr_store = AttrStore(None)
    for frag in fld.view(VIEW_STANDARD).fragments.values():
        frag.row_attr_store = fld.row_attr_store
        frag.cache.recalculate()
    for row in (1, 3, 4):
        fld.row_attr_store.set_attrs(row, {"x": 1})
    q = 'TopN(f, Row(f=1), n=2, attrName="x", attrValues=[1])'
    uncached = Executor(holder, device_policy="always")
    try:
        for _ in range(2):
            got = ex.execute("i", q)
            assert got == uncached.execute("i", q) and got[0]
    finally:
        uncached.close()
    assert pc.stats()["entries"] == 0 and pc.stats()["hits"] == 0


def test_attribute_bearing_row_is_never_cached():
    """A top-level Row() on a field with an attribute store carries the
    row's attributes, which no generation counter covers: never cached,
    so a SetRowAttrs shows in the next answer. Excluding the attributes
    makes it cacheable again."""
    from pilosa_tpu_torch.utils.attrstore import AttrStore

    h = Holder(new_attr_store=lambda path: AttrStore(None))
    h.open()
    seed(h)
    ex, pc = cached_executor(h)
    ex.execute("i", 'SetRowAttrs(f, 1, tier="gold")')
    (row,) = ex.execute("i", "Row(f=1)")
    assert row.attrs == {"tier": "gold"}
    ex.execute("i", 'SetRowAttrs(f, 1, tier="silver")')
    (row,) = ex.execute("i", "Row(f=1)")
    assert row.attrs == {"tier": "silver"}
    assert pc.stats()["entries"] == 0 and pc.stats()["hits"] == 0
    opt = ExecOptions(exclude_row_attrs=True)
    first = ex.execute("i", "Row(f=1)", opt=opt)[0]
    again = ex.execute("i", "Row(f=1)", opt=opt)[0]
    assert norm(again) == norm(first) and again.attrs == {}
    assert pc.stats()["hits"] == 1


def test_byte_budget_evicts_lru(holder):
    seed(holder, rows=10)
    # size one entry first, then budget for ~2.5 of them
    ex0, pc0 = cached_executor(holder)
    ex0.execute("i", "Union(Row(f=0), Row(f=1))")
    per_entry = pc0.stats()["bytes"]
    assert per_entry > 0
    budget = int(per_entry * 2.5)
    ex, pc = cached_executor(holder, max_bytes=budget)
    for r in range(8):
        ex.execute("i", f"Union(Row(f={r}), Row(f={(r + 1) % 8}))")
    st = pc.stats()
    assert st["evictions"] > 0
    assert st["bytes"] <= budget
    assert st["entries"] < 8


def test_min_cost_filters_cheap_builds(holder):
    seed(holder)
    ex, pc = cached_executor(holder, min_cost=1e9)  # nothing qualifies
    ex.execute("i", "Count(Row(f=1))")
    ex.execute("i", "Count(Row(f=1))")
    st = pc.stats()
    assert st["entries"] == 0 and st["hits"] == 0 and st["misses"] == 2


def test_returned_rows_are_isolated_from_the_cache(holder):
    seed(holder)
    ex, pc = cached_executor(holder)
    (r1,) = ex.execute("i", "Union(Row(f=1), Row(f=2))")
    r1.set_bit(5)  # caller mutates its copy
    r1.keys = ["x"]
    (r2,) = ex.execute("i", "Union(Row(f=1), Row(f=2))")
    assert pc.stats()["hits"] == 1
    assert not r2.includes_column(5) or r2.includes_column(5) == (
        5 in r1.columns().tolist() and False
    )
    oracle = Executor(holder, device_policy="never")
    (want,) = oracle.execute("i", "Union(Row(f=1), Row(f=2))")
    assert r2.columns().tolist() == want.columns().tolist()


def test_singleflight_builds_once_for_concurrent_duplicates(holder):
    seed(holder)
    pc = PlanCache()
    builds = []
    gate = threading.Event()

    def build():
        builds.append(1)
        gate.wait(5)
        return 42

    key = ("h", (0,), (False, False))
    gv = lambda: ("g",)
    out = []
    ts = [
        threading.Thread(target=lambda: out.append(pc.get_or_build(key, gv, build)))
        for _ in range(6)
    ]
    for t in ts:
        t.start()
    gate.set()
    for t in ts:
        t.join()
    assert out == [42] * 6
    assert len(builds) == 1
    assert pc.stats()["hits"] == 5 and pc.stats()["misses"] == 1


def test_epoch_reset_clears_and_fences(holder):
    seed(holder)
    ex, pc = cached_executor(holder)
    ex.execute("i", "Count(Row(f=1))")
    assert pc.stats()["entries"] == 1
    ex._on_device_restore()  # the wedge-recovery hook
    st = pc.stats()
    assert st["entries"] == 0 and st["bytes"] == 0 and st["epoch"] == 1


# -- CSE: intra-query dedupe + cached-subtree feeding -----------------------


def test_repeated_subtree_across_calls_builds_once(holder):
    seed(holder)
    ex, pc = cached_executor(holder)
    q = (
        "Count(Intersect(Row(f=1), Row(f=2))) "
        "TopN(f, Intersect(Row(f=2), Row(f=1)), n=3)"
    )
    oracle = Executor(holder, device_policy="never")
    w = oracle.execute("i", q)  # expectation BEFORE the spy goes in
    shard_evals = []
    orig = _Executor._bitmap_call_shard_cpu

    def spy(self, index, c, shard):
        shard_evals.append(c.name)
        return orig(self, index, c, shard)

    _Executor._bitmap_call_shard_cpu = spy
    try:
        r = ex.execute("i", q)
    finally:
        _Executor._bitmap_call_shard_cpu = orig
    assert r[0] == w[0] and r[1] == w[1]
    # the shared intersection was evaluated by ONE build: its per-shard
    # Intersect evaluations appear exactly once per shard (2 shards),
    # both consumers read the __cached placeholder instead
    assert shard_evals.count("Intersect") == 2
    assert shard_evals.count("__cached") >= 2


def test_cached_subtree_feeds_parent_only_cold_leg_recomputes(holder):
    seed(holder)
    ex, pc = cached_executor(holder)
    # seed the hot leg as a shared subtree (twice in one query)
    ex.execute(
        "i",
        "Count(Intersect(Row(f=1), Row(f=2))) "
        "Count(Union(Intersect(Row(f=1), Row(f=2)), Row(f=7)))",
    )
    hits0 = pc.stats()["hits"]
    # a NEW query shape containing the hot subtree: the probe feeds the
    # cached rows in; only the cold leg (Row(f=6)) evaluates
    (got,) = ex.execute(
        "i", "Count(Union(Intersect(Row(f=2), Row(f=1)), Row(f=6)))"
    )
    oracle = Executor(holder, device_policy="never")
    (want,) = oracle.execute(
        "i", "Count(Union(Intersect(Row(f=2), Row(f=1)), Row(f=6)))"
    )
    assert got == want
    assert pc.stats()["hits"] > hits0


@pytest.mark.parametrize("policy", ["never", "always"])
def test_cse_bit_identical_on_both_paths(holder, policy):
    seed(holder)
    pc = PlanCache()
    ex = Executor(holder, device_policy=policy, plan_cache=pc)
    oracle = Executor(holder, device_policy=policy)
    q = (
        "Count(Intersect(Row(f=1), Row(f=2))) "
        "Count(Intersect(Row(f=2), Row(f=1))) "
        "TopN(f, Intersect(Row(f=1), Row(f=2)), n=3)"
    )
    for _ in range(2):
        got = ex.execute("i", q)
        want = oracle.execute("i", q)
        assert [str(norm(g)) for g in got] == [str(norm(w)) for w in want]


# -- write-path invalidation completeness ------------------------------------


def _mut_set_bit(h, fld, frag, api):
    fld.set_bit(1, 999_983)


def _mut_clear_bit(h, fld, frag, api):
    cols = frag.row(1).columns()
    assert frag.clear_bit(1, int(cols[0])) is True


def _mut_bulk_import(h, fld, frag, api):
    frag.bulk_import([1, 2, 3], [11, 22, 33])


def _mut_import_value(h, fld, frag, api):
    frag.import_value([5, 6], [3, 9], bit_depth=8)


def _mut_import_block_pairs(h, fld, frag, api):
    frag.import_block_pairs(
        np.array([1, 2], dtype=np.uint64), np.array([401, 402], dtype=np.uint64)
    )


def _mut_api_restore(h, fld, frag, api):
    blob = api.marshal_fragment("i", "f", VIEW_STANDARD, 0)
    api.unmarshal_fragment("i", "f", VIEW_STANDARD, 0, blob)


@pytest.mark.parametrize(
    "mutate",
    [
        _mut_set_bit,
        _mut_clear_bit,
        _mut_bulk_import,
        _mut_import_value,
        _mut_import_block_pairs,
        _mut_api_restore,
    ],
    ids=[
        "set_bit",
        "clear_bit",
        "bulk_import",
        "import_value",
        "import_block_pairs",
        "api_restore",
    ],
)
def test_every_write_path_bumps_generation_and_invalidates(holder, mutate):
    """The cache's correctness contract: EVERY write path bumps the
    fragment generation, and a planted plan-cache entry therefore
    invalidates on the next lookup."""
    from pilosa_tpu_torch.server.api import API

    fld = seed(holder)
    ex, pc = cached_executor(holder)
    api = API(holder, ex)
    frag = holder.fragment("i", "f", VIEW_STANDARD, 0)
    q = "Count(Row(f=1))"
    ex.execute("i", q)  # plant
    (planted_hit,) = ex.execute("i", q)
    assert pc.stats()["hits"] == 1 and pc.stats()["invalidations"] == 0
    gen0 = frag.generation
    mutate(holder, fld, frag, api)
    assert frag.generation > gen0, "write path did not bump the generation"
    (after,) = ex.execute("i", q)
    assert pc.stats()["invalidations"] == 1, "planted entry survived a write"
    oracle = Executor(holder, device_policy="never")
    (want,) = oracle.execute("i", q)
    assert after == want


# -- the acceptance bar: randomized read/write interleaving -----------------


def test_randomized_read_write_interleaving_bit_identical(holder):
    """Cached executor vs uncached oracle over one holder: a seeded
    random interleaving of reads (Zipf-repeated pool) and writes
    (set/clear on the rows the reads touch) shows 0 result mismatches,
    with real hits AND real invalidations observed."""
    fld = seed(holder, rows=10, bits=40)
    ex, pc = cached_executor(holder)
    oracle = Executor(holder, device_policy="never")
    pool = [
        "Count(Intersect(Row(f=1), Row(f=2)))",
        "Count(Union(Row(f=2), Row(f=3), Row(f=4)))",
        "TopN(f, Row(f=1), n=5)",
        "Union(Row(f=3), Row(f=5))",
        "Sum(Row(f=4), field=f)",
        "Count(Difference(Row(f=5), Row(f=1)))",
    ]
    rng = np.random.default_rng(99)
    mismatches = 0
    for step in range(400):
        if rng.random() < 0.15:
            row = int(rng.integers(0, 6))
            col = int(rng.integers(0, 1 << 20))
            if rng.random() < 0.7:
                fld.set_bit(row, col)
            else:
                frag = holder.fragment("i", "f", VIEW_STANDARD, 0)
                frag.clear_bit(row, col)
        else:
            q = pool[int(rng.zipf(1.5)) % len(pool)]
            (got,) = ex.execute("i", q)
            (want,) = oracle.execute("i", q)
            if str(norm(got)) != str(norm(want)):
                mismatches += 1
    assert mismatches == 0
    st = pc.stats()
    assert st["hits"] > 50
    assert st["invalidations"] > 0


# -- server surface: cache=false, /debug/plancache, recalc epoch ------------


def test_http_cache_option_and_debug_endpoint(tmp_path):
    from pilosa_tpu_torch.server import Config, Server

    cfg = Config(
        data_dir=str(tmp_path / "data"),
        bind="127.0.0.1:0",
        device="cpu",
        device_policy="never",
        device_timeout=0,
        metric="none",
    )
    s = Server(cfg)
    s.open()
    try:
        def post(path, body):
            r = urllib.request.Request(s.uri + path, data=body, method="POST")
            with urllib.request.urlopen(r, timeout=30) as resp:
                return json.loads(resp.read() or b"{}")

        def get(path):
            with urllib.request.urlopen(s.uri + path, timeout=30) as resp:
                return json.loads(resp.read())

        post("/index/pcx", b"{}")
        post("/index/pcx/field/f", b"{}")
        post("/index/pcx/query", b"Set(3, f=1) Set(4, f=1)")
        a = post("/index/pcx/query", b"Count(Row(f=1))")
        b = post("/index/pcx/query", b"Count(Row(f=1))")
        assert a == b == {"results": [2]}
        snap = get("/debug/plancache")
        assert snap["enabled"] is True
        assert snap["hits"] >= 1 and snap["entries"] >= 1
        # cache=false bypasses (hit count stays put)
        hits0 = get("/debug/plancache")["hits"]
        post("/index/pcx/query?cache=false", b"Count(Row(f=1))")
        assert get("/debug/plancache")["hits"] == hits0
        # recalculate-caches bumps the epoch (rank reorders can change
        # TopN walks without a generation bump)
        epoch0 = get("/debug/plancache")["epoch"]
        post("/recalculate-caches", b"")
        snap = get("/debug/plancache")
        assert snap["epoch"] == epoch0 + 1 and snap["entries"] == 0
    finally:
        s.close()


def test_plancache_metrics_flow_to_registry(holder):
    seed(holder)
    before = metrics.snapshot().get(metrics.PLANCACHE_HITS, 0)
    ex, pc = cached_executor(holder)
    ex.execute("i", "Count(Row(f=2))")
    ex.execute("i", "Count(Row(f=2))")
    snap = metrics.snapshot()
    assert snap.get(metrics.PLANCACHE_HITS, 0) >= before + 1
    assert metrics.PLANCACHE_BYTES in snap
