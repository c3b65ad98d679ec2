"""The port's BSI and analytics legs end to end against the JAX package's.

One small data directory is written through ``pilosa_tpu``'s own
Holder and opened by both packages (the port with ``holder_from_dir``):
3 shards; three set fields (``seg``, ``dev``, ``tier``); int fields
``v`` (min -50, max 900: a 10-bit depth) and ``w`` (min 0, max 100); a
time-quantum field ``t``. Every Sum/Min/Max/Range/GroupBy/Distinct/
Percentile query runs through ``pilosa_tpu.executor.Executor(device_policy=
"always")``, the port's ``Executor(device="cpu", device_policy="always")``
(the kernels' plain versions) and the port's CPU roaring leg
(``device_policy="never"``); the three answers must be identical.
"""

import shutil

import numpy as np
import pytest

from pilosa_tpu.core import FieldOptions as JaxFieldOptions
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor

import pilosa_tpu_torch
from pilosa_tpu_torch.executor import analytics
from pilosa_tpu_torch.ops import bsi, packed
from pilosa_tpu_torch.utils import metrics

SW = 1 << 20
NCOLS = 3000
VMIN, VMAX = -50, 900


def _build(path) -> None:
    rng = np.random.default_rng(2024)
    h = JaxHolder(str(path))
    h.open()
    idx = h.create_index("i")
    fields = {name: idx.create_field(name) for name in ("seg", "dev", "tier")}
    v = idx.create_field("v", JaxFieldOptions(type="int", min=VMIN, max=VMAX))
    w = idx.create_field("w", JaxFieldOptions(type="int", min=0, max=100))
    t = idx.create_field("t", JaxFieldOptions(type="time", time_quantum="YMD"))
    cols = rng.choice(3 * SW, size=NCOLS, replace=False)
    for name, nrows in (("seg", 5), ("dev", 4), ("tier", 3)):
        fields[name].import_bits(rng.integers(0, nrows, size=NCOLS).tolist(), cols.tolist())
    vcols = cols[rng.random(NCOLS) < 0.85]
    vvals = rng.integers(VMIN, VMAX + 1, size=vcols.size)
    vvals[:7] = VMIN  # several columns hold the minimum and maximum
    vvals[7:12] = VMAX
    v.import_values(vcols.tolist(), vvals.tolist())
    wcols = cols[rng.random(NCOLS) < 0.6]
    w.import_values(wcols.tolist(), rng.integers(0, 101, size=wcols.size).tolist())
    from datetime import datetime

    tcols = cols[:600]
    stamps = [datetime(2010, 1, 1 + int(d)) for d in rng.integers(0, 6, size=tcols.size)]
    t.import_bits([1] * tcols.size, tcols.tolist(), stamps)
    h.close()


def _plain(results):
    out = []
    for r in results:
        if hasattr(r, "columns"):
            r = [int(c) for c in r.columns()]
        elif hasattr(r, "val") and hasattr(r, "count"):
            r = ("vc", r.val, r.count)
        out.append(r)
    return out


class _Sides:
    def __init__(self, base, tmp) -> None:
        jdir, tdir = tmp / "jax", tmp / "torch"
        shutil.copytree(base, jdir)
        shutil.copytree(base, tdir)
        self.jh = JaxHolder(str(jdir))
        self.jh.open()
        self.th = pilosa_tpu_torch.holder_from_dir(str(tdir))
        self.jax = JaxExecutor(self.jh, device_policy="always")
        self.dev = pilosa_tpu_torch.Executor(self.th, device="cpu", device_policy="always")
        self.cpu = pilosa_tpu_torch.Executor(self.th, device="cpu", device_policy="never")

    def run(self, q, index="i"):
        return [_plain(ex.execute(index, q)) for ex in (self.jax, self.dev, self.cpu)]

    def close(self) -> None:
        for ex in (self.jax, self.dev, self.cpu):
            ex.close()
        self.jh.close()
        self.th.close()


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = tmp_path_factory.mktemp("bsi_holder")
    _build(d)
    return d


@pytest.fixture(scope="module")
def sides(base, tmp_path_factory):
    s = _Sides(base, tmp_path_factory.mktemp("bsi_shared"))
    yield s
    s.close()


@pytest.fixture
def legs(monkeypatch):
    """Which plain kernel versions a query ran: "groupby" (K4) with its
    (K, P), "range" (K5)."""
    seen = []
    real_gb, real_rg = packed.groupby_reduce_plain, bsi.bsi_range_plain

    def gb(dims, filt, planes):
        out = real_gb(dims, filt, planes)
        seen.append(("groupby", tuple(out[1].shape)))
        return out

    def rg(planes, code, out_sel):
        seen.append(("range", len(code)))
        return real_rg(planes, code, out_sel)

    monkeypatch.setattr(packed, "groupby_reduce_plain", gb)
    monkeypatch.setattr(bsi, "bsi_range_plain", rg)
    return seen


def _same(sides, q):
    jax_ans, dev_ans, cpu_ans = sides.run(q)
    assert dev_ans == jax_ans == cpu_ans, q
    return dev_ans[0]


SUMS = [
    "Sum(field=v)",
    "Sum(Row(seg=1), field=v)",
    "Sum(Range(w > 50), field=v)",
    "Sum(Intersect(Row(dev=2), Range(v >< [100, 500])), field=w)",
    "Sum(Row(seg=99), field=v)",
]


@pytest.mark.parametrize("q", SUMS)
def test_sum_runs_on_k4(sides, legs, q):
    ans = _same(sides, q)
    assert ans[0] == "vc"
    assert [kind for kind, _ in legs if kind == "groupby"] == ["groupby"]
    # one group (the filter), one count per plane
    assert dict(legs)["groupby"][0] == 1


MINMAX = [
    "Min(field=v)",
    "Max(field=v)",
    "Min(Row(seg=3), field=v)",
    "Max(Row(tier=0), field=w)",
    "Min(Range(w < 10), field=v)",
    "Max(Row(seg=99), field=v)",
]


@pytest.mark.parametrize("q", MINMAX)
def test_min_max(sides, q):
    _same(sides, q)


# (query, runs the range kernel): predicates that select nothing or all
# not-null columns read no plane program
RANGES = [
    ("Count(Range(v == 17))", True),
    ("Count(Range(v != 17))", True),
    ("Count(Range(v < 300))", True),
    ("Count(Range(v <= 300))", True),
    ("Count(Range(v > -20))", True),
    ("Count(Range(v >= -20))", True),
    ("Count(Range(v >< [-10, 250]))", True),
    ("Count(Range(v != null))", False),
    ("Count(Range(v == -50))", True),
    ("Count(Range(v < -50))", True),
    ("Count(Range(v <= 900))", False),
    ("Count(Range(v > 900))", True),
    # out-of-range predicates
    ("Count(Range(v == 5000))", False),
    ("Count(Range(v != 5000))", False),
    ("Count(Range(v < -100))", False),
    ("Count(Range(v > 2000))", False),
    ("Count(Range(v >< [-1000, 2000]))", False),
    ("Count(Range(v >< [2000, 3000]))", False),
    ("Count(Range(v >< [300, 100]))", True),
]


@pytest.mark.parametrize("q,kernel", RANGES)
def test_range_count(sides, legs, q, kernel):
    n = _same(sides, q)
    assert isinstance(n, int)
    assert (("range", 10) in legs) == kernel, q


CHAINS_AND_ROWS = [
    "Count(Intersect(Row(seg=2), Range(v < 300)))",
    "Count(Union(Range(v > 800), Range(w == 3), Row(tier=1)))",
    "Count(Difference(Row(dev=0), Range(v >< [0, 400])))",
    "Range(v > 850)",
    "Intersect(Row(seg=1), Range(w <= 20))",
    "Count(Range(t=1, 2010-01-02T00:00, 2010-01-04T00:00))",
    "Range(t=1, 2010-01-01T00:00, 2010-01-03T00:00)",
    "Count(Intersect(Row(seg=0), Range(t=1, 2010-01-01T00:00, 2010-02-01T00:00)))",
]


@pytest.mark.parametrize("q", CHAINS_AND_ROWS)
def test_range_leaves_in_chains_and_rows(sides, q):
    ans = _same(sides, q)
    assert ans if isinstance(ans, list) else ans > 0


GROUPBYS = [
    "GroupBy(Rows(seg), Rows(dev))",
    "GroupBy(Rows(seg), Rows(dev), Sum(field=v))",
    "GroupBy(Rows(seg, ids=[3, 1]), Rows(dev), Row(tier=2), Sum(field=v))",
    "GroupBy(Rows(seg), Rows(dev), Rows(tier), Sum(field=w), limit=7)",
    "GroupBy(Rows(tier), Range(v > 400))",
    "GroupBy(Rows(seg), Range(t=1, 2010-01-01T00:00, 2010-01-04T00:00), Sum(field=v))",
    "GroupBy(Rows(seg, ids=[0, 77]), Rows(dev, ids=[2]), Sum(field=v))",
]


@pytest.mark.parametrize("q", GROUPBYS)
def test_groupby_runs_on_k4(sides, legs, q):
    groups = _same(sides, q)
    assert groups and all(g["count"] > 0 for g in groups)
    ks = [shape for kind, shape in legs if kind == "groupby"]
    assert len(ks) == 1, legs
    if "Sum" in q:
        assert ks[0][1] > 0


ANALYTICS = [
    "Distinct(field=v)",
    "Distinct(Row(seg=4), field=v)",
    "Distinct(Range(v > 800), field=w)",
    "Percentile(field=v, nth=50)",
    "Percentile(field=v, nth=99.9)",
    "Percentile(field=v, nth=0)",
    "Percentile(field=v, nth=100)",
    "Percentile(Row(dev=1), field=w, nth=95)",
    "Percentile(Row(seg=99), field=v, nth=50)",
]


@pytest.mark.parametrize("q", ANALYTICS)
def test_distinct_and_percentile(sides, q):
    ans = _same(sides, q)
    assert ans != [] or "99" in q


def test_rows_outside_groupby_raises(sides):
    from pilosa_tpu_torch.pql import Call, Query

    for ex in (sides.dev, sides.cpu):
        with pytest.raises(ValueError, match="inside GroupBy"):
            ex.execute("i", Query([Call("Rows", {"_field": "seg"})]))


def test_only_attribute_calls_stay_unported(sides):
    from pilosa_tpu_torch.executor.executor import _UNPORTED

    assert sorted(_UNPORTED) == ["SetColumnAttrs", "SetRowAttrs"]
    with pytest.raises(NotImplementedError, match="A9"):
        sides.dev.execute("i", "SetRowAttrs(seg, 1, x=1)")


def test_device_analytics_do_not_degrade(sides):
    before = metrics.snapshot().get(metrics.ANALYTICS_DEGRADED_LEGS, 0)
    for q in GROUPBYS + ANALYTICS:
        sides.dev.execute("i", q)
    assert metrics.snapshot().get(metrics.ANALYTICS_DEGRADED_LEGS, 0) == before


def test_set_value_restages_and_reads_back(base, tmp_path):
    s = _Sides(base, tmp_path)
    try:
        queries = ["Sum(field=v)", "Count(Range(v == 77))", "Max(field=w)",
                   "GroupBy(Rows(seg), Sum(field=v))", "Percentile(field=v, nth=50)"]
        before = [s.run(q) for q in queries]
        applies = s.dev.stager.delta_applies
        col = 2 * SW + 12345
        for ex in (s.jax, s.dev):
            ex.execute("i", f"Set({col}, seg=1)")
            assert ex.execute("i", f"SetValue(col={col}, v=77)") == [None]
            ex.execute("i", f"SetValue(col={col}, w=100)")
        after = [s.run(q) for q in queries]
        for b, a in zip(before, after):
            assert b[0] == b[1] == b[2] and a[0] == a[1] == a[2]
        assert after[1][0][0] == before[1][0][0] + 1
        assert after[2][0][0][1] == 100
        assert after[0][0] != before[0][0]
        # the staged planes and rows took the writes as delta scatters
        assert s.dev.stager.delta_applies > applies
    finally:
        s.close()


DEEP = 1 << 40


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """An int field of bit depth 41: predicates past 32 bits."""
    d = tmp_path_factory.mktemp("deep")
    h = JaxHolder(str(d))
    h.open()
    idx = h.create_index("d")
    f = idx.create_field("v", JaxFieldOptions(type="int", min=0, max=DEEP))
    rng = np.random.default_rng(41)
    cols = rng.choice(2 * SW, size=2000, replace=False)
    vals = rng.integers(0, DEEP + 1, size=cols.size)
    vals[:5] = (1 << 32) + 9
    vals[5:8] = DEEP
    f.import_values(cols.tolist(), vals.tolist())
    h.close()
    jh = JaxHolder(str(d))
    jh.open()
    th = pilosa_tpu_torch.holder_from_dir(str(d))
    exs = (
        JaxExecutor(jh, device_policy="never"),
        pilosa_tpu_torch.Executor(th, device="cpu", device_policy="always"),
        pilosa_tpu_torch.Executor(th, device="cpu", device_policy="never"),
    )
    yield exs
    for ex in exs:
        ex.close()
    jh.close()
    th.close()


B = (1 << 36) + 12345


@pytest.mark.parametrize(
    "q",
    [
        f"Count(Range(v == {(1 << 32) + 9}))",
        f"Count(Range(v >< [{B}, {4 * B}]))",
        f"Count(Range(v < {3 * B}))",
        f"Count(Range(v >= {DEEP}))",
        f"Count(Range(v != {(1 << 32) + 9}))",
        "Sum(field=v)",
        "Max(field=v)",
        "Percentile(field=v, nth=50)",
    ],
)
def test_deep_field_predicates(deep, q):
    """The port answers 64-bit predicates as both CPU legs do (the JAX
    package's CPU leg and the port's); the JAX device path raises
    OverflowError on the first two (ROADMAP C)."""
    jax_cpu, dev, cpu = deep
    got = [_plain(ex.execute("d", q)) for ex in (jax_cpu, dev, cpu)]
    assert got[1] == got[0] == got[2]
    if "==" in q:
        assert got[0] == [5]


@pytest.fixture(scope="module", params=[1, 3], ids=["1shard", "3shards"])
def dup_ids(request, tmp_path_factory):
    """ROADMAP C2's smallest input: one set field ``seg`` whose row 1
    holds column 7 of each of 1 or 3 shards, and row 2 column 9 of the
    first. Yields (JAX always leg, the port's legs, seg's rows as numpy
    column sets)."""
    shards = request.param
    d = tmp_path_factory.mktemp(f"dup{shards}")
    h = JaxHolder(str(d))
    h.open()
    seg = h.create_index("c").create_field("seg")
    rows = {1: np.array([s * SW + 7 for s in range(shards)]), 2: np.array([9])}
    for r, cols in rows.items():
        seg.import_bits([r] * cols.size, cols.tolist())
    h.close()
    jh = JaxHolder(str(d))
    jh.open()
    th = pilosa_tpu_torch.holder_from_dir(str(d))
    jax_dev = JaxExecutor(jh, device_policy="always")
    port = [pilosa_tpu_torch.Executor(th, device="cpu", device_policy=p) for p in ("always", "never")]
    yield jax_dev, port, rows
    for ex in [jax_dev, *port]:
        ex.close()
    jh.close()
    th.close()


def _groupby_oracle(rows, ids, limit=None) -> list:
    """numpy: one group per distinct id in first-occurrence order, its
    column count, empty groups dropped, then ``limit``."""
    out = [
        {"group": [{"field": "seg", "rowID": r}], "count": int(np.unique(rows.get(r, [])).size)}
        for r in dict.fromkeys(ids)
    ]
    out = [g for g in out if g["count"]]
    return out[:limit] if limit else out


@pytest.mark.parametrize(
    "ids,limit",
    [([1, 1], None), ([2, 1, 2, 1], None), ([1, 2, 1], 1), ([1], None), ([2, 1], None)],
)
def test_groupby_repeated_ids_count_distinct_groups(dup_ids, ids, limit):
    """ROADMAP C2: repeated explicit ids make one group, ranked by their
    first position, on every leg of the port (1 shard: the ``always`` leg
    runs on the CPU path; 3 shards: on the GroupBy kernel's plain
    version). With distinct ids the port also equals the JAX package,
    whose legs disagree with each other on repeats (its fault)."""
    jax_dev, port, rows = dup_ids
    q = f"GroupBy(Rows(seg, ids=[{', '.join(map(str, ids))}])" + (f", limit={limit}" if limit else "") + ")"
    want = [_groupby_oracle(rows, ids, limit)]
    for ex in port:
        # analytics-max-groups bounds the distinct groups
        ex.analytics_max_groups = len(set(ids))
        try:
            assert ex.execute("c", q) == want, q
        finally:
            ex.analytics_max_groups = analytics.DEFAULT_MAX_GROUPS
    if len(set(ids)) == len(ids):
        assert jax_dev.execute("c", q) == want, q


MM_MIN, MM_MAX = -1000, 1000


@pytest.fixture(scope="module")
def minmax_sides(tmp_path_factory):
    """5 shards of ``seg``; the int field ``v`` (min -1000) holds values in
    shards 0, 2 and 3 only. The minimum -1000 sits in shards 0 (2
    columns) and 2 (3 columns), the maximum 1000 in shards 2 (1) and 3
    (4): ties across shards."""
    d = tmp_path_factory.mktemp("minmax_holder")
    rng = np.random.default_rng(808)
    h = JaxHolder(str(d))
    h.open()
    idx = h.create_index("i")
    seg = idx.create_field("seg")
    v = idx.create_field("v", JaxFieldOptions(type="int", min=MM_MIN, max=MM_MAX))
    cols = np.concatenate([s * SW + rng.choice(SW, size=400, replace=False) for s in range(5)])
    seg.import_bits(rng.integers(0, 4, size=cols.size).tolist(), cols.tolist())
    vcols, vvals = [], []
    for shard, lows, highs in ((0, 2, 0), (2, 3, 1), (3, 0, 4)):
        c = cols[shard * 400 : (shard + 1) * 400]
        x = rng.integers(MM_MIN + 1, MM_MAX, size=c.size)
        x[:lows] = MM_MIN
        x[lows : lows + highs] = MM_MAX
        vcols += c.tolist()
        vvals += x.tolist()
    v.import_values(vcols, vvals)
    h.close()
    s = _Sides(d, tmp_path_factory.mktemp("minmax_shared"))
    yield s
    s.close()


@pytest.mark.parametrize(
    "q",
    [
        "Min(field=v)",
        "Max(field=v)",
        "Min(Row(seg=1), field=v)",
        "Max(Row(seg=2), field=v)",
        "Max(Range(v < 0), field=v)",
        "Min(Range(v > 0), field=v)",
        "Min(Row(seg=9), field=v)",
    ],
)
def test_min_max_batched_leg_matches_jax(minmax_sides, monkeypatch, q):
    """Min/Max over every shard take the port's batched leg: one K8
    recurrence per shard in one launch (its plain version here), folded
    in shard order; the answers equal the JAX executor's and the CPU
    leg's, negative minimum, ties and value-less shards included."""
    seen = []
    real = bsi.bsi_minmax_plain

    def spy(planes, filt, is_min):
        seen.append(planes.shape[0])
        return real(planes, filt, is_min)

    monkeypatch.setattr(bsi, "bsi_minmax_plain", spy)
    ans = _same(minmax_sides, q)
    assert seen == [5], q
    if q == "Min(field=v)":
        assert ans == ("vc", MM_MIN, 2)
    if q == "Max(field=v)":
        assert ans == ("vc", MM_MAX, 1)
