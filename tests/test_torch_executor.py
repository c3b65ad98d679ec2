"""The port's executor end to end against the JAX package's.

One small data directory is built with ``pilosa_tpu``'s own writer and
opened by both packages (the port with ``holder_from_dir``):

  * ``tall``  — 3 shards: hot rows in every shard, medium rows, and a
    singleton tail. Multi-shard TopN takes the stacked block-sparse leg
    and Count(chain) the fused tree count;
  * ``dense`` — 1 shard whose rows fill every container: TopN takes the
    dense ``_LazyScores`` chunk;
  * ``one``   — 1 shard, hot rows plus a tail: TopN takes the
    single-shard block-sparse chunk.

Every query runs through ``pilosa_tpu.executor.Executor(device_policy=
"always")``, the port's ``Executor(device="cpu", device_policy=
"always")`` (the kernels' plain versions) and the port's CPU roaring leg
(``device_policy="never"``); the three answers must be identical.
"""

import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.roaring import build_fragment_file

import pilosa_tpu_torch
from pilosa_tpu_torch.ops import packed

SW = 1 << 20


def _frag_positions(shard: int, hot: int, hot_bits: int, medium: bool, tail: int):
    pos = []
    for h in range(hot):
        rng = np.random.default_rng(h * 100003 + shard)
        pos.append(np.uint64(h * SW) + rng.integers(0, SW, size=hot_bits, dtype=np.uint64))
    if medium:
        rng = np.random.default_rng(7 + shard)
        for m in range(10, 18):
            cols = rng.integers(0, 1 << 16, size=300, dtype=np.uint64) + np.uint64((m % 16) << 16)
            pos.append(np.uint64(m * SW) + cols)
    rows = np.arange(64 + shard * tail, 64 + (shard + 1) * tail, dtype=np.uint64)
    pos.append(rows * np.uint64(SW) + (rows * np.uint64(2654435761)) % np.uint64(SW))
    return np.unique(np.concatenate(pos))


def _build(base) -> None:
    layout = {
        "tall": [_frag_positions(s, 8, 20000, True, 100) for s in range(3)],
        "dense": [_frag_positions(0, 40, 6000, False, 0)],
        "one": [_frag_positions(0, 4, 20000, False, 200)],
    }
    for index, frags in layout.items():
        vdir = base / index / "f" / "views" / "standard" / "fragments"
        vdir.mkdir(parents=True)
        for shard, positions in enumerate(frags):
            build_fragment_file(str(vdir / str(shard)), [positions])


def _open_pair(base, tmp):
    """(JAX holder, port holder) over two private copies of ``base``."""
    jdir, tdir = tmp / "jax", tmp / "torch"
    shutil.copytree(base, jdir)
    shutil.copytree(base, tdir)
    jh = JaxHolder(str(jdir))
    jh.open()
    return jh, pilosa_tpu_torch.holder_from_dir(str(tdir))


class _Sides:
    def __init__(self, jh, th) -> None:
        self.jh, self.th = jh, th
        self.jax = JaxExecutor(jh, device_policy="always")
        self.dev = pilosa_tpu_torch.Executor(th, device="cpu", device_policy="always")
        self.cpu = pilosa_tpu_torch.Executor(th, device="cpu", device_policy="never")

    def run(self, index, q):
        """The three answers, rows as column lists."""
        return [_plain(ex.execute(index, q)) for ex in (self.jax, self.dev, self.cpu)]

    def close(self) -> None:
        for ex in (self.jax, self.dev, self.cpu):
            ex.close()
        self.jh.close()
        self.th.close()


def _plain(results):
    out = []
    for r in results:
        if hasattr(r, "columns"):
            r = [int(c) for c in r.columns()]
        out.append(r)
    return out


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = tmp_path_factory.mktemp("holder")
    _build(d)
    return d


@pytest.fixture(scope="module")
def sides(base, tmp_path_factory):
    s = _Sides(*_open_pair(base, tmp_path_factory.mktemp("shared")))
    yield s
    s.close()


@pytest.fixture
def legs(monkeypatch):
    """Which plain kernel versions a query ran, with their source shapes:
    [("dense", Q) | ("sparse", S) | ("tree", nleaves)]."""
    seen = []

    def spy(kind, fn, shape_of):
        def wrapped(*a, **kw):
            seen.append((kind, shape_of(*a)))
            return fn(*a, **kw)

        monkeypatch.setattr(packed, fn.__name__, wrapped)

    spy("dense", packed.intersection_counts_matrix_plain, lambda srcs, mat: srcs.shape[0])
    spy("sparse", packed.sparse_stacked_scores_plain, lambda srcs, *rest: srcs.shape[1])
    spy("tree", packed.tree_count_plain, lambda lv, prog: prog.nleaves)
    return seen


TALL_TOPN = [
    "TopN(f, Row(f=1), n=5)",
    "TopN(f, Row(f=2))",
    "TopN(f, Row(f=3), ids=[1, 2, 5, 12, 70, 170])",
    "TopN(f, Row(f=0), n=3, threshold=400)",
    "TopN(f, Union(Row(f=4), Row(f=12)), n=4)",
]


@pytest.mark.parametrize("q", TALL_TOPN)
def test_topn_multi_shard_stacked_sparse(sides, legs, q):
    jax_ans, dev_ans, cpu_ans = sides.run("tall", q)
    assert dev_ans == jax_ans == cpu_ans
    assert jax_ans[0], "the query must rank something"
    assert ("sparse", 3) in legs and ("dense", 1) not in legs


@pytest.mark.parametrize(
    "index,q,leg",
    [
        ("dense", "TopN(f, Row(f=3), n=7)", "dense"),
        ("dense", "TopN(f, Row(f=0), ids=[1, 4, 9, 39])", "dense"),
        ("one", "TopN(f, Row(f=1), n=3)", "sparse"),
        ("one", "TopN(f, Row(f=2))", "sparse"),
    ],
)
def test_topn_single_shard_chunks(sides, legs, index, q, leg):
    jax_ans, dev_ans, cpu_ans = sides.run(index, q)
    assert dev_ans == jax_ans == cpu_ans
    assert jax_ans[0]
    assert legs and all(kind == leg for kind, _ in legs if kind != "tree")


CHAINS = [
    # bench_tall._queries()'s three chain shapes, and an Xor
    "Count(Intersect(Union(Row(f=0), Row(f=5)), Union(Row(f=3), Row(f=6))))",
    "Count(Union(Intersect(Row(f=1), Row(f=2)), Intersect(Row(f=3), Row(f=4)), Row(f=1)))",
    "Count(Difference(Union(Row(f=2), Row(f=7), Row(f=11)), Row(f=4)))",
    "Count(Xor(Row(f=0), Difference(Row(f=1), Row(f=12)), Row(f=3)))",
    "Count(Row(f=5))",
]


@pytest.mark.parametrize("q", CHAINS)
def test_count_chain_fused_tree_count(sides, legs, q):
    jax_ans, dev_ans, cpu_ans = sides.run("tall", q)
    assert dev_ans == jax_ans == cpu_ans
    assert jax_ans[0] > 0
    assert [kind for kind, _ in legs] == ["tree"]


def test_count_chain_coalesced_batch(sides):
    """Concurrent same-shape chains go through the chain scorer (the
    tree count's batch form) and answer as the CPU leg does."""
    ex = pilosa_tpu_torch.Executor(sides.th, device="cpu", device_policy="always")
    try:
        queries = CHAINS * 3
        with ThreadPoolExecutor(max_workers=6) as pool:
            got = list(pool.map(lambda q: ex.execute("tall", q), queries))
        assert got == [sides.cpu.execute("tall", q) for q in queries]
        assert ex.chain_scorer.dispatches > 0
    finally:
        ex.close()


def test_sparse_staging_holds_exactly_the_set_containers(sides):
    """The block-sparse forms stage one block per set container of the
    candidates and nothing more (the kernel takes any block count)."""
    th, stager = sides.th, sides.dev.stager
    frags = tuple(th.fragment("tall", "f", "standard", s) for s in range(3))
    ids = (0, 1, 10, 70)
    want = [f.sparse_row_blocks(list(ids))[0].shape[0] for f in frags]
    assert all(want)
    blocks, brow, bslot, num_rows = stager.sparse_rows(frags[0], ids)
    assert blocks.shape[0] == brow.shape[0] == bslot.shape[0] == want[0]
    assert num_rows == len(ids)
    blocks, brow, bslot, bshard, num_rows = stager.sparse_rows_stacked(frags, (ids,) * 3, 8)
    assert blocks.shape[0] == bshard.shape[0] == sum(want)
    assert num_rows == 3 * 8


@pytest.mark.parametrize("index,q", [("tall", TALL_TOPN[0]), ("tall", CHAINS[0]), ("one", "TopN(f, Row(f=1), n=3)")])
def test_auto_policy_matches(sides, index, q):
    """device_policy="auto" routes by touched containers; either route
    gives the CPU leg's answer."""
    ex = pilosa_tpu_torch.Executor(sides.th, device="cpu", device_policy="auto")
    try:
        assert ex.execute(index, q) == sides.cpu.execute(index, q)
    finally:
        ex.close()


@pytest.mark.parametrize(
    "q",
    [
        "Row(f=70)",
        "Intersect(Row(f=1), Row(f=2))",
        "Union(Row(f=10), Row(f=170))",
        "Difference(Row(f=0), Row(f=1))",
    ],
)
def test_bitmap_calls(sides, q):
    jax_ans, dev_ans, cpu_ans = sides.run("tall", q)
    assert dev_ans == jax_ans == cpu_ans


def test_multi_call_request(sides):
    q = "TopN(f, Row(f=1), n=3)Count(Row(f=2))TopN(f, Row(f=4), n=2)"
    jax_ans, dev_ans, cpu_ans = sides.run("tall", q)
    assert dev_ans == jax_ans == cpu_ans
    assert len(dev_ans) == 3


def test_set_restages_and_answers_move(base, tmp_path):
    s = _Sides(*_open_pair(base, tmp_path))
    try:
        queries = [
            ("tall", "Count(Intersect(Row(f=1), Row(f=2)))"),
            ("tall", "TopN(f, Row(f=1), ids=[1, 2, 3])"),
            ("dense", "TopN(f, Row(f=5), ids=[3, 5, 7])"),
        ]
        before = [s.run(i, q) for i, q in queries]
        for b in before:
            assert b[0] == b[1] == b[2]
        misses = s.dev.stager.misses
        # columns of row 1 (tall, shard 2) and row 5 (dense) that rows 2
        # and 3 lack: setting them raises both the chain count and the
        # TopN scores
        tall1 = set(_plain(s.cpu.execute("tall", "Row(f=1)"))[0])
        tall2 = set(_plain(s.cpu.execute("tall", "Row(f=2)"))[0])
        col = max(c for c in tall1 - tall2 if c >= 2 * SW)
        d5 = set(_plain(s.cpu.execute("dense", "Row(f=5)"))[0])
        d3 = set(_plain(s.cpu.execute("dense", "Row(f=3)"))[0])
        dcol = min(d5 - d3)
        for ex in (s.jax, s.dev):
            assert ex.execute("tall", f"Set({col}, f=2)") == [True]
            assert ex.execute("dense", f"Set({dcol}, f=3)") == [True]
        after = [s.run(i, q) for i, q in queries]
        for a in after:
            assert a[0] == a[1] == a[2]
        assert after[0][0][0] == before[0][0][0] + 1
        assert after[1][0] != before[1][0]
        assert after[2][0] != before[2][0]
        # the generation change restaged the entries the re-queries read
        assert s.dev.stager.misses > misses
    finally:
        s.close()


@pytest.mark.parametrize(
    "q,call,shards,ref_routed,port_routed",
    [
        # a one-shard TopN ranks every candidate row: the JAX package
        # counts only its source's containers and takes the CPU walk
        ("TopN(f, Row(f=3), n=5)", "TopN", 1, 0, 2),
        # an unfiltered Min reads the plane stack of every shard: the JAX
        # package counts nothing, so each shard runs its own device leg
        ("Min(field=v)", "Min", 3, 0, 1),
        ("Sum(field=v)", "Sum", 3, 0, 1),
    ],
    ids=["topn_candidates", "min_planes", "sum_planes"],
)
def test_auto_policy_counts_what_the_call_reads(q, call, shards, ref_routed, port_routed):
    """Under "auto", the port's estimate of a call's touched containers
    includes what the call itself reads (TopN's candidate rows, an
    aggregate's planes), so the shard-batched device leg is chosen where
    the JAX package chose the CPU walk or per-shard launches. The
    answers are the same."""
    from pilosa_tpu.utils import metrics as ref_metrics
    from pilosa_tpu_torch.core import Holder as PortHolder
    from pilosa_tpu_torch.utils import metrics as port_metrics

    rng = np.random.default_rng(21)
    rows, cols = [], []
    for r in range(100):
        c = rng.choice(1 << 20, size=3000, replace=False) + (r % shards) * (1 << 20)
        rows += [r] * len(c)
        cols += c.tolist()
    vcols = rng.choice(shards << 20, size=20000, replace=False).tolist()
    vals = rng.integers(0, 1000, size=len(vcols)).tolist()
    key = f"{port_metrics.EXECUTOR_ROUTE_DEVICE};call:{call}"
    answers, routed = {}, {}
    for name, holder_cls, make, metrics in (
        ("ref", JaxHolder, lambda h: JaxExecutor(h, device_policy="auto", dispatch_enabled=False), ref_metrics),
        ("port", PortHolder, lambda h: pilosa_tpu_torch.Executor(h, device="cpu", device_policy="auto"), port_metrics),
    ):
        h = holder_cls()
        h.open()
        idx = h.create_index("i")
        idx.create_field("f").import_bits(rows, cols)
        opts = (pilosa_tpu_torch.core if name == "port" else __import__("pilosa_tpu.core").core).FieldOptions
        idx.create_field("v", opts(type="int", min=0, max=1000)).import_values(vcols, vals)
        ex = make(h)
        before = metrics.snapshot().get(key, 0)
        answers[name] = repr(ex.execute("i", q)[0])
        routed[name] = metrics.snapshot().get(key, 0) - before
        ex.close()
        h.close()
    assert answers["ref"] == answers["port"]
    assert routed == {"ref": ref_routed, "port": port_routed}


class TestReadPoolRace:
    """The read pool's close (the reference's TestReadPoolRace,
    tests/test_dispatch.py): close() drains the pool's checkouts, later
    checkouts get none and run their calls serially inline, and nothing
    builds a pool again."""

    def test_close_during_concurrent_execution_is_clean(self, sides):
        # fusion off, so every multi-call read maps its calls on the pool
        ex = pilosa_tpu_torch.Executor(
            sides.th, device="cpu", device_policy="always", fusion_enabled=False
        )
        q = (
            "Count(Union(Row(f=3), Xor(Row(f=4), Row(f=5)), Difference(Row(f=6), Row(f=7))))"
            "Count(Intersect(Row(f=1), Row(f=2)))"
            "TopN(f, Row(f=1), n=3)"
        )
        want = _plain(sides.cpu.execute("tall", q))
        stop = time.monotonic() + 2.0
        errors, done = [], []

        def reader():
            try:
                while time.monotonic() < stop:
                    assert _plain(ex.execute("tall", q)) == want
                done.append(True)
            except Exception as e:  # pragma: no cover - the regression
                errors.append(e)

        ts = [threading.Thread(target=reader) for _ in range(6)]
        for t in ts:
            t.start()
        time.sleep(0.3)
        ex.close()  # mid-traffic: drains, then later reads run inline
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not errors, errors[0]
        assert len(done) == 6
        assert ex._read_pool is None

    def test_read_after_close_builds_no_pool(self, sides):
        ex = pilosa_tpu_torch.Executor(sides.th, device="cpu", device_policy="never")
        q = "Row(f=1)Row(f=2)"
        want = _plain(sides.cpu.execute("tall", q))
        ex.close()
        assert _plain(ex.execute("tall", q)) == want
        assert ex._read_pool is None
