"""The parity gauntlet with writes: random PQL against both packages.

One seeded data directory (3 shards: set fields ``f`` and ``g``, the int
field ``v``, the time field ``t``) is written through ``pilosa_tpu``'s
Holder and copied for each side. Per seed, a random sequence of reads
and write requests runs through ``pilosa_tpu``'s ``Executor``
(``device_policy="always"`` and ``"never"``) and the port's
``Executor(device="cpu")`` legs (``"always"``, the kernels' plain
versions, and ``"never"``, the roaring leg). Reads are random trees over
Row, Range and time-quantum leaves under Count, TopN (``n``, ``ids``,
``threshold``, ``tanimotoThreshold``), Sum/Min/Max, GroupBy (``ids``,
repeats among them, a filter, ``limit``, Sum), Distinct and Percentile;
writes are ``Set``, ``Clear`` and ``SetValue`` requests. Every answer
must be identical on the four legs, except a GroupBy whose ``ids``
repeat: there the reference is at fault (ROADMAP C2), and the port's
legs are held to a numpy oracle of the same data instead.

The writes refresh the port's staged tensors. At some writes the test
takes a view of every staged tensor and holds it until the next write,
as a reader between staging and launch does: those entries must be
refreshed into a copy (the view keeps its snapshot), the others in
place. Both routes must be taken.

A second gauntlet sends multi-call reads (several random reads in one
request, drawn again and again from a small pool so the plan caches
hit) among the same writes, to legs that run fusion and a plan cache:
``pilosa_tpu``'s ``always`` leg and the port's ``always`` leg, each
with a ``PlanCache``, held call by call to the port's uncached roaring
leg, to ``pilosa_tpu``'s uncached roaring leg, and (ids that repeat) to
the numpy oracle. Fused launches, cache hits and invalidations must all
have happened.
"""

import itertools
import shutil
from datetime import datetime

import numpy as np
import pytest
import torch

from pilosa_tpu.core import FieldOptions as JaxFieldOptions
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.plan.cache import PlanCache as JaxPlanCache

import pilosa_tpu_torch
from pilosa_tpu_torch.plan.cache import PlanCache

SW = 1 << 20
SHARDS = 3
POOL = 2000
ROWS = {"f": 8, "g": 6}
VMIN, VMAX = -50, 900
DAYS = [f"2010-01-0{d}T00:00" for d in range(1, 8)]
STEPS = 60
WRITE_FRAC = 0.25
PIN_FRAC = 0.4


def _build(path) -> dict:
    """Write the data directory; returns the numpy model of f, g and v.
    Every bit lies in one pool of POOL columns over the shards, each
    column in about a third of each field's rows, so trees and groups
    intersect."""
    rng = np.random.default_rng(1729)
    h = JaxHolder(str(path))
    h.open()
    idx = h.create_index("z")
    pool = rng.choice(SHARDS * SW, size=POOL, replace=False)
    model = {"pool": pool, "bits": {}, "vals": {}}
    for name, nrows in ROWS.items():
        fld = idx.create_field(name)
        member = rng.random((nrows, POOL)) < 0.3
        rows, cols = np.nonzero(member)
        fld.import_bits(rows.tolist(), pool[cols].tolist())
        for r in range(nrows):
            model["bits"][(name, r)] = set(pool[member[r]].tolist())
    v = idx.create_field("v", JaxFieldOptions(type="int", min=VMIN, max=VMAX))
    vcols = pool[rng.random(POOL) < 0.85]
    vvals = rng.integers(VMIN, VMAX + 1, size=vcols.size)
    v.import_values(vcols.tolist(), vvals.tolist())
    model["vals"] = {int(c): int(x) for c, x in zip(vcols, vvals)}
    t = idx.create_field("t", JaxFieldOptions(type="time", time_quantum="YMD"))
    tcols = pool[:400]
    stamps = [datetime(2010, 1, 1 + int(d)) for d in rng.integers(0, 6, size=tcols.size)]
    t.import_bits(rng.integers(0, 3, size=tcols.size).tolist(), tcols.tolist(), stamps)
    h.close()
    return model


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = tmp_path_factory.mktemp("fuzz_holder")
    return d, _build(d)


# -- queries -------------------------------------------------------------------------


def _row(rng, field=None):
    field = field or str(rng.choice(["f", "g"]))
    return ("row", field, int(rng.integers(0, ROWS[field] + 1)))


def _range(rng):
    op = str(rng.choice(["<", "<=", "==", ">", ">="]))
    return ("range", op, int(rng.integers(VMIN - 20, VMAX + 20)))


def _leaf(rng) -> str:
    k = rng.random()
    if k < 0.55:
        return _pql(_row(rng))
    if k < 0.75:
        return _pql(_range(rng))
    if k < 0.85:
        lo = int(rng.integers(VMIN, 400))
        return f"Range(v >< [{lo}, {lo + int(rng.integers(0, 500))}])"
    a, b = sorted(rng.choice(len(DAYS), size=2, replace=False))
    return f"Range(t={int(rng.integers(0, 3))}, {DAYS[a]}, {DAYS[b]})"


def _pql(leaf) -> str:
    if leaf[0] == "row":
        return f"Row({leaf[1]}={leaf[2]})"
    return f"Range(v {leaf[1]} {leaf[2]})"


def _tree(rng, depth: int) -> str:
    if depth == 0 or rng.random() < 0.4:
        return _leaf(rng)
    op = str(rng.choice(["Intersect", "Union", "Difference", "Xor"]))
    kids = ", ".join(_tree(rng, depth - 1) for _ in range(int(rng.integers(2, 4))))
    return f"{op}({kids})"


def _topn(rng) -> str:
    field = str(rng.choice(["f", "g"]))
    args = [field]
    if rng.random() < 0.8:
        args.append(_tree(rng, 1))
    k = rng.random()
    if k < 0.3:
        ids = rng.choice(ROWS[field] + 2, size=int(rng.integers(1, 5)), replace=False)
        args.append(f"ids=[{', '.join(str(int(i)) for i in ids)}]")
    else:
        args.append(f"n={int(rng.integers(1, 8))}")
    if k >= 0.3 and rng.random() < 0.3:
        args.append(f"threshold={int(rng.integers(1, 40))}")
    if len(args) > 1 and args[1].startswith(("Row", "Inter", "Union", "Diff", "Xor", "Range")) and rng.random() < 0.2:
        args.append(f"tanimotoThreshold={int(rng.integers(1, 60))}")
    return f"TopN({', '.join(args)})"


def _groupby(rng):
    """(pql, spec): spec is what the numpy oracle needs when ids repeat."""
    dims, spec_dims = [], []
    for field in rng.permutation(["f", "g"])[: int(rng.integers(1, 3))]:
        field = str(field)
        if rng.random() < 0.7:
            ids = [int(i) for i in rng.integers(0, ROWS[field] + 1, size=int(rng.integers(1, 5)))]
            dims.append(f"Rows({field}, ids=[{', '.join(map(str, ids))}])")
        else:
            ids = None
            dims.append(f"Rows({field})")
        spec_dims.append((field, ids))
    repeats = any(ids is not None and len(set(ids)) < len(ids) for _, ids in spec_dims)
    args = list(dims)
    filt = None
    if rng.random() < 0.5:
        if repeats:
            filt = _row(rng) if rng.random() < 0.6 else _range(rng)
            args.append(_pql(filt))
        else:
            args.append(_tree(rng, 1))
    agg = rng.random() < 0.5
    if agg:
        args.append("Sum(field=v)")
    limit = int(rng.integers(1, 6)) if rng.random() < 0.3 else None
    if limit is not None:
        args.append(f"limit={limit}")
    spec = {"dims": spec_dims, "filter": filt, "agg": agg, "limit": limit} if repeats else None
    return f"GroupBy({', '.join(args)})", spec


def _read(rng):
    kind = str(rng.choice(["count", "topn", "sum", "minmax", "groupby", "distinct", "percentile"],
                          p=[0.25, 0.2, 0.1, 0.1, 0.2, 0.07, 0.08]))
    filt = _tree(rng, 1) + ", " if rng.random() < 0.5 else ""
    if kind == "count":
        return f"Count({_tree(rng, 2)})", None
    if kind == "topn":
        return _topn(rng), None
    if kind == "sum":
        return f"Sum({filt}field=v)", None
    if kind == "minmax":
        return f"{rng.choice(['Min', 'Max'])}({filt}field=v)", None
    if kind == "groupby":
        return _groupby(rng)
    if kind == "distinct":
        return f"Distinct({filt}field=v)", None
    nth = str(rng.choice(["0", "25", "50", "95", "99.9", "100"]))
    return f"Percentile({filt}field=v, nth={nth})", None


def _write(rng, model) -> str:
    calls = []
    pool = model["pool"]
    for _ in range(int(rng.integers(1, 5))):
        col = int(pool[rng.integers(0, pool.size)]) if rng.random() < 0.8 else int(rng.integers(0, SHARDS * SW))
        k = rng.random()
        if k < 0.35:
            field, r = str(rng.choice(["f", "g"])), None
            r = int(rng.integers(0, ROWS[field]))
            calls.append(f"Set({col}, {field}={r})")
            model["bits"][(field, r)].add(col)
        elif k < 0.7:
            field = str(rng.choice(["f", "g"]))
            r = int(rng.integers(0, ROWS[field]))
            present = sorted(model["bits"][(field, r)])
            if present and rng.random() < 0.8:
                col = present[int(rng.integers(0, len(present)))]  # clear a bit that is set
            calls.append(f"Clear({col}, {field}={r})")
            model["bits"][(field, r)].discard(col)
        else:
            val = int(rng.integers(VMIN, VMAX + 1))
            calls.append(f"SetValue(col={col}, v={val})")
            model["vals"][col] = val
    return "".join(calls)


# -- the numpy oracle of a GroupBy whose ids repeat ----------------------------------


_CMP = {
    "<": np.less, "<=": np.less_equal, "==": np.equal, ">": np.greater, ">=": np.greater_equal,
}


def _oracle_groupby(model, spec) -> list:
    """Distinct groups in rank order (explicit ids by first position,
    discovered ids ascending), zero counts dropped, then ``limit``."""
    filt = None
    if spec["filter"] is not None:
        f = spec["filter"]
        if f[0] == "row":
            filt = model["bits"].get((f[1], f[2]), set())
        else:
            cols = np.fromiter(model["vals"].keys(), np.int64)
            vals = np.fromiter(model["vals"].values(), np.int64)
            filt = set(cols[_CMP[f[1]](vals, f[2])].tolist())
    dims = []
    for field, ids in spec["dims"]:
        ids = list(dict.fromkeys(ids)) if ids is not None else list(range(ROWS[field]))
        dims.append((field, ids))
    out = []
    for key in itertools.product(*[ids for _, ids in dims]):
        cols = None
        for (field, _), r in zip(dims, key):
            s = model["bits"].get((field, r), set())
            cols = s if cols is None else cols & s
        if filt is not None:
            cols = cols & filt
        if not cols:
            continue
        entry = {"group": [{"field": f, "rowID": r} for (f, _), r in zip(dims, key)], "count": len(cols)}
        if spec["agg"]:
            entry["sum"] = sum(model["vals"].get(c, 0) for c in cols)
        out.append(entry)
    return out[: spec["limit"]] if spec["limit"] else out


def _plain(results):
    out = []
    for r in results:
        if hasattr(r, "columns"):
            r = [int(c) for c in r.columns()]
        elif hasattr(r, "val") and hasattr(r, "count"):
            r = ("vc", r.val, r.count)
        out.append(r)
    return out


def _pin(stager) -> list:
    """A view of every staged tensor and a copy of its words: a reader
    that staged them and has not launched yet."""
    return [
        (e.value.view(-1), e.value.clone().view(-1))
        for e in list(stager._cache.values())
        if isinstance(e.value, torch.Tensor)
    ]


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_fuzz_parity_with_writes(base, tmp_path, seed):
    src, model0 = base
    model = {
        "pool": model0["pool"],
        "bits": {k: set(v) for k, v in model0["bits"].items()},
        "vals": dict(model0["vals"]),
    }
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    shutil.copytree(src, jdir)
    shutil.copytree(src, tdir)
    jh = JaxHolder(str(jdir))
    jh.open()
    th = pilosa_tpu_torch.holder_from_dir(str(tdir))
    jax_dev = JaxExecutor(jh, device_policy="always")
    jax_cpu = JaxExecutor(jh, device_policy="never")
    dev = pilosa_tpu_torch.Executor(th, device="cpu", device_policy="always")
    cpu = pilosa_tpu_torch.Executor(th, device="cpu", device_policy="never")
    rng = np.random.default_rng(seed)
    pins: list = []
    checked = {"reference": 0, "oracle": 0}
    try:
        for step in range(STEPS):
            if rng.random() < WRITE_FRAC:
                pins = _pin(dev.stager) if rng.random() < PIN_FRAC else []
                w = _write(rng, model)
                jax_dev.execute("z", w)
                dev.execute("z", w)
                continue
            q, spec = _read(rng)
            port = [_plain(ex.execute("z", q)) for ex in (dev, cpu)]
            assert port[0] == port[1], (seed, step, q, port)
            if spec is None:
                ref = [_plain(ex.execute("z", q)) for ex in (jax_dev, jax_cpu)]
                assert ref[0] == ref[1] == port[0], (seed, step, q, ref, port)
                checked["reference"] += 1
            else:
                assert port[0] == [_oracle_groupby(model, spec)], (seed, step, q, port)
                checked["oracle"] += 1
            # a held snapshot never sees a later write
            for view, words in pins:
                assert torch.equal(view, words), (seed, step)
        routes = dev.stager.delta_routes
        assert routes["in_place"] > 0 and routes["copied"] > 0, routes
        assert checked["reference"] > 0
        assert checked["oracle"] > 0
    finally:
        for ex in (jax_dev, jax_cpu, dev, cpu):
            ex.close()
        jh.close()
        th.close()


MULTI_POOL = 6
MULTI_STEPS = 30


@pytest.mark.parametrize("seed", [5])
def test_fuzz_multicall_with_fusion_and_plan_cache(base, tmp_path, seed):
    src, model0 = base
    model = {
        "pool": model0["pool"],
        "bits": {k: set(v) for k, v in model0["bits"].items()},
        "vals": dict(model0["vals"]),
    }
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    shutil.copytree(src, jdir)
    shutil.copytree(src, tdir)
    jh = JaxHolder(str(jdir))
    jh.open()
    th = pilosa_tpu_torch.holder_from_dir(str(tdir))
    jax_dev = JaxExecutor(jh, device_policy="always", plan_cache=JaxPlanCache())
    jax_cpu = JaxExecutor(jh, device_policy="never")
    dev = pilosa_tpu_torch.Executor(th, device="cpu", device_policy="always", plan_cache=PlanCache())
    cpu = pilosa_tpu_torch.Executor(th, device="cpu", device_policy="never")
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(MULTI_POOL):
        reads = [_read(rng) for _ in range(int(rng.integers(2, 6)))]
        pool.append(("".join(q for q, _ in reads), [spec for _, spec in reads]))
    try:
        for step in range(MULTI_STEPS):
            if rng.random() < WRITE_FRAC:
                w = _write(rng, model)
                jax_dev.execute("z", w)
                dev.execute("z", w)
                continue
            q, specs = pool[int(rng.zipf(1.5)) % MULTI_POOL]
            got, want = _plain(dev.execute("z", q)), _plain(cpu.execute("z", q))
            assert got == want, (seed, step, q)
            ref_dev, ref_cpu = _plain(jax_dev.execute("z", q)), _plain(jax_cpu.execute("z", q))
            for k, spec in enumerate(specs):
                if spec is None:
                    assert ref_dev[k] == ref_cpu[k] == got[k], (seed, step, q, k)
                else:
                    assert got[k] == _oracle_groupby(model, spec), (seed, step, q, k)
        st, pc = dev.fuser.stats(), dev.plan_cache.stats()
        assert st["fused_launches"] > 0 and st["cache_served"] > 0, st
        assert pc["hits"] > 0 and pc["invalidations"] > 0, pc
        assert "error" not in st["bypasses"], st
    finally:
        for ex in (jax_dev, jax_cpu, dev, cpu):
            ex.close()
        jh.close()
        th.close()
