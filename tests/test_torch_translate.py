"""Key translation in the port (``utils/translate.py``, ``translate/``,
the planner's ``resolve_keys``, the executor's keyed surface and the
server's keyed routes) against the JAX package's.

The reference's own cases run on ``pilosa_tpu_torch``: every case of
``tests/test_translate.py`` and the single-node cases of
``tests/test_translate_subsystem.py`` (executors on ``device="cpu"``;
``TestClusterKeyed`` needs the multi-device plane, ROADMAP A8). Then the
two packages are held to each other: the same mint sequence gives equal
ids and byte-identical logs, each opens the other's logs and resolves the
same keys, a keyed workload with attributes answers ``==`` through the
reference's executor and the port's on both legs, and a backup moves
between the two servers.
"""

import functools
import io
import json
import os
import shutil
import tarfile
import urllib.error
import urllib.request

import pytest
from port_reference import exec_against_port

exec_against_port("test_translate", globals())
exec_against_port("test_translate_subsystem", globals())

from pilosa_tpu_torch.executor import Executor as _PortExecutor  # noqa: E402

# the reference's cases build executors with no device: the port's run on the CPU
Executor = functools.partial(_PortExecutor, device="cpu")
# two federated nodes over HTTP: the multi-device plane (ROADMAP A8)
del TestClusterKeyed  # noqa: F821

import pilosa_tpu.translate as ref_translate  # noqa: E402
import pilosa_tpu.utils.translate as ref_wal  # noqa: E402
import pilosa_tpu_torch.translate as port_translate  # noqa: E402
import pilosa_tpu_torch.utils.translate as port_wal  # noqa: E402

SIDES = {"ref": ref_translate.Translator, "port": port_translate.Translator}


def _mint_sequence(t) -> list:
    """A mixed mint sequence: column and row keys in batches with
    repeats, unicode, an empty-key-free long key, reads that must not
    mint, and a second index."""
    out = []
    out.append(t.translate_columns_to_ids("u", [f"user-{j:04d}" for j in range(300)]))
    out.append(t.translate_rows_to_ids("u", "likes", ["pizza", "sushi", "pizza", "日本語"]))
    out.append(t.translate_columns_to_ids("u", ["user-0007", "héllo", "K" * 300, "user-0007"]))
    out.append(t.translate_columns_to_ids("u", ["never"], create=False))
    out.append(t.translate_rows_to_ids("u", "seg", [f"s{j}" for j in range(40)]))
    out.append(t.translate_columns_to_ids("other", ["a", "b", "user-0001"]))
    out.append(t.mint("u", "likes", ["ramen", "pizza"]))
    out.append([t.translate_column_to_string("u", i) for i in out[0][:5] + [999_999]])
    out.append([t.translate_row_to_string("u", "likes", i) for i in (1, 2, 3, 4)])
    return out


def _logs(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".log"):
                path = os.path.join(d, fn)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("partitions", [1, 4, 16])
def test_same_mints_give_equal_ids_and_identical_logs(tmp_path, partitions):
    got, logs = {}, {}
    for side, cls in SIDES.items():
        t = cls(str(tmp_path / side), partitions=partitions)
        try:
            got[side] = _mint_sequence(t)
            got[side].append(t.stores())
        finally:
            t.close()
        logs[side] = _logs(str(tmp_path / side))
    assert got["port"] == got["ref"]
    assert logs["port"] == logs["ref"] and len(logs["ref"]) >= min(partitions, 4) + 2


def test_translate_store_wal_is_byte_identical(tmp_path):
    """``utils/translate.TranslateStore``: the same mints give the same
    ids and the same WAL bytes (its checkpoint is numpy's, not compared)."""
    got, wal = {}, {}
    for side, mod in (("ref", ref_wal), ("port", port_wal)):
        p = str(tmp_path / side / ".keys")
        ts = mod.TranslateStore(p)
        got[side] = [
            ts.translate_columns_to_ids("i", [f"k{j}" for j in range(500)] + ["k3", "ключ"]),
            ts.translate_rows_to_ids("i", "f", ["x", "y", "x"]),
            ts.translate_columns_to_ids("i", ["k9", "new"]),
        ]
        ts.close()
        with open(p, "rb") as f:
            wal[side] = f.read()
    assert got["port"] == got["ref"] and wal["port"] == wal["ref"]
    # and each replays the other's WAL
    for reader, mod in (("port", port_wal), ("ref", ref_wal)):
        writer = "ref" if reader == "port" else "port"
        p = str(tmp_path / f"{writer}-read-by-{reader}")
        with open(p, "wb") as f:
            f.write(wal[writer])
        ts = mod.TranslateStore(p)
        assert ts.translate_columns_to_ids("i", ["k499", "ключ", "new"], create=False) == [500, 501, 502]
        assert ts.translate_row_to_string("i", "f", 2) == "y"
        ts.close()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_side_opens_the_others_logs(tmp_path, writer, reader):
    src = str(tmp_path / "src")
    t = SIDES[writer](src, partitions=8)
    minted = _mint_sequence(t)
    t.close()
    copies = {}
    for side in ("ref", "port"):
        copies[side] = str(tmp_path / side)
        shutil.copytree(src, copies[side])
    answers, logs = {}, {}
    for side in (writer, reader):
        t = SIDES[side](copies[side], partitions=8)
        try:
            cols = [f"user-{j:04d}" for j in range(300)] + ["héllo", "K" * 300, "never"]
            answers[side] = [
                t.translate_columns_to_ids("u", cols, create=False),
                t.translate_rows_to_ids("u", "likes", ["pizza", "ramen", "日本語"], create=False),
                [t.translate_column_to_string("u", i) for i in minted[0][:20]],
                [t.translate_row_to_string("u", "seg", i) for i in range(1, 41)],
                # minting goes on from the same high-water marks
                t.translate_columns_to_ids("u", ["fresh-1", "user-0002", "fresh-2"]),
                t.translate_rows_to_ids("u", "likes", ["tacos"]),
                t.stats()["keys"],
            ]
        finally:
            t.close()
        logs[side] = _logs(copies[side])
    assert answers[reader] == answers[writer]
    assert answers[reader][0][:300] == minted[0]
    assert logs[reader] == logs[writer]


# -- the keyed gauntlet with attributes: reference, port never, port always --

GAUNTLET_WRITES = [
    'Set("{col}", likes="{genre}")',
    'Set("{col}", segment="{seg}")',
    'SetValue(col="{col}", age={age})',
]

GAUNTLET_READS = KEYED_QUERIES + [  # noqa: F821
    'Row(segment="premium")',
    'Count(Difference(Row(likes="fiction"), Row(segment="free")))',
    'Count(Intersect(Row(likes="scifi"), Union(Row(segment="free"), Row(likes="poetry"))))',
    'TopN(likes, Row(segment="premium"), n=2)',
    'TopN(likes, n=3, attrName="category", attrValues=["books"])',
    'TopN(likes, Row(segment="free"), n=3, attrName="category", attrValues=["books", "verse"])',
    'TopN(likes, Row(segment="free"), attrName="category", attrValues=["none"])',
    'Sum(Row(likes="fiction"), field="age")',
    # one multi-call request: the fuser on both packages
    'Count(Row(likes="fiction"))TopN(likes, Row(segment="free"), n=2)'
    'Count(Union(Row(likes="scifi"), Row(likes="poetry")))'
    'TopN(likes, Row(segment="premium"), n=3, attrName="category", attrValues=["books"])',
]


def _canon(r):
    if hasattr(r, "columns"):
        return ("row", [int(c) for c in r.columns()], list(r.keys), dict(r.attrs))
    if hasattr(r, "val") and hasattr(r, "count"):
        return ("vc", r.val, r.count)
    return r


def _keyed_side(side: str, path: str):
    """A keyed index with attribute stores on one package, the gauntlet's
    traffic written through its executor, and the executors to read it."""
    if side == "ref":
        from pilosa_tpu.core import FieldOptions, Holder
        from pilosa_tpu.core.field import FIELD_TYPE_INT
        from pilosa_tpu.executor import Executor as RefExecutor
        from pilosa_tpu.utils.attrstore import new_attr_store

        def make(h, t, policy):
            return RefExecutor(h, device_policy=policy, translate_store=t)

    else:
        from pilosa_tpu_torch.core import FieldOptions, Holder
        from pilosa_tpu_torch.core.field import FIELD_TYPE_INT
        from pilosa_tpu_torch.utils.attrstore import new_attr_store

        def make(h, t, policy):
            return _PortExecutor(h, device="cpu", device_policy=policy, translate_store=t)

    h = Holder(os.path.join(path, "data"), new_attr_store=new_attr_store)
    h.open()
    idx = h.create_index("users", keys=True)
    idx.create_field("likes", FieldOptions(keys=True))
    idx.create_field("segment", FieldOptions(keys=True))
    idx.create_field("age", FieldOptions(type=FIELD_TYPE_INT, min=0, max=100))
    t = SIDES[side](os.path.join(path, "translate"), partitions=8)
    w = make(h, t, "never")
    for col, genre, seg, age in _keyed_workload():  # noqa: F821
        w.execute("users", "".join(q.format(col=col, genre=genre, seg=seg, age=age) for q in GAUNTLET_WRITES))
    # attributes by id (the keyed rows' ids, as minted); columns too
    ids = t.translate_rows_to_ids("users", "likes", ["fiction", "scifi", "poetry"], create=False)
    cols = t.translate_columns_to_ids("users", ["user-001", "user-002"], create=False)
    w.execute(
        "users",
        f'SetRowAttrs(likes, {ids[0]}, category="books", rank=1)'
        f'SetRowAttrs(likes, {ids[1]}, category="books")'
        f'SetRowAttrs(likes, {ids[2]}, category="verse")'
        f'SetColumnAttrs({cols[0]}, region="eu")SetColumnAttrs({cols[1]}, region="us", vip=true)',
    )
    w.close()
    for f in idx.fields.values():
        for v in f.views.values():
            for frag in v.fragments.values():
                frag.cache.recalculate()
    return h, t, {policy: make(h, t, policy) for policy in ("never", "always")}


def test_keyed_gauntlet_answers_as_the_reference(tmp_path):
    """Keyed Set/Row/Count/TopN/GroupBy/Distinct/Sum, attribute-filtered
    TopN, a Row's attributes and a fused multi-call request: the port at
    ``never`` and ``always`` answers ``==`` the reference at ``always``,
    key for key; the column attributes written are the same."""
    sides = {side: _keyed_side(side, str(tmp_path / side)) for side in ("ref", "port")}
    try:
        for q in GAUNTLET_READS:
            want = [_canon(r) for r in sides["ref"][2]["always"].execute("users", q)]
            for policy in ("never", "always"):
                got = [_canon(r) for r in sides["port"][2][policy].execute("users", q)]
                assert got == want, (q, policy)
        top = sides["port"][2]["always"].execute("users", GAUNTLET_READS[-5])[0]
        assert sorted(p["key"] for p in top) == ["fiction", "scifi"]
        # the keyed requests reached both fusers with ids only (the
        # multi-call one with its attribute-filtered TopN): the same
        # launches, calls and no bypass
        ref_st, port_st = (sides[side][2]["always"].fuser.stats() for side in ("ref", "port"))
        for key in ("fused_launches", "fused_calls", "bypasses"):
            assert port_st[key] == ref_st[key], key
        assert port_st["fused_calls"] >= 4 and not port_st["bypasses"]
        row = sides["port"][2]["always"].execute("users", 'Row(likes="fiction")')[0]
        assert row.attrs == {"category": "books", "rank": 1} and "user-000" in row.keys
        (ref_h, _, _), (port_h, _, _) = sides["ref"], sides["port"]
        for col in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10):
            assert port_h.index("users").column_attrs.attrs(col) == ref_h.index("users").column_attrs.attrs(col)
    finally:
        for h, t, exs in sides.values():
            for ex in exs.values():
                ex.close()
            t.close()
            h.close()


# -- server round-trips: keyed ingest, debug, backup/restore ------------------


def _req(server, method, path, body=None, raw=False):
    data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
    r = urllib.request.Request(server.uri + path, data=data, method=method)
    try:
        with urllib.request.urlopen(r) as resp:
            st, payload = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        st, payload = e.code, e.read()
    return st, (payload if raw else json.loads(payload or b"{}"))


def _server(side: str, data_dir: str):
    if side == "ref":
        from pilosa_tpu.server import Config, Server

        s = Server(Config(data_dir=data_dir, bind="127.0.0.1:0", device_policy="always"))
    else:
        from pilosa_tpu_torch.server import Config, Server

        s = Server(Config(data_dir=data_dir, bind="127.0.0.1:0", device="cpu", device_policy="always"))
    s.open()
    return s


class TestServerKeyed:
    """The reference's single-node keyed server case on the port's
    server (its cluster boot is the port's one node)."""

    def test_keyed_ingest_debug_backup_restore(self, tmp_path):
        s = _server("port", str(tmp_path / "p"))
        try:
            assert _req(s, "POST", "/index/u", {"options": {"keys": True}})[0] == 200
            assert _req(s, "POST", "/index/u/field/f", {"options": {"keys": True}})[0] == 200
            st, body = _req(
                s, "POST", "/index/u/field/f/ingest",
                {"rowKeys": ["r1", "r1", "r2"], "columnKeys": ["alice", "bob", "alice"]},
            )
            assert st == 200, body
            st, body = _req(s, "POST", "/index/u/query", b'Row(f="r1")')
            assert st == 200 and sorted(body["results"][0]["keys"]) == ["alice", "bob"]
            st, dbg = _req(s, "GET", "/debug/translate")
            assert st == 200 and dbg["enabled"] is True
            assert dbg["keys"] == 4 and dbg["minted"] == 4
            st, stores = _req(s, "GET", "/internal/translate/stores")
            assert st == 200 and any(e["name"].startswith("u/columns.") for e in stores)
            st, archive = _req(s, "GET", "/backup", raw=True)
            assert st == 200
            with tarfile.open(fileobj=io.BytesIO(archive)) as tr:
                names = tr.getnames()
                manifest = json.loads(tr.extractfile("MANIFEST.json").read())
            t_names = [n for n in names if n.startswith("translate/")]
            assert t_names and all(n in manifest["entries"] for n in t_names)
            # a tampered translate member is refused, by its digest and,
            # with the digest fixed, by the frame parse
            for fix in (False, True):
                st, body = _req(s, "POST", "/restore", _tamper_tar_member(archive, "translate/", fix_manifest=fix))  # noqa: F821
                assert st == 400 and "restore refused" in body["error"], body
            st, body = _req(s, "POST", "/index/u/query", b'Count(Row(f="r1"))')
            assert st == 200 and body["results"][0] == 2
            fresh = _server("port", str(tmp_path / "fresh"))
            try:
                # a stale key in the fresh server is gone after the restore
                _req(fresh, "POST", "/index/u", {"options": {"keys": True}})
                _req(fresh, "POST", "/index/u/field/f", {"options": {"keys": True}})
                _req(fresh, "POST", "/index/u/query", b'Set("stale", f="r9")')
                st, body = _req(fresh, "POST", "/restore", archive)
                assert st == 200, body
                st, body = _req(fresh, "POST", "/index/u/query", b'Row(f="r1")')
                assert st == 200 and sorted(body["results"][0]["keys"]) == ["alice", "bob"]
                for key in ("alice", "bob"):
                    assert fresh.translate_store.translate_columns_to_ids(
                        "u", [key], create=False
                    ) == s.translate_store.translate_columns_to_ids("u", [key], create=False)
                assert fresh.translate_store.translate_columns_to_ids("u", ["stale"], create=False) == [None]
            finally:
                fresh.close()
        finally:
            s.close()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_backup_moves_between_the_two_servers(tmp_path, writer, reader):
    """One side's ``/backup`` of a keyed index restores on the other's
    server, which then answers the keyed reads as the writer did."""
    reads = b'Row(f="r1")TopN(f, n=5)Count(Row(f="r2"))'
    w = _server(writer, str(tmp_path / writer))
    try:
        _req(w, "POST", "/index/u", {"options": {"keys": True}})
        _req(w, "POST", "/index/u/field/f", {"options": {"keys": True}})
        st, _ = _req(w, "POST", "/index/u/query", b'Set("alice", f="r1")Set("bob", f="r1")Set("carol", f="r2")')
        assert st == 200
        _req(w, "POST", "/recalculate-caches")
        want = _req(w, "POST", "/index/u/query", reads)
        st, archive = _req(w, "GET", "/backup", raw=True)
        assert st == 200
    finally:
        w.close()
    r = _server(reader, str(tmp_path / reader))
    try:
        st, body = _req(r, "POST", "/restore", archive)
        assert st == 200, body
        _req(r, "POST", "/recalculate-caches")
        assert _req(r, "POST", "/index/u/query", reads) == want
        assert want[1]["results"][1] == [{"key": "r1", "count": 2}, {"key": "r2", "count": 1}]
    finally:
        r.close()


# -- chip_smoke.py's keys phase, on the CPU at a small size ------------------


def _smoke():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("partitions", [1, 16])
def test_smoke_keys_prefix_is_the_translators(partitions):
    """chip_smoke.keys_column_prefix predicts the ids the port's
    translator mints for ``u%07d`` in key order, and its prefix is the
    longest whose ids stay below the width; keys_fresh_column's key is
    minted next with the id it says, still below the width."""
    smoke = _smoke()
    width, n = 3000, 3600
    k, ids, part = smoke.keys_column_prefix(n, partitions, width)
    t = port_translate.Translator(None, partitions=partitions)
    keys = [f"u{j:07d}" for j in range(n)]
    got = []
    for lo in range(0, k, 700):
        got += t.translate_columns_to_ids("users", keys[lo : min(k, lo + 700)])
    assert got == ids[:k].tolist() and max(got) < width
    assert k == n or ids[k] >= width
    if partitions == 1:
        # ids 1..width-1: no key past the prefix fits
        assert k == width - 1
        with pytest.raises(AssertionError, match="no fresh column key"):
            smoke.keys_fresh_column(k, ids, part, partitions, width)
        return
    j, nid = smoke.keys_fresh_column(k, ids, part, partitions, width)
    assert t.translate_columns_to_ids("users", [keys[j]]) == [nid] and nid < width


def test_smoke_keys_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.run_keys end to end on the port's server on the CPU, at
    ~4,000 column keys and 96 rows: keyed import, plain import, both
    kinds of attributes, every family held to the CPU leg, the fused
    request and the keyed write read back."""
    smoke = _smoke()
    for name, value in (("KEYS_COLUMNS", 4000), ("KEYS_ROWS", 96), ("KEYS_BATCH", 1500),
                        ("KEYS_IMPORT_ROWS", 40), ("KEYS_COLUMN_ATTRS", 2000), ("KEYS_ATTR_BATCH", 700),
                        ("KEYS_REPEATS", 2), ("DENSE_DRAWS", 600)):
        monkeypatch.setattr(smoke, name, value)
    out = smoke.run_keys(str(tmp_path / ".keys"), "test", device="cpu")
    assert out["data"]["column_keys"] == 4000 and out["data"]["shards"] == 1
    assert set(out["families"]) == {"keyed_topn", "attr_topn", "keyed_chains", "row_column_attrs", "multi_call"}
    assert all(r["queries"] > 0 for r in out["families"].values())
    assert out["write_read_back"]["id"] < smoke.SW
    assert out["translate"]["keys"] == 4000 + 96 + 1
