"""The port's HTTP server against the JAX package's, request by request.

Each case drives the same request sequence (the single-node sequences of
``tests/test_server_http.py``, with data drawn from a numpy seed) through
``pilosa_tpu.server.Server`` (JAX on the CPU, ``device_policy="always"``)
and ``pilosa_tpu_torch.server.Server(Config(device="cpu",
device_policy="always"))``, each on its own data directory and bound to
127.0.0.1:0. Status codes, content types, JSON bodies and protobuf bytes
must be equal. Masked: the version string of ``/version`` and the port's
``device`` block of ``/status`` (the backend). Attributes and keys
(keyed indexes and fields, key imports, keyed ingest, ``columnAttrs``,
the translate and attribute-diff routes) answer as the reference's, and
the translate logs of one side's data directory open on the other.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu import SHARD_WIDTH
from pilosa_tpu.server import Config as RefConfig
from pilosa_tpu.server import Server as RefServer
from pilosa_tpu.utils import publicproto as ref_proto
from pilosa_tpu_torch.server import Config as PortConfig
from pilosa_tpu_torch.server import Server as PortServer
from pilosa_tpu_torch.utils import publicproto

PROTO = publicproto.CONTENT_TYPE


def _server(side: str, data_dir: str, **cfg):
    if side == "ref":
        return RefServer(
            RefConfig(data_dir=data_dir, bind="127.0.0.1:0", device_policy="always", **cfg)
        )
    return PortServer(
        PortConfig(
            data_dir=data_dir, bind="127.0.0.1:0", device="cpu", device_policy="always", **cfg
        )
    )


def _http(server, method, path, body=None, headers=None):
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    r = urllib.request.Request(server.uri + path, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(r) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


class Client:
    """One side's server plus a transcript of every exchange."""

    def __init__(self, side: str, data_dir: str, **cfg) -> None:
        self.side = side
        self.data_dir = data_dir
        self.cfg = cfg
        self.transcript: list = []
        self.server = _server(side, data_dir, **cfg)
        self.server.open()

    def req(self, method, path, body=None, headers=None, record=True):
        st, ctype, payload = _http(self.server, method, path, body, headers)
        parsed = json.loads(payload or b"{}") if (ctype or "").startswith("application/json") else payload
        if record:
            self.transcript.append((method, path, st, ctype, _mask(path, parsed)))
        return st, parsed

    def query(self, index, pql, proto=False):
        """A query as JSON, and (``proto``) again as protobuf."""
        out = self.req("POST", f"/index/{index}/query", pql.encode())
        if proto:
            self.req(
                "POST",
                f"/index/{index}/query",
                ref_proto.encode_query_request(pql, shards=None),
                headers={"Content-Type": PROTO, "Accept": PROTO},
            )
        return out

    def restart(self) -> None:
        self.server.close()
        self.server = _server(self.side, self.data_dir, **self.cfg)
        self.server.open()

    def close(self) -> None:
        self.server.close()


def _phantom(ischema: dict) -> bool:
    """ROADMAP C3, a fault of the reference: its translate store's
    directory ``<data-dir>/translate`` opens as an empty index named
    "translate" (test_reference_lists_its_translate_directory_as_an_index)."""
    return ischema.get("name") == "translate" and not ischema.get("fields")


def _mask(path: str, body):
    if not isinstance(body, dict):
        return body
    if path == "/version":
        return {**body, "version": "<masked>"}
    if path == "/status":
        return {k: v for k, v in body.items() if k != "device"}
    if path in ("/schema", "/index") and "indexes" in body:
        return {**body, "indexes": [i for i in body["indexes"] if not _phantom(i)]}
    if path == "/internal/shards/max":
        return {"standard": {k: v for k, v in body["standard"].items() if k != "translate"}}
    return body


def run_both(tmp_path, sequence, **cfg):
    """Run ``sequence(client)`` on each side; assert equal transcripts.
    Returns the two clients' transcripts."""
    out = {}
    for side in ("ref", "port"):
        c = Client(side, str(tmp_path / side), **cfg)
        try:
            sequence(c)
        finally:
            c.close()
        out[side] = c.transcript
    ref, port = out["ref"], out["port"]
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert a == b
    return ref, port


# -- the sequences ------------------------------------------------------------


def star_trace(c: Client) -> None:
    c.req("GET", "/version")
    c.req("GET", "/info")
    c.req("GET", "/status")
    c.req("POST", "/index/repository", {})
    c.req("POST", "/index/repository/field/stargazer", {"options": {"type": "time", "timeQuantum": "YMD"}})
    c.req("POST", "/index/repository/field/language", {"options": {}})
    for q in [
        "Set(10, stargazer=1)",
        "Set(20, stargazer=1)",
        "Set(10, stargazer=2)",
        "Set(30, stargazer=2)",
        "Set(10, language=5)",
        "Set(20, language=5)",
        "Set(10, stargazer=3, 2017-05-01T00:00)",
    ]:
        c.query("repository", q)
    for q in (
        "Row(stargazer=1)",
        "Intersect(Row(stargazer=1), Row(stargazer=2))",
        "Count(Row(stargazer=2))",
        "Union(Row(stargazer=1), Row(language=5)) Xor(Row(stargazer=1), Row(stargazer=2))",
    ):
        c.query("repository", q, proto=True)
    c.req("POST", "/recalculate-caches")
    c.query("repository", "TopN(stargazer, n=2)", proto=True)
    c.query("repository", "TopN(stargazer, Row(language=5), n=3)", proto=True)
    c.query("repository", "Range(stargazer=3, 2017-01-01T00:00, 2018-01-01T00:00)", proto=True)
    c.req("GET", "/schema")
    c.req("GET", "/index/repository")
    c.req("GET", "/index/repository/field/stargazer/views")
    c.req("GET", "/internal/shards/max")
    c.req("GET", "/internal/fragments")


def bsi_over_http(c: Client) -> None:
    c.req("POST", "/index/i", {})
    c.req("POST", "/index/i/field/bytes", {"options": {"type": "int", "min": 0, "max": 1000000}})
    for col, v in [(1, 100), (2, 2000), (3, 30000)]:
        c.query("i", f"SetValue(col={col}, bytes={v})")
    for q in (
        'Sum(field="bytes")',
        "Range(bytes > 1000)",
        'Min(field="bytes") Max(field="bytes")',
        "Count(Range(bytes >< [100, 2000]))",
    ):
        c.query("i", q, proto=True)


def import_and_export(c: Client) -> None:
    rng = np.random.default_rng(7)
    c.req("POST", "/index/i", {})
    c.req("POST", "/index/i/field/f", {})
    rows = rng.integers(0, 6, size=300).tolist()
    cols = rng.integers(0, 2 * SHARD_WIDTH, size=300).tolist()
    c.req("POST", "/index/i/field/f/import", {"rowIDs": rows, "columnIDs": cols})
    # and as protobuf, the way the reference's client sends it
    body = ref_proto.encode_import_request("i", "f", 1, row_ids=[7, 7], column_ids=[SHARD_WIDTH + 5, SHARD_WIDTH + 9], timestamps=None)
    c.req("POST", "/index/i/field/f/import", body, headers={"Content-Type": PROTO})
    c.req("POST", "/recalculate-caches")
    for q in ("Row(f=1)", "Count(Row(f=7))", "TopN(f, n=4)", "Count(Union(Row(f=0), Row(f=2)))"):
        c.query("i", q, proto=True)
    for shard in (0, 1, 2):
        c.req("GET", f"/export?index=i&field=f&shard={shard}")


def import_values(c: Client) -> None:
    rng = np.random.default_rng(11)
    c.req("POST", "/index/i", {})
    c.req("POST", "/index/i/field/v", {"options": {"type": "int", "min": -10, "max": 10}})
    cols = rng.choice(3 * SHARD_WIDTH, size=120, replace=False).tolist()
    vals = rng.integers(-10, 11, size=120).tolist()
    c.req("POST", "/index/i/field/v/import-value", {"columnIDs": cols, "values": vals})
    body = ref_proto.encode_import_value_request("i", "v", 0, column_ids=[1, 2, 3], values=[-5, 0, 7])
    c.req("POST", "/index/i/field/v/import-value", body, headers={"Content-Type": PROTO})
    for q in ('Sum(field="v")', 'Min(field="v")', 'Max(field="v")', "Count(Range(v > 2))", "Range(v == -5)"):
        c.query("i", q, proto=True)


def error_handling(c: Client) -> None:
    c.req("POST", "/index/nope/query", b"Row(f=1)")
    c.req("POST", "/index/i", {})
    c.req("POST", "/index/i", {})
    c.req("POST", "/index/i/query", b"BadCall(")
    c.req("GET", "/no/such/route")
    c.req("POST", "/index/i/query", b"Row(nofield=1)")
    c.req("POST", "/index/i/field/f", {})
    c.req("POST", "/index/i/field/f", {})
    c.req("DELETE", "/index/i/field/nofield")
    c.req("POST", "/index/i/query", b"Rows(f)")
    c.req("GET", "/export?index=i&field=f")
    c.req("DELETE", "/index/i")
    c.req("DELETE", "/index/i")


def persistence_across_restart(c: Client) -> None:
    c.req("POST", "/index/i", {})
    c.req("POST", "/index/i/field/f", {})
    c.query("i", "Set(7, f=1)")
    node_id = c.server.node_id
    c.restart()
    assert c.server.node_id == node_id
    c.query("i", "Row(f=1)", proto=True)


def restart_durability_fuzz(c: Client) -> None:
    """The randomized write mix of test_server_http's durability fuzz
    without its attributes (ROADMAP A9): sets, clears, timestamps and
    int values across op-log tails; a restart answers the same."""
    rng = np.random.default_rng(12345)
    c.req("POST", "/index/i", {})
    c.req("POST", "/index/i/field/f", {})
    c.req("POST", "/index/i/field/t", {"options": {"type": "time", "timeQuantum": "YMD"}})
    c.req("POST", "/index/i/field/v", {"options": {"type": "int", "min": -100, "max": 900}})
    days = ["2021-03-05T08:00", "2021-03-17T20:00", "2021-06-01T00:00"]
    batch = []
    for _ in range(600):
        kind = rng.random()
        col = int(rng.integers(0, 3 * SHARD_WIDTH))
        row = int(rng.integers(0, 20))
        if kind < 0.6:
            batch.append(f"Set({col}, f={row})")
        elif kind < 0.7:
            batch.append(f"Clear({col}, f={row})")
        elif kind < 0.85:
            batch.append(f"Set({col}, t={row}, {days[rng.integers(0, 3)]})")
        else:
            batch.append(f"SetValue(col={col}, v={int(rng.integers(-100, 901))})")
    for i in range(0, len(batch), 200):
        c.req("POST", "/index/i/query", " ".join(batch[i : i + 200]).encode())
    queries = []
    for r in range(0, 20, 5):
        queries += [
            f"Count(Row(f={r}))",
            f"TopN(f, Row(f={r}), n=5)",
            f"Count(Range(t={r}, 2021-03-01T00:00, 2021-04-01T00:00))",
        ]
    queries += ["Sum(field=v)", "Min(field=v)", "Max(field=v)", "Count(Range(v > 250))", "Count(Range(v >< [-50, 500]))"]
    c.req("POST", "/recalculate-caches")
    for q in queries:
        c.query("i", q)
    c.restart()
    c.req("POST", "/recalculate-caches")
    for q in queries:
        c.query("i", q, proto=True)


def backup_restore(c: Client) -> None:
    """Fragment archives off every (field, view, shard) into a second
    index; the holder archive (/backup) restored over a wiped index."""
    rng = np.random.default_rng(31337)
    c.req("POST", "/index/b", {})
    c.req("POST", "/index/b/field/f", {})
    c.req("POST", "/index/b/field/v", {"options": {"type": "int", "min": 0, "max": 99}})
    rows = rng.integers(0, 10, size=400).tolist()
    cols = rng.integers(0, 2 * SHARD_WIDTH, size=400).tolist()
    c.req("POST", "/index/b/field/f/import", {"rowIDs": rows, "columnIDs": cols})
    vcols = rng.choice(2 * SHARD_WIDTH, size=80, replace=False).tolist()
    c.req("POST", "/index/b/field/v/import-value", {"columnIDs": vcols, "values": rng.integers(0, 100, size=80).tolist()})
    c.req("POST", "/recalculate-caches")
    queries = [f"Count(Row(f={r}))" for r in range(0, 10, 3)] + ["TopN(f, n=5)", "Sum(field=v)", "Count(Range(v >= 50))"]
    for q in queries:
        c.query("b", q)
    c.req("POST", "/index/c", {})
    c.req("POST", "/index/c/field/f", {})
    c.req("POST", "/index/c/field/v", {"options": {"type": "int", "min": 0, "max": 99}})
    _, views = c.req("GET", "/index/b/field/v/views")
    for field, vlist in (("f", ["standard"]), ("v", views["views"])):
        for view in vlist:
            for shard in (0, 1):
                path = f"/internal/fragment/data?index=b&field={field}&view={view}&shard={shard}"
                st, data = c.req("GET", path, record=False)
                assert st == 200
                path_c = path.replace("index=b", "index=c")
                c.req("POST", path_c, data)
    c.req("POST", "/recalculate-caches")
    for q in queries:
        c.query("c", q)
    st, archive = c.req("GET", "/backup", record=False)
    assert st == 200
    c.req("DELETE", "/index/b")
    c.query("b", "Count(Row(f=3))")
    c.req("POST", "/restore", archive)
    c.req("POST", "/restore", archive[:-100] + b"x" * 100)
    c.req("POST", "/recalculate-caches")
    for q in queries:
        c.query("b", q, proto=True)


def fragment_data_roundtrip(c: Client) -> None:
    c.req("POST", "/index/i", {})
    c.req("POST", "/index/i/field/f", {})
    c.query("i", "Set(1, f=1)Set(2, f=1)")
    st, data = c.req("GET", "/internal/fragment/data?index=i&field=f&shard=0", record=False)
    assert st == 200
    c.req("GET", "/internal/fragment/blocks?index=i&field=f&shard=0")
    c.req("GET", "/internal/fragment/block/data?index=i&field=f&shard=0&block=0")
    c.req("POST", "/index/i/field/g", {})
    c.req("POST", "/internal/fragment/data?index=i&field=g&shard=0", data)
    c.query("i", "Row(g=1)", proto=True)
    c.req("GET", "/internal/fragment/data?index=i&field=nope&shard=0")


def malformed_protobuf(c: Client) -> None:
    c.req("POST", "/index/mp", b"")
    c.req("POST", "/index/mp/field/f", b"")
    good = ref_proto.encode_import_request("mp", "f", 0, row_ids=[1, 2], column_ids=[10, 20], timestamps=None)
    c.req("POST", "/index/mp/field/f/import", good[:-3], headers={"Content-Type": PROTO})
    c.query("mp", "Count(Row(f=1))", proto=True)


def query_protobuf_errors(c: Client) -> None:
    c.req("POST", "/index/qe", b"")
    bad = ref_proto.encode_query_request("ThisIsNotPQL((", shards=None)
    c.req("POST", "/index/qe/query", bad, headers={"Content-Type": PROTO})
    c.req("POST", "/index/nope/query", ref_proto.encode_query_request("Row(f=1)", shards=None), headers={"Content-Type": PROTO, "Accept": PROTO})
    c.req("POST", "/index/qe/query", b"Row(f=1)", headers={"Accept": PROTO})


@pytest.mark.parametrize(
    "sequence",
    [
        star_trace,
        bsi_over_http,
        import_and_export,
        import_values,
        error_handling,
        persistence_across_restart,
        restart_durability_fuzz,
        backup_restore,
        fragment_data_roundtrip,
        malformed_protobuf,
        query_protobuf_errors,
    ],
    ids=lambda f: f.__name__,
)
def test_port_answers_as_the_reference(tmp_path, sequence):
    ref, _ = run_both(tmp_path, sequence)
    # every sequence sends queries
    assert any("/query" in path for _, path, _, _, _ in ref)


def test_periodic_cache_flush(tmp_path):
    """Both servers persist the TopN cache on the flush interval, not
    only at close (reference monitorCacheFlush, holder.go:425)."""
    from pilosa_tpu_torch.core.cache import read_cache

    got = {}
    for side in ("ref", "port"):
        s = _server(side, str(tmp_path / side), metric="none", cache_flush_interval=0.2, anti_entropy_interval=0)
        s.open()
        try:
            _http(s, "POST", "/index/cf")
            _http(s, "POST", "/index/cf/field/f")
            _http(s, "POST", "/index/cf/query", b"Set(1, f=3) Set(2, f=3)")
            path = s.holder.fragment("cf", "f", "standard", 0).cache_path()
            deadline = time.time() + 5
            while time.time() < deadline and not os.path.exists(path):
                time.sleep(0.05)
            got[side] = read_cache(path) if os.path.exists(path) else None
        finally:
            s.close()
    assert got["ref"] == got["port"] == [3]


def test_port_serves_a_data_directory_the_reference_wrote(tmp_path):
    """State carries across: the fragment format is shared, so the
    port's server answers the reference's data directory as the
    reference answered it before it closed."""
    data = str(tmp_path / "shared")
    writer = Client("ref", data)
    try:
        star_trace(writer)
        bsi_over_http(writer)
        import_and_export(writer)
        reads = [
            ("repository", "Row(stargazer=1)"),
            ("repository", "TopN(stargazer, n=2)"),
            ("repository", "Range(stargazer=3, 2017-01-01T00:00, 2018-01-01T00:00)"),
            ("i", 'Sum(field="bytes")'),
            ("i", "Count(Range(bytes >< [100, 2000]))"),
            ("i", "TopN(f, n=4)"),
            ("i", "Count(Union(Row(f=0), Row(f=2)))"),
        ]
        writer.transcript.clear()
        for index, q in reads:
            writer.query(index, q, proto=True)
        writer.req("GET", "/schema")
        want = list(writer.transcript)
    finally:
        writer.close()
    reader = Client("port", data)
    try:
        for index, q in reads:
            reader.query(index, q, proto=True)
        reader.req("GET", "/schema")
    finally:
        reader.close()
    assert reader.transcript == want


def test_reference_lists_its_translate_directory_as_an_index(tmp_path):
    """ROADMAP C3: the reference's schema lists a phantom index for its
    own translate directory; the port, which has no translate store,
    lists only the user's indexes."""
    schemas = {}
    for side in ("ref", "port"):
        c = Client(side, str(tmp_path / side))
        try:
            c.req("POST", "/index/i", {})
            schemas[side] = [i["name"] for i in c.req("GET", "/schema", record=False)[1]["indexes"]]
        finally:
            c.close()
    assert schemas == {"ref": ["i", "translate"], "port": ["i"]}


def attribute_requests(c: Client) -> None:
    """test_server_http's attribute sequence, then the same reads as
    protobuf and the two attribute diffs."""
    c.req("POST", "/index/i", {})
    c.req("POST", "/index/i/field/f", {})
    c.req(
        "POST", "/index/i/query",
        b'Set(1, f=10)SetRowAttrs(f, 10, category="search")SetColumnAttrs(1, name="acme")',
    )
    c.query("i", "Row(f=10)", proto=True)
    c.req("POST", "/index/i/query?columnAttrs=true", b"Row(f=10)")
    c.req(
        "POST",
        "/index/i/query",
        ref_proto.encode_query_request("Row(f=10)", column_attrs=True),
        headers={"Content-Type": PROTO, "Accept": PROTO},
    )
    c.req("POST", "/index/i/query", b'SetRowAttrs(f, 10, category=null, rank=3)SetColumnAttrs(2, name="x")')
    c.query("i", "Row(f=10)")
    c.req("POST", "/index/i/query?excludeRowAttrs=true", b"Row(f=10)")
    for path in ("/internal/index/i/attr/diff", "/internal/index/i/field/f/attr/diff"):
        c.req("POST", path, {"blocks": []})
        c.req("POST", path, {"blocks": [[0, "00" * 16]]})
    c.req("POST", "/internal/index/nope/attr/diff", {"blocks": []})


def test_attribute_requests_answer_501_naming_a9(tmp_path):
    """Attribute requests, refused with 501 naming ROADMAP A9 until the
    port had attribute stores, answer as the reference's: SetRowAttrs,
    SetColumnAttrs, a Row's attrs, ``columnAttrs`` (JSON and protobuf)
    and the attribute diffs."""
    ref, _ = run_both(tmp_path, attribute_requests)
    assert ref[3][4] == {"results": [{"attrs": {"category": "search"}, "columns": [1]}]}
    assert ref[5][4]["columnAttrs"] == [{"id": 1, "attrs": {"name": "acme"}}]


def key_requests(c: Client) -> None:
    """test_server_http's key sequence, then key imports, keyed ingest
    and the translate routes, whose log bytes must be equal."""
    c.req("POST", "/index/users", {"options": {"keys": True}})
    c.req("POST", "/index/users/field/likes", {"options": {"keys": True}})
    c.query("users", 'Set("alice", likes="pizza")')
    c.query("users", 'Set("bob", likes="pizza")')
    c.query("users", 'Row(likes="pizza")', proto=True)
    c.query("users", "TopN(likes, n=5)")
    c.req("POST", "/index/users/field/likes/import", {"rowKeys": ["sushi", "pizza"], "columnKeys": ["carol", "dave"]})
    c.req(
        "POST", "/index/users/field/likes/ingest",
        {"rowKeys": ["tacos", "tacos", "sushi"], "columnKeys": ["erin", "alice", "frank"]},
    )
    c.req("POST", "/recalculate-caches")
    c.query("users", 'Count(Row(likes="sushi"))TopN(likes, Row(likes="tacos"), n=3)Row(likes="nope")')
    c.req("POST", "/index/users/field/age", {"options": {"type": "int", "min": 0, "max": 120}})
    c.req("POST", "/index/users/field/age/import-value", {"columnKeys": ["alice", "bob"], "values": [31, 44]})
    c.query("users", 'Sum(field="age")Row(likes="pizza")')
    c.req("GET", "/debug/translate")
    _, stores = c.req("GET", "/internal/translate/stores")
    for entry in stores:
        c.req("GET", f"/internal/translate/data?store={entry['name']}&offset=0")
    c.req("POST", "/internal/translate/keys", {"index": "users", "field": "likes", "keys": ["pizza", "ramen"]})
    c.req("POST", "/internal/translate/keys", {})
    c.req("GET", "/internal/translate/data?store=../x&offset=0")
    c.req("POST", "/index/plain", {})
    c.req("POST", "/index/plain/field/f", {})
    c.query("plain", 'Set("alice", f=1)')


def test_key_translation_requests_answer_501_naming_a9(tmp_path):
    """Keyed requests, refused with 501 naming ROADMAP A9 until the port
    had a translate store, answer as the reference's; then a keyed index
    the reference wrote is served by the port's server, and one the port
    wrote by the reference's, with the same answers."""
    ref, _ = run_both(tmp_path, key_requests)
    row = next(t for t in ref if t[1] == "/index/users/query" and t[2] == 200 and "keys" in str(t[4]))
    assert sorted(row[4]["results"][0]["keys"]) == ["alice", "bob"]
    reads = 'Row(likes="pizza")Count(Row(likes="sushi"))TopN(likes, n=5)Sum(field="age")'
    for writer, reader in (("ref", "port"), ("port", "ref")):
        data = str(tmp_path / writer)
        answers, logs = {}, {}
        for side in (writer, reader):
            c = Client(side, data)
            try:
                c.req("POST", "/recalculate-caches")
                answers[side] = c.query("users", reads)
            finally:
                c.close()
        # each side mints on a copy of the directory: the same new ids,
        # and the same log bytes after them
        for side in (writer, reader):
            copy = str(tmp_path / f"{writer}-{side}")
            shutil.copytree(data, copy)
            c = Client(side, copy)
            try:
                c.query("users", 'Set("new", likes="ramen")Set("bob", likes="ramen")')
            finally:
                c.close()
            logs[side] = _translate_logs(copy)
        assert answers[reader] == answers[writer]
        assert answers[reader][0] == 200
        assert logs[reader] == logs[writer] and logs[writer]


def _translate_logs(data_dir: str) -> dict:
    root = os.path.join(data_dir, "translate")
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".log"):
                with open(os.path.join(d, fn), "rb") as f:
                    out[os.path.relpath(os.path.join(d, fn), root)] = f.read()
    return out


@pytest.mark.parametrize(
    "method,path,body",
    [
        ("GET", "/debug/translate", None),
        ("GET", "/internal/translate/data?offset=0", None),
        ("GET", "/internal/translate/data?store=u/rows.f&offset=0", None),
        ("GET", "/internal/translate/stores", None),
        ("POST", "/internal/translate/keys", {"index": "u", "field": "f", "keys": ["a", "b", "c"]}),
        ("POST", "/internal/index/i/attr/diff", {"blocks": []}),
        ("POST", "/internal/index/i/field/f/attr/diff", {"blocks": [[0, "00" * 16]]}),
    ],
)
def test_translate_and_attribute_routes_answer_as_the_reference(tmp_path, method, path, body):
    """The routes that answered 501 naming ROADMAP A9, each on both
    servers over the same data."""

    def sequence(c: Client) -> None:
        c.req("POST", "/index/i", {})
        c.req("POST", "/index/i/field/f", {})
        c.query("i", 'Set(3, f=1)SetRowAttrs(f, 1, kind="hot")SetColumnAttrs(3, region="eu")')
        c.req("POST", "/index/u", {"options": {"keys": True}})
        c.req("POST", "/index/u/field/f", {"options": {"keys": True}})
        c.query("u", 'Set("k1", f="a")Set("k2", f="b")')
        c.req(method, path, body)

    ref, _ = run_both(tmp_path, sequence)
    assert ref[-1][2] == 200


def test_schema_lists_no_translate_index(tmp_path):
    """ROADMAP C3: the port's server keeps its translate logs in
    ``<data-dir>/translate`` and its holder does not open them as an
    index, on a restart either."""
    c = Client("port", str(tmp_path / "p"))
    try:
        c.req("POST", "/index/u", {"options": {"keys": True}})
        c.req("POST", "/index/u/field/f", {"options": {"keys": True}})
        assert c.query("u", 'Set("k", f="r")')[0] == 200
        c.restart()
        assert os.listdir(os.path.join(c.data_dir, "translate", "u"))
        _, body = c.req("GET", "/schema")
        assert [i["name"] for i in body["indexes"]] == ["u"]
        assert c.req("POST", "/index/translate", {})[0] == 400
        assert c.query("u", 'Row(f="r")')[1]["results"][0]["keys"] == ["k"]
    finally:
        c.close()


def test_fusion_and_plan_cache_answer_as_the_reference(tmp_path):
    """Both servers on their defaults (fusion and the plan cache on): a
    multi-call read over two shards fuses into one launch, its repeat is
    served by the plan cache, ``cache=false`` bypasses it, a write
    invalidates; answers, ``/debug/plancache`` and ``/debug/fusion``'s
    counters are the reference's."""
    q = "Count(Row(f=1))Count(Intersect(Row(f=1), Row(f=2)))TopN(f, Row(f=2), n=3)"
    out = {}
    for side in ("ref", "port"):
        c = Client(side, str(tmp_path / side))
        try:
            c.req("POST", "/index/i", {})
            c.req("POST", "/index/i/field/f", {})
            cols = [3, 9, 20, SHARD_WIDTH + 4, SHARD_WIDTH + 7]
            c.query("i", "".join(f"Set({col}, f=1)" for col in cols))
            c.query("i", "".join(f"Set({col}, f=2)" for col in cols[1:]))
            c.req("POST", "/recalculate-caches")
            answers = [c.query("i", q)[1] for _ in range(2)]
            answers.append(c.req("POST", "/index/i/query?cache=false", q.encode())[1])
            c.query("i", f"Set({SHARD_WIDTH + 11}, f=1)")
            answers.append(c.query("i", q)[1])
            _, pc = c.req("GET", "/debug/plancache")
            _, fu = c.req("GET", "/debug/fusion")
            out[side] = (answers, pc, fu)
        finally:
            c.close()
    (ref_answers, ref_pc, ref_fu), (answers, pc, fu) = out["ref"], out["port"]
    assert answers == ref_answers
    assert answers[0]["results"][0] == 5 and answers[3]["results"][0] == 6
    assert pc == ref_pc
    assert pc["enabled"] and pc["hits"] >= 3 and pc["invalidations"] >= 1
    assert set(fu) == set(ref_fu)
    for key in ("enabled", "max_calls", "fused_launches", "fused_calls", "cache_served", "admission_splits"):
        assert fu[key] == ref_fu[key], key
    assert fu["fused_launches"] == 3
    assert fu["device_cache"]["enabled"] and ref_fu["device_cache"]["enabled"]


@pytest.mark.parametrize(
    "method,path,item",
    [
        ("POST", "/internal/cluster/message", "A8"),
        ("GET", "/internal/fragment/nodes?index=i&shard=0", "A8"),
        ("POST", "/internal/gang/apply", "A8"),
        ("GET", "/debug/fleet", "A8"),
        ("GET", "/debug/scrub", "A8"),
        ("GET", "/debug/dispatch", "A6"),
        ("GET", "/metrics?fleet=true", "A8"),
    ],
)
def test_unported_routes_answer_501_with_their_item(tmp_path, method, path, item):
    c = Client("port", str(tmp_path / "p"))
    try:
        st, body = c.req(method, path, {} if method == "POST" else None)
        assert st == 501 and f"ROADMAP {item}" in body["error"]
    finally:
        c.close()


def test_status_reports_the_device_and_its_gate(tmp_path):
    c = Client("port", str(tmp_path / "p"))
    try:
        _, body = c.req("GET", "/status")
        assert body["device"] == {"type": "cpu", "healthy": True, "trips": 0, "cpu_fallbacks": body["device"]["cpu_fallbacks"]}
        _, prof = c.req("GET", "/debug/profile")
        assert prof["capture"] == {"running": False, "dir": None}
    finally:
        c.close()


# -- fault injection and the journal (ROADMAP A7) ------------------------------------


def _chaos_sides(tmp_path, **cfg):
    return {side: Client(side, str(tmp_path / side), **cfg) for side in ("ref", "port")}


def test_debug_chaos_answers_as_the_reference(tmp_path):
    """``GET /debug/chaos`` has the reference's shape: the same keys at
    every level, the same fault flags, OOM counters and trips, and the
    governor's ledger with the same tenants."""
    sides = _chaos_sides(tmp_path, chaos_enabled=True)
    try:
        got = {side: c.req("GET", "/debug/chaos") for side, c in sides.items()}
        for side, c in sides.items():
            c.req("POST", "/debug/chaos", {"device": "oom_every=3"})
        installed = {side: c.req("GET", "/debug/chaos")[1] for side, c in sides.items()}
    finally:
        for c in sides.values():
            c.close()
    (rst, ref), (pst, port) = got["ref"], got["port"]
    assert rst == pst == 200
    assert set(port) == set(ref)
    for key in ("enabled", "oom", "health_trips", "faults"):
        assert port[key] == ref[key], key
    assert set(port["governor"]) == set(ref["governor"])
    assert set(port["governor"]["tenants"]) <= set(ref["governor"]["tenants"])
    assert port["governor"]["used_bytes"] == ref["governor"]["used_bytes"] == 0
    assert installed["port"]["faults"] == installed["ref"]["faults"] == {"storage": False, "device": True}


def test_chaos_window_gate_errors_and_journal_as_the_reference(tmp_path):
    """Without ``chaos-enabled`` a POST answers 403; an unknown knob 400;
    an install then a clear each journal ``chaos.window`` — status codes
    and bodies ``==`` the reference's, journal records equal but for the
    time and sequence stamps."""
    from pilosa_tpu.utils import events as ref_events
    from pilosa_tpu_torch.utils import events

    journals = {"ref": ref_events, "port": events}
    out = {}
    for side in ("ref", "port"):
        off = Client(side, str(tmp_path / side / "off"))
        try:
            forbidden = off.req("POST", "/debug/chaos", {"device": "oom_every=1"}, record=False)
            assert off.req("GET", "/debug/chaos", record=False)[1]["enabled"] is False
        finally:
            off.close()
        c = Client(side, str(tmp_path / side / "on"), chaos_enabled=True)
        try:
            seq0 = journals[side].JOURNAL.snapshot(limit=1)[-1]["seq"] if journals[side].JOURNAL.snapshot() else 0
            answers = [
                c.req("POST", "/debug/chaos", {"device": "bogus_every=1"}, record=False),
                c.req("POST", "/debug/chaos", {"storage": "fsync_fail_every=9", "device": "oom_every=2,stall_s=0.01"},
                      record=False),
                c.req("POST", "/debug/chaos", {}, record=False),
            ]
            st, body = c.req("GET", f"/debug/events?kind=chaos.window&since={seq0}", record=False)
        finally:
            c.close()
        windows = [{k: v for k, v in e.items() if k not in ("t", "seq")} for e in body["events"]]
        out[side] = (forbidden, answers, st, windows)
    assert out["port"] == out["ref"]
    forbidden, answers, st, windows = out["port"]
    assert forbidden[0] == 403 and "chaos-enabled" in forbidden[1]["error"]
    assert [a[0] for a in answers] == [400, 200, 200]
    assert [w["action"] for w in windows] == ["install", "clear"]


def test_default_journal_lives_beside_the_data_as_the_reference(tmp_path):
    """The default Config keeps the journal on disk under
    ``<data-dir>/.events`` on both sides, across a restart, and the
    holder lists no ``.events`` index."""
    from pilosa_tpu.utils import events as ref_events
    from pilosa_tpu_torch.utils import events

    for side, journal in (("ref", ref_events), ("port", events)):
        c = Client(side, str(tmp_path / side))
        try:
            c.req("POST", "/index/i", record=False)
            first = journal.record("chaos.window", action="install")["seq"]
            c.restart()
            assert journal.JOURNAL.durable
            c.req("POST", "/index/j", record=False)
            _, schema = c.req("GET", "/schema", record=False)
            _, body = c.req("GET", "/debug/events?kind=chaos.window", record=False)
        finally:
            c.close()
        assert not journal.JOURNAL.durable
        segs = os.listdir(tmp_path / side / ".events")
        assert segs and all(s.startswith("events-") for s in segs)
        assert [i["name"] for i in schema["indexes"] if not _phantom(i)] == ["i", "j"]
        assert first in [e["seq"] for e in body["events"]]
