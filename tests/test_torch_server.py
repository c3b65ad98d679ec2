"""The port's HTTP server against the JAX package's, request by request.

Each case drives the same request sequence (the single-node sequences of
``tests/test_server_http.py``, with data drawn from a numpy seed) through
``pilosa_tpu.server.Server`` (JAX on the CPU, ``device_policy="always"``)
and ``pilosa_tpu_torch.server.Server(Config(device="cpu",
device_policy="always"))``, each on its own data directory and bound to
127.0.0.1:0. Status codes, content types, JSON bodies and protobuf bytes
must be equal. Masked: the version string of ``/version`` and the port's
``device`` block of ``/status`` (the backend). Attributes and keys are
not ported: their requests must answer 501 naming ROADMAP A9.
"""

from __future__ import annotations

import json
import os
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


def _body_names_a9(st, body) -> bool:
    return st == 501 and "ROADMAP A9" in body["error"]


def test_attribute_requests_answer_501_naming_a9(tmp_path):
    c = Client("port", str(tmp_path / "p"))
    try:
        c.req("POST", "/index/i", {})
        c.req("POST", "/index/i/field/f", {})
        st, body = c.req(
            "POST", "/index/i/query",
            b'Set(1, f=10)SetRowAttrs(f, 10, category="search")SetColumnAttrs(1, name="acme")',
        )
        assert _body_names_a9(st, body)
        # nothing of the refused request was applied
        assert c.query("i", "Row(f=10)")[1] == {"results": [{"attrs": {}, "columns": []}]}
        st, body = c.req("POST", "/index/i/query?columnAttrs=true", b"Row(f=10)")
        assert _body_names_a9(st, body)
        for path in ("/internal/index/i/attr/diff", "/internal/index/i/field/f/attr/diff"):
            assert _body_names_a9(*c.req("POST", path, {"blocks": []}))
    finally:
        c.close()


def test_key_translation_requests_answer_501_naming_a9(tmp_path):
    c = Client("port", str(tmp_path / "p"))
    try:
        assert _body_names_a9(*c.req("POST", "/index/users", {"options": {"keys": True}}))
        c.req("POST", "/index/plain", {})
        assert _body_names_a9(*c.req("POST", "/index/plain/field/likes", {"options": {"keys": True}}))
        c.req("POST", "/index/plain/field/f", {})
        st, body = c.req("POST", "/index/plain/field/f/import", {"rowKeys": ["a"], "columnKeys": ["b"]})
        assert _body_names_a9(st, body)
        assert _body_names_a9(*c.req("GET", "/debug/translate"))
        assert _body_names_a9(*c.req("POST", "/internal/translate/keys", {"index": "plain", "keys": ["x"]}))
    finally:
        c.close()
    # a keyed index the reference wrote: the port's server refuses its
    # queries by name instead of answering with untranslated ids
    data = str(tmp_path / "keyed")
    ref = Client("ref", data)
    try:
        ref.req("POST", "/index/users", {"options": {"keys": True}})
        ref.req("POST", "/index/users/field/likes", {"options": {"keys": True}})
        assert ref.query("users", 'Set("alice", likes="pizza")')[0] == 200
    finally:
        ref.close()
    port = Client("port", data)
    try:
        assert _body_names_a9(*port.query("users", 'Row(likes="pizza")'))
    finally:
        port.close()


@pytest.mark.parametrize(
    "method,path,item",
    [
        ("POST", "/internal/cluster/message", "A8"),
        ("GET", "/internal/fragment/nodes?index=i&shard=0", "A8"),
        ("POST", "/internal/gang/apply", "A8"),
        ("GET", "/debug/fleet", "A8"),
        ("GET", "/debug/scrub", "A8"),
        ("GET", "/debug/chaos", "A7"),
        ("GET", "/debug/profile?capture=start", "A7"),
        ("GET", "/debug/dispatch", "A6"),
        ("GET", "/debug/fusion", "A5"),
        ("GET", "/debug/plancache", "A5"),
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
