"""The golden fixtures (``tests/golden_fixtures.json``, transcribed from
the reference's executor_test.go) against the port: each fixture's data
is written by the JAX package's holder and executor (the writer of the
shared fragment format), the directory is opened with the port's
``holder_from_dir``, and the port answers each fixture's query on both
of its legs (``device_policy`` "never" and "always", ``device="cpu"``)
and through its HTTP server. The two attribute fixtures' row attributes
are written by the reference's attribute store and read by the port's
(``holder_from_dir`` and the server open them)."""

import json
import os
import urllib.error
import urllib.request

import pytest

import pilosa_tpu_torch
from pilosa_tpu.core import FieldOptions, Holder
from pilosa_tpu.executor import Executor as RefExecutor
from pilosa_tpu.utils.attrstore import new_attr_store
from pilosa_tpu_torch.core import Row
from pilosa_tpu_torch.executor.executor import ValCount
from pilosa_tpu_torch.server import Config, Server

HERE = os.path.dirname(__file__)
FIXTURES = json.load(open(os.path.join(HERE, "golden_fixtures.json")))["fixtures"]
BY_NAME = {f["name"]: f for f in FIXTURES}
SW = 1 << 20


def _expand(value):
    """'{SW+1}' -> 1048577 (fixture placeholders)."""
    if isinstance(value, str) and value.startswith("{") and value.endswith("}"):
        return eval(value[1:-1].replace("SW", str(SW)), {"__builtins__": {}})  # noqa: S307
    return value


def _expand_query(q: str) -> str:
    import re

    return re.sub(r"\{([^}]+)\}", lambda m: str(_expand("{" + m.group(1) + "}")), q)


def _base(fx):
    while "reuse" in fx:
        fx = BY_NAME[fx["reuse"]]
    return fx


def _write_fixture(h: Holder, fx) -> None:
    """One fixture's schema and data as index ``fx["name"]``, written by
    the reference (its executor runs the setup PQL)."""
    base = _base(fx)
    name = fx["name"]
    idx = h.create_index(name)
    for fname, opts in base["fields"].items():
        idx.create_field(fname, FieldOptions.from_dict(opts))
    setup = RefExecutor(h, device_policy="never", dispatch_enabled=False)
    for q in base.get("setup", []) + fx.get("extra_setup", []):
        setup.execute(name, _expand_query(q))
    setup.close()
    if "row_attrs" in base:
        ra = base["row_attrs"]
        h.field(name, ra["field"]).row_attr_store.set_attrs(ra["row"], ra["attrs"])
    if base.get("recalculate") or fx.get("recalculate"):
        for f in idx.fields.values():
            for v in f.views.values():
                for frag in v.fragments.values():
                    frag.cache.recalculate()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("golden"))
    h = Holder(d, new_attr_store=new_attr_store)
    h.open()
    for fx in FIXTURES:
        _write_fixture(h, fx)
    h.close()
    return d


@pytest.fixture(scope="module")
def port_holder(data_dir):
    h = pilosa_tpu_torch.holder_from_dir(data_dir)
    yield h
    h.close()


def _canon(result):
    if isinstance(result, Row):
        return ("columns", tuple(int(c) for c in result.columns()))
    if isinstance(result, ValCount):
        return ("valcount", result.val, result.count)
    if isinstance(result, list):
        return ("pairs", tuple((p["id"], p["count"]) for p in result))
    if isinstance(result, (int, bool)):
        return ("count", int(result))
    return ("other", repr(result))


def _canon_json(result):
    if isinstance(result, dict) and "columns" in result:
        return ("columns", tuple(result["columns"]))
    if isinstance(result, dict) and "value" in result:
        return ("valcount", result["value"], result["count"])
    if isinstance(result, list):
        return ("pairs", tuple((p["id"], p["count"]) for p in result))
    return ("count", int(result))


def _want(fx):
    e = fx["expect"]
    if "columns" in e:
        return ("columns", tuple(_expand(c) for c in e["columns"]))
    if "pairs" in e:
        return ("pairs", tuple((p[0], p[1]) for p in e["pairs"]))
    if "valcount" in e:
        return ("valcount", e["valcount"][0], e["valcount"][1])
    return ("count", e["count"])


@pytest.mark.parametrize("policy", ["never", "always"])
@pytest.mark.parametrize("fx", FIXTURES, ids=[f["name"] for f in FIXTURES])
def test_golden_executor(fx, policy, port_holder):
    ex = pilosa_tpu_torch.Executor(port_holder, device="cpu", device_policy=policy)
    try:
        q = _expand_query(fx["query"])
        if fx["expect"].get("error"):
            with pytest.raises(Exception):
                ex.execute(fx["name"], q)
        else:
            res = ex.execute(fx["name"], q)
            assert len(res) == 1
            assert _canon(res[0]) == _want(fx), fx["ref"]
    finally:
        ex.close()


@pytest.fixture(scope="module")
def server(data_dir, tmp_path_factory):
    # a copy of the directory: the executor legs keep theirs open
    import shutil

    d = str(tmp_path_factory.mktemp("golden_http"))
    shutil.copytree(data_dir, d, dirs_exist_ok=True)
    s = Server(Config(data_dir=d, bind="127.0.0.1:0", device="cpu", device_policy="always"))
    s.open()
    yield s
    s.close()


@pytest.mark.parametrize("fx", FIXTURES, ids=[f["name"] for f in FIXTURES])
def test_golden_http(fx, server):
    r = urllib.request.Request(
        f"{server.uri}/index/{fx['name']}/query",
        data=_expand_query(fx["query"]).encode(),
        method="POST",
    )
    try:
        with urllib.request.urlopen(r) as resp:
            st, body = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        st, body = e.code, json.loads(e.read())
    if fx["expect"].get("error"):
        assert st == 400 and body["error"]
    else:
        assert st == 200, body
        assert _canon_json(body["results"][0]) == _want(fx), fx["ref"]
