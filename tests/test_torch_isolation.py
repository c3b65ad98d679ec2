"""The port stands alone: it imports neither JAX nor the JAX package, and
without CUDA an entry point that was not asked for the CPU raises."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest
import torch

import pilosa_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pilosa_tpu_torch")

_PROBE = r"""
import os, sys, tempfile
import numpy as np
import pilosa_tpu_torch
from pilosa_tpu_torch.roaring.writer import build_fragment_file

d = tempfile.mkdtemp()
vdir = os.path.join(d, "i", "f", "views", "standard", "fragments")
os.makedirs(vdir)
SW = 1 << 20
pos = np.concatenate([np.arange(0, 5000, 3, dtype=np.uint64) + np.uint64(r * SW) for r in range(4)])
build_fragment_file(os.path.join(vdir, "0"), [pos])
h = pilosa_tpu_torch.holder_from_dir(d)
from pilosa_tpu_torch.core import FieldOptions
idx = h.create_index("b")
cols = list(range(0, 2 * SW, 4099))
idx.create_field("g").import_bits([c % 3 for c in cols], cols)
idx.create_field("v", FieldOptions(type="int", min=0, max=1000)).import_values(cols, [c % 1001 for c in cols])
ex = pilosa_tpu_torch.Executor(h, device="cpu", device_policy="always")
print(ex.execute("i", "Count(Intersect(Row(f=1), Row(f=2)))TopN(f, Row(f=0), n=2)"))
groups, n, pct = ex.execute("b", "GroupBy(Rows(g), Sum(field=v))Count(Range(v > 10))Percentile(field=v, nth=50)")
print("ANALYTICS", len(groups), sum(g["count"] for g in groups), n, pct.count)
ex.close()
# fusion, the plan cache and the planner's CSE rewrite
from pilosa_tpu_torch.executor import fusion
from pilosa_tpu_torch.plan import cache, planner
ex = pilosa_tpu_torch.Executor(h, device="cpu", device_policy="always", plan_cache=cache.PlanCache())
q = "Count(Intersect(Row(f=1), Row(f=2)))Count(Union(Intersect(Row(f=1), Row(f=2)), Row(f=0)))"
r1, r2 = ex.execute("i", q), ex.execute("i", q)
print("FUSED", r1 == r2, isinstance(ex.fuser, fusion.QueryFuser), ex.fuser.stats()["fused_launches"],
      ex.plan_cache.stats()["hits"] >= 2, planner.BITMAP_CALLS[0])
ex.close()
# a write, then a read, through a tiered, delta-enabled stager
from pilosa_tpu_torch.executor import DeviceStager
st = DeviceStager("cpu", tier1_max_bytes=1 << 20, compressed_min_ratio=4.0)
ex = pilosa_tpu_torch.Executor(h, device="cpu", device_policy="always", stager=st)
a = ex.execute("i", "Count(Row(f=1))")[0]
ex.execute("i", "Set(4, f=1)")
b = ex.execute("i", "Count(Row(f=1))")[0]
print("TIERED", a, b, st.delta_applies, st.tier1.stats()["admitted"])
ex.close()
h.close()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "pilosa_tpu" or m.startswith("pilosa_tpu."))
print("FOREIGN", bad)
"""


def test_import_and_query_pull_in_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    count, pairs = ast.literal_eval(lines[-5])
    assert count == 1667 and len(pairs) == 2 and pairs[0]["count"] == 1667
    ncols = len(range(0, 2 * (1 << 20), 4099))
    assert lines[-4].split()[:3] == ["ANALYTICS", "3", str(ncols)]
    assert 0 < int(lines[-4].split()[3]) < ncols and int(lines[-4].split()[4]) == ncols
    # one fused launch, then both calls served by the plan cache
    assert lines[-3] == "FUSED True True 1 True Row"
    # the write reached the staged row as one delta; tier 1 held its payloads
    assert lines[-2] == "TIERED 1667 1668 1 1"
    assert lines[-1] == "FOREIGN []"


_KEYS_PROBE = r"""
import sys, tempfile
import pilosa_tpu_torch
import pilosa_tpu_torch.parallel.hashing
import pilosa_tpu_torch.utils.attrstore
import pilosa_tpu_torch.utils.translate
from pilosa_tpu_torch.core import FieldOptions
from pilosa_tpu_torch.translate import SpaceStore, Translator, resolve
from pilosa_tpu_torch.plan import planner

d = tempfile.mkdtemp()
h = pilosa_tpu_torch.holder_from_dir(d)
idx = h.create_index("u", keys=True)
idx.create_field("f", FieldOptions(keys=True))
t = Translator(d + "/translate")
ex = pilosa_tpu_torch.Executor(h, device="cpu", device_policy="always", translate_store=t)
ex.execute("u", 'Set("a", f="x")Set("b", f="x")Set("b", f="y")SetRowAttrs(f, 1, c="k")SetColumnAttrs(2, n=1)')
row, top = ex.execute("u", 'Row(f="x")TopN(f, Row(f="x"), n=2, attrName="c", attrValues=["k"])')
print("KEYS", sorted(row.keys), row.attrs, top)
ex.close()
t.close()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "pilosa_tpu" or m.startswith("pilosa_tpu."))
print("FOREIGN", bad)
"""


def test_attribute_and_key_modules_pull_in_no_jax():
    """The key-translation and attribute modules (parallel/hashing,
    utils/attrstore, utils/translate, translate/, the planner's
    resolve_keys) import neither JAX nor the JAX package, and a keyed,
    attribute-filtered query runs through them."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _KEYS_PROBE], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "KEYS ['a', 'b'] {'c': 'k'} [{'key': 'x', 'count': 2}]"
    assert lines[-1] == "FOREIGN []"


_FOREIGN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+pilosa_tpu\b(?!_)|from\s+pilosa_tpu\b(?!_))")
_FOREIGN_NAME = re.compile(r"\bpilosa_tpu\.")


def _sources():
    for root, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, fn)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "chain_batch_probe.py")
    yield os.path.join(REPO, "ab_probe.py")


def test_sources_name_no_jax_and_no_jax_package():
    found = []
    for path in _sources():
        with open(path) as f:
            for no, line in enumerate(f, 1):
                if _FOREIGN.search(line) or _FOREIGN_NAME.search(line):
                    found.append(f"{os.path.relpath(path, REPO)}:{no}: {line.strip()}")
    assert not found, "\n".join(found)


def test_executor_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = pilosa_tpu_torch.holder_from_dir(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pilosa_tpu_torch.Executor(h)
        # an explicit CPU request is honoured
        pilosa_tpu_torch.Executor(h, device="cpu").close()
    finally:
        h.close()


def test_kernel_wrappers_refuse_cpu_tensors():
    from pilosa_tpu_torch.ops import cuda

    w = torch.zeros((2, 2048), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda.dense_scores(w, w)
    assert cuda.DENSE_SCORES.launches == 0


# -- the server and the CLI ---------------------------------------------------

_SERVER_PROBE = r"""
import sys, tempfile, urllib.request
import pilosa_tpu_torch.server
import pilosa_tpu_torch.cli.main
from pilosa_tpu_torch.server import Config, Server
s = Server(Config(data_dir=tempfile.mkdtemp(), bind="127.0.0.1:0", device="cpu"))
s.open()
urllib.request.urlopen(urllib.request.Request(s.uri + "/index/i", data=b"{}", method="POST")).read()
urllib.request.urlopen(urllib.request.Request(s.uri + "/index/i/field/f", data=b"{}", method="POST")).read()
urllib.request.urlopen(urllib.request.Request(s.uri + "/index/i/query", data=b"Set(3, f=1)", method="POST")).read()
print(urllib.request.urlopen(urllib.request.Request(s.uri + "/index/i/query", data=b"Count(Row(f=1))", method="POST")).read().decode())
s.close()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "pilosa_tpu" or m.startswith("pilosa_tpu."))
print("FOREIGN", bad)
"""


def _run(args, timeout=120, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout, **kw)


def test_server_and_cli_pull_in_no_jax():
    out = _run([sys.executable, "-c", _SERVER_PROBE])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == '{"results": [1]}'
    assert lines[-1] == "FOREIGN []"


def test_module_help_imports_no_jax():
    out = _run([sys.executable, "-X", "importtime", "-m", "pilosa_tpu_torch", "--help"])
    assert out.returncode == 0, out.stderr
    assert "server" in out.stdout and "generate-config" in out.stdout
    imported = [ln.rsplit("|", 1)[-1].strip() for ln in out.stderr.splitlines() if "|" in ln]
    assert "pilosa_tpu_torch.cli.main" in imported
    foreign = [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "pilosa_tpu")]
    assert foreign == []


def test_server_without_cuda_raises(monkeypatch, tmp_path):
    from pilosa_tpu_torch.server import Config, Server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(Config(data_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(Config(data_dir=str(tmp_path), device="cuda:0"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_cli_server_without_device_cpu_exits_nonzero(tmp_path):
    out = _run([sys.executable, "-m", "pilosa_tpu_torch", "server", "-d", str(tmp_path), "-b", "127.0.0.1:0"])
    assert out.returncode == 2
    assert "CUDA is not available" in out.stderr


@pytest.mark.parametrize(
    "flags,item",
    [
        (["--hosts", "a:1,b:2"], "A8"),
        (["--coordinator"], "A8"),
        (["--mesh-devices", "4"], "A8"),
        (["--distributed"], "A8"),
    ],
)
def test_cli_cluster_flags_exit_naming_their_item(tmp_path, flags, item, capsys):
    from pilosa_tpu_torch.cli.main import main

    assert main(["server", "--device", "cpu", "-d", str(tmp_path), *flags]) == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


@pytest.mark.parametrize(
    "key,value,item",
    [
        ("dispatch-enabled", True, "A6"),
        ("prefetch-enabled", True, "A6"),
        ("mesh-devices", 2, "A8"),
        ("distributed-enabled", True, "A8"),
        ("federation-leader", True, "A8"),
        ("scrub-interval", 300.0, "A8"),
        ("translate-primary-url", "http://x:1", "A8"),
    ],
)
def test_enabling_an_unported_subsystem_raises(tmp_path, key, value, item):
    from pilosa_tpu_torch.server import Config, Server

    cfg = Config.from_dict({key: value, "data-dir": str(tmp_path), "device": "cpu"})
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        Server(cfg)


def test_generate_config_prints_the_ports_defaults():
    out = _run([sys.executable, "-m", "pilosa_tpu_torch", "generate-config"])
    assert out.returncode == 0, out.stderr
    toml = out.stdout
    assert 'device = "cuda"' in toml
    for key in ("dispatch-enabled", "prefetch-enabled"):
        assert f"{key} = false" in toml
    # fusion and the plan cache are on, as in the reference
    for key in ("fusion-enabled", "plan-cache-enabled"):
        assert f"{key} = true" in toml
    from pilosa_tpu.server.config import Config as RefConfig
    from pilosa_tpu_torch.server.config import Config, tomllib

    # the same keys as the JAX package's, plus the port's device
    ref_keys = {ln.split(" = ")[0] for ln in RefConfig().to_toml().splitlines() if " = " in ln}
    keys = {ln.split(" = ")[0] for ln in toml.splitlines() if " = " in ln}
    assert keys == ref_keys | {"device"}
    assert Config.from_dict(tomllib.loads(toml)) == Config()


def test_generated_config_journal_budget_is_the_references():
    out = _run([sys.executable, "-m", "pilosa_tpu_torch", "generate-config"])
    assert out.returncode == 0, out.stderr
    from pilosa_tpu.server.config import Config as RefConfig

    ref = {ln.split(" = ")[0]: ln for ln in RefConfig().to_toml().splitlines() if " = " in ln}
    got = {ln.split(" = ")[0]: ln for ln in out.stdout.splitlines() if " = " in ln}
    for key in ("journal-max-bytes", "journal-dir", "export-path", "export-url", "device-faults", "chaos-enabled"):
        assert got[key] == ref[key], key
    assert got["journal-max-bytes"] == f"journal-max-bytes = {8 << 20}"


def test_fault_telemetry_modules_pull_in_no_jax():
    """The modules this port's fault injection, telemetry export and
    profiler live in import neither JAX nor the JAX package; chaos and
    the exporter not even torch, as the reference's."""
    probe = (
        "import sys\n"
        "import pilosa_tpu_torch.utils.chaos, pilosa_tpu_torch.utils.telemetry_export\n"
        "torchless = 'torch' not in sys.modules\n"
        "import pilosa_tpu_torch.utils.profiler, pilosa_tpu_torch.executor.hbm, pilosa_tpu_torch.server\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'pilosa_tpu' or m.startswith('pilosa_tpu.'))\n"
        "print(torchless, bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "[]"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_server_import_export_roundtrip(tmp_path):
    import signal
    import time
    import urllib.request

    port = _free_port()
    host = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "--device", "cpu",
         "-b", f"127.0.0.1:{port}", "-d", str(tmp_path / "data")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(host + "/status", timeout=2) as r:
                    assert json.loads(r.read())["device"]["type"] == "cpu"
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.monotonic() < deadline
                time.sleep(0.1)
        pairs = [(r, c) for r in range(3) for c in (r + 1, (1 << 20) + 7 * r + 2, 5 << 20)]
        csv = tmp_path / "bits.csv"
        csv.write_text("".join(f"{r},{c}\n" for r, c in pairs))
        out = _run([sys.executable, "-m", "pilosa_tpu_torch", "import", "--host", host,
                    "-i", "i", "-f", "f", "--create", str(csv)])
        assert out.returncode == 0, out.stderr
        out = _run([sys.executable, "-m", "pilosa_tpu_torch", "export", "--host", host, "-i", "i", "-f", "f"])
        assert out.returncode == 0, out.stderr
        got = sorted(tuple(map(int, ln.split(","))) for ln in out.stdout.splitlines())
        assert got == sorted(pairs)
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    assert rc == 0
