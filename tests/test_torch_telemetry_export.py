"""Telemetry export in the port (``pilosa_tpu_torch/utils/telemetry_export.py``):
every case of ``tests/test_telemetry_export.py`` runs on
``pilosa_tpu_torch``, its servers on ``device="cpu"`` — the batching
exporter's never-block contract, the JSONL and OTLP/HTTP sinks, the
journal and tracer taps, and the server wiring. Then the two packages'
output for the same records: the JSONL lines and the OTLP bodies are
``==`` (the OTLP resource names each package's own service)."""

import json

import pytest
from port_reference import cpu_config, exec_against_port

exec_against_port("test_telemetry_export", globals())
Config = cpu_config(Config)  # bound by the reference module

from pilosa_tpu.utils import telemetry_export as ref_export  # noqa: E402

T0 = 1792321542.5
BATCH = [
    {"stream": "spans", "t": T0, "record": {
        "name": "query", "trace_id": "ab" * 16, "span_id": "cd" * 8, "duration_ms": 12.5,
        "meta": {"index": "i", "shards": 2, "ok": True, "ratio": 0.25},
    }},
    {"stream": "events", "t": T0, "record": {"seq": 7, "t": T0 - 1.0, "kind": "chaos.window",
                                              "action": "install", "device": "oom_every=2"}},
    {"stream": "events", "t": T0, "record": {"seq": 8, "t": T0 - 0.5, "kind": "device.fault", "fault": "oom"}},
    {"stream": "metrics", "t": T0, "record": {"uptime": 12.5, "queries": 40, "name": "not-a-number", "up": True}},
]


def _jsonl(mod, path, monkeypatch):
    monkeypatch.setattr(mod.time, "time", lambda: T0)
    ex = mod.BatchingExporter([mod.JsonlFileSink(str(path))], queue_max=16)
    for rec in BATCH:
        ex.enqueue(rec["stream"], rec["record"])
    ex.close()
    monkeypatch.undo()
    return path.read_bytes()


def test_jsonl_lines_equal_the_reference(tmp_path, monkeypatch):
    ref = _jsonl(ref_export, tmp_path / "ref.jsonl", monkeypatch)
    port = _jsonl(telemetry_export, tmp_path / "port.jsonl", monkeypatch)
    assert len(ref.splitlines()) == len(BATCH)
    assert port == ref


@pytest.mark.parametrize("streams", [("spans",), ("events",), ("metrics",), ("spans", "events", "metrics")])
def test_otlp_bodies_equal_the_reference(monkeypatch, streams):
    def posts(mod):
        got = []

        class _Resp:
            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

        def fake_urlopen(req, timeout=None):
            got.append((req.full_url, req.get_header("Content-type"), json.loads(req.data)))
            return _Resp()

        monkeypatch.setattr(mod.urllib.request, "urlopen", fake_urlopen)
        mod.OtlpHttpSink("http://collector:4318/").write_batch([r for r in BATCH if r["stream"] in streams])
        return got

    ref, port = posts(ref_export), posts(telemetry_export)
    assert [u for u, _, _ in port] == [u for u, _, _ in ref] == [
        "http://collector:4318/v1/" + p for p in ("traces", "logs", "metrics")
        if {"traces": "spans", "logs": "events", "metrics": "metrics"}[p] in streams
    ]
    for (_, rtype, rbody), (_, ptype, pbody) in zip(ref, port):
        assert ptype == rtype == "application/json"
        res_key = next(iter(rbody))
        assert rbody[res_key][0]["resource"]["attributes"][0]["value"] == {"stringValue": "pilosa_tpu"}
        assert pbody[res_key][0]["resource"]["attributes"][0]["value"] == {"stringValue": "pilosa_tpu_torch"}
        # the service name set aside, the bodies are ==
        for body in (rbody, pbody):
            body[res_key][0]["resource"]["attributes"][0]["value"] = None
        assert pbody == rbody
