"""The durable event journal in the port (``pilosa_tpu_torch/utils/events.py``
behind the port's server): every case of ``tests/test_journal.py`` runs on
``pilosa_tpu_torch``, its servers on ``device="cpu"`` — crash-consistent
framing, monotonic sequence numbers across a restart, whole-segment
retention, demotion to ring-only on an IO failure, and the
/debug/events paging that rides it. Then the two packages' segment files:
the same records give byte-identical files, and each package reads the
other's."""

import os

import pytest
from port_reference import cpu_config, exec_against_port

exec_against_port("test_journal", globals())
Config = cpu_config(Config)  # bound by the reference module

from pilosa_tpu.utils import events as ref_events  # noqa: E402


RECORDS = [
    ("gang.transition", {"frm": "A", "to": "B", "i": 0}),
    ("chaos.window", {"action": "install", "storage": "", "device": "oom_every=2"}),
    ("device.fault", {"fault": "oom"}),
    ("ingest.wave", {"i": 3, "pad": "x" * 300}),
    ("chaos.window", {"action": "clear", "storage": "", "device": ""}),
]


def _write(mod, directory, monkeypatch, max_bytes=1 << 20):
    monkeypatch.setattr(mod.time, "time", lambda: 1792321542.25)
    j = mod.EventJournal()
    j.open_backing(str(directory), max_bytes)
    for kind, fields in RECORDS:
        j.record(kind, **fields)
    j.close_backing()
    monkeypatch.undo()
    return {name: (directory / name).read_bytes() for name in sorted(os.listdir(directory))}


def test_segments_are_byte_identical_to_the_reference(tmp_path, monkeypatch):
    ref = _write(ref_events, tmp_path / "ref", monkeypatch)
    port = _write(events, tmp_path / "port", monkeypatch)
    assert ref and list(ref) == list(port)
    assert ref == port


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_reads_the_others_segments(tmp_path, monkeypatch, writer, reader):
    mods = {"ref": ref_events, "port": events}
    _write(mods[writer], tmp_path, monkeypatch, max_bytes=128 << 10)
    j = mods[reader].EventJournal()
    j.open_backing(str(tmp_path), 128 << 10)
    try:
        snap = j.snapshot()
        assert [e["seq"] for e in snap] == [1, 2, 3, 4, 5]
        assert [(e["kind"], {k: e[k] for k in f}) for e, (_, f) in zip(snap, RECORDS)] == RECORDS
        # sequence numbers continue past the other package's records
        assert j.record("device.fault", fault="stall")["seq"] == 6
        assert [e["seq"] for e in j.snapshot(kind="chaos.window")] == [2, 5]
    finally:
        j.close_backing()


def test_default_config_keeps_the_reference_journal_budget():
    from pilosa_tpu.server.config import Config as RefConfig

    assert Config().journal_max_bytes == RefConfig().journal_max_bytes == 8 << 20
    assert Config().journal_dir == RefConfig().journal_dir == ""
