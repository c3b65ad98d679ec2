"""The port's profiler (``pilosa_tpu_torch/utils/profiler.py``).

The stack sampler and the server's stack dump keep no sampled frame
alive: a frame that a sample or a dump saw, and the tensors its locals
hold, are freed when the frame finishes, with the garbage collector off.
Then the reference's device-telemetry and ``/debug/profile`` cases
(``tests/test_profiling.py``) on the port, the telemetry's mapping of
``torch.cuda``'s allocator statistics (monkeypatched: no card here), the
governor's watermark relief, a ``torch.profiler`` capture on the CPU and
the kernel builds in the compile table."""

import gc
import threading
import weakref

import torch

from pilosa_tpu_torch.utils.profiler import StackSampler


def _sampled_while_running(sample) -> bool:
    """Run ``sample`` while another thread sits in a frame holding a
    tensor; True if the tensor outlives that frame."""
    ready, done = threading.Event(), threading.Event()
    held = {}

    def work():
        staged = torch.zeros(8)
        held["ref"] = weakref.ref(staged)
        ready.set()
        done.wait()

    t = threading.Thread(target=work)
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        t.start()
        ready.wait()
        sample()
        done.set()
        t.join()
        return held["ref"]() is not None
    finally:
        if enabled:
            gc.enable()


def test_a_sample_keeps_no_frame_alive():
    sampler = StackSampler(frame_depth=3)
    assert not _sampled_while_running(sampler.sample_once)
    assert sampler.samples == 1
    assert any("work" in row["frames"] for row in sampler.top())


def test_the_stack_dump_keeps_no_frame_alive():
    from pilosa_tpu_torch.server.http_handler import Handler

    out = {}

    def dump():
        out["body"] = Handler.get_debug_pprof(None, None).data

    assert not _sampled_while_running(dump)
    assert b"work" in out["body"]


# -- device telemetry, capture and build tracking (the reference's cases
#    of tests/test_profiling.py, then the port's own) -------------------------------

import json  # noqa: E402
import os  # noqa: E402
import types  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402

import pytest  # noqa: E402

from pilosa_tpu_torch.utils import events, metrics, profiler  # noqa: E402
from pilosa_tpu_torch.utils.profiler import DeviceTelemetry  # noqa: E402


@pytest.fixture(autouse=False)
def clean_journal():
    events.JOURNAL.clear()
    yield
    events.JOURNAL.clear()


def test_device_telemetry_cpu_backend_degrades_to_no_samples():
    tel = DeviceTelemetry()
    snap = tel.poll_once()  # no device set: nothing to poll, no error
    assert snap["devices"] == {}
    assert "stager" not in snap
    tel.device = torch.device("cpu")
    assert tel.poll_once()["devices"] == {}


def test_device_telemetry_gauges_and_watermark_event(monkeypatch, clean_journal):
    tel = DeviceTelemetry(watermark_pct=0.8)
    stats = {"bytes_in_use": 900, "bytes_limit": 1000, "peak_bytes_in_use": 950}
    monkeypatch.setattr(tel, "_device_stats", lambda: [("cuda:0", stats)])
    tel.stager_probe = lambda: (250, 1000)
    snap = tel.poll_once()
    dev = snap["devices"]["cuda:0"]
    assert dev["fraction"] == 0.9 and dev["peak_bytes"] == 950
    assert snap["stager"]["fraction"] == 0.25
    ms = metrics.snapshot()
    for name in (metrics.HBM_BYTES_IN_USE, metrics.HBM_PEAK_BYTES, metrics.HBM_BYTES_LIMIT):
        assert any(k.startswith(name) and "cuda:0" in k for k in ms)
    assert any(k.startswith(metrics.HBM_STAGER_FRACTION) for k in ms)
    # watermark is edge-triggered: above, above, below, above -> 2 events
    tel.poll_once()
    stats["bytes_in_use"] = 100
    tel.poll_once()
    stats["bytes_in_use"] = 950
    tel.poll_once()
    evs = events.snapshot(kind=events.PROFILER_HBM_WATERMARK)
    assert len(evs) == 2
    assert evs[0]["device"] == "cuda:0" and evs[0]["fraction"] == 0.9


def _fake_cuda(monkeypatch, initialized=True, raises=False):
    calls = []

    def memory_stats(index):
        calls.append(("memory_stats", index))
        if raises:
            raise RuntimeError("CUDA error: device-side assert triggered")
        return {"allocated_bytes.all.current": 7 << 30, "allocated_bytes.all.peak": 9 << 30,
                "reserved_bytes.all.current": 10 << 30, "active_bytes.all.current": 1}

    def mem_get_info(index):
        calls.append(("mem_get_info", index))
        return (60 << 30, 80 << 30)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialized)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    return calls


def test_device_stats_map_the_cuda_allocator(monkeypatch):
    """bytes_in_use / peak from the allocator's allocated bytes,
    bytes_limit the card's total memory, reserved bytes beside them; the
    label names the server's card."""
    calls = _fake_cuda(monkeypatch)
    tel = DeviceTelemetry()
    tel.device = torch.device("cuda", 1)
    assert tel._device_stats() == [(
        "cuda:1",
        {"bytes_in_use": 7 << 30, "peak_bytes_in_use": 9 << 30, "bytes_limit": 80 << 30, "bytes_reserved": 10 << 30},
    )]
    assert calls == [("memory_stats", 1), ("mem_get_info", 1)]
    tel.device = torch.device("cuda")  # no index: the current device
    assert tel._device_stats()[0][0] == "cuda:0"
    snap = tel.poll_once()["devices"]["cuda:0"]
    assert snap == {"bytes_in_use": 7 << 30, "peak_bytes": 9 << 30, "bytes_limit": 80 << 30, "fraction": 0.0875}


@pytest.mark.parametrize("initialized,raises", [(False, False), (True, True)])
def test_device_stats_empty_without_a_live_context(monkeypatch, initialized, raises):
    """A process that never initialized CUDA is not made to; a dead
    context (the call raises) polls nothing."""
    calls = _fake_cuda(monkeypatch, initialized=initialized, raises=raises)
    tel = DeviceTelemetry()
    tel.device = torch.device("cuda", 0)
    assert tel._device_stats() == []
    assert tel.poll_once()["devices"] == {}
    assert [c for c, _ in calls] == ([] if not initialized else ["memory_stats", "memory_stats"])


def test_watermark_relief_frees_the_excess_once_per_sample(monkeypatch):
    """The governor's telemetry relief: a sample above the watermark
    frees its excess through the tiers (the reserving tenant's too) at
    the next reserve, once; a new sample above it relieves again, one
    below it does not."""
    from pilosa_tpu_torch.executor.hbm import HbmGovernor

    gov = HbmGovernor()
    evicted = []
    held = {"stager": 600, "device_cache": 100}

    def evictor(name):
        def evict(need):
            freed = min(need, held[name])
            held[name] -= freed
            evicted.append((name, need, freed))
            return freed

        return evict

    gov.register("device_cache", share_bytes=1000, evict_fn=evictor("device_cache"), tier=0)
    gov.register("stager", share_bytes=1 << 40, evict_fn=evictor("stager"), tier=1)
    monkeypatch.setattr(profiler, "TELEMETRY", DeviceTelemetry())
    stats = {"bytes_in_use": 950, "bytes_limit": 1000}
    monkeypatch.setattr(profiler.TELEMETRY, "_device_stats", lambda: [("cuda:0", dict(stats))])
    before = sum(v for k, v in metrics.snapshot().items() if k.startswith(metrics.HBM_GOVERNOR_EVICTIONS))
    profiler.TELEMETRY.poll_once()
    gov.reserve("stager", 10)  # ledger far under budget: the excess still goes
    assert evicted == [("device_cache", 50, 50)]
    gov.reserve("stager", 10)  # the same sample: no second sweep
    assert len(evicted) == 1
    stats["bytes_in_use"] = 990
    profiler.TELEMETRY.poll_once()
    gov.reserve("stager", 10)
    assert evicted[1:] == [("device_cache", 90, 50), ("stager", 40, 40)]
    stats["bytes_in_use"] = 500
    profiler.TELEMETRY.poll_once()
    gov.reserve("stager", 10)
    assert len(evicted) == 3
    after = sum(v for k, v in metrics.snapshot().items() if k.startswith(metrics.HBM_GOVERNOR_EVICTIONS))
    assert after - before == 3


def _req(server, path):
    try:
        with urllib.request.urlopen(server.uri + path) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_debug_profile_endpoint(tmp_path):
    from pilosa_tpu_torch.server import Config, Server

    server = Server(Config(data_dir=str(tmp_path / "data"), bind="127.0.0.1:0", metric="expvar",
                           device="cpu", device_policy="always", device_timeout=0))
    server.open()
    try:
        st, body = _req(server, "/debug/profile")
        assert st == 200
        assert body["sampler"]["running"] is True  # always-on by default
        assert body["sampler"]["hz"] == server.config.profiler_hz
        assert "compiles" in body and "hbm" in body
        assert body["capture"]["running"] is False
        # capture control: stop with nothing running reports, never raises
        st, body = _req(server, "/debug/profile?capture=stop")
        assert st == 200 and body["capture"]["ok"] is False
        st, _ = _req(server, "/debug/profile?capture=bogus")
        assert st == 400
        st, _ = _req(server, "/debug/profile?top=bogus")
        assert st == 400
        # a capture over HTTP: start, a second start refused, stop writes the trace
        st, body = _req(server, f"/debug/profile?capture=start&dir={tmp_path / 'cap'}")
        assert st == 200 and body["capture"]["ok"] and body["capture"]["cuda"] is False
        assert _req(server, "/debug/profile")[1]["capture"] == {"running": True, "dir": str(tmp_path / "cap")}
        st, body = _req(server, f"/debug/profile?capture=start&dir={tmp_path / 'other'}")
        assert body["capture"] == {"ok": False, "error": "capture already running", "dir": str(tmp_path / "cap")}
        st, body = _req(server, "/debug/profile?capture=stop")
        assert body["capture"]["ok"] and body["capture"]["trace"].startswith(str(tmp_path / "cap"))
        # a capture left running stops when the server closes
        _req(server, f"/debug/profile?capture=start&dir={tmp_path / 'left'}")
    finally:
        server.close()
    assert profiler.capture_status() == {"running": False, "dir": None}
    assert len(list((tmp_path / "left").iterdir())) == 1


def test_capture_writes_a_trace_with_cpu_events(tmp_path):
    """A capture on the CPU: the operators run on another thread while it
    runs are in the Chrome trace it writes."""
    assert profiler.stop_capture() == {"ok": False, "error": "no capture running"}
    start = profiler.start_capture(str(tmp_path))
    assert start["ok"] and start["cuda"] is False
    t = threading.Thread(target=lambda: torch.mm(torch.ones(64, 64), torch.ones(64, 64)))
    t.start()
    t.join()
    stop = profiler.stop_capture()
    assert stop["ok"], stop
    with open(stop["trace"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"] if e.get("cat") == "cpu_op"}
    if start["all_threads"]:
        assert "aten::mm" in names
    assert profiler.capture_status() == {"running": False, "dir": None}
    assert profiler.stop_capture()["ok"] is False


@pytest.mark.parametrize(
    "kept,want",
    [
        (6, {"lost": 0, "lost_s": 0.0, "verified": True}),  # every marker kept
        (4, {"lost": 2, "lost_s": 0.2, "verified": True}),  # the settle's first two lost
        (3, {"lost": 3, "lost_s": 0.3, "verified": True}),  # the whole settle lost, none after it
        (2, {"lost": 4, "lost_s": 0.4, "verified": False}),  # one after the settle lost
        (0, {"lost": 6, "lost_s": 0.5, "verified": False}),  # none kept
    ],
)
def test_capture_loss_from_the_markers_kept(kept, want):
    """Six markers, three of them in the settle: the lost ones are the
    first, and the recording is verified while no marker after the
    settle was lost."""
    got = profiler.capture_loss([0.0, 0.1, 0.2, 0.3, 0.4, 0.5], kept, settled=3)
    assert got == {"markers": 6, "kept": kept, **{k: pytest.approx(v) for k, v in want.items()}}


def _fake_card_capture(monkeypatch, lose: int):
    """Drive the card's capture path on the CPU: the marker kernel, the
    card's sync and the trace's marker count (all markers but the first
    ``lose``) are stand-ins."""
    launched = []
    monkeypatch.setattr(profiler, "_marker", lambda device: launched.append(device))
    monkeypatch.setattr(profiler, "_device_sync", lambda device: None)
    monkeypatch.setattr(profiler, "trace_kernel_count", lambda path, needle: max(0, len(launched) - lose))
    monkeypatch.setattr(profiler.TELEMETRY, "device", torch.device("cuda", 0))
    monkeypatch.setattr(profiler, "CAPTURE_SETTLE_S", 0.05)
    monkeypatch.setattr(profiler, "_capture_lost_s", 0.0)
    return launched


def test_capture_on_the_card_settles_and_verifies_its_markers(tmp_path, monkeypatch):
    """The start returns after markers for the settle; the stop counts
    every marker kept (the settle's and the heartbeat's) and reports
    the recording verified."""
    launched = _fake_card_capture(monkeypatch, lose=0)
    start = profiler.start_capture(str(tmp_path))
    try:
        assert start["ok"] and start["cuda"] is True, start
        assert start["settle_s"] == 0.05 and start["settle_markers"] >= 2
        assert len(launched) >= start["settle_markers"]
    finally:
        stop = profiler.stop_capture()
    assert stop["ok"], stop
    m = stop["markers"]
    assert m["markers"] == len(launched) == m["kept"] and m["lost"] == 0 and m["verified"]
    assert profiler._capture_lost_s == 0.0


def test_capture_on_the_card_fails_its_stop_when_the_profiler_lost_work_after_the_start(tmp_path, monkeypatch):
    """The trace lost markers past the settle: the stop reports
    ``ok: False`` with the trace and the loss, and the next capture
    settles for twice that loss."""
    launched = _fake_card_capture(monkeypatch, lose=10_000)
    start = profiler.start_capture(str(tmp_path))
    assert start["ok"], start
    stop = profiler.stop_capture()
    assert stop["ok"] is False and "recorded the card's work only from" in stop["error"], stop
    assert stop["trace"].startswith(str(tmp_path))
    assert stop["markers"]["kept"] == 0 and stop["markers"]["lost"] == len(launched)
    assert not stop["markers"]["verified"]
    assert profiler._capture_lost_s == stop["markers"]["lost_s"] > 0
    again = profiler.start_capture(str(tmp_path))
    try:
        assert again["ok"] and again["settle_s"] == pytest.approx(max(0.05, 2 * stop["markers"]["lost_s"]))
    finally:
        profiler.stop_capture()


def test_kernel_builds_are_noted_as_compiles(tmp_path, monkeypatch):
    """``ops/_build.py`` notes each nvcc it runs in the compile table
    (kind ``nvcc``, the library's name with its source hash); a library
    already built is loaded without a note."""
    import sys

    from pilosa_tpu_torch.ops import _build

    fake_nvcc = tmp_path / "nvcc"
    fake_nvcc.write_text(
        f"#!{sys.executable}\nimport sys\nopen(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'so')\n"
    )
    fake_nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake_nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "SOURCES", ("dense_scores", "tree_count"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    loaded = []

    def fake_cdll(path):
        loaded.append(path)
        return types.SimpleNamespace(**{sym: types.SimpleNamespace() for src in _build._SIGNATURES.values()
                                        for sym, _ in src})

    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(profiler, "COMPILES", profiler.CompileTracker())
    _build.build_all()
    sigs = {row["signature"]: row for row in profiler.COMPILES.snapshot()["signatures"]}
    names = sorted(os.path.basename(_build._lib_path(n))[: -len(".so")] for n in ("dense_scores", "tree_count"))
    assert sorted(sigs) == sorted(f"nvcc:{n!r}" for n in names)
    assert all(row["kind"] == "nvcc" and row["compiles"] == 1 for row in sigs.values())
    # a second process finds the libraries built: nothing noted
    monkeypatch.setattr(_build, "_LIBS", {})
    _build.build_all()
    assert profiler.COMPILES.total_compiles == 2 and len(loaded) == 4
