"""The serving pipeline of the port (``server/pipeline.py`` and
``server/deadline.py``): every case of ``tests/test_pipeline.py`` runs on
``pilosa_tpu_torch``, its servers on ``device="cpu"`` — bounded
admission with 503 + Retry-After sheds, deadline propagation and
cancellation at stage boundaries, singleflight coalescing,
cross-request batching, graceful drain, and the /debug/pipeline +
metrics surface."""

import time

import pytest
from port_reference import cpu_config, exec_against_port

exec_against_port("test_pipeline", globals())
Config = cpu_config(Config)  # bound by the reference module


def test_deadline_cancels_before_per_shard_map(tmp_path):
    """The reference case with its 0.08 s / 0.04 s scaled to 0.8 / 0.4:
    on a worker loaded by other test processes the map may start later
    than 40 ms after the call, and then no shard is mapped at all."""
    s = make_server(tmp_path)
    try:
        seed(s, "exq")
        ex = s.executor

        # expired BEFORE the executor: zero call dispatch happens
        before = metrics.snapshot().get("executor.calls;call:Count", 0)
        with dl_mod.activate(Deadline.after(-1)):
            with pytest.raises(DeadlineExceeded):
                ex.execute("exq", "Count(Row(f=1))")
        assert metrics.snapshot().get("executor.calls;call:Count", 0) == before

        # expires MID-map: the second shard's work is cancelled at the
        # shard boundary instead of computed and discarded
        mapped = []
        orig = ex._bitmap_call_shard_cpu

        def slow_shard(index, c, shard):
            mapped.append(shard)
            time.sleep(0.8)
            return orig(index, c, shard)

        ex._bitmap_call_shard_cpu = slow_shard
        try:
            with dl_mod.activate(Deadline.after(0.4)):
                with pytest.raises(DeadlineExceeded):
                    ex.execute("exq", "Count(Row(f=1))")
        finally:
            ex._bitmap_call_shard_cpu = orig
        assert len(mapped) == 1, f"expected cancellation after shard 1, mapped {mapped}"
    finally:
        s.close()
