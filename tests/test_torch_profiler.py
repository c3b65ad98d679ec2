"""The port's stack sampler (``pilosa_tpu_torch/utils/profiler.py``) and
the server's stack dump keep no sampled frame alive: a frame that a
sample or a dump saw, and the tensors its locals hold, are freed when
the frame finishes, with the garbage collector off."""

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
