#!/usr/bin/env python3
"""The cluster arm of ``chip_smoke.py`` alone, on one NVIDIA card.

Run from the root of a checkout:  python3 cluster_probe.py [--out FILE]

It builds the port's kernels while 8 worker processes write the tall
cell's 64 shards (bench_tall.py config 4, the tail cut as the smoke cuts
it), answers the tall TopN and chains on the port's CPU leg and the int
field's queries on a CPU leg of their own, then runs
``chip_smoke.run_cluster``: three port servers in this process on
``cuda``, every answer at every node against the CPU leg, the writes and
the failover. It prints the arm's result (its seconds by step among it)
as one JSON line, and writes it to FILE with ``--out``. About four
minutes; exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the arm's result (JSON) here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("cluster_probe.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import pilosa_tpu_torch
    from pilosa_tpu_torch.ops import cuda

    t0 = time.monotonic()
    box: dict = {}
    build_thread = threading.Thread(target=lambda: box.setdefault("log", cuda.build_kernels()))
    build_thread.start()
    root = tempfile.mkdtemp(prefix="cluster_probe_")
    try:
        ctx = multiprocessing.get_context("spawn")
        n = cs.TALL_SHARDS
        with ProcessPoolExecutor(max_workers=cs.BUILD_WORKERS, mp_context=ctx) as pool:
            list(pool.map(cs._write_tall_shard, [root] * n, range(n), [cs.TAIL_ROWS_PER_SHARD] * n))
        build_thread.join()
        cs.log(f"data and build {time.monotonic() - t0:.1f} s")
        card = cs.card_line()
        print(card, flush=True)
        topn, chains = cs.tall_queries()
        h = pilosa_tpu_torch.holder_from_dir(root)
        for frag in h.view("tall", "f", "standard").fragments.values():
            frag.ensure_open()
        cpu = pilosa_tpu_torch.Executor(h, device_policy="never")
        t1 = time.monotonic()
        try:
            answers = {("tall", q): cs.wire(cpu.execute("tall", q)) for q in topn + chains}
        finally:
            cpu.close()
            h.close()  # writes the rank caches the nodes link
        answers.update(cs.cluster_int_answers())
        cs.log(f"CPU legs {time.monotonic() - t1:.1f} s")
        cuda.reset_launches()
        out = cs.run_cluster(root, card, answers, topn, chains, {})
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"cluster": out}), flush=True)
    cs.log(f"arm {out['seconds']:.1f} s; total {time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
