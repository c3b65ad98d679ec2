#!/usr/bin/env python3
"""Per-query against coalesced Count(chain) launches, on one NVIDIA card.

Run from the root of a checkout:  python3 chain_batch_probe.py

The port's executor launches the fused tree count (kernel tree_count)
once per Count(chain) query. The other form coalesces concurrent chains
of the same tree shape through a BatchedScorer into one launch over
Q queries' leaves (the kernel's batch form). This script drives both
forms through ``Executor.execute`` on bench_tall.py's config 4 data
(chip_smoke.py's generator: 64 shards, 32 hot rows x 50,000 bits) and
its 24 chains, sequentially and from 8 closed-loop client threads, in
the order per-query, coalesced, coalesced, per-query. Every answer must
equal the CPU roaring leg.

The chains read only the hot rows, so the singleton tail is written at
1,000 rows per shard (printed as ``reduced``); the leaves the kernel
reads are the same as at full size.

Output: progress on stderr; on stdout the card's name and power limit
(nvidia-smi) and one JSON line with qps, p50 and p99 per form and run.
Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CLIENTS = 8
PASSES = 4
TAIL_ROWS_PER_SHARD = 1_000


def _forms():
    """(per-query Executor, coalescing Executor) classes; both launch the
    same kernel through ops.tree_count and differ only in coalescing."""
    from pilosa_tpu_torch import Executor, ops
    from pilosa_tpu_torch.executor.batcher import BatchedScorer

    programs: dict = {}

    def program(tree):
        key = repr(tree)
        prog = programs.get(key)
        if prog is None:
            prog = programs[key] = ops.TreeProgram(tree)
        return prog

    class PerQuery(Executor):
        def _count_device_batched(self, index, child, shards) -> int:
            leaves, tree = self._tree_leaves(index, child, shards)
            return int(ops.tree_count([leaves], program(tree)).cpu()[0])

    class Coalesced(Executor):
        def __init__(self, *a, **kw) -> None:
            super().__init__(*a, **kw)
            self.chains = BatchedScorer(
                max_batch=32,
                single_fn=lambda leaves, prog: ops.tree_count([list(leaves)], prog),
                batch_fn=lambda srcs, prog: ops.tree_count([list(lv) for lv in srcs], prog),
                # pad lanes repeat a real query; their counts are never read
                pad_fn=lambda proto: proto,
            )

        def _count_device_batched(self, index, child, shards) -> int:
            leaves, tree = self._tree_leaves(index, child, shards)
            key = (repr(tree), tuple(tuple(t.shape) for t in leaves))
            return int(self.chains.score(key, program(tree), tuple(leaves)).reshape(-1)[0])

    return PerQuery, Coalesced


def _rate(lat: list[float], wall: float) -> dict:
    lat = sorted(lat)
    return {
        "queries": len(lat),
        "qps": len(lat) / wall,
        "p50_ms": statistics.median(lat) * 1e3,
        "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3,
    }


def measure(ex, chains: list[str], oracle: dict) -> dict:
    import chip_smoke
    from pilosa_tpu_torch.ops import cuda

    seq, _ = chip_smoke.run_sequential(ex, "tall", chains + chains, oracle)
    cuda.reset_launches()
    lat, _, wall = chip_smoke.run_concurrent(ex, "tall", chains, oracle, CLIENTS, PASSES)
    return {
        "sequential": _rate(seq, sum(seq)),
        f"concurrent_c{CLIENTS}": _rate(lat, wall),
        "launches": cuda.TREE_COUNT.launches,
        "launches_q_gt_1": cuda.TREE_COUNT.batched_launches,
    }


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "pilosa_tpu_torch")):
        print("chain_batch_probe.py: run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chain_batch_probe.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    import pilosa_tpu_torch
    from pilosa_tpu_torch.ops import cuda

    cuda.build_kernels()
    card = chip_smoke.card_line()
    print(card, flush=True)
    root = tempfile.mkdtemp(prefix="pilosa_tpu_torch_chains_")
    holder = None
    try:
        tdir = chip_smoke._fragment_dir(root, "tall")
        from pilosa_tpu_torch.roaring.writer import build_fragment_file

        for s in range(chip_smoke.TALL_SHARDS):
            build_fragment_file(
                os.path.join(tdir, str(s)), chip_smoke._tall_chunks(s, TAIL_ROWS_PER_SHARD)
            )
        holder = pilosa_tpu_torch.holder_from_dir(root)
        _, chains = chip_smoke.tall_queries()
        cpu = pilosa_tpu_torch.Executor(holder, device_policy="never")
        oracle = chip_smoke.oracle_answers(cpu, "tall", chains)
        cpu.close()
        per_query, coalesced = _forms()
        runs = []
        for name, cls in (
            ("per_query", per_query),
            ("coalesced", coalesced),
            ("coalesced", coalesced),
            ("per_query", per_query),
        ):
            ex = cls(holder, device_policy="always")
            try:
                chip_smoke.run_sequential(ex, "tall", chains, oracle)  # stage the leaves
                t0 = time.monotonic()
                runs.append({"form": name, **measure(ex, chains, oracle)})
                chip_smoke.log(f"{name}: {runs[-1]} in {time.monotonic() - t0:.1f} s")
            finally:
                ex.close()
        print(
            json.dumps(
                {
                    "chain_batch_probe": runs,
                    "card": card,
                    "clients": CLIENTS,
                    "passes": PASSES,
                    "reduced": {"tall.rows_per_shard": {"from": 15_625_000, "to": TAIL_ROWS_PER_SHARD}},
                }
            ),
            flush=True,
        )
    finally:
        if holder is not None:
            holder.close()
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
