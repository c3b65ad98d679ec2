#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pilosa_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the port's hand-written kernels from the sources in the
checkout, writes two seeded data directories with the port's own roaring
writer, and drives the port's executor through ``Executor.execute(index,
pql)``, the entry point the benchmarks and the HTTP API call:

  dense  bench.py's kernel workload: 1 shard, 4096 rows x 2^20 columns
         at ~1.6 % density. Every container is occupied, so TopN scores
         dense chunks (kernel dense_scores). 16 sources run one after
         another, then from 8 concurrent clients, whose TopN scoring the
         batcher coalesces into launches with Q > 1.
  tall   bench_tall.py's config 4: 64 shards, 32 hot rows x 50,000 bits
         per shard and a singleton tail. Its 16 TopN queries score the
         stacked block-sparse chunk (sparse_stacked_scores) and its 24
         Count(chain) queries run the fused tree count (tree_count), one
         after another and then from 8 concurrent clients. The one cut is
         the tail's rows per shard, printed as ``reduced``.

Every answer must equal the port's CPU roaring leg (device_policy=
"never"). The kernels' launch counts are set to 0 just before the main
path and read just after it; each kernel must have launched there. Then
each kernel runs again at the arguments of its largest main-path launch
and must equal its plain PyTorch version run on the card on the same
inputs (integers: the bar is ==). Both are timed with CUDA events, the
L2 cache flushed before every launch.

Output: progress on stderr; on stdout the card's name and power limit
(nvidia-smi), a ``phases`` line (qps and p50 on the card), a
``kernels`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits nonzero
before the last line. Without CUDA, or outside a checkout, it exits 2
and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SW = 1 << 20

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s (at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12

# bench.py's kernel workload (bench.py:2334-2345): 4096 rows at ~2^-6
# density. 16,512 random draws per row leave ~16,380 distinct columns.
DENSE_ROWS = 4096
DENSE_DRAWS = 16_512
DENSE_SOURCES = 16
CLIENTS = 8
CONCURRENT_PASSES = 2

# bench_tall.py config 4 (bench_tall.py:46-73)
TALL_SHARDS = 64
HOT_ROWS = 32
HOT_BITS = 50_000
SINGLES_BASE = 64
FULL_ROWS_PER_SHARD = 15_625_000
# The one cut: the singleton tail's rows per shard, the largest that
# builds the 64 shards in about 60 s on the card's host.
TAIL_ROWS_PER_SHARD = 4_000_000


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


# -- data ------------------------------------------------------------------------


def _fragment_dir(root: str, index: str) -> str:
    d = os.path.join(root, index, "f", "views", "standard", "fragments")
    os.makedirs(d, exist_ok=True)
    return d


def _dense_chunks(rows: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    for r0 in range(0, rows, 256):
        yield np.concatenate(
            [
                np.uint64(r * SW)
                + np.unique(rng.integers(0, SW, size=DENSE_DRAWS, dtype=np.uint64))
                for r in range(r0, min(rows, r0 + 256))
            ]
        )


def _tall_chunks(shard: int, rows_per_shard: int):
    """bench_tall._fragment_chunks: hot rows first, then the singleton
    tail (one bit per row, column = row hash)."""
    for h in range(HOT_ROWS):
        rng = np.random.default_rng(h * 100003 + shard)
        cols = np.unique(rng.integers(0, SW, size=HOT_BITS, dtype=np.uint64))
        yield np.uint64(h * SW) + cols
    base = SINGLES_BASE + shard * rows_per_shard
    step = 4_000_000
    for i in range(0, rows_per_shard, step):
        rows = np.arange(i, min(i + step, rows_per_shard), dtype=np.uint64) + np.uint64(base)
        cols = (rows * np.uint64(2654435761)) % np.uint64(SW)
        yield rows * np.uint64(SW) + cols


def build_data(root: str, dense_rows: int, shards: int, rows_per_shard: int) -> dict:
    from pilosa_tpu_torch.roaring.writer import build_fragment_file

    t0 = time.monotonic()
    build_fragment_file(os.path.join(_fragment_dir(root, "dense"), "0"), _dense_chunks(dense_rows))
    t1 = time.monotonic()
    tdir = _fragment_dir(root, "tall")
    for s in range(shards):
        build_fragment_file(os.path.join(tdir, str(s)), _tall_chunks(s, rows_per_shard))
    t2 = time.monotonic()
    return {"dense_build_s": t1 - t0, "tall_build_s": t2 - t1}


def dense_queries(rows: int) -> list[str]:
    rng = np.random.default_rng(5)
    srcs = rng.choice(rows, size=min(DENSE_SOURCES, rows), replace=False)
    return [f"TopN(f, Row(f={int(r)}), n=10)" for r in srcs]


def tall_queries() -> tuple[list[str], list[str]]:
    """bench_tall._queries(): 16 TopN and 24 Count(chain)."""
    topn = [f"TopN(f, Row(f={h}), n=10)" for h in range(0, HOT_ROWS, 2)]
    chains = []
    for r in range(8):
        a, b, c, d = r, (r + 5) % HOT_ROWS, (r + 11) % HOT_ROWS, (r + 17) % HOT_ROWS
        chains += [
            f"Count(Intersect(Union(Row(f={a}), Row(f={b})), Union(Row(f={c}), Row(f={d}))))",
            f"Count(Union(Intersect(Row(f={a}), Row(f={b})), Intersect(Row(f={c}), Row(f={d})), Row(f={a})))",
            f"Count(Difference(Union(Row(f={a}), Row(f={b}), Row(f={c})), Row(f={d})))",
        ]
    return topn, chains


# -- driving the executor -----------------------------------------------------------


def _execute(ex, index: str, q: str, oracle: dict, legs: dict) -> float:
    """One query under the executor's latency attribution; adds its
    seconds per waterfall leg to ``legs`` and returns its latency (s).
    Raises on a wrong answer."""
    from pilosa_tpu_torch.utils import trace

    d: dict = {}
    t0 = time.perf_counter()
    with trace.attrib_activate(d):
        ans = ex.execute(index, q)
    dt = time.perf_counter() - t0
    if ans != oracle[q]:
        raise AssertionError(f"{index}: {q} answered {ans}, CPU leg {oracle[q]}")
    # what no leg claimed: parsing, routing, the ranked walk on the host
    d["host.other"] = dt - sum(d.values())
    for k, v in d.items():
        legs[k] = legs.get(k, 0.0) + v
    return dt


def run_sequential(ex, index: str, queries: list[str], oracle: dict):
    """Each query once, in order. Returns (latencies, seconds per leg)."""
    legs: dict = {}
    return [_execute(ex, index, q, oracle, legs) for q in queries], legs


def run_concurrent(ex, index: str, queries: list[str], oracle: dict, clients: int, passes: int):
    """``clients`` closed-loop threads, each sending every query ``passes``
    times from its own offset. Returns (latencies, seconds per leg, wall
    seconds)."""
    lat: list[list[float]] = [[] for _ in range(clients)]
    legs: list[dict] = [{} for _ in range(clients)]
    errors: list[BaseException] = []
    start = threading.Barrier(clients)

    def client(ci: int) -> None:
        try:
            start.wait()
            for i in range(ci, ci + passes * len(queries)):
                q = queries[i % len(queries)]
                lat[ci].append(_execute(ex, index, q, oracle, legs[ci]))
        except BaseException as e:  # re-raised below, after every thread joined
            errors.append(e)
            start.abort()

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    merged: dict = {}
    for per in legs:
        for k, v in per.items():
            merged[k] = merged.get(k, 0.0) + v
    return [x for per in lat for x in per], merged, wall


def _rate(lat: list[float], legs: dict, wall: float | None = None) -> dict:
    wall = sum(lat) if wall is None else wall
    return {
        "queries": len(lat),
        "qps": len(lat) / wall,
        "p50_ms": statistics.median(lat) * 1e3,
        # mean latency per query split by waterfall leg (the executor's
        # own attribution: stager, device.compute = launch to fetched
        # result, transfer.decode, reduce; host.other = the rest)
        "legs_ms": {k: v / len(lat) * 1e3 for k, v in sorted(legs.items())},
    }


def oracle_answers(cpu, index: str, queries: list[str]) -> dict:
    return {q: cpu.execute(index, q) for q in queries}


def _rescues(metrics) -> float:
    return metrics.snapshot().get(metrics.BATCHER_RESCUES, 0)


def main_path(dev, dense_qs, tall_topn, tall_chains, oracle) -> dict:
    """Dense TopN (sequential, then concurrent) and tall TopN + Count(chain),
    every answer held against the CPU leg. Returns the card's rates."""
    out = {}
    cold, _ = run_sequential(dev, "dense", dense_qs, oracle)
    out["dense_first_pass_s"] = sum(cold)
    out["dense_sequential"] = _rate(*run_sequential(dev, "dense", dense_qs, oracle))
    from pilosa_tpu_torch.utils import metrics

    before = (dev.scorer.dispatches, dev.scorer.batched_queries, _rescues(metrics))
    lat, legs, wall = run_concurrent(dev, "dense", dense_qs, oracle, CLIENTS, CONCURRENT_PASSES)
    out[f"dense_concurrent_c{CLIENTS}"] = _rate(lat, legs, wall)
    # how the batcher served the concurrent clients: launches, queries
    # that rode in a launch with Q > 1, orphaned queues a waiter adopted
    out[f"dense_concurrent_c{CLIENTS}"]["batcher"] = {
        "dispatches": dev.scorer.dispatches - before[0],
        "batched_queries": dev.scorer.batched_queries - before[1],
        "rescues": _rescues(metrics) - before[2],
    }
    cold, _ = run_sequential(dev, "tall", tall_topn + tall_chains, oracle)
    out["tall_first_pass_s"] = sum(cold)
    out["tall_topn"] = _rate(*run_sequential(dev, "tall", tall_topn, oracle))
    out["tall_chain"] = _rate(*run_sequential(dev, "tall", tall_chains, oracle))
    lat, legs, wall = run_concurrent(dev, "tall", tall_chains, oracle, CLIENTS, 1)
    out[f"tall_chain_concurrent_c{CLIENTS}"] = _rate(lat, legs, wall)
    return out


# -- kernels against their plain versions ----------------------------------------------


class Recorder:
    """Wraps the kernel wrappers of ``ops.cuda`` to keep, per kernel, the
    arguments of its largest launch (by input bytes). The wrappers' own
    launch counts are untouched."""

    def __init__(self, cuda_mod) -> None:
        self.args: dict[str, tuple] = {}
        self.kernel_fn: dict = {}
        self._size: dict[str, int] = {}
        self._mu = threading.Lock()
        for name, size in (
            ("dense_scores", self._dense_bytes),
            ("sparse_stacked_scores", self._sparse_bytes),
            ("tree_count", self._tree_bytes),
        ):
            self.kernel_fn[name] = getattr(cuda_mod, name)
            setattr(cuda_mod, name, self._wrap(name, self.kernel_fn[name], size))

    def _wrap(self, name, fn, size):
        def wrapped(*args):
            n = size(*args)
            with self._mu:
                if n > self._size.get(name, -1):
                    self._size[name] = n
                    self.args[name] = args
            return fn(*args)

        return wrapped

    @staticmethod
    def _dense_bytes(srcs, mat):
        return (srcs.numel() + mat.numel()) * 4

    @staticmethod
    def _sparse_bytes(srcs, blocks, *rest):
        return blocks.numel() * 4 * srcs.shape[0]

    @staticmethod
    def _tree_bytes(leaves_by_query, program):
        return sum(t.numel() * 4 for leaves in leaves_by_query for t in leaves)


def bound_bytes(name: str, args) -> int:
    """Bytes the function must move on these inputs: each input read once,
    each output written once. For the sparse scorer, the blocks in range
    and the source containers they name (not all of srcs); for the tree
    count, each distinct leaf."""
    import torch

    if name == "dense_scores":
        srcs, mat = args
        q, w = srcs.shape
        return (mat.numel() + q * w + q * mat.shape[0]) * 4
    if name == "sparse_stacked_scores":
        srcs, blocks, brow, bslot, bshard, num_rows = args
        q, s, w = srcs.shape
        valid = (brow >= 0) & (brow < num_rows) & (bslot >= 0) & (bslot < w // 2048)
        shard = bshard if bshard is not None else torch.zeros_like(brow)
        valid &= (shard >= 0) & (shard < s)
        used = torch.unique(shard[valid].long() * (w // 2048) + bslot[valid].long()).numel()
        nb = int(valid.sum())  # a block out of range is never read
        idx = 3 if bshard is not None else 2
        return nb * 2048 * 4 + nb * idx * 4 + q * used * 2048 * 4 + q * num_rows * 4
    if name == "tree_count":
        leaves_by_query, program = args
        # coalesced chains often share a leaf (the same staged row):
        # the function needs each distinct leaf once
        leaf_bytes = sum(
            {t.data_ptr(): t.numel() * 4 for leaves in leaves_by_query for t in leaves}.values()
        )
        return leaf_bytes + len(program.code) * 4 + len(leaves_by_query) * 4
    raise KeyError(name)


def time_ms(fn, iters: int, flush) -> float:
    """Median device time of ``fn`` over ``iters`` launches (CUDA events),
    with the L2 cache flushed before each."""
    import torch

    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_kernels(rec: Recorder, launches: dict, batched: dict, device) -> list[dict]:
    import torch

    from pilosa_tpu_torch.ops import cuda, packed

    kernels = {k.name: k for k in cuda.KERNELS}
    plain = {
        "dense_scores": packed.intersection_counts_matrix_plain,
        "sparse_stacked_scores": packed.sparse_stacked_scores_plain,
        "tree_count": packed.tree_count_plain,
    }
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)  # 256 MiB > L2
    rows = []
    for name, plain_fn in plain.items():
        kernel_fn = rec.kernel_fn[name]
        args = rec.args[name]
        got = kernel_fn(*args)
        want = plain_fn(*args)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs plain {want.shape}/{want.dtype}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version by {err}")
        ms = time_ms(lambda: kernel_fn(*args), 20, flush)
        plain_ms = time_ms(lambda: plain_fn(*args), 3, flush)
        nbytes = bound_bytes(name, args)
        k = kernels[name]
        rows.append(
            {
                "name": name,
                "route": "cuda",
                "source": k.source,
                "replaces": k.replaces,
                "launches": launches[name],
                "batched_launches": batched[name],
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": None,
                "bytes": nbytes,
                "shape": _shape(name, args),
            }
        )
        log(f"{name}: == plain; {ms:.3f} ms (bound {rows[-1]['bound_ms']:.3f}, plain {plain_ms:.3f})")
    return rows


def _shape(name: str, args) -> dict:
    if name == "dense_scores":
        return {"Q": args[0].shape[0], "R": args[1].shape[0], "W": args[1].shape[1]}
    if name == "sparse_stacked_scores":
        q, s, w = args[0].shape
        return {"Q": q, "S": s, "W": w, "B": args[1].shape[0], "num_rows": args[5]}
    leaves_by_query, program = args
    return {
        "Q": len(leaves_by_query),
        "nleaves": program.nleaves,
        "leaf": list(leaves_by_query[0][0].shape),
    }


# -- the run ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "pilosa_tpu_torch")):
        print("chip_smoke.py: pilosa_tpu_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import pilosa_tpu_torch
    from pilosa_tpu_torch.ops import cuda

    t_start = time.monotonic()
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. build
    t0 = time.monotonic()
    build = cuda.build_kernels()
    build_s = time.monotonic() - t0
    for name, ent in build.items():
        report = [ln for ln in ent["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"built {name} in {ent['seconds']:.1f} s: " + " | ".join(report))
    card = card_line()
    print(card, flush=True)
    log(f"kernels built in {build_s:.1f} s on {kind}")

    root = tempfile.mkdtemp(prefix="pilosa_tpu_torch_smoke_")
    holder = dev = cpu = None
    try:
        # 2. data
        t0 = time.monotonic()
        built = build_data(root, DENSE_ROWS, TALL_SHARDS, TAIL_ROWS_PER_SHARD)
        log(f"data written: {built}")
        holder = pilosa_tpu_torch.holder_from_dir(root)
        for index in ("dense", "tall"):
            for frag in holder.view(index, "f", "standard").fragments.values():
                frag.ensure_open()
        data_s = time.monotonic() - t0

        dense_qs = dense_queries(DENSE_ROWS)
        tall_topn, tall_chains = tall_queries()
        dev = pilosa_tpu_torch.Executor(holder, device_policy="always")
        cpu = pilosa_tpu_torch.Executor(holder, device_policy="never")

        # 3. the CPU leg's answers
        t0 = time.monotonic()
        oracle = oracle_answers(cpu, "dense", dense_qs)
        oracle.update(oracle_answers(cpu, "tall", tall_topn + tall_chains))
        oracle_s = time.monotonic() - t0
        for q in dense_qs + tall_topn:
            if len(oracle[q][0]) != 10:
                raise AssertionError(f"{q}: expected 10 pairs, CPU leg gave {oracle[q]}")
        if not all(oracle[q][0] > 0 for q in tall_chains):
            raise AssertionError("a chain counted 0 bits: the data is not config 4's")
        log(f"CPU leg answered {len(oracle)} queries in {oracle_s:.1f} s")

        # 4. the main path, counts set to 0 just before and read just after
        rec = Recorder(cuda)
        cuda.reset_launches()
        t0 = time.monotonic()
        phases = main_path(dev, dense_qs, tall_topn, tall_chains, oracle)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in cuda.KERNELS}
        batched = {k.name: k.batched_launches for k in cuda.KERNELS}
        main_s = time.monotonic() - t0
        log(f"main path in {main_s:.1f} s; launches {launches}, with Q > 1 {batched}")
        for k in cuda.KERNELS:
            if launches[k.name] <= 0:
                raise AssertionError(f"kernel {k.name} never launched on the main path")
        if batched["dense_scores"] <= 0:
            raise AssertionError("dense_scores never launched with Q > 1 under concurrency")

        # 5. each kernel against its plain version, at its main-path arguments
        kernels = check_kernels(rec, launches, batched, device)

        n_dense = len(dense_qs) * (2 + CLIENTS * CONCURRENT_PASSES)
        n_tall = 2 * len(tall_topn) + (2 + CLIENTS) * len(tall_chains)
        phases.update(
            {
                "card": card,
                "kind": kind,
                "reduced": {
                    "tall.rows_per_shard": {
                        "from": FULL_ROWS_PER_SHARD,
                        "to": TAIL_ROWS_PER_SHARD,
                    }
                },
                "launches_per_query": {
                    "dense_scores": launches["dense_scores"] / n_dense,
                    "sparse_stacked_scores": launches["sparse_stacked_scores"]
                    / (2 * len(tall_topn)),
                    "tree_count": launches["tree_count"] / ((2 + CLIENTS) * len(tall_chains)),
                },
                "dense_queries_run": n_dense,
                "tall_queries_run": n_tall,
                "seconds": {
                    "build": build_s,
                    "data": data_s,
                    "cpu_leg": oracle_s,
                    "main_path": main_s,
                    **built,
                },
            }
        )
        print(json.dumps({"phases": phases}), flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
    finally:
        for ex in (dev, cpu):
            if ex is not None:
                ex.close()
        if holder is not None:
            holder.close()
        shutil.rmtree(root, ignore_errors=True)

    log(f"done in {time.monotonic() - t_start:.1f} s")
    print(
        json.dumps(
            {
                "ok": True,
                "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
