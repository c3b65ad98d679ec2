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
  ssb    the Star Schema Benchmark (O'Neil et al., rev. 3) at SF = 10 as
         Pilosa fields: 60,000,000 lineorder rows as columns (58 shards),
         nine set fields with SSB's cardinalities and hierarchy, and the
         int fields lo_revenue, lo_quantity and lo_discount. Q1.1/Q1.2 as
         filtered Sums, Q2.1-Q3.2 as GroupBy panels with a Sum aggregate
         (K = 280, 56, 150, 600 groups: the GroupBy kernel
         groupby_reduce), a count-only GroupBy, Min/Max (every shard's
         recurrence in one launch of bsi_minmax), Percentile (the whole
         bit-sliced search in one cooperative launch of bsi_percentile;
         one launch and no tree count a query, asserted), Distinct (the presence map
         distinct_presence), and Count(Range) of every operator alone and
         inside chains (the range kernel bsi_range), a cold pass then a
         warm pass. dbgen is not in the repository: the columns are drawn
         uniformly with numpy from a seed.
  fusion multi-call requests over the staged tall and ssb data:
         bench_tall.py's three-chain request, three chains and a TopN,
         each ssb family as one request and all 31 ssb queries as one,
         each run warm with the executor's fuser set aside, then with
         it, every answer against its oracle. Per request: p50, fused
         launches, kernel launches, device-to-host copies (a
         torch.profiler trace) and bypasses. Every fused enqueue runs
         under torch.cuda.set_sync_debug_mode("error"), so a host wait
         inside it fails the run, and each fused launch must make
         exactly one fetch.
  writes the shape of bench.py's ingest probe (_ingest_sustained_probe)
         over dense and tall: 10 % of operations are one PQL request of
         16 Set/Clear calls (80 % sets), the rest reads (the probe's four
         query shapes over dense, the dense TopN sources, the tall
         Count(chain) queries). A write bumps its fragment's generation;
         the next read refreshes each staged entry with one word-delta
         scatter (kernel word_delta) instead of restaging it: in place
         when no reader holds the entry, into a copy when one does (the
         refreshes are counted by route). First a seeded sequence, every
         read held against the CPU leg right after it; then 8 concurrent
         clients x 50 operations (bench.py's are x 200: cut for the run's
         time limit, printed as ``reduced``), every read checked again
         once they are done.
  tiered the shape of bench.py's tiering probe (_tiering_oversub_probe)
         at 4,096 rows of one shard, the working set 512 MiB: rows of
         array, run and bitmap containers. Zipf(1.3) Count(Row) traffic
         from 4 clients with think time, 16 filtered TopN and 16 TopN
         over the ids of the first 128 rows per arm, first with the
         stager budget holding the whole working set, then with a third
         of it, where rows leave the card and re-enter from the host's
         container tier (tier 1). Cold rows cross to the card as
         container payloads, expanded there (kernel expand_blocks); the
         128-row TopN chunk is its full-width launch. One 16-mutation
         write lands in the middle of the 3x arm.

  server the port's server (``pilosa_tpu_torch.server.Server``, the
         default Config on ``cuda``) over the same directory, run after
         ssb and before writes (the in-process holder closes first and
         reopens after): every dense, tall and ssb query over HTTP, a
         cold pass, then each family sequentially and from 8 clients
         (HTTP p50 and qps beside the in-process p50 of this run);
         Set/Clear PQL and one protobuf import, each read back, then
         cleared again; an allocation failure on the card under the
         executor's OomRecovery (relief, one retry, the CPU cooldown,
         then the device path again) and a relief-plus-retry that
         succeeds; a restart with the fault injector open
         (``chaos_enabled``) and telemetry exported to a JSONL file and
         an OTLP listener thread on 127.0.0.1, ending in the faults arm:
         fault windows through POST /debug/chaos (a poisoned fused
         lowering, an allocation failure on every second and on every
         launch, stalls) over the OOM check's reads and the stats family
         as one request, a torch.profiler capture whose trace must
         hold each port kernel as often as its wrapper launched it, a
         ballast past 0.9 of the card's memory that
         the governor's watermark relief answers, the durable journal
         and both exports, and ``chip_smoke.py --sticky-child`` (a
         process that loses its CUDA context to a device-side assert,
         trips its gate and serves every later read on the CPU leg,
         counted); and ``python -m pilosa_tpu_torch server`` as a
         subprocess, /status, one TopN, the restart's journal records,
         SIGINT. The server runs
         the reference's defaults (fusion and the plan cache on); every
         timed row sends ``cache=false`` except a row per family that
         times plan-cache hits, and bench.py's plan-cache probe runs over
         HTTP on dense (Zipf 1.3 over 48 TopN/Intersect/Union queries,
         uncached, cached, then cached with 1 % writes that must
         invalidate; every read against the CPU leg). It must launch K1,
         K2, K3, K4, K5, K7, K8, K9 and K10 and show no degrade, device-down
         fallback or gate trip outside the allocation failure.
  keys   Pilosa's keyed indexes with attributes, on a server of its own
         (the default Config on ``cuda``) over a fresh directory under the
         run's root: index ``users`` and field ``likes`` with ``keys``,
         one shard of column keys ``u%07d`` (the longest prefix whose ids
         fit one shard: 16 partitions mint past 2^20, printed as
         ``reduced``), 1024 row keys ``item-%04d`` at the dense cell's
         density (K1's matrix 1024 x 32768 words). Every column key is
         minted through the keyed import route (one bit a key, the row
         keys cycling, 65,536 a request), the rest of the bits imported
         by id through the plain import (the server's ``API.import_bits``
         in process) with the ids the server's own translator gives; SetRowAttrs gives every row a category (one of
         16) and a rank, SetColumnAttrs the first 65,536 columns a
         segment. Then, over HTTP, each answer against the CPU leg on the
         same holder and translator: keyed TopN, TopN with attrName /
         attrValues (128 candidate rows), keyed Count chains, Row with
         columnAttrs, one keyed multi-call request through the fuser; last
         a keyed Set of a new column key, read back. It must launch K1 and
         K3; mint and import seconds and the family p50s print on a
         ``phases.keys`` line.

The device executors stage with the port's defaults, which are the
server's: 8 GiB budget, delta refresh on at a 0.25 ratio, a 256 MiB
tier 1 and compressed uploads at a dense/payload ratio of 4.0 (the
tiered arms change only the budget).

Every dense, tall, writes, tiered, server and keys answer must equal the
port's CPU roaring leg (device_policy="never"); every ssb answer (in
process and over HTTP) must equal a plain numpy computation over the
generated columns (int64, exact). Each path (dense and tall; ssb;
fusion; server; keys; writes; tiered) runs with the kernels' launch
counts set to 0 just before it and read just after; each kernel must
have launched on its path (the server's kernels on the server path, K1
and K3 on the keys path). Then each kernel runs again at the arguments
of its largest main-path launch and must equal its plain PyTorch version
run on the card on the same inputs (integers: the bar is ==). Both are
timed with CUDA events, the L2 cache flushed (by a read, leaving clean
lines) before every launch and the host's enqueue kept out of the
window. The word-delta kernel is checked and timed on both routes, at
the largest in-place patch and at the largest copy; the expansion kernel
against the unbinned function, at the largest tiered launch with each
input kind, and once more on the widest launch's payloads shuffled,
binned on the card. The percentile search is also checked and timed
on its global route, on a seeded stack just past what its on-chip route
holds. The tree count is also checked and timed at
its most launched shape, a one-leaf count of one shard row; the dense
scorer at the widest batch (Q) of the dense phases; the block-sparse
scorer at its largest launch at every batch width Q it launched with on
any path (each with its launches at that Q), and once at Q = 32 (the
batcher's widest batch) on the server's largest staged bundle; the GroupBy kernel
at the count-only ssb panel and at a dense, non-exclusive shape (no
filter, two 8-row set fields whose columns sit in several rows each,
drawn from a seed), the worst case of a kernel that visits only the
group words that are set; and every kernel that launches on the fusion
path also at each shape it launched with there (the first launch of
each, == plain and timed, with its launches there), which gives its
launch-weighted gap to the bound. Bounds count what the inputs need: for
the GroupBy kernel, the set group words and the sectors where the filter
is set; for the dense scorer, the non-zero source words; for Min/Max and
the percentile search, each step's plane only in the sectors where that
step's candidates lie (per shard for Min/Max); for Distinct, the planes
at the considered words and its minterm split's operations.

The fragments are written by a pool of worker processes, stopped before
the card is used.

Output: progress on stderr; on stdout the card's name and power limit
(nvidia-smi), a ``phases.server`` line (its ``faults`` arm among it), a
``phases.keys`` line, a ``phases.fusion`` line (its
table, the plan-cache probe and the fused TopN head,
``sparse_intersection_counts_stacked_mat``, == plain and timed), a
``phases`` line (qps and p50 on the card), a ``kernels`` line, and as
the last line
``{"ok": true, "device": {...}}``. Any failed check exits nonzero
before the last line. Without CUDA, or outside a checkout, it exits 2
and prints no result.
"""

from __future__ import annotations

import itertools
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SW = 1 << 20

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s (at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
# CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0: results per clock per SM
POPC_PER_CLOCK_PER_SM = 16
INT32_PER_CLOCK_PER_SM = 64

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
# worker processes writing fragment files
BUILD_WORKERS = 8

# SSB at SF = 10 (O'Neil et al., Star Schema Benchmark rev. 3): lineorder
# has 6,000,000 x SF rows; each is a column.
SSB_ROWS = 60_000_000  # 58 shards
SSB_SEED = 1993
SSB_YEARS = tuple(range(1992, 1999))
# set fields and their row ids: 5 regions, 25 nations (5 per region), 250
# cities (10 per nation), 25 categories, 1000 brands (40 per category)
SSB_SET_FIELDS = (
    "d_year", "c_region", "c_nation", "c_city", "s_region", "s_nation", "s_city",
    "p_category", "p_brand1",
)
SSB_INT_FIELDS = {"lo_revenue": (0, 10_500_000), "lo_quantity": (1, 50), "lo_discount": (0, 10)}
# query families of the ssb phase, timed apart
STATS = "minmax_percentile_distinct"
# the Count(Range) queries: the tree count's launches on the ssb path
# (Min/Max run on bsi_minmax, Percentile on bsi_percentile)
SSB_TREE_COUNT_MAX = 40
RANGE = "range_count"
SSB_FAMILIES = ("sum", "groupby", RANGE, STATS)
AMERICA, ASIA = 1, 2  # SSB region order: AFRICA, AMERICA, ASIA, EUROPE, MIDDLE EAST
UNITED_STATES = 9  # the fifth nation of AMERICA

# The stager's default budget, the server's (pilosa_tpu/server/config.py:61)
STAGER_BUDGET = 8 << 30

# writes: bench.py's ingest probe (bench.py:683-739)
WRITE_FRAC = 0.10
WRITE_BATCH = 16
SET_FRAC = 0.8
# read shares: the probe's four shapes, the dense TopN sources, the tall
# chains. A filtered dense TopN costs the CPU leg seconds, so its share
# bounds how many reads the run can check.
READ_SHARES = (0.4, 0.1, 0.5)
# the sequence checked read by read stays short (a filtered dense TopN
# costs the CPU leg seconds); the concurrent clients serve ~40 write
# batches, their reads checked once quiesced. bench.py's ingest shape is
# 8 clients x 200 operations; the run's time limit cuts it to 8 x 50
WRITES_SEQUENTIAL_OPS = 40
WRITES_CLIENT_OPS = 50
WRITES_CLIENT_OPS_BENCH = 200

# keys: Pilosa's keyed indexes (index and field option ``keys``) with row
# attributes and TopN's attrName/attrValues filter, on the port's server:
# one shard of column keys, 1024 row keys at the dense cell's density
KEYS_DIR = ".keys"  # under the run's root; the holder skips dot names
KEYS_COLUMNS = SW  # column keys asked for: one shard's width
KEYS_ROWS = 1024
KEYS_BATCH = 65_536  # column keys a keyed import request
KEYS_IMPORT_ROWS = 256  # rows a plain import call (~4.2M bits)
KEYS_CATEGORIES = 16
KEYS_FILTER = ("cat-03", "cat-11")  # two of the 16: 128 candidate rows
KEYS_COLUMN_ATTRS = 65_536
KEYS_ATTR_BATCH = 4096  # SetColumnAttrs calls a request
KEYS_REPEATS = 10  # timed runs of each query
KEYS_SEED = 1407
KEYS_KERNELS = ("dense_scores", "tree_count")

# tiered: bench.py's tiering probe (bench.py:1154-1240) at 4096 rows
TIER_ROWS = 4096
TIER_BITS = 1200  # rows = 0-5 (mod 8): array containers
TIER_RUN = 4001  # rows = 6: one run container (tests/test_tiering.py:279)
TIER_BITMAP = 5000  # rows = 7: one bitmap container (:281)
TIER_COUNTS = 2400  # Count(Row) queries per arm
TIER_TOPN = 16  # filtered TopN per arm
# TopN over the ids of the first 128 rows per arm: they are all scored in
# the executor's first chunk (FIRST_CHUNK), staged dense and, at a
# payload ratio of ~46, expanded on the card: 128 x 32,768 words
TIER_IDS_TOPN = 16
FIRST_CHUNK_ROWS = 128
TIER_CLIENTS = 4
THINK_S = 0.008
HOT = 4  # the probe's hot set: rows below it


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


def _write_dense(root: str, rows: int) -> None:
    from pilosa_tpu_torch.roaring.writer import build_fragment_file

    build_fragment_file(os.path.join(_fragment_dir(root, "dense"), "0"), _dense_chunks(rows))


def _write_tall_shard(root: str, shard: int, rows_per_shard: int) -> None:
    from pilosa_tpu_torch.roaring.writer import build_fragment_file

    build_fragment_file(
        os.path.join(_fragment_dir(root, "tall"), str(shard)), _tall_chunks(shard, rows_per_shard)
    )


def _bit_depth(span: int) -> int:
    """BSIGroup.bit_depth: the smallest i with max - min < 2^i."""
    return next(i for i in range(64) if span < (1 << i))


def ssb_columns(shard: int, rows: int = SSB_ROWS) -> dict:
    """One shard's lineorder columns, drawn uniformly as dbgen draws them:
    the customer's and supplier's city (which fix nation and region), the
    part's brand (which fixes its category), the order year, quantity
    1-50, discount 0-10, and revenue = quantity x retail price x (100 -
    discount) / 100 with the retail price in [90,000, 210,000]."""
    n = min(SW, rows - shard * SW)
    rng = np.random.default_rng([SSB_SEED, shard])
    year = (1992 + rng.integers(0, 7, n)).astype(np.int16)
    c_city = rng.integers(0, 250, n).astype(np.int16)
    s_city = rng.integers(0, 250, n).astype(np.int16)
    brand = rng.integers(0, 1000, n).astype(np.int16)
    qty = rng.integers(1, 51, n).astype(np.int8)
    disc = rng.integers(0, 11, n).astype(np.int8)
    price = rng.integers(90_000, 210_001, n)
    rev = (qty.astype(np.int64) * price * (100 - disc.astype(np.int64)) // 100).astype(np.int32)
    return {
        "d_year": year,
        "c_city": c_city,
        "c_nation": c_city // 10,
        "c_region": c_city // 50,
        "s_city": s_city,
        "s_nation": s_city // 10,
        "s_region": s_city // 50,
        "p_brand1": brand,
        "p_category": brand // 40,
        "lo_quantity": qty,
        "lo_discount": disc,
        "lo_revenue": rev,
    }


def _write_ssb_shard(root: str, shard: int, rows: int) -> None:
    """A shard's fragments: one row per column in each set field; bit
    planes plus the not-null row in each int field's BSI view."""
    from pilosa_tpu_torch.roaring.writer import build_fragment_file

    cols = ssb_columns(shard, rows)
    n = cols["d_year"].size
    local = np.arange(n, dtype=np.uint64)
    for f in SSB_SET_FIELDS:
        order = np.argsort(cols[f], kind="stable")
        pos = cols[f][order].astype(np.uint64) * np.uint64(SW) + local[order]
        d = os.path.join(root, "ssb", f, "views", "standard", "fragments")
        os.makedirs(d, exist_ok=True)
        build_fragment_file(os.path.join(d, str(shard)), [pos])
    for f, (lo, hi) in SSB_INT_FIELDS.items():
        depth = _bit_depth(hi - lo)
        base = cols[f].astype(np.int64) - lo
        chunks = [np.uint64(i * SW) + local[(base >> i) & 1 == 1] for i in range(depth)]
        chunks.append(np.uint64(depth * SW) + local)
        d = os.path.join(root, "ssb", f, "views", "bsig_" + f, "fragments")
        os.makedirs(d, exist_ok=True)
        build_fragment_file(os.path.join(d, str(shard)), chunks)


def _create_ssb_schema(root: str) -> None:
    from pilosa_tpu_torch.core import FieldOptions, Holder

    h = Holder(root)
    h.open()
    idx = h.create_index("ssb")
    for f in SSB_SET_FIELDS:
        idx.create_field(f)
    for f, (lo, hi) in SSB_INT_FIELDS.items():
        idx.create_field(f, FieldOptions(type="int", min=lo, max=hi))
    h.close()


def build_data(root: str, dense_rows: int, shards: int, rows_per_shard: int, ssb_rows: int, during=None):
    """Write the three data sets with BUILD_WORKERS processes, running
    ``during()`` in this process meanwhile. Returns (the seconds until
    each set's last fragment was written, what ``during`` returned)."""
    _create_ssb_schema(root)
    t0 = time.monotonic()
    done: dict = {}

    def finished(name):
        def cb(_fut) -> None:
            done[name] = max(done.get(name, 0.0), time.monotonic() - t0)

        return cb

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=BUILD_WORKERS, mp_context=ctx) as pool:
        jobs = [("ssb_build_s", pool.submit(_write_ssb_shard, root, s, ssb_rows)) for s in range(-(-ssb_rows // SW))]
        jobs += [("tall_build_s", pool.submit(_write_tall_shard, root, s, rows_per_shard)) for s in range(shards)]
        jobs.append(("dense_build_s", pool.submit(_write_dense, root, dense_rows)))
        for name, fut in jobs:
            fut.add_done_callback(finished(name))
        extra = during() if during is not None else None
        for _, fut in jobs:
            fut.result()
    return {**done, "build_workers": BUILD_WORKERS}, extra


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


# -- SSB queries and their numpy oracle ----------------------------------------------


def _ids(xs) -> str:
    return "[" + ", ".join(str(int(x)) for x in xs) + "]"


class SsbOracle:
    """Every ssb answer from the generated columns alone, with numpy:
    int64 sums, exact counts. Independent of the port: it reads no
    fragment and runs no kernel. Results are in the executor's shapes
    (ValCount, GroupBy wire lists, sorted value lists, ints)."""

    def __init__(self, valcount, rows: int = SSB_ROWS) -> None:
        self.rows = rows
        self.shards = -(-rows // SW)
        parts = [ssb_columns(s, rows) for s in range(self.shards)]
        # shard s holds columns [s * SW, (s + 1) * SW)
        self.c = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        self.ValCount = valcount
        self.queries: list[tuple[str, str]] = []  # (family, pql)
        self.answers: dict = {}

    def add(self, family: str, pql: str, answer) -> None:
        self.queries.append((family, pql))
        self.answers[pql] = [answer]

    # masks
    def row(self, f: str, r: int):
        return self.c[f] == r

    def rng(self, f: str, op: str, a: int, b: int = 0):
        v = self.c[f].astype(np.int64)
        return {
            "==": v == a, "!=": v != a, "<": v < a, "<=": v <= a, ">": v > a, ">=": v >= a,
            "><": (v >= a) & (v <= b),
        }[op]

    # answers
    def sum(self, field: str, m):
        v = self.c[field][m].astype(np.int64)
        return self.ValCount(int(v.sum()), int(v.size)) if v.size else self.ValCount()

    def minmax(self, field: str, m, is_min: bool):
        """Per shard (value, columns holding it), folded in shard order as
        the executor's reduce does: ties keep the earlier shard."""
        acc = self.ValCount()
        v = self.c[field].astype(np.int64)
        for s in range(self.shards):
            sl = slice(s * SW, (s + 1) * SW)
            sv = v[sl][m[sl]]
            if sv.size:
                x = int(sv.min() if is_min else sv.max())
                vc = self.ValCount(x, int((sv == x).sum()))
                acc = acc.smaller(vc) if is_min else acc.larger(vc)
        return acc

    def percentile(self, field: str, m, nth_bp: int):
        v = self.c[field][m].astype(np.int64)
        n = int(v.size)
        if n == 0:
            return self.ValCount()
        q, r = divmod(n, 10000)
        k = min(max(nth_bp * q + (nth_bp * r + 9999) // 10000, 1), n)
        return self.ValCount(int(np.partition(v, k - 1)[k - 1]), n)

    def distinct(self, field: str, m):
        return [int(x) for x in np.unique(self.c[field][m])]

    def groupby(self, dims, m, agg=None):
        """dims: [(field, ids or None for discovered)]; product order,
        zero-count groups dropped, as analytics.finalize_groups emits."""
        resolved = [(f, list(ids) if ids is not None else [int(x) for x in np.unique(self.c[f])]) for f, ids in dims]
        sel = m.copy()
        pos = []
        for f, ids in resolved:
            col = self.c[f].astype(np.int64)
            lut = np.full(max(int(col.max()), max(ids)) + 1, -1, dtype=np.int64)
            lut[ids] = np.arange(len(ids))
            p = lut[col]
            sel &= p >= 0
            pos.append(p)
        idx = np.zeros(int(sel.sum()), dtype=np.int64)
        for p, (_, ids) in zip(pos, resolved):
            idx = idx * len(ids) + p[sel]
        k = 1
        for _, ids in resolved:
            k *= len(ids)
        counts = np.bincount(idx, minlength=k)
        sums = np.zeros(k, dtype=np.int64)
        if agg is not None:
            np.add.at(sums, idx, self.c[agg][sel].astype(np.int64))
        out = []
        for gi, key in enumerate(itertools.product(*[ids for _, ids in resolved])):
            if counts[gi] == 0:
                continue
            e = {"group": [{"field": f, "rowID": int(r)} for (f, _), r in zip(resolved, key)], "count": int(counts[gi])}
            if agg is not None:
                e["sum"] = int(sums[gi])
            out.append(e)
        return out


def ssb_workload(oracle: SsbOracle) -> None:
    """The ssb queries, each added with its oracle answer."""
    o, R, G = oracle, oracle.row, oracle.rng
    years = list(SSB_YEARS)
    # Q1.1 / Q1.2: SSB's extendedprice x discount is not a PQL field, so
    # the aggregate is Sum(lo_revenue) under the same filters
    o.add("sum", "Sum(Intersect(Row(d_year=1993), Range(lo_discount >< [1, 3]), Range(lo_quantity < 25)), field=lo_revenue)",
          o.sum("lo_revenue", R("d_year", 1993) & G("lo_discount", "><", 1, 3) & G("lo_quantity", "<", 25)))
    o.add("sum", "Sum(Intersect(Row(d_year=1994), Range(lo_discount >< [4, 6]), Range(lo_quantity >< [26, 35])), field=lo_revenue)",
          o.sum("lo_revenue", R("d_year", 1994) & G("lo_discount", "><", 4, 6) & G("lo_quantity", "><", 26, 35)))
    everything = np.ones(o.rows, dtype=bool)
    o.add("sum", "Sum(field=lo_revenue)", o.sum("lo_revenue", everything))
    # Q2.1: category MFGR#12's 40 brands x 7 years, suppliers in AMERICA
    b12 = list(range(12 * 40, 13 * 40))
    o.add("groupby", f"GroupBy(Rows(d_year), Rows(p_brand1, ids={_ids(b12)}), Intersect(Row(p_category=12), Row(s_region={AMERICA})), Sum(field=lo_revenue))",
          o.groupby([("d_year", None), ("p_brand1", b12)], R("p_category", 12) & R("s_region", AMERICA), "lo_revenue"))
    # Q2.2: brands MFGR#2221-2228 x 7 years, suppliers in ASIA
    b22 = list(range(22 * 40 + 20, 22 * 40 + 28))
    o.add("groupby", f"GroupBy(Rows(d_year), Rows(p_brand1, ids={_ids(b22)}), Row(s_region={ASIA}), Sum(field=lo_revenue))",
          o.groupby([("d_year", None), ("p_brand1", b22)], R("s_region", ASIA), "lo_revenue"))
    # Q3.1: ASIA customer nation x supplier nation x 1992-1997
    asia = list(range(ASIA * 5, ASIA * 5 + 5))
    o.add("groupby", f"GroupBy(Rows(c_nation, ids={_ids(asia)}), Rows(s_nation, ids={_ids(asia)}), Rows(d_year, ids={_ids(years[:6])}), Intersect(Row(c_region={ASIA}), Row(s_region={ASIA})), Sum(field=lo_revenue))",
          o.groupby([("c_nation", asia), ("s_nation", asia), ("d_year", years[:6])], R("c_region", ASIA) & R("s_region", ASIA), "lo_revenue"))
    # Q3.2: UNITED STATES customer city x supplier city x 1992-1997
    us = list(range(UNITED_STATES * 10, UNITED_STATES * 10 + 10))
    o.add("groupby", f"GroupBy(Rows(c_city, ids={_ids(us)}), Rows(s_city, ids={_ids(us)}), Rows(d_year, ids={_ids(years[:6])}), Intersect(Row(c_nation={UNITED_STATES}), Row(s_nation={UNITED_STATES})), Sum(field=lo_revenue))",
          o.groupby([("c_city", us), ("s_city", us), ("d_year", years[:6])], R("c_nation", UNITED_STATES) & R("s_nation", UNITED_STATES), "lo_revenue"))
    o.add("groupby", "GroupBy(Rows(c_region), Rows(s_region))",
          o.groupby([("c_region", None), ("s_region", None)], everything))
    # Min / Max / Percentile / Distinct
    for is_min in (True, False):
        name = "Min" if is_min else "Max"
        o.add(STATS, f"{name}(field=lo_revenue)", o.minmax("lo_revenue", everything, is_min))
        o.add(STATS, f"{name}(Intersect(Row(p_category=3), Range(lo_discount == 0)), field=lo_revenue)",
              o.minmax("lo_revenue", R("p_category", 3) & G("lo_discount", "==", 0), is_min))
    for nth in (50, 95):
        o.add(STATS, f"Percentile(field=lo_revenue, nth={nth})", o.percentile("lo_revenue", everything, nth * 100))
        o.add(STATS, f"Percentile(Row(d_year=1997), field=lo_revenue, nth={nth})",
              o.percentile("lo_revenue", R("d_year", 1997), nth * 100))
    o.add(STATS, "Percentile(Row(c_region=3), field=lo_quantity, nth=95)",
          o.percentile("lo_quantity", R("c_region", 3), 9500))
    o.add(STATS, "Distinct(field=lo_quantity)", o.distinct("lo_quantity", everything))
    o.add(STATS, "Distinct(field=lo_discount)", o.distinct("lo_discount", everything))
    o.add(STATS, "Distinct(Row(p_brand1=7), field=lo_discount)", o.distinct("lo_discount", R("p_brand1", 7)))
    # Count(Range) of every operator, and Range leaves inside chains
    x = int(o.c["lo_revenue"][123_457])
    for op, a, b in [("==", x, 0), ("!=", x, 0), ("<", 2_500_000, 0), ("<=", 2_500_000, 0),
                     (">", 7_000_000, 0), (">=", 7_000_000, 0), ("><", 1_000_000, 2_000_000)]:
        rhs = f"[{a}, {b}]" if op == "><" else str(a)
        o.add(RANGE, f"Count(Range(lo_revenue {op} {rhs}))", int(G("lo_revenue", op, a, b).sum()))
    o.add(RANGE, "Count(Range(lo_quantity < 25))", int(G("lo_quantity", "<", 25).sum()))
    o.add(RANGE, "Count(Range(lo_revenue != null))", o.rows)
    o.add(RANGE, "Count(Intersect(Row(d_year=1996), Range(lo_revenue >< [1000000, 2000000])))",
          int((R("d_year", 1996) & G("lo_revenue", "><", 1_000_000, 2_000_000)).sum()))
    o.add(RANGE, f"Count(Union(Intersect(Row(c_region={AMERICA}), Range(lo_discount > 8)), Intersect(Row(s_region=4), Range(lo_quantity <= 3))))",
          int(((R("c_region", AMERICA) & G("lo_discount", ">", 8)) | (R("s_region", 4) & G("lo_quantity", "<=", 3))).sum()))


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


# -- writes and tiered staging ---------------------------------------------------------


def _counters(metrics, *names) -> dict:
    """Each counter's labelled series summed, and the labelled ones
    apart (``name;label:value``)."""
    out = {}
    for k, v in metrics.snapshot().items():
        if isinstance(v, dict):
            continue
        name = k.partition(";")[0]
        if name in names:
            out[name] = out.get(name, 0) + v
            if ";" in k:
                out[k] = v
    return out


def _diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _pct(xs: list[float], p: float) -> float:
    s = sorted(xs)
    return s[min(len(s) - 1, int(p * len(s)))] * 1e3


def writes_reads() -> list[list[tuple[str, str]]]:
    """The writes phase's read pools, one per READ_SHARES entry: the
    ingest probe's four shapes over dense (rows from a seed), the dense
    TopN sources, the tall Count(chain) queries."""
    rng = np.random.default_rng(59)
    a, b, c, d, e, g = (int(x) for x in rng.choice(DENSE_ROWS, size=6, replace=False))
    shapes = [
        "TopN(f, n=10)",
        f"TopN(f, Row(f={a}), n=8)",
        f"Count(Intersect(Row(f={b}), Row(f={c})))",
        f"Count(Union(Row(f={d}), Row(f={e}), Row(f={g})))",
    ]
    _, chains = tall_queries()
    return [
        [("dense", q) for q in shapes],
        [("dense", q) for q in dense_queries(DENSE_ROWS)],
        [("tall", q) for q in chains],
    ]


def write_batch(rng) -> tuple[str, str]:
    """One request of WRITE_BATCH Set/Clear calls (bench.py:736-738):
    dense rows uniform over all its rows, tall rows over the hot rows
    its chains read and columns over every shard."""
    if rng.random() < 0.5:
        index, top, cols = "dense", DENSE_ROWS, SW
    else:
        index, top, cols = "tall", HOT_ROWS, TALL_SHARDS * SW
    rows = rng.integers(0, top, WRITE_BATCH)
    col = rng.integers(0, cols, WRITE_BATCH)
    sets = rng.random(WRITE_BATCH) < SET_FRAC
    return index, "".join(
        f"{'Set' if s else 'Clear'}({int(c)}, f={int(r)})" for r, c, s in zip(rows, col, sets)
    )


def writes_ops(seed, n: int, pools) -> list[tuple[str, str, str]]:
    """A seeded sequence of ("w" | "r", index, pql)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if rng.random() < WRITE_FRAC:
            out.append(("w",) + write_batch(rng))
        else:
            pool = pools[rng.choice(len(pools), p=READ_SHARES)]
            out.append(("r",) + pool[int(rng.integers(0, len(pool)))])
    return out


def run_writes(dev, cpu) -> dict:
    """The writes phase on ``dev``'s stager: a seeded sequence with every
    read held against the CPU leg right after it, then CLIENTS concurrent
    clients, then every read of the pools against the CPU leg."""
    from pilosa_tpu_torch.utils import metrics

    names = (
        metrics.STAGER_DELTA_APPLIED,
        metrics.STAGER_DELTA_FALLBACK,
        metrics.STAGER_RESTAGED_BYTES,
        metrics.STAGER_MISSES_COLD,
        metrics.STAGER_MISSES_INVALIDATION,
    )
    st = dev.stager
    pools = writes_reads()
    m0, forms0 = _counters(metrics, *names), dict(st.delta_by_form)
    routes0 = dict(st.delta_routes)
    out = {}

    reads, writes = [], []
    cpu_s = 0.0
    for kind, index, q in writes_ops(61, WRITES_SEQUENTIAL_OPS, pools):
        t0 = time.perf_counter()
        ans = dev.execute(index, q)
        dt = time.perf_counter() - t0
        if kind == "w":
            writes.append(dt)
            continue
        reads.append(dt)
        t0 = time.perf_counter()
        want = cpu.execute(index, q)
        cpu_s += time.perf_counter() - t0
        if ans != want:
            raise AssertionError(f"writes: {index}: {q} answered {ans}, CPU leg {want}")
    routes1 = dict(st.delta_routes)
    out["sequential"] = {
        "reads": len(reads),
        "writes": len(writes),
        "read_qps": len(reads) / sum(reads),
        "read_p50_ms": statistics.median(reads) * 1e3,
        "write_p50_ms": statistics.median(writes) * 1e3,
        "refreshes_by_route": _diff(routes1, routes0),
    }

    lat: list[list] = [[] for _ in range(CLIENTS)]
    errors: list[BaseException] = []
    start = threading.Barrier(CLIENTS)

    def client(ci: int) -> None:
        try:
            start.wait()
            for kind, index, q in writes_ops([67, ci], WRITES_CLIENT_OPS, pools):
                t0 = time.perf_counter()
                dev.execute(index, q)
                lat[ci].append((kind, time.perf_counter() - t0))
        except BaseException as e:  # re-raised below, after every thread joined
            errors.append(e)
            start.abort()

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    reads = [dt for per in lat for kind, dt in per if kind == "r"]
    writes = [dt for per in lat for kind, dt in per if kind == "w"]
    out[f"concurrent_c{CLIENTS}"] = {
        "reads": len(reads),
        "writes": len(writes),
        "read_qps": len(reads) / wall,
        "read_p50_ms": statistics.median(reads) * 1e3,
        "write_p50_ms": statistics.median(writes) * 1e3 if writes else None,
        "refreshes_by_route": _diff(dict(st.delta_routes), routes1),
    }
    # quiesced: every read once more against the CPU leg
    checked = 0
    for pool in pools:
        for index, q in pool:
            ans = dev.execute(index, q)
            t0 = time.perf_counter()
            want = cpu.execute(index, q)
            cpu_s += time.perf_counter() - t0
            if ans != want:
                raise AssertionError(f"writes (after the clients): {index}: {q} answered {ans}, CPU leg {want}")
            checked += 1
    out["reads_checked_after"] = checked
    out["cpu_leg_s"] = cpu_s
    out["delta_applied_by_form"] = _diff(st.delta_by_form, forms0)
    counters = _diff(_counters(metrics, *names), m0)
    out["delta_applied"] = counters.get(metrics.STAGER_DELTA_APPLIED, 0)
    out["delta_fallback"] = {
        k.partition(";")[2]: v for k, v in counters.items() if k.startswith(metrics.STAGER_DELTA_FALLBACK + ";")
    }
    out["restaged_bytes"] = counters.get(metrics.STAGER_RESTAGED_BYTES, 0)
    out["misses_cold"] = counters.get(metrics.STAGER_MISSES_COLD, 0)
    out["misses_invalidation"] = counters.get(metrics.STAGER_MISSES_INVALIDATION, 0)
    out["refreshes_by_route"] = _diff(dict(st.delta_routes), routes0)
    by_form = out["delta_applied_by_form"]
    for form in ("row", "rows_p2", "row_stack"):
        if by_form.get(form, 0) <= 0:
            raise AssertionError(f"writes: no delta applied on the {form} form: {by_form}")
    if out["refreshes_by_route"].get("in_place", 0) <= 0:
        raise AssertionError(f"writes: no refresh patched in place: {out['refreshes_by_route']}")
    return out


def tier_bits(seed: int = 43):
    """The tier index's bits: rows = 0-5 (mod 8) TIER_BITS random
    columns, rows = 6 one run of TIER_RUN columns at a seeded offset,
    rows = 7 TIER_BITMAP columns inside one seeded 2^16-column slot."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(TIER_ROWS):
        if r % 8 < 6:
            c = rng.integers(0, SW, TIER_BITS)
        elif r % 8 == 6:
            off = int(rng.integers(0, SW - TIER_RUN))
            c = np.arange(off, off + TIER_RUN)
        else:
            c = int(rng.integers(0, SW >> 16)) * 65536 + rng.choice(65536, TIER_BITMAP, replace=False)
        rows.append(np.full(len(c), r, dtype=np.uint64))
        cols.append(np.asarray(c, dtype=np.uint64))
    return np.concatenate(rows), np.concatenate(cols)


def build_tier(holder) -> dict:
    """The tier index through Field.import_bits (the roaring writer
    writes no run containers); fails unless the fragment holds array,
    run and bitmap containers."""
    from pilosa_tpu_torch.roaring.bitmap import CONTAINER_ARRAY, CONTAINER_BITMAP, CONTAINER_RUN

    rows, cols = tier_bits()
    holder.create_index("tier").create_field("f").import_bits(rows, cols)
    frag = holder.fragment("tier", "f", "standard", 0)
    entries, nbytes = frag.container_blocks(list(range(TIER_ROWS)))
    kinds = {"array": CONTAINER_ARRAY, "run": CONTAINER_RUN, "bitmap": CONTAINER_BITMAP}
    found = {name: sum(1 for e in entries if e[2] == typ) for name, typ in kinds.items()}
    if not all(found.values()):
        raise AssertionError(f"tier: container kinds {found}, expected all three")
    return {"bits": int(rows.size), "containers": found, "payload_bytes": nbytes,
            "dense_bytes": TIER_ROWS * SW // 8}


def tier_queries() -> list[tuple[str, int]]:
    """(pql, row) for one arm: TIER_COUNTS Count(Row(f=k)) with k from
    one fixed Zipf(1.3) draw sequence (seed 31, bench.py:1192), and
    TIER_TOPN filtered TopN and TIER_IDS_TOPN TopN over the first
    FIRST_CHUNK_ROWS rows' ids, spread evenly among them (row -1)."""
    z = (np.random.default_rng(31).zipf(1.3, size=TIER_COUNTS) - 1) % TIER_ROWS
    qs = [(f"Count(Row(f={int(k)}))", int(k)) for k in z]
    rng = np.random.default_rng(37)
    ids = ", ".join(str(r) for r in range(FIRST_CHUNK_ROWS))
    topn = [f"TopN(f, Row(f={int(k)}), n=10)" for k in rng.choice(TIER_ROWS, size=TIER_TOPN, replace=False)]
    topn += [
        f"TopN(f, Row(f={int(k)}), n=10, ids=[{ids}])"
        for k in rng.choice(TIER_ROWS, size=TIER_IDS_TOPN, replace=False)
    ]
    # interleaved: the two kinds alternate
    topn = [q for pair in zip(topn[:TIER_TOPN], topn[TIER_TOPN:]) for q in pair]
    step = len(qs) // len(topn)
    for i, q in enumerate(topn):
        qs.insert(i * (step + 1), (q, -1))
    return qs


def _tier_clients(ex, qs, oracle) -> tuple[list, float]:
    """TIER_CLIENTS threads, client c sending qs[c::TIER_CLIENTS] with
    THINK_S between queries. Returns ((pql, row, seconds), wall)."""
    lat: list[list] = [[] for _ in range(TIER_CLIENTS)]
    errors: list[BaseException] = []

    def client(ci: int) -> None:
        try:
            for q, k in qs[ci::TIER_CLIENTS]:
                t0 = time.perf_counter()
                ans = ex.execute("tier", q)
                lat[ci].append((q, k, time.perf_counter() - t0))
                if ans != oracle[q]:
                    raise AssertionError(f"tier: {q} answered {ans}, CPU leg {oracle[q]}")
                time.sleep(THINK_S)
        except BaseException as e:  # re-raised below, after every thread joined
            errors.append(e)

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(TIER_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return [x for per in lat for x in per], wall


def tier_arm(holder, device, qs, oracle, budget: int, mid_write=None) -> tuple[dict, int]:
    """One arm on a fresh default stager of ``budget`` bytes.
    ``mid_write(ex)`` runs between the two halves of the arm, with the
    clients stopped. Returns (the arm's numbers, bytes staged at its
    end)."""
    import pilosa_tpu_torch
    from pilosa_tpu_torch.executor import DeviceStager
    from pilosa_tpu_torch.utils import metrics

    names = (
        metrics.STAGER_RESTAGED_BYTES,
        metrics.TIERING_COMPRESSED_UPLOADS,
        metrics.TIERING_UPLOAD_BYTES_SAVED,
    )
    st = DeviceStager(device, budget)
    ex = pilosa_tpu_torch.Executor(holder, device=device, device_policy="always", stager=st)
    m0 = _counters(metrics, *names)
    watch = {"peak_bytes": 0, "over_budget": 0}
    stop = threading.Event()

    def watcher() -> None:
        # staged bytes stay within the budget, bar the one entry just
        # built (the stager evicts down to it)
        while not stop.is_set():
            b, n = st.usage()
            watch["peak_bytes"] = max(watch["peak_bytes"], b)
            if b > budget and n > 1:
                watch["over_budget"] += 1
            time.sleep(0.001)

    w = threading.Thread(target=watcher)
    w.start()
    halves = [qs] if mid_write is None else [qs[: len(qs) // 2], qs[len(qs) // 2 :]]
    lat, wall = [], 0.0
    try:
        for i, part in enumerate(halves):
            if i:
                mid_write(ex)
            l, s = _tier_clients(ex, part, oracle)
            lat += l
            wall += s
        staged, entries = st.usage()
    finally:
        stop.set()
        w.join()
        ex.close()
    counters = _diff(_counters(metrics, *names), m0)
    t1 = st.tier1.stats()
    all_s = [s for _, _, s in lat]
    hot = [s for _, k, s in lat if 0 <= k < HOT]
    res = {
        "budget_bytes": budget,
        "queries": len(lat),
        "qps": len(lat) / wall,
        "p50_ms": _pct(all_s, 0.50),
        "p95_ms": _pct(all_s, 0.95),
        "hot_queries": len(hot),
        "hot_p50_ms": _pct(hot, 0.50),
        "t0_hit_rate": st.hits / max(st.hits + st.misses, 1),
        "t1_hit_rate": t1["hits"] / max(t1["hits"] + t1["misses"], 1),
        "t1": t1,
        "restaged_bytes": counters.get(metrics.STAGER_RESTAGED_BYTES, 0),
        "compressed_uploads": counters.get(metrics.TIERING_COMPRESSED_UPLOADS, 0),
        "upload_bytes_saved": counters.get(metrics.TIERING_UPLOAD_BYTES_SAVED, 0),
        "delta_applied": st.delta_applies,
        "staged_bytes_end": staged,
        "staged_entries_end": entries,
        "peak_staged_bytes": watch["peak_bytes"],
    }
    if watch["over_budget"]:
        raise AssertionError(f"tier: staged bytes above the {budget}-byte budget: {res}")
    return res, staged


def run_tiered(holder, cpu, device) -> dict:
    """The two arms, every answer held against the CPU leg."""
    t0 = time.monotonic()
    qs = tier_queries()
    oracle = {q: cpu.execute("tier", q) for q in {q for q, _ in qs}}
    out = {"cpu_leg_s": time.monotonic() - t0, "distinct_queries": len(oracle)}

    def mid_write(ex) -> None:
        # one WRITE_BATCH-mutation request to the hot rows; then the CPU
        # leg's answers of every query it can change
        rng = np.random.default_rng(71)
        rows = rng.integers(0, HOT, WRITE_BATCH)
        cols = rng.integers(0, SW, WRITE_BATCH)
        sets = rng.random(WRITE_BATCH) < SET_FRAC
        ex.execute("tier", "".join(
            f"{'Set' if s else 'Clear'}({int(c)}, f={int(r)})" for r, c, s in zip(rows, cols, sets)
        ))
        for q in {q for q, k in qs if k < 0 or k in rows}:
            oracle[q] = cpu.execute("tier", q)

    out["1x"], working_set = tier_arm(holder, device, qs, oracle, STAGER_BUDGET)
    out["working_set_bytes"] = working_set
    out["3x"], _ = tier_arm(holder, device, qs, oracle, working_set // 3, mid_write)
    three = out["3x"]
    for key in ("restaged_bytes", "compressed_uploads"):
        if three[key] <= 0:
            raise AssertionError(f"tier 3x: no {key}: {three}")
    if three["t1"]["hits"] <= 0:
        raise AssertionError(f"tier 3x: no tier-1 hit: {three}")
    return out


# -- kernels against their plain versions ----------------------------------------------


def _copy_tensors(args, fn):
    """``args`` with each tensor replaced by ``fn(tensor)``: tensors that
    share one storage, offset, shape and strides share their copy, so a
    launch reads each distinct leaf once, as the recorded one did."""
    import torch

    memo: dict = {}

    def copy(x):
        if isinstance(x, torch.Tensor):
            key = (x.device, x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)
            if key not in memo:
                memo[key] = fn(x)
            return memo[key]
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        if isinstance(x, SparseGroups):
            return SparseGroups(copy(x.order), copy(x.items), x.nb, x.num_rows, x.n_shards, x.slots)
        return x

    from pilosa_tpu_torch.ops.packed import SparseGroups

    return copy(args)


# where ``_keep`` puts its copies: on the card (no host wait, so the
# paths' timings and the fused enqueue's sync check hold) or, on the
# server path, on the host, so no kept tensor sits among the server's
# allocations, whose segments the OOM check's relief must return whole
KEEP_ON_HOST = {"on": False}


def _keep(args):
    """A copy of a launch's arguments that holds no staged tensor: a held
    one would turn the stager's next refresh of it from a patch in place
    into a copy, and a patch in place would change what was kept. Copies
    made on the card go to the host when their path ends (``_offload``)."""
    if KEEP_ON_HOST["on"]:
        return _copy_tensors(args, lambda x: x.cpu())
    return _copy_tensors(args, lambda x: x.clone())


def _offload(args):
    """Kept arguments with every tensor on the host."""
    return _copy_tensors(args, lambda x: x.cpu())


def _on_card(args):
    """Kept arguments back on the card, to launch them again."""
    return _copy_tensors(args, lambda x: x.cuda())


def _card_storages(*objs) -> dict:
    """{data_ptr: bytes} of the distinct device storages that ``objs``
    hold, through lists, tuples, dicts and objects' attributes."""
    import torch

    seen: dict = {}
    stack, visited = list(objs), set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                st = x.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
        elif isinstance(x, (list, tuple, set)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif id(x) not in visited and (hasattr(x, "__dict__") or hasattr(x, "__slots__")):
            visited.add(id(x))
            if hasattr(x, "__dict__"):
                stack.extend(vars(x).values())
            for slot in getattr(type(x), "__slots__", ()):
                stack.append(getattr(x, slot, None))
    return seen


# what the script itself holds on the card (kept launch arguments);
# main registers its recorders here
SMOKE_HELD: list = []


def _describe_holders(t, skip: list, depth: int = 3) -> list:
    """What holds tensor ``t``: each referrer's kind (an object's class
    and attribute, a dict's or list's own holders, a frame's function and
    line), ``depth`` levels up, leaving out the objects in ``skip``."""
    import gc
    import types

    skip_ids = {id(x) for x in skip}

    def name(r, child) -> str:
        if isinstance(r, types.FrameType):
            return f"frame {r.f_code.co_name} {os.path.basename(r.f_code.co_filename)}:{r.f_lineno}"
        if isinstance(r, dict):
            keys = [repr(k)[:40] for k, v in r.items() if v is child][:2]
            return f"dict[{','.join(keys)}]"
        if isinstance(r, (types.FunctionType, types.MethodType)):
            return f"function {getattr(r, '__qualname__', '?')}"
        if isinstance(r, types.TracebackType):
            return f"traceback at {r.tb_frame.f_code.co_name}:{r.tb_lineno}"
        if isinstance(r, BaseException):
            return f"exception {type(r).__qualname__}: {str(r)[:80]}"
        return type(r).__qualname__

    own_frames = ("walk", "_describe_holders", "card_memory_by_owner")
    skip_ids.add(id(skip))

    def walk(x, level: int) -> list:
        refs = gc.get_referrers(x)
        skip_ids.add(id(refs))
        out = []
        for r in refs:
            if id(r) in skip_ids or isinstance(r, types.FrameType) and r.f_code.co_name in own_frames:
                continue
            node = {"by": name(r, x)}
            if level > 1 and not isinstance(r, types.ModuleType):
                node["held_by"] = walk(r, level - 1)
            out.append(node)
            if len(out) >= 6:
                break
        return out

    return walk(t, depth)


def card_memory_by_owner(ex, holders: int = 0) -> dict:
    """Where the card's allocated bytes are, by owner: the stager's and the
    device plan cache's entries, the script's kept arguments, other live
    tensors (by dtype and shape, largest first) and what no Python tensor
    holds; with ``holders``, what holds that many of the largest other
    tensors. Then the segments the allocator cannot return: those holding
    free (inactive) blocks beside live ones, with the live bytes there by
    owner."""
    import gc

    import torch

    torch.cuda.synchronize()
    owner: dict = {}
    with ex.stager._mu:
        staged = [e.value for e in ex.stager._cache.values()]
    for ptr in _card_storages(staged):
        owner[ptr] = "stager"
    dc = getattr(ex, "device_cache", None)
    if dc is not None:
        with dc._mu:
            cached = [e.value for e in dc._entries.values()]
        for ptr in _card_storages(cached):
            owner.setdefault(ptr, "device_cache")
    for ptr in _card_storages(SMOKE_HELD):
        owner.setdefault(ptr, "smoke_kept")
    desc: dict = {}
    others: list = []
    everything = gc.get_objects()
    for o in everything:
        if isinstance(o, torch.Tensor) and o.is_cuda and o.layout == torch.strided:
            ptr, nbytes = o.untyped_storage().data_ptr(), o.untyped_storage().nbytes()
            if ptr not in desc:
                desc[ptr] = (nbytes, f"{o.dtype} {list(o.shape)}")
                if holders and ptr not in owner:
                    others.append((nbytes, o))
    others.sort(key=lambda x: -x[0])
    tops = [o for _, o in others[:holders]]
    del others, o
    held = [
        {"tensor": desc[t.untyped_storage().data_ptr()][1], "holders": _describe_holders(t, [everything, tops])}
        for t in tops
    ]
    del everything, tops
    by_owner: dict = {}
    other: dict = {}
    for ptr, (nbytes, what) in desc.items():
        who = owner.get(ptr, "other_tensors")
        by_owner[who] = by_owner.get(who, 0) + nbytes
        if who == "other_tensors":
            other[what] = other.get(what, 0) + nbytes
    allocated = torch.cuda.memory_allocated()
    by_owner["no_python_tensor"] = allocated - sum(by_owner.values())
    split = {"segments": 0, "inactive_bytes": 0, "active_bytes_by_owner": {}}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        live, free = [], 0
        for b in seg["blocks"]:
            b_addr = b.get("address", addr)
            addr = b_addr + b["size"]
            if b["state"] == "active_allocated":
                live.append((b_addr, b["size"]))
            elif b["state"] == "inactive":
                free += b["size"]
        if live and free:
            split["segments"] += 1
            split["inactive_bytes"] += free
            for b_addr, size in live:
                who = owner.get(b_addr) or ("other_tensors" if b_addr in desc else "no_python_tensor")
                split["active_bytes_by_owner"][who] = split["active_bytes_by_owner"].get(who, 0) + size
    return {
        "allocated": allocated,
        "reserved": torch.cuda.memory_reserved(),
        "by_owner": by_owner,
        "holders": held,
        "other_tensors_largest": sorted(other.items(), key=lambda kv: -kv[1])[:8],
        "split_segments": split,
    }


# the kernels timed at each shape they launch with on the fusion path (the
# rest launch on other paths only), and the distinct shapes of each whose
# arguments are kept and timed; launches of any further shape are counted
# as untimed
FUSION_SHAPE_KERNELS = ("sparse_stacked_scores", "tree_count", "groupby_reduce", "bsi_range",
                        "bsi_minmax", "distinct_presence", "bsi_percentile")
FUSION_SHAPES_KEPT = 24


class Recorder:
    """Wraps the kernel wrappers of ``ops.cuda`` to keep, per kernel, a
    copy of the arguments of its largest launch over the run (by input
    bytes, or popcounts for the GroupBy kernel) and the path it came from
    (``path`` is the path running now), the server's among them. The
    wrappers' own launch counts are untouched."""

    def __init__(self, cuda_mod) -> None:
        self.args: dict[str, tuple] = {}
        self.where: dict[str, str] = {}
        self.kernel_fn: dict = {}
        self.path = None
        self._size: dict[str, int] = {}
        self._mu = threading.Lock()
        # GroupBy launches with K > 1 groups and P > 0 planes
        self.groupby_multi_with_planes = 0
        # the widest count-only GroupBy launch (K > 1, P = 0) and the
        # widest-Q dense scoring launch of the dense_tall path
        self.groupby_count_only = None
        self._count_only_k = 0
        self.dense_widest_q = None
        # expand_blocks launches on the tiered path with each input kind
        # non-empty, and the largest such launch per kind
        self.expand_kinds = {"positions": 0, "runs": 0, "dense": 0}
        self.expand_kind_args: dict[str, tuple] = {}
        self._kind_size: dict[str, int] = {}
        # the most words one expand_blocks launch wrote on that path
        self.expand_widest = 0
        # a one-leaf tree count of one shard row (32,768 words), the
        # tree count's most launched shape
        self.tree_one_leaf = None
        # K2's largest launch at each batch width Q over every path, and
        # the server path's largest launch by blocks (its largest bundle)
        self.sparse_by_q: dict[int, tuple] = {}
        self._sparse_q_size: dict[int, int] = {}
        self.sparse_server_bundle = None
        self._server_blocks = 0
        # each kernel on the fusion path, by shape: {key: [launches, kept
        # arguments of the first launch or None past FUSION_SHAPES_KEPT]}
        self.fusion_shapes: dict[str, dict] = {name: {} for name in FUSION_SHAPE_KERNELS}
        # (wrapper, record key, size): the word-delta kernel's two routes
        # are recorded apart, the in-place one under the kernel's name
        for attr, name, size in (
            ("dense_scores", "dense_scores", self._dense_bytes),
            ("sparse_stacked_scores", "sparse_stacked_scores", self._sparse_bytes),
            ("tree_count", "tree_count", self._tree_bytes),
            ("groupby_reduce", "groupby_reduce", self._groupby_work),
            ("bsi_range", "bsi_range", self._range_bytes),
            ("expand_blocks", "expand_blocks", self._expand_bytes),
            ("word_delta_", "word_delta", self._patch_bytes),
            ("word_delta", COPY_ROUTE, self._delta_bytes),
            ("bsi_minmax", "bsi_minmax", self._minmax_bytes),
            ("distinct_presence", "distinct_presence", self._minmax_bytes),
            ("bsi_percentile", "bsi_percentile", self._minmax_bytes),
        ):
            self.kernel_fn[name] = getattr(cuda_mod, attr)
            setattr(cuda_mod, attr, self._wrap(name, self.kernel_fn[name], size))

    def offload(self) -> None:
        """Move what was kept on the card (under a sync-debug mode) to the host."""
        with self._mu:
            self.args = {k: _offload(v) for k, v in self.args.items()}
            self.expand_kind_args = {k: _offload(v) for k, v in self.expand_kind_args.items()}
            self.dense_widest_q = _offload(self.dense_widest_q)
            self.sparse_by_q = {q: _offload(v) for q, v in self.sparse_by_q.items()}
            self.sparse_server_bundle = _offload(self.sparse_server_bundle)
            self.tree_one_leaf = _offload(self.tree_one_leaf)
            self.groupby_count_only = _offload(self.groupby_count_only)
            for shapes in self.fusion_shapes.values():
                for entry in shapes.values():
                    entry[1] = _offload(entry[1])

    def _wrap(self, name, fn, size):
        def wrapped(*args, **kw):
            if kw:  # K2's grouping, its last parameter, kept with the rest
                args = args + (kw.pop("groups"),)
            n = size(*args)
            with self._mu:
                if n > self._size.get(name, -1):
                    self._size[name] = n
                    self.args[name] = _keep(args)
                    self.where[name] = self.path
                if self.path == "fusion" and name in self.fusion_shapes:
                    shapes = self.fusion_shapes[name]
                    key = json.dumps(_shape(name, args), sort_keys=True)
                    if key not in shapes:
                        shapes[key] = [0, _keep(args) if len(shapes) < FUSION_SHAPES_KEPT else None]
                    shapes[key][0] += 1
            return fn(*args)

        return wrapped

    def _expand_bytes(self, positions, starts, ends, dense, dword, num_words, offsets):
        n = num_words * 4 + (positions.numel() + 2 * starts.numel() + dense.numel() + dword.numel()) * 4
        if self.path == "tiered":
            args = (positions, starts, ends, dense, dword, num_words, offsets)
            with self._mu:
                self.expand_widest = max(self.expand_widest, num_words)
                for kind, t in (("positions", positions), ("runs", starts), ("dense", dense)):
                    if t.numel():
                        self.expand_kinds[kind] += 1
                        if n > self._kind_size.get(kind, -1):
                            self._kind_size[kind] = n
                            self.expand_kind_args[kind] = _keep(args)
        return n

    @staticmethod
    def _delta_bytes(words, shard_idx, word_idx, or_mask, andnot_mask):
        return words.numel() * 4 + word_idx.numel() * 16

    @staticmethod
    def _patch_bytes(words, shard_idx, word_idx, or_mask, andnot_mask):
        return word_idx.numel() * 16

    def _dense_bytes(self, srcs, mat):
        if self.path == "dense_tall":
            with self._mu:
                cur = self.dense_widest_q
                if cur is None or (srcs.shape[0], mat.numel()) > (cur[0].shape[0], cur[1].numel()):
                    self.dense_widest_q = _keep((srcs, mat))
        return (srcs.numel() + mat.numel()) * 4

    def _sparse_bytes(self, srcs, blocks, *rest):
        q = _sparse_qsw(srcs)[0]
        n = blocks.numel() * 4 * q
        with self._mu:
            if n > self._sparse_q_size.get(q, -1):
                self._sparse_q_size[q] = n
                self.sparse_by_q[q] = _keep((srcs, blocks) + rest)
            if self.path == "server" and blocks.numel() > self._server_blocks:
                self._server_blocks = blocks.numel()
                self.sparse_server_bundle = _keep((srcs, blocks) + rest)
        return n

    def _tree_bytes(self, leaves_by_query, program):
        if self.tree_one_leaf is None and program.nleaves == 1 and len(leaves_by_query) == 1:
            if leaves_by_query[0][0].numel() == SW // 32:
                self.tree_one_leaf = _keep((leaves_by_query, program))
        # each distinct leaf once, as the kernel reads them
        return sum({t.data_ptr(): t.numel() * 4 for leaves in leaves_by_query for t in leaves}.values())

    @staticmethod
    def _minmax_bytes(planes, filt, _flag):
        return (planes.numel() + (filt.numel() if filt is not None else 0)) * 4

    def _groupby_work(self, dims, filt, planes):
        k = 1
        for d in dims:
            k *= d.shape[0]
        if k > 1 and planes.shape[1] > 0:
            with self._mu:
                self.groupby_multi_with_planes += 1
        if k > 1 and planes.shape[1] == 0:
            with self._mu:
                if k > self._count_only_k:
                    self._count_only_k = k
                    self.groupby_count_only = _keep((dims, filt, planes))
        return k * planes.shape[0] * planes.shape[2] * (planes.shape[1] + 1)

    @staticmethod
    def _range_bytes(planes, code, out_sel):
        return planes.shape[0] * planes.shape[2] * 4 * (1 + sum(1 for c in code if c))


class Card:
    """What the bounds need from the card: SMs and the SM clock."""

    def __init__(self) -> None:
        import torch

        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        self.sm_clock_hz = float(out.stdout.strip().splitlines()[0]) * 1e6


# bytes of the sector, the unit in which the card reads device memory
SECTOR_BYTES = 32
# int32 words one step of groupby_need materialises
NEED_CHUNK_WORDS = 1 << 26


def groupby_need(dims, filt, planes) -> dict:
    """What a GroupBy launch's inputs need, counted from the inputs on
    whatever device they lie: the non-zero group words summed over the K
    groups (``group_words``), and the 32-byte sectors of the flattened word
    axis where the filter is non-zero (``sectors``; every sector without a
    filter) out of ``all_sectors``. Dimensions are [R, S, W] (or [R, Wf]),
    the filter [S, W] or None, planes [S, P, W]. Groups are enumerated a
    chunk at a time over the words where the filter is set."""
    import torch

    s, _, w = planes.shape
    wf = s * w
    flat = [d.reshape(d.shape[0], wf) for d in dims]
    per_sector = SECTOR_BYTES // 4
    all_sectors = -(-wf // per_sector)
    if filt is None:
        f = None
        sectors = all_sectors
        n = wf
    else:
        f = filt.reshape(wf)
        padded = torch.zeros(all_sectors * per_sector, dtype=f.dtype, device=f.device)
        padded[:wf] = f
        sectors = int((padded.view(all_sectors, per_sector) != 0).any(dim=1).sum())
        pos = torch.nonzero(f != 0).flatten()
        f = f[pos]
        flat = [d[:, pos] for d in flat]
        n = int(pos.numel())
    radix = [int(d.shape[0]) for d in flat]
    k = 1
    for r in radix:
        k *= r
    words = 0
    if n:
        tile = max(1, NEED_CHUNK_WORDS // n)
        for k0 in range(0, k, tile):
            ks = torch.arange(k0, min(k, k0 + tile), device=planes.device)
            g = torch.full((ks.numel(), n), -1, dtype=torch.int32, device=planes.device)
            if f is not None:
                g &= f
            rem = ks
            for d in range(len(flat) - 1, -1, -1):
                g &= flat[d][rem % radix[d]]
                rem = rem // radix[d]
            words += int((g != 0).sum())
    return {"group_words": words, "sectors": sectors, "all_sectors": all_sectors, "groups": k}


def dense_need(srcs) -> int:
    """The non-zero words of the dense scorer's sources, summed over them:
    each needs one popcount per matrix row."""
    return int((srcs != 0).sum())


def percentile_need(planes, filt, nth_bp: int) -> dict:
    """What one nearest-rank search over these inputs needs, counted from
    the inputs on whatever device they lie by running the search: at each
    plane step, the non-zero words of that step's ``consider`` (each needs
    a popcount; ``step_words``) and the 32-byte sectors holding them (a
    plane is read only there; ``step_sectors``), summed over the steps,
    out of ``all_sectors`` a step. Planes [S, D+1, W], filter [S, W] or
    None; W a multiple of 8, so no sector crosses a shard."""
    import torch

    from pilosa_tpu_torch.ops.packed import popcount

    s, d1, w = planes.shape
    per_sector = SECTOR_BYTES // 4
    consider = planes[:, d1 - 1] if filt is None else planes[:, d1 - 1] & filt
    count = int(popcount(consider).sum())
    k = nth_bp * (count // 10000) + (nth_bp * (count % 10000) + 9999) // 10000
    k = min(max(k, 1), max(count, 1))
    words = sectors = 0
    for i in range(d1 - 2, -1, -1):
        words += int(torch.count_nonzero(consider))
        sectors += int((consider.reshape(s, w // per_sector, per_sector) != 0).any(dim=2).sum())
        plane = planes[:, i]
        zeros = consider & ~plane
        c = int(popcount(zeros).sum())
        if k <= c:
            consider = zeros
        else:
            consider = consider & plane
            k -= c
    return {"step_words": words, "step_sectors": sectors, "all_sectors": s * w // per_sector}


def minmax_need(planes, filt, is_min: bool) -> dict:
    """What K8's per-shard recurrences over these inputs need, counted from
    the inputs on whatever device they lie by running them: at each plane
    step of each shard, the non-zero words of that shard's ``consider``
    (``step_words``) and the 32-byte sectors holding them (a plane is read
    only there; ``step_sectors``), summed over shards and steps, out of
    ``all_sectors`` a step. Min keeps the columns with the plane's bit
    clear when any is, Max those with it set; planes [S, D+1, W], filter
    [S, W] or None; W a multiple of 8."""
    import torch

    s, d1, w = planes.shape
    per_sector = SECTOR_BYTES // 4
    consider = planes[:, d1 - 1] if filt is None else planes[:, d1 - 1] & filt
    words = sectors = 0
    for i in range(d1 - 2, -1, -1):
        words += int(torch.count_nonzero(consider))
        sectors += int((consider.reshape(s, w // per_sector, per_sector) != 0).any(dim=2).sum())
        plane = planes[:, i]
        x = consider & ~plane if is_min else consider & plane
        keep = (x != 0).any(dim=1, keepdim=True)
        consider = torch.where(keep, x, consider)
    return {"step_words": words, "step_sectors": sectors, "all_sectors": s * w // per_sector}


def _popc_s(n: int, card: Card) -> float:
    return n / (card.sms * POPC_PER_CLOCK_PER_SM * card.sm_clock_hz)


def bound_dense_work(name: str, args, card: Card) -> float | None:
    """The earlier yardstick of K1 and K4 (ms), kept so shares taken
    against it can be read beside the bound that counts what the inputs
    need: K1 by bytes alone, K4 by K x Wf x (P + 1) popcounts with every
    row read whole."""
    if name == "dense_scores":
        srcs, mat = args
        q, w = srcs.shape
        return (mat.numel() + q * w + q * mat.shape[0]) * 4 / HBM_BYTES_PER_S * 1e3
    if name == "groupby_reduce":
        dims, filt, planes = args
        s, p, w = planes.shape
        k = 1
        for d in dims:
            k *= d.shape[0]
        rows = sum(d.shape[0] for d in dims) + (1 if filt is not None else 0) + p
        nbytes = rows * s * w * 4 + k * (p + 1) * 4
        return max(nbytes / HBM_BYTES_PER_S, _popc_s(k * s * w * (p + 1), card)) * 1e3
    return None


def _sparse_qsw(srcs) -> tuple[int, int, int]:
    """(Q, S, W) of K2's sources: i32[Q, S, W] or a list of Q i32[S, W]
    stacks."""
    if hasattr(srcs, "shape"):
        return tuple(srcs.shape)
    return (len(srcs),) + tuple(srcs[0].shape)


def bound(name: str, args, card: Card) -> dict:
    """The least time the card could take for the function on these
    inputs: the larger of its bytes (each input read once, each output
    written once) over HBM's rate and its operations over the card's rate
    for them (popcounts for the scorers and the GroupBy kernel, 32-bit
    integer ops for the range kernel and Distinct's minterm split). Where the work depends on the data,
    what these inputs need: for the dense scorer, a popcount per row and
    non-zero source word; for the GroupBy kernel, P + 1 popcounts per
    non-zero group word, the filter read whole and every other row only in
    the sectors where the filter is set; for the sparse scorer, the blocks
    in range and the source containers they name; for the tree count, each
    distinct leaf; for the range kernel, the planes its program reads; for
    Distinct, the planes at the considered words and, to 6 bits, the
    2^(D+1) - 2 operations that split each into its value minterms; for
    the percentile
    search, each step's plane in the sectors where that step's candidates
    lie (``percentile_need``); for Min/Max, each shard's step plane in
    the sectors where that shard's candidates lie (``minmax_need``).

    Popcounts are timed at the CUDA cores' rate (``popcount_ms``). The
    dense scorer runs them as single-bit matrix products on the tensor
    cores, whose single-bit rate NVIDIA does not publish for the H100, so
    for it that term is no floor and the bound is the bytes alone."""
    import torch

    ops_s = 0.0
    tensor_cores = False
    if name == "dense_scores":
        srcs, mat = args
        q, w = srcs.shape
        nbytes = (mat.numel() + q * w + q * mat.shape[0]) * 4
        ops_s = _popc_s(dense_need(srcs) * mat.shape[0], card)
        tensor_cores = True
    elif name == "sparse_stacked_scores":
        srcs, blocks, brow, bslot, bshard, num_rows = args[:6]
        q, s, w = _sparse_qsw(srcs)
        valid = (brow >= 0) & (brow < num_rows) & (bslot >= 0) & (bslot < w // 2048)
        shard = bshard if bshard is not None else torch.zeros_like(brow)
        valid &= (shard >= 0) & (shard < s)
        used = torch.unique(shard[valid].long() * (w // 2048) + bslot[valid].long()).numel()
        nb = int(valid.sum())  # a block out of range is never read
        idx = 3 if bshard is not None else 2
        nbytes = nb * 2048 * 4 + nb * idx * 4 + q * used * 2048 * 4 + q * num_rows * 4
    elif name == "tree_count":
        leaves_by_query, program = args
        # coalesced chains often share a leaf (the same staged row):
        # the function needs each distinct leaf once
        leaf_bytes = sum(
            {t.data_ptr(): t.numel() * 4 for leaves in leaves_by_query for t in leaves}.values()
        )
        nbytes = leaf_bytes + len(program.code) * 4 + len(leaves_by_query) * 4
    elif name == "groupby_reduce":
        dims, filt, planes = args
        s, p, w = planes.shape
        need = groupby_need(dims, filt, planes)
        rows = sum(d.shape[0] for d in dims) + p
        filt_bytes = s * w * 4 if filt is not None else 0
        row_bytes = min(need["sectors"] * SECTOR_BYTES, s * w * 4)
        nbytes = filt_bytes + rows * row_bytes + need["groups"] * (p + 1) * 4
        ops_s = _popc_s(need["group_words"] * (p + 1), card)
    elif name == "bsi_range":
        planes, code, out_sel = args
        s, _, w = planes.shape
        read = 1 + sum(1 for c in code if c)
        nbytes = (read + 1) * s * w * 4
        # about three 32-bit ops per opcode nibble per word
        nibbles = sum((c & 15 != 0) + (c >> 4 != 0) for c in code)
        ops_s = 3 * nibbles * s * w / (card.sms * INT32_PER_CLOCK_PER_SM * card.sm_clock_hz)
    elif name == "expand_blocks":
        positions, starts, ends, dense, dword, num_words, _offsets = args
        # every payload read once, every output word written once
        nbytes = (positions.numel() + 2 * starts.numel() + dense.numel() + dword.numel() + num_words) * 4
    elif name == "word_delta":
        nbytes = _patch_bound_bytes(*args)
    elif name == COPY_ROUTE:
        nbytes = _delta_bound_bytes(*args)
    elif name == "bsi_minmax":
        planes, filt, is_min = args
        s, d1, w = planes.shape
        need = minmax_need(planes, filt, is_min)
        # the not-null plane and the filter whole, each step's plane only in
        # the sectors where that shard's consider is set; bits and counts out
        nbytes = (1 + (filt is not None)) * s * w * 4 + need["step_sectors"] * SECTOR_BYTES + s * (d1 - 1) + s * 4
        # a test per considered word a step, and a popcount per word for the count
        ops_s = _popc_s(s * w + need["step_words"], card)
    elif name == "distinct_presence":
        planes, filt, depth = args
        s, _, w = planes.shape
        considered = planes[:, depth] if filt is None else planes[:, depth] & filt
        words = int(torch.count_nonzero(considered))
        # not-null and filter whole, the planes only at words that hold a
        # considered column, the presence words out
        nbytes = (1 + (filt is not None)) * s * w * 4 + words * depth * 4 + max(((1 << depth) + 31) // 32, 1) * 4
        # to 6 bits, the bit-sliced split of each considered word into its
        # 2^D value minterms: 2^(D+1) - 2 logical operations (the last
        # level's AND folded into the OR); deeper fields by bytes alone
        if depth <= 6:
            ops_s = words * ((2 << depth) - 2) / (card.sms * INT32_PER_CLOCK_PER_SM * card.sm_clock_hz)
    elif name == "bsi_percentile":
        planes, filt, nth = args
        s, d1, w = planes.shape
        need = percentile_need(planes, filt, nth)
        # the not-null plane and the filter whole, each step's plane only in
        # the sectors where that step's consider is set; the bits and the
        # count out
        nbytes = (1 + (filt is not None)) * s * w * 4 + need["step_sectors"] * SECTOR_BYTES + (d1 - 1) + 4
        # one popcount per word for the count, then one per considered word a step
        ops_s = _popc_s(s * w + need["step_words"], card)
    else:
        raise KeyError(name)
    bytes_s = nbytes / HBM_BYTES_PER_S
    floor_ops_s = 0.0 if tensor_cores else ops_s
    return {
        "bound_ms": max(bytes_s, floor_ops_s) * 1e3,
        "bound_by": "operations" if floor_ops_s > bytes_s else "bytes",
        "bytes": nbytes,
        "popcount_ms": ops_s * 1e3,
    }


def _update_bytes(shard_idx, word_idx, or_mask, andnot_mask) -> int:
    """One word-delta update's coordinates and masks."""
    return 4 * (3 + (shard_idx is not None)) * word_idx.numel()


def _delta_bound_bytes(words, shard_idx, word_idx, or_mask, andnot_mask) -> int:
    """The word-delta copy route returns a new tensor: the block read once
    and written once, plus the updates."""
    return 2 * words.numel() * 4 + _update_bytes(shard_idx, word_idx, or_mask, andnot_mask)


def _patch_bound_bytes(words, shard_idx, word_idx, or_mask, andnot_mask) -> int:
    """The word-delta patch in place: the updates, plus each 32-byte
    sector that holds a touched word read once and written once (touched
    words that share a sector share its bytes)."""
    import torch

    s, m = words.shape
    w = word_idx.long()
    sh = shard_idx.long() if shard_idx is not None else torch.zeros_like(w)
    valid = (w >= 0) & (w < m) & (sh >= 0) & (sh < s)
    sectors = torch.unique((sh * m + w)[valid] // (SECTOR_BYTES // 4)).numel()
    return _update_bytes(shard_idx, word_idx, or_mask, andnot_mask) + 2 * SECTOR_BYTES * sectors


# the record key of the word-delta kernel's copy route (a reader held the
# snapshot): the whole block copied, then patched
COPY_ROUTE = "word_delta_copied"

# a device spin before each timed launch, longer than any wrapper's host
# work, so the launch is queued before the start event fires
HIDE_ENQUEUE_CYCLES = 2_000_000


def time_ms(fn, iters: int, flush, as_before: bool = False) -> float:
    """Median device time of ``fn`` over ``iters`` launches (CUDA events).
    Before each, the L2 cache is flushed by reading a buffer larger than
    L2 (the lines left behind are clean) and the device spins while the
    host enqueues ``fn``, so the window holds device work only.
    ``as_before`` times the earlier way: flushed by a write (the kernel
    also pays for writing back the dirty lines its reads evict) and the
    host's enqueue inside the window."""
    import torch

    times = []
    for _ in range(iters):
        if as_before:
            flush.zero_()
        else:
            flush.sum()
            torch.cuda._sleep(HIDE_ENQUEUE_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# the dense, non-exclusive GroupBy shape: no filter, two set fields of 8
# rows whose columns each sit in about 3 of the 8 (bits at density 3/8),
# and 25 planes, over the ssb panel's 58 shards
NONEXCL_DIMS = 2
NONEXCL_ROWS = 8
NONEXCL_PLANES = 25
NONEXCL_SEED = 1905


def nonexclusive_groupby_inputs(device, seed: int = NONEXCL_SEED):
    """(dims, None, planes) of the dense, non-exclusive GroupBy shape,
    drawn on ``device`` from ``seed``: the enumerating kernel's worst case,
    every group set at nearly every word."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    s, w = -(-SSB_ROWS // SW), SW // 32

    def words(*shape):
        return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, generator=g, device=device)

    dims = []
    for _ in range(NONEXCL_DIMS):
        shape = (NONEXCL_ROWS, s, w)
        dims.append(words(*shape) & (words(*shape) | words(*shape)))
    return dims, None, words(s, NONEXCL_PLANES, w)


# the percentile search's global route: ssb's depth and shard width, a
# filter, and shards just past what the on-chip route holds
PCT_GLOBAL_DEPTH = 24
PCT_GLOBAL_NTH = 9500
PCT_GLOBAL_SEED = 1906


def percentile_global_inputs(device, seed: int = PCT_GLOBAL_SEED):
    """(planes, filter, nth_bp) of a seeded stack two shards past K10's
    on-chip capacity on ``device``: random planes, the not-null plane and
    the filter each set at about 3 of 4 columns."""
    import torch

    from pilosa_tpu_torch.ops import cuda

    w = SW // 32
    s = cuda.percentile_grid(device)[1] // w + 2
    g = torch.Generator(device=device).manual_seed(seed)

    def words(*shape):
        return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, generator=g, device=device)

    planes = words(s, PCT_GLOBAL_DEPTH + 1, w)
    planes[:, PCT_GLOBAL_DEPTH] |= words(s, w)
    return planes, words(s, w) | words(s, w), PCT_GLOBAL_NTH


def _held(name: str, kernel_fn, plain_fn, args, flush, card: Card) -> dict:
    """One more launch of ``name`` held against its plain version (==)
    and timed, with its bound, its share of it and the earlier yardstick."""
    import torch

    args = _on_card(args)
    got = _as_tuple(kernel_fn(*args))
    want = _as_tuple(plain_fn(*args))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{name} differs from its plain version at {_shape(name, args)}")
    ms = time_ms(lambda: kernel_fn(*args), 20, flush)
    b = bound(name, args, card)
    return {
        "shape": _shape(name, args),
        "max_abs_err": 0,
        "ms": ms,
        "plain_ms": time_ms(lambda: plain_fn(*args), 3, flush),
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "share_of_bound": b["bound_ms"] / ms,
        "popcount_ms": b["popcount_ms"],
        "bound_dense_work_ms": bound_dense_work(name, args, card),
    }


def check_kernels(rec: Recorder, launches: dict, batched: dict, device, card: Card,
                  sparse_q_launches: dict) -> list[dict]:
    """Each kernel at its largest main-path arguments against its plain
    version on the card (== on every output), then both timed.
    ``launches`` and ``batched`` hold each kernel's counts on its path,
    ``sparse_q_launches`` K2's launches at each Q over every path."""
    import torch

    from pilosa_tpu_torch.ops import bsi, cuda, delta, packed

    kernels = {k.name: k for k in cuda.KERNELS}
    plain = {
        "dense_scores": packed.intersection_counts_matrix_plain,
        # the kept grouping is the kernel's argument alone
        "sparse_stacked_scores": lambda *a: packed.sparse_stacked_scores_plain(*a[:6]),
        "tree_count": packed.tree_count_plain,
        "groupby_reduce": packed.groupby_reduce_plain,
        "bsi_range": bsi.bsi_range_plain,
        # the unbinned function: a binning fault shows as a difference
        "expand_blocks": lambda *a: packed.expand_blocks_plain(*a[:6]),
        # in place, as the kernel's route on the path
        "word_delta": delta.patch_words_2d_plain_,
        "bsi_minmax": bsi.bsi_minmax_plain,
        "distinct_presence": bsi.bsi_distinct_presence_plain,
        "bsi_percentile": bsi.bsi_percentile_plain,
    }
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=device)  # 256 MiB > L2
    rows = []
    for name, plain_fn in plain.items():
        kernel_fn = rec.kernel_fn[name]
        args = _on_card(rec.args[name])
        # the in-place patch: the plain version first, on a copy of the words
        want = _as_tuple(plain_fn(*((args[0].clone(),) + args[1:] if name == "word_delta" else args)))
        got = _as_tuple(kernel_fn(*args))
        torch.cuda.synchronize()
        err = 0
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs plain {w.shape}/{w.dtype}")
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version by {err}")
        ms = time_ms(lambda: kernel_fn(*args), 20, flush)
        plain_ms = time_ms(lambda: plain_fn(*args), 3, flush)
        b = bound(name, args, card)
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
                "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"],
                "library_ms": None,
                "bytes": b["bytes"],
                "popcount_ms": b["popcount_ms"],
                "shape": _shape(name, args),
            }
        )
        rows[-1]["timed_launch_path"] = rec.where[name]
        if name == "expand_blocks":
            # also == and timed at the largest tiered launch with each
            # input kind, and on the widest input unbinned and shuffled
            rows[-1]["share_of_bound"] = b["bound_ms"] / ms
            rows[-1]["by_input_kind"] = {
                kind: _held(name, kernel_fn, plain_fn, kargs, flush, card)
                for kind, kargs in rec.expand_kind_args.items()
            }
            rows[-1]["unbinned_shuffled"] = _expand_unbinned(args, plain_fn, flush)
        if name == "word_delta":
            rows[-1]["share_of_bound"] = b["bound_ms"] / ms
            rows[-1]["copy_route"] = _delta_copy_route(rec, flush, card)
        if name in ("dense_scores", "groupby_reduce"):
            rows[-1]["share_of_bound"] = b["bound_ms"] / ms
            rows[-1]["bound_dense_work_ms"] = bound_dense_work(name, args, card)
        if name == "dense_scores":
            if rec.dense_widest_q is None:
                raise AssertionError("no dense_scores launch on the dense_tall path")
            rows[-1]["widest_q_dense_tall"] = _held(name, kernel_fn, plain_fn, rec.dense_widest_q, flush, card)
        if name == "groupby_reduce":
            if rec.groupby_count_only is None:
                raise AssertionError("no count-only GroupBy launch (K > 1, P = 0) on the ssb path")
            rows[-1]["count_only_panel"] = _held(name, kernel_fn, plain_fn, rec.groupby_count_only, flush, card)
            nonexcl = nonexclusive_groupby_inputs(device)
            rows[-1]["dense_nonexclusive"] = _held(name, kernel_fn, plain_fn, nonexcl, flush, card)
            del nonexcl
        if name in rec.fusion_shapes:
            rows[-1]["fusion_shapes"] = _fusion_shapes(rec, name, kernel_fn, plain_fn, flush, card)
        if name == "bsi_percentile":
            rows[-1]["share_of_bound"] = b["bound_ms"] / ms
            if not rows[-1]["shape"]["on_chip"]:
                raise AssertionError(f"bsi_percentile's largest ssb launch took the global route: {rows[-1]['shape']}")
            rows[-1]["global_route"] = _held(name, kernel_fn, plain_fn, percentile_global_inputs(device), flush, card)
            if rows[-1]["global_route"]["shape"]["on_chip"]:
                raise AssertionError("bsi_percentile's global-route inputs fit on chip")
        if name == "sparse_stacked_scores":
            rows[-1]["share_of_bound"] = b["bound_ms"] / ms
            rows[-1]["by_q"] = _sparse_by_q(rec, kernel_fn, plain_fn, sparse_q_launches, flush, card)
            rows[-1]["q32_largest_bundle"] = _sparse_q32(rec, kernel_fn, plain_fn, flush, card)
        if name == "tree_count":
            rows[-1]["share_of_bound"] = b["bound_ms"] / ms
            rows[-1]["ms_as_before"] = time_ms(lambda: kernel_fn(*args), 20, flush, as_before=True)
            rows[-1]["one_leaf_32768"] = _tree_one_leaf(rec, kernel_fn, plain_fn, flush, card)
        log(f"{name}: == plain; {ms:.3f} ms (bound {b['bound_ms']:.3f} by {b['bound_by']}, plain {plain_ms:.3f})")
    return rows


def _sparse_by_q(rec, kernel_fn, plain_fn, q_launches: dict, flush, card: Card) -> dict:
    """K2 at its largest launch at each batch width Q it launched with on
    any path: == plain, timed, its bound, and its launches at that Q over
    every path."""
    out = {}
    for q in sorted(rec.sparse_by_q):
        row = _held("sparse_stacked_scores", kernel_fn, plain_fn, rec.sparse_by_q[q], flush, card)
        row["launches"] = q_launches.get(q, 0)
        out[str(q)] = row
    if not set(q_launches) <= set(rec.sparse_by_q):
        raise AssertionError(f"K2 kept widths {sorted(rec.sparse_by_q)}, launched at {sorted(q_launches)}")
    return out


# the batcher's widest batch (executor.MAX_BATCH): the north star's c32 depth
SPARSE_Q_WIDEST = 32


def _sparse_q32(rec, kernel_fn, plain_fn, flush, card: Card) -> dict:
    """One K2 launch at Q = 32 on the server's largest staged bundle, with
    its grouping: that launch's sources and more made from them by
    rotating each word axis, == plain and timed."""
    import torch

    if rec.sparse_server_bundle is None:
        raise AssertionError("no sparse_stacked_scores launch on the server path")
    srcs, *rest = _on_card(rec.sparse_server_bundle)
    stacks = list(srcs.unbind(0)) if hasattr(srcs, "shape") else list(srcs)
    wide = [torch.roll(stacks[j % len(stacks)], shifts=4 * 97 * j, dims=1).contiguous()
            for j in range(SPARSE_Q_WIDEST)]
    return _held("sparse_stacked_scores", kernel_fn, plain_fn, (wide, *rest), flush, card)


def _fusion_shapes(rec: Recorder, name: str, kernel_fn, plain_fn, flush, card: Card) -> dict:
    """A kernel at each shape it launched with on the fusion path (the
    arguments of the shape's first launch): == its plain version once,
    timed, with its bound and its launches there; and over them, the
    launches x (ms - bound) that ranks the kernel (``gap_ms``)."""
    import torch

    rows, gap, untimed = [], 0.0, 0
    for key, (n, kept) in sorted(rec.fusion_shapes[name].items(), key=lambda kv: -kv[1][0]):
        if kept is None:
            untimed += n
            continue
        args = _on_card(kept)
        got = _as_tuple(kernel_fn(*args))
        want = _as_tuple(plain_fn(*args))
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version at fusion shape {key}")
        ms = time_ms(lambda: kernel_fn(*args), 20, flush)
        b = bound(name, args, card)
        rows.append({"shape": json.loads(key), "launches": n, "ms": ms,
                     "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]})
        gap += n * (ms - b["bound_ms"])
        del args, got, want
    return {"shapes": rows, "launches": sum(r["launches"] for r in rows) + untimed,
            "untimed_launches": untimed, "gap_ms": gap}


def _expand_unbinned(args, plain_fn, flush) -> dict:
    """K6 through ``ops.expand_blocks`` without offsets, on ``args``'
    payloads in a seeded shuffled order: binned on the device, then one
    launch; == the plain version, and timed with the binning."""
    import torch

    from pilosa_tpu_torch import ops

    positions, starts, ends, dense, dword, num_words, _ = args
    g = torch.Generator(device=dense.device).manual_seed(7)
    p = torch.randperm(positions.numel(), generator=g, device=dense.device)
    r = torch.randperm(starts.numel(), generator=g, device=dense.device)
    d = torch.randperm(dword.numel(), generator=g, device=dense.device)
    shuffled = (positions[p], starts[r], ends[r], dense[d].contiguous(), dword[d], num_words)
    if not torch.equal(ops.expand_blocks(*shuffled), plain_fn(*shuffled)):
        raise AssertionError("expand_blocks differs from its plain version on shuffled, unbinned input")
    return {"ms": time_ms(lambda: ops.expand_blocks(*shuffled), 20, flush), "binned_on_device": True}


def _delta_copy_route(rec, flush, card) -> dict | None:
    """The word-delta kernel's copy route (a reader held the snapshot) at
    its largest launch: == the plain new-tensor version, its time and
    bound (the block copied), and the patch alone into a copy made
    beforehand. None if no refresh took that route."""
    import torch

    from pilosa_tpu_torch.ops import cuda, delta

    if COPY_ROUTE not in rec.args:
        return None
    args = _on_card(rec.args[COPY_ROUTE])
    kernel_fn, plain_fn = rec.kernel_fn[COPY_ROUTE], delta.apply_word_updates_2d_plain
    if not torch.equal(kernel_fn(*args), plain_fn(*args)):
        raise AssertionError(f"word_delta (copy route) differs from its plain version at {_shape('word_delta', args)}")
    words, sh, wi, om, am = args
    out = words.clone()
    b = bound(COPY_ROUTE, args, card)
    return {
        "shape": _shape("word_delta", args),
        "timed_launch_path": rec.where[COPY_ROUTE],
        "ms": time_ms(lambda: kernel_fn(*args), 20, flush),
        "plain_ms": time_ms(lambda: plain_fn(*args), 3, flush),
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "patch_ms": time_ms(lambda: cuda.word_delta_patch(words, out, sh, wi, om, am), 20, flush),
    }


def _kernels_per_call(fn, calls: int):
    """Device kernels (memsets included) per call of ``fn`` from a
    torch.profiler trace, or None if the trace holds none or fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(1 for ev in prof.events() if "CUDA" in str(getattr(ev, "device_type", "")))
    except Exception as e:  # the trace is a report, not a check of the port
        log(f"profiler trace failed: {e!r}")
        return None
    return n / calls if n else None


def _tree_one_leaf(rec, kernel_fn, plain_fn, flush, card) -> dict:
    """The tree count at a one-leaf count of one shard row, its most
    launched shape: == plain, time, bound, share, and device kernels per
    count (one launch, no memset) from a profiler trace."""
    import torch

    if rec.tree_one_leaf is None:
        raise AssertionError("no one-leaf 32768-word tree count on the main paths")
    args = _on_card(rec.tree_one_leaf)
    got, want = kernel_fn(*args), plain_fn(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"tree_count one-leaf: {got.tolist()} vs plain {want.tolist()}")
    ms = time_ms(lambda: kernel_fn(*args), 20, flush)
    b = bound("tree_count", args, card)
    per_count = _kernels_per_call(lambda: kernel_fn(*args), 10)
    if per_count is not None and per_count != 1:
        raise AssertionError(f"a one-leaf count ran {per_count} device kernels, not 1")
    return {
        "ms": ms,
        "plain_ms": time_ms(lambda: plain_fn(*args), 3, flush),
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "share_of_bound": b["bound_ms"] / ms,
        "device_kernels_per_count": per_count,
    }


def _shape(name: str, args) -> dict:
    if name == "dense_scores":
        return {"Q": args[0].shape[0], "R": args[1].shape[0], "W": args[1].shape[1]}
    if name == "sparse_stacked_scores":
        q, s, w = _sparse_qsw(args[0])
        return {"Q": q, "S": s, "W": w, "B": args[1].shape[0], "num_rows": args[5]}
    if name == "groupby_reduce":
        dims, filt, planes = args
        s, p, w = planes.shape
        return {"dims": [d.shape[0] for d in dims], "filter": filt is not None, "S": s, "P": p, "W": w}
    if name == "bsi_range":
        planes, code, out_sel = args
        return {"S": planes.shape[0], "W": planes.shape[2], "depth": len(code),
                "planes_read": 1 + sum(1 for c in code if c),
                "opcodes": sum((c & 15 != 0) + (c >> 4 != 0) for c in code)}
    if name == "expand_blocks":
        positions, starts, ends, dense, dword, num_words, _offsets = args
        return {"positions": positions.numel(), "runs": starts.numel(), "dense": dense.shape[0], "num_words": num_words}
    if name == "word_delta":
        words, sh, wi, om, am = args
        return {"words": list(words.shape), "updates": wi.numel(), "shard_idx": sh is not None}
    if name == "bsi_minmax":
        planes, filt, is_min = args
        s, d1, w = planes.shape
        return {"S": s, "depth": d1 - 1, "W": w, "filter": filt is not None, "min": bool(is_min)}
    if name == "distinct_presence":
        planes, filt, depth = args
        s, _, w = planes.shape
        return {"S": s, "depth": depth, "W": w, "filter": filt is not None}
    if name == "bsi_percentile":
        from pilosa_tpu_torch.ops import cuda

        planes, filt, nth = args
        s, d1, w = planes.shape
        return {"S": s, "depth": d1 - 1, "W": w, "filter": filt is not None, "nth_bp": nth,
                "on_chip": cuda.percentile_on_chip(planes)}
    from pilosa_tpu_torch.ops import packed

    leaves_by_query, program = args
    return {
        "Q": len(leaves_by_query),
        "nleaves": program.nleaves,
        "distinct_leaves": len(packed.tree_tables(leaves_by_query)[0]),
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


# the stats family's parts, by the call that starts the query
STATS_PARTS = {"minmax": ("Min(", "Max("), "percentile": ("Percentile(",), "distinct": ("Distinct(",)}


def _stats_part(q: str) -> str:
    return next(part for part, heads in STATS_PARTS.items() if q.startswith(heads))


# the kernels whose launches the stats family's parts count
STATS_KERNELS = ("tree_count", "bsi_minmax", "bsi_percentile")


def _execute_ssb(dev, q: str, oracle: SsbOracle, legs: dict) -> tuple[float, dict]:
    """One ssb query: its latency and the launches of STATS_KERNELS it
    made. A Percentile query must launch bsi_percentile once and the tree
    count never (the whole search is one launch)."""
    from pilosa_tpu_torch.ops import cuda

    kernels = {k.name: k for k in cuda.KERNELS}
    before = {name: kernels[name].launches for name in STATS_KERNELS}
    dt = _execute(dev, "ssb", q, oracle.answers, legs)
    launched = {name: kernels[name].launches - before[name] for name in STATS_KERNELS}
    if q.startswith(STATS_PARTS["percentile"]) and (launched["bsi_percentile"], launched["tree_count"]) != (1, 0):
        raise AssertionError(f"{q} launched {launched}: not one bsi_percentile and no tree_count")
    return dt, launched


def run_ssb(dev, oracle: SsbOracle) -> dict:
    """Every ssb query once cold (staging included), then each family
    warm, every answer held against the numpy oracle. The stats family's
    warm pass is also split by part (Min/Max, Percentile, Distinct), each
    with its p50 and its tree-count, bsi_minmax and bsi_percentile
    launches."""
    qs = [q for _, q in oracle.queries]
    cold = [_execute_ssb(dev, q, oracle, {})[0] for q in qs]
    out = {"first_pass_s": sum(cold), "queries": len(qs)}
    for family in SSB_FAMILIES:
        fq = [q for f, q in oracle.queries if f == family]
        if family != STATS:
            out[family] = _rate(*run_sequential(dev, "ssb", fq, oracle.answers))
            continue
        parts = {part: ([], {}, dict.fromkeys(STATS_KERNELS, 0)) for part in STATS_PARTS}
        for q in fq:
            lat, legs, launched = parts[_stats_part(q)]
            dt, made = _execute_ssb(dev, q, oracle, legs)
            lat.append(dt)
            for name, n in made.items():
                launched[name] += n
        merged: dict = {}
        for _, legs, _ in parts.values():
            for k, v in legs.items():
                merged[k] = merged.get(k, 0.0) + v
        out[family] = _rate([x for lat, _, _ in parts.values() for x in lat], merged)
        out[family + "_parts"] = {
            part: {**_rate(lat, legs), "launches": launched} for part, (lat, legs, launched) in parts.items()
        }
    # cold and warm
    out["minmax_queries_run"] = 2 * sum(1 for q in qs if q.startswith(STATS_PARTS["minmax"]))
    out["percentile_queries_run"] = 2 * sum(1 for q in qs if q.startswith(STATS_PARTS["percentile"]))
    return out


# -- fusion: multi-call requests, the fuser off and on ----------------------------

# warm repeats of each multi-call request in each arm
FUSION_REPEATS = 10


def fusion_requests(ssb, tall_topn, tall_chains) -> dict:
    """name -> (index, calls) of each multi-call request: bench_tall.py's
    three-chain request (its ``"".join(chains[:3])``), three chain Counts
    and a TopN, each ssb family as one request, and all 31 ssb queries as
    one (under the default fusion-max-calls of 64)."""
    reqs = {
        "tall_3_chains": ("tall", tall_chains[:3]),
        "tall_3_counts_1_topn": ("tall", tall_chains[3:6] + tall_topn[:1]),
    }
    for family in SSB_FAMILIES:
        reqs["ssb_" + family] = ("ssb", [q for f, q in ssb.queries if f == family])
    reqs["ssb_all_31"] = ("ssb", [q for _, q in ssb.queries])
    return reqs


class FusedLaunchWatch:
    """Wraps the fuser's enqueue and fetch: with ``strict`` the enqueue
    runs under ``torch.cuda.set_sync_debug_mode("error")`` (a host wait
    inside it raises), every fetch is counted, and the largest TopN head
    (``sparse_intersection_counts_stacked_mat``) a fused launch scored is
    kept with its launch count."""

    def __init__(self) -> None:
        import torch

        from pilosa_tpu_torch import ops
        from pilosa_tpu_torch.executor.fusion import QueryFuser

        self.strict = False
        self.fetches = 0
        self.enqueues = 0
        self.mat_calls = 0
        self.mat_args = None
        self._mat_size = -1
        enqueue, fetch, mat = QueryFuser._enqueue, QueryFuser._fetch, ops.sparse_intersection_counts_stacked_mat
        watch = self

        def strict_enqueue(fuser, program, units):
            watch.enqueues += 1
            if not watch.strict:
                return enqueue(fuser, program, units)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return enqueue(fuser, program, units)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        def counted_fetch(buf):
            watch.fetches += 1
            return fetch(buf)

        def kept_mat(srcs, blocks, brow, bslot, bshard, num_rows, n_shards, chunk, groups=None):
            watch.mat_calls += 1
            if blocks.numel() > watch._mat_size:
                watch._mat_size = blocks.numel()
                watch.mat_args = _keep((srcs, blocks, brow, bslot, bshard, num_rows, n_shards, chunk, groups))
            return mat(srcs, blocks, brow, bslot, bshard, num_rows, n_shards, chunk, groups=groups)

        self.offload = lambda: setattr(self, "mat_args", _offload(self.mat_args))
        QueryFuser._enqueue = strict_enqueue
        QueryFuser._fetch = staticmethod(counted_fetch)
        ops.sparse_intersection_counts_stacked_mat = kept_mat


def _request_trace(fn) -> dict:
    """One call of ``fn`` under torch.profiler; a failed trace fails the
    phase. Its device-to-host copies (``Memcpy DtoH`` events), and on the
    device: the kernels and their time (``kernel_ms``, memcpys and memsets
    apart), by kernel name; the span from the first device event's start
    to the last one's end; and the gaps in that span where no device event
    ran (``device_gap_ms``: the host enqueuing, between launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    on_device = sorted(
        (ev for ev in events if "CUDA" in str(getattr(ev, "device_type", ""))),
        key=lambda ev: ev.time_range.start,
    )
    kernels = [ev for ev in on_device if not ev.name.startswith(("Memcpy", "Memset"))]
    by_name: dict = {}
    for ev in kernels:
        name = ev.name.split("(")[0].removeprefix("void ")
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + ev.time_range.elapsed_us())
    busy_us = 0.0
    end = None
    for ev in on_device:
        start = ev.time_range.start if end is None else max(ev.time_range.start, end)
        if ev.time_range.end > start:
            busy_us += ev.time_range.end - start
        end = ev.time_range.end if end is None else max(end, ev.time_range.end)
    span_us = end - on_device[0].time_range.start if on_device else 0.0
    return {
        "dtoh_copies": sum(1 for ev in events if "Memcpy DtoH" in ev.name),
        "device_kernels": len(kernels),
        "kernel_ms": sum(us for _, us in by_name.values()) / 1e3,
        "device_span_ms": span_us / 1e3,
        "device_gap_ms": (span_us - busy_us) / 1e3,
        "kernel_ms_by_name": {k: {"launches": n, "ms": us / 1e3} for k, (n, us) in sorted(by_name.items())},
    }


def fusion_arm(dev, index: str, calls: list[str], answers: dict, fused: bool, watch) -> dict:
    """One multi-call request FUSION_REPEATS times, warm, with the fuser
    on or off (``dev.fuser`` set aside), every answer held to its oracle:
    p50, fused launches, kernel launches and fetches per request, bypasses
    by reason, and a profiler trace of one more request (its device-to-host
    copies, kernel time and the gaps between kernels: ``_request_trace``)."""
    from pilosa_tpu_torch.ops import cuda

    pql = "".join(calls)
    oracle = {pql: [a for q in calls for a in answers[q]]}
    fuser = dev.fuser
    if not fused:
        dev.fuser = None
    try:
        legs: dict = {}
        _execute(dev, index, pql, oracle, legs)  # warm: staging, programs
        st0 = fuser.stats()
        k0 = sum(k.launches for k in cuda.KERNELS)
        f0 = watch.fetches
        lat = [_execute(dev, index, pql, oracle, legs) for _ in range(FUSION_REPEATS)]
        st1 = fuser.stats()
        launches = st1["fused_launches"] - st0["fused_launches"]
        fetches = watch.fetches - f0
        out = {
            "calls": len(calls),
            "requests": FUSION_REPEATS,
            "p50_ms": statistics.median(lat) * 1e3,
            "qps": FUSION_REPEATS / sum(lat),
            "fused_launches_per_request": launches / FUSION_REPEATS,
            "fused_calls_per_launch": (st1["fused_calls"] - st0["fused_calls"]) / launches if launches else None,
            "kernel_launches_per_request": (sum(k.launches for k in cuda.KERNELS) - k0) / FUSION_REPEATS,
            "fetches_per_fused_launch": fetches / launches if launches else None,
            "bypasses": {r: n - st0["bypasses"].get(r, 0) for r, n in st1["bypasses"].items()
                         if n != st0["bypasses"].get(r, 0)},
            "legs_ms": {k: v / len(lat) * 1e3 for k, v in sorted(legs.items())},
        }
        trace = _request_trace(lambda: _execute(dev, index, pql, oracle, {}))
        out["dtoh_copies_per_request"] = trace.pop("dtoh_copies")
        out["trace"] = trace
        if fused and fetches != launches:
            raise AssertionError(f"fusion: {index}: {fetches} fetches for {launches} fused launches")
        # each fused launch's one fetch is a device-to-host copy: a trace
        # that sees fewer saw nothing of the card
        if out["dtoh_copies_per_request"] < (launches / FUSION_REPEATS if fused else 1):
            raise AssertionError(f"fusion: {index}: the trace saw {out['dtoh_copies_per_request']} DtoH copies")
        if fused and launches != FUSION_REPEATS:
            raise AssertionError(f"fusion: {index}: {launches} fused launches for {FUSION_REPEATS} requests")
        return out
    finally:
        dev.fuser = fuser


def run_fusion(dev, ssb, tall_topn, tall_chains, tall_answers, watch) -> dict:
    """Each multi-call request unfused, then fused, in turns on the same
    executor and staged data; the fused enqueues strict about host waits."""
    answers = {**tall_answers, **ssb.answers}
    out: dict = {}
    watch.strict = True
    try:
        for name, (index, calls) in fusion_requests(ssb, tall_topn, tall_chains).items():
            unfused = fusion_arm(dev, index, calls, answers, False, watch)
            fused = fusion_arm(dev, index, calls, answers, True, watch)
            out[name] = {"unfused": unfused, "fused": fused}
            log(f"fusion: {name} ({len(calls)} calls): p50 {unfused['p50_ms']:.3f} -> {fused['p50_ms']:.3f} ms, "
                f"kernel launches {unfused['kernel_launches_per_request']:.1f} -> "
                f"{fused['kernel_launches_per_request']:.1f}, DtoH {unfused['dtoh_copies_per_request']} -> "
                f"{fused['dtoh_copies_per_request']}, bypasses {fused['bypasses']}; fused trace: kernels "
                f"{fused['trace']['kernel_ms']:.4f} ms, gaps {fused['trace']['device_gap_ms']:.4f} of a "
                f"{fused['trace']['device_span_ms']:.4f} ms device span")
    finally:
        watch.strict = False
    st = dev.fuser.stats()
    if st["bypasses"].get("error", 0):
        raise AssertionError(f"fusion: bypasses {st['bypasses']}")
    out["fuser"] = st
    out["strict_enqueues"] = watch.enqueues
    return out


def stacked_mat_row(watch, flush, card: Card) -> dict:
    """``sparse_intersection_counts_stacked_mat`` (K2, then the head as a
    view) at the largest TopN head a fused launch scored: == its plain
    version, timed, with K2's bound of those inputs."""
    import torch

    from pilosa_tpu_torch import ops
    from pilosa_tpu_torch.ops import packed

    if watch.mat_args is None:
        raise AssertionError("no fused TopN head scored")
    *mat_args, groups = _on_card(watch.mat_args)
    srcs, blocks, brow, bslot, bshard, num_rows, n_shards, chunk = mat_args

    def plain():
        flat = packed.sparse_stacked_scores_plain(srcs.unsqueeze(0), blocks, brow, bslot, bshard, num_rows)[0]
        return flat[: n_shards * chunk].reshape(n_shards, chunk)

    got = ops.sparse_intersection_counts_stacked_mat(*mat_args, groups=groups)
    if not torch.equal(got, plain()):
        raise AssertionError("sparse_intersection_counts_stacked_mat differs from its plain version")
    b = bound("sparse_stacked_scores", (srcs.unsqueeze(0), blocks, brow, bslot, bshard, num_rows), card)
    return {
        "name": "sparse_intersection_counts_stacked_mat",
        "route": "cuda",
        "source": "pilosa_tpu_torch/ops/kernels/sparse_scores.cu",
        "replaces": "pilosa_tpu/ops/packed.py:155",
        "launches": watch.mat_calls,
        "max_abs_err": 0,
        "ms": time_ms(lambda: ops.sparse_intersection_counts_stacked_mat(*mat_args, groups=groups), 20, flush),
        "plain_ms": time_ms(plain, 3, flush),
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": None,
        "shape": {"S": n_shards, "chunk": chunk, "B": blocks.shape[0], "num_rows": num_rows},
    }


# -- the server: the same data and queries over HTTP -------------------------------

# kernels the server phase must launch (K6 may launch too, under tier
# 1's compressed uploads; nothing requires it)
SERVER_KERNELS = (
    "dense_scores",
    "sparse_stacked_scores",
    "tree_count",
    "groupby_reduce",
    "bsi_range",
    "word_delta",
    "bsi_minmax",
    "distinct_presence",
    "bsi_percentile",
)
# the OOM check's post-degrade CPU cooldown, cut from the default 30 s
# (PILOSA_OOM_CPU_COOLDOWN_S) so the phase sees the device path return
OOM_COOLDOWN_S = 10.0
# the server phase's families and, for each, the in-process phase and
# key that measured the same queries earlier in this run
SERVER_IN_PROCESS = {
    "dense_topn": ("dense_sequential",),
    "tall_topn": ("tall_topn",),
    "tall_chain": ("tall_chain",),
    **{"ssb_" + family: ("ssb", family) for family in SSB_FAMILIES},
}


def wire(results) -> list:
    """Executor results in the HTTP API's JSON shapes."""
    from pilosa_tpu_torch.server import encode_result

    return json.loads(json.dumps([encode_result(r) for r in results]))


class HttpClient:
    """One keep-alive HTTP/1.1 connection to the server."""

    def __init__(self, host: str, port: int, timeout: float = 600.0) -> None:
        import http.client

        self.conn = http.client.HTTPConnection(host, port, timeout=timeout)

    def request(self, method: str, path: str, body=None, headers=None):
        self.conn.request(method, path, body=body, headers=headers or {})
        resp = self.conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()

    def query(self, index: str, q: str, want, cold: bool = False, cache: bool = False) -> float:
        """POST one query; returns its latency (s). Raises on any status
        but 200 and on an answer other than ``want``. A ``cold`` query
        (its data not staged yet) asks for a 600 s deadline instead of
        the server's default (analytics-timeout is 10 s). Unless
        ``cache``, the query asks the server not to answer from its plan
        cache (``cache=false``), so every answer is an execution."""
        params = (["timeout=600"] if cold else []) + ([] if cache else ["cache=false"])
        path = f"/index/{index}/query" + ("?" + "&".join(params) if params else "")
        t0 = time.perf_counter()
        st, _, body = self.request("POST", path, q.encode())
        dt = time.perf_counter() - t0
        if st != 200:
            raise AssertionError(f"server: {index}: {q}: HTTP {st}: {body[:300]!r}")
        got = json.loads(body)["results"]
        if got != want:
            raise AssertionError(f"server: {index}: {q} answered {str(got)[:300]}, oracle {str(want)[:300]}")
        return dt

    def close(self) -> None:
        self.conn.close()


def recalculate_caches(addr) -> None:
    c = HttpClient(*addr)
    try:
        st, _, body = c.request("POST", "/recalculate-caches")
        if st != 200:
            raise AssertionError(f"server: /recalculate-caches: HTTP {st}: {body[:300]!r}")
    finally:
        c.close()


def http_sequential(addr, items, answers, cold: bool = False, cache: bool = False) -> list[float]:
    c = HttpClient(*addr)
    try:
        return [c.query(index, q, answers[(index, q)], cold, cache) for index, q in items]
    finally:
        c.close()


def rotating_streams(items, clients: int) -> list[list]:
    """``clients`` streams, each every item once from its own offset:
    clients often send the same query at once, and the pipeline's
    singleflight shares one answer between them."""
    return [[items[(ci + j) % len(items)] for j in range(len(items))] for ci in range(clients)]


def distinct_streams(items, clients: int) -> list[list]:
    """min(clients, len(items)) streams of len(items) queries each, item
    i only in stream i mod n: no two clients ever send the same query,
    so every answer is an execution of its own."""
    n = min(clients, len(items))
    return [[items[ci::n][j % len(items[ci::n])] for j in range(len(items))] for ci in range(n)]


def http_concurrent(addr, streams, answers) -> tuple[list[float], float]:
    """One thread per stream, each on its own connection, sending its
    stream in order. Returns (latencies, wall seconds)."""
    clients = len(streams)
    lat: list[list[float]] = [[] for _ in range(clients)]
    errors: list[BaseException] = []
    start = threading.Barrier(clients)

    def client(ci: int) -> None:
        c = HttpClient(*addr)
        try:
            start.wait()
            for index, q in streams[ci]:
                lat[ci].append(c.query(index, q, answers[(index, q)]))
        except BaseException as e:  # re-raised below, after every thread joined
            errors.append(e)
            start.abort()
        finally:
            c.close()

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return [x for per in lat for x in per], wall


def _http_rate(lat: list[float], wall: float) -> dict:
    return {"queries": len(lat), "qps": len(lat) / wall, "p50_ms": statistics.median(lat) * 1e3}


def server_families(dense_qs, tall_topn, tall_chains, ssb) -> dict:
    fam = {
        "dense_topn": [("dense", q) for q in dense_qs],
        "tall_topn": [("tall", q) for q in tall_topn],
        "tall_chain": [("tall", q) for q in tall_chains],
    }
    for family in SSB_FAMILIES:
        fam["ssb_" + family] = [("ssb", q) for f, q in ssb.queries if f == family]
    return fam


# the counters that move when a read leaves the card: device errors an
# executor's OomRecovery saw, its degrades, gate trips, CPU fallbacks
LEFT_THE_CARD = ("DEVICE_OOM", "DEVICE_OOM_CPU_DEGRADES", "DEVICEHEALTH_TRIPS", "EXECUTOR_DEVICE_DOWN_FALLBACK")


def fallback_counts(metrics) -> dict:
    snap = metrics.snapshot()
    out = {}
    for attr in LEFT_THE_CARD:
        name = getattr(metrics, attr)
        out[name] = sum(v for k, v in snap.items() if k == name or k.startswith(name + ";"))
    return out


def require_on_card(metrics, base: dict, path: str) -> None:
    """An in-process path ran with no device error, degrade, trip or
    CPU fallback: its answers and times are the card's."""
    moved = {k: v - base[k] for k, v in fallback_counts(metrics).items() if v != base[k]}
    if moved:
        raise AssertionError(f"{path}: reads left the card: {moved}")


def _device_counters(server, metrics) -> dict:
    ex = server.executor
    return {
        "degraded": ex._oom.stats()["degraded"],
        "fallbacks": metrics.snapshot().get(metrics.EXECUTOR_DEVICE_DOWN_FALLBACK, 0),
        "trips": ex.health.trips,
    }


def _require_clean(server, metrics, base: dict, when: str) -> None:
    """0 degrades, 0 device-down fallbacks and 0 gate trips since
    ``base`` (this server's own count of degrades and trips)."""
    now = _device_counters(server, metrics)
    moved = {k: now[k] - base.get(k, 0) for k in now if now[k] != base.get(k, 0)}
    if moved or not server.executor.health.healthy:
        raise AssertionError(f"server ({when}): degrades/fallbacks/trips moved: {moved}, healthy {server.executor.health.healthy}")


def _unset_columns(frag, row: int, n: int, lo: int) -> list[int]:
    """``n`` columns from ``lo`` up (absolute ids) that ``row`` of
    ``frag`` does not hold."""
    have = set(int(c) for c in frag.row(row).columns())
    out, c = [], lo
    while len(out) < n:
        if c not in have:
            out.append(c)
        c += 97
    return out


def server_writes(server, addr, cpu) -> dict:
    """Set/Clear PQL on dense and tall, and one protobuf import on dense,
    each followed by reads that must see it: exact counts, and a TopN or
    the chains over the written row against the CPU leg. Every write is
    cleared again, so the data (and the phase's oracle) end as they
    began."""
    from pilosa_tpu_torch.utils import publicproto

    c = HttpClient(*addr)
    h = server.holder
    n = {"reads_checked": 0, "set_clear_requests": 0}

    def expect(index, q, want=None):
        c.query(index, q, wire(cpu.execute(index, q)) if want is None else want)
        n["set_clear_requests" if q.startswith(("Set(", "Clear(")) else "reads_checked"] += 1

    def count(index, row):
        st, _, body = c.request("POST", f"/index/{index}/query", f"Count(Row(f={row}))".encode())
        assert st == 200, body
        return json.loads(body)["results"][0]

    try:
        dense_qs = dense_queries(DENSE_ROWS)
        r0 = int(dense_qs[0].split("Row(f=")[1].split(")")[0])
        cols = _unset_columns(h.fragment("dense", "f", "standard", 0), r0, 3, 11)
        n0 = count("dense", r0)
        for col in cols:
            expect("dense", f"Set({col}, f={r0})", [True])
        expect("dense", f"Count(Row(f={r0}))", [n0 + len(cols)])
        # a write reaches TopN's candidates when the rank cache next
        # recalculates (debounced, as in the reference): recalculate, so
        # the server's and the CPU leg's reads see one ranking
        recalculate_caches(addr)
        expect("dense", dense_qs[0])
        expect("dense", "".join(f"Clear({col}, f={r0})" for col in cols), [True] * len(cols))
        expect("dense", f"Count(Row(f={r0}))", [n0])
        # tall: a hot row of one shard gains a bit; the chains over it see it
        _, chains = tall_queries()
        t0 = count("tall", 0)
        shard = min(5, TALL_SHARDS - 1)
        col = _unset_columns(h.fragment("tall", "f", "standard", shard), 0, 1, shard * SW + 3)[0]
        expect("tall", f"Set({col}, f=0)", [True])
        expect("tall", "Count(Row(f=0))", [t0 + 1])
        for q in chains[:3]:
            expect("tall", q)
        expect("tall", f"Clear({col}, f=0)", [True])
        expect("tall", "Count(Row(f=0))", [t0])
        # one protobuf import of 64 bits into a dense TopN source row
        r1 = int(dense_qs[1].split("Row(f=")[1].split(")")[0])
        icols = _unset_columns(h.fragment("dense", "f", "standard", 0), r1, 64, 5)
        n1 = count("dense", r1)
        body = publicproto.encode_import_request(
            "dense", "f", 0, row_ids=[r1] * len(icols), column_ids=icols, timestamps=None
        )
        st, _, resp = c.request(
            "POST", "/index/dense/field/f/import", body, {"Content-Type": publicproto.CONTENT_TYPE}
        )
        if st != 200:
            raise AssertionError(f"server: protobuf import: HTTP {st}: {resp[:300]!r}")
        expect("dense", f"Count(Row(f={r1}))", [n1 + len(icols)])
        recalculate_caches(addr)
        expect("dense", dense_qs[1])
        expect("dense", "".join(f"Clear({col}, f={r1})" for col in icols), [True] * len(icols))
        expect("dense", f"Count(Row(f={r1}))", [n1])
    finally:
        c.close()
    return {**n, "import_bits": len(icols)}


# the plan-cache arm: bench.py's _plan_cache_probe traffic over HTTP on the
# dense data set: a Zipf(1.3) draw over 48 distinct TopN / Intersect /
# Union queries over its first 128 rows; 1 % writes on the 16 hottest
PC_DISTINCT = 48
PC_ROWS = 128
PC_ZIPF_A = 1.3
PC_READS = 160
PC_WRITE_OPS = 250
PC_WRITE_EVERY = 100
PC_HOT_ROWS = 16


def plan_cache_pool() -> list[str]:
    pool = []
    for i in range(PC_DISTINCT):
        a, b, c = i % PC_ROWS, (i * 7 + 1) % PC_ROWS, (i * 13 + 2) % PC_ROWS
        pool.append([
            f"TopN(f, Row(f={a}), n=10)",
            f"Count(Intersect(Row(f={a}), Row(f={b})))",
            f"Count(Union(Row(f={a}), Row(f={b}), Row(f={c})))",
        ][i % 3])
    return pool


def plan_cache_arm(server, addr, cpu) -> dict:
    """The plan cache over HTTP: the same Zipf draws with ``cache=false``
    (every read executed), then cached, then cached with 1 % writes (Set
    on a hot row at a column it lacks; the rank cache recalculated in
    process after each, which leaves the plan cache alone, so a write
    reaches the plan cache only through fragment generations). Every read
    is held to the port's uncached CPU leg (memoized until the next
    write). The writes are cleared at the end."""
    pc = server.executor.plan_cache
    pool = plan_cache_pool()
    draws = (np.random.default_rng(23).zipf(PC_ZIPF_A, size=PC_READS + PC_WRITE_OPS) - 1) % PC_DISTINCT
    frag = server.holder.fragment("dense", "f", "standard", 0)
    memo: dict = {}

    def want(q):
        if q not in memo:
            memo[q] = wire(cpu.execute("dense", q))
        return memo[q]

    def recalc():
        frag.cache.recalculate()

    c = HttpClient(*addr)
    out: dict = {"distinct_queries": PC_DISTINCT, "zipf_a": PC_ZIPF_A, "write_frac": 1 / PC_WRITE_EVERY}
    written: list = []
    try:
        recalc()

        def arm(ops: int, cache: bool, writes: bool) -> dict:
            st0 = pc.stats()
            lat, nw = [], 0
            for i in range(ops):
                if writes and i % PC_WRITE_EVERY == PC_WRITE_EVERY - 1:
                    row = len(written) % PC_HOT_ROWS
                    col = _unset_columns(frag, row, 1, 1000 + 7919 * len(written))[0]
                    c.query("dense", f"Set({col}, f={row})", [True])
                    written.append((col, row))
                    recalc()
                    memo.clear()
                    nw += 1
                    continue
                q = pool[draws[i]]
                lat.append(c.query("dense", q, want(q), cache=cache))
            st1 = pc.stats()
            hits, misses = st1["hits"] - st0["hits"], st1["misses"] - st0["misses"]
            return {
                "reads": len(lat), "writes": nw, "p50_ms": statistics.median(lat) * 1e3, "qps": len(lat) / sum(lat),
                "hits": hits, "misses": misses, "hit_ratio": hits / (hits + misses) if hits + misses else None,
                "invalidations": st1["invalidations"] - st0["invalidations"],
            }

        out["uncached"] = arm(PC_READS, cache=False, writes=False)
        out["cached"] = arm(PC_READS, cache=True, writes=False)
        out["cached_writes"] = arm(PC_WRITE_OPS, cache=True, writes=True)
        out["result_mismatches_vs_uncached_cpu_leg"] = 0  # any mismatch raised
        if out["uncached"]["hits"] or out["uncached"]["misses"]:
            raise AssertionError(f"plan cache: cache=false reads touched the cache: {out['uncached']}")
        if out["cached_writes"]["invalidations"] <= 0:
            raise AssertionError(f"plan cache: no invalidation under writes: {out['cached_writes']}")
        c.query("dense", "".join(f"Clear({col}, f={row})" for col, row in written), [True] * len(written))
        recalc()
    finally:
        c.close()
    out["entries"] = pc.stats()["entries"]
    return out


def oom_check(server, addr, metrics, answers, probe_items) -> dict:
    """``OomRecovery`` on the card's own allocation failure, then relief
    plus a retry that succeeds, without ``torch.cuda.empty_cache``."""
    import gc

    import torch

    from pilosa_tpu_torch.executor.hbm import DeviceOom, OomRecovery, classify_device_error
    from pilosa_tpu_torch.ops import cuda

    ex = server.executor
    gov = ex.governor
    out: dict = {"cooldown_s": OOM_COOLDOWN_S}
    ex.oom_cpu_cooldown_s = OOM_COOLDOWN_S
    staged0 = gov.used("stager")
    evictions0 = sum(v for k, v in metrics.snapshot().items() if k.startswith(metrics.HBM_GOVERNOR_EVICTIONS))
    try:
        ex._oom.run(lambda: torch.empty(1 << 40, dtype=torch.uint8, device="cuda"), kind="oom_check")
    except DeviceOom as e:
        cls = classify_device_error(e.__cause__)
        out["cause"] = type(e.__cause__).__name__
    else:
        raise AssertionError("server: a 1 TiB allocation did not fail")
    if cls != "alloc":
        raise AssertionError(f"server: the card's OOM classified {cls!r}, not 'alloc'")
    relieved = sum(v for k, v in metrics.snapshot().items() if k.startswith(metrics.HBM_GOVERNOR_EVICTIONS)) - evictions0
    st = ex._oom.stats()
    out.update(stats=st, staged_before=staged0, staged_after_relief=gov.used("stager"), relief_evictions=relieved)
    if (st["ooms"], st["recovered"], st["degraded"]) != (1, 0, 1):
        raise AssertionError(f"server: OomRecovery stats after the OOM check: {st}")
    if relieved <= 0 or gov.used("stager") >= staged0:
        raise AssertionError(f"server: relief did not run: {out}")
    if ex.health.trips != 0 or not ex.health.healthy:
        raise AssertionError("server: one OOM tripped the gate (trip_after = 2)")
    # the cooldown: reads are CPU-forced, launch nothing, stay exact
    if not ex._cpu_forced():
        raise AssertionError("server: no CPU cooldown after the degrade")
    launched = sum(k.launches for k in cuda.KERNELS)
    fb = metrics.snapshot().get(metrics.EXECUTOR_DEVICE_DOWN_FALLBACK, 0)
    http_sequential(addr, probe_items[:1], answers)
    if not ex._cpu_forced():
        raise AssertionError(f"server: the cooldown query outlasted the {OOM_COOLDOWN_S} s cooldown")
    out["cooldown_kernel_launches"] = sum(k.launches for k in cuda.KERNELS) - launched
    if out["cooldown_kernel_launches"]:
        raise AssertionError(f"server: {out['cooldown_kernel_launches']} launches during the CPU cooldown")
    # the cooldown's one read call is served on the CPU leg, and counted
    out["cooldown_fallbacks"] = metrics.snapshot().get(metrics.EXECUTOR_DEVICE_DOWN_FALLBACK, 0) - fb
    if out["cooldown_fallbacks"] != 1:
        raise AssertionError(f"server: {out['cooldown_fallbacks']} fallbacks counted for the cooldown's one read")
    # after it: the device path again, restaging what relief evicted
    time.sleep(max(0.0, ex._oom_cpu_until - time.monotonic()) + 0.1)
    misses0, launched = ex.stager.misses, sum(k.launches for k in cuda.KERNELS)
    http_sequential(addr, probe_items, answers, cold=True)
    out["restaged_entries"] = ex.stager.misses - misses0
    out["kernel_launches_after_cooldown"] = sum(k.launches for k in cuda.KERNELS) - launched
    if out["restaged_entries"] <= 0 or out["kernel_launches_after_cooldown"] <= 0:
        raise AssertionError(f"server: the device path did not return after the cooldown: {out}")
    # relief plus one retry succeeds: ask for more than the card has free
    # (the allocator's cached blocks included) but less than relief frees.
    # The allocator returns to the driver only segments left wholly free,
    # so a live tensor beside a staged one keeps its segment: where the
    # card's bytes are, by owner, is printed before the probe and after a
    # failed one
    torch.cuda.synchronize()
    free, _ = torch.cuda.mem_get_info()
    cached = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    with ex.stager._mu:
        sizes = [e.nbytes for e in ex.stager._cache.values()]
    need = (sum(sizes) - max(sizes)) // 2
    ask = free + cached + need
    probe = OomRecovery(governor=gov)
    out["retry_probe"] = {"asked_bytes": ask, "free_bytes": free, "cached_bytes": cached, "relief_need_bytes": need,
                          "staged_before": gov.used("stager"), "staged_entries": len(sizes),
                          "allocated_before": torch.cuda.memory_allocated()}
    try:
        held = probe.run(lambda: torch.empty(ask, dtype=torch.uint8, device="cuda"), kind="oom_retry_probe")
    except DeviceOom:
        out["retry_probe"].update(staged_after=gov.used("stager"), card_after=card_memory_by_owner(ex, holders=4))
        gc.collect()
        out["retry_probe"]["allocated_after_gc"] = torch.cuda.memory_allocated()
        raise AssertionError(f"server: relief plus retry did not succeed: {json.dumps(out['retry_probe'])}")
    del held
    # the probe's one segment spans the card: staging carves it up, and
    # a segment with one live tensor is never released to CUDA, so it
    # would hold the card from the processes this run starts later
    torch.cuda.empty_cache()
    out["retry_probe"]["card_after_relief"] = card_memory_by_owner(ex, holders=4)
    out["retry_probe"].update(probe.stats())
    if (probe.stats()["ooms"], probe.stats()["recovered"]) != (1, 1):
        raise AssertionError(f"server: relief plus retry did not succeed: {out['retry_probe']}")
    http_sequential(addr, probe_items, answers, cold=True)
    return out


# -- the faults arm: injected and real device faults on the restart server ----------

# the sticky child's device-health probe interval: the gate must stay
# tripped across several failed probes
STICKY_PROBE_S = 0.5
STICKY_HOLD_S = 1.5
STICKY_COOLDOWN_S = 0.2
# the telemetry ballast lifts the card's allocated bytes this far past
# the watermark
BALLAST_MARGIN = 512 << 20
# the card's launch counts must stand still this long before a capture
# opens its window (a background stage would race the window's edge)
CAPTURE_QUIET_S = 0.25


class OtlpListener:
    """An OTLP/HTTP JSON collector on 127.0.0.1, a thread of this script:
    it keeps the path and JSON body of every POST it receives."""

    def __init__(self) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        posts: list = []
        mu = threading.Lock()
        self.posts, self._mu = posts, mu

        class Collector(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                with mu:
                    posts.append((self.path, json.loads(body)))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Collector)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    @property
    def url(self) -> str:
        return "http://127.0.0.1:%d" % self.httpd.server_address[1]

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()

    def summary(self) -> dict:
        """Posts by path, and the journal kinds the log posts carried."""
        with self._mu:
            posts = list(self.posts)
        by_path: dict = {}
        kinds: dict = {}
        for path, body in posts:
            by_path[path] = by_path.get(path, 0) + 1
            for rl in body.get("resourceLogs", []):
                for sl in rl.get("scopeLogs", []):
                    for rec in sl.get("logRecords", []):
                        k = rec["body"]["stringValue"]
                        kinds[k] = kinds.get(k, 0) + 1
        return {"posts_by_path": by_path, "log_kinds": kinds}


def _chaos(c: "HttpClient", body=None, status: int = 200) -> dict:
    """GET /debug/chaos, or POST ``body`` to it; its JSON, which must
    come with ``status``."""
    if body is None:
        st, _, raw = c.request("GET", "/debug/chaos")
    else:
        st, _, raw = c.request("POST", "/debug/chaos", json.dumps(body).encode())
    if st != status:
        raise AssertionError(f"server: /debug/chaos {body}: HTTP {st} (want {status}): {raw[:300]!r}")
    return json.loads(raw)


def _json_get(c: "HttpClient", path: str) -> dict:
    st, _, raw = c.request("GET", path)
    if st != 200:
        raise AssertionError(f"server: GET {path}: HTTP {st}: {raw[:300]!r}")
    return json.loads(raw)


def _metric_sum(metrics, name: str) -> float:
    return sum(v for k, v in metrics.snapshot().items() if k == name or k.startswith(name + ";"))


def fault_windows(server, addr, answers: dict, probe_items: list, stats_items: list, launched) -> dict:
    """Fault windows opened and cleared through ``POST /debug/chaos`` over
    the OOM check's probe items and the stats family as one multi-call
    request, every answer == the CPU leg: a poisoned lowering (the
    per-call path answers), an allocation failure on every second
    launch (recovered in place), on every launch (the read degrades to
    the CPU leg, the cooldown launches nothing, then the card again),
    and stalls (counted, the gate stays open). ``launched()`` counts the
    kernel launches so far. Returns each window's numbers and its
    ``GET /debug/chaos``, and ``fallbacks``: the reads the windows sent
    to the CPU leg on purpose."""
    from pilosa_tpu_torch.utils import chaos, metrics

    ex = server.executor
    fuser = ex.fuser
    index = stats_items[0][0]
    multi_q = "".join(q for _, q in stats_items)
    multi_want = [a for _, q in stats_items for a in answers[(index, q)]]
    out: dict = {}
    c = HttpClient(*addr)

    def multi() -> float:
        return c.query(index, multi_q, multi_want, cold=True)

    def reads(items) -> list[float]:
        return [c.query(i, q, answers[(i, q)], cold=True) for i, q in items]

    def fallbacks() -> float:
        return metrics.snapshot().get(metrics.EXECUTOR_DEVICE_DOWN_FALLBACK, 0)

    def gate_open(when: str, trips0: int) -> None:
        if ex.health.trips != trips0 or not ex.health.healthy:
            raise AssertionError(f"faults ({when}): the gate tripped: {ex.health.trips - trips0} trips")

    def delta(s1: dict, s0: dict) -> dict:
        return {k: s1[k] - s0[k] for k in ("ooms", "recovered", "degraded")}

    try:
        trips0, fb0 = ex.health.trips, fallbacks()
        # a poisoned lowering: no program is built, so nothing fuses and
        # the per-call path answers every call. First, before the
        # request's program was ever built (a built one is reused)
        f0 = fuser.stats()
        _chaos(c, {"device": "poison_every=1"})
        lat = [multi()]
        f1 = fuser.stats()
        errors = f1["bypasses"].get("error", 0) - f0["bypasses"].get("error", 0)
        if f1["fused_launches"] != f0["fused_launches"] or errors < 1 or chaos.FAULTS.injected < 1:
            raise AssertionError(f"faults (poison_every=1): fused launches {f0['fused_launches']} -> "
                                 f"{f1['fused_launches']}, error bypasses +{errors}")
        w = {"error_bypasses": errors, "injected": chaos.FAULTS.injected, "p50_ms": lat[0] * 1e3, "chaos": _chaos(c)}
        _chaos(c, {})
        multi()
        w["fused_launches_after_clear"] = fuser.stats()["fused_launches"] - f1["fused_launches"]
        if w["fused_launches_after_clear"] < 1:
            raise AssertionError(f"faults (poison_every=1): no fused launch after the window cleared: {w}")
        out["poison_every=1"] = w
        log(f"faults: poison_every=1 {w}")

        # an allocation failure on every second hooked launch: relief and
        # the one retry recover each in place
        s0 = ex._oom.stats()
        _chaos(c, {"device": "oom_every=2"})
        lat = reads(probe_items) + [multi()]
        d = delta(ex._oom.stats(), s0)
        w = {**d, "injected": chaos.FAULTS.injected, "reads": len(lat), "p50_ms": statistics.median(lat) * 1e3,
             "chaos": _chaos(c)}
        _chaos(c, {})
        if d["ooms"] < 1 or d["recovered"] != d["ooms"] or d["degraded"] != 0 or fallbacks() != fb0:
            raise AssertionError(f"faults (oom_every=2): {w}, fallbacks +{fallbacks() - fb0}")
        gate_open("oom_every=2", trips0)
        out["oom_every=2"] = w
        log(f"faults: oom_every=2 {w}")

        # every hooked launch fails, the retry too: the read degrades to
        # the CPU leg and the cooldown holds reads there, launching nothing
        ex.oom_cpu_cooldown_s = OOM_COOLDOWN_S
        s0 = ex._oom.stats()
        _chaos(c, {"device": "oom_every=1"})
        lat = reads(probe_items[:1])
        d = delta(ex._oom.stats(), s0)
        if d["degraded"] != 1 or not ex._cpu_forced():
            raise AssertionError(f"faults (oom_every=1): {d}, CPU forced {ex._cpu_forced()}")
        k0, l0 = chaos.FAULTS._kernels, launched()
        lat += reads(probe_items[1:2])
        w = {**d, "cooldown_hooked_launches": chaos.FAULTS._kernels - k0, "cooldown_kernel_launches": launched() - l0,
             "fallbacks": fallbacks() - fb0, "p50_ms": statistics.median(lat) * 1e3, "chaos": _chaos(c)}
        if w["cooldown_hooked_launches"] or w["cooldown_kernel_launches"]:
            raise AssertionError(f"faults (oom_every=1): the cooldown read launched: {w}")
        if not ex._cpu_forced():
            raise AssertionError(f"faults (oom_every=1): the cooldown read outlasted the {OOM_COOLDOWN_S} s cooldown")
        # one fallback for the degraded read, one for the cooldown's
        if w["fallbacks"] != 2:
            raise AssertionError(f"faults (oom_every=1): {w['fallbacks']} fallbacks counted for 2 reads")
        _chaos(c, {})
        time.sleep(max(0.0, ex._oom_cpu_until - time.monotonic()) + 0.1)
        l0 = launched()
        reads(probe_items[:2])
        w["kernel_launches_after_cooldown"] = launched() - l0
        if w["kernel_launches_after_cooldown"] <= 0 or fallbacks() - fb0 != 2:
            raise AssertionError(f"faults (oom_every=1): the card did not return after the cooldown: {w}")
        gate_open("oom_every=1", trips0)
        out["oom_every=1"] = w
        log(f"faults: oom_every=1 {w}")

        # stalled launches: latency only, the gate stays open
        s0, st0 = ex._oom.stats(), _metric_sum(metrics, metrics.DEVICE_FAULTS_INJECTED + ";fault:stall")
        _chaos(c, {"device": "stall_every=4,stall_s=0.05"})
        lat = reads(probe_items) + [multi()]
        w = {"stalls": _metric_sum(metrics, metrics.DEVICE_FAULTS_INJECTED + ";fault:stall") - st0,
             **delta(ex._oom.stats(), s0), "p50_ms": statistics.median(lat) * 1e3, "chaos": _chaos(c)}
        _chaos(c, {})
        if w["stalls"] < 1 or w["ooms"] or fallbacks() - fb0 != 2:
            raise AssertionError(f"faults (stall_every=4): {w}")
        gate_open("stall_every=4", trips0)
        out["stall_every=4"] = w
        log(f"faults: stall_every=4 {w}")
        out["fallbacks"] = fallbacks() - fb0
    finally:
        chaos.install_device_faults("")
        c.close()
    return out


_GLOBAL_RE = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def kernel_symbols() -> dict:
    """Each port kernel's ``__global__`` function names, read from its
    source: every wrapper call launches exactly one of them."""
    from pilosa_tpu_torch.ops import cuda

    out = {}
    for k in cuda.KERNELS:
        with open(os.path.join(REPO, k.source)) as f:
            out[k.name] = set(_GLOBAL_RE.findall(f.read()))
    return out


def trace_kernel_base(name: str) -> str:
    """A device kernel's function name from the trace's demangled
    signature: no return type, namespaces, template arguments or
    parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def capture_arm(addr, answers: dict, items: list, stats_items: list, directory: str,
                launches=None) -> dict:
    """``/debug/profile?capture=start`` around ``items`` and the stats
    request, sent once with no pause, then ``capture=stop``. Where
    ``launches`` (a function giving each port kernel's launch count) is
    given, the card: the Chrome trace must hold, of each port kernel,
    exactly as many device kernels as its wrapper launched between the
    start and the stop, ``dense_scores`` and ``tree_count`` among them,
    so a kernel the profiler lost fails the arm. Returns the kernel
    count, the device span (first device event's start to the last
    one's end), kernels by name, the start's settle, the stop's count of
    the capture's marker kernels and what the CPU side of the trace
    holds."""
    from urllib.parse import quote

    before = launches() if launches is not None else {}
    t_quiet = time.monotonic()
    while launches is not None and time.monotonic() - t_quiet < 5.0:
        time.sleep(CAPTURE_QUIET_S)
        now = launches()
        if now == before:
            break
        before = now
    c = HttpClient(*addr)
    try:
        t = time.monotonic()
        start = _json_get(c, "/debug/profile?capture=start&dir=" + quote(directory))["capture"]
        start_s = time.monotonic() - t
        if not start.get("ok"):
            raise AssertionError(f"capture: start: {start}")
        for index, q in items:
            c.query(index, q, answers[(index, q)], cold=True)
        index = stats_items[0][0]
        c.query(index, "".join(q for _, q in stats_items),
                [a for _, q in stats_items for a in answers[(index, q)]], cold=True)
        stop = _json_get(c, "/debug/profile?capture=stop")["capture"]
    finally:
        c.close()
    after = launches() if launches is not None else {}
    if "trace" not in stop:
        raise AssertionError(f"capture: stop: {stop}")
    with open(stop["trace"]) as f:
        evs = json.load(f)["traceEvents"]
    device = [e for e in evs if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    kernels = [e for e in device if e["cat"] == "kernel"]
    by_name: dict = {}
    for e in kernels:
        name = trace_kernel_base(e["name"])
        by_name[name] = by_name.get(name, 0) + 1
    cpu_ops = [e for e in evs if e.get("cat") == "cpu_op"]
    by_cat: dict = {}
    for e in evs:
        by_cat[e.get("cat")] = by_cat.get(e.get("cat"), 0) + 1
    timed = [e for e in evs if "ts" in e and e.get("ph") == "X"]
    t0 = min((e["ts"] for e in timed), default=0)
    rt = [e for e in evs if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")]
    out = {
        "settle_s": start.get("settle_s"),
        "start_s": start_s,
        "markers": stop.get("markers"),
        "events_by_cat": by_cat,
        "runtime_launches": len(rt),
        "first_kernel_ms": (min(e["ts"] for e in kernels) - t0) / 1e3 if kernels else None,
        "trace_span_ms": (max(e["ts"] + e.get("dur", 0) for e in timed) - t0) / 1e3 if timed else 0.0,
        "all_threads": start.get("all_threads"),
        "trace_bytes": os.path.getsize(stop["trace"]),
        "device_kernels": len(kernels),
        "device_span_ms": (max(e["ts"] + e["dur"] for e in device) - min(e["ts"] for e in device)) / 1e3 if device else 0.0,
        "kernels_by_name": dict(sorted(by_name.items())),
        "cpu_ops": len(cpu_ops),
        "cpu_op_threads": len({e.get("tid") for e in cpu_ops}),
    }
    if launches is not None:
        per_kernel = {}
        for name, symbols in kernel_symbols().items():
            traced = sum(n for k, n in by_name.items() if k in symbols)
            launched = after.get(name, 0) - before.get(name, 0)
            if traced or launched:
                per_kernel[name] = {"traced": traced, "launched": launched}
        out["port_kernels"] = per_kernel
        out["port_kernels_traced"] = sum(v["traced"] for v in per_kernel.values())
        lost = {k: v for k, v in per_kernel.items() if v["traced"] != v["launched"]}
        missing = [k for k in ("dense_scores", "tree_count") if not per_kernel.get(k, {}).get("launched")]
        if lost or missing or not stop.get("ok"):
            raise AssertionError(
                f"capture: traced != launched for {lost}, not launched {missing}, stop {stop}: {out}"
            )
    elif not stop.get("ok"):
        raise AssertionError(f"capture: stop: {stop}")
    return out


def telemetry_arm(server, addr, metrics, answers: dict, cold_items: list) -> dict:
    """Device telemetry on the card: ``/debug/profile``'s ``hbm`` shows
    the server's card with its total memory as the limit; a ballast
    tensor lifts the card's allocated bytes past the watermark, one
    poll journals ``profiler.hbm_watermark`` and the next cold query's
    staging relieves (evictions counted); with the ballast gone and
    polled again, a cold query runs with no relief."""
    import torch

    from pilosa_tpu_torch.utils import events, profiler

    ex = server.executor
    c = HttpClient(*addr)
    try:
        hbm = _json_get(c, "/debug/profile")["hbm"]
        if "cuda:0" not in hbm.get("devices", {}):
            # the poller's first sample may predate the card's context
            profiler.TELEMETRY.poll_once()
            hbm = _json_get(c, "/debug/profile")["hbm"]
        dev = hbm.get("devices", {}).get("cuda:0")
        _free, total = torch.cuda.mem_get_info(0)
        if dev is None or dev.get("bytes_limit") != total or dev.get("bytes_in_use", 0) <= 0:
            raise AssertionError(f"telemetry: /debug/profile hbm {hbm}, mem_get_info total {total}")
        out: dict = {"hbm": dev}

        def evictions() -> float:
            return _metric_sum(metrics, metrics.HBM_GOVERNOR_EVICTIONS)

        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated(0)
        need = int(profiler.TELEMETRY.watermark_pct * total) + BALLAST_MARGIN - allocated
        free, _ = torch.cuda.mem_get_info(0)
        spare = torch.cuda.memory_reserved(0) - allocated
        out["ballast"] = {"bytes": need, "allocated_before": allocated, "free": free, "allocator_spare": spare}
        marks0 = len(events.snapshot(kind=events.PROFILER_HBM_WATERMARK))
        ballast = torch.empty(need, dtype=torch.uint8, device="cuda:0")
        try:
            snap = profiler.TELEMETRY.poll_once()["devices"]["cuda:0"]
            out["above"] = snap
            marks = len(events.snapshot(kind=events.PROFILER_HBM_WATERMARK)) - marks0
            ev0, miss0 = evictions(), ex.stager.misses
            lat = [c.query(i, q, answers[(i, q)], cold=True) for i, q in cold_items]
            out["relief"] = {"watermark_events": marks, "evictions": evictions() - ev0,
                             "restaged": ex.stager.misses - miss0, "p50_ms": statistics.median(lat) * 1e3}
        finally:
            del ballast
        if out["relief"]["watermark_events"] < 1 or out["relief"]["evictions"] <= 0 or out["relief"]["restaged"] <= 0:
            raise AssertionError(f"telemetry: no relief under the ballast: {out}")
        # the ballast's block is released to CUDA: the processes this run
        # starts after the arm need the card's memory
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["below"] = profiler.TELEMETRY.poll_once()["devices"]["cuda:0"]
        ex.stager.clear()
        ev0, miss0 = evictions(), ex.stager.misses
        for i, q in cold_items:
            c.query(i, q, answers[(i, q)], cold=True)
        out["after"] = {"evictions": evictions() - ev0, "restaged": ex.stager.misses - miss0}
        if out["after"]["evictions"] or out["after"]["restaged"] <= 0:
            raise AssertionError(f"telemetry: relief after the ballast was dropped: {out}")
    finally:
        c.close()
    return out


def export_check(path: str, listener: OtlpListener) -> dict:
    """The restart server's JSONL export and the listener's posts each
    carry ``chaos.window`` and ``device.fault`` records; the listener
    got traces, logs and metrics posts."""
    kinds: dict = {}
    streams: dict = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            streams[rec["stream"]] = streams.get(rec["stream"], 0) + 1
            if rec["stream"] == "events":
                k = rec["record"]["kind"]
                kinds[k] = kinds.get(k, 0) + 1
    heard = listener.summary()
    out = {"jsonl": {"streams": streams, "kinds": kinds}, "listener": heard}
    for want in ("chaos.window", "device.fault"):
        if not kinds.get(want) or not heard["log_kinds"].get(want):
            raise AssertionError(f"export: no {want} record: {out}")
    for p in ("/v1/traces", "/v1/logs", "/v1/metrics"):
        if not heard["posts_by_path"].get(p):
            raise AssertionError(f"export: the listener got no {p} post: {out}")
    return out


def sticky_child(root: str, answers_path: str) -> int:
    """``chip_smoke.py --sticky-child ROOT ANSWERS``: a process of its own
    opens the dense data set on the card with a device health gate,
    answers dense TopN there, then loses its CUDA context to a real
    device-side assert (plain torch indexing out of range). The next
    reads degrade, the gate trips and stays tripped across failed
    probes, and every later read answers == on the CPU leg, counted as a
    fallback, launching nothing. Prints one JSON line; exits 0 only if
    every check held."""
    import torch

    sys.path.insert(0, REPO)
    import pilosa_tpu_torch
    from pilosa_tpu_torch.executor.devicehealth import DeviceHealth
    from pilosa_tpu_torch.ops import cuda
    from pilosa_tpu_torch.utils import metrics

    with open(answers_path) as f:
        spec = json.load(f)
    topn = [(q, a) for q, a in spec["topn"]]
    out: dict = {"ok": False}
    t0 = time.monotonic()
    cuda.build_kernels()
    holder = pilosa_tpu_torch.holder_from_dir(root)
    for frag in holder.view("dense", "f", "standard").fragments.values():
        frag.ensure_open()
    cpu = pilosa_tpu_torch.Executor(holder, device_policy="never")
    counts = [f"Count(Intersect(Row(f={r}), Row(f={r + 1})))" for r in range(0, 18, 2)]
    count_want = {q: wire(cpu.execute("dense", q)) for q in counts}
    dev = torch.device("cuda")
    hlth = DeviceHealth(timeout_s=120.0, probe_interval_s=STICKY_PROBE_S, probe_timeout_s=10.0, device=dev)
    ex = pilosa_tpu_torch.Executor(holder, device=dev, device_policy="auto", health=hlth, auto_min_containers=1)
    # a short cooldown: the degraded read falls back, and the next read
    # after it launches again, degrades again and trips the gate (two
    # unrecovered failures inside OomRecovery's window)
    ex.oom_cpu_cooldown_s = STICKY_COOLDOWN_S
    tripped: dict = {}
    real_trip = hlth._trip

    def timed_trip(reason: str) -> None:
        tripped.setdefault("t", time.monotonic())
        tripped.setdefault("reason", reason)
        real_trip(reason)

    hlth._trip = timed_trip

    def read(q: str, want) -> float:
        t = time.perf_counter()
        got = wire(ex.execute("dense", q))
        if got != want:
            raise AssertionError(f"sticky child: {q} answered {str(got)[:200]}, CPU leg {str(want)[:200]}")
        return time.perf_counter() - t

    def fallbacks() -> float:
        return metrics.snapshot().get(metrics.EXECUTOR_DEVICE_DOWN_FALLBACK, 0)

    try:
        out["setup_s"] = time.monotonic() - t0
        cuda.reset_launches()
        healthy = [read(q, a) for q, a in topn] + [read(q, count_want[q]) for q in counts[:2]]
        launched = {k.name: k.launches for k in cuda.KERNELS}
        if launched["dense_scores"] <= 0 or launched["tree_count"] <= 0 or fallbacks():
            raise AssertionError(f"sticky child: healthy reads launched {launched}, fallbacks {fallbacks()}")
        out["healthy"] = {"reads": len(healthy), "launches": {k: v for k, v in launched.items() if v}}
        # the real fault: an index out of range trips a device-side assert,
        # and the context is lost for the life of the process
        table = torch.arange(8, device=dev)
        try:
            table[torch.tensor([1 << 20], device=dev)]
            torch.cuda.synchronize()
        except Exception as e:  # the sticky error, checked below
            out["poison"] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        if "poison" not in out:
            raise AssertionError("sticky child: an out-of-range index raised no device-side assert")
        t_poison = time.monotonic()
        degrading = []
        for q in counts[2:6]:
            fb = fallbacks()
            degrading.append(read(q, count_want[q]))
            if fallbacks() - fb != 1:
                raise AssertionError(f"sticky child: a read after the assert counted {fallbacks() - fb} fallbacks")
            if not hlth.healthy:
                tripped["answered"] = time.monotonic()
                break
            time.sleep(STICKY_COOLDOWN_S + 0.1)
        if hlth.healthy:
            raise AssertionError(f"sticky child: {len(degrading)} reads after the assert, the gate still open")
        out["trip"] = {"reads_to_trip": len(degrading), "reason": tripped["reason"],
                       "assert_to_trip_s": tripped["t"] - t_poison,
                       "trip_to_first_fallback_s": tripped["answered"] - tripped["t"],
                       "degraded": ex._oom.stats()["degraded"]}
        # the probe keeps failing: the gate stays tripped
        time.sleep(STICKY_HOLD_S)
        if hlth.healthy or hlth.restores:
            raise AssertionError(f"sticky child: the gate reopened on a dead context ({hlth.restores} restores)")
        cuda.reset_launches()
        fb0 = fallbacks()
        later = [read(q, count_want[q]) for q in counts[6:]]
        out["after_trip"] = {
            "reads": len(later), "fallbacks": fallbacks() - fb0,
            "kernel_launches": sum(k.launches for k in cuda.KERNELS),
            "p50_ms": statistics.median(later) * 1e3, "held_s": STICKY_HOLD_S,
            "probe_interval_s": STICKY_PROBE_S, "restores": hlth.restores, "trips": hlth.trips,
        }
        if out["after_trip"]["fallbacks"] != len(later) or out["after_trip"]["kernel_launches"]:
            raise AssertionError(f"sticky child: after the trip {out['after_trip']}")
        out["ok"] = True
    except BaseException as e:  # reported in the line; the exit code says it failed
        out["error"] = f"{type(e).__name__}: {e}"[:2000]
    out["seconds"] = time.monotonic() - t0
    print(json.dumps({"sticky_child": out}), flush=True)
    sys.stderr.flush()
    # a dead context's teardown and the guard's abandoned workers are not
    # waited for
    os._exit(0 if out["ok"] else 1)


class StickyChild:
    """``sticky_child`` in a process of its own over ``root``, started
    now; ``result()`` waits for it and reads its line, and fails unless
    it exited 0 with ``ok``. It reads the data only, so it runs beside
    the server."""

    def __init__(self, root: str, topn: list, tmp: str) -> None:
        path = os.path.join(tmp, "sticky_answers.json")
        with open(path, "w") as f:
            json.dump({"topn": topn}, f)
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sticky-child", root, path],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )

    def result(self) -> dict:
        try:
            stdout, stderr = self.proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise AssertionError("sticky child: no answer within 300 s")
        lines = [ln for ln in stdout.splitlines() if ln.startswith('{"sticky_child"')]
        if not lines:
            raise AssertionError(f"sticky child: exit {self.proc.returncode}, no result line: {stderr[-2000:]!r}")
        out = json.loads(lines[-1])["sticky_child"]
        if self.proc.returncode != 0 or not out.get("ok"):
            raise AssertionError(f"sticky child: exit {self.proc.returncode}: {out}; stderr {stderr[-1500:]!r}")
        out["wall_s"] = time.monotonic() - self.t0
        return out


def run_server(root: str, cpu_answers: dict, families: dict, in_process: dict, card: str) -> dict:
    """The port's server over the run's data directory: the in-process
    phases' queries over HTTP, sequentially and from CLIENTS clients,
    writes, the OOM check, a restart with fault injection, profile
    capture and telemetry export on (the faults arm), a child process
    that loses its CUDA context, and the CLI."""
    import signal
    import socket

    import torch

    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import cuda
    from pilosa_tpu_torch.server import Config, Server
    from pilosa_tpu_torch.utils import events, metrics

    cfg = Config(data_dir=root, bind="127.0.0.1:0", device="cuda")
    out: dict = {"card": card, "config": {"device": cfg.device, "device_policy": cfg.device_policy,
                 "stager_budget_bytes": cfg.stager_budget_bytes, "tier1_max_bytes": cfg.tier1_max_bytes,
                 "journal_max_bytes": cfg.journal_max_bytes}}
    # the cooldown's one query first: its CPU leg is fast
    probe_items = families["tall_chain"][:6] + families["dense_topn"][:4] + families["ssb_groupby"] + families["ssb_range_count"][:4]
    stats_items = families["ssb_" + STATS]
    t0 = time.monotonic()
    server = Server(cfg)
    server.open()
    out["open_s"] = time.monotonic() - t0
    addr = server.address()
    base = _device_counters(server, metrics)
    fb0 = base["fallbacks"]
    try:
        # the rank caches recalculate on a debounce (reference cache.go:
        # 233-241); TopN candidates are their rankings, so every check of
        # TopN answers starts from recalculated caches, as the answers'
        # CPU leg did
        recalculate_caches(addr)
        cold = {}
        for family, items in families.items():
            cold[family] = sum(http_sequential(addr, items, cpu_answers, cold=True))
        out["first_pass_s"] = cold
        log(f"server: first pass (staging) {sum(cold.values()):.1f} s")
        rates = {}

        def hits() -> int:
            return server.pipeline.stats()["coalesce_hits"]

        for family, items in families.items():
            seq = http_sequential(addr, items, cpu_answers)
            h0 = hits()
            lat, wall = http_concurrent(addr, rotating_streams(items, CLIENTS), cpu_answers)
            h1 = hits()
            streams = distinct_streams(items, CLIENTS)
            dlat, dwall = http_concurrent(addr, streams, cpu_answers)
            h2 = hits()
            if h2 != h1:
                raise AssertionError(f"server: {family}: {h2 - h1} coalesced answers with no query shared by two clients")
            src = in_process
            for k in SERVER_IN_PROCESS[family]:
                src = src[k]
            pc0 = server.executor.plan_cache.stats()
            http_sequential(addr, items, cpu_answers, cache=True)
            cached = http_sequential(addr, items, cpu_answers, cache=True)
            pc1 = server.executor.plan_cache.stats()
            rates[family] = {
                # the plan cache on: a first pass fills it, a second is timed
                "cached": {**_http_rate(cached, sum(cached)), "hits": pc1["hits"] - pc0["hits"],
                           "misses": pc1["misses"] - pc0["misses"]},
                "sequential": _http_rate(seq, sum(seq)),
                # the same queries from every client: part of the answers
                # are shared by singleflight coalescing, not executed
                f"concurrent_c{CLIENTS}": {**_http_rate(lat, wall), "coalesce_hits": h1 - h0},
                # each query from one client only: every answer executed
                "concurrent_distinct": {**_http_rate(dlat, dwall), "clients": len(streams), "coalesce_hits": 0},
                "in_process_p50_ms": src["p50_ms"],
            }
        out["families"] = rates
        log("server: " + ", ".join(
            f"{f} p50 {r['sequential']['p50_ms']:.2f} ms ({r['in_process_p50_ms']:.2f} in process), "
            f"{r[f'concurrent_c{CLIENTS}']['qps']:.1f} qps from {CLIENTS} "
            f"({r[f'concurrent_c{CLIENTS}']['coalesce_hits']} coalesced), "
            f"{r['concurrent_distinct']['qps']:.1f} qps from {r['concurrent_distinct']['clients']} distinct"
            for f, r in rates.items()))
        _require_clean(server, metrics, base, "reads")
        # writes, each followed by reads that see it; then the answers the
        # rest of the phase holds the server to are the CPU leg's anew
        cpu = Executor(server.holder, device=torch.device("cuda"), device_policy="never")
        try:
            t0 = time.monotonic()
            out["plan_cache"] = plan_cache_arm(server, addr, cpu)
            out["plan_cache"]["seconds"] = time.monotonic() - t0
            log(f"server: plan cache {out['plan_cache']}")
            out["writes"] = server_writes(server, addr, cpu)
        finally:
            cpu.close()
        recalculate_caches(addr)
        _require_clean(server, metrics, base, "writes")
        log(f"server: writes {out['writes']}")
        out["oom"] = oom_check(server, addr, metrics, cpu_answers, probe_items)
        after_oom = _device_counters(server, metrics)
        log(f"server: OOM check {out['oom']}")
        ps = server.pipeline.stats()
        out["pipeline"] = {c: {"admitted": v["admitted"], "sheds": v["sheds"]} for c, v in ps["classes"].items()}
        out["pipeline"]["coalesce_hits"] = ps["coalesce_hits"]
        out["pipeline"]["batched_entries"] = ps["batched_entries"]
        # fused launches and bypasses beside the pipeline's batched count
        out["fusion"] = server.executor.fuser.stats()
        out["health"] = {"healthy": server.executor.health.healthy, "trips": server.executor.health.trips}
        out["governor"] = server.executor.governor.stats()
        out["oom_recovery"] = server.executor._oom.stats()
        # nothing but the OOM check's own degrade: the reads after it ran clean
        _require_clean(server, metrics, after_oom, "after the OOM check")
        # the default Config keeps the journal on disk and no fault injector
        c = HttpClient(*addr)
        try:
            _chaos(c, {"device": "oom_every=1"}, status=403)
            last = _json_get(c, "/debug/events?limit=1")["events"]
        finally:
            c.close()
        if not events.JOURNAL.durable or not last:
            raise AssertionError(f"server: the default journal is not durable ({events.JOURNAL.durable}) or empty")
        out["journal"] = {"first_server_last_seq": last[-1]["seq"]}
    finally:
        server.close()
    # restart: a new server over the same directory answers the same; it
    # opens the fault injector and exports its telemetry to a JSONL file
    # and to an OTLP listener on this host
    fdir = os.path.join(root, ".faults")  # the holder skips dot names
    os.makedirs(fdir, exist_ok=True)
    # the exporter posts with urllib, which honours proxy settings: the
    # listener on this host is never reached through one
    os.environ["no_proxy"] = ",".join(x for x in (os.environ.get("no_proxy", ""), "127.0.0.1", "localhost") if x)
    listener = OtlpListener()
    export_path = os.path.join(fdir, "telemetry.jsonl")
    restart_cfg = Config(data_dir=root, bind="127.0.0.1:0", device="cuda", chaos_enabled=True,
                         export_path=export_path, export_url=listener.url)
    t0 = time.monotonic()
    server = Server(restart_cfg)
    server.open()
    try:
        try:
            addr = server.address()
            base = _device_counters(server, metrics)
            recalculate_caches(addr)
            restart_q = 0
            for items in families.values():
                http_sequential(addr, items, cpu_answers, cold=True)
                restart_q += len(items)
            out["restart"] = {"queries": restart_q, "seconds": time.monotonic() - t0}
            log(f"server: restart {out['restart']}")
            _require_clean(server, metrics, base, "restart")
            # the faults arm: a child process that meets a real sticky
            # CUDA error (beside the rest: it reads the data only), fault
            # windows, a profile capture, device memory telemetry (after
            # the child: its ballast takes the card), the journal and the
            # exports
            t_faults = time.monotonic()
            child = StickyChild(root, [(q, cpu_answers[(i, q)]) for i, q in families["dense_topn"][:1]], fdir)
            try:
                faults: dict = {"windows": fault_windows(server, addr, cpu_answers, probe_items, stats_items,
                                                         lambda: sum(k.launches for k in cuda.KERNELS))}
                faults["capture"] = capture_arm(addr, cpu_answers,
                                                [families["dense_topn"][0], families["tall_chain"][0]],
                                                stats_items, os.path.join(fdir, "profile"),
                                                launches=lambda: {k.name: k.launches for k in cuda.KERNELS})
                log(f"faults: capture {faults['capture']}")
            finally:
                faults_child = child.result()
            faults["sticky_child"] = faults_child
            log(f"faults: sticky child {faults_child}")
            faults["telemetry"] = telemetry_arm(server, addr, metrics, cpu_answers, families["tall_topn"][:2])
            log(f"faults: telemetry {faults['telemetry']}")
            c = HttpClient(*addr)
            try:
                # one traced query: its span goes to the exporter
                index, q = families["tall_chain"][0]
                st, _, body = c.request("POST", f"/index/{index}/query?profile=true&cache=false", q.encode())
                if st != 200 or json.loads(body)["results"] != cpu_answers[(index, q)]:
                    raise AssertionError(f"server: the traced query: HTTP {st}: {body[:300]!r}")
                first_seq = out["journal"]["first_server_last_seq"]
                since = _json_get(c, f"/debug/events?since={first_seq}")["events"]
            finally:
                c.close()
            kinds = {}
            for e in since:
                kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
            windows = [e["seq"] for e in since if e["kind"] == "chaos.window"]
            out["journal"].update(restart_first_seq=since[0]["seq"] if since else None, restart_kinds=kinds,
                                  chaos_window_seqs=windows)
            if not since or since[0]["seq"] <= first_seq or not windows or not kinds.get("device.fault"):
                raise AssertionError(f"server: the restart's journal does not continue the first's: {out['journal']}")
        finally:
            server.close()
        faults["export"] = export_check(export_path, listener)
        log(f"faults: export {faults['export']}")
    finally:
        listener.close()
    faults["seconds"] = time.monotonic() - t_faults
    out["faults"] = faults
    # every fallback of the phase is the OOM check's cooldown read or a
    # read the fault windows sent to the CPU leg
    out["device_down_fallbacks"] = metrics.snapshot().get(metrics.EXECUTOR_DEVICE_DOWN_FALLBACK, 0) - fb0
    expected = out["oom"]["cooldown_fallbacks"] + faults["windows"]["fallbacks"]
    if out["device_down_fallbacks"] != expected:
        raise AssertionError(f"server: {out['device_down_fallbacks']} device-down fallbacks, "
                             f"{out['oom']['cooldown_fallbacks']} of them in the OOM check's cooldown and "
                             f"{faults['windows']['fallbacks']} in the fault windows")
    # the CLI: python -m pilosa_tpu_torch server, /status, one TopN, SIGINT
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    errlog = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "--device", "cuda",
         "-b", f"127.0.0.1:{port}", "-d", root],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.DEVNULL, stderr=errlog,
    )

    def stderr_tail() -> str:
        errlog.seek(0)
        return errlog.read()[-2000:]

    try:
        while True:
            try:
                c = HttpClient("127.0.0.1", port, timeout=60)
                st, _, body = c.request("GET", "/status")
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() - t0 > 300:
                    raise AssertionError(f"server (CLI): never answered: {stderr_tail()!r}")
                time.sleep(0.25)
        status = json.loads(body)
        if st != 200 or status["device"]["type"] != "cuda" or not status["device"]["healthy"]:
            raise AssertionError(f"server (CLI): /status {st} {status}")
        index, q = families["dense_topn"][0]
        c.query(index, q, cpu_answers[(index, q)])
        # a new process reads the same durable journal
        seen = [e["seq"] for e in _json_get(c, "/debug/events?kind=chaos.window")["events"]]
        faults_seen = len(_json_get(c, "/debug/events?kind=device.fault")["events"])
        c.close()
        out["cli"] = {"status": status, "ready_s": time.monotonic() - t0,
                      "journal": {"chaos_window_seqs": seen, "device_fault_records": faults_seen}}
        if not set(out["journal"]["chaos_window_seqs"]) <= set(seen) or not faults_seen:
            raise AssertionError(f"server (CLI): the durable journal lacks the restart's records: {out['cli']['journal']}")
        log(f"server: CLI ready and answered in {out['cli']['ready_s']:.1f} s")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError("server (CLI): did not exit within 120 s of SIGINT")
    if rc != 0:
        raise AssertionError(f"server (CLI): exit code {rc} after SIGINT: {stderr_tail()!r}")
    out["cli"]["exit_code"] = rc
    return out


def keys_column_prefix(n: int, partitions: int, width: int = SW) -> tuple[int, np.ndarray, np.ndarray]:
    """Column keys ``u%07d`` for j < ``n`` as the translator mints them in
    key order: partition fnv64a(key) % ``partitions``, id = ordinal *
    partitions + partition + 1 (translate/translator.py). Returns the
    length of the longest prefix whose ids all lie below ``width`` (one
    shard), every key's id and partition."""
    m = np.frombuffer("".join(f"u{j:07d}" for j in range(n)).encode(), dtype=np.uint8).reshape(n, 8)
    h = np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    for j in range(m.shape[1]):
        h = (h ^ m[:, j].astype(np.uint64)) * prime
    part = (h % np.uint64(partitions)).astype(np.int64)
    ordinal = np.empty(n, dtype=np.int64)
    for p in range(partitions):
        sel = part == p
        ordinal[sel] = np.arange(int(sel.sum()))
    ids = ordinal * partitions + part + 1
    over = np.nonzero(ids >= width)[0]
    return (int(over[0]) if over.size else n), ids, part


def keys_fresh_column(k: int, ids: np.ndarray, part: np.ndarray, partitions: int, width: int = SW) -> tuple[int, int]:
    """(j, id) of the first key past the prefix ``u%07d``[:k] whose id,
    minted next, still lies below ``width``."""
    counts = np.bincount(part[:k], minlength=partitions)
    for j in range(k + 1, len(part)):
        nid = int(counts[part[j]]) * partitions + int(part[j]) + 1
        if nid < width:
            return j, nid
    raise AssertionError("keys: no fresh column key fits the shard")


def keys_queries() -> dict[str, list[str]]:
    """The keys phase's query families, all by key."""
    def row(r: int) -> str:
        return f'Row(likes="item-{r:04d}")'

    def four(r: int) -> str:
        return ", ".join(row(r + i) for i in range(4))

    attr = 'attrName="category", attrValues=[' + ", ".join(f'"{c}"' for c in KEYS_FILTER) + "]"
    return {
        "keyed_topn": [f"TopN(likes, {row(r)}, n=10)" for r in (1, 2, 3, 4)],
        "attr_topn": [f"TopN(likes, {row(r)}, n=10, {attr})" for r in (5, 6, 7, 8)],
        # four leaves: 64 containers, the auto policy's crossover
        "keyed_chains": [f"Count(Intersect({four(10)}))", f"Count(Union({four(20)}))",
                         f"Count(Difference({four(30)}))", f"Count(Intersect(Union({four(40)}), {four(50)}))"],
        "row_column_attrs": [row(60), row(61)],
        "multi_call": [
            f"Count(Intersect({four(70)}))TopN(likes, {row(74)}, n=5)"
            f"Count(Union({four(80)}))TopN(likes, {row(84)}, n=5, {attr})"
        ],
    }


def _keys_post(c: "HttpClient", path: str, body) -> dict:
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    st, _, resp = c.request("POST", path, data)
    if st != 200:
        raise AssertionError(f"keys: POST {path}: HTTP {st}: {resp[:300]!r}")
    return json.loads(resp or b"{}")


def _column_attrs(store, rows) -> list:
    """The ``columnAttrs`` block of a query's answer (server/api.py)."""
    cols = sorted({int(c) for r in rows if hasattr(r, "columns") for c in r.columns()})
    return [{"id": c, "attrs": a} for c in cols if (a := store.attrs(c))]


def run_keys(data_dir: str, card: str, device: str = "cuda") -> dict:
    """A keyed index on the port's server (default Config on ``cuda``),
    fresh: every column key minted through the keyed import route, the
    rest of the bits by id through the plain import (``API.import_bits``),
    row and column
    attributes, then keyed TopN, attribute-filtered TopN, keyed chains,
    Row with columnAttrs and a fused multi-call request over HTTP, each
    answer against the CPU leg on the same holder and translator; last
    a keyed Set of a new column key, read back. (``device="cpu"`` runs
    it on the kernels' plain versions, for its tests.)"""
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.server import Config, Server
    from pilosa_tpu_torch.utils import metrics

    cfg = Config(data_dir=data_dir, bind="127.0.0.1:0", device=device)
    out: dict = {"card": card, "config": {"device": cfg.device, "device_policy": cfg.device_policy,
                                          "translate_partitions": cfg.translate_partitions}}
    t_phase = time.monotonic()
    k, ids, part = keys_column_prefix(KEYS_COLUMNS + 4096, cfg.translate_partitions)
    k = min(k, KEYS_COLUMNS)
    keys = [f"u{j:07d}" for j in range(k)]
    server = Server(cfg)
    server.open()
    c = HttpClient(*server.address())
    cpu = None
    try:
        base = _device_counters(server, metrics)
        _keys_post(c, "/index/users", {"options": {"keys": True}})
        _keys_post(c, "/index/users/field/likes", {"options": {"keys": True}})
        # every column key minted by the keyed import: one bit a key, the
        # row keys cycling (all 1024 minted by the first batch)
        t0 = time.monotonic()
        for lo in range(0, k, KEYS_BATCH):
            hi = min(k, lo + KEYS_BATCH)
            _keys_post(c, "/index/users/field/likes/import?timeout=600", {
                "rowKeys": [f"item-{j % KEYS_ROWS:04d}" for j in range(lo, hi)],
                "columnKeys": keys[lo:hi],
            })
        out["mint_s"] = time.monotonic() - t0
        ts = server.translate_store
        got = np.asarray(ts.translate_columns_to_ids("users", keys, create=False), dtype=np.int64)
        if not np.array_equal(got, ids[:k]):
            raise AssertionError("keys: the translator's column ids differ from the partition plan's")
        row_ids = ts.translate_rows_to_ids("users", "likes", [f"item-{r:04d}" for r in range(KEYS_ROWS)], create=False)
        if row_ids != list(range(1, KEYS_ROWS + 1)):
            raise AssertionError(f"keys: row ids {row_ids[:4]}..., not 1..{KEYS_ROWS}")
        # the rest of the bits by id through the plain import (the API's
        # import_bits, in process: the HTTP route's JSON coding of ~15.7 M
        # ids took 40.8-72.6 s of the phase), with the ids the server's
        # translator gave: DENSE_DRAWS draws a row
        rng = np.random.default_rng(KEYS_SEED)
        t0 = time.monotonic()
        bits = k
        for r0 in range(0, KEYS_ROWS, KEYS_IMPORT_ROWS):
            rs, cs = [], []
            for r in range(r0, min(KEYS_ROWS, r0 + KEYS_IMPORT_ROWS)):
                cols = got[np.unique(rng.integers(0, k, size=DENSE_DRAWS))]
                rs.append(np.full(cols.size, row_ids[r], dtype=np.int64))
                cs.append(cols)
            rs, cs = np.concatenate(rs), np.concatenate(cs)
            bits += int(cs.size)
            server.api.import_bits("users", "likes", rs, cs)
        out["import_s"] = time.monotonic() - t0
        # attributes: every row a category and a rank, the first 65,536
        # columns a segment
        t0 = time.monotonic()
        _keys_post(c, "/index/users/query", "".join(
            f'SetRowAttrs(likes, {rid}, category="cat-{rid % KEYS_CATEGORIES:02d}", rank={rid})'
            for rid in row_ids).encode())
        for lo in range(0, min(KEYS_COLUMN_ATTRS, k), KEYS_ATTR_BATCH):
            _keys_post(c, "/index/users/query", "".join(
                f'SetColumnAttrs({int(col)}, segment="s{int(col) % 8}")'
                for col in got[lo:lo + KEYS_ATTR_BATCH]).encode())
        out["attrs_s"] = time.monotonic() - t0
        recalculate_caches(server.address())
        frag = server.holder.fragment("users", "likes", "standard", 0)
        out["data"] = {"column_keys": k, "row_keys": KEYS_ROWS, "bits": int(frag.storage.count()),
                       "imported_bits": bits, "shards": server.holder.index("users").max_shard() + 1,
                       "matrix_bytes": KEYS_ROWS * SW // 8}
        if out["data"]["shards"] != 1:
            raise AssertionError(f"keys: {out['data']['shards']} shards, not one")
        log(f"keys: minted {k} column keys in {out['mint_s']:.1f} s, imported {bits} bits in "
            f"{out['import_s']:.1f} s, attributes in {out['attrs_s']:.1f} s")
        # the CPU leg on the same holder and translator
        cpu = Executor(server.holder, device=device, device_policy="never", translate_store=ts)
        idx = server.holder.index("users")
        families = keys_queries()
        answers = {}
        t0 = time.monotonic()
        for items in families.values():
            for q in items:
                res = cpu.execute("users", q)
                answers[q] = (wire(res), _column_attrs(idx.column_attrs, res))
        out["cpu_leg_s"] = time.monotonic() - t0
        if not all(len(answers[q][0][0]) == 10 for q in families["keyed_topn"]):
            raise AssertionError("keys: a keyed TopN did not give 10 pairs")
        cats = {"cat-03": 3, "cat-11": 11}
        for q in families["attr_topn"]:
            pairs = answers[q][0][0]
            rids = ts.translate_rows_to_ids("users", "likes", [p["key"] for p in pairs], create=False)
            if len(pairs) != 10 or any(rid % KEYS_CATEGORIES not in cats.values() for rid in rids):
                raise AssertionError(f"keys: {q} answered {pairs}")
        for q in families["row_column_attrs"]:
            if not answers[q][1]:
                raise AssertionError(f"keys: {q} has no column attributes")
        rates = {}
        for family, items in families.items():
            lat = []
            attrs = family == "row_column_attrs"
            path = "/index/users/query?cache=false" + ("&columnAttrs=true" if attrs else "")
            for _ in range(KEYS_REPEATS):
                for q in items:
                    t1 = time.perf_counter()
                    st, _, body = c.request("POST", path, q.encode())
                    lat.append(time.perf_counter() - t1)
                    resp = json.loads(body) if st == 200 else {"status": st, "body": body[:300]}
                    want, want_attrs = answers[q]
                    if resp.get("results") != want or (attrs and resp.get("columnAttrs") != want_attrs):
                        raise AssertionError(f"keys: {q} answered {str(resp)[:300]}, CPU leg {str(want)[:300]}")
            rates[family] = {"queries": len(lat), "p50_ms": statistics.median(lat) * 1e3}
        out["families"] = rates
        out["fusion"] = server.executor.fuser.stats()
        # an acknowledged keyed write is read back, by key
        j, nid = keys_fresh_column(k, ids, part, cfg.translate_partitions)
        new_key = f"u{j:07d}"
        qr = 'Row(likes="item-0009")'
        before = cpu.execute("users", f"Count({qr})")[0]
        if _keys_post(c, "/index/users/query", f'Set("{new_key}", likes="item-0009")'.encode())["results"] != [True]:
            raise AssertionError(f"keys: Set({new_key}) was not acknowledged as a change")
        got_row = _keys_post(c, "/index/users/query?cache=false", qr.encode())["results"]
        if got_row != wire(cpu.execute("users", qr)) or new_key not in got_row[0]["keys"]:
            raise AssertionError(f"keys: {new_key} not read back in {qr}")
        if cpu.execute("users", f"Count({qr})")[0] != before + 1 or ts.translate_columns_to_ids(
                "users", [new_key], create=False) != [nid]:
            raise AssertionError(f"keys: {new_key} minted or counted wrong")
        out["write_read_back"] = {"key": new_key, "id": nid}
        _require_clean(server, metrics, base, "keys")
        out["translate"] = {k2: v for k2, v in ts.stats().items() if k2 != "stores"}
    finally:
        if cpu is not None:
            cpu.close()
        c.close()
        server.close()
    out["seconds"] = time.monotonic() - t_phase
    log("keys: " + ", ".join(f"{f} p50 {r['p50_ms']:.2f} ms" for f, r in out["families"].items()))
    return out


PATH_OF = {
    "dense_scores": "dense_tall",
    "sparse_stacked_scores": "dense_tall",
    "tree_count": "dense_tall",
    "groupby_reduce": "ssb",
    "bsi_range": "ssb",
    "expand_blocks": "tiered",
    "word_delta": "writes",
    "bsi_minmax": "ssb",
    "distinct_presence": "ssb",
    "bsi_percentile": "ssb",
}


# sources whose build must report no spill: their design keeps per-thread
# state (K10's planes, K9's accumulators, K5's b, k1 and k2, K8's
# consider and step planes, K2's MMA accumulators and tile rows) in
# registers; K2 (sparse_stacked_scores) is built from sparse_scores.cu
NO_SPILL = ("bsi_percentile", "distinct_presence", "bsi_range", "bsi_minmax", "sparse_scores")


def spill_bytes(ptxas: str) -> int:
    """The spill store and load bytes ptxas -v reports, summed over a
    source's kernels."""
    return sum(int(a) + int(b) for a, b in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ptxas))


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
    from pilosa_tpu_torch.executor.executor import ValCount
    from pilosa_tpu_torch.ops import cuda

    t_start = time.monotonic()
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. build: one nvcc process a source, waited on by a thread while
    # the data is written
    build_box: dict = {}

    def build_kernels() -> None:
        t1 = time.monotonic()
        try:
            build_box["log"] = cuda.build_kernels()
        except BaseException as e:  # re-raised once the data is written
            build_box["error"] = e
        build_box["seconds"] = time.monotonic() - t1

    builder = threading.Thread(target=build_kernels)
    builder.start()

    root = tempfile.mkdtemp(prefix="pilosa_tpu_torch_smoke_")
    holder = dev = cpu = None
    try:
        # 2. data, and the ssb oracle while the workers write
        t0 = time.monotonic()

        def make_oracle():
            t1 = time.monotonic()
            o = SsbOracle(ValCount)
            ssb_workload(o)
            return o, time.monotonic() - t1

        try:
            built, (ssb, ssb_oracle_s) = build_data(
                root, DENSE_ROWS, TALL_SHARDS, TAIL_ROWS_PER_SHARD, SSB_ROWS, during=make_oracle
            )
        finally:
            builder.join()
        log(f"data written: {built}; ssb oracle: {len(ssb.queries)} answers in {ssb_oracle_s:.1f} s")
        if "error" in build_box:
            raise build_box["error"]
        build, build_s = build_box["log"], build_box["seconds"]
        for name, ent in build.items():
            report = [ln for ln in ent["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
            log(f"built {name} in {ent['seconds']:.1f} s: " + " | ".join(report))
        for name in NO_SPILL:
            if build[name]["cached"]:
                log(f"{name}: built before this run, its spills not checked")
            elif spill_bytes(build[name]["ptxas"]):
                raise AssertionError(f"{name}: ptxas reports {spill_bytes(build[name]['ptxas'])} spill bytes")
        card = card_line()
        print(card, flush=True)
        card_info = Card()
        log(f"kernels built in {build_s:.1f} s on {kind}, {card_info.sms} SMs, SM clock {card_info.sm_clock_hz / 1e6:.0f} MHz")
        holder = pilosa_tpu_torch.holder_from_dir(root)
        for index in ("dense", "tall"):
            for frag in holder.view(index, "f", "standard").fragments.values():
                frag.ensure_open()
        data_s = time.monotonic() - t0

        dense_qs = dense_queries(DENSE_ROWS)
        tall_topn, tall_chains = tall_queries()
        dev = pilosa_tpu_torch.Executor(holder, device=device, device_policy="always")
        cpu = pilosa_tpu_torch.Executor(holder, device_policy="never")

        # 3. the CPU leg's answers (dense and tall)
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

        # 4. each path, counts set to 0 just before it and read just after
        rec = Recorder(cuda)
        from pilosa_tpu_torch.utils import metrics

        watch = FusedLaunchWatch()
        SMOKE_HELD.extend((rec, watch))
        launches: dict = {}
        batched: dict = {}
        launches_by_q: dict = {}
        path_s: dict = {}

        def run_path(path: str, fn):
            rec.path = path
            KEEP_ON_HOST["on"] = path == "server"
            cuda.reset_launches()
            fb0 = fallback_counts(metrics)
            t0 = time.monotonic()
            out = fn()
            torch.cuda.synchronize()
            if path != "server":  # its OOM check degrades once, on purpose
                require_on_card(metrics, fb0, path)
            launches[path] = {k.name: k.launches for k in cuda.KERNELS}
            batched[path] = {k.name: k.batched_launches for k in cuda.KERNELS}
            launches_by_q[path] = {k.name: dict(sorted(k.launches_by_q.items())) for k in cuda.KERNELS}
            rec.path = None
            KEEP_ON_HOST["on"] = False
            for held in (rec, watch):
                held.offload()
            path_s[path] = time.monotonic() - t0
            log(f"{path} in {path_s[path]:.1f} s; launches {launches[path]}")
            return out

        phases = run_path("dense_tall", lambda: main_path(dev, dense_qs, tall_topn, tall_chains, oracle))
        phases["ssb"] = run_path("ssb", lambda: run_ssb(dev, ssb))
        phases["ssb"]["data_build_s"] = built["ssb_build_s"]
        # multi-call requests over the staged tall and ssb data, the fuser
        # off and on in turns
        phases["fusion"] = run_path("fusion", lambda: run_fusion(dev, ssb, tall_topn, tall_chains, oracle, watch))

        # the server over the same directory, before any write changes
        # dense or tall, so the CPU leg's answers (oracle) and numpy's
        # hold for it; the server's own writes are cleared again. The
        # in-process executors and holder close first, and reopen after.
        families = server_families(dense_qs, tall_topn, tall_chains, ssb)
        server_answers = {
            (index, q): wire(ssb.answers[q] if index == "ssb" else oracle[q])
            for items in families.values()
            for index, q in items
        }
        dev.stager.clear()
        for ex in (dev, cpu):
            ex.close()
        holder.close()
        dev = cpu = holder = None
        # the server starts with nothing cached by the allocator, as in a
        # process of its own
        torch.cuda.empty_cache()
        phases["server"] = run_path("server", lambda: run_server(root, server_answers, families, phases, card))
        for name in SERVER_KERNELS:
            if launches["server"][name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the server path")
        # a keyed index on a server of its own, then the card is the
        # in-process phases' again
        phases["keys"] = run_path("keys", lambda: run_keys(os.path.join(root, KEYS_DIR), card))
        for name in KEYS_KERNELS:
            if launches["keys"][name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the keys path")
        torch.cuda.empty_cache()
        holder = pilosa_tpu_torch.holder_from_dir(root)
        for index in ("dense", "tall"):
            for frag in holder.view(index, "f", "standard").fragments.values():
                frag.ensure_open()
        dev = pilosa_tpu_torch.Executor(holder, device=device, device_policy="always")
        cpu = pilosa_tpu_torch.Executor(holder, device_policy="never")
        # stage dense and tall again before the writes phase, as the
        # phases before the server left them
        rec.path = "restage"
        run_sequential(dev, "dense", dense_qs, oracle)
        run_sequential(dev, "tall", tall_topn + tall_chains, oracle)
        rec.path = None
        phases["writes"] = run_path("writes", lambda: run_writes(dev, cpu))
        t0 = time.monotonic()
        tier_data = build_tier(holder)
        tier_build_s = time.monotonic() - t0
        log(f"tier index imported in {tier_build_s:.1f} s: {tier_data}")
        phases["tiered"] = run_path("tiered", lambda: run_tiered(holder, cpu, device))
        phases["tiered"]["data"] = tier_data

        for name, path in PATH_OF.items():
            if launches[path][name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the {path} path")
        if batched["dense_tall"]["dense_scores"] <= 0:
            raise AssertionError("dense_scores never launched with Q > 1 under concurrency")
        if rec.groupby_multi_with_planes <= 0:
            raise AssertionError("groupby_reduce never launched with K > 1 and P > 0")
        if not all(rec.expand_kinds.values()):
            raise AssertionError(f"expand_blocks launches by input kind on its path: {rec.expand_kinds}")
        mm_run = phases["ssb"]["minmax_queries_run"]
        if launches["ssb"]["bsi_minmax"] != mm_run:
            raise AssertionError(
                f"bsi_minmax launched {launches['ssb']['bsi_minmax']} times on ssb for {mm_run} Min/Max queries"
            )
        pct_run = phases["ssb"]["percentile_queries_run"]
        if launches["ssb"]["bsi_percentile"] != pct_run:
            raise AssertionError(
                f"bsi_percentile launched {launches['ssb']['bsi_percentile']} times on ssb for {pct_run} Percentile queries"
            )
        if launches["ssb"]["tree_count"] > SSB_TREE_COUNT_MAX:
            raise AssertionError(
                f"tree_count launched {launches['ssb']['tree_count']} times on ssb (> {SSB_TREE_COUNT_MAX})"
            )
        if rec.expand_widest != FIRST_CHUNK_ROWS * SW // 32:
            raise AssertionError(
                f"expand_blocks' widest tiered launch wrote {rec.expand_widest} words, "
                f"not the {FIRST_CHUNK_ROWS}-row chunk's"
            )

        # 5. each kernel against its plain version, at its main-path arguments
        own = {name: launches[path][name] for name, path in PATH_OF.items()}
        own_batched = {name: batched[path][name] for name, path in PATH_OF.items()}
        sparse_q_launches: dict = {}
        for by_q in launches_by_q.values():
            for q, n in by_q["sparse_stacked_scores"].items():
                sparse_q_launches[q] = sparse_q_launches.get(q, 0) + n
        kernels = check_kernels(rec, own, own_batched, device, card_info, sparse_q_launches)
        phases["fusion"]["stacked_mat"] = stacked_mat_row(
            watch, torch.zeros(64 << 20, dtype=torch.int32, device=device), card_info
        )
        phases["fusion"]["fetches_all_paths"] = watch.fetches
        for row in kernels:
            row["path"] = PATH_OF[row["name"]]
            row["launches_by_path"] = {path: launches[path][row["name"]] for path in launches}
            row["launches_by_q_by_path"] = {path: launches_by_q[path][row["name"]] for path in launches_by_q}
            if row["name"] == "word_delta":
                row["launches_by_route"] = phases["writes"]["refreshes_by_route"]
                copy = row["copy_route"]
                phases["writes"]["word_delta_ms_by_route"] = {
                    "in_place": row["ms"],
                    "copied": copy["ms"] if copy is not None else None,
                }

        n_dense = len(dense_qs) * (2 + CLIENTS * CONCURRENT_PASSES)
        n_tall = 2 * len(tall_topn) + (2 + CLIENTS) * len(tall_chains)
        n_ssb = 2 * len(ssb.queries)
        w = phases["writes"]
        n_writes = sum(w[k]["reads"] + w[k]["writes"] for k in ("sequential", f"concurrent_c{CLIENTS}"))
        n_writes += w["reads_checked_after"]
        n_tiered = phases["tiered"]["1x"]["queries"] + phases["tiered"]["3x"]["queries"]
        phases.update(
            {
                "card": card,
                "kind": kind,
                "reduced": {
                    "tall.rows_per_shard": {
                        "from": FULL_ROWS_PER_SHARD,
                        "to": TAIL_ROWS_PER_SHARD,
                    },
                    "writes.client_ops": {
                        "from": WRITES_CLIENT_OPS_BENCH,
                        "to": WRITES_CLIENT_OPS,
                    },
                    # the ids of 16 partitions run past 2^20: the keys whose
                    # ids fit one shard
                    "keys.column_keys": {
                        "from": KEYS_COLUMNS,
                        "to": phases["keys"]["data"]["column_keys"],
                    },
                },
                "launches_per_query": {
                    "dense_scores": launches["dense_tall"]["dense_scores"] / n_dense,
                    "sparse_stacked_scores": launches["dense_tall"]["sparse_stacked_scores"]
                    / (2 * len(tall_topn)),
                    "tree_count": launches["dense_tall"]["tree_count"] / ((2 + CLIENTS) * len(tall_chains)),
                    "groupby_reduce": launches["ssb"]["groupby_reduce"] / n_ssb,
                    "bsi_range": launches["ssb"]["bsi_range"] / n_ssb,
                    "expand_blocks": launches["tiered"]["expand_blocks"] / n_tiered,
                    "word_delta": launches["writes"]["word_delta"] / n_writes,
                    "bsi_minmax": launches["ssb"]["bsi_minmax"] / phases["ssb"]["minmax_queries_run"],
                    "distinct_presence": launches["ssb"]["distinct_presence"] / n_ssb,
                    "bsi_percentile": launches["ssb"]["bsi_percentile"] / pct_run,
                },
                "launches_by_path": launches,
                # K2's launches by batch width on each path (ROADMAP B8's K2 at Q = 8)
                "sparse_stacked_scores_launches_by_q": {
                    path: by_q["sparse_stacked_scores"] for path, by_q in launches_by_q.items()
                },
                "groupby_launches_k_gt_1_p_gt_0": rec.groupby_multi_with_planes,
                "expand_launches_by_input_kind": rec.expand_kinds,
                "expand_widest_tiered_words": rec.expand_widest,
                "dense_queries_run": n_dense,
                "tall_queries_run": n_tall,
                "ssb_queries_run": n_ssb,
                "writes_operations_run": n_writes,
                "tiered_queries_run": n_tiered,
                "seconds": {
                    "build": build_s,
                    "data": data_s,
                    "ssb_oracle": ssb_oracle_s,
                    "cpu_leg": oracle_s,
                    "main_path": path_s["dense_tall"],
                    "ssb_path": path_s["ssb"],
                    "writes_path": path_s["writes"],
                    "tier_build": tier_build_s,
                    "tiered_path": path_s["tiered"],
                    "server_path": path_s["server"],
                    "keys_path": path_s["keys"],
                    "fusion_path": path_s["fusion"],
                    **built,
                },
            }
        )
        stats = phases["ssb"][STATS + "_parts"]
        print(json.dumps({"ssb_stats": {
            part: {"p50_ms": r["p50_ms"], "qps": r["qps"], "launches": r["launches"]}
            for part, r in stats.items()
        }}), flush=True)
        srv = phases["server"]
        print(json.dumps({"phases.server": {
            "card": srv["card"],
            "families": srv["families"],
            "pipeline": srv["pipeline"],
            "health": srv["health"],
            "governor": srv["governor"],
            "oom_recovery": srv["oom_recovery"],
            "oom_check": srv["oom"],
            "device_down_fallbacks": srv["device_down_fallbacks"],
            "fusion": srv["fusion"],
            "plan_cache": srv["plan_cache"],
            "journal": srv["journal"],
            "faults": srv["faults"],
            "cli_journal": srv["cli"]["journal"],
            "launches": launches["server"],
        }}), flush=True)
        keys = phases["keys"]
        print(json.dumps({"phases.keys": {
            "card": keys["card"],
            "seconds": {"mint": keys["mint_s"], "import": keys["import_s"], "attrs": keys["attrs_s"],
                        "cpu_leg": keys["cpu_leg_s"], "path": path_s["keys"]},
            "families": keys["families"],
            "data": keys["data"],
            "fusion": keys["fusion"],
            "write_read_back": keys["write_read_back"],
            "launches": launches["keys"],
        }}), flush=True)
        fus = phases["fusion"]
        print(json.dumps({"phases.fusion": {
            "card": card,
            "requests": {k: v for k, v in fus.items() if isinstance(v, dict) and "fused" in v},
            "plan_cache_http": srv["plan_cache"],
            "stacked_mat": fus["stacked_mat"],
            "bypasses": fus["fuser"]["bypasses"],
            "launches": launches["fusion"],
        }}), flush=True)
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
    if len(sys.argv) == 4 and sys.argv[1] == "--sticky-child":
        sticky_child(sys.argv[2], sys.argv[3])
    sys.exit(main())
