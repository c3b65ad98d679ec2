#!/usr/bin/env python3
"""Time kernels of checkouts of the port in turns on one NVIDIA card.

Run from the root of a checkout:

    python3 kernel_ab_probe.py [--only PREFIX[,PREFIX...]] DIR [DIR ...]

Each DIR is the root of a checkout of the repository ("." is this one),
for example a parent commit unpacked with ``git archive`` into a
git-ignored directory. The arms run one after another in the order given,
so ``A B B A`` pairs each arm's runs around the other's. Each arm runs in
a process of its own and imports that checkout's ``pilosa_tpu_torch``
(its kernels built from its sources), then times its ``ops.cuda``
wrappers on the same seeded inputs, drawn once by this process:

  chain        the tree count (K3): 4 coalesced Count(chain) queries of
               the tall index's Union-of-Intersects shape, 5 leaves each
               over 12 distinct 64 x 32768-word stacks (the tall chains'
               widest launch);
  one          the tree count of one 32768-word row (its most launched
               shape);
  dense_q1/4/8/32 the dense scorer (K1) with Q = 1, 4, 8, 32 sources against a
               4096 x 32768-word matrix, every bit set with probability
               1/64 (1.56 %, the dense workload's density);
  groupby_q32  the GroupBy kernel (K4) at SSB Q3.2's launch: customer city
               x supplier city x year (10 x 10 x 6 groups) under
               c_nation = s_nation = UNITED STATES, with lo_revenue's 24
               planes and its not-null plane, over 58 shards;
  groupby_count_only  the count-only panel GroupBy(Rows(c_region),
               Rows(s_region)): 25 groups, no filter, no planes;
  sum          the one-group launch of Sum(field=lo_revenue): 25 planes;
  groupby_nonexclusive  the dense, non-exclusive shape ``chip_smoke.py``
               also holds: two set-field dimensions of 8 rows, each bit
               set with probability 3/8 (a column in about 3 rows of each),
               lo_revenue's 25 planes, no filter, 58 shards: every group
               set at nearly every word;
  expand_widest the expansion (K6) of the tiered phase's widest launch:
               the container payloads of the tier index's first 128 rows
               (``chip_smoke.tier_bits``: array, run and bitmap
               containers) into 4,194,304 words; expand_positions /
               expand_runs / expand_dense the same rows' payloads of one
               kind alone. A checkout whose kernel takes binned input
               gets it binned (``ops.bin_expand_inputs``) before the
               timing, as the stager ships it;
  delta_refresh the word-delta kernel (K7) as the stager runs it on a
               refresh of the dense 4096 x 32768-word chunk with 64
               updated words: in place where the checkout has that route
               (``cuda.word_delta_``), else a copy and the patch;
  delta_copy   the copy route (``cuda.word_delta``) on the same input;
  fill_16mib   a yardstick, not a kernel of the port: PyTorch's
               ``zero_`` of a 4,194,304-word tensor, the stores alone of
               expand_widest's output;
  pct_ssb      Percentile(field=lo_revenue, nth=95) over the 58 shards:
               the percentile search (K10, ``cuda.bsi_percentile``; a
               checkout without it runs ``ops.bsi_percentile_batched``,
               its torch ops and tree counts) on lo_revenue's 25 planes;
  pct_ssb_filtered the same under Q3.2's filter (nth=50);
  pct_step_floor the same search over one shard's first 1024 words (a
               strided view of the planes): its bytes are negligible, so
               the time is the launch and its grid-wide steps;
  pct_launch_floor the same view's not-null plane alone (depth 0): the
               launch and the one grid-wide count, so pct_step_floor less
               this is the search's steps;
  pct_global   the search on K10's global route at a fixed shape for every
               arm: 101 shards of 25 random planes (past every checkout's
               on-chip capacity), the not-null plane and a filter each set
               at about 3 of 4 columns, nth=95 (held to a numpy search
               over the same words);
  distinct_ssb_quantity / distinct_ssb_discount / distinct_ssb_discount_brand7
               the Distinct kernel (K9, ``cuda.distinct_presence``) as
               ``chip_smoke.py`` queries it: Distinct(field=lo_quantity)
               (6 bits), Distinct(field=lo_discount) (4 bits), and
               lo_discount under Row(p_brand1=7), over the 58 shards;
  range_ssb    the range kernel (K5, ``cuda.bsi_range``) at its held
               launch: Range(lo_revenue == x) over the 58 shards, every
               one of the 24 planes and the not-null plane read;
  range_ssb_leaf6 Range(lo_quantity < 25): the not-null plane and 5 of
               lo_quantity's 6 planes, the 6-plane leaf shape that carries
               most of the fusion path's range launches;
  range_pass_floor a program that reads one plane (lo_revenue's bit 23)
               besides the not-null plane: a pass whose bytes are
               small, so the time beyond them is the pass's floor;
  minmax_ssb   Min(field=lo_revenue) per shard (K8, ``cuda.bsi_minmax``)
               over the 58 shards under Q3.2's filter;
  minmax_ssb_unfiltered Max(field=lo_revenue) per shard, no filter;
  minmax_step_floor Min over one shard's first 1024 words (a strided
               view of the planes): the launch and its 24 plane steps;
  sparse_tall_q1 / sparse_tall_q8 / sparse_tall_q32 the block-sparse
               scorer (K2, ``cuda.sparse_stacked_scores``) at the server's
               held bundle: bench_tall.py config 4's 64 shards, each with
               its 32 hot rows (50,000 bits a shard, every container set)
               and 96 singleton rows (one bit) as the TopN chunk's 128
               candidates, laid out as the stager lays them (shard, then
               candidate, then slot: B = 38,912), against Q = 1, 8 and 32
               sources that are hot rows of the same shards, stacked as
               i32[Q, 64, 32768];
  sparse_batch_q8 / sparse_batch_q32 the same through the batch entry
               point (``ops.sparse_intersection_counts_stacked_batch_list``)
               with Q separate source tensors, as the batcher calls it;
  sparse_head_q1 the fused TopN head (``ops.sparse_intersection_counts_
               stacked_mat``, Q = 1, 64 shards x 128 candidates).
               A checkout whose API takes a grouping of the bundle
               (``groups``) gets it (``ops.sparse_groups``) before the
               timing, as the stager stages it with the bundle, and
               its arm line carries ``sparse_group_ms``: the host time
               of making that grouping from the bundle's host arrays.
``--only`` runs the cases whose names start with one of the prefixes
(and draws only their inputs).
The ssb columns are drawn as ``chip_smoke.py`` draws them
(``ssb_columns``) and packed to words with numpy.

Every result must equal a numpy count of the same function. Times are
medians of CUDA-event windows taken with this checkout's
``chip_smoke.time_ms``: L2 flushed by a read and the host's enqueue
outside the window (the tree count also the earlier way, flushed by a
write and the enqueue inside).

Output: the card's name and power limit, one JSON line per arm, and as
the last line a summary of every arm's times in run order. Exits nonzero
if an arm fails or without CUDA.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
LEAF_SHAPE = (64, 32768)
DISTINCT = 12
# the Union-of-Intersects chain over leaves 0-4, and each query's leaves
TREE = ("Union", (("Intersect", (("leaf", 0), ("leaf", 1))), ("Intersect", (("leaf", 2), ("leaf", 3))), ("leaf", 4)))
PICKS = ((0, 1, 2, 3, 4), (0, 5, 6, 3, 7), (8, 1, 9, 3, 10), (0, 11, 2, 3, 4))
ITERS = 30
# host timings of K2's grouping a sparse arm makes (median)
GROUP_ITERS = 9
DENSE_SHAPE = (4096, 32768)
DENSE_QS = (1, 4, 8, 32)
# AND of this many uniform words: each bit set with probability 1/64
DENSE_AND = 6
EXPAND_ROWS = 128
EXPAND_KINDS = ("widest", "positions", "runs", "dense")
DELTA_WORDS = 64
# (filter, nth basis points, shards, words, planes) of the percentile
# cases; a filter of None reads none; planes "all" or "not-null" (depth 0)
PCT_CASES = {
    "pct_ssb": (None, 9500, None, None, "all"),
    "pct_ssb_filtered": ("q32_filt", 5000, None, None, "all"),
    "pct_step_floor": (None, 9500, 1, 1024, "all"),
    "pct_launch_floor": (None, 9500, 1, 1024, "not-null"),
}
PCT_GLOBAL_SHAPE = (101, 25, 32768)
PCT_GLOBAL_NTH = 9500
# (field, p_brand1 row of the filter or None) of the Distinct cases
DISTINCT_CASES = {
    "distinct_ssb_quantity": ("lo_quantity", None),
    "distinct_ssb_discount": ("lo_discount", None),
    "distinct_ssb_discount_brand7": ("lo_discount", 7),
}
# (field, operator, base predicate) of the range cases: the program of
# ``ops.bsi.range_program``; an operator of None reads the one plane named
# by the predicate and keeps the not-null columns that have its bit set
RANGE_CASES = {
    "range_ssb": ("lo_revenue", "==", "x"),
    "range_ssb_leaf6": ("lo_quantity", "<", 24),
    "range_pass_floor": ("lo_revenue", None, 23),
}
# (Min or not, filter or None, shards, words) of the Min/Max cases; None
# shards and words: every shard, whole
MINMAX_CASES = {
    "minmax_ssb": (True, "q32_filt", None, None),
    "minmax_ssb_unfiltered": (False, None, None, None),
    "minmax_step_floor": (True, None, 1, 1024),
}
# bench_tall.py config 4 (bench_tall.py:46-73) as the TopN chunk stages it:
# shards, hot rows a shard (every container set), their bits a shard, the
# singleton candidates that fill the 128-candidate chunk
SPARSE_SHARDS = 64
SPARSE_HOT = 32
SPARSE_HOT_BITS = 50_000
SPARSE_CHUNK = 128
SPARSE_QS = (1, 2, 4, 8, 32)
SPARSE_BATCH_QS = (8, 32)
SPARSE_CASES = tuple(f"sparse_tall_q{q}" for q in SPARSE_QS) + tuple(
    f"sparse_batch_q{q}" for q in SPARSE_BATCH_QS) + ("sparse_head_q1",)
CASES = ("chain", "one") + tuple(f"dense_q{q}" for q in DENSE_QS) + (
    "groupby_q32", "groupby_count_only", "sum", "groupby_nonexclusive") + tuple(
    f"expand_{k}" for k in EXPAND_KINDS) + ("delta_refresh", "delta_copy", "fill_16mib") + tuple(
    PCT_CASES) + ("pct_global",) + tuple(DISTINCT_CASES) + tuple(RANGE_CASES) + tuple(MINMAX_CASES) + SPARSE_CASES


def _smoke():
    """This checkout's chip_smoke.py, whichever port an arm imports."""
    spec = importlib.util.spec_from_file_location("smoke_here", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree_inputs():
    rng = np.random.default_rng(2024)
    pool = [rng.integers(0, 2**32, size=LEAF_SHAPE, dtype=np.uint32) for _ in range(DISTINCT)]
    chain = [
        int(np.bitwise_count((pool[a] & pool[b]) | (pool[c] & pool[d]) | pool[e]).sum())
        for a, b, c, d, e in PICKS
    ]
    return pool, chain, int(np.bitwise_count(pool[0][0]).sum())


def _sparse_words(rng, shape):
    out = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    for _ in range(DENSE_AND - 1):
        out &= rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return out


def _pack(mask, shards: int, sw: int) -> np.ndarray:
    """A bool column mask as u32[shards, sw / 32] words, bit i of word j
    being column 32 j + i of the shard (columns past the end unset)."""
    full = np.zeros(shards * sw, dtype=bool)
    full[: mask.size] = mask
    return np.packbits(full.reshape(shards, sw), axis=1, bitorder="little").view(np.uint32)


def _groupby_oracle(dim_cols, ids, sel, bits):
    """counts[K] and plane_counts[K, P] by numpy over the columns: group
    index in product order (first dimension slowest)."""
    k = 1
    for i in ids:
        k *= len(i)
    idx = np.zeros(int(sel.sum()), dtype=np.int64)
    for col, rows in zip(dim_cols, ids):
        lut = np.full(int(col.max()) + 1, -1, dtype=np.int64)
        lut[list(rows)] = np.arange(len(rows))
        idx = idx * len(rows) + lut[col[sel]]
    counts = np.bincount(idx, minlength=k)
    planes = np.stack([np.bincount(idx, weights=b[sel], minlength=k) for b in bits], axis=1) if bits else np.zeros((k, 0))
    return counts.astype(np.int64), planes.astype(np.int64)


def _nonexclusive(smoke, planes) -> dict:
    """The dense non-exclusive GroupBy case over ``planes`` (u32[S, P, W]):
    its dimension rows and numpy's counts, group index in product order."""
    rng = np.random.default_rng(smoke.NONEXCL_SEED)
    planes = planes[:, : smoke.NONEXCL_PLANES]
    s, _, w = planes.shape
    shape = (smoke.NONEXCL_ROWS, s, w)
    dims = []
    for _ in range(smoke.NONEXCL_DIMS):
        a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
        a &= rng.integers(0, 2**32, size=shape, dtype=np.uint32) | rng.integers(0, 2**32, size=shape, dtype=np.uint32)
        dims.append(a)
    counts, plane_counts = [], []
    for i in range(smoke.NONEXCL_ROWS):
        for j in range(smoke.NONEXCL_ROWS):
            g = dims[0][i] & dims[1][j]
            counts.append(int(np.bitwise_count(g).sum(dtype=np.int64)))
            plane_counts.append(np.bitwise_count(planes & g[:, None, :]).sum(axis=(0, 2), dtype=np.int64))
    return {
        **{f"nx_dim{d}": a for d, a in enumerate(dims)},
        "nx_counts": np.array(counts, dtype=np.int64),
        "nx_plane_counts": np.stack(plane_counts),
    }


def _tier_payloads(smoke):
    """The tier index's first EXPAND_ROWS rows as the stager ships them
    (flat bit space row * SW + column, container order): array positions
    u32[P], runs u32[N, 2] split at container edges, bitmap containers
    u32[D, 2048] at word offsets i32[D]; and by numpy the words each
    case expands to (``ex_words_<kind>``, int32 views)."""
    rows, cols = smoke.tier_bits()
    sw = smoke.SW
    keep = rows < EXPAND_ROWS
    rows, cols = rows[keep].astype(np.int64), cols[keep].astype(np.int64)
    pos, runs, dense, dword = [], [], [], []
    words = {k: np.zeros(EXPAND_ROWS * sw // 32, dtype=np.uint32) for k in EXPAND_KINDS}
    for r in range(EXPAND_ROWS):
        c = np.unique(cols[rows == r]) + r * sw
        kind = "positions" if r % 8 < 6 else ("runs" if r % 8 == 6 else "dense")
        for k in (kind, "widest"):
            np.bitwise_or.at(words[k], c >> 5, (np.uint32(1) << (c & 31).astype(np.uint32)))
        if kind == "positions":
            pos.append(c)
        elif kind == "runs":
            for slot in np.unique(c >> 16):
                part = c[(c >> 16) == slot]
                runs.append((part[0], part[-1]))
        else:
            first = int(c[0] >> 16) * 2048
            dense.append(words["dense"][first : first + 2048].copy())
            dword.append(first)
    out = {
        "ex_pos": np.concatenate(pos).astype(np.uint32),
        "ex_runs": np.array(runs, dtype=np.uint32),
        "ex_dense": np.stack(dense),
        "ex_dword": np.array(dword, dtype=np.int32),
    }
    out.update({f"ex_words_{k}": w.view("<i4") for k, w in words.items()})
    return out


def _expand_case(ops, dev, arrays, kind: str):
    """(launch, expected words) of one expand case on this checkout's
    kernel wrapper, binned beforehand where it takes binned input."""
    import inspect

    import torch

    pos, runs, dense, dword = (arrays[k] for k in ("ex_pos", "ex_runs", "ex_dense", "ex_dword"))
    num_words = EXPAND_ROWS * 32768
    none = np.zeros(0, np.uint32)
    if kind != "widest":
        pos = pos if kind == "positions" else none
        runs = runs if kind == "runs" else np.zeros((0, 2), np.uint32)
        dense, dword = (dense, dword) if kind == "dense" else (np.zeros((0, 2048), np.uint32), np.zeros(0, np.int32))

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a).view("<i4").copy()).to(dev)

    args = [up(pos), up(runs[:, 0]), up(runs[:, 1]), up(dense).view(-1, 2048), up(dword)]
    want = arrays[f"ex_words_{kind}"]
    if "offsets" in inspect.signature(ops.cuda.expand_blocks).parameters:
        *binned, offsets = ops.bin_expand_inputs(*args, num_words)
        return (lambda: ops.cuda.expand_blocks(*binned, num_words, offsets)), want
    return (lambda: ops.cuda.expand_blocks(*args, num_words)), want


def _percentile_oracle(values, nth_bp: int, depth: int) -> list:
    """[bit 0, ..., bit depth-1, count] of the nearest-rank percentile of
    ``values`` (the search's answer; no value: every bit set, count 0)."""
    n = int(values.size)
    if n == 0:
        return [1] * depth + [0]
    q, r = divmod(n, 10000)
    k = min(max(nth_bp * q + (nth_bp * r + 9999) // 10000, 1), n)
    kth = int(np.partition(values, k - 1)[k - 1])
    return [(kth >> i) & 1 for i in range(depth)] + [n]


def _percentile_words_oracle(planes, filt, nth_bp: int) -> list:
    """[bit 0, ..., bit D-1, count] of the nearest-rank search over packed
    u32 words (planes [S, D+1, W], filter [S, W]) by numpy."""
    depth = planes.shape[1] - 1
    consider = planes[:, depth] & filt
    count = int(np.bitwise_count(consider).sum(dtype=np.int64))
    k = nth_bp * (count // 10000) + (nth_bp * (count % 10000) + 9999) // 10000
    k = min(max(k, 1), max(count, 1))
    bits = [0] * depth
    for i in range(depth - 1, -1, -1):
        zeros = consider & ~planes[:, i]
        c = int(np.bitwise_count(zeros).sum(dtype=np.int64))
        if k <= c:
            consider = zeros
        else:
            bits[i] = 1
            consider = consider & planes[:, i]
            k -= c
    return bits + [count]


def range_program_of(bsi, op, pred: int, depth: int):
    """(code, out_sel) of a range case: ``bsi.range_program`` for an
    operator, else the one-plane program that keeps plane ``pred``."""
    if op is not None:
        return bsi.range_program(op, depth, pred)
    code = [bsi.NOP] * depth
    code[pred] = bsi.B_AND
    return tuple(code), bsi.OUT_B


def _range_columns(vals, op, pred: int) -> np.ndarray:
    """The columns a range case keeps, by numpy over the base values."""
    if op is None:
        return (vals >> pred) & 1 == 1
    return {"==": vals == pred, "<": vals < pred}[op]


def _minmax_oracle(vals, sel, is_min: bool, depth: int):
    """(bits i64[S, D], count i64[S]) of each shard's Min (or Max) over the
    selected columns (vals, sel: [S, columns]); a shard with none gives what
    the recurrence gives an empty set (every bit set for Min, none for Max;
    count 0)."""
    shards = vals.shape[0]
    bits = np.zeros((shards, depth), dtype=np.int64)
    count = np.zeros(shards, dtype=np.int64)
    for s in range(shards):
        v = vals[s][sel[s]]
        if v.size == 0:
            bits[s] = 1 if is_min else 0
            continue
        x = int(v.min() if is_min else v.max())
        bits[s] = [(x >> i) & 1 for i in range(depth)]
        count[s] = int((v == x).sum())
    return bits, count


def _presence_words(values, depth: int) -> np.ndarray:
    """The presence bitmap of ``values`` over [0, 2^depth) as int32 words."""
    pres = np.zeros(max(1 << depth, 32), dtype=bool)
    pres[np.unique(values)] = True
    return np.packbits(pres, bitorder="little").view("<u4").view("<i4")


def _sparse_inputs(smoke) -> dict:
    """The K2 cases' bundle, sources and numpy's scores: blocks u32[B,
    2048], block row / slot / shard i32[B], the hot rows' words u32[HOT,
    S, W] (source q is hot row q), and i64[max Q, S x CHUNK] scores."""
    rng = np.random.default_rng(1202)
    sw, slots, cw = smoke.SW, smoke.SW >> 16, 2048
    w = sw // 32
    hot = np.zeros((SPARSE_HOT, SPARSE_SHARDS, w), dtype=np.uint32)
    blocks, rows, bslot, bshard = [], [], [], []
    for s in range(SPARSE_SHARDS):
        for h in range(SPARSE_HOT):
            cols = rng.integers(0, sw, size=SPARSE_HOT_BITS)
            np.bitwise_or.at(hot[h, s], cols >> 5, np.uint32(1) << (cols & 31).astype(np.uint32))
        # hot candidates: every slot; singletons: one bit in one slot
        blocks.append(hot[:, s].reshape(SPARSE_HOT * slots, cw))
        rows.append(np.repeat(np.arange(SPARSE_HOT), slots))
        bslot.append(np.tile(np.arange(slots), SPARSE_HOT))
        single = SPARSE_CHUNK - SPARSE_HOT
        col = rng.integers(0, sw, size=single)
        blk = np.zeros((single, cw), dtype=np.uint32)
        blk[np.arange(single), (col & 0xFFFF) >> 5] = np.uint32(1) << (col & 31).astype(np.uint32)
        blocks.append(blk)
        rows.append(SPARSE_HOT + np.arange(single))
        bslot.append(col >> 16)
        bshard.append(np.full(SPARSE_HOT * slots + single, s))
    blocks = np.concatenate(blocks)
    bshard = np.concatenate(bshard).astype(np.int32)
    bslot = np.concatenate(bslot).astype(np.int32)
    brow = (np.concatenate(rows) + bshard * SPARSE_CHUNK).astype(np.int32)
    num_rows = SPARSE_SHARDS * SPARSE_CHUNK
    want = np.zeros((max(SPARSE_QS), num_rows), dtype=np.int64)
    b64 = blocks.view(np.uint64)
    for q in range(max(SPARSE_QS)):
        src = hot[q % SPARSE_HOT].reshape(SPARSE_SHARDS, slots, cw)[bshard, bslot].view(np.uint64)
        want[q] = np.bincount(brow, weights=np.bitwise_count(b64 & src).sum(axis=1), minlength=num_rows)
    return {"sp_blocks": blocks, "sp_brow": brow, "sp_bslot": bslot, "sp_bshard": bshard,
            "sp_hot": hot, "sp_want": want}


def draw_inputs(smoke, out_dir: str, cases=CASES) -> None:
    """Every input and expected answer of ``cases``, saved as .npy files
    in ``out_dir``."""
    if any(c in SPARSE_CASES for c in cases):
        for name, a in _sparse_inputs(smoke).items():
            np.save(os.path.join(out_dir, name + ".npy"), a)
    if all(c in SPARSE_CASES for c in cases):
        return
    rng = np.random.default_rng(1404)
    mat = _sparse_words(rng, DENSE_SHAPE)
    srcs = _sparse_words(rng, (max(DENSE_QS), DENSE_SHAPE[1]))
    want = np.stack([np.bitwise_count(mat & s).sum(axis=1, dtype=np.int64) for s in srcs])
    np.save(os.path.join(out_dir, "dense_mat.npy"), mat)
    np.save(os.path.join(out_dir, "dense_srcs.npy"), srcs)
    np.save(os.path.join(out_dir, "dense_want.npy"), want)
    del mat

    sw = smoke.SW
    shards = -(-smoke.SSB_ROWS // sw)
    parts = [smoke.ssb_columns(s) for s in range(shards)]
    c = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    del parts
    us = list(range(smoke.UNITED_STATES * 10, smoke.UNITED_STATES * 10 + 10))
    years = list(smoke.SSB_YEARS[:6])
    lo, hi = smoke.SSB_INT_FIELDS["lo_revenue"]
    depth = smoke._bit_depth(hi - lo)
    rev = c["lo_revenue"].astype(np.int64) - lo
    bits = [((rev >> i) & 1).astype(bool) for i in range(depth)] + [np.ones(rev.size, dtype=bool)]
    arrays = {
        "q32_dim0": np.stack([_pack(c["c_city"] == r, shards, sw) for r in us]),
        "q32_dim1": np.stack([_pack(c["s_city"] == r, shards, sw) for r in us]),
        "q32_dim2": np.stack([_pack(c["d_year"] == y, shards, sw) for y in years]),
        "q32_filt": _pack((c["c_nation"] == smoke.UNITED_STATES) & (c["s_nation"] == smoke.UNITED_STATES), shards, sw),
        "planes": np.stack([_pack(b, shards, sw) for b in bits], axis=1),
        "co_dim0": np.stack([_pack(c["c_region"] == r, shards, sw) for r in range(5)]),
        "co_dim1": np.stack([_pack(c["s_region"] == r, shards, sw) for r in range(5)]),
    }
    sel = (c["c_nation"] == smoke.UNITED_STATES) & (c["s_nation"] == smoke.UNITED_STATES)
    sel &= np.isin(c["c_city"], us) & np.isin(c["s_city"], us) & np.isin(c["d_year"], years)
    arrays["q32_counts"], arrays["q32_plane_counts"] = _groupby_oracle(
        [c["c_city"], c["s_city"], c["d_year"]], [us, us, years], sel, bits
    )
    arrays["co_counts"], _ = _groupby_oracle(
        [c["c_region"], c["s_region"]], [range(5), range(5)], np.ones(rev.size, dtype=bool), []
    )
    arrays["sum_plane_counts"] = np.array([int(b.sum()) for b in bits], dtype=np.int64)
    q32_sel = (c["c_nation"] == smoke.UNITED_STATES) & (c["s_nation"] == smoke.UNITED_STATES)
    for name, (filt, nth, shards_cut, words, which) in PCT_CASES.items():
        cols = rev if words is None else rev[: words * 32]
        if filt is not None:
            cols = cols[q32_sel[: cols.size]]
        d = depth if which == "all" else 0
        arrays[name + "_want"] = np.array(_percentile_oracle(cols, nth, d), dtype=np.int64)
    for name, (field, brand) in DISTINCT_CASES.items():
        lo_f, hi_f = smoke.SSB_INT_FIELDS[field]
        d = smoke._bit_depth(hi_f - lo_f)
        vals = c[field].astype(np.int64) - lo_f
        key = f"planes_{field}"
        if key not in arrays:
            fb = [((vals >> i) & 1).astype(bool) for i in range(d)] + [np.ones(vals.size, dtype=bool)]
            arrays[key] = np.stack([_pack(b, shards, sw) for b in fb], axis=1)
        if brand is not None:
            m = c["p_brand1"] == brand
            arrays[f"brand{brand}_filt"] = _pack(m, shards, sw)
            vals = vals[m]
        arrays[name + "_want"] = _presence_words(vals, d)
    x = int(rev[123_457])  # chip_smoke.py's Range(lo_revenue == x)
    arrays["range_x"] = np.array([x], dtype=np.int64)
    for name, (field, op, pred) in RANGE_CASES.items():
        lo_f, _ = smoke.SSB_INT_FIELDS[field]
        vals = c[field].astype(np.int64) - lo_f
        pred = x if pred == "x" else pred
        arrays[name + "_want"] = _pack(_range_columns(vals, op, pred), shards, sw).view("<i4")
    # the columns as [S, SW], those past the last row not-null nowhere
    rev_s = np.zeros(shards * sw, dtype=np.int64)
    rev_s[: rev.size] = rev
    rev_s = rev_s.reshape(shards, sw)
    for name, (is_min, filt, shards_cut, words) in MINMAX_CASES.items():
        sel = np.zeros(shards * sw, dtype=bool)
        sel[: rev.size] = q32_sel if filt is not None else True
        sel = sel.reshape(shards, sw)
        n_sh = shards if shards_cut is None else shards_cut
        width = sw if words is None else words * 32
        arrays[name + "_bits"], arrays[name + "_count"] = _minmax_oracle(
            rev_s[:n_sh, :width], sel[:n_sh, :width], is_min, depth
        )
    del rev_s
    del c, bits, rev, sel
    g = np.random.default_rng(1906)
    s_g, d1_g, w_g = PCT_GLOBAL_SHAPE
    gp = g.integers(0, 2**32, size=(s_g, d1_g, w_g), dtype=np.uint32)
    gp[:, d1_g - 1] |= g.integers(0, 2**32, size=(s_g, w_g), dtype=np.uint32)
    gf = g.integers(0, 2**32, size=(s_g, w_g), dtype=np.uint32) | g.integers(0, 2**32, size=(s_g, w_g), dtype=np.uint32)
    arrays["pct_global_planes"], arrays["pct_global_filt"] = gp, gf
    arrays["pct_global_want"] = np.array(_percentile_words_oracle(gp, gf, PCT_GLOBAL_NTH), dtype=np.int64)
    arrays.update(_nonexclusive(smoke, arrays["planes"]))
    arrays.update(_tier_payloads(smoke))
    for name, a in arrays.items():
        np.save(os.path.join(out_dir, name + ".npy"), a)


def _sparse_cases(ops, dev, load, extra: dict) -> dict:
    """The K2 cases on this checkout's wrappers; the grouping made before
    the timing where its API takes one. Where it does, ``extra`` gets
    ``sparse_group_ms``: the host milliseconds (median of GROUP_ITERS) of
    making the bundle's grouping from its host index arrays, as the
    stager makes it when it stages the bundle."""
    import inspect
    import time

    import torch

    blocks = ops.words_from_numpy(load("sp_blocks"), dev)
    idx = [torch.from_numpy(load(k)).to(dev) for k in ("sp_brow", "sp_bslot", "sp_bshard")]
    hot = load("sp_hot")
    want = load("sp_want")
    num_rows = SPARSE_SHARDS * SPARSE_CHUNK
    srcs = [ops.words_from_numpy(hot[q % SPARSE_HOT], dev) for q in range(max(SPARSE_QS))]
    kw = {}
    if "groups" in inspect.signature(ops.cuda.sparse_stacked_scores).parameters:
        host = [load(k) for k in ("sp_brow", "sp_bslot", "sp_bshard")]
        slots = hot.shape[2] // 2048
        took = []
        for _ in range(GROUP_ITERS):
            t0 = time.perf_counter()
            ops.sparse_groups(*host, num_rows, SPARSE_SHARDS, slots, device=dev)
            took.append((time.perf_counter() - t0) * 1e3)
        extra["sparse_group_ms"] = float(np.median(took))
        kw["groups"] = ops.sparse_groups(*idx, num_rows, SPARSE_SHARDS, slots)
    cases = {}
    for q in SPARSE_QS:
        stacked = torch.stack(srcs[:q])
        cases[f"sparse_tall_q{q}"] = (
            lambda stacked=stacked: ops.cuda.sparse_stacked_scores(stacked, blocks, *idx, num_rows, **kw),
            [want[:q]],
        )
    for q in SPARSE_BATCH_QS:
        cases[f"sparse_batch_q{q}"] = (
            lambda q=q: ops.sparse_intersection_counts_stacked_batch_list(srcs[:q], blocks, *idx, num_rows, **kw),
            [want[:q]],
        )
    cases["sparse_head_q1"] = (
        lambda: ops.sparse_intersection_counts_stacked_mat(
            srcs[0], blocks, *idx, num_rows, SPARSE_SHARDS, SPARSE_CHUNK, **kw),
        [want[0].reshape(SPARSE_SHARDS, SPARSE_CHUNK)],
    )
    return cases


def run_arm(checkout: str, data: str, names=CASES) -> int:
    """One arm: ``checkout``'s kernels at ``names``. Prints {"arm", ...}
    last."""
    sys.path.insert(0, checkout)
    import torch

    import pilosa_tpu_torch
    from pilosa_tpu_torch import ops

    port = os.path.dirname(os.path.abspath(pilosa_tpu_torch.__file__))
    if not port.startswith(checkout + os.sep):
        raise RuntimeError(f"arm {checkout} imported the port from {port}")
    smoke = _smoke()
    ops.build_kernels()
    dev = torch.device("cuda")

    def load(name):
        return np.load(os.path.join(data, name + ".npy"))

    def up(name):
        return ops.words_from_numpy(load(name), dev)

    cases, extra = {}, {}
    if any(c in SPARSE_CASES for c in names):
        cases.update(_sparse_cases(ops, dev, load, extra))
    if all(c in SPARSE_CASES for c in names):
        return _time_arm(checkout, smoke, dev, cases, names, extra)
    pool, chain_want, one_want = _tree_inputs()
    leaves = [ops.words_from_numpy(a, dev) for a in pool]
    chain_args = ([[leaves[i] for i in p] for p in PICKS], ops.TreeProgram(TREE))
    one_args = ([[leaves[0][0]]], ops.TreeProgram(("leaf", 0)))
    mat, srcs, dense_want = up("dense_mat"), up("dense_srcs"), load("dense_want")
    planes = up("planes")
    q32 = ([up(f"q32_dim{i}") for i in range(3)], up("q32_filt"), planes)
    co = ([up(f"co_dim{i}") for i in range(2)], None, planes[:, :0])
    sum_args = ([], None, planes)
    nx = ([up("nx_dim0"), up("nx_dim1")], None, planes[:, : smoke.NONEXCL_PLANES])
    cuda = ops.cuda
    cases |= {
        "chain": (lambda: cuda.tree_count(*chain_args), [chain_want]),
        "one": (lambda: cuda.tree_count(*one_args), [[one_want]]),
        "groupby_q32": (lambda: cuda.groupby_reduce(*q32), [load("q32_counts"), load("q32_plane_counts")]),
        "groupby_count_only": (lambda: cuda.groupby_reduce(*co), [load("co_counts")]),
        "sum": (lambda: cuda.groupby_reduce(*sum_args)[1][0], [load("sum_plane_counts")]),
        "groupby_nonexclusive": (lambda: cuda.groupby_reduce(*nx), [load("nx_counts"), load("nx_plane_counts")]),
    }
    for q in DENSE_QS:
        s = srcs[:q].contiguous()
        cases[f"dense_q{q}"] = (lambda s=s: cuda.dense_scores(s, mat), [dense_want[:q]])
    ex = {k: load(k) for k in ("ex_pos", "ex_runs", "ex_dense", "ex_dword")}
    for kind in EXPAND_KINDS:
        ex[f"ex_words_{kind}"] = load(f"ex_words_{kind}")
        fn, want = _expand_case(ops, dev, ex, kind)
        cases[f"expand_{kind}"] = (fn, [want])
    # K7: 64 words of the dense chunk, each set and cleared in part; the
    # masks are idempotent, so repeated in-place launches agree
    rng = np.random.default_rng(61)
    wi = np.sort(rng.choice(mat.numel(), size=DELTA_WORDS, replace=False)).astype(np.int32)
    om = rng.integers(0, 2**32, size=DELTA_WORDS, dtype=np.uint32)
    am = rng.integers(0, 2**32, size=DELTA_WORDS, dtype=np.uint32) & ~om
    flat = mat.view(1, -1)
    upd = [ops.words_from_numpy(a, dev) for a in (wi, om, am)]
    patched = mat.cpu().numpy().view("<u4").reshape(-1).copy()
    patched[wi] = (patched[wi] | om) & ~am
    in_place = getattr(cuda, "word_delta_", None)
    refresh = in_place if in_place is not None else cuda.word_delta
    work = flat.clone()
    cases["delta_refresh"] = (lambda: refresh(work, None, *upd), [patched.view("<i4").reshape(1, -1)])
    cases["delta_copy"] = (lambda: cuda.word_delta(flat, None, *upd), [patched.view("<i4").reshape(1, -1)])
    fill = torch.empty(EXPAND_ROWS * 32768, dtype=torch.int32, device=dev)
    cases["fill_16mib"] = (lambda: fill.zero_(), [np.zeros(fill.numel(), np.int32)])
    depth = planes.shape[1] - 1
    for name, (filt_name, nth, shards_cut, words, which) in PCT_CASES.items():
        pl = planes if words is None else planes[:shards_cut, :, :words]
        if which == "not-null":
            pl = pl[:, depth:]
        filt = up(filt_name) if filt_name is not None else None
        kernel = getattr(cuda, "bsi_percentile", None)
        if kernel is not None:
            fn = lambda pl=pl, filt=filt, nth=nth, k=kernel: k(pl, filt, nth)  # noqa: E731
        else:
            fn = lambda pl=pl, filt=filt, nth=nth: ops.bsi_percentile_batched(  # noqa: E731
                pl, filt, nth, bit_depth=pl.shape[1] - 1, has_filter=filt is not None
            )
        want = load(name + "_want")
        cases[name] = (fn, [want[:-1], want[-1]])
    gpl, gfl = up("pct_global_planes"), up("pct_global_filt")
    gw = load("pct_global_want")
    cases["pct_global"] = (lambda: cuda.bsi_percentile(gpl, gfl, PCT_GLOBAL_NTH), [gw[:-1], gw[-1]])
    for name, (field, brand) in DISTINCT_CASES.items():
        dpl = up(f"planes_{field}")
        dfl = up(f"brand{brand}_filt") if brand is not None else None
        ddepth = dpl.shape[1] - 1
        cases[name] = (
            lambda dpl=dpl, dfl=dfl, ddepth=ddepth: cuda.distinct_presence(dpl, dfl, ddepth),
            [load(name + "_want")],
        )
    bsi = importlib.import_module("pilosa_tpu_torch.ops.bsi")
    for name, (field, op, pred) in RANGE_CASES.items():
        rpl = planes if field == "lo_revenue" else up(f"planes_{field}")
        rdepth = rpl.shape[1] - 1
        pred = int(load("range_x")[0]) if pred == "x" else pred
        code, out_sel = range_program_of(bsi, op, pred, rdepth)
        cases[name] = (
            lambda rpl=rpl, code=code, out_sel=out_sel: cuda.bsi_range(rpl, code, out_sel),
            [load(name + "_want")],
        )
    for name, (is_min, filt_name, shards_cut, words) in MINMAX_CASES.items():
        mpl = planes if words is None else planes[:shards_cut, :, :words]
        mfl = up(filt_name) if filt_name is not None else None
        cases[name] = (
            lambda mpl=mpl, mfl=mfl, is_min=is_min: cuda.bsi_minmax(mpl, mfl, is_min),
            [load(name + "_bits"), load(name + "_count")],
        )
    return _time_arm(checkout, smoke, dev, cases, names, extra)


def _time_arm(checkout: str, smoke, dev, cases: dict, names, extra: dict) -> int:
    import torch

    torch.cuda.synchronize()
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    out = {"arm": checkout, **extra}
    for name in names:
        fn, want = cases[name]
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            if not np.array_equal(g.cpu().numpy().astype(np.int64), np.asarray(w, dtype=np.int64)):
                raise AssertionError(f"{checkout} {name}: differs from the numpy count")
        out[name] = {"ms": smoke.time_ms(fn, ITERS, flush)}
        if name in ("chain", "one"):
            out[name]["ms_as_before"] = smoke.time_ms(fn, ITERS, flush, as_before=True)
    print(json.dumps(out), flush=True)
    return 0


def main(argv: list[str]) -> int:
    names = CASES
    if len(argv) >= 2 and argv[0] == "--only":
        prefixes = tuple(argv[1].split(","))
        names = tuple(c for c in CASES if c.startswith(prefixes))
        if not names:
            print(f"kernel_ab_probe.py: no case starts with {argv[1]}", file=sys.stderr)
            return 2
        argv = argv[2:]
    if len(argv) >= 3 and argv[0] == "--arm":
        return run_arm(os.path.abspath(argv[1]), argv[2], names)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab_probe.py: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    print(smoke.card_line(), flush=True)
    data = tempfile.mkdtemp(prefix="kernel_ab_probe_")
    try:
        draw_inputs(smoke, data, names)
        rows = []
        for d in argv:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--only", ",".join(names), "--arm",
                 os.path.abspath(d), data],
                capture_output=True, text=True, timeout=900,
            )
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        shutil.rmtree(data, ignore_errors=True)
    extras = ("sparse_group_ms",)
    print(json.dumps({"summary": [
        {"arm": r["arm"], **{k: r[k]["ms"] for k in names}, **{k: r[k] for k in extras if k in r}} for r in rows
    ]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
