"""The port's GroupBy reduction (K4) and BSI ops (K5 and the plane
recurrences) against the JAX package's functions.

Same inputs (numpy, from a seed) go through ``pilosa_tpu.ops`` (XLA on
the CPU, the Pallas GroupBy kernel in interpret mode) and through
``pilosa_tpu_torch.ops`` on CPU tensors, where each public function runs
its plain PyTorch version. Outputs are integers, so the bar is ==. Inputs
include all-ones words, which catch sign bugs in the port's int32 view
of the u32 words.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu import ops as jops
from pilosa_tpu.ops.pallas_kernels import groupby_plane_counts_pallas, pad_for_pallas
from pilosa_tpu_torch import ops as tops

CPU = torch.device("cpu")
W = 256  # words per shard at this small width


def _u32(rng, shape, ones=1):
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    flat = a.reshape(-1)
    flat[rng.choice(flat.size, size=min(ones * 29, flat.size), replace=False)] = 0xFFFFFFFF
    a.reshape(-1, shape[-1])[:ones] = 0xFFFFFFFF
    return a


def _t(a):
    return tops.words_from_numpy(a, CPU)


def _np(t):
    return t.numpy().astype(np.int64)


# -- K4: GroupBy segmented reduction ---------------------------------------------------


def test_plain_k4_matches_pallas_p3_interpret():
    """One dimension, no filter: plane_counts.T is exactly P3's output."""
    rng = np.random.default_rng(11)
    groups = _u32(rng, (37, 2 * W))
    planes = _u32(rng, (9, 2 * W))
    _, pc = tops.groupby_reduce_plain([_t(groups)], None, _t(planes))
    gp, k = pad_for_pallas(groups)
    pp, _ = pad_for_pallas(planes)
    want = np.asarray(groupby_plane_counts_pallas(pp[:9], gp, interpret=True))[:, :k]
    assert np.array_equal(_np(pc).T, want)
    assert np.array_equal(_np(tops.groupby_plane_counts(_t(groups), _t(planes))), want.T)


DIM_SHAPES = [(5,), (3, 4), (2, 3, 4)]


@pytest.mark.parametrize("rows", DIM_SHAPES, ids=["1dim", "2dim", "3dim"])
@pytest.mark.parametrize("with_filter", [False, True], ids=["nofilter", "filter"])
def test_groupby_reduce_matches_jax(rows, with_filter):
    rng = np.random.default_rng(sum(rows) * 7 + with_filter)
    dims = [_u32(rng, (r, 3 * W)) for r in rows]
    filt = _u32(rng, (3 * W,)) if with_filter else None
    planes = _u32(rng, (6, 3 * W))
    jf = filt if with_filter else None
    want_c, want_pc = jops.groupby_sum_reduce(tuple(dims), jf, planes)
    tf = _t(filt) if with_filter else None
    got_c, got_pc = tops.groupby_sum_reduce([_t(d) for d in dims], tf, _t(planes))
    assert got_c.dtype == got_pc.dtype == torch.int32
    assert np.array_equal(_np(got_c), np.asarray(want_c))
    assert np.array_equal(_np(got_pc), np.asarray(want_pc))
    counts = tops.groupby_counts([_t(d) for d in dims], tf)
    assert np.array_equal(_np(counts), np.asarray(jops.groupby_counts(tuple(dims), jf)))
    # the whole-matrix cross product agrees too
    assert np.array_equal(
        tops.words_to_numpy(tops.combine_groups([_t(d) for d in dims], tf)),
        np.asarray(jops.combine_groups(tuple(dims), jf)),
    )


def test_groupby_reduce_stack_layouts_and_edges():
    """[R, S, W] dimensions and a staged [S, P, W] plane stack read in
    place give the flattened answer; no dimension is one group; P = 0
    gives counts only; tiles smaller than K change nothing."""
    rng = np.random.default_rng(5)
    s = 3
    dims = [_u32(rng, (4, s, W)), _u32(rng, (3, s, W))]
    filt = _u32(rng, (s, W))
    stack = _u32(rng, (s, 7, W))  # [S, P, W] as staged
    flat_planes = np.ascontiguousarray(stack.transpose(1, 0, 2)).reshape(7, s * W)
    want = jops.groupby_sum_reduce(
        tuple(d.reshape(d.shape[0], -1) for d in dims), filt.reshape(-1), flat_planes
    )
    got = tops.groupby_reduce([_t(d) for d in dims], _t(filt), _t(stack))
    assert np.array_equal(_np(got[0]), np.asarray(want[0]))
    assert np.array_equal(_np(got[1]), np.asarray(want[1]))
    # dims=(): K = 1, the filter (or all ones) is the group
    c, pc = tops.groupby_reduce((), _t(filt), _t(stack))
    assert _np(c).tolist() == [int(np.bitwise_count(filt).sum())]
    assert np.array_equal(_np(pc)[0], np.asarray(jops.bsi_plane_counts_batched(stack, filt, bit_depth=6, has_filter=True)))
    c, pc = tops.groupby_reduce((), None, _t(stack))
    assert _np(c).tolist() == [s * W * 32]
    assert np.array_equal(_np(pc)[0], np.bitwise_count(stack).sum(axis=(0, 2)))
    # P = 0
    c, pc = tops.groupby_reduce([_t(d) for d in dims], None, _t(stack[:, :0]))
    assert tuple(pc.shape) == (12, 0)
    assert np.array_equal(_np(c), np.asarray(jops.groupby_counts(tuple(d.reshape(d.shape[0], -1) for d in dims), None)))
    # a tile of one group at a time
    small = tops.packed._GROUP_TILE_WORDS
    try:
        tops.packed._GROUP_TILE_WORDS = 1
        again = tops.groupby_reduce([_t(d) for d in dims], _t(filt), _t(stack))
    finally:
        tops.packed._GROUP_TILE_WORDS = small
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_count_bits_rows_matches_jax():
    m = _u32(np.random.default_rng(8), (6, W))
    assert np.array_equal(_np(tops.count_bits_rows(_t(m))), np.asarray(jops.count_bits_rows(m)))


# -- K5: the range recurrences --------------------------------------------------------


def _planes(rng, depth, shards=None, nn_ones=True):
    shape = (depth + 1, W) if shards is None else (shards, depth + 1, W)
    p = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    flat = p.reshape(-1, W)
    flat[rng.choice(flat.shape[0], size=max(1, flat.shape[0] // 3), replace=False), :5] = 0xFFFFFFFF
    if nn_ones:
        p[..., depth, :] |= np.uint32(0xFFFF0000)
    return p


def _jax_range(planes, op, depth, a, b=0):
    if op == "==":
        return jops.bsi_range_eq(planes, np.uint32(a), bit_depth=depth)
    if op == "!=":
        return jops.bsi_range_neq(planes, np.uint32(a), bit_depth=depth)
    if op in ("<", "<="):
        return jops.bsi_range_lt(planes, np.uint32(a), bit_depth=depth, allow_equality=op == "<=")
    if op in (">", ">="):
        return jops.bsi_range_gt(planes, np.uint32(a), bit_depth=depth, allow_equality=op == ">=")
    return jops.bsi_range_between(planes, np.uint32(a), np.uint32(b), bit_depth=depth)


def _preds(rng, depth):
    top = (1 << depth) - 1
    mid = int(rng.integers(0, top + 1))
    return sorted({0, 1 % (top + 1), top, mid, max(top - 1, 0)})


@pytest.mark.parametrize("depth", [1, 6, 24])
@pytest.mark.parametrize("op", ["==", "!=", "<", "<=", ">", ">="])
def test_bsi_range_plain_k5_matches_jax(depth, op):
    rng = np.random.default_rng(depth * 31 + len(op) + ord(op[0]))
    planes = _planes(rng, depth)
    for pred in _preds(rng, depth):
        want = np.asarray(_jax_range(planes, op, depth, pred))
        got = tops.words_to_numpy(tops.bsi_range(_t(planes), op, depth, pred))
        assert np.array_equal(got, want), (op, pred)
    # the JAX-named entry point
    fn = {"==": "eq", "!=": "neq", "<": "lt", "<=": "lt", ">": "gt", ">=": "gt"}[op]
    kw = {"allow_equality": op in ("<=", ">=")} if fn in ("lt", "gt") else {}
    got = getattr(tops, f"bsi_range_{fn}")(_t(planes), pred, bit_depth=depth, **kw)
    assert np.array_equal(tops.words_to_numpy(got), np.asarray(_jax_range(planes, op, depth, pred)))


@pytest.mark.parametrize("depth", [1, 6, 24])
def test_bsi_range_between_plain_k5_matches_jax(depth):
    rng = np.random.default_rng(depth)
    planes = _planes(rng, depth)
    preds = _preds(rng, depth)
    for lo in preds:
        for hi in preds:
            want = np.asarray(_jax_range(planes, "><", depth, lo, hi))
            got = tops.words_to_numpy(tops.bsi_range_between(_t(planes), lo, hi, bit_depth=depth))
            assert np.array_equal(got, want), (lo, hi)


def test_bsi_range_stacked_equals_per_shard():
    """The [S, D+1, W] form (what the kernel takes) is the per-shard form
    stacked."""
    rng = np.random.default_rng(3)
    stack = _planes(rng, 10, shards=4)
    for op, a, b in [("<", 700, 0), (">=", 3, 0), ("><", 100, 900), ("!=", 512, 0)]:
        got = tops.bsi_range(_t(stack), op, 10, a, b)
        for s in range(4):
            assert torch.equal(got[s], tops.bsi_range(_t(stack[s]), op, 10, a, b))


def test_range_program_deep_predicates():
    """64-bit predicates lower without truncation: bit 40 of the
    predicate reaches plane 40's opcode."""
    code, out = tops.range_program("==", 41, 1 << 40)
    assert code[40] == tops.bsi.B_AND and code[39] == tops.bsi.B_ANDNOT and out == tops.bsi.OUT_B
    code, _ = tops.range_program("><", 41, (1 << 36) + 12345, 4 * ((1 << 36) + 12345))
    assert len(code) == 41
    with pytest.raises(ValueError):
        tops.range_program("<", 64, 1)
    with pytest.raises(ValueError):
        tops.range_program("~", 8, 1)


# -- Sum / Min / Max / Percentile / Distinct ------------------------------------------


@pytest.mark.parametrize("has_filter", [False, True])
def test_plane_counts_match_jax(has_filter):
    rng = np.random.default_rng(21 + has_filter)
    planes = _planes(rng, 8)
    filt = _u32(rng, (W,))
    want = np.asarray(jops.bsi_plane_counts(planes, filt, bit_depth=8, has_filter=has_filter))
    got = tops.bsi_plane_counts(_t(planes), _t(filt), bit_depth=8, has_filter=has_filter)
    assert np.array_equal(_np(got), want)
    stack = _planes(rng, 8, shards=3)
    filts = _u32(rng, (3, W))
    want = np.asarray(jops.bsi_plane_counts_batched(stack, filts, bit_depth=8, has_filter=has_filter))
    got = tops.bsi_plane_counts_batched(_t(stack), _t(filts), bit_depth=8, has_filter=has_filter)
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("fn", ["bsi_min", "bsi_max"])
@pytest.mark.parametrize("has_filter", [False, True])
def test_min_max_match_jax(fn, has_filter):
    rng = np.random.default_rng(len(fn) + has_filter)
    planes = _planes(rng, 7)
    filt = _u32(rng, (W,))
    wb, wc = getattr(jops, fn)(planes, filt, bit_depth=7, has_filter=has_filter)
    gb, gc = getattr(tops, fn)(_t(planes), _t(filt), bit_depth=7, has_filter=has_filter)
    assert gb.tolist() == np.asarray(wb).tolist() and int(gc) == int(wc)
    # a sparse filter leaves few candidates: the recurrence branches both ways
    sparse = np.zeros(W, dtype=np.uint32)
    sparse[::17] = 0x10101
    wb, wc = getattr(jops, fn)(planes, sparse, bit_depth=7, has_filter=True)
    gb, gc = getattr(tops, fn)(_t(planes), _t(sparse), bit_depth=7, has_filter=True)
    assert gb.tolist() == np.asarray(wb).tolist() and int(gc) == int(wc)


PERCENTILE_NTH = (0, 1, 5000, 9500, 9999, 10000)
# (nth_bp, depth, shards, strided): the first cases keep their ids
PERCENTILE_CASES = [pytest.param(n, 9, 2, False, id=str(n)) for n in PERCENTILE_NTH] + [
    pytest.param(n, d, s, strided, id=f"d{d}-s{s}-{'strided-' if strided else ''}{n}")
    for d in (0, 1, 9, 24)
    for s in (1, 3)
    for strided in (False, True)
    for n in PERCENTILE_NTH
    if not strided or (d, s) == (9, 3)
]


def _strided_planes(stack):
    """[S, D+1, W] words as a view of a larger buffer: the planes 2 apart
    with a plane before them, each shard's words offset by 4."""
    s, d1, w = stack.shape
    big = np.zeros((s, 2 * d1 + 1, w + 8), dtype=np.uint32)
    big[:, 1::2, 4 : w + 4] = stack
    view = _t(big)[:, 1::2, 4 : w + 4]
    assert not view.is_contiguous() and tuple(view.shape) == stack.shape
    return view


@pytest.mark.parametrize("nth_bp,depth,shards,strided", PERCENTILE_CASES)
def test_percentile_matches_jax(nth_bp, depth, shards, strided):
    """``bsi_percentile_plain`` (K10's plain version) and
    ``bsi_percentile_batched`` against the JAX package, ==: no filter, a
    random filter, an all-zero filter (count 0: every bit set), and a
    sparse filter that leaves few candidates, so the search branches both
    ways; all-ones words in the planes."""
    rng = np.random.default_rng(nth_bp + 100 * depth + 10 * shards + strided)
    stack = _planes(rng, depth, shards=shards)
    sparse = np.zeros((shards, W), dtype=np.uint32)
    sparse[:, ::17] = 0x10101
    filters = [None, _u32(rng, (shards, W)), np.zeros((shards, W), dtype=np.uint32), sparse]
    planes = _strided_planes(stack) if strided else _t(stack)
    for filt in filters:
        has_filter = filt is not None
        f = filt if has_filter else np.zeros((shards, W), dtype=np.uint32)
        wb, wc = jops.bsi_percentile_batched(stack, f, np.int32(nth_bp), bit_depth=depth, has_filter=has_filter)
        want = (np.asarray(wb).tolist(), int(wc))
        gb, gc = tops.bsi_percentile_batched(planes, _t(f), nth_bp, bit_depth=depth, has_filter=has_filter)
        pb, pc = tops.bsi_percentile_plain(planes, _t(filt) if has_filter else None, nth_bp)
        assert gb.dtype == pb.dtype == torch.bool and gc.dtype == pc.dtype == torch.int32
        assert (gb.tolist(), int(gc)) == want and (pb.tolist(), int(pc)) == want, has_filter
        if has_filter and not filt.any():
            assert want == ([True] * depth, 0)


@pytest.mark.parametrize("depth", [1, 6, 10])
def test_distinct_presence_matches_jax(depth):
    rng = np.random.default_rng(depth + 40)
    stack = _planes(rng, depth, shards=2)
    # thin the not-null plane so only some values occur
    stack[:, depth, :] &= rng.integers(0, 2**32, size=(2, W), dtype=np.uint32) & np.uint32(0x01010101)
    filts = _u32(rng, (2, W))
    for has_filter in (False, True):
        want = np.asarray(jops.bsi_distinct_presence(stack, filts, bit_depth=depth, has_filter=has_filter))
        got = tops.bsi_distinct_presence(_t(stack), _t(filts), bit_depth=depth, has_filter=has_filter)
        assert np.array_equal(tops.words_to_numpy(got), want)


# -- K8: the per-shard Min/Max recurrences in one launch -------------------------------


@pytest.mark.parametrize("depth", [0, 1, 10, 41])
@pytest.mark.parametrize("is_min", [True, False], ids=["min", "max"])
@pytest.mark.parametrize("has_filter", [False, True], ids=["nofilter", "filter"])
def test_minmax_batched_plain_matches_jax_per_shard(depth, is_min, has_filter):
    """K8's plain version, shard by shard, against the JAX package's
    one-shard recurrence: all-ones planes, a filter that empties a shard,
    a shard with no value, a sparse filter that branches both ways."""
    rng = np.random.default_rng(depth * 4 + is_min * 2 + has_filter)
    s = 5
    stack = _planes(rng, depth, shards=s)
    stack[1, :depth] = 0xFFFFFFFF
    stack[3, depth] = 0
    filts = _u32(rng, (s, W))
    filts[2] = 0
    filts[4] = 0
    filts[4, ::17] = 0x10101
    bits, count = tops.bsi_minmax_batched(
        _t(stack), _t(filts), is_min=is_min, bit_depth=depth, has_filter=has_filter
    )
    assert bits.dtype == torch.bool and tuple(bits.shape) == (s, depth)
    assert count.dtype == torch.int32 and tuple(count.shape) == (s,)
    fn = jops.bsi_min if is_min else jops.bsi_max
    for i in range(s):
        wb, wc = fn(stack[i], filts[i], bit_depth=depth, has_filter=has_filter)
        assert bits[i].tolist() == np.asarray(wb).tolist() and int(count[i]) == int(wc), i
    assert int(count[3]) == 0
    assert (int(count[2]) == 0) == has_filter


@pytest.mark.parametrize("fn", ["bsi_min", "bsi_max"])
@pytest.mark.parametrize("depth", [1, 10, 41])
def test_min_max_batch_folds_to_jax_global_recurrence(fn, depth):
    """A [S, D+1, W] batch to bsi_min/bsi_max is one set of columns: the
    per-shard results folded on the device equal the JAX recurrence over
    the shards laid end to end (ties across shards add their counts)."""
    rng = np.random.default_rng(depth + len(fn))
    s = 4
    stack = _planes(rng, depth, shards=s)
    stack[:, depth] &= rng.integers(0, 2**32, size=(s, W), dtype=np.uint32) & np.uint32(0x00110011)
    stack[2, depth] = 0
    filts = _u32(rng, (s, W))
    filts[1] = 0

    def flat(a):
        return np.ascontiguousarray(a.transpose(1, 0, 2)).reshape(depth + 1, s * W)

    for has_filter in (False, True):
        wb, wc = getattr(jops, fn)(flat(stack), filts.reshape(-1), bit_depth=depth, has_filter=has_filter)
        gb, gc = getattr(tops, fn)(_t(stack), _t(filts), bit_depth=depth, has_filter=has_filter)
        assert gb.tolist() == np.asarray(wb).tolist() and int(gc) == int(wc), has_filter
    # no value anywhere: what the recurrence gives an empty set
    empty = stack.copy()
    empty[:, depth] = 0
    wb, wc = getattr(jops, fn)(flat(empty), None, bit_depth=depth, has_filter=False)
    gb, gc = getattr(tops, fn)(_t(empty), None, bit_depth=depth, has_filter=False)
    assert gb.tolist() == np.asarray(wb).tolist() and int(gc) == int(wc) == 0
