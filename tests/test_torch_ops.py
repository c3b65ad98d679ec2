"""The port's plain kernel versions against the JAX package's functions.

Same inputs (numpy, from a seed) go through ``pilosa_tpu.ops`` (XLA on
the CPU, the Pallas kernels in interpret mode) and through
``pilosa_tpu_torch.ops`` on CPU tensors, where every public scorer runs
its plain PyTorch version. Outputs are integers, so the bar is ==.
Inputs include all-ones words (0xFFFFFFFF), which catch sign bugs in the
port's int32 view of the u32 words.
"""

import itertools

import numpy as np
import pytest
import torch

from pilosa_tpu import ops as jops
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.executor.executor import _eval_tree
from pilosa_tpu.ops.pallas_kernels import (
    intersection_counts_matrix_batch_pallas,
    intersection_counts_matrix_pallas,
    pad_for_pallas,
)
from pilosa_tpu_torch import ops as tops

CPU = torch.device("cpu")


def _u32(rng, shape, ones=2):
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    flat = a.reshape(-1)
    flat[rng.choice(flat.size, size=min(ones * 37, flat.size), replace=False)] = 0xFFFFFFFF
    a.reshape(-1, shape[-1])[:ones] = 0xFFFFFFFF
    return a


def _t(a):
    return tops.words_from_numpy(a, CPU)


def _np(t):
    return t.numpy().astype(np.int64)


# -- words and boolean algebra -------------------------------------------------


def test_words_round_trip_u32_and_u64():
    rng = np.random.default_rng(1)
    w32 = _u32(rng, (3, 64))
    t = tops.words_from_numpy(w32, CPU)
    assert t.dtype == torch.int32
    assert np.array_equal(tops.words_to_numpy(t), w32)
    w64 = jops.u32_to_u64(w32)
    assert np.array_equal(tops.u32_to_u64(w32), w64)
    assert np.array_equal(tops.u64_to_u32(w64), jops.u64_to_u32(w64))
    # u64 host words upload as the same bits
    assert np.array_equal(tops.words_to_numpy(tops.words_from_numpy(w64, CPU)), w32)


@pytest.mark.parametrize("name", ["and_", "or_", "xor_", "andnot", "not_"])
def test_boolean_ops_match_jax(name):
    rng = np.random.default_rng(2)
    a, b = _u32(rng, (4, 256)), _u32(rng, (4, 256))
    args = (a,) if name == "not_" else (a, b)
    want = np.asarray(getattr(jops, name)(*args))
    got = tops.words_to_numpy(getattr(tops, name)(*(_t(x) for x in args)))
    assert np.array_equal(got, want)


# -- K1: dense scores -------------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(3)
    mat = _u32(rng, (20, 2048))  # ragged R: no padding on the port's side
    srcs = _u32(rng, (3, 2048), ones=1)
    return srcs, mat


def test_dense_single_matches_jax_and_pallas(dense):
    srcs, mat = dense
    got = tops.intersection_counts_matrix(_t(srcs[0]), _t(mat))
    assert got.dtype == torch.int32
    want = np.asarray(jops.intersection_counts_matrix(srcs[0], mat))
    assert np.array_equal(_np(got), want)
    padded, r = pad_for_pallas(mat)
    psrc = np.pad(srcs[0], (0, padded.shape[1] - srcs.shape[1]))
    p1 = np.asarray(intersection_counts_matrix_pallas(psrc, padded, interpret=True))[:r]
    assert np.array_equal(_np(got), p1)


def test_dense_batch_matches_jax_and_pallas(dense):
    srcs, mat = dense
    got = tops.intersection_counts_matrix_batch_list([_t(s) for s in srcs], _t(mat))
    assert tuple(got.shape) == (3, 20)
    want = np.asarray(jops.intersection_counts_matrix_batch_list(list(srcs), mat))
    assert np.array_equal(_np(got), want)
    padded, r = pad_for_pallas(mat)
    psrcs = np.pad(srcs, ((0, 0), (0, padded.shape[1] - srcs.shape[1])))
    p2 = np.asarray(intersection_counts_matrix_batch_pallas(psrcs, padded, interpret=True))
    assert np.array_equal(_np(got), p2[:, :r])
    assert np.array_equal(_np(tops.intersection_counts_matrix_plain(_t(srcs), _t(mat))), want)


# -- K2: block-sparse stacked scores ------------------------------------------------

_SLOTS = 4  # containers per row at this small width
_W = _SLOTS * tops.CONTAINER_WORDS


@pytest.fixture(scope="module")
def sparse():
    rng = np.random.default_rng(4)
    s, b = 3, 50
    srcs = _u32(rng, (4, s, _W))
    blocks = _u32(rng, (b, tops.CONTAINER_WORDS))
    brow = rng.integers(0, 12, size=b).astype(np.int32)
    brow[:9] = 5  # duplicate rows add up
    bslot = rng.integers(0, _SLOTS, size=b).astype(np.int32)
    bshard = rng.integers(0, s, size=b).astype(np.int32)
    num_rows = 32  # larger than the rows any block names
    return srcs, blocks, brow, bslot, bshard, num_rows


def test_sparse_single_shard_matches_jax(sparse):
    srcs, blocks, brow, bslot, _, num_rows = sparse
    src = srcs[0, 0]
    got = tops.sparse_intersection_counts(
        _t(src), _t(blocks), _t(brow), _t(bslot), num_rows
    )
    want = np.asarray(jops.sparse_intersection_counts(src, blocks, brow, bslot, num_rows))
    assert got.shape == (num_rows,)
    assert np.array_equal(_np(got), want)
    assert want[12:].sum() == 0 and want[5] > 0


def test_sparse_stacked_matches_jax(sparse):
    srcs, blocks, brow, bslot, bshard, num_rows = sparse
    got = tops.sparse_intersection_counts_stacked(
        _t(srcs[1]), _t(blocks), _t(brow), _t(bslot), _t(bshard), num_rows
    )
    want = np.asarray(
        jops.sparse_intersection_counts_stacked(srcs[1], blocks, brow, bslot, bshard, num_rows)
    )
    assert np.array_equal(_np(got), want)


def test_sparse_stacked_batch_matches_jax(sparse):
    srcs, blocks, brow, bslot, bshard, num_rows = sparse
    got = tops.sparse_intersection_counts_stacked_batch_list(
        [_t(s) for s in srcs], _t(blocks), _t(brow), _t(bslot), _t(bshard), num_rows
    )
    want = np.asarray(
        jops.sparse_intersection_counts_stacked_batch_list(
            list(srcs), blocks, brow, bslot, bshard, num_rows
        )
    )
    assert tuple(got.shape) == (4, num_rows)
    assert np.array_equal(_np(got), want)


# -- K3: fused tree count ----------------------------------------------------------

# The lowered trees (executor _tree_leaves output) of bench_tall's three
# chain shapes, plus an Xor chain. Every Row occurrence is its own leaf.
L = [("leaf", i) for i in range(5)]
TREES = {
    "intersect_of_unions": ("Intersect", (("Union", (L[0], L[1])), ("Union", (L[2], L[3])))),
    "union_of_intersects": (
        "Union",
        (("Intersect", (L[0], L[1])), ("Intersect", (L[2], L[3])), L[4]),
    ),
    "difference_of_union": ("Difference", (("Union", (L[0], L[1], L[2])), L[3])),
    "xor": ("Xor", (L[0], ("Difference", (L[1], L[2])), L[3])),
    "single_leaf": L[0],
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_count_matches_jax(name):
    tree = TREES[name]
    prog = tops.TreeProgram(tree)
    rng = np.random.default_rng(len(name))
    per_query = [[_u32(rng, (3, 2048)) for _ in range(prog.nleaves)] for _ in range(2)]
    want = [int(jops.count_bits(_eval_tree(tree, leaves))) for leaves in per_query]
    got = tops.tree_count([[_t(a) for a in leaves] for leaves in per_query], prog)
    assert got.dtype == torch.int32
    assert got.tolist() == want
    assert tops.tree_count_plain([[_t(a) for a in per_query[1]]], prog).tolist() == want[1:]


def test_count_bits_matches_jax():
    a = _u32(np.random.default_rng(6), (5, 4096))
    assert int(tops.count_bits(_t(a))) == int(jops.count_bits(a))


def test_tree_program_limits_raise():
    deep = L[0]
    for i in range(1, tops.packed.TREE_MAX_STACK + 1):
        deep = ("Intersect", (("leaf", i), deep))
    with pytest.raises(ValueError, match="stack depth"):
        tops.TreeProgram(deep)
    wide = ("Union", tuple(("leaf", i) for i in range(tops.packed.TREE_MAX_LEAVES + 1)))
    with pytest.raises(ValueError):
        tops.TreeProgram(wide)
    with pytest.raises(ValueError, match="not a boolean tree node"):
        tops.TreeProgram(("Sum", (L[0],)))


# -- K3's host lowering: shared leaves and the kernel's program -----------------------


def test_tree_tables_share_leaves_and_match_jax_batch(tmp_path):
    """Coalesced chains that stage the same rows: each storage is one
    distinct leaf, every query names its leaves by index, and the counts
    from those tables equal per-query counts and the reference's batched
    program (_tree_count_batch_jit)."""
    tree = TREES["union_of_intersects"]
    prog = tops.TreeProgram(tree)
    rng = np.random.default_rng(17)
    pool = [_u32(rng, (3, 2048)) for _ in range(8)]
    picks = [(0, 1, 2, 3, 4), (0, 5, 2, 6, 4), (0, 1, 2, 3, 4), (7, 7, 7, 7, 7)]
    torch_pool = [_t(a) for a in pool]
    queries = [[torch_pool[i] for i in p] for p in picks]
    # a view of the same storage is the same leaf
    queries[2][1] = torch_pool[1].view(-1).view(3, 2048)
    distinct, refs = tops.tree_tables(queries)
    assert len(distinct) == 8
    assert refs[0] == (0, 1, 2, 3, 4) and refs[2] == refs[0]
    assert refs[1] == (0, 5, 2, 6, 4) and refs[3] == (7,) * 5
    assert all(distinct[r].data_ptr() == q[l].data_ptr() for q, rr in zip(queries, refs) for l, r in enumerate(rr))
    got = tops.tree_count(queries, prog)
    assert got.tolist() == [int(tops.tree_count([q], prog)[0]) for q in queries]
    assert tops.tree_count_plain(queries, prog).tolist() == got.tolist()
    h = JaxHolder(str(tmp_path / "h"))
    h.open()
    try:
        jex = JaxExecutor(h, device_policy="always")
        flat = [pool[i] for p in picks for i in p]
        want = np.asarray(jex._tree_count_batch_jit(tree, len(picks), prog.nleaves)(*flat))
        jex.close()
    finally:
        h.close()
    assert got.tolist() == want.tolist()


def _kernel_run(code, leaves):
    """tree_count.cu's interpreter (tc_run) over CPU words: the top of the
    stack in a register, the entries below it in spill slots. Returns
    (result, spill slots used)."""
    apply = {
        tops.packed.K_AND: tops.and_,
        tops.packed.K_OR: tops.or_,
        tops.packed.K_XOR: tops.xor_,
        tops.packed.K_ANDNOT: tops.andnot,
    }
    top, spill, peak = None, [], 0
    for i, ins in enumerate(code):
        op, arg = ins >> 16, ins & 0xFFFF
        if i == 0:
            assert op == tops.packed.K_PUSH
        if arg == tops.packed.KERNEL_STACK:
            top = apply[op](spill.pop(), top)
        elif op == tops.packed.K_PUSH:
            if top is not None:
                spill.append(top)
                peak = max(peak, len(spill))
            top = leaves[arg]
        else:
            top = apply[op](top, leaves[arg])
    assert not spill
    return top, peak


DEEP = ("Difference", (L[0], ("Union", (L[1], ("Xor", (L[2], ("Intersect", (L[3], L[4])), L[0])))), L[2]))


@pytest.mark.parametrize("name", sorted(TREES) + ["deep"])
def test_kernel_program_matches_tree(name):
    """The peephole program the kernel runs ("push leaf; op" folded into
    the top of the stack) computes the tree, within its spill slots, and
    a chain of one operator never spills."""
    tree = DEEP if name == "deep" else TREES[name]
    prog = tops.TreeProgram(tree)
    rng = np.random.default_rng(len(name) + 5)
    leaves = [_t(_u32(rng, (2, 512))) for _ in range(prog.nleaves)]
    got, peak = _kernel_run(prog.kernel_code, leaves)
    assert torch.equal(got, tops.eval_tree(tree, leaves))
    assert peak == prog.spill <= prog.depth - 1
    assert len(prog.kernel_code) <= len(prog.code)
    if name in ("intersect_of_unions", "difference_of_union", "single_leaf"):
        assert prog.spill <= 1


# -- the bound's counts (chip_smoke.py): what a launch's inputs need ----------------


def _smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sparse_u32(rng, shape, ands=3):
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    for _ in range(ands):
        a &= rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return a


def _need_brute(dims, filt, planes):
    """Non-zero group words (every group of the cross product, first
    dimension slowest) and the 8-word sectors where the filter is set."""
    s, _, w = planes.shape
    flat = [d.reshape(d.shape[0], s * w) for d in dims]
    f = np.full(s * w, 0xFFFFFFFF, dtype=np.uint32) if filt is None else filt.reshape(-1)
    words = 0
    for rows in itertools.product(*[range(d.shape[0]) for d in flat]):
        g = f.copy()
        for d, r in zip(flat, rows):
            g &= d[r]
        words += int(np.count_nonzero(g))
    sectors = sum(1 for i in range(0, s * w, 8) if np.any(f[i : i + 8]))
    return words, sectors


@pytest.mark.parametrize(
    "rows,p,s,w,with_filter,ones",
    [((3, 2), 3, 2, 36, True, False), ((3, 2), 3, 2, 36, False, False), ((4,), 0, 3, 20, True, False),
     ((2, 2, 3), 5, 1, 64, True, True), ((5,), 0, 2, 12, False, True), ((), 2, 2, 16, True, False)],
)
def test_groupby_need_matches_brute_force(rows, p, s, w, with_filter, ones):
    """chip_smoke.groupby_need counts every group a column is in, with a
    non-exclusive dimension (a column in two rows of one), with and
    without a filter, P = 0, and all-ones words."""
    smoke = _smoke()
    rng = np.random.default_rng(sum(rows) * 100 + p * 10 + s + w)
    dims = [_sparse_u32(rng, (r, s, w), ands=1) for r in rows]
    if dims:
        # row 1 of the first dimension holds every column of row 0 too
        dims[0][min(1, rows[0] - 1)] |= dims[0][0]
        if ones:
            dims[0][0, 0, :4] = 0xFFFFFFFF
    filt = _sparse_u32(rng, (s, w)) if with_filter else None
    if ones and filt is not None:
        filt[0, :4] = 0xFFFFFFFF
    planes = _u32(rng, (s, p, w)) if p else np.zeros((s, 0, w), dtype=np.uint32)
    got = smoke.groupby_need(
        [_t(d) for d in dims], None if filt is None else _t(filt), _t(planes)
    )
    words, sectors = _need_brute(dims, filt, planes)
    assert got["group_words"] == words
    assert got["sectors"] == sectors
    assert got["all_sectors"] == -(-s * w // 8)
    k = 1
    for r in rows:
        k *= r
    assert got["groups"] == k


@pytest.mark.parametrize("q,w,ones", [(1, 64, False), (5, 40, True), (3, 8, False)])
def test_dense_need_matches_numpy(q, w, ones):
    smoke = _smoke()
    rng = np.random.default_rng(q * w)
    srcs = _sparse_u32(rng, (q, w))
    if ones:
        srcs[0] = 0xFFFFFFFF
    srcs[-1, : w // 2] = 0
    assert smoke.dense_need(_t(srcs)) == int(np.count_nonzero(srcs))


@pytest.mark.parametrize(
    "rows,p,with_filter",
    [((5, 5), 0, False), ((14, 3), 0, False), ((8, 8), 25, False), ((4, 4), 31, False),
     ((3, 3), 32, False), ((5, 13), 0, False), ((8, 8), 25, True), ((), 25, False)],
)
def test_bound_popcount_floor_by_kernel(rows, p, with_filter):
    """Every GroupBy launch counts on the CUDA cores, so its popcounts are
    a floor of its bound on any panel, filtered or dense; the dense
    scorer counts on the tensor cores, whose single-bit rate is not
    published, so its popcounts are reported but its bound is its bytes."""
    import types

    smoke = _smoke()
    rng = np.random.default_rng(sum(rows) + p)
    s, w = 1, 64
    dims = [_t(_sparse_u32(rng, (r, s, w), ands=0)) for r in rows]
    filt = _t(_sparse_u32(rng, (s, w))) if with_filter else None
    planes = _t(_u32(rng, (s, p, w))) if p else _t(np.zeros((s, 0, w), dtype=np.uint32))
    # a card slow enough that every popcount term passes the bytes term
    card = types.SimpleNamespace(sms=1, sm_clock_hz=1.0)
    b = smoke.bound("groupby_reduce", (dims, filt, planes), card)
    assert b["popcount_ms"] > 0
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(b["popcount_ms"])
    if p:
        d = smoke.bound("dense_scores", (planes[0], planes[0]), card)
        assert d["popcount_ms"] > 0 and d["bound_by"] == "bytes"


def _percentile_need_brute(a, f, nth):
    """(considered words, their 32-byte sectors) summed over the plane
    steps of the nearest-rank search on u32 planes [S, D+1, W] and an
    optional filter [S, W], walked one step at a time in numpy."""
    s, d1, w = a.shape
    consider = a[:, d1 - 1] if f is None else a[:, d1 - 1] & f
    count = sum(bin(int(x)).count("1") for x in consider.reshape(-1))
    k = min(max(-(-nth * count // 10000), 1), max(count, 1))
    words = sectors = 0
    for i in range(d1 - 2, -1, -1):
        words += int(np.count_nonzero(consider))
        sectors += int((consider.reshape(s, w // 8, 8) != 0).any(axis=2).sum())
        zeros = consider & ~a[:, i]
        c = sum(bin(int(x)).count("1") for x in zeros.reshape(-1))
        if k <= c:
            consider = zeros
        else:
            consider = consider & a[:, i]
            k -= c
    return words, sectors


@pytest.mark.parametrize(
    "depth,filt_kind,nth",
    [(0, None, 9500), (6, "dense", 9500), (24, None, 9500), (24, "dense", 9500),
     (24, "sparse", 5000), (9, "sparse", 1), (9, "empty", 10000)],
)
def test_bound_bsi_percentile(depth, filt_kind, nth):
    """chip_smoke's bound of the percentile search: the not-null plane and
    the filter read whole, each step's plane only in the sectors where
    that step's candidates lie, the bits and the count written; one
    popcount per word for the count and one per candidate word a step,
    the floor on a card slow enough for it."""
    import types

    smoke = _smoke()
    rng = np.random.default_rng(depth * 7 + len(filt_kind or "") + nth)
    s, w = 3, 64
    a = _u32(rng, (s, depth + 1, w))
    f = None
    if filt_kind == "dense":
        f = _u32(rng, (s, w))
    elif filt_kind == "sparse":
        f = rng.integers(0, 2**32, size=(s, w), dtype=np.uint32) * (rng.random((s, w)) < 0.2)
        f = f.astype(np.uint32)
    elif filt_kind == "empty":
        f = np.zeros((s, w), dtype=np.uint32)
    planes = _t(a)
    filt = _t(f) if f is not None else None
    words, sectors = _percentile_need_brute(a, f, nth)
    assert smoke.percentile_need(planes, filt, nth) == {
        "step_words": words, "step_sectors": sectors, "all_sectors": s * w // 8}
    if depth >= 9:
        # the search narrows: later steps read fewer sectors than a plane holds
        assert sectors < depth * s * w // 8
    h100 = types.SimpleNamespace(sms=132, sm_clock_hz=1.98e9)
    b = smoke.bound("bsi_percentile", (planes, filt, nth), h100)
    assert b["bytes"] == (1 + (f is not None)) * s * w * 4 + sectors * 32 + depth + 4
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / smoke.HBM_BYTES_PER_S * 1e3)
    popcounts = s * w + words
    assert b["popcount_ms"] == pytest.approx(popcounts / (132 * smoke.POPC_PER_CLOCK_PER_SM * 1.98e9) * 1e3)
    slow = smoke.bound("bsi_percentile", (planes, filt, nth), types.SimpleNamespace(sms=1, sm_clock_hz=1.0))
    assert slow["bound_by"] == "operations"
    assert slow["bound_ms"] == pytest.approx(popcounts / smoke.POPC_PER_CLOCK_PER_SM * 1e3)


def _minmax_need_brute(a, f, is_min):
    """(step words, step sectors) of K8's per-shard recurrences by numpy,
    one shard and one step at a time."""
    s, d1, w = a.shape
    words = sectors = 0
    for sh in range(s):
        consider = a[sh, d1 - 1] if f is None else a[sh, d1 - 1] & f[sh]
        for i in range(d1 - 2, -1, -1):
            words += int(np.count_nonzero(consider))
            sectors += int((consider.reshape(w // 8, 8) != 0).any(axis=1).sum())
            x = consider & ~a[sh, i] if is_min else consider & a[sh, i]
            if x.any():
                consider = x
    return words, sectors


@pytest.mark.parametrize("depth", [0, 1, 9, 24])
@pytest.mark.parametrize("filt_kind", [None, "sparse", "empty"])
@pytest.mark.parametrize("is_min", [True, False], ids=["min", "max"])
def test_bound_bsi_minmax_counts_the_narrowing_search(depth, filt_kind, is_min):
    """chip_smoke's bound of K8: the not-null plane and the filter read
    whole, each shard's step plane only in the sectors where that shard's
    candidates lie (Min keeps the clear side when any column has it, Max
    the set side), the bits and counts written; a test per candidate word
    a step and a popcount per word for the count."""
    import types

    smoke = _smoke()
    rng = np.random.default_rng(depth * 5 + len(filt_kind or "") + is_min)
    s, w = 3, 64
    a = _u32(rng, (s, depth + 1, w))
    f = None
    if filt_kind == "sparse":
        f = (rng.integers(0, 2**32, size=(s, w), dtype=np.uint32) * (rng.random((s, w)) < 0.2)).astype(np.uint32)
    elif filt_kind == "empty":
        f = np.zeros((s, w), dtype=np.uint32)
    planes = _t(a)
    filt = _t(f) if f is not None else None
    words, sectors = _minmax_need_brute(a, f, is_min)
    assert smoke.minmax_need(planes, filt, is_min) == {
        "step_words": words, "step_sectors": sectors, "all_sectors": s * w // 8}
    if depth >= 9 and filt_kind is None:
        assert sectors < depth * s * w // 8
    h100 = types.SimpleNamespace(sms=132, sm_clock_hz=1.98e9)
    b = smoke.bound("bsi_minmax", (planes, filt, is_min), h100)
    assert b["bytes"] == (1 + (f is not None)) * s * w * 4 + sectors * 32 + s * depth + s * 4
    tests = s * w + words
    assert b["popcount_ms"] == pytest.approx(tests / (132 * smoke.POPC_PER_CLOCK_PER_SM * 1.98e9) * 1e3)


@pytest.mark.parametrize("depth", [0, 4, 6, 7])
@pytest.mark.parametrize("with_filter", [False, True])
def test_bound_distinct_presence_counts_the_minterm_split(depth, with_filter):
    """chip_smoke's bound of K9: not-null and filter whole, the planes at
    the considered words, the presence words out; to 6 bits also the
    2^(D+1) - 2 logical operations a considered word, the floor on a card
    slow enough for it; deeper fields by bytes alone."""
    import types

    smoke = _smoke()
    rng = np.random.default_rng(depth * 3 + with_filter + 90)
    s, w = 2, 64
    a = _u32(rng, (s, depth + 1, w))
    a[:, depth, ::3] = 0
    f = _u32(rng, (s, w)) if with_filter else None
    if f is not None:
        f[:, 1::4] = 0
    considered = a[:, depth] if f is None else a[:, depth] & f
    words = int(np.count_nonzero(considered))
    planes, filt = _t(a), (_t(f) if f is not None else None)
    h100 = types.SimpleNamespace(sms=132, sm_clock_hz=1.98e9)
    b = smoke.bound("distinct_presence", (planes, filt, depth), h100)
    nwords = max(((1 << depth) + 31) // 32, 1)
    assert b["bytes"] == (1 + with_filter) * s * w * 4 + words * depth * 4 + nwords * 4
    assert b["bound_by"] == "bytes"
    ops_ = words * ((2 << depth) - 2) if depth <= 6 else 0
    assert b["popcount_ms"] == pytest.approx(ops_ / (132 * smoke.INT32_PER_CLOCK_PER_SM * 1.98e9) * 1e3)
    slow = smoke.bound("distinct_presence", (planes, filt, depth), types.SimpleNamespace(sms=1, sm_clock_hz=1.0))
    assert slow["bound_by"] == ("operations" if 0 < depth <= 6 else "bytes")


@pytest.mark.parametrize(
    "report,want",
    [("", 0),
     ("ptxas info    : Used 64 registers, used 1 barriers, 800 bytes smem\n"
      "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads", 0),
     ("    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
      "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads", 20)],
)
def test_smoke_spill_bytes_reads_ptxas(report, want):
    """chip_smoke.spill_bytes sums every kernel's spill stores and loads in
    ptxas -v output (a stack frame alone is no spill)."""
    assert _smoke().spill_bytes(report) == want


def test_recorder_counts_fusion_shapes():
    """chip_smoke's Recorder keeps, for each kernel that launches on the
    fusion path, each shape's launches there and the arguments of its
    first launch (up to its limit), and nothing for other paths."""
    import types

    smoke = _smoke()
    names = ("dense_scores", "sparse_stacked_scores", "tree_count", "groupby_reduce", "bsi_range",
             "expand_blocks", "word_delta_", "word_delta", "bsi_minmax", "distinct_presence", "bsi_percentile")
    fake = types.SimpleNamespace(**{n: (lambda *a: None) for n in names})
    rec = smoke.Recorder(fake)
    planes = torch.zeros((2, 5, 64), dtype=torch.int32)
    filt = torch.zeros((2, 64), dtype=torch.int32)
    rec.path = "ssb"
    fake.bsi_range(planes, (0x11, 0, 0, 0x2), 0)
    rec.path = "fusion"
    for _ in range(3):
        fake.bsi_range(planes, (0x11, 0, 0, 0x2), 0)
    fake.bsi_range(planes[:, 1:], (0x1, 0, 0), 0)
    fake.groupby_reduce([], filt, planes)
    fake.groupby_reduce([], filt, planes)
    fake.bsi_minmax(planes, None, True)
    fake.bsi_minmax(planes, filt, True)
    fake.bsi_minmax(planes, filt, False)
    fake.distinct_presence(planes, None, 4)
    k5 = rec.fusion_shapes["bsi_range"]
    assert sorted(n for n, _ in k5.values()) == [1, 3]
    assert all(kept is not None for _, kept in k5.values())
    assert [n for n, _ in rec.fusion_shapes["groupby_reduce"].values()] == [2]
    assert sorted(n for n, _ in rec.fusion_shapes["bsi_minmax"].values()) == [1, 1, 1]
    assert [n for n, _ in rec.fusion_shapes["distinct_presence"].values()] == [1]
    assert not rec.fusion_shapes["bsi_percentile"] and "dense_scores" not in rec.fusion_shapes
    assert set(rec.fusion_shapes) == set(smoke.FUSION_SHAPE_KERNELS)


@pytest.mark.parametrize("depth", [0, 1, 6, 7, 24])
def test_percentile_scratch_bytes_on_cpu(depth):
    """The fused percentile unit's admission charge off the card: K10's
    step counters (three u64 words a barrier, each in a 128-byte line: the
    count, then one barrier per two bits) and outputs as on its on-chip
    route, no [S, W] working set."""
    from pilosa_tpu_torch.ops import cuda

    planes = torch.zeros((), dtype=torch.int32).expand(58, depth + 1, 32768)
    assert cuda.percentile_scratch_bytes(planes) == 128 * 3 * (1 + (depth + 1) // 2) + depth + 4


@pytest.mark.parametrize("n_items", [1, 3, 5, 8, 16])
def test_smoke_client_streams(n_items):
    """chip_smoke's HTTP client streams: the rotating ones send every
    item from every client; the distinct ones send each item from one
    client only, so the pipeline can share no answer between them."""
    smoke = _smoke()
    items = [("i", f"Count(Row(f={k}))") for k in range(n_items)]
    rot = smoke.rotating_streams(items, 8)
    assert len(rot) == 8 and all(sorted(s) == sorted(items) for s in rot)
    dist = smoke.distinct_streams(items, 8)
    assert len(dist) == min(8, n_items)
    assert all(len(s) == n_items for s in dist)
    owner = {}
    for ci, s in enumerate(dist):
        for it in s:
            assert owner.setdefault(it, ci) == ci
    assert set(owner) == set(items)


def _kernel_constants(source: str) -> dict:
    """``constexpr int name = value;`` lines of a kernel source, evaluated
    (products of integers only)."""
    import os
    import re

    from pilosa_tpu_torch.ops import _build

    with open(os.path.join(_build.KERNEL_DIR, source)) as f:
        text = f.read()
    out = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([\w\s*]+);", text):
        val = 1
        for factor in expr.split("*"):
            factor = factor.strip()
            val *= out[factor] if factor in out else int(factor)
        out[name] = val
    return out


def test_minmax_routes_agree_with_the_kernel():
    """K8 holds ``consider`` in registers for a whole shard of 2^20
    columns (the staged width), and its shared route takes every width
    the wrapper accepts (at most 32 vectors a thread, within the kernel's
    shared memory), so no width the wrapper lets through is refused at
    launch."""
    from pilosa_tpu_torch import SHARD_WIDTH
    from pilosa_tpu_torch.ops import cuda

    k = _kernel_constants("bsi_minmax.cu")
    assert k["kCluster"] * k["kRegMaxVectors"] * 4 == SHARD_WIDTH // 32
    sv = cuda.BSI_MINMAX_MAX_WORDS // 32
    assert sv <= k["kSmemMaxVec"] * k["kSmemThreads"] and sv * 16 <= k["kDynBudget"]
