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
