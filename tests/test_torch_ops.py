"""The port's plain kernel versions against the JAX package's functions.

Same inputs (numpy, from a seed) go through ``pilosa_tpu.ops`` (XLA on
the CPU, the Pallas kernels in interpret mode) and through
``pilosa_tpu_torch.ops`` on CPU tensors, where every public scorer runs
its plain PyTorch version. Outputs are integers, so the bar is ==.
Inputs include all-ones words (0xFFFFFFFF), which catch sign bugs in the
port's int32 view of the u32 words.
"""

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
