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
