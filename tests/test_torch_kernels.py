"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Integer outputs: the bar is ==.

These tests need an NVIDIA card and nvcc; without CUDA they skip (the
plain versions are held against the JAX package in test_torch_ops.py).
Run on a GPU machine with: python -m pytest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch import ops
from pilosa_tpu_torch.ops import delta

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ops.build_kernels()
    return torch.device("cuda")


def _words(rng, shape, dev, ones_rows=1):
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    # all-ones words catch sign bugs in the int32 view
    a.reshape(-1, shape[-1])[:ones_rows] = 0xFFFFFFFF
    return ops.words_from_numpy(a, dev)


@pytest.mark.parametrize(
    "q,r,w",
    [(1, 5, 4096), (3, 130, 4096), (8, 64, 32768), (33, 17, 1024),
     (9, 40, 1028), (32, 33, 2052), (1, 17, 516), (4, 16, 4), (65, 3, 260)],
)
def test_dense_scores_matches_plain(dev, q, r, w):
    rng = np.random.default_rng(q * 1000 + r)
    srcs = _words(rng, (q, w), dev)
    mat = _words(rng, (r, w), dev, ones_rows=2)
    before = ops.cuda.DENSE_SCORES.launches
    got = ops.cuda.dense_scores(srcs, mat)
    torch.cuda.synchronize()
    assert ops.cuda.DENSE_SCORES.launches == before + 1
    want = ops.intersection_counts_matrix_plain(srcs, mat)
    assert torch.equal(got, want)
    # the public wrapper routes CUDA tensors to the kernel
    assert torch.equal(ops.intersection_counts_matrix(srcs[0], mat), want[0])


def _sparse(rng, shape, dev, ands=5):
    """Words whose bits are set with probability 2^-(ands + 1)."""
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    for _ in range(ands):
        a &= rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return ops.words_from_numpy(a, dev)


@pytest.mark.parametrize("q", [1, 3, 8, 9, 32, 33])
@pytest.mark.parametrize("r,w", [(37, 1540), (16, 8192)])
def test_dense_scores_sparse_zero_and_full_sources(dev, q, r, w):
    """Sources at the dense workload's density (1/64), one all-zero and
    one all-ones, against a sparse matrix: R not a multiple of the 16-row
    tile, W not a multiple of the word tile."""
    rng = np.random.default_rng(q * 7 + r + w)
    srcs = _sparse(rng, (q, w), dev)
    srcs[0] = 0
    srcs[-1] = -1
    mat = _sparse(rng, (r, w), dev)
    mat[r // 2] = -1
    got = ops.cuda.dense_scores(srcs, mat)
    want = ops.intersection_counts_matrix_plain(srcs, mat)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if q > 1:
        assert int(got[0].abs().sum()) == 0


@pytest.mark.parametrize("q,s,with_shard", [(1, 1, False), (1, 3, True), (5, 3, True), (40, 2, True)])
def test_sparse_scores_matches_plain(dev, q, s, with_shard):
    rng = np.random.default_rng(q * 10 + s)
    w = 4 * 2048
    num_rows = 24
    b = 300
    srcs = _words(rng, (q, s, w), dev)
    blocks = _words(rng, (b, 2048), dev)
    brow = rng.integers(0, num_rows, size=b).astype(np.int32)
    brow[:40] = 3  # duplicate rows add up
    brow[-1] = num_rows + 5  # out of range: dropped
    bslot = rng.integers(0, w // 2048, size=b).astype(np.int32)
    bshard = rng.integers(0, s, size=b).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    shard = t(bshard) if with_shard else None
    if not with_shard:
        srcs = srcs[:, :1].contiguous()
    got = ops.cuda.sparse_stacked_scores(srcs, blocks, t(brow), t(bslot), shard, num_rows)
    torch.cuda.synchronize()
    want = ops.sparse_stacked_scores_plain(srcs, blocks, t(brow), t(bslot), shard, num_rows)
    assert torch.equal(got, want)


TREES = [
    ("leaf", 0),
    ("Intersect", (("Union", (("leaf", 0), ("leaf", 1))), ("Union", (("leaf", 2), ("leaf", 3))))),
    ("Union", (("Intersect", (("leaf", 0), ("leaf", 1))), ("Intersect", (("leaf", 2), ("leaf", 3))), ("leaf", 0))),
    ("Difference", (("Union", (("leaf", 0), ("leaf", 1), ("leaf", 2))), ("leaf", 3))),
    ("Xor", (("leaf", 0), ("Difference", (("leaf", 1), ("leaf", 2))), ("leaf", 3))),
]


@pytest.mark.parametrize("tree", TREES, ids=range(len(TREES)))
@pytest.mark.parametrize("q", [1, 4])
def test_tree_count_matches_plain(dev, tree, q):
    rng = np.random.default_rng(len(repr(tree)) + q)
    prog = ops.TreeProgram(tree)
    leaves = [[_words(rng, (3, 8192), dev) for _ in range(prog.nleaves)] for _ in range(q)]
    got = ops.cuda.tree_count(leaves, prog)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.tree_count_plain(leaves, prog))


def test_count_bits_on_card(dev):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2**32, size=(64, 32768), dtype=np.uint32)
    got = int(ops.count_bits(ops.words_from_numpy(a, dev)))
    assert got == int(np.bitwise_count(a).sum())


def test_wrapper_rejects_misaligned(dev):
    mat = torch.zeros((4, 1024), dtype=torch.int32, device=dev)
    flat = torch.zeros(4100, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ops.cuda.dense_scores(flat[1:1025].view(1, 1024), mat)
    with pytest.raises(ValueError):
        ops.cuda.tree_count([[flat[1:4097]]], ops.TreeProgram(("leaf", 0)))


def test_tree_count_rejects_too_many_leaf_pointers(dev):
    """One launch takes TREE_MAX_REFS leaf references and
    TREE_MAX_DISTINCT distinct leaves; past either the wrapper raises and
    the public function splits the batch."""
    prog = ops.TreeProgram(("Union", (("leaf", 0), ("leaf", 1))))
    leaf = torch.zeros((1, 1024), dtype=torch.int32, device=dev)
    q = ops.cuda.TREE_MAX_REFS // 2
    assert ops.cuda.tree_count([[leaf, leaf]] * q, prog).shape == (q,)
    with pytest.raises(ValueError):
        ops.cuda.tree_count([[leaf, leaf]] * (q + 1), prog)
    rng = np.random.default_rng(9)
    many = [[_words(rng, (1, 1024), dev), leaf] for _ in range(ops.cuda.TREE_MAX_DISTINCT)]
    with pytest.raises(ValueError):
        ops.cuda.tree_count(many, prog)
    # the public function splits a wider batch into several launches
    for leaves in (many, [[leaf, leaf]] * (q + 3)):
        before = ops.cuda.TREE_COUNT.launches
        got = ops.tree_count(leaves, prog)
        assert ops.cuda.TREE_COUNT.launches == before + 2
        assert torch.equal(got, ops.tree_count_plain(leaves, prog))


def test_tree_count_shared_leaves_at_the_chain_shape(dev):
    """Q=4 coalesced 5-leaf chains over 12 distinct 64 x 32768 leaf stacks
    (the tall chains' launch), and a batch at the new limits: one launch
    each, == plain."""
    rng = np.random.default_rng(31)
    tree = ("Union", (("Intersect", (("leaf", 0), ("leaf", 1))), ("Intersect", (("leaf", 2), ("leaf", 3))), ("leaf", 4)))
    prog = ops.TreeProgram(tree)
    pool = [_words(rng, (64, 32768), dev) for _ in range(12)]
    picks = [(0, 1, 2, 3, 4), (0, 5, 6, 3, 7), (8, 1, 9, 3, 10), (0, 11, 2, 3, 4)]
    leaves = [[pool[i] for i in p] for p in picks]
    assert len(ops.tree_tables(leaves)[0]) == 12
    before = ops.cuda.TREE_COUNT.launches
    got = ops.tree_count(leaves, prog)
    torch.cuda.synchronize()
    assert ops.cuda.TREE_COUNT.launches == before + 1
    assert torch.equal(got, ops.tree_count_plain(leaves, prog))
    # 307 queries x 5 leaves = 1535 references over 256 distinct leaves
    small = [_words(rng, (2, 1024), dev) for _ in range(256)]
    n = ops.cuda.TREE_MAX_REFS // 5
    wide = [[small[(5 * k + j) % 256] for j in range(5)] for k in range(n)]
    before = ops.cuda.TREE_COUNT.launches
    got = ops.tree_count(wide, prog)
    assert ops.cuda.TREE_COUNT.launches == before + 1
    assert torch.equal(got, ops.tree_count_plain(wide, prog))


def test_tree_count_deepest_stack_with_most_leaves(dev):
    """A tree 16 deep (15 operators, a spilled stack entry at each level)
    over 16 queries of 16 leaves each, 256 distinct: the ring's widest
    stage beside the most stack slots, one launch, == plain."""
    ops_cycle = ("Intersect", "Union", "Xor", "Difference")
    tree = ("leaf", 15)
    for i in reversed(range(15)):
        tree = (ops_cycle[i % 4], (("leaf", i), tree))
    prog = ops.TreeProgram(tree)
    assert prog.depth == ops.packed.TREE_MAX_STACK and prog.spill == 14
    rng = np.random.default_rng(16)
    pool = [_words(rng, (1, 4096), dev) for _ in range(256)]
    leaves = [pool[16 * k : 16 * (k + 1)] for k in range(16)]
    before = ops.cuda.TREE_COUNT.launches
    got = ops.tree_count(leaves, prog)
    torch.cuda.synchronize()
    assert ops.cuda.TREE_COUNT.launches == before + 1
    assert torch.equal(got, ops.tree_count_plain(leaves, prog))


@pytest.mark.parametrize("n_words", [4, 1024, 4100, 32768, 58 * 32768, 64 * 32768 + 12])
def test_count_bits_one_launch(dev, n_words):
    """The one-leaf count at tile-ragged sizes: one launch, no memset, and
    the per-stream accumulator left at zero for the next count."""
    rng = np.random.default_rng(n_words)
    a = rng.integers(0, 2**32, size=n_words, dtype=np.uint32)
    a[:3] = 0xFFFFFFFF
    t = ops.words_from_numpy(a, dev)
    want = int(np.bitwise_count(a).sum())
    before = ops.cuda.TREE_COUNT.launches
    assert int(ops.count_bits(t)) == want
    assert int(ops.count_bits(t)) == want
    assert ops.cuda.TREE_COUNT.launches == before + 2
    # another stream has its own accumulator
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        got = ops.count_bits(t)
    s.synchronize()
    assert int(got) == want


# -- K4 groupby_reduce and K5 bsi_range ------------------------------------------------


@pytest.mark.parametrize(
    "rows,p,s,with_filter,w",
    [((), 25, 58, True, 2048), ((), 7, 3, False, 2048), ((7, 40), 25, 4, True, 2048),
     ((5, 5, 6), 25, 2, True, 2048), ((3,), 0, 2, False, 2048), ((1,), 64, 1, True, 2048),
     ((2, 3), 9, 1, False, 2048), ((600,), 3, 1, True, 2048), ((9,), 40, 3, False, 2048),
     ((4, 5), 25, 3, True, 400), ((10, 10, 6), 25, 5, True, 4096 + 36)],
)
def test_groupby_reduce_matches_plain(dev, rows, p, s, with_filter, w):
    """Small K (warps split the words) and K >= 8 (planes staged in shared
    memory, tiles cut at shard ends and ragged shard widths)."""
    rng = np.random.default_rng(sum(rows) + p + s)
    dims = [_words(rng, (r, s, w), dev) for r in rows]
    filt = _words(rng, (s, w), dev) if with_filter else None
    planes = _words(rng, (s, p, w), dev) if p else torch.empty((s, 0, w), dtype=torch.int32, device=dev)
    before = ops.cuda.GROUPBY_REDUCE.launches
    got = ops.groupby_reduce(dims, filt, planes)
    torch.cuda.synchronize()
    assert ops.cuda.GROUPBY_REDUCE.launches == before + 1
    want = ops.groupby_reduce_plain(dims, filt, planes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _dense38(rng, shape, dev):
    """Set-field rows where a column sits in about 3 of every 8 rows."""
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    a &= rng.integers(0, 2**32, size=shape, dtype=np.uint32) | rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return ops.words_from_numpy(a, dev)


# name: (rows per dimension, planes, shards, words per shard, filter, dense rows)
WALK_CASES = {
    "nonexclusive": ((8, 8), 25, 3, 1024, "sparse", True),
    "dense_count_only": ((5, 5), 0, 2, 4096, None, True),
    "dense_count_only_64_groups": ((4, 4, 4), 0, 3, 1036, None, True),
    "dense_count_only_65_groups": ((5, 13), 0, 2, 1024, None, True),
    "dense_count_only_17_rows": ((14, 3), 0, 2, 1024, None, True),
    "dense_planes_no_filter": ((8, 8), 25, 2, 1024, None, True),
    "dense_31_planes": ((4, 4), 31, 2, 1036, None, True),
    "dense_32_planes": ((3, 3), 32, 1, 512, None, True),
    "past_shared_histogram": ((100, 40), 25, 1, 256, "sparse", True),
    "k1_filter": ((), 25, 3, 2048, "sparse", False),
    "k1_no_filter": ((), 25, 3, 2048, None, False),
    "k1_one_row_dims": ((1, 1), 7, 2, 1024, "sparse", True),
    "p0": ((6, 7), 0, 2, 1024, "sparse", True),
    "p64": ((3, 4), 64, 2, 1024, "sparse", True),
    "one_dim": ((50,), 9, 2, 2048, "sparse", False),
    "eight_dims": ((2, 2, 2, 2, 2, 2, 2, 3), 3, 2, 1024, None, True),
    "filter_all_zero": ((4, 3), 5, 2, 512, "zero", True),
    "ragged_words": ((3, 5), 11, 3, 36, "dense", True),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_groupby_reduce_walk_cases(dev, case):
    """The enumerating kernel (K >= 2), the streaming one (K = 1) and the
    count-only ring (no filter, no planes, K <= 64, 16 rows) at the shapes
    that stress each: columns in several rows of one dimension, a dense
    cross product with no filter, a histogram too big for shared
    memory (4,000 groups x 26 counts), P = 0 and P = 64, 1 and 8
    dimensions, an all-zero filter, shards of 36 words."""
    rows, p, s, w, filt_kind, dense_rows = WALK_CASES[case]
    rng = np.random.default_rng(len(case) * 31 + p)
    dims = [(_dense38 if dense_rows else _sparse)(rng, (r, s, w), dev) for r in rows]
    if dims and dims[0].shape[0] > 1:
        dims[0][1] |= dims[0][0]  # a column in two rows of one dimension
    filt = None
    if filt_kind == "sparse":
        filt = _sparse(rng, (s, w), dev, ands=3)
        filt[0, :8] = -1
    elif filt_kind == "zero":
        filt = torch.zeros((s, w), dtype=torch.int32, device=dev)
    elif filt_kind == "dense":
        filt = _words(rng, (s, w), dev)
    planes = _words(rng, (s, p, w), dev) if p else torch.empty((s, 0, w), dtype=torch.int32, device=dev)
    got = ops.cuda.groupby_reduce(dims, filt, planes)
    want = ops.groupby_reduce_plain(dims, filt, planes)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_groupby_reduce_flat_and_strided_layouts(dev):
    """[R, Wf] dimensions with [P, Wf] planes, and a strided [S, P, W]
    slice of a wider stack, read in place."""
    rng = np.random.default_rng(77)
    dims = [_words(rng, (6, 3 * 4096), dev), _words(rng, (5, 3 * 4096), dev)]
    planes = _words(rng, (11, 3 * 4096), dev)
    got = ops.groupby_reduce(dims, None, planes)
    want = ops.groupby_reduce_plain(dims, None, planes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    wide = _words(rng, (4, 30, 1024), dev)
    sub = wide[:, 3:20]
    d = [_words(rng, (3, 4, 1024), dev)]
    got = ops.groupby_reduce(d, None, sub)
    want = ops.groupby_reduce_plain(d, None, sub.contiguous())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("depth", [1, 6, 24, 41])
@pytest.mark.parametrize("op", ["==", "!=", "<", "<=", ">", ">=", "><"])
def test_bsi_range_matches_plain(dev, depth, op):
    rng = np.random.default_rng(depth * 7 + len(op))
    planes = _words(rng, (5, depth + 1, 4096), dev, ones_rows=3)
    top = (1 << depth) - 1
    for pred in sorted({0, top, int(rng.integers(0, top + 1))}):
        hi = min(top, pred * 3 + 1)
        code, out_sel = ops.range_program(op, depth, pred, hi)
        before = ops.cuda.BSI_RANGE.launches
        got = ops.bsi_range(planes, op, depth, pred, hi)
        torch.cuda.synchronize()
        assert ops.cuda.BSI_RANGE.launches == before + 1
        assert torch.equal(got, ops.bsi_range_plain(planes, code, out_sel)), (op, pred)
    # one shard's [D+1, W] and a strided plane view
    assert torch.equal(ops.bsi_range(planes[2], op, depth, 1, 1), ops.bsi_range(planes, op, depth, 1, 1)[2])


def test_bsi_device_recurrences_on_card(dev):
    """Min/Max run on K8 (one shard, a batch folded, the per-shard form),
    Percentile on K10 (one launch, no tree count), Distinct on K9; all
    agree with the CPU run."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2**32, size=(3, 11, 1024), dtype=np.uint32)
    filt = rng.integers(0, 2**32, size=(3, 1024), dtype=np.uint32)
    gpu = (ops.words_from_numpy(a, dev), ops.words_from_numpy(filt, dev))
    cpu = (ops.words_from_numpy(a, "cpu"), ops.words_from_numpy(filt, "cpu"))
    for fn, args in [
        (ops.bsi_min, dict(bit_depth=10, has_filter=True)),
        (ops.bsi_max, dict(bit_depth=10, has_filter=False)),
    ]:
        gb, gc = fn(*gpu, **args)
        cb, cc = fn(*cpu, **args)
        assert gb.cpu().tolist() == cb.tolist() and int(gc) == int(cc)
        before = ops.cuda.BSI_MINMAX.launches
        gb, gc = fn(gpu[0][1], gpu[1][1], **args)
        assert ops.cuda.BSI_MINMAX.launches == before + 1
        cb, cc = fn(cpu[0][1], cpu[1][1], **args)
        assert gb.cpu().tolist() == cb.tolist() and int(gc) == int(cc)
    for is_min in (True, False):
        gb, gc = ops.bsi_minmax_batched(*gpu, is_min=is_min, bit_depth=10, has_filter=True)
        cb, cc = ops.bsi_minmax_batched(*cpu, is_min=is_min, bit_depth=10, has_filter=True)
        assert torch.equal(gb.cpu(), cb) and torch.equal(gc.cpu(), cc)
    k3, k10 = ops.cuda.TREE_COUNT.launches, ops.cuda.BSI_PERCENTILE.launches
    gb, gc = ops.bsi_percentile_batched(*gpu, 9500, bit_depth=10, has_filter=True)
    assert (ops.cuda.TREE_COUNT.launches, ops.cuda.BSI_PERCENTILE.launches) == (k3, k10 + 1)
    cb, cc = ops.bsi_percentile_batched(*cpu, 9500, bit_depth=10, has_filter=True)
    assert gb.cpu().tolist() == cb.tolist() and int(gc) == int(cc)
    got = ops.bsi_distinct_presence(*gpu, bit_depth=10, has_filter=True)
    assert torch.equal(got.cpu(), ops.bsi_distinct_presence(*cpu, bit_depth=10, has_filter=True))


@pytest.mark.parametrize("depth", [0, 24, 41])
@pytest.mark.parametrize("s,w", [(1, 32768), (3, 4096), (58, 32768)])
@pytest.mark.parametrize("with_filter", [False, True])
def test_bsi_minmax_matches_plain(dev, depth, s, w, with_filter):
    """K8 == its plain version, Min and Max, one launch each: all-ones
    planes, a shard with no value, a filter emptying a shard, a sparse
    filter that branches both ways."""
    rng = np.random.default_rng(depth * 100 + s + with_filter)
    a = rng.integers(0, 2**32, size=(s, depth + 1, w), dtype=np.uint32)
    a[0, : depth // 2] = 0xFFFFFFFF
    f = rng.integers(0, 2**32, size=(s, w), dtype=np.uint32)
    if s > 1:
        a[1, depth] = 0
        f[-1] = 0
        f[s // 2] &= np.uint32(0x00010001)
    planes = ops.words_from_numpy(a, dev)
    filt = ops.words_from_numpy(f, dev) if with_filter else None
    for is_min in (True, False):
        before = ops.cuda.BSI_MINMAX.launches
        got = ops.cuda.bsi_minmax(planes, filt, is_min)
        torch.cuda.synchronize()
        assert ops.cuda.BSI_MINMAX.launches == before + 1
        want = ops.bsi_minmax_plain(planes, filt, is_min)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), is_min


def test_bsi_minmax_strided_and_rejects(dev):
    """A plane stack read in place through its strides; a shard width not
    a multiple of 8 x 4 words raises."""
    rng = np.random.default_rng(6)
    wide = ops.words_from_numpy(rng.integers(0, 2**32, size=(4, 30, 2048), dtype=np.uint32), dev)
    sub = wide[:, 3:14]
    got = ops.cuda.bsi_minmax(sub, None, True)
    want = ops.bsi_minmax_plain(sub.contiguous(), None, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        ops.cuda.bsi_minmax(torch.zeros((2, 5, 2048 + 16), dtype=torch.int32, device=dev), None, True)


def _percentile_once(planes, filt, nth):
    """One K10 call: one launch of it and none of the tree count, and its
    outputs == the plain version's."""
    k3, k10 = ops.cuda.TREE_COUNT.launches, ops.cuda.BSI_PERCENTILE.launches
    got = ops.cuda.bsi_percentile(planes, filt, nth)
    torch.cuda.synchronize()
    assert (ops.cuda.TREE_COUNT.launches, ops.cuda.BSI_PERCENTILE.launches) == (k3, k10 + 1)
    want = ops.bsi_percentile_plain(planes, filt, nth)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32 and got[1].dim() == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), nth
    return got


@pytest.mark.parametrize("depth", [0, 9, 24])
@pytest.mark.parametrize("s,w", [(1, 32768), (3, 4096), (58, 32768)])
@pytest.mark.parametrize("with_filter", [False, True])
def test_bsi_percentile_matches_plain(dev, depth, s, w, with_filter):
    """K10 on its on-chip route == its plain version at every nth, one
    launch and no tree count each: all-ones planes, a shard with no
    value, a filter emptying a shard and a sparse one."""
    rng = np.random.default_rng(depth * 100 + s + with_filter + 7)
    a = rng.integers(0, 2**32, size=(s, depth + 1, w), dtype=np.uint32)
    a[0, : depth // 2] = 0xFFFFFFFF
    f = rng.integers(0, 2**32, size=(s, w), dtype=np.uint32)
    if s > 1:
        a[1, depth] = 0
        f[-1] = 0
        f[s // 2] &= np.uint32(0x00010001)
    planes = ops.words_from_numpy(a, dev)
    filt = ops.words_from_numpy(f, dev) if with_filter else None
    assert ops.cuda.percentile_on_chip(planes)
    for nth in (0, 1, 5000, 9500, 9999, 10000):
        _percentile_once(planes, filt, nth)


@pytest.mark.parametrize("with_filter", [False, True])
def test_bsi_percentile_global_route(dev, with_filter):
    """Two shards past what the on-chip route holds, ``consider`` lives in
    an [S, W] scratch in device memory: == the plain version."""
    w = 32768
    s = ops.cuda.percentile_grid(dev)[1] // w + 2
    g = torch.Generator(device=dev).manual_seed(5 + with_filter)
    planes = torch.randint(-(2**31), 2**31, (s, 10, w), dtype=torch.int32, generator=g, device=dev)
    assert not ops.cuda.percentile_on_chip(planes)
    filt = None
    if with_filter:
        filt = torch.randint(-(2**31), 2**31, (s, w), dtype=torch.int32, generator=g, device=dev)
        filt[3] = 0
    for nth in (1, 5000, 10000):
        _percentile_once(planes, filt, nth)


def _sector_filter(rng, s, w):
    """A filter that empties whole 32-byte sectors (every other 8-word
    run), one whole shard, and leaves single bits elsewhere in part."""
    f = rng.integers(0, 2**32, size=(s, w), dtype=np.uint32)
    f.reshape(s, w // 8, 8)[:, ::2] = 0
    f[s // 2] = 0
    f[-1, 8::64] = 1 << 7
    return f


@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4, 5, 7, 8, 13, 16, 23, 24])
@pytest.mark.parametrize("with_filter", [False, True])
def test_bsi_percentile_two_bit_steps(dev, depth, with_filter):
    """K10 decides two bits a barrier, and an odd depth ends with one
    single-bit step: == the plain version at even and odd depths, with
    all-ones and all-zero planes among random ones, k at 1 and at count
    (nth 0 and 10000), and a filter that empties whole sectors and a
    whole shard."""
    rng = np.random.default_rng(700 + depth * 2 + with_filter)
    s, w = 3, 4096
    a = rng.integers(0, 2**32, size=(s, depth + 1, w), dtype=np.uint32)
    if depth >= 2:
        a[:, depth - 1] = 0xFFFFFFFF
        a[:, depth // 2] = 0
    planes = ops.words_from_numpy(a, dev)
    filt = ops.words_from_numpy(_sector_filter(rng, s, w), dev) if with_filter else None
    assert ops.cuda.percentile_on_chip(planes)
    for nth in (0, 1, 2500, 5000, 9999, 10000):
        _percentile_once(planes, filt, nth)


@pytest.mark.parametrize("depth", [1, 6, 7, 24])
@pytest.mark.parametrize("side", ["set", "clear"])
def test_bsi_percentile_consider_dies_after_one_step(dev, depth, side):
    """One column alone on its side of the top plane: the search takes
    that side at the first step (nth 10000 for the set side, 0 for the
    clear one), so every other vector of ``consider`` dies and no later
    step reads it; the answer is that column's value. Also with the rest
    filtered away."""
    rng = np.random.default_rng(800 + depth + (side == "set"))
    s, w = 5, 2048
    a = rng.integers(0, 2**32, size=(s, depth + 1, w), dtype=np.uint32)
    lone = np.uint32(1 << 19)
    if side == "set":
        a[:, depth - 1] = 0
        a[3, depth - 1, 1001] = lone
        nth = 10000
    else:
        a[:, depth - 1] = 0xFFFFFFFF
        a[3, depth - 1, 1001] = ~lone
        nth = 0
    a[3, depth, 1001] |= lone
    planes = ops.words_from_numpy(a, dev)
    bits, count = _percentile_once(planes, None, nth)
    want = [int(a[3, i, 1001] >> 19 & 1) for i in range(depth)]
    assert bits.cpu().tolist() == [bool(b) for b in want]
    f = np.zeros((s, w), dtype=np.uint32)
    f[3, 1001] = lone
    f[0, :64] = 0xFFFFFFFF
    _percentile_once(planes, ops.words_from_numpy(f, dev), nth)


@pytest.mark.parametrize("count", [1, (1 << 16) - 1, 1 << 16, (1 << 24) - 1, 1 << 24])
@pytest.mark.parametrize("depth", [7, 8])
def test_bsi_percentile_count_packing_edges(dev, count, depth):
    """K10 sums a step's three counts in one step word below 2^16
    considered columns, in two below 2^24, else in three: == the plain
    version with exactly ``count`` columns considered on each side of
    those edges, at an odd and an even depth."""
    w = 32768
    s = (count - 1) // (w * 32) + 1
    rng = np.random.default_rng(count % 1000 + depth)
    a = rng.integers(0, 2**32, size=(s, depth + 1, w), dtype=np.uint32)
    nn = np.zeros(s * w, dtype=np.uint32)
    nn[: count // 32] = 0xFFFFFFFF
    if count % 32:
        nn[count // 32] = (1 << (count % 32)) - 1
    a[:, depth] = nn.reshape(s, w)
    planes = ops.words_from_numpy(a, dev)
    for nth in (1, 5000, 10000):
        _, got = _percentile_once(planes, None, nth)
        assert int(got) == count


@pytest.mark.parametrize("depth", [7, 24])
def test_bsi_percentile_global_route_odd_depth_and_sectors(dev, depth):
    """The global route at an odd and an even depth under a filter that
    empties whole sectors and a whole shard, and through a strided view:
    == the plain version at nth 0, 1, 5000 and 10000."""
    w = 32768
    s = ops.cuda.percentile_grid(dev)[1] // w + 2
    g = torch.Generator(device=dev).manual_seed(900 + depth)
    wide = torch.randint(-(2**31), 2**31, (s, depth + 3, w), dtype=torch.int32, generator=g, device=dev)
    planes = wide[:, 1 : depth + 2]
    assert not ops.cuda.percentile_on_chip(planes)
    filt = torch.randint(-(2**31), 2**31, (s, w), dtype=torch.int32, generator=g, device=dev)
    filt.view(s, w // 8, 8)[:, 1::2] = 0
    filt[s // 3] = 0
    for nth in (0, 1, 5000, 10000):
        _percentile_once(planes, filt, nth)


def test_bsi_percentile_edges_strided_and_rejects(dev):
    """An all-zero filter (count 0: every bit set), a strided plane view
    read in place, a launch under set_sync_debug_mode("error"), and what
    the wrapper refuses."""
    rng = np.random.default_rng(12)
    wide = ops.words_from_numpy(rng.integers(0, 2**32, size=(4, 30, 2048 + 8), dtype=np.uint32), dev)
    sub = wide[:, 3:14, 4 : 2048 + 4]
    zero = torch.zeros((4, 2048), dtype=torch.int32, device=dev)
    bits, count = _percentile_once(sub, zero, 5000)
    assert bits.all() and int(count) == 0
    _percentile_once(sub, None, 9500)
    assert torch.equal(
        ops.cuda.bsi_percentile(sub, None, 9500)[0], ops.cuda.bsi_percentile(sub.contiguous(), None, 9500)[0]
    )
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.bsi_percentile_batched(sub, zero, 50, bit_depth=10, has_filter=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = ops.bsi_percentile_plain(sub, None, 50)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for planes, nth in (
        (torch.zeros((2, 5, 2048 + 2), dtype=torch.int32, device=dev), 50),
        (sub, 10001),
        (sub, -1),
        (torch.zeros((1, 65, 32), dtype=torch.int32, device=dev), 50),
    ):
        with pytest.raises(ValueError):
            ops.cuda.bsi_percentile(planes, None, nth)


# -- K6 expand_blocks and K7 word_delta -----------------------------------------------

SW = 1 << 20
W32 = SW // 32


def _roaring_payloads(rng, rows, padded):
    """Roaring-valid payloads over ``rows`` rows (containers and runs
    disjoint): per row, array containers in slots 0-5, runs in slots 6-9
    (same-word, word-crossing, a full 2^16-bit container, width 1), a
    bitmap container in slot 11; the contract's padding when
    ``padded``."""
    pos, starts, ends, dense, dword = [], [], [], [], []
    for r in range(rows):
        base = r * SW
        for slot in range(6):
            pos.append(base + (slot << 16) + rng.choice(65536, int(rng.integers(1, 600)), replace=False))
        s6 = base + (6 << 16)
        for s, e in [(3, 9), (40, 40), (100, 5000), (6000, 65535)]:
            starts.append(s6 + s)
            ends.append(s6 + e)
        starts += [base + (7 << 16), base + (9 << 16) + 31]
        ends += [base + (8 << 16) + 65535, base + (9 << 16) + 32]
        w = rng.integers(0, 2**32, size=2048, dtype=np.uint32)
        w[:3] = 0xFFFFFFFF
        dense.append(w)
        dword.append(r * W32 + (11 << 11))
    pos = np.concatenate(pos).astype(np.uint32)
    starts, ends = np.array(starts, np.uint32), np.array(ends, np.uint32)
    dense, dword = np.stack(dense), np.array(dword, np.int32)
    num_words = rows * W32
    if padded:
        pos = np.concatenate([pos, np.full(5, 0xFFFFFFFF, np.uint32)])
        starts = np.concatenate([starts, [1, 7]]).astype(np.uint32)
        ends = np.concatenate([ends, [0, 3]]).astype(np.uint32)
        dense = np.concatenate([dense, np.zeros((2, 2048), np.uint32)])
        dword = np.concatenate([dword, [num_words, num_words]]).astype(np.int32)
    return pos, starts, ends, dense, dword, num_words


def _on(dev, a):
    return torch.from_numpy(np.ascontiguousarray(a).view("<i4").copy()).to(dev)


@pytest.mark.parametrize("rows,padded", [(1, False), (3, True), (128, True)])
def test_expand_blocks_matches_plain(dev, rows, padded):
    rng = np.random.default_rng(rows)
    *arrays, num_words = _roaring_payloads(rng, rows, padded)
    args = [_on(dev, a) for a in arrays]
    before = ops.cuda.EXPAND_BLOCKS.launches
    got = ops.expand_blocks(*args, num_words)
    torch.cuda.synchronize()
    assert ops.cuda.EXPAND_BLOCKS.launches == before + 1
    assert torch.equal(got, ops.expand_blocks_plain(*args, num_words))


def test_expand_blocks_single_kinds_and_empty(dev):
    rng = np.random.default_rng(12)
    pos, starts, ends, dense, dword, num_words = _roaring_payloads(rng, 2, True)
    none = np.zeros(0, np.uint32)
    for case in (
        (pos, none, none, np.zeros((0, 2048), np.uint32), np.zeros(0, np.int32)),
        (none, starts, ends, np.zeros((0, 2048), np.uint32), np.zeros(0, np.int32)),
        (none, none, none, dense, dword),
        (none, none, none, np.zeros((0, 2048), np.uint32), np.zeros(0, np.int32)),
    ):
        args = [_on(dev, a) for a in case]
        assert torch.equal(ops.expand_blocks(*args, num_words), ops.expand_blocks_plain(*args, num_words))
    # runs alone are the Pallas kernel's function
    st, en = _on(dev, starts), _on(dev, ends)
    none_t = _on(dev, none)
    got = ops.expand_blocks(none_t, st, en, _on(dev, np.zeros((0, 2048), np.uint32)), none_t, num_words)
    assert torch.equal(got, ops.expand_runs_plain(st, en, num_words))


@pytest.mark.parametrize("num_words", [2048, 5000, 3 * W32, 3 * W32 + 100])
def test_expand_blocks_binned_shuffled_and_misbinned(dev, num_words):
    """Unbinned input in any order (runs across spans, bitmap blocks off
    their spans, words past the end) through the binning, and binned
    input with offsets that misname spans: the kernel equals the plain
    version over the same bins, and over the unbinned input."""
    rng = np.random.default_rng(num_words)
    nbits = num_words * 32
    pos = rng.integers(0, nbits + 4096, size=3000).astype(np.uint32)
    pos[:5] = 0xFFFFFFFF
    starts = rng.integers(0, nbits, size=40)
    ends = starts + rng.integers(-5, 3 * 65536, size=40)
    starts, ends = starts.astype(np.uint32), np.minimum(ends, 2**32 - 1).astype(np.uint32)
    dense = rng.integers(0, 2**32, size=(5, 2048), dtype=np.uint32)
    dword = rng.integers(-1000, num_words + 500, size=5).astype(np.int32)
    dword[0] = 0
    args = [_on(dev, a) for a in (pos, starts, ends, dense, dword)]
    want = ops.expand_blocks_plain(*args, num_words)
    before = ops.cuda.EXPAND_BLOCKS.launches
    got = ops.expand_blocks(*args, num_words)
    torch.cuda.synchronize()
    assert ops.cuda.EXPAND_BLOCKS.launches == before + 1
    assert torch.equal(got, want)
    *binned, offsets = ops.bin_expand_inputs(*args, num_words)
    assert torch.equal(ops.cuda.expand_blocks(*binned, num_words, offsets), want)
    wrong = offsets.clone()
    wrong[:, 1:-1] = offsets[:, 2:].clone()
    got = ops.cuda.expand_blocks(*binned, num_words, wrong)
    assert torch.equal(got, ops.expand_blocks_plain(*binned, num_words, wrong))


def test_expand_blocks_rejects_missing_or_misshaped_offsets(dev):
    none = _on(dev, np.zeros(0, np.uint32))
    dense = _on(dev, np.zeros((0, 2048), np.uint32))
    with pytest.raises(TypeError):
        ops.cuda.expand_blocks(none, none, none, dense, none, 4096)
    with pytest.raises(ValueError):
        ops.cuda.expand_blocks(none, none, none, dense, none, 4096, _on(dev, np.zeros((3, 2), np.int32)))


@pytest.mark.parametrize("shape,n", [((W32,), 1), ((3, 32768), 300), ((64, W32), 5000), ((2, 5, 2048), 77)])
@pytest.mark.parametrize("padded", [False, True])
def test_word_delta_matches_plain(dev, shape, n, padded):
    rng = np.random.default_rng(n + padded)
    words = _words(rng, shape, dev)
    total = words.numel()
    wi = rng.integers(0, total, size=n)
    wi[: n // 4] = wi[0]
    idx, om, am = ops.coalesce_bit_updates(wi, rng.integers(0, 32, size=n), rng.random(n) < 0.7)
    om[0] = 0xFFFFFFFF
    if padded:
        idx, om, am = delta.pad_updates(idx, om, am, total)
    keep = words.clone()
    before = ops.cuda.WORD_DELTA.launches
    got = ops.apply_word_updates(words, idx, om, am)
    torch.cuda.synchronize()
    assert ops.cuda.WORD_DELTA.launches == before + 1
    want = ops.apply_word_updates_plain(words, _on(dev, idx), _on(dev, om), _on(dev, am))
    assert torch.equal(got, want)
    # a new tensor; the staged input is untouched
    assert got.data_ptr() != words.data_ptr() and torch.equal(words, keep)


@pytest.mark.parametrize("shape,n", [((W32,), 1), ((3, 32768), 300), ((4096, W32), 5000)])
def test_word_delta_in_place_matches_plain(dev, shape, n):
    """The stager's in-place route: the tensor's own storage patched, one
    launch, the same words as the plain version's copy."""
    rng = np.random.default_rng(n)
    words = _words(rng, shape, dev)
    wi = rng.integers(0, words.numel(), size=n)
    idx, om, am = ops.coalesce_bit_updates(wi, rng.integers(0, 32, size=n), rng.random(n) < 0.7)
    want = ops.apply_word_updates_plain(words, _on(dev, idx), _on(dev, om), _on(dev, am))
    ptr = words.data_ptr()
    before = ops.cuda.WORD_DELTA.launches
    got = ops.apply_word_updates_(words, idx, om, am)
    torch.cuda.synchronize()
    assert ops.cuda.WORD_DELTA.launches == before + 1
    assert got is words and words.data_ptr() == ptr
    assert torch.equal(words, want)


@pytest.mark.parametrize("s,m", [(1, 4096), (4, 2048), (64, W32)])
def test_word_delta_2d_matches_plain(dev, s, m):
    rng = np.random.default_rng(s)
    words = _words(rng, (s, m), dev)
    k = 513
    flat = rng.choice(s * m, size=k, replace=False)
    shard, word = (flat // m).astype(np.int32), (flat % m).astype(np.int32)
    om = rng.integers(0, 2**32, size=k, dtype=np.uint32)
    am = rng.integers(0, 2**32, size=k, dtype=np.uint32) & ~om
    shard[-4:] = s  # the contract's padding: dropped
    got = ops.apply_word_updates_2d(words, shard, word, om, am)
    want = ops.apply_word_updates_2d_plain(words, *[_on(dev, a) for a in (shard, word, om, am)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4, 5, 6, 7, 13, 20, 21, 24])
@pytest.mark.parametrize("with_filter", [False, True])
def test_distinct_presence_matches_plain(dev, depth, with_filter):
    """K9 == its plain version on every route (a bit-sliced minterm split
    in registers up to depth 6, shared memory up to 20, global atomics to 24), one
    launch: random values, a shard with no value, a sparse filter, and a
    plane stack read in place through its strides."""
    rng = np.random.default_rng(depth * 10 + with_filter)
    s, w = 3, 4096
    wide = _words(rng, (s, depth + 3, w), dev)
    planes = wide[:, 1 : depth + 2]
    planes[1, depth] = 0
    filt = _sparse(rng, (s, w), dev, ands=2) if with_filter else None
    before = ops.cuda.DISTINCT_PRESENCE.launches
    got = ops.cuda.distinct_presence(planes, filt, depth)
    torch.cuda.synchronize()
    assert ops.cuda.DISTINCT_PRESENCE.launches == before + 1
    want = ops.bsi_distinct_presence_plain(planes, filt, depth)
    assert torch.equal(got, want)
    assert int((got != 0).sum()) > 0
    # the public function routes CUDA tensors to the kernel
    zeros = torch.zeros((s, w), dtype=torch.int32, device=dev)
    pub = ops.bsi_distinct_presence(planes, filt if with_filter else zeros, bit_depth=depth, has_filter=with_filter)
    assert torch.equal(pub, want)


@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("aligned", [True, False], ids=["vec4", "vec1"])
def test_distinct_presence_register_route_words(dev, depth, aligned):
    """K9's register route at every depth it serves, with 16-byte vector
    loads (aligned) and word loads (a view one word in): words with a
    single set bit, all-ones words, a filter that zeroes whole words, and
    no value at all; == the plain version."""
    rng = np.random.default_rng(1000 + depth * 2 + aligned)
    s, w = 4, 2048
    a = rng.integers(0, 2**32, size=(s, depth + 1, w + 4), dtype=np.uint32)
    nn = a[:, depth]
    nn[0, : w // 2] = 1 << (np.arange(w // 2) % 32)
    nn[1] = 0xFFFFFFFF
    nn[2] = 0
    if depth:
        a[1, depth - 1, ::3] = 0xFFFFFFFF
    wide = ops.words_from_numpy(a, dev)
    planes = wide[..., :w] if aligned else wide[..., 1 : w + 1]
    f = rng.integers(0, 2**32, size=(s, w), dtype=np.uint32)
    f[:, ::2] = 0
    f[3] = 0
    for filt in (None, ops.words_from_numpy(f, dev), torch.zeros((s, w), dtype=torch.int32, device=dev)):
        before = ops.cuda.DISTINCT_PRESENCE.launches
        got = ops.cuda.distinct_presence(planes, filt, depth)
        torch.cuda.synchronize()
        assert ops.cuda.DISTINCT_PRESENCE.launches == before + 1
        assert torch.equal(got, ops.bsi_distinct_presence_plain(planes, filt, depth))
    assert not bool(ops.cuda.distinct_presence(planes[2:3], None, depth).any())


def test_distinct_presence_at_the_ssb_shape_and_rejects(dev):
    """K9 at ssb's lo_quantity shape ([58, 7, 32768]: 60 million columns
    on 50 values, the contended per-thread-mask route) == plain; a depth
    past 24 or a mismatched filter raises."""
    rng = np.random.default_rng(58)
    vals = rng.integers(0, 50, size=(58, 32768 * 32), dtype=np.uint64)
    bits = np.stack([(vals >> np.uint64(i)) & np.uint64(1) for i in range(6)], axis=1)
    packed = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little").view("<u4")
    nn = np.full((58, 1, 32768), 0xFFFFFFFF, dtype=np.uint32)
    planes = ops.words_from_numpy(np.concatenate([packed, nn], axis=1), dev)
    got = ops.cuda.distinct_presence(planes, None, 6)
    want = ops.bsi_distinct_presence_plain(planes, None, 6)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.cpu().numpy().view("<u4").tolist() == [0xFFFFFFFF, (1 << 18) - 1]
    with pytest.raises(ValueError):
        ops.cuda.distinct_presence(torch.zeros((1, 26, 32), dtype=torch.int32, device=dev), None, 25)
    with pytest.raises(ValueError):
        ops.cuda.distinct_presence(planes, torch.zeros((58, 16), dtype=torch.int32, device=dev), 6)


def test_fused_enqueue_waits_for_nothing_on_card(dev):
    """A multi-call read through the fuser on the card: every unit kind's
    kernels enqueue under ``torch.cuda.set_sync_debug_mode("error")``
    (the enqueue never waits for the device), one fetch a launch, and the
    answers equal the CPU leg's."""
    from pilosa_tpu_torch.core import FieldOptions, Holder
    from pilosa_tpu_torch.core.field import FIELD_TYPE_INT
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.executor.fusion import QueryFuser

    rng = np.random.default_rng(9)
    h = Holder()
    h.open()
    idx = h.create_index("i")
    f = idx.create_field("f")
    v = idx.create_field("v", FieldOptions(type=FIELD_TYPE_INT, min=-50, max=5000))
    f.import_bits(rng.integers(0, 12, 3000).tolist(), rng.integers(0, 3 << 20, 3000).tolist())
    v.import_values(rng.choice(3 << 20, 800, replace=False).tolist(), rng.integers(-50, 5000, 800).tolist())
    q = (
        "Count(Row(f=1))Count(Row(f=2))Count(Intersect(Row(f=1), Row(f=2)))"
        'TopN(f, Row(f=3), n=4)Sum(Row(f=1), field="v")Count(Range(v > 100))'
        'Distinct(field="v")Percentile(field="v", nth=50)GroupBy(Rows(f), limit=5)'
        "GroupBy(Rows(f, ids=[1, 2]), Row(f=3), Sum(field=v))"
    )
    cpu = Executor(h, device="cpu", device_policy="never")
    ex = Executor(h, device=dev, device_policy="always")
    fetches = []
    enqueue, fetch = QueryFuser._enqueue, QueryFuser._fetch

    def strict_enqueue(self, program, units):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return enqueue(self, program, units)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def counted_fetch(buf):
        fetches.append(buf.numel())
        return fetch(buf)

    try:
        QueryFuser._enqueue = strict_enqueue
        QueryFuser._fetch = staticmethod(counted_fetch)
        want = cpu.execute("i", q)
        for _ in range(2):
            assert ex.execute("i", q) == want
        st = ex.fuser.stats()
        assert st["fused_launches"] == 2 and st["fused_calls"] == 20, st
        assert len(fetches) == 2 and not st["bypasses"], st
    finally:
        QueryFuser._enqueue, QueryFuser._fetch = enqueue, staticmethod(fetch)
        ex.close()
        cpu.close()
        h.close()


def test_tree_program_first_upload_waits_for_nothing(dev):
    """A tree program's first use on the card uploads its code without a
    host wait, once per device however the device is named, and a launch
    on another stream reads the uploaded code."""
    prog = ops.TreeProgram(("Intersect", (("leaf", 0), ("Union", (("leaf", 1), ("leaf", 2))))))
    torch.cuda.set_sync_debug_mode("error")
    try:
        code = prog.device_code("cuda")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert prog.device_code(torch.device("cuda", torch.cuda.current_device())) is code
    assert prog.device_code(dev) is code
    assert code.cpu().tolist() == list(prog.kernel_code)
    rng = np.random.default_rng(3)
    leaves = [_words(rng, (4096,), dev) for _ in range(3)]
    torch.cuda.synchronize()
    fresh = ops.TreeProgram(("Intersect", (("leaf", 0), ("Union", (("leaf", 1), ("leaf", 2))))))
    fresh.device_code(dev)  # on the default stream, not waited for
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = ops.cuda.tree_count([leaves], fresh)
    side.synchronize()
    assert torch.equal(got.cpu(), ops.tree_count_plain([[t.cpu() for t in leaves]], fresh))
