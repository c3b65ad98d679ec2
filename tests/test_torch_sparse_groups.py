"""K2's grouping of block-sparse bundles by source container, on the CPU.

The block-sparse scorer (``ops/kernels/sparse_scores.cu``) walks a
bundle's blocks group by group: ``ops.SparseGroups`` lists the valid
blocks sorted stably by (shard, slot) and cuts each group into work
items of at most ``ops.SPARSE_SPAN`` blocks. Here the grouping is held
against a numpy oracle, a numpy replay of the kernel's schedule over the
grouping is held against ``pilosa_tpu``'s scorer, the stager's grouped
bundles are held against ``pilosa_tpu``'s answer, and the batch entry
point (which hands the kernel its sources by pointer) against
``pilosa_tpu/ops/packed.py``'s batch scorer with separate, non-contiguous
sources. Integer outputs: the bar is ==.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu import ops as jops
from pilosa_tpu.roaring import build_fragment_file

import pilosa_tpu_torch
from pilosa_tpu_torch import ops as tops

CPU = torch.device("cpu")
SLOTS = 4  # containers per source row at this small width
W = SLOTS * tops.CONTAINER_WORDS
S = 3
NUM_ROWS = 24
SPAN = tops.SPARSE_SPAN


def _u32(rng, shape):
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    a.reshape(-1, shape[-1])[:1] = 0xFFFFFFFF  # all-ones words catch sign bugs
    return a


def _t(a):
    return tops.words_from_numpy(a, CPU)


def _group_arrays(*args):
    """(order, items) of ``ops.sparse_groups`` as numpy arrays."""
    g = tops.sparse_groups(*args, device=CPU)
    return g.order.numpy(), g.items.numpy()


def _case(name: str, rng):
    """(block_row, block_slot, block_shard or None) of one grouping case."""
    b = 90
    row = rng.integers(0, NUM_ROWS, size=b)
    slot = rng.integers(0, SLOTS, size=b)
    shard = rng.integers(0, S, size=b)
    if name == "duplicate_rows":
        row[:30] = 5
        slot[:30] = 2
        shard[:30] = 1
    elif name == "out_of_range":
        row[:3] = (-1, NUM_ROWS, NUM_ROWS + 7)
        slot[3:5] = (-1, SLOTS)
        shard[5:7] = (-1, S)
    elif name == "empty_shards":
        shard[:] = np.where(shard == 1, 2, shard)  # shard 1 holds nothing
    elif name == "one_block":
        row, slot, shard = row[:1], slot[:1], shard[:1]
    elif name == "groups_past_span":
        # groups of 2.5, 1 and 1 + 1/64 spans, and one block
        n = (5 * SPAN) // 2 + SPAN + SPAN + 1 + 1
        row = rng.integers(0, NUM_ROWS, size=n)
        slot = np.full(n, 3)
        shard = np.zeros(n, dtype=np.int64)
        a, c = (5 * SPAN) // 2, (5 * SPAN) // 2 + SPAN
        slot[:a], shard[:a] = 1, 2
        slot[a:c], shard[a:c] = 0, 0
        slot[c : c + SPAN + 1], shard[c : c + SPAN + 1] = 2, 1
        perm = rng.permutation(n)  # unsorted
        row, slot, shard = row[perm], slot[perm], shard[perm]
    elif name == "many_past_span":
        # every (shard, slot) a group of 1 to 3.5 spans, in random order
        sizes = rng.integers(1, (7 * SPAN) // 2, size=S * SLOTS)
        key = rng.permutation(np.repeat(np.arange(S * SLOTS), sizes))
        row = rng.integers(0, NUM_ROWS, size=key.size)
        slot, shard = key % SLOTS, key // SLOTS
    elif name == "none_valid":
        row[:] = -1
    elif name == "no_shard":
        shard = None
    return row.astype(np.int32), slot.astype(np.int32), None if shard is None else shard.astype(np.int32)


CASES = ("unsorted", "duplicate_rows", "out_of_range", "empty_shards", "one_block", "groups_past_span",
         "many_past_span", "none_valid", "no_shard")


def _oracle(row, slot, shard, n_shards=S):
    """{(shard, slot): [block indices in bundle order]}, keys sorted."""
    groups = {}
    for b in range(row.size):
        sh = 0 if shard is None else int(shard[b])
        if 0 <= row[b] < NUM_ROWS and 0 <= slot[b] < SLOTS and 0 <= sh < n_shards:
            groups.setdefault((sh, int(slot[b])), []).append(b)
    return dict(sorted(groups.items()))


def _check_grouping(order, items, want):
    order, items = np.asarray(order), np.asarray(items).reshape(-1, 4)
    assert order.dtype == np.int32 and items.dtype == np.int32
    assert order.tolist() == [b for bs in want.values() for b in bs]
    at = 0
    for key, bs in want.items():
        k = -(-len(bs) // SPAN)
        mine = items[at : at + k]
        at += k
        assert [tuple(r[2:]) for r in mine] == [key] * k
        # contiguous, even shares of the group, none past the span
        assert mine[0, 0] == order.tolist().index(bs[0])
        assert (mine[1:, 0] == mine[:-1, 0] + mine[:-1, 1]).all()
        assert mine[:, 1].sum() == len(bs)
        assert mine[:, 1].max() <= SPAN and mine[:, 1].max() - mine[:, 1].min() <= 1
    assert at == items.shape[0]


def _replay(srcs, blocks, brow, order, items):
    """The kernel's schedule in numpy: each item's blocks against its
    (shard, slot) container of every query -> i64[Q, NUM_ROWS]."""
    out = np.zeros((srcs.shape[0], NUM_ROWS), dtype=np.int64)
    order, items = np.asarray(order), np.asarray(items).reshape(-1, 4)
    for first, n, sh, sl in items:
        idx = order[first : first + n]
        for q in range(srcs.shape[0]):
            src = srcs[q, sh, sl * tops.CONTAINER_WORDS : (sl + 1) * tops.CONTAINER_WORDS]
            counts = np.bitwise_count(blocks[idx] & src).sum(axis=1, dtype=np.int64)
            np.add.at(out[q], brow[idx], counts)
    return out


@pytest.mark.parametrize("case", CASES)
def test_grouping_matches_oracle(case):
    rng = np.random.default_rng(CASES.index(case) + 11)
    row, slot, shard = _case(case, rng)
    order, items = _group_arrays(row, slot, shard, NUM_ROWS, S, SLOTS)
    _check_grouping(order, items, _oracle(row, slot, shard))
    # from tensors, on their device, with the bundle it was made for
    g = tops.sparse_groups(_t(row), _t(slot), None if shard is None else _t(shard), NUM_ROWS, S, SLOTS)
    assert np.array_equal(g.order.numpy(), order) and np.array_equal(g.items.numpy(), items)
    assert (g.nb, g.num_rows, g.n_shards, g.slots) == (row.size, NUM_ROWS, S, SLOTS)
    assert g.n_items == items.shape[0] and g.nbytes == 4 * (order.size + items.size)
    if case == "groups_past_span":
        # 2.5 spans in three even items, one whole span, one span and a
        # block in two, and a group of one
        a = (5 * SPAN) // 2
        assert sorted(items[:, 1].tolist()) == sorted(
            [a // 3 + (i < a % 3) for i in range(3)] + [SPAN, SPAN // 2 + 1, SPAN // 2, 1]
        )
    if case == "none_valid":
        assert order.size == 0 and items.shape == (0, 4)


@pytest.mark.parametrize("case", CASES)
def test_schedule_replay_matches_jax(case):
    """Scoring item by item over the grouping gives pilosa_tpu's answer:
    the grouping covers every valid block once and names its container."""
    rng = np.random.default_rng(CASES.index(case) + 31)
    row, slot, shard = _case(case, rng)
    srcs = _u32(rng, (3, S, W))
    blocks = _u32(rng, (row.size, tops.CONTAINER_WORDS))
    if shard is None:  # every block reads shard 0
        srcs = srcs[:, :1]
    n_shards = srcs.shape[1]
    sh = shard if shard is not None else np.zeros_like(row)
    order, items = _group_arrays(row, slot, shard, NUM_ROWS, n_shards, SLOTS)
    got = _replay(srcs, blocks, row, order, items)
    # pilosa_tpu's gather clamps a slot or shard out of range where the
    # port drops the block (segment_sum drops rows out of range in both):
    # it is held on the blocks whose slot and shard are in range
    keep = (slot >= 0) & (slot < SLOTS) & (sh >= 0) & (sh < n_shards)
    want = np.asarray(
        jops.sparse_intersection_counts_stacked_batch_list(
            list(srcs), blocks[keep], row[keep], slot[keep], sh[keep], NUM_ROWS
        )
    )
    assert np.array_equal(got, want)
    # the port's entry points take the grouping and give the same answer,
    # and so does the plain version on every block
    g = tops.sparse_groups(row, slot, shard, NUM_ROWS, n_shards, SLOTS)
    args = (_t(blocks), _t(row), _t(slot), None if shard is None else _t(shard), NUM_ROWS)
    port = tops.sparse_intersection_counts_stacked_batch_list([_t(s) for s in srcs], *args, groups=g)
    assert np.array_equal(port.numpy().astype(np.int64), want)
    plain = tops.sparse_stacked_scores_plain(_t(srcs), *args)
    assert np.array_equal(plain.numpy().astype(np.int64), want)


@pytest.mark.parametrize("q", [1, 3, 32])
def test_batch_list_with_strided_sources_matches_jax(q):
    """The batch entry point with Q separate, non-contiguous source stacks
    (each a column window of a wider array, at its own offset) against
    pilosa_tpu/ops/packed.py's batch scorer."""
    rng = np.random.default_rng(q + 100)
    row, slot, shard = _case("unsorted", rng)
    row[:2] = (-1, NUM_ROWS)  # dropped
    blocks = _u32(rng, (row.size, tops.CONTAINER_WORDS))
    wide = [_u32(rng, (S, W + 3 * tops.CONTAINER_WORDS)) for _ in range(q)]
    offs = [int(rng.integers(0, 4)) * tops.CONTAINER_WORDS for _ in range(q)]
    srcs_np = [w[:, o : o + W] for w, o in zip(wide, offs)]
    srcs_t = [_t(w)[:, o : o + W] for w, o in zip(wide, offs)]
    assert not any(t.is_contiguous() for t in srcs_t)
    want = np.asarray(
        jops.sparse_intersection_counts_stacked_batch_list(
            [np.ascontiguousarray(s) for s in srcs_np], blocks, row, slot, shard, NUM_ROWS
        )
    )
    g = tops.sparse_groups(row, slot, shard, NUM_ROWS, S, SLOTS)
    for groups in (g, None):
        got = tops.sparse_intersection_counts_stacked_batch_list(
            srcs_t, _t(blocks), _t(row), _t(slot), _t(shard), NUM_ROWS, groups=groups
        )
        assert tuple(got.shape) == (q, NUM_ROWS)
        assert np.array_equal(got.numpy().astype(np.int64), want)
    assert np.array_equal(_replay(np.stack(srcs_np), blocks, row, g.order.numpy(), g.items.numpy()), want)


SW = 1 << 20


@pytest.fixture(scope="module")
def holder(tmp_path_factory):
    """A 3-shard index: hot rows with every container set, a few rows in
    one or two containers, a singleton tail, and shard 1 with no
    candidate beyond the tail."""
    base = tmp_path_factory.mktemp("sparse_groups")
    vdir = base / "tall" / "f" / "views" / "standard" / "fragments"
    vdir.mkdir(parents=True)
    for shard in range(3):
        rng = np.random.default_rng(shard + 5)
        pos = []
        hot = 0 if shard == 1 else 6
        for h in range(hot):
            pos.append(np.uint64(h * SW) + rng.integers(0, SW, size=20000, dtype=np.uint64))
        for m in range(10, 14):
            cols = rng.integers(0, 1 << 16, size=200, dtype=np.uint64) + np.uint64(((m * 3 + shard) % 16) << 16)
            pos.append(np.uint64(m * SW) + cols)
        rows = np.arange(64, 64 + 40, dtype=np.uint64)
        pos.append(rows * np.uint64(SW) + (rows * np.uint64(2654435761) + np.uint64(shard)) % np.uint64(SW))
        build_fragment_file(str(vdir / str(shard)), [np.unique(np.concatenate(pos))])
    h = pilosa_tpu_torch.holder_from_dir(str(base))
    yield h
    h.close()


def test_stager_bundles_carry_their_grouping(holder):
    """The stager's stacked and single-shard bundles unpack as before and
    carry the grouping of their own index arrays; scored through the
    port with it, or replayed item by item, they give pilosa_tpu's
    answer."""
    ex = pilosa_tpu_torch.Executor(holder, device="cpu", device_policy="always")
    try:
        frags = tuple(holder.fragment("tall", "f", "standard", s) for s in range(3))
        ids = (0, 1, 3, 5, 10, 11, 12, 13, 64, 70, 99, 200)
        chunk = 16
        bundle = ex.stager.sparse_rows_stacked(frags, (ids,) * 3, chunk)
        blocks, brow, bslot, bshard, num_rows = bundle
        assert num_rows == 3 * chunk
        g = bundle.groups
        arrays = [t.numpy() for t in (blocks, brow, bslot, bshard)]
        order, items = _group_arrays(*arrays[1:], num_rows, 3, tops.CONTAINERS_PER_ROW)
        assert np.array_equal(g.order.numpy(), order) and np.array_equal(g.items.numpy(), items)
        assert (g.nb, g.num_rows, g.n_shards, g.slots) == (blocks.shape[0], num_rows, 3, 16)
        # every block of a group names a different row
        for first, n, _, _ in items:
            rows = arrays[1][order[first : first + n]]
            assert len(set(rows.tolist())) == n
        # the cache hands back the same bundle, grouping and all
        assert ex.stager.sparse_rows_stacked(frags, (ids,) * 3, chunk).groups is g
        rng = np.random.default_rng(9)
        srcs = _u32(rng, (2, 3, SW // 32))
        want = np.asarray(jops.sparse_intersection_counts_stacked(srcs[0], *arrays, num_rows))
        got = tops.sparse_intersection_counts_stacked(_t(srcs[0]), *bundle, groups=g)
        assert np.array_equal(got.numpy().astype(np.int64), want)
        assert want.sum() > 0
        b_want = np.asarray(jops.sparse_intersection_counts_stacked_batch_list(list(srcs), *arrays, num_rows))
        order64 = g.order.numpy()
        out = np.zeros((2, num_rows), dtype=np.int64)
        for first, n, sh, sl in g.items.numpy():
            idx = order64[first : first + n]
            for q in range(2):
                src = srcs[q, sh, sl * 2048 : (sl + 1) * 2048]
                np.add.at(out[q], arrays[1][idx], np.bitwise_count(arrays[0].view("<u4")[idx] & src).sum(axis=1))
        assert np.array_equal(out, b_want)

        single = ex.stager.sparse_rows(frags[0], ids)
        blocks1, brow1, bslot1, n1 = single
        assert n1 == len(ids)
        o1, i1 = _group_arrays(brow1.numpy(), bslot1.numpy(), None, n1, 1, 16)
        assert np.array_equal(single.groups.order.numpy(), o1) and np.array_equal(single.groups.items.numpy(), i1)
        want1 = np.asarray(jops.sparse_intersection_counts(
            srcs[0, 0], blocks1.numpy(), brow1.numpy(), bslot1.numpy(), n1))
        got1 = tops.sparse_intersection_counts(_t(srcs[0, 0]), *single, groups=single.groups)
        assert np.array_equal(got1.numpy().astype(np.int64), want1)
    finally:
        ex.close()
