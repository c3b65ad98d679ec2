"""Packed-word bitmap ops — the port's device data plane (L0 compute).

Counterpart of the main-path part of ``pilosa_tpu/ops/packed.py``. A
fragment row (2^20 columns) is 32,768 packed words. On the device the
words are ``int32`` views of the same little-endian ``u32`` bits the JAX
package stages: torch's ``uint32`` has no ``~`` and no shifts on the
CPU, and every op here only reads bit patterns.

Each scorer has two implementations with one public entry point:

  * a plain PyTorch version (``*_plain``). Torch has no popcount op, so
    popcount is SWAR arithmetic in ``int64``. The CPU tests run it
    against the JAX functions, and ``chip_smoke.py`` holds each kernel
    against it on the card;
  * a hand-written CUDA kernel (``ops/kernels/*.cu``, bound in
    ``ops/cuda.py``).

The public function picks by where its tensor lies: the plain version
for a CPU tensor, the kernel for a CUDA tensor. There is no fallback —
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from pilosa_tpu_torch.ops import cuda

# Words per shard-row on device: 2^20 bits / 32.
SHARD_WIDTH = 1 << 20
WORDS_PER_ROW = SHARD_WIDTH // 32
# Words per 2^16-bit container block: the sparse-staging granule.
CONTAINER_WORDS = (1 << 16) // 32
CONTAINERS_PER_ROW = SHARD_WIDTH >> 16  # 16


def u64_to_u32(words64: np.ndarray) -> np.ndarray:
    """Reinterpret uint64 packed words as uint32 words (little-endian:
    bit p of the row lands in u32 word p>>5, bit p&31)."""
    return words64.view("<u8").view("<u4")


def u32_to_u64(words32: np.ndarray) -> np.ndarray:
    return words32.view("<u4").view("<u8")


def words_from_numpy(words: np.ndarray, device) -> torch.Tensor:
    """Host packed words (``u32`` as the JAX package stages them, or the
    CPU engine's ``u64``) as the port's ``int32`` device words, same
    bits. A CUDA upload goes through pinned memory without blocking the
    host; a CPU result is a private copy."""
    w = np.require(words, requirements=["C"])
    if w.dtype.itemsize not in (4, 8) or w.dtype.kind not in "ui":
        raise TypeError(f"packed words must be 32- or 64-bit integers, got {w.dtype}")
    t = torch.from_numpy(np.require(w.view("<i4"), requirements=["W"]))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    if device.type != "cpu":
        raise ValueError(f"unsupported device: {device}")
    return t.clone()


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """Device ``int32`` words back to host ``u32`` (same bits)."""
    if words.dtype != torch.int32:
        raise TypeError(f"packed words are int32, got {words.dtype}")
    return words.detach().cpu().numpy().view("<u4")


# -- elementwise boolean algebra --------------------------------------------
# Named so lowered call trees read like the PQL ops they implement
# (reference executor.go:704-1000).


def and_(a, b):
    return torch.bitwise_and(a, b)


def or_(a, b):
    return torch.bitwise_or(a, b)


def xor_(a, b):
    return torch.bitwise_xor(a, b)


def andnot(a, b):
    """a AND NOT b — the Difference op."""
    return torch.bitwise_and(a, torch.bitwise_not(b))


def not_(a):
    return torch.bitwise_not(a)


def eval_tree(tree, leaves):
    """Evaluate a lowered boolean call tree over leaf word tensors —
    the counterpart of the JAX executor's ``_eval_tree``. ``tree`` is
    ``("leaf", i)`` or ``(name, (subtrees...))`` with name one of
    Intersect/Union/Xor/Difference; n-ary nodes fold left."""
    tag = tree[0]
    if tag == "leaf":
        return leaves[tree[1]]
    acc = eval_tree(tree[1][0], leaves)
    for sub in tree[1][1:]:
        v = eval_tree(sub, leaves)
        if tag == "Intersect":
            acc = and_(acc, v)
        elif tag == "Union":
            acc = or_(acc, v)
        elif tag == "Xor":
            acc = xor_(acc, v)
        else:
            acc = andnot(acc, v)
    return acc


# -- popcount (plain) ---------------------------------------------------------


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit counts of ``int32`` words, as ``int64`` (SWAR:
    torch has no popcount op; widening first keeps the shifts logical)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _on_cuda(t: torch.Tensor) -> bool:
    """The one routing decision: a CUDA tensor goes to the kernel, a CPU
    tensor to the plain version; anything else is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device: {t.device}")


# -- K1: dense scoring --------------------------------------------------------


def intersection_counts_matrix_plain(srcs: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """popcount(srcs[q] & mat[r]) for every (q, r): i32[Q, W], i32[R, W]
    -> i32[Q, R]."""
    out = torch.empty((srcs.shape[0], mat.shape[0]), dtype=torch.int32, device=mat.device)
    for q in range(srcs.shape[0]):
        out[q] = popcount(mat & srcs[q]).sum(dim=-1)
    return out


def _dense_scores(srcs: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    if _on_cuda(mat):
        return cuda.dense_scores(srcs, mat)
    return intersection_counts_matrix_plain(srcs, mat)


def intersection_counts_matrix(src: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """TopN scoring: popcount(src & row) for every row. src i32[W],
    mat i32[R, W] -> i32[R]. One pass over the staged matrix replaces
    the reference's per-candidate heap loop (fragment.go:985)."""
    return _dense_scores(src.reshape(1, -1), mat)[0]


def intersection_counts_matrix_batch_list(
    srcs: Sequence[torch.Tensor], mat: torch.Tensor
) -> torch.Tensor:
    """Batched dense scoring of a list of Q sources against one staged
    matrix: the matrix is read once for all Q. -> i32[Q, R]."""
    return _dense_scores(torch.stack(list(srcs)), mat)


# -- K2: block-sparse stacked scoring ------------------------------------------

# Blocks one K2 work item holds at most: four 16-block MMA tiles
# (kSpan in ops/kernels/sparse_scores.cu).
SPARSE_SPAN = 64


class SparseGroups:
    """K2's grouping of a block-sparse bundle by source container.

    A block at (shard, slot) is scored against container ``slot`` of
    shard ``shard`` of every query's source stack, so the blocks that
    share a (shard, slot) share their Q source containers: the kernel
    brings those into shared memory once for the group. ``order``
    i32[V] lists the blocks whose row, slot and shard are in range,
    stably sorted by (shard, slot); the blocks themselves keep their
    place. ``items`` i32[I, 4] is the kernel's work list, one row a
    group or an even share of at most SPARSE_SPAN blocks of a larger
    one: (first position in ``order``, blocks, shard, slot). ``nb``,
    ``num_rows``, ``n_shards`` and ``slots`` name the bundle it was made
    for; a launch with another raises."""

    __slots__ = ("order", "items", "nb", "num_rows", "n_shards", "slots")

    def __init__(self, order, items, nb: int, num_rows: int, n_shards: int, slots: int) -> None:
        self.order = order
        self.items = items
        self.nb = nb
        self.num_rows = num_rows
        self.n_shards = n_shards
        self.slots = slots

    @property
    def n_items(self) -> int:
        return int(self.items.shape[0])

    @property
    def nbytes(self) -> int:
        return 4 * (int(self.order.numel()) + int(self.items.numel()))


def _host_i32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a).astype(np.int64, copy=False)


def _sparse_group_arrays(block_row, block_slot, block_shard, num_rows: int, n_shards: int, slots: int):
    """(order i32[V], items i32[I, 4]) of ``SparseGroups`` by numpy from
    host copies of a bundle's index arrays (block_shard None: every block
    in shard 0)."""
    row = _host_i32(block_row)
    slot = _host_i32(block_slot)
    shard = np.zeros_like(row) if block_shard is None else _host_i32(block_shard)
    valid = (
        (row >= 0) & (row < num_rows) & (slot >= 0) & (slot < slots) & (shard >= 0) & (shard < n_shards)
    )
    idx = np.flatnonzero(valid)
    key = shard[idx] * slots + slot[idx]
    perm = np.argsort(key, kind="stable")
    order = idx[perm]
    key = key[perm]
    if not key.size:
        return order.astype(np.int32), np.zeros((0, 4), dtype=np.int32)
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    counts = np.diff(np.r_[starts, key.size])
    # a group of n blocks becomes ceil(n / SPAN) items of even size
    k = -(-counts // SPARSE_SPAN)
    g = np.repeat(np.arange(starts.size), k)
    j = np.arange(g.size) - np.repeat(np.cumsum(k) - k, k)
    base, extra = counts[g] // k[g], counts[g] % k[g]
    first = starts[g] + j * base + np.minimum(j, extra)
    size = base + (j < extra)
    items = np.stack([first, size, key[starts[g]] // slots, key[starts[g]] % slots], axis=1)
    return order.astype(np.int32), items.astype(np.int32)


def sparse_groups(block_row, block_slot, block_shard, num_rows: int, n_shards: int, slots: int, device=None):
    """The ``SparseGroups`` of a bundle (index arrays as numpy arrays or
    tensors), on ``device`` (default: that of ``block_row``). Index
    tensors on the card are first copied to the host, which waits for the
    stream: the stager calls this once when it builds a bundle, from its
    host arrays."""
    if device is None:
        device = block_row.device if isinstance(block_row, torch.Tensor) else "cpu"
    order, items = _sparse_group_arrays(block_row, block_slot, block_shard, num_rows, n_shards, slots)
    nb = int(block_row.shape[0])
    return SparseGroups(
        words_from_numpy(order, device), words_from_numpy(items, device), nb, num_rows, n_shards, slots
    )


class SparseBundle(tuple):
    """A staged block-sparse bundle: the tuple its scorer unpacks
    (blocks, block_row, block_slot[, block_shard], num_rows), and as
    ``groups`` the bundle's ``SparseGroups``, made once with it."""

    def __new__(cls, fields, groups: SparseGroups):
        self = super().__new__(cls, fields)
        self.groups = groups
        return self


def sparse_stacked_scores_plain(
    srcs,
    blocks: torch.Tensor,
    block_row: torch.Tensor,
    block_slot: torch.Tensor,
    block_shard,
    num_rows: int,
) -> torch.Tensor:
    """Block-sparse scoring over staged candidate blocks.

    srcs i32[Q, S, W] (or a sequence of Q i32[S, W]); blocks i32[B,
    2048] with block_row (segment id), block_slot (container position
    within the row) and block_shard (which of the S source rows; None =
    shard 0) i32[B]. Gathers each block's source container, popcounts
    the AND and segment-sums per row -> i32[Q, num_rows]. Blocks whose
    row, slot or shard lies out of range contribute nothing."""
    if not isinstance(srcs, torch.Tensor):
        srcs = torch.stack(list(srcs))
    q, s, w = srcs.shape
    slots = w // CONTAINER_WORDS
    per = srcs.reshape(q, s, slots, CONTAINER_WORDS)
    if block_shard is None:
        block_shard = torch.zeros_like(block_row)
    valid = (
        (block_row >= 0)
        & (block_row < num_rows)
        & (block_slot >= 0)
        & (block_slot < slots)
        & (block_shard >= 0)
        & (block_shard < s)
    )
    rows = block_row[valid].to(torch.int64)
    slot = block_slot[valid].to(torch.int64)
    shard = block_shard[valid].to(torch.int64)
    blk = blocks[valid]
    out = torch.zeros((q, num_rows), dtype=torch.int64, device=blocks.device)
    for qi in range(q):
        per_block = popcount(blk & per[qi, shard, slot]).sum(dim=-1)
        out[qi].index_add_(0, rows, per_block)
    return out.to(torch.int32)


def _sparse_scores(srcs, blocks, block_row, block_slot, block_shard, num_rows: int, groups):
    if _on_cuda(blocks):
        return cuda.sparse_stacked_scores(
            srcs, blocks, block_row, block_slot, block_shard, num_rows, groups=groups
        )
    return sparse_stacked_scores_plain(
        srcs, blocks, block_row, block_slot, block_shard, num_rows
    )


def sparse_intersection_counts(src, blocks, block_row, block_slot, num_rows: int, *, groups=None):
    """Single-shard block-sparse TopN scoring: src i32[W] -> i32[num_rows].
    Only nonempty container blocks are staged; absent blocks contribute
    zero to an intersection, so this is bit-identical to the dense pass.
    ``groups``: the bundle's ``SparseGroups`` (``SparseBundle.groups``);
    None makes it in the kernel's wrapper."""
    return _sparse_scores(
        src.reshape(1, 1, -1), blocks, block_row, block_slot, None, num_rows, groups
    )[0]


def sparse_intersection_counts_stacked(
    srcs, blocks, block_row, block_slot, block_shard, num_rows: int, *, groups=None
):
    """Cross-shard TopN scoring in one launch: srcs i32[S, W], block_row
    a global segment id (shard_index * chunk + candidate index) ->
    i32[num_rows]."""
    return _sparse_scores(
        srcs.unsqueeze(0), blocks, block_row, block_slot, block_shard, num_rows, groups
    )[0]


def sparse_intersection_counts_stacked_mat(
    srcs, blocks, block_row, block_slot, block_shard, num_rows: int, n_shards: int, chunk: int,
    *, groups=None,
):
    """The stacked scorer's matrix form, as whole-query fusion lowers a
    TopN head: K2's launch, then i32[n_shards, chunk] as a view of its
    output on the device, so the caller fetches exactly the per-shard
    score head. The stacked staging keeps num_rows == n_shards * chunk,
    so the slice takes nothing away."""
    flat = sparse_intersection_counts_stacked(
        srcs, blocks, block_row, block_slot, block_shard, num_rows, groups=groups
    )
    return flat[: n_shards * chunk].reshape(n_shards, chunk)


def sparse_intersection_counts_stacked_batch_list(
    srcs, blocks, block_row, block_slot, block_shard, num_rows: int, *, groups=None
):
    """Concurrent-query batch of the stacked scorer: a list of Q source
    stacks i32[S, W]; the staged blocks stream once for the whole batch,
    and the kernel takes the Q stacks by pointer (no copy into one
    tensor). -> i32[Q, num_rows]."""
    return _sparse_scores(list(srcs), blocks, block_row, block_slot, block_shard, num_rows, groups)


# -- K3: fused tree count --------------------------------------------------------

# Interpreter limits shared with ops/kernels/tree_count.cu (TC_MAX_*);
# launch limits (distinct leaves, queries x leaves) are cuda.TREE_MAX_*.
TREE_MAX_STACK = 16
TREE_MAX_LEAVES = 256
TREE_MAX_CODE = 512
_OPCODES = {"Intersect": -1, "Union": -2, "Xor": -3, "Difference": -4}
# the kernel's instruction words: op << 16 | operand, the operand a
# query-local leaf index or KERNEL_STACK (the entry below the top)
K_PUSH, K_AND, K_OR, K_XOR, K_ANDNOT = range(5)
KERNEL_STACK = 0xFFFF
_KERNEL_OPS = {-1: K_AND, -2: K_OR, -3: K_XOR, -4: K_ANDNOT}


def _kernel_program(code) -> tuple[tuple[int, ...], int]:
    """A postfix program as the tree-count kernel runs it: "push leaf;
    op" folds into one instruction on the top of the stack, which lives
    in a register; a push onto a live top spills it to a stack slot, and
    an op whose operand is KERNEL_STACK pops one. Returns (instruction
    words, stack slots needed)."""
    out: list[int] = []
    spill = top = peak = 0
    i = 0
    while i < len(code):
        ins = code[i]
        if ins >= 0 and i + 1 < len(code) and code[i + 1] < 0 and top:
            out.append(_KERNEL_OPS[code[i + 1]] << 16 | ins)
            i += 2
            continue
        if ins >= 0:
            spill += top
            peak = max(peak, spill)
            top = 1
            out.append(K_PUSH << 16 | ins)
        else:
            spill -= 1
            out.append(_KERNEL_OPS[ins] << 16 | KERNEL_STACK)
        i += 1
    return tuple(out), peak


class TreeProgram:
    """A lowered boolean call tree encoded for the tree-count kernel: a
    postfix program of int32 instructions, ``i >= 0`` pushing leaf i
    and ``-1..-4`` (Intersect, Union, Xor, Difference) combining the top
    two stack entries, and its ``kernel_code`` (``_kernel_program``). One
    kernel interprets any tree shape, so query shapes never multiply
    builds. Trees past the interpreter's limits raise here, before any
    launch."""

    def __init__(self, tree) -> None:
        self.tree = tree
        code: list[int] = []
        self.depth = self._emit(tree, code)
        self.code = tuple(code)
        self.nleaves = max(i for i in code if i >= 0) + 1
        if self.depth > TREE_MAX_STACK:
            raise ValueError(
                f"tree needs stack depth {self.depth} > {TREE_MAX_STACK}"
            )
        if self.nleaves > TREE_MAX_LEAVES:
            raise ValueError(f"tree has {self.nleaves} leaves > {TREE_MAX_LEAVES}")
        if len(self.code) > TREE_MAX_CODE:
            raise ValueError(f"tree program of {len(self.code)} > {TREE_MAX_CODE}")
        self.kernel_code, self.spill = _kernel_program(self.code)
        self._dev: dict = {}
        self._mu = threading.Lock()

    @classmethod
    def _emit(cls, t, out: list) -> int:
        """Append t's postfix code to out; return the stack depth it needs."""
        if t[0] == "leaf":
            out.append(int(t[1]))
            return 1
        op = _OPCODES.get(t[0])
        if op is None or not t[1]:
            raise ValueError(f"not a boolean tree node: {t[0]!r}")
        depth = cls._emit(t[1][0], out)
        for sub in t[1][1:]:
            depth = max(depth, 1 + cls._emit(sub, out))
            out.append(op)
        return depth

    def device_code(self, device) -> torch.Tensor:
        """The kernel program as an int32 tensor on ``device``, uploaded
        once per device. On a card the upload goes from pinned memory
        without a host wait, so a first use inside a launch sequence
        stays asynchronous; a stream other than the uploading one waits
        for the copy on the card."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with self._mu:
            ent = self._dev.get(device)
            if ent is None:
                host = torch.tensor(self.kernel_code, dtype=torch.int32)
                if device.type != "cuda":
                    ent = (host.to(device), None, None)
                else:
                    stream = torch.cuda.current_stream(device)
                    t = host.pin_memory().to(device, non_blocking=True)
                    ent = (t, stream, stream.record_event())
                self._dev[device] = ent
        t, stream, uploaded = ent
        if stream is not None and torch.cuda.current_stream(device) != stream:
            torch.cuda.current_stream(device).wait_event(uploaded)
        return t


def tree_tables(leaves_by_query):
    """The tree count's host lowering: (distinct leaves, refs), where
    ``distinct`` lists each leaf storage once (a leaf staged for several
    queries is the same tensor) in first-seen order and ``refs[q][l]``
    indexes leaf l of query q in it."""
    index: dict = {}
    distinct: list = []
    refs = []
    for leaves in leaves_by_query:
        r = []
        for t in leaves:
            key = (t.data_ptr(), t.numel())
            i = index.get(key)
            if i is None:
                i = index[key] = len(distinct)
                distinct.append(t)
            r.append(i)
        refs.append(tuple(r))
    return distinct, refs


def tree_count_plain(leaves_by_query, program: TreeProgram) -> torch.Tensor:
    """popcount(tree(leaves)) for each query's leaf list -> i32[Q], from
    the same tables the kernel gets (``tree_tables``). Evaluates the tree
    itself, not the kernel's code, so it checks that encoding too."""
    distinct, refs = tree_tables(leaves_by_query)
    out = torch.empty(len(refs), dtype=torch.int32, device=distinct[0].device)
    for qi, r in enumerate(refs):
        out[qi] = popcount(eval_tree(program.tree, [distinct[i] for i in r])).sum()
    return out


def _tree_launches(leaves_by_query, program: TreeProgram) -> list:
    """Consecutive query groups that each fit one tree-count launch (the
    cuda.TREE_MAX_* limits on leaf references, distinct leaves and
    resolved program words)."""
    per = min(
        cuda.TREE_MAX_REFS // program.nleaves,
        cuda.TREE_MAX_RESOLVED // len(program.kernel_code),
    )
    groups, cur, seen = [], [], set()
    for leaves in leaves_by_query:
        new = {(t.data_ptr(), t.numel()) for t in leaves} - seen
        if cur and (len(cur) == per or len(seen) + len(new) > cuda.TREE_MAX_DISTINCT):
            groups.append(cur)
            cur, seen = [], set()
            new = {(t.data_ptr(), t.numel()) for t in leaves}
        cur.append(leaves)
        seen |= new
    groups.append(cur)
    return groups


def tree_count(leaves_by_query, program: TreeProgram) -> torch.Tensor:
    """Fused Count over a boolean tree: Q queries, each a list of
    ``program.nleaves`` same-shape word tensors (u32[S, W] leaf stacks
    in the executor) -> i32[Q]. Q = 1 is the per-query form. A batch
    past one launch's limits runs as several launches."""
    if _on_cuda(leaves_by_query[0][0]):
        groups = _tree_launches(leaves_by_query, program)
        if len(groups) == 1:
            return cuda.tree_count(leaves_by_query, program)
        return torch.cat([cuda.tree_count(g, program) for g in groups])
    return tree_count_plain(leaves_by_query, program)


_ONE_LEAF = TreeProgram(("leaf", 0))


def count_bits(words: torch.Tensor) -> torch.Tensor:
    """Total set bits of a word tensor (any shape) -> int32 scalar (the
    one-leaf tree count)."""
    return tree_count([[words]], _ONE_LEAF)[0]


def count_bits_rows(mat: torch.Tensor) -> torch.Tensor:
    """Per-row set bits of i32[R, W] -> i32[R] (plain: GroupBy's
    per-group counts come from K4, never from a materialised matrix)."""
    return popcount(mat).sum(dim=-1).to(torch.int32)


# -- K4: GroupBy segmented reduction ------------------------------------------------
#
# A GroupBy panel is the cross product of its dimensions' row bitmaps:
# group k = filt & dims[0][i0] & dims[1][i1] & ... in product order (first
# dimension slowest). K4 popcounts every group, and every group AND each
# BSI plane, without ever writing the [K, Wf] group matrix.
#
# Layouts: a dimension is i32[R_d, Wf] or i32[R_d, S, W] (Wf = S * W, words
# flattened over the shard batch); the filter i32[Wf] or i32[S, W] or None;
# planes i32[P, Wf] or the staged i32[S, P, W] stack, read in place. P = 0
# gives counts only; no dimension gives one group (the filter, or all ones).

# Largest transient (int32 words) the plain version materialises per tile.
_GROUP_TILE_WORDS = 1 << 22


def _as_stack3(t: torch.Tensor) -> torch.Tensor:
    """A dimension [R, Wf] as [R, 1, Wf]; [R, S, W] as is."""
    return t.unsqueeze(1) if t.dim() == 2 else t


def _planes_stack3(planes: torch.Tensor) -> torch.Tensor:
    """Planes [P, Wf] as the [1, P, Wf] view; a staged [S, P, W] as is."""
    return planes.unsqueeze(0) if planes.dim() == 2 else planes


def _group_count(dims) -> int:
    k = 1
    for d in dims:
        k *= int(d.shape[0])
    return k


def groupby_reduce_plain(dims, filt, planes):
    """(counts i32[K], plane_counts i32[K, P]) with counts[k] =
    popcount(g_k) and plane_counts[k, p] = popcount(g_k & planes[p]),
    g_k = filt & dims[0][i0] & ... (product order, first dimension
    slowest). Groups are built a tile at a time, so the [K, Wf] group
    matrix is never held whole."""
    dims3 = [_as_stack3(d) for d in dims]
    p3 = _planes_stack3(planes)
    s, p, w = p3.shape
    device = p3.device
    flat_dims = [d.reshape(d.shape[0], -1) for d in dims3]
    flat_planes = p3.permute(1, 0, 2).reshape(p, s * w)
    wf = s * w
    f = None if filt is None else filt.reshape(1, wf)
    k = _group_count(dims3)
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    plane_counts = torch.zeros((k, p), dtype=torch.int64, device=device)
    radix = [int(d.shape[0]) for d in flat_dims]
    tile = max(1, _GROUP_TILE_WORDS // max(wf, 1))
    for k0 in range(0, k, tile):
        ks = torch.arange(k0, min(k, k0 + tile), device=device)
        g = torch.full((ks.numel(), wf), -1, dtype=torch.int32, device=device)
        if f is not None:
            g &= f
        rem = ks
        for d in range(len(flat_dims) - 1, -1, -1):
            g &= flat_dims[d][rem % radix[d]]
            rem = rem // radix[d]
        counts[k0 : k0 + ks.numel()] = popcount(g).sum(dim=-1)
        for pi in range(p):
            plane_counts[k0 : k0 + ks.numel(), pi] = popcount(g & flat_planes[pi]).sum(dim=-1)
    return counts.to(torch.int32), plane_counts.to(torch.int32)


def groupby_reduce(dims, filt, planes):
    """GroupBy segmented reduction: the kernel for CUDA tensors, the
    plain version for CPU ones. ``planes`` may have P = 0 rows."""
    if _on_cuda(planes):
        return cuda.groupby_reduce(
            [_as_stack3(d) for d in dims],
            None if filt is None else filt.reshape(_planes_stack3(planes).shape[0], -1),
            _planes_stack3(planes),
        )
    return groupby_reduce_plain(dims, filt, planes)


def _no_planes(like: torch.Tensor) -> torch.Tensor:
    """A P = 0 plane stack with ``like``'s flattened word count."""
    d = _as_stack3(like)
    return torch.empty((d.shape[1], 0, d.shape[2]), dtype=torch.int32, device=like.device)


def combine_groups(dims, filt) -> torch.Tensor:
    """Cross-product AND of the dimension stacks -> i32[K, Wf] in product
    order. Plain and whole: the serving path never materialises this
    (see groupby_reduce); kept for parity with the JAX function."""
    flat = [_as_stack3(d).reshape(d.shape[0], -1) for d in dims]
    acc = flat[0]
    if filt is not None:
        acc = acc & filt.reshape(1, -1)
    for d in flat[1:]:
        acc = (acc[:, None, :] & d[None, :, :]).reshape(-1, acc.shape[-1])
    return acc


def groupby_counts(dims, filt) -> torch.Tensor:
    """Count-aggregate GroupBy: popcount per group -> i32[K]."""
    return groupby_reduce(dims, filt, _no_planes(dims[0]))[0]


def groupby_plane_counts(groups: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """popcount(groups[k] & planes[p]) -> i32[K, P] (one dimension: the
    groups themselves, no filter)."""
    return groupby_reduce([groups], None, planes)[1]


def groupby_sum_reduce(dims, filt, planes):
    """Sum-aggregate GroupBy: (counts i32[K], plane_counts i32[K, P])."""
    return groupby_reduce(dims, filt, planes)


# -- K6: compressed-upload expansion ------------------------------------------------
#
# Roaring container payloads -> packed words, for the tiered stager's
# compressed uploads (ops/kernels/expand_blocks.cu). Coordinates are the
# int32 views of u32 global bit offsets of one flat bit space (row_index *
# SHARD_WIDTH + slot * 2^16 + local); the stager keeps them below 2^31.
# The kernel takes its inputs binned by span (one container's 2048 output
# words, ``cuda.EXPAND_SPAN_WORDS``): ``bin_expand_inputs`` bins on the
# device, the stager on the host.


def _as_u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns as their unsigned values, in int64."""
    return t.to(torch.int64) & 0xFFFFFFFF


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 views of the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _scatter_or(out: torch.Tensor, idx: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] |= masks[i] over int64 words (masks in [0, 2^32)); torch
    has no OR reduction, so each of the 32 bits is a max-scatter."""
    if idx.numel() == 0:
        return out
    for b in range(32):
        bit = (masks >> b) & 1
        hit = torch.zeros_like(out).scatter_reduce_(0, idx, bit, "amax")
        out |= hit << b
    return out


def expand_blocks_plain(
    positions, run_starts, run_ends, dense, dense_word, num_words: int, offsets=None
):
    """The function of ``pilosa_tpu/ops/packed.py`` expand_blocks (and,
    with no positions and no dense blocks, of the Pallas
    expand_runs_pallas) -> i32[num_words]: array positions (0xFFFFFFFF =
    padding), inclusive RLE runs (start > end = padding) and dense
    [D, 2048] blocks at word offsets dense_word, ORed into zeros; words
    past num_words drop. With ``offsets`` (K6's binned form), what the
    kernel reads: each element outside the span its offsets name is
    dropped first."""
    if offsets is not None:
        positions, run_starts, run_ends, dense, dense_word = _in_their_spans(
            positions, run_starts, run_ends, dense, dense_word, offsets
        )
    device = dense.device
    out = torch.zeros(num_words, dtype=torch.int64, device=device)
    idx_parts, mask_parts = [], []
    # array containers: one bit each
    p = _as_u32(positions)
    keep = (p >> 5) < num_words
    idx_parts.append((p >> 5)[keep])
    mask_parts.append(torch.ones_like(p[keep]) << (p[keep] & 31))
    # runs: head and tail masks, interior words by a +1/-1 cover count
    s, e = _as_u32(run_starts), _as_u32(run_ends)
    valid = s <= e
    s, e = s[valid], e[valid]
    ws, we = s >> 5, e >> 5
    full = torch.full_like(s, 0xFFFFFFFF)
    head = (full << (s & 31)) & 0xFFFFFFFF
    tail = full >> (31 - (e & 31))
    same = ws == we
    head = torch.where(same, head & tail, head)
    for w, m in ((ws, head), (we[~same], tail[~same])):
        k = w < num_words
        idx_parts.append(w[k])
        mask_parts.append(m[k])
    interior = we > ws + 1
    diff = torch.zeros(num_words + 2, dtype=torch.int64, device=device)
    ones = torch.ones(int(interior.sum()), dtype=torch.int64, device=device)
    diff.index_add_(0, torch.clamp(ws[interior] + 1, max=num_words + 1), ones)
    diff.index_add_(0, torch.clamp(we[interior], max=num_words + 1), -ones)
    cover = torch.cumsum(diff, 0)[:num_words] > 0
    # dense bitmap containers: raw words at their offsets
    didx = dense_word.to(torch.int64)[:, None] + torch.arange(
        dense.shape[1], dtype=torch.int64, device=device
    )
    dk = (didx >= 0) & (didx < num_words)
    idx_parts.append(didx[dk])
    mask_parts.append(_as_u32(dense)[dk])
    _scatter_or(out, torch.cat(idx_parts), torch.cat(mask_parts))
    out[cover] = 0xFFFFFFFF
    return _to_i32(out)


def expand_runs_plain(run_starts, run_ends, num_words: int):
    """The Pallas expand_runs_pallas' function: inclusive RLE runs ->
    i32[num_words] (start > end = padding)."""
    device = run_starts.device
    none = torch.empty(0, dtype=torch.int32, device=device)
    return expand_blocks_plain(
        none, run_starts, run_ends, torch.empty((0, CONTAINER_WORDS), dtype=torch.int32, device=device),
        none, num_words,
    )


def _bins(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """The span each of n elements lies in by non-decreasing ``offsets``
    i64[spans + 1] (-1 outside every span)."""
    idx = torch.arange(n, dtype=torch.int64, device=offsets.device)
    span = torch.searchsorted(offsets, idx, right=True) - 1
    return torch.where(idx < offsets[-1], span, -1)


def _in_their_spans(positions, run_starts, run_ends, dense, dense_word, offsets):
    """The binned inputs without the elements that lie outside the span
    ``offsets`` names for them, as K6 drops them."""
    off = offsets.to(torch.int64)
    p = _as_u32(positions)
    s, e = _as_u32(run_starts), _as_u32(run_ends)
    dw = dense_word.to(torch.int64)
    keep_p = (p >> 16) == _bins(off[0], p.numel())
    span_r = _bins(off[1], s.numel())
    keep_r = ((s >> 16) == span_r) & ((e >> 16) == span_r)
    span_d = _bins(off[2], dw.numel())
    keep_d = (span_d >= 0) & (dw == span_d * cuda.EXPAND_SPAN_WORDS)
    return positions[keep_p], run_starts[keep_r], run_ends[keep_r], dense[keep_d], dense_word[keep_d]


def bin_expand_inputs(positions, run_starts, run_ends, dense, dense_word, num_words: int):
    """K6's binning, on the inputs' device: the expand_blocks contract's
    inputs (any order, padding, runs and dense blocks at any offset) as
    the same function's inputs binned by span, with their offsets:
    (positions, run_starts, run_ends, dense, dense_word, offsets i32[3,
    spans + 1]). Positions sort by value; a run splits at span edges; a
    dense block is cut into the (at most two) spans it overlaps, each
    piece a span-aligned block with zeros outside it."""
    device = dense.device
    span_words = cuda.EXPAND_SPAN_WORDS
    spans = -(-num_words // span_words)
    nbits = num_words * 32
    first_bit = torch.arange(spans + 1, dtype=torch.int64, device=device) << 16

    p = _as_u32(positions)
    p = torch.sort(p[p < nbits]).values
    pos_off = torch.searchsorted(p, first_bit)

    s, e = _as_u32(run_starts), _as_u32(run_ends)
    keep = (s <= e) & (s < nbits)
    s, e = s[keep], torch.clamp(e[keep], max=nbits - 1)
    pieces = (e >> 16) - (s >> 16) + 1
    run = torch.repeat_interleave(torch.arange(s.numel(), device=device), pieces)
    nth = torch.arange(run.numel(), device=device) - (torch.cumsum(pieces, 0) - pieces)[run]
    span = (s[run] >> 16) + nth
    span, order = torch.sort(span)
    run = run[order]
    starts = torch.maximum(s[run], span << 16)
    ends = torch.minimum(e[run], (span << 16) | 0xFFFF)
    run_off = torch.searchsorted(span, first_bit >> 16)

    dw = dense_word.to(torch.int64)
    lo = torch.div(dw, span_words, rounding_mode="floor")
    block = torch.arange(dw.numel(), device=device).repeat_interleave(2)
    dspan = torch.stack([lo, lo + 1], 1).reshape(-1)
    shift = dspan * span_words - dw[block]  # source word of the span's word 0
    keep = (dspan >= 0) & (dspan < spans) & (shift > -span_words) & (shift < span_words)
    dspan, order = torch.sort(dspan[keep])
    block, shift = block[keep][order], shift[keep][order]
    src = shift[:, None] + torch.arange(span_words, device=device)
    inside = (src >= 0) & (src < span_words)
    words = dense[block[:, None], src.clamp(0, span_words - 1)]
    dense_off = torch.searchsorted(dspan, first_bit >> 16)
    return (
        _to_i32(p),
        _to_i32(starts),
        _to_i32(ends),
        torch.where(inside, words, torch.zeros_like(words)).contiguous(),
        (dspan * span_words).to(torch.int32),
        torch.stack([pos_off, run_off, dense_off]).to(torch.int32),
    )


def expand_blocks(positions, run_starts, run_ends, dense, dense_word, num_words: int, offsets=None):
    """Expand compressed roaring payloads to packed words: K6 for CUDA
    tensors (binned first by ``bin_expand_inputs`` unless ``offsets``
    come with them), the plain version for CPU ones."""
    if _on_cuda(dense):
        if offsets is None:
            *binned, offsets = bin_expand_inputs(
                positions, run_starts, run_ends, dense, dense_word, num_words
            )
            positions, run_starts, run_ends, dense, dense_word = binned
        return cuda.expand_blocks(
            positions, run_starts, run_ends, dense, dense_word, num_words, offsets
        )
    return expand_blocks_plain(
        positions, run_starts, run_ends, dense, dense_word, num_words, offsets
    )
