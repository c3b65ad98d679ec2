"""Wrappers of the hand-written CUDA kernels (``ops/kernels/*.cu``).

Each wrapper checks device, dtype, shape, contiguity and alignment and
raises on what its kernel does not take, allocates the output, launches
on PyTorch's current stream without synchronising, raises if the launch
was refused, and adds one to its kernel's launch count. Nothing here
runs on the CPU: the plain versions in ``packed.py`` are the CPU path.

The kernels are built on first use (see ``_build.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import threading
from typing import Optional

import torch

from pilosa_tpu_torch.analysis.locks import OrderedLock
from pilosa_tpu_torch.ops import _build


# The scope a launch is also counted under (``Kernel.launches_by_scope``):
# the serving node, where several nodes of a cluster share one process
# and so these counts. The executor sets it at its entry point and hands
# it over at each thread hop, as it does the request's deadline.
_SCOPE: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "pilosa_launch_scope", default=None
)


def launch_scope() -> Optional[str]:
    """The scope this context's launches are counted under, or None."""
    return _SCOPE.get()


@contextlib.contextmanager
def scoped(scope: Optional[str]):
    """Count this context's launches under ``scope`` as well."""
    token = _SCOPE.set(scope)
    try:
        yield
    finally:
        _SCOPE.reset(token)


class Kernel:
    """One hand-written kernel: its source, the TPU-side function it
    replaces, and how many times it was launched, in all, at each
    query count Q (``launches_by_q``) and under each launch scope
    (``launches_by_scope``)."""

    def __init__(self, name: str, source: str, replaces: str) -> None:
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.launches_by_q: dict[int, int] = {}
        self.launches_by_scope: dict[str, int] = {}
        self._mu = threading.Lock()

    @property
    def batched_launches(self) -> int:
        """Launches that served more than one query."""
        with self._mu:
            return sum(n for q, n in self.launches_by_q.items() if q > 1)

    def note_launch(self, q: int) -> None:
        scope = _SCOPE.get()
        with self._mu:
            self.launches += 1
            self.launches_by_q[q] = self.launches_by_q.get(q, 0) + 1
            if scope is not None:
                self.launches_by_scope[scope] = self.launches_by_scope.get(scope, 0) + 1

    def reset(self) -> None:
        with self._mu:
            self.launches = 0
            self.launches_by_q = {}
            self.launches_by_scope = {}


DENSE_SCORES = Kernel(
    "dense_scores",
    "pilosa_tpu_torch/ops/kernels/dense_scores.cu",
    "pilosa_tpu/ops/pallas_kernels.py:55",
)
SPARSE_STACKED_SCORES = Kernel(
    "sparse_stacked_scores",
    "pilosa_tpu_torch/ops/kernels/sparse_scores.cu",
    "pilosa_tpu/ops/packed.py:129",
)
TREE_COUNT = Kernel(
    "tree_count",
    "pilosa_tpu_torch/ops/kernels/tree_count.cu",
    "pilosa_tpu/executor/executor.py:1526",
)
GROUPBY_REDUCE = Kernel(
    "groupby_reduce",
    "pilosa_tpu_torch/ops/kernels/groupby_reduce.cu",
    "pilosa_tpu/ops/pallas_kernels.py:170",
)
BSI_RANGE = Kernel(
    "bsi_range",
    "pilosa_tpu_torch/ops/kernels/bsi_range.cu",
    "pilosa_tpu/ops/bsi.py:85",
)
EXPAND_BLOCKS = Kernel(
    "expand_blocks",
    "pilosa_tpu_torch/ops/kernels/expand_blocks.cu",
    "pilosa_tpu/ops/pallas_kernels.py:225",
)
WORD_DELTA = Kernel(
    "word_delta",
    "pilosa_tpu_torch/ops/kernels/word_delta.cu",
    "pilosa_tpu/ops/delta.py:117",
)
BSI_MINMAX = Kernel(
    "bsi_minmax",
    "pilosa_tpu_torch/ops/kernels/bsi_minmax.cu",
    "pilosa_tpu/ops/bsi.py:47",
)
DISTINCT_PRESENCE = Kernel(
    "distinct_presence",
    "pilosa_tpu_torch/ops/kernels/distinct_presence.cu",
    "pilosa_tpu/ops/bsi.py:262",
)
BSI_PERCENTILE = Kernel(
    "bsi_percentile",
    "pilosa_tpu_torch/ops/kernels/bsi_percentile.cu",
    "pilosa_tpu/ops/bsi.py:222",
)
KERNELS = (
    DENSE_SCORES,
    SPARSE_STACKED_SCORES,
    TREE_COUNT,
    GROUPBY_REDUCE,
    BSI_RANGE,
    EXPAND_BLOCKS,
    WORD_DELTA,
    BSI_MINMAX,
    DISTINCT_PRESENCE,
    BSI_PERCENTILE,
)


def reset_launches() -> None:
    for k in KERNELS:
        k.reset()


def build_kernels() -> dict:
    """Build (or load the cached build of) every kernel; returns the
    per-source build log (seconds, ptxas report)."""
    return _build.build_all()


def _check_words(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{what} must be int32, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned for vector loads")


def _check_i32(t: torch.Tensor, what: str, dim: int = 1) -> None:
    """An int32 CUDA tensor of ``dim`` dimensions, contiguous (scalar
    loads: no alignment beyond the element)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{what} must be int32, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dim}-d tensor, got {tuple(t.shape)}")


def _same_device(device, *ts) -> None:
    for t in ts:
        if t.device != device:
            raise ValueError(f"tensors on different devices: {t.device} vs {device}")


class LaunchError(RuntimeError):
    """A kernel of the port's refused its launch (the runtime's error
    right after it). Not a device fault to recover from: the executor
    lets it reach the caller (``executor/hbm.py``)."""


def _raise_on(err: int, name: str) -> None:
    if err:
        raise LaunchError(f"{name}: CUDA error {err} at launch")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dense_scores(srcs: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """K1: popcount(srcs[q] & mat[r]) -> i32[Q, R]. srcs i32[Q, W],
    mat i32[R, W], W a multiple of 4."""
    _check_words(srcs, "srcs")
    _check_words(mat, "mat")
    _same_device(mat.device, srcs)
    if srcs.dim() != 2 or mat.dim() != 2 or srcs.shape[1] != mat.shape[1]:
        raise ValueError(f"shape mismatch: srcs {tuple(srcs.shape)}, mat {tuple(mat.shape)}")
    q, w = srcs.shape
    r = mat.shape[0]
    if w % 4:
        raise ValueError(f"words per row must be a multiple of 4, got {w}")
    out = torch.empty((q, r), dtype=torch.int32, device=mat.device)
    if q == 0 or r == 0:
        return out
    if w == 0:
        return out.zero_()
    lib = _build.library("dense_scores")
    err = lib.pilosa_dense_scores(
        srcs.data_ptr(), mat.data_ptr(), out.data_ptr(), q, r, w,
        mat.device.index, _stream(mat.device),
    )
    _raise_on(err, "dense_scores")
    DENSE_SCORES.note_launch(q)
    return out


# Source stacks one sparse_scores launch takes by pointer (SS_MAX_Q in
# sparse_scores.cu); a wider batch takes further launches.
SPARSE_MAX_Q = 32


class _SparseSrcs(ctypes.Structure):
    # SparseSrcs in sparse_scores.cu: each query's [S, W] source stack by
    # its base pointer and shard stride in words
    _fields_ = [
        ("base", ctypes.c_void_p * SPARSE_MAX_Q),
        ("shard_stride", ctypes.c_longlong * SPARSE_MAX_Q),
    ]


def _source_stacks(srcs) -> list:
    """Each query's i32[S, W] source stack: the rows of an i32[Q, S, W]
    tensor or the tensors of a sequence, as views (nothing is copied).
    Each must have a dense word axis, a shard stride of whole 16-byte
    vectors and a 16-byte aligned start: the kernel copies 8 KiB
    containers of it with cp.async.bulk."""
    stacks = list(srcs.unbind(0)) if isinstance(srcs, torch.Tensor) and srcs.dim() == 3 else list(srcs)
    if not stacks:
        return stacks
    shape = tuple(stacks[0].shape)
    for t in stacks:
        if not isinstance(t, torch.Tensor) or t.dim() != 2 or tuple(t.shape) != shape:
            raise ValueError(f"sources must be i32[S, W] of one shape, got {getattr(t, 'shape', t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"sources must be int32, got {t.dtype}")
        if t.device.type != "cuda":
            raise ValueError(f"sources must be CUDA tensors, got {t.device}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError("sources must have a dense word axis")
        if t.data_ptr() % 16 or t.stride(0) % 4:
            raise ValueError("sources must be 16-byte aligned per shard for bulk copies")
    if shape[1] % 2048:
        raise ValueError(f"source words per shard must be a multiple of 2048, got {shape[1]}")
    return stacks


def sparse_stacked_scores(
    srcs,
    blocks: torch.Tensor,
    block_row: torch.Tensor,
    block_slot: torch.Tensor,
    block_shard,
    num_rows: int,
    groups=None,
) -> torch.Tensor:
    """K2: block-sparse scoring -> i32[Q, num_rows]. srcs i32[Q, S, W]
    or a sequence of Q i32[S, W] stacks (W a multiple of 2048; taken by
    pointer, see ``_source_stacks``), blocks i32[B, 2048], index arrays
    i32[B] (block_shard None = shard 0). ``groups`` is the bundle's
    ``ops.SparseGroups`` (the stager makes it with the bundle); None
    makes it here, in one step: ``ops.sparse_groups`` copies the index
    arrays to the host, which waits for the stream. Up to SPARSE_MAX_Q
    queries a launch."""
    from pilosa_tpu_torch.ops.packed import sparse_groups

    stacks = _source_stacks(srcs)
    _check_words(blocks, "blocks")
    idx = [block_row, block_slot] + ([block_shard] if block_shard is not None else [])
    for t, what in zip(idx, ("block_row", "block_slot", "block_shard")):
        _check_words(t, what)
        if t.dim() != 1 or t.shape[0] != blocks.shape[0]:
            raise ValueError(f"{what} must be i32[B], got {tuple(t.shape)}")
    device = blocks.device
    _same_device(device, *stacks, *idx)
    if blocks.dim() != 2 or blocks.shape[1] != 2048:
        raise ValueError(f"blocks must be i32[B, 2048], got {tuple(blocks.shape)}")
    q = len(stacks)
    nb = blocks.shape[0]
    # integer atomics give the same sum in any order; they add into zeros
    out = torch.zeros((q, num_rows), dtype=torch.int32, device=device)
    if q == 0 or nb == 0 or num_rows == 0 or stacks[0].shape[0] == 0:
        return out
    s, w = stacks[0].shape
    if groups is None:
        groups = sparse_groups(block_row, block_slot, block_shard, num_rows, s, w // 2048)
    made_for = (groups.nb, groups.num_rows, groups.n_shards, groups.slots)
    if made_for != (nb, num_rows, s, w // 2048):
        raise ValueError(f"grouping made for (B, rows, S, slots) = {made_for}, not {(nb, num_rows, s, w // 2048)}")
    _check_i32(groups.order, "groups.order")
    _check_i32(groups.items, "groups.items", dim=2)
    _same_device(device, groups.order, groups.items)
    if groups.n_items == 0:
        return out
    lib = _build.library("sparse_scores")
    stream = _stream(device)
    for q0 in range(0, q, SPARSE_MAX_Q):
        part = stacks[q0 : q0 + SPARSE_MAX_Q]
        tab = _SparseSrcs()
        for j, t in enumerate(part):
            tab.base[j] = t.data_ptr()
            tab.shard_stride[j] = t.stride(0)
        err = lib.pilosa_sparse_scores(
            ctypes.byref(tab), blocks.data_ptr(), block_row.data_ptr(),
            groups.order.data_ptr(), groups.items.data_ptr(), groups.n_items,
            out[q0].data_ptr(), len(part), num_rows, device.index, stream,
        )
        _raise_on(err, "sparse_stacked_scores")
        SPARSE_STACKED_SCORES.note_launch(len(part))
    return out


# What one tree_count launch takes (TC_MAX_* in tree_count.cu): distinct
# leaf pointers and queries x leaves (one byte each naming a distinct
# leaf), both in the parameter block, and queries x kernel program words
# (resolved per query in shared memory).
TREE_MAX_DISTINCT = 256
TREE_MAX_REFS = 1536
TREE_MAX_RESOLVED = 3072

_tree_scratch: dict = {}
_tree_scratch_mu = OrderedLock("ops.tree_scratch")


def _tree_accumulator(device, stream: int) -> torch.Tensor:
    """The per-stream u32[3 + TREE_MAX_REFS] tickets and sums of the tree
    count: zeroed once when made, and every launch leaves it zero (its
    last block moves the sums out), so launches on one stream, which run
    in order, share it and no count needs a memset."""
    key = (device.index, stream)
    t = _tree_scratch.get(key)
    if t is None:
        with _tree_scratch_mu:
            t = _tree_scratch.get(key)
            if t is None:
                t = _tree_scratch[key] = torch.zeros(
                    3 + TREE_MAX_REFS, dtype=torch.int32, device=device
                )
    return t


def tree_count(leaves_by_query, program) -> torch.Tensor:
    """K3: popcount of a boolean tree over each query's leaves -> i32[Q].
    Every leaf is a same-shape int32 tensor; ``program`` is an
    ops.TreeProgram. A leaf shared by several queries (the same storage)
    is read once. Queries x leaves is at most TREE_MAX_REFS and the
    distinct leaves at most TREE_MAX_DISTINCT. One launch, no memset."""
    from pilosa_tpu_torch.ops.packed import tree_tables

    q = len(leaves_by_query)
    first = leaves_by_query[0][0]
    device = first.device
    n_words = first.numel()
    for leaves in leaves_by_query:
        if len(leaves) != program.nleaves:
            raise ValueError(f"query has {len(leaves)} leaves, program needs {program.nleaves}")
        for t in leaves:
            _check_words(t, "leaf")
            _same_device(device, t)
            if t.numel() != n_words:
                raise ValueError(f"leaf sizes differ: {t.numel()} vs {n_words}")
    if n_words % 4:
        raise ValueError(f"leaf words must be a multiple of 4, got {n_words}")
    if q * program.nleaves > TREE_MAX_REFS:
        raise ValueError(
            f"{q} queries x {program.nleaves} leaves > {TREE_MAX_REFS} leaf references per launch"
        )
    if q * len(program.kernel_code) > TREE_MAX_RESOLVED:
        raise ValueError(
            f"{q} queries x {len(program.kernel_code)} program words > {TREE_MAX_RESOLVED} per launch"
        )
    distinct, refs = tree_tables(leaves_by_query)
    if len(distinct) > TREE_MAX_DISTINCT:
        raise ValueError(f"{len(distinct)} distinct leaves > {TREE_MAX_DISTINCT} per launch")
    if n_words == 0:
        return torch.zeros(q, dtype=torch.int32, device=device)
    out = torch.empty(q, dtype=torch.int32, device=device)
    code = program.device_code(device)
    stream = _stream(device)
    flat = [i for r in refs for i in r]
    lib = _build.library("tree_count")
    # both tables travel by value in the kernel's parameter block
    err = lib.pilosa_tree_count(
        (ctypes.c_uint64 * len(distinct))(*[t.data_ptr() for t in distinct]),
        (ctypes.c_ubyte * len(flat))(*flat),
        len(distinct), code.data_ptr(), len(program.kernel_code), program.spill,
        program.nleaves, n_words, q, _tree_accumulator(device, stream).data_ptr(),
        out.data_ptr(), device.index, stream,
    )
    _raise_on(err, "tree_count")
    TREE_COUNT.note_launch(q)
    return out


# Dimensions one groupby_reduce launch takes (GB_MAX_DIMS) and the most
# planes it accumulates (the widest accumulator template).
GROUPBY_MAX_DIMS = 8
GROUPBY_MAX_PLANES = 64


class _GbDim(ctypes.Structure):
    # one GroupBy dimension; strides in 16-byte vectors (GbDim in
    # groupby_reduce.cu)
    _fields_ = [
        ("base", ctypes.c_void_p),
        ("row_stride", ctypes.c_longlong),
        ("shard_stride", ctypes.c_longlong),
        ("rows", ctypes.c_int),
    ]


def _vec_strides(t: torch.Tensor, what: str) -> tuple[int, int]:
    """(row stride, shard stride) in 16-byte vectors of an int32 [R, S, W]
    (or [S, R, W] plane) view whose word axis is dense."""
    if t.dtype != torch.int32:
        raise TypeError(f"{what} must be int32, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dim() != 3 or (t.shape[2] > 1 and t.stride(2) != 1):
        raise ValueError(f"{what} must be [., ., W] with a dense word axis")
    if t.data_ptr() % 16 or t.stride(0) % 4 or t.stride(1) % 4:
        raise ValueError(f"{what} must be 16-byte aligned per row and shard")
    return t.stride(0) // 4, t.stride(1) // 4


def groupby_reduce(dims, filt, planes) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: (counts i32[K], plane_counts i32[K, P]) of the GroupBy cross
    product. dims: list of i32[R_d, S, W] (any strides with a dense word
    axis); filt: i32[S, W] or None; planes: i32[S, P, W] (P may be 0).
    W a multiple of 4; one group's count must fit in int32."""
    s, p, w = planes.shape
    device = planes.device
    if len(dims) > GROUPBY_MAX_DIMS:
        raise ValueError(f"{len(dims)} dimensions > {GROUPBY_MAX_DIMS}")
    if p > GROUPBY_MAX_PLANES:
        raise ValueError(f"{p} planes > {GROUPBY_MAX_PLANES}")
    if w % 4:
        raise ValueError(f"words per shard must be a multiple of 4, got {w}")
    if s * w * 32 >= 1 << 31:
        raise ValueError(f"{s * w} words: a group's count would overflow int32")
    # planes are [S, P, W]: their shard axis is dim 0, the plane axis dim 1
    ps_shard, ps_plane = _vec_strides(planes, "planes") if p else (0, 0)
    arr = (_GbDim * GROUPBY_MAX_DIMS)()
    for i, d in enumerate(dims):
        if d.dim() != 3 or d.shape[1] != s or d.shape[2] != w:
            raise ValueError(f"dimension {i} is {tuple(d.shape)}, planes are {tuple(planes.shape)}")
        _same_device(device, d)
        rs, ss = _vec_strides(d, f"dimension {i}")
        arr[i] = _GbDim(d.data_ptr(), rs, ss, int(d.shape[0]))
    fptr, fss = None, 0
    if filt is not None:
        if tuple(filt.shape) != (s, w):
            raise ValueError(f"filter is {tuple(filt.shape)}, expected {(s, w)}")
        _same_device(device, filt)
        _, fss = _vec_strides(filt.unsqueeze(0), "filter")
        fptr = filt.data_ptr()
    k = 1
    for d in dims:
        k *= int(d.shape[0])
    counts = torch.zeros(k, dtype=torch.int32, device=device)
    plane_counts = torch.zeros((k, p), dtype=torch.int32, device=device)
    if k == 0 or s * w == 0:
        return counts, plane_counts
    lib = _build.library("groupby_reduce")
    err = lib.pilosa_groupby_reduce(
        arr, len(dims), fptr, fss,
        planes.data_ptr() if p else None, ps_plane, ps_shard, p,
        s, w // 4, k, counts.data_ptr(), plane_counts.data_ptr(),
        device.index, _stream(device),
    )
    _raise_on(err, "groupby_reduce")
    GROUPBY_REDUCE.note_launch(1)
    return counts, plane_counts


# Bit depth one bsi_range launch takes (the predicate is 64-bit).
BSI_MAX_DEPTH = 63


class _RangeProg(ctypes.Structure):
    # RangeProg in bsi_range.cu: one opcode byte per plane below the
    # not-null plane, the depth and the output selector
    _fields_ = [
        ("code", ctypes.c_ubyte * 64),
        ("depth", ctypes.c_int),
        ("out_sel", ctypes.c_int),
    ]


def bsi_range(planes: torch.Tensor, code, out_sel: int) -> torch.Tensor:
    """K5: one BSI range row per shard from a [S, D+1, W] plane stack
    (plane D is not-null) and a per-plane opcode program (ops/bsi.py
    range_program) -> i32[S, W]. One launch of a persistent grid."""
    s, d1, w = planes.shape
    depth = d1 - 1
    if not 0 <= depth <= BSI_MAX_DEPTH or len(code) != depth:
        raise ValueError(f"bit depth {depth} with a program of {len(code)}")
    if w % 4:
        raise ValueError(f"words per shard must be a multiple of 4, got {w}")
    shard_stride, plane_stride = _vec_strides(planes, "planes")
    out = torch.empty((s, w), dtype=torch.int32, device=planes.device)
    if s * w == 0:
        return out
    prog = _RangeProg()
    for i, op in enumerate(code):
        prog.code[i] = op
    prog.depth = depth
    prog.out_sel = out_sel
    lib = _build.library("bsi_range")
    err = lib.pilosa_bsi_range(
        planes.data_ptr(), plane_stride, shard_stride, s, w // 4,
        out.data_ptr(), ctypes.byref(prog), planes.device.index, _stream(planes.device),
    )
    _raise_on(err, "bsi_range")
    BSI_RANGE.note_launch(1)
    return out


# Words one expand_blocks launch writes: a 0xFFFFFFFF position pad must
# land past the last word after >> 5.
EXPAND_MAX_WORDS = (1 << 27) - 1
# Output words one expand_blocks CTA owns: one 2^16-bit container.
EXPAND_SPAN_WORDS = 2048


def expand_blocks(positions, run_starts, run_ends, dense, dense_word, num_words: int, offsets):
    """K6: roaring payloads binned by span -> i32[num_words] packed words.
    A span is EXPAND_SPAN_WORDS output words; ``offsets`` i32[3, spans +
    1] gives each span's slice of positions i32[P] (global bit offsets),
    of run_starts / run_ends i32[N] (inclusive global endpoints, each run
    inside its span) and of dense i32[D, 2048] (bitmap words whose
    dense_word i32[D] is their span's first word). Everything is ORed
    into zeros; an element outside the span its slice names is dropped.
    ``ops.expand_blocks`` bins unbinned inputs. One launch, no memset."""
    for t, what in (
        (positions, "positions"),
        (run_starts, "run_starts"),
        (run_ends, "run_ends"),
        (dense_word, "dense_word"),
    ):
        _check_i32(t, what)
    _check_words(dense, "dense")
    device = dense.device
    _same_device(device, positions, run_starts, run_ends, dense_word, offsets)
    if run_starts.shape != run_ends.shape:
        raise ValueError(f"run_starts {tuple(run_starts.shape)} vs run_ends {tuple(run_ends.shape)}")
    if dense.dim() != 2 or dense.shape[1] != 2048 or dense_word.shape[0] != dense.shape[0]:
        raise ValueError(f"dense must be i32[D, 2048] with i32[D] offsets: {tuple(dense.shape)}")
    if not 0 <= num_words <= EXPAND_MAX_WORDS:
        raise ValueError(f"num_words {num_words} outside [0, {EXPAND_MAX_WORDS}]")
    spans = -(-num_words // EXPAND_SPAN_WORDS)
    _check_i32(offsets, "offsets", dim=2)
    if tuple(offsets.shape) != (3, spans + 1):
        raise ValueError(f"offsets must be i32[3, {spans + 1}], got {tuple(offsets.shape)}")
    out = torch.empty(num_words, dtype=torch.int32, device=device)
    if num_words == 0:
        return out
    lib = _build.library("expand_blocks")
    err = lib.pilosa_expand_blocks(
        positions.data_ptr(), positions.shape[0],
        run_starts.data_ptr(), run_ends.data_ptr(), run_starts.shape[0],
        dense.data_ptr(), dense_word.data_ptr(), dense.shape[0], offsets.data_ptr(),
        out.data_ptr(), num_words, device.index, _stream(device),
    )
    _raise_on(err, "expand_blocks")
    EXPAND_BLOCKS.note_launch(1)
    return out


def word_delta_patch(src, out, shard_idx, word_idx, or_mask, andnot_mask) -> None:
    """K7's patch: out[s, m] = (src[s, m] | or) & ~andnot at each valid
    update, out of range dropped; ``out`` may be ``src``. Counts
    nothing: ``word_delta`` and ``word_delta_`` are the function."""
    _check_i32(src, "words", dim=2)
    _check_i32(out, "out", dim=2)
    if out.shape != src.shape:
        raise ValueError(f"out {tuple(out.shape)} vs words {tuple(src.shape)}")
    idx = [word_idx, or_mask, andnot_mask] + ([shard_idx] if shard_idx is not None else [])
    for t, what in zip(idx, ("word_idx", "or_mask", "andnot_mask", "shard_idx")):
        _check_i32(t, what)
        if t.shape[0] != word_idx.shape[0]:
            raise ValueError(f"{what} has {t.shape[0]} updates, word_idx {word_idx.shape[0]}")
    _same_device(src.device, out, *idx)
    s, m = src.shape
    lib = _build.library("word_delta")
    err = lib.pilosa_word_delta(
        src.data_ptr(), out.data_ptr(),
        shard_idx.data_ptr() if shard_idx is not None else None,
        word_idx.data_ptr(), or_mask.data_ptr(), andnot_mask.data_ptr(),
        word_idx.shape[0], s, m, src.device.index, _stream(src.device),
    )
    _raise_on(err, "word_delta")


def word_delta(words, shard_idx, word_idx, or_mask, andnot_mask) -> torch.Tensor:
    """K7 on the copy route: a NEW i32[S, M] equal to ``words`` with the
    per-word masks applied at (shard_idx, word_idx) (shard_idx None =
    shard 0); an update outside [0, S) x [0, M) is dropped. The wrapper
    copies the block device to device, then the kernel patches the K
    words."""
    _check_i32(words, "words", dim=2)
    out = torch.empty_like(words)
    out.copy_(words)
    if word_idx.shape[0] == 0:
        return out
    word_delta_patch(words, out, shard_idx, word_idx, or_mask, andnot_mask)
    WORD_DELTA.note_launch(1)
    return out


def word_delta_(words, shard_idx, word_idx, or_mask, andnot_mask) -> torch.Tensor:
    """K7 in place: ``words`` i32[S, M] patched at (shard_idx, word_idx)
    and returned. Kernels enqueued earlier on this stream read the words
    before the patch."""
    if word_idx.shape[0]:
        word_delta_patch(words, words, shard_idx, word_idx, or_mask, andnot_mask)
        WORD_DELTA.note_launch(1)
    return words


# Widest shard one bsi_minmax launch takes (136,512 words). A CTA of the
# shard's cluster holds W / 8 of its words: in registers up to a shard of
# 32768 words, past that in shared memory, 16 bytes for 4 words, well
# within the 200 KiB the kernel may ask for.
BSI_MINMAX_MAX_WORDS = 32 * (200 * 1024 // 48)


def bsi_minmax(planes: torch.Tensor, filt, is_min: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K8: the Min (or Max) recurrence of every shard of a [S, D+1, W]
    plane stack (plane D is not-null; any strides with a dense word axis)
    under an optional [S, W] filter -> (bits bool[S, D], count i32[S]).
    One launch: a cluster of 8 CTAs per shard. W a multiple of 32."""
    s, d1, w = planes.shape
    depth = d1 - 1
    device = planes.device
    if not 0 <= depth <= BSI_MAX_DEPTH:
        raise ValueError(f"bit depth {depth} outside [0, {BSI_MAX_DEPTH}]")
    if w == 0 or w % 32:
        raise ValueError(f"words per shard must be a positive multiple of 8 x 4, got {w}")
    if w > BSI_MINMAX_MAX_WORDS:
        raise ValueError(f"{w} words per shard > {BSI_MINMAX_MAX_WORDS}")
    shard_stride, plane_stride = _vec_strides(planes, "planes")
    fptr, fss = None, 0
    if filt is not None:
        if tuple(filt.shape) != (s, w):
            raise ValueError(f"filter is {tuple(filt.shape)}, expected {(s, w)}")
        _same_device(device, filt)
        _, fss = _vec_strides(filt.unsqueeze(0), "filter")
        fptr = filt.data_ptr()
    bits = torch.empty((s, depth), dtype=torch.bool, device=device)
    count = torch.empty(s, dtype=torch.int32, device=device)
    if s == 0:
        return bits, count
    lib = _build.library("bsi_minmax")
    err = lib.pilosa_bsi_minmax(
        planes.data_ptr(), plane_stride, shard_stride, fptr, fss, s, depth, w // 32,
        int(is_min), bits.data_ptr(), count.data_ptr(), device.index, _stream(device),
    )
    _raise_on(err, "bsi_minmax")
    BSI_MINMAX.note_launch(1)
    return bits, count


# Deepest field distinct_presence takes: its output is 2^depth bits
# (DP_MAX_DEPTH in distinct_presence.cu).
DISTINCT_MAX_DEPTH = 24


def _word_strides(t: torch.Tensor, what: str) -> tuple[int, int]:
    """(dim 0 stride, dim 1 stride) in words of an int32 [., ., W] CUDA
    view whose word axis is dense."""
    if t.dtype != torch.int32:
        raise TypeError(f"{what} must be int32, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dim() != 3 or (t.shape[2] > 1 and t.stride(2) != 1):
        raise ValueError(f"{what} must be [., ., W] with a dense word axis")
    return t.stride(0), t.stride(1)


def distinct_presence(planes: torch.Tensor, filt, depth: int) -> torch.Tensor:
    """K9: the values present among the columns of a [S, D+1, W] plane
    stack (plane D is not-null; any strides with a dense word axis) under
    an optional [S, W] filter -> i32[max(ceil(2^D / 32), 1)] presence
    words (bit v of the bitmap set iff some considered column holds v).
    One launch into zeros."""
    s, d1, w = planes.shape
    if d1 != depth + 1:
        raise ValueError(f"{d1} planes for bit depth {depth}")
    if not 0 <= depth <= DISTINCT_MAX_DEPTH:
        raise ValueError(f"bit depth {depth} outside [0, {DISTINCT_MAX_DEPTH}]")
    device = planes.device
    shard_stride, plane_stride = _word_strides(planes, "planes")
    fptr, fss = None, 0
    if filt is not None:
        if tuple(filt.shape) != (s, w):
            raise ValueError(f"filter is {tuple(filt.shape)}, expected {(s, w)}")
        _same_device(device, filt)
        fss, _ = _word_strides(filt.unsqueeze(1), "filter")
        fptr = filt.data_ptr()
    nwords = max(((1 << depth) + 31) // 32, 1)
    out = torch.zeros(nwords, dtype=torch.int32, device=device)
    if s * w == 0:
        return out
    lib = _build.library("distinct_presence")
    err = lib.pilosa_distinct_presence(
        planes.data_ptr(), plane_stride, shard_stride, fptr, fss, s, w, depth,
        out.data_ptr(), nwords, device.index, _stream(device),
    )
    _raise_on(err, "distinct_presence")
    DISTINCT_PRESENCE.note_launch(1)
    return out


# Columns one bsi_percentile launch counts: each step word keeps its sum
# in its low 48 bits (kArrivalShift in bsi_percentile.cu).
PERCENTILE_MAX_BITS = 1 << 48

def percentile_grid(device) -> tuple[int, int]:
    """(CTAs of K10's cooperative grid, int32 words of ``consider`` its
    on-chip route holds) on a CUDA device. The occupancy query runs once
    per device inside the library, which later calls read."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    grid, vectors = ctypes.c_int(0), ctypes.c_longlong(0)
    lib = _build.library("bsi_percentile")
    err = lib.pilosa_bsi_percentile_grid(index, ctypes.byref(grid), ctypes.byref(vectors))
    _raise_on(err, "bsi_percentile (grid query)")
    return grid.value, 4 * vectors.value


def percentile_on_chip(planes: torch.Tensor) -> bool:
    """Whether K10 keeps ``consider`` of the search over this [S, D+1, W]
    plane view on chip (else in an [S, W] scratch in device memory):
    the S x W words fit in what the grid holds (4 16-byte vectors a
    thread), and every plane word lies within the kernel's 32-bit vector
    offsets. The one route decision:
    the launch and fusion's admission charge both ask it."""
    s, d1, w = planes.shape
    last = ((s - 1) * planes.stride(0) + (d1 - 1) * planes.stride(1) + w) // 4
    return s * w <= percentile_grid(planes.device)[1] and last < 1 << 32


def percentile_counter_words(depth: int) -> int:
    """K10's u64 step-word slots for a depth: three words a barrier (one
    barrier for the count, then one per two bits), each in a 128-byte
    line of its own (16 slots; kCounterStride in bsi_percentile.cu)."""
    return 3 * 16 * (1 + (depth + 1) // 2)


def percentile_scratch_bytes(planes: torch.Tensor) -> int:
    """Device memory one K10 launch over ``planes`` ([S, D+1, W])
    allocates beyond its inputs: the step counters, the bits and the
    count, and on the global route the [S, W] scratch. On a CPU device,
    what the card's on-chip route takes (no grid to ask)."""
    s, d1, w = planes.shape
    small = 8 * percentile_counter_words(d1 - 1) + (d1 - 1) + 4
    if planes.device.type != "cuda" or s * w == 0 or percentile_on_chip(planes):
        return small
    return small + s * w * 4


def bsi_percentile(planes: torch.Tensor, filt, nth_bp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K10: the nearest-rank Percentile (``nth_bp`` basis points, 0 to
    10000) of a [S, D+1, W] plane stack (plane D is not-null; any strides
    with a dense word axis, 16-byte aligned) under an optional [S, W]
    filter -> (bits bool[D], count i32 scalar), bit i of the k-th smallest
    considered value and the considered columns (0: no value; every bit
    is then set, as the search gives an empty set). One cooperative
    launch; no host sync. W a multiple of 4."""
    s, d1, w = planes.shape
    depth = d1 - 1
    device = planes.device
    if not 0 <= depth <= BSI_MAX_DEPTH:
        raise ValueError(f"bit depth {depth} outside [0, {BSI_MAX_DEPTH}]")
    if not 0 <= nth_bp <= 10000:
        raise ValueError(f"nth {nth_bp} basis points outside [0, 10000]")
    if w % 4:
        raise ValueError(f"words per shard must be a multiple of 4, got {w}")
    if s * w * 32 >= PERCENTILE_MAX_BITS:
        raise ValueError(f"{s * w} words: the count would pass 2^48 columns")
    shard_stride, plane_stride = _vec_strides(planes, "planes")
    fptr, fss = None, 0
    if filt is not None:
        if tuple(filt.shape) != (s, w):
            raise ValueError(f"filter is {tuple(filt.shape)}, expected {(s, w)}")
        _same_device(device, filt)
        _, fss = _vec_strides(filt.unsqueeze(0), "filter")
        fptr = filt.data_ptr()
    bits = torch.empty(depth, dtype=torch.bool, device=device)
    count = torch.empty((), dtype=torch.int32, device=device)
    if s * w == 0:
        return bits.fill_(True), count.zero_()
    wv = w // 4
    nv = s * wv
    on_chip = percentile_on_chip(planes)
    state = None if on_chip else torch.empty(s * w, dtype=torch.int32, device=device)
    counters = torch.empty(percentile_counter_words(depth), dtype=torch.int64, device=device)
    lib = _build.library("bsi_percentile")
    err = lib.pilosa_bsi_percentile(
        planes.data_ptr(), plane_stride, shard_stride, fptr, fss, wv, nv, depth, int(nth_bp),
        int(on_chip), state.data_ptr() if state is not None else None, counters.data_ptr(),
        bits.data_ptr(), count.data_ptr(), device.index, _stream(device),
    )
    _raise_on(err, "bsi_percentile")
    BSI_PERCENTILE.note_launch(1)
    return bits, count
